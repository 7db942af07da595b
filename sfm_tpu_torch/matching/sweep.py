"""The exhaustive all-pairs sweep: match + verify every candidate pair.

Counterpart of ``sfm_tpu/matching/sweep.py``: ``candidate_pairs`` and
``all_pairs_sweep``, which fills a :class:`PairTable` (numpy on the host,
in :mod:`sfm_tpu_torch.matching.pair_table`). Pairs run in chunks of
``chunk_size`` through the batched :func:`match_and_verify`; the results
stay on the device until the end and are then copied to the host once.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sfm_tpu_torch.config import SfMConfig, effective_match_config
from sfm_tpu_torch.matching.pair_table import PairTable
from sfm_tpu_torch.matching.verify import match_and_verify


def candidate_pairs(num_images: int) -> np.ndarray:
    """All (i, j), i < j."""
    i, j = np.triu_indices(num_images, k=1)
    return np.stack([i, j], axis=-1).astype(np.int32)


_FIELDS = ("accept", "num_matches", "num_inliers", "inlier_ratio",
           "reprojection_error", "well_distributed", "F", "xy1", "xy2",
           "idx1", "idx2", "match_valid", "inliers")


def all_pairs_sweep(
    xy: torch.Tensor,
    desc: torch.Tensor,
    valid: torch.Tensor,
    config: SfMConfig = SfMConfig(),
    pairs: Optional[np.ndarray] = None,
    generator: Optional[torch.Generator] = None,
    chunk_size: int = 32,
) -> PairTable:
    """Match + verify every candidate pair of stacked padded features.

    xy: (N, K, 2); desc: (N, K, D); valid: (N, K), all on one device, which
    is where the sweep runs. ``pairs``: optional (P, 2) candidate list
    (default all i < j). RANSAC draws come from ``generator``, by default
    one seeded with ``config.seed`` on that device.
    """
    dev = desc.device
    n = xy.shape[0]
    if pairs is None:
        pairs = candidate_pairs(n)
    pairs = np.asarray(pairs, np.int32)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(config.seed)
    mc, vc = effective_match_config(config), config.verify

    outs = []
    for c0 in range(0, pairs.shape[0], chunk_size):
        ij = torch.as_tensor(pairs[c0:c0 + chunk_size], dtype=torch.long, device=dev)
        i, j = ij[:, 0], ij[:, 1]
        out = match_and_verify(
            desc[i], xy[i], valid[i],
            desc[j], xy[j], valid[j],
            ratio_threshold=mc.ratio_threshold,
            max_matches=mc.max_matches,
            mutual_check=mc.mutual_check,
            ransac_iters=vc.ransac_iters,
            ransac_threshold=vc.ransac_threshold,
            min_inliers=vc.min_inliers,
            min_inlier_ratio=vc.min_inlier_ratio,
            max_reproj_error=vc.max_reproj_error,
            min_spread=vc.min_spread,
            generator=generator,
        )
        outs.append({k: out[k] for k in _FIELDS})
    host = {k: torch.cat([o[k] for o in outs]).cpu().numpy() for k in _FIELDS}
    return PairTable(
        pairs=pairs,
        accept=host["accept"],
        num_matches=host["num_matches"].astype(np.int32),
        num_inliers=host["num_inliers"].astype(np.int32),
        inlier_ratio=host["inlier_ratio"].astype(np.float32),
        reprojection_error=host["reprojection_error"].astype(np.float32),
        well_distributed=host["well_distributed"],
        F=host["F"].astype(np.float32),
        xy1=host["xy1"].astype(np.float32),
        xy2=host["xy2"].astype(np.float32),
        idx1=host["idx1"].astype(np.int32),
        idx2=host["idx2"].astype(np.int32),
        match_valid=host["match_valid"],
        inliers=host["inliers"],
    )
