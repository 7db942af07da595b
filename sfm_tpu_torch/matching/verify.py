"""Geometric verification of matched pairs and the reference's quality gates.

Counterpart of ``sfm_tpu/matching/verify.py``, batched over pairs. Gates:
num_inliers >= 15, inlier_ratio >= 0.3, mean inlier symmetric-epipolar
error <= 2.0 px, and point spread (std) > 20 px on both axes of both images.
The gates are computed with the refit, in kernel K2's one launch,
``fmat_ransac`` (:mod:`sfm_tpu_torch.estimators.fundamental`).
"""
from __future__ import annotations

import torch

from sfm_tpu_torch.estimators.fundamental import estimate_fundamental_ransac
from sfm_tpu_torch.matching.core import match_descriptors

_VERIFY_KEYS = ("F", "inliers", "num_matches", "num_inliers", "inlier_ratio",
                "reprojection_error", "well_distributed", "accept")


def verify_pair(
    xy1,
    xy2,
    valid,
    ransac_iters: int = 2048,
    ransac_threshold: float = 3.0,
    min_inliers: int = 15,
    min_inlier_ratio: float = 0.3,
    max_reproj_error: float = 2.0,
    min_spread: float = 20.0,
    prefix_valid: bool = False,
    score_budget: int = 0,
    generator: torch.Generator | None = None,
    indices: torch.Tensor | None = None,
):
    """RANSAC F + quality gates on (B, N) padded match sets.

    Returns a dict of per-pair tensors: F, inliers (B, N), num_matches,
    num_inliers, inlier_ratio, reprojection_error, well_distributed, accept.
    """
    est = estimate_fundamental_ransac(
        xy1, xy2, valid, iters=ransac_iters, threshold=ransac_threshold,
        prefix_valid=prefix_valid, score_budget=score_budget,
        generator=generator, indices=indices, min_inliers=min_inliers,
        min_inlier_ratio=min_inlier_ratio, max_reproj_error=max_reproj_error,
        min_spread=min_spread,
    )
    return {k: est[k] for k in _VERIFY_KEYS}


def match_and_verify(
    desc1, xy_1, valid1,
    desc2, xy_2, valid2,
    ratio_threshold: float = 0.75,
    max_matches: int = 1024,
    mutual_check: bool = True,
    ransac_iters: int = 2048,
    ransac_threshold: float = 3.0,
    min_inliers: int = 15,
    min_inlier_ratio: float = 0.3,
    max_reproj_error: float = 2.0,
    min_spread: float = 20.0,
    generator: torch.Generator | None = None,
    indices: torch.Tensor | None = None,
):
    """Descriptor match -> F-RANSAC -> gates for a batch of B pairs.

    desc*: (B, K, D), xy_*: (B, K, 2), valid*: (B, K). Returns the
    :func:`verify_pair` dict plus xy1, xy2, match_valid, idx1, idx2.
    Hypotheses are scored on the first ``min(256, M)`` matches, which the
    best-first compaction makes the most reliable ones.
    """
    m = match_descriptors(
        desc1, valid1, desc2, valid2,
        ratio_threshold=ratio_threshold,
        max_matches=max_matches,
        mutual_check=mutual_check,
    )
    mv = m["valid"][..., None]
    take = lambda xy, idx: torch.gather(xy, 1, idx[..., None].expand(-1, -1, 2))
    xy1 = take(xy_1.to(torch.float32), m["idx1"]) * mv
    xy2 = take(xy_2.to(torch.float32), m["idx2"]) * mv
    out = verify_pair(
        xy1, xy2, m["valid"],
        ransac_iters=ransac_iters,
        ransac_threshold=ransac_threshold,
        min_inliers=min_inliers,
        min_inlier_ratio=min_inlier_ratio,
        max_reproj_error=max_reproj_error,
        min_spread=min_spread,
        prefix_valid=True,
        score_budget=min(256, xy1.shape[1]),
        generator=generator,
        indices=indices,
    )
    out["xy1"] = xy1
    out["xy2"] = xy2
    out["match_valid"] = m["valid"]
    out["idx1"] = m["idx1"]
    out["idx2"] = m["idx2"]
    return out
