"""Descriptor matching for a batch of image pairs.

Counterpart of ``sfm_tpu/matching/core.py::_match_descriptors``. The
per-row best index, best and second-best squared-L2 distance is kernel K1
(``csrc/match_top2.cu``), which never writes the distance matrix to device
memory; its plain twin :func:`match_top2_plain` materializes it. The mutual
check is the same kernel with the two sides swapped. Ratio test, mutual test
and best-first compaction are plain torch.
"""
from __future__ import annotations

import torch

from sfm_tpu_torch import _kernels
from sfm_tpu_torch.estimators.ransac import top_k

# The kernel stages descriptors through shared memory in chunks of 32 floats.
_K1_D_MULTIPLE = 32


def match_top2_plain(desc1, valid1, desc2, valid2):
    """(B, K1, D), (B, K2, D) -> per row of desc1: (best index, best, second).

    Distance is ``max(2 - 2 d1.d2, 0)``, +inf for an invalid row or column;
    ties go to the lowest index, and an all-inf row returns index 0.
    """
    sim = desc1 @ desc2.mT
    dist = torch.clamp(2.0 - 2.0 * sim, min=0.0)
    dist = dist + torch.where(valid2[:, None, :], 0.0, torch.inf)
    dist = torch.where(valid1[:, :, None], dist, torch.inf)
    best, idx = torch.min(dist, dim=-1)
    second = torch.min(dist.scatter(-1, idx[..., None], torch.inf), dim=-1).values
    return idx, best, second


def match_top2_cuda(desc1, valid1, desc2, valid2):
    B, K1, D = desc1.shape
    K2 = desc2.shape[1]
    dev = desc1.device
    if D % _K1_D_MULTIPLE:
        raise ValueError(f"match_top2: D={D} must be a multiple of {_K1_D_MULTIPLE}")
    _kernels.check_tensor(desc1, "desc1", torch.float32, (B, K1, D), dev)
    _kernels.check_tensor(valid1, "valid1", torch.bool, (B, K1), dev)
    _kernels.check_tensor(desc2, "desc2", torch.float32, (B, K2, D), dev)
    _kernels.check_tensor(valid2, "valid2", torch.bool, (B, K2), dev)
    idx = torch.empty((B, K1), dtype=torch.int32, device=dev)
    best = torch.empty((B, K1), dtype=torch.float32, device=dev)
    second = torch.empty((B, K1), dtype=torch.float32, device=dev)
    _kernels.launch("match_top2", dev, desc1, valid1, desc2, valid2,
                    B, K1, K2, D, idx, best, second)
    return idx.long(), best, second


def match_top2(desc1, valid1, desc2, valid2):
    """Kernel K1 on a CUDA tensor, its plain twin on a CPU tensor."""
    if desc1.is_cuda:
        return match_top2_cuda(desc1, valid1, desc2, valid2)
    if desc1.device.type == "cpu":
        return match_top2_plain(desc1, valid1, desc2, valid2)
    raise ValueError(f"match_top2: unsupported device {desc1.device}")


def match_descriptors(
    desc1, valid1, desc2, valid2,
    ratio_threshold: float = 0.75,
    max_matches: int = 1024,
    mutual_check: bool = True,
):
    """Match a batch of padded descriptor-set pairs.

    desc1: (B, K1, D) unit-norm; valid1: (B, K1); desc2: (B, K2, D);
    valid2: (B, K2). Returns a dict of (B, M) tensors, M = max_matches:
    idx1, idx2 (int64), valid (bool), distance (squared L2), best first.
    """
    d1 = desc1.to(torch.float32).contiguous()
    d2 = desc2.to(torch.float32).contiguous()
    valid1 = valid1.to(torch.bool).contiguous()
    valid2 = valid2.to(torch.bool).contiguous()
    B, K1 = valid1.shape

    best_j, d_best, d_second = match_top2(d1, valid1, d2, valid2)
    ratio_ok = d_best < (ratio_threshold ** 2) * d_second
    good = ratio_ok & valid1 & torch.isfinite(d_best)
    if mutual_check:
        back, _, _ = match_top2(d2, valid2, d1, valid1)          # (B, K2)
        rows = torch.arange(K1, device=d1.device)
        good = good & (torch.gather(back, 1, best_j) == rows)

    # Compact to the budget, smallest distance first (lax.top_k order).
    score = torch.where(good, -d_best, -torch.inf)
    k = min(max_matches, K1)
    top_scores, order = top_k(score, k)
    if k < max_matches:
        pad = max_matches - k
        top_scores = torch.cat([top_scores, top_scores.new_full((B, pad), -torch.inf)], 1)
        order = torch.cat([order, order.new_zeros((B, pad))], 1)
    valid = torch.isfinite(top_scores)
    idx2 = torch.gather(best_j, 1, order)
    return {
        "idx1": torch.where(valid, order, 0),
        "idx2": torch.where(valid, idx2, 0),
        "valid": valid,
        "distance": torch.where(valid, -top_scores, 0.0),
    }
