"""Descriptor matching for a batch of image pairs.

Counterpart of ``sfm_tpu/matching/core.py::_match_descriptors``, as three
kernel entries of ``csrc/match_top2.cu`` on a CUDA tensor (K1):

* :func:`match_top2` -- per row of desc1 the best index, best and
  second-best squared-L2 distance and, for the mutual check, the column
  argmin ``back`` from the same distance tiles (entry ``match_top2``; the
  distance matrix never reaches device memory); twin
  :func:`match_top2_plain`, which materializes it;
* :func:`match_epilogue` -- the ratio test, the mutual test and the score
  that ``topk_rows`` compacts (entry ``match_epilogue``); twin
  :func:`match_epilogue_plain`;
* :func:`match_compact` -- the compaction's gathers and ``where``s after
  ``topk_rows`` (entry ``match_compact``); twin :func:`match_compact_plain`.
"""
from __future__ import annotations

import torch

from sfm_tpu_torch import _kernels
from sfm_tpu_torch.estimators.ransac import top_k, top_k_rows

# The kernel stages descriptors through shared memory in chunks of 32 floats.
_K1_D_MULTIPLE = 32


def match_top2_plain(desc1, valid1, desc2, valid2, mutual: bool = False):
    """(B, K1, D), (B, K2, D) -> per row of desc1: (best index, best, second)
    and, with ``mutual``, per column of desc2 the row of its minimum (back).

    Distance is ``max(2 - 2 d1.d2, 0)``, +inf for an invalid row or column;
    ties go to the lowest index, and an all-inf row (column) returns index 0.
    """
    sim = desc1 @ desc2.mT
    dist = torch.clamp(2.0 - 2.0 * sim, min=0.0)
    dist = dist + torch.where(valid2[:, None, :], 0.0, torch.inf)
    dist = torch.where(valid1[:, :, None], dist, torch.inf)
    best, idx = torch.min(dist, dim=-1)
    second = torch.min(dist.scatter(-1, idx[..., None], torch.inf), dim=-1).values
    if mutual:
        return idx, best, second, torch.argmin(dist, dim=-2)
    return idx, best, second


def match_top2_cuda(desc1, valid1, desc2, valid2, mutual: bool = False):
    """Kernel K1's ``match_top2``; indices come back as int32."""
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
    back_key = torch.empty((B, K2), dtype=torch.int64, device=dev) if mutual else None
    back = torch.empty((B, K2), dtype=torch.int32, device=dev) if mutual else None
    _kernels.launch("match_top2", dev, desc1, valid1, desc2, valid2,
                    B, K1, K2, D, idx, best, second, back_key, back)
    return (idx, best, second, back) if mutual else (idx, best, second)


def match_top2(desc1, valid1, desc2, valid2, mutual: bool = False):
    """Kernel K1 on a CUDA tensor, its plain twin on a CPU tensor."""
    if desc1.is_cuda:
        return match_top2_cuda(desc1, valid1, desc2, valid2, mutual)
    if desc1.device.type == "cpu":
        return match_top2_plain(desc1, valid1, desc2, valid2, mutual)
    raise ValueError(f"match_top2: unsupported device {desc1.device}")


def match_epilogue_plain(best_j, d_best, d_second, valid1, back, ratio_threshold: float):
    """Score of each row for the compaction: -d_best where the row passes the
    Lowe ratio (and, when ``back`` is given, the mutual test
    ``back[best_j] == row``), -inf elsewhere. (B, K1) -> (B, K1)."""
    ratio_ok = d_best < (ratio_threshold ** 2) * d_second
    good = ratio_ok & valid1 & torch.isfinite(d_best)
    if back is not None:
        rows = torch.arange(best_j.shape[1], device=best_j.device)
        good = good & (torch.gather(back.long(), 1, best_j.long()) == rows)
    return torch.where(good, -d_best, -torch.inf)


def match_epilogue_cuda(best_j, d_best, d_second, valid1, back, ratio_threshold: float):
    B, K1 = best_j.shape
    dev = best_j.device
    _kernels.check_tensor(best_j, "best_j", torch.int32, (B, K1), dev)
    _kernels.check_tensor(d_best, "d_best", torch.float32, (B, K1), dev)
    _kernels.check_tensor(d_second, "d_second", torch.float32, (B, K1), dev)
    _kernels.check_tensor(valid1, "valid1", torch.bool, (B, K1), dev)
    K2 = 0
    if back is not None:
        K2 = back.shape[1]
        _kernels.check_tensor(back, "back", torch.int32, (B, K2), dev)
    score = torch.empty((B, K1), dtype=torch.float32, device=dev)
    _kernels.launch("match_epilogue", dev, best_j, d_best, d_second, valid1, back, B, K1, K2,
                    float(ratio_threshold ** 2), score)
    return score


def match_epilogue(best_j, d_best, d_second, valid1, back, ratio_threshold: float):
    """K1's ``match_epilogue`` on a CUDA tensor, its plain twin on a CPU tensor."""
    args = (best_j, d_best, d_second, valid1, back, ratio_threshold)
    if best_j.is_cuda:
        return match_epilogue_cuda(*args)
    if best_j.device.type == "cpu":
        return match_epilogue_plain(*args)
    raise ValueError(f"match_epilogue: unsupported device {best_j.device}")


def match_compact_plain(top_scores, order, best_j, max_matches: int):
    """The (B, M) match table from the compaction's (B, k) top scores and
    rows (k <= M; the budget past k is padded dead)."""
    B, k = top_scores.shape
    if k < max_matches:
        pad = max_matches - k
        top_scores = torch.cat([top_scores, top_scores.new_full((B, pad), -torch.inf)], 1)
        order = torch.cat([order, order.new_zeros((B, pad))], 1)
    valid = torch.isfinite(top_scores)
    idx2 = torch.gather(best_j.long(), 1, order.long())
    return {
        "idx1": torch.where(valid, order.long(), 0),
        "idx2": torch.where(valid, idx2, 0),
        "valid": valid,
        "distance": torch.where(valid, -top_scores, 0.0),
    }


def match_compact_cuda(top_scores, order, best_j, max_matches: int):
    B, k = top_scores.shape
    K1 = best_j.shape[1]
    dev = top_scores.device
    _kernels.check_tensor(top_scores, "top_scores", torch.float32, (B, k), dev)
    _kernels.check_tensor(order, "order", torch.int64, (B, k), dev)
    _kernels.check_tensor(best_j, "best_j", torch.int32, (B, K1), dev)
    M = max_matches
    out = {"idx1": torch.empty((B, M), dtype=torch.int64, device=dev),
           "idx2": torch.empty((B, M), dtype=torch.int64, device=dev),
           "valid": torch.empty((B, M), dtype=torch.bool, device=dev),
           "distance": torch.empty((B, M), dtype=torch.float32, device=dev)}
    _kernels.launch("match_compact", dev, top_scores, order, best_j, B, K1, k, M,
                    out["idx1"], out["idx2"], out["valid"], out["distance"])
    return out


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
    On CUDA tensors: ``match_top2``, ``match_epilogue``, ``topk_rows`` and
    ``match_compact``, one launch each.
    """
    d1 = desc1.to(torch.float32).contiguous()
    d2 = desc2.to(torch.float32).contiguous()
    valid1 = valid1.to(torch.bool).contiguous()
    valid2 = valid2.to(torch.bool).contiguous()
    K1 = valid1.shape[1]

    top2 = match_top2(d1, valid1, d2, valid2, mutual=mutual_check)
    best_j, d_best, d_second = top2[:3]
    back = top2[3] if mutual_check else None
    score = match_epilogue(best_j, d_best, d_second, valid1, back, ratio_threshold)
    # Compact to the budget, smallest distance first (lax.top_k order).
    k = min(max_matches, K1)
    if d1.is_cuda:
        top_scores, order = top_k_rows(score, k)
        return match_compact_cuda(top_scores, order, best_j, max_matches)
    top_scores, order = top_k(score, k)
    return match_compact_plain(top_scores, order, best_j, max_matches)
