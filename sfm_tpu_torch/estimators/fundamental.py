"""Fundamental-matrix RANSAC, batched over image pairs.

Counterpart of ``sfm_tpu/estimators/fundamental.py``. Hypotheses are solved
by the eight-point solver in plain torch; scoring every hypothesis against
the scoring subset and picking the winner is kernel K2
(``csrc/fmat_ransac.cu``), whose plain twin is :func:`fmat_score_select_plain`.
The winner's consensus over the full set, the weighted rank-2 refit and the
final inliers are plain torch again.
"""
from __future__ import annotations

import torch

from sfm_tpu_torch import _kernels
from sfm_tpu_torch.geometry.epipolar import eight_point, symmetric_epipolar_distance
from sfm_tpu_torch.estimators.ransac import ransac_sample_indices, ransac_select

# One thread block holds the scoring subset in shared memory (5 floats a row).
_K2_MAX_POINTS = 2048


def fmat_score_select_plain(Fs, pts1, pts2, valid, threshold: float):
    """Score (B, H, 3, 3) hypotheses on (B, N) points; returns (best_h, count)."""
    errors = symmetric_epipolar_distance(Fs, pts1[:, None], pts2[:, None])
    best, _, count = ransac_select(errors, valid, threshold)
    return best, count


def fmat_score_select_cuda(Fs, pts1, pts2, valid, threshold: float):
    B, H = Fs.shape[:2]
    N = pts1.shape[1]
    dev = Fs.device
    if N > _K2_MAX_POINTS:
        raise ValueError(f"fmat_score_select: N={N} exceeds {_K2_MAX_POINTS}")
    _kernels.check_tensor(Fs, "Fs", torch.float32, (B, H, 3, 3), dev)
    _kernels.check_tensor(pts1, "pts1", torch.float32, (B, N, 2), dev)
    _kernels.check_tensor(pts2, "pts2", torch.float32, (B, N, 2), dev)
    _kernels.check_tensor(valid, "valid", torch.bool, (B, N), dev)
    best = torch.empty((B,), dtype=torch.int32, device=dev)
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    _kernels.launch("fmat_score_select", dev, Fs, pts1, pts2, valid,
                    B, H, N, float(threshold), best, count)
    return best.long(), count.long()


def fmat_score_select(Fs, pts1, pts2, valid, threshold: float):
    """Kernel K2 on a CUDA tensor, its plain twin on a CPU tensor."""
    if Fs.is_cuda:
        return fmat_score_select_cuda(Fs, pts1, pts2, valid, threshold)
    if Fs.device.type == "cpu":
        return fmat_score_select_plain(Fs, pts1, pts2, valid, threshold)
    raise ValueError(f"fmat_score_select: unsupported device {Fs.device}")


def estimate_fundamental_ransac(
    pts1,
    pts2,
    valid,
    iters: int = 2048,
    threshold: float = 3.0,
    prefix_valid: bool = False,
    score_budget: int = 0,
    generator: torch.Generator | None = None,
    indices: torch.Tensor | None = None,
):
    """Robust F for a batch of padded correspondence sets.

    pts1, pts2: (B, N, 2); valid: (B, N) bool. ``indices`` (B, iters, 8)
    replaces the draw from ``generator`` when given. Returns a dict of
    F (B, 3, 3), inliers (B, N), num_inliers (B,), errors (B, N), ok (B,).
    ``score_budget`` > 0 selects hypotheses on the first ``score_budget``
    rows only; the consensus refit and reported inliers use all rows.
    """
    pts1 = pts1.to(torch.float32)
    pts2 = pts2.to(torch.float32)
    valid = valid.to(torch.bool)
    B, N = valid.shape
    ok = valid.sum(-1) >= 8

    if indices is None:
        if generator is None:
            raise ValueError("estimate_fundamental_ransac needs a generator or indices")
        indices = ransac_sample_indices(valid, iters, 8, generator, prefix=prefix_valid)
    flat = indices.reshape(B, -1)
    gather = lambda p: torch.gather(p, 1, flat[..., None].expand(-1, -1, 2)).reshape(
        indices.shape + (2,))
    s1, s2 = gather(pts1), gather(pts2)          # (B, iters, 8, 2)
    Fs = eight_point(s1, s2, enforce_rank2=False, null_iters=3, null_fallback=False)

    if score_budget and score_budget < N:
        sc1, sc2, scv = pts1[:, :score_budget], pts2[:, :score_budget], valid[:, :score_budget]
    else:
        sc1, sc2, scv = pts1, pts2, valid
    best_h, _ = fmat_score_select(Fs.contiguous(), sc1.contiguous(), sc2.contiguous(),
                                  scv.contiguous(), threshold)

    F_best = Fs[torch.arange(B, device=Fs.device), best_h]
    err_h = symmetric_epipolar_distance(F_best, pts1, pts2)
    w = ((err_h < threshold) & valid).to(torch.float32)
    F = eight_point(pts1, pts2, w)
    final_err = symmetric_epipolar_distance(F, pts1, pts2)
    inliers = (final_err < threshold) & valid & ok[:, None]
    return {
        "F": F,
        "inliers": inliers,
        "num_inliers": inliers.sum(-1, dtype=torch.int32),
        "errors": final_err,
        "ok": ok,
    }
