"""Fundamental-matrix RANSAC, batched over image pairs, and the verify gates.

Counterpart of ``sfm_tpu/estimators/fundamental.py`` (and of the gates of
``sfm_tpu/matching/verify.py::verify_pair``). Kernel K2 runs every device
step in one launch, ``fmat_ransac`` (``csrc/fmat_ransac.cu``): the
eight-point solve of every RANSAC sample, every hypothesis scored on the
scoring subset, the winner, the winner's consensus over all rows, the
weighted rank-2 refit, the final inliers and the verify gates. Its plain
twin :func:`fmat_ransac_plain` is the composition of
:func:`fmat_hypotheses_plain`, :func:`fmat_score_select_plain` and
:func:`fmat_refit_verify_plain`.
"""
from __future__ import annotations

import torch

from sfm_tpu_torch import _kernels
from sfm_tpu_torch.geometry.epipolar import eight_point, symmetric_epipolar_distance
from sfm_tpu_torch.estimators.ransac import ransac_sample_indices, ransac_select

# fmat_ransac: a thread block holds a pair's rows in shared memory.
_K2_MAX_ROWS = 1024
# fmat_ransac: hypotheses a thread block (csrc/fmat_ransac.cu's HT; the
# entry refuses another tile count).
_K2_TILE = 64
_EPS = 1e-12


def fmat_hypotheses_plain(pts1, pts2, indices):
    """Eight-point F of every sample: pts (B, N, 2), indices (B, H, 8) ->
    (B, H, 3, 3) unit-norm, rank 2 not enforced (3 inverse-iteration steps,
    no fallback tier: a degenerate sample gives junk that scores no consensus)."""
    B = pts1.shape[0]
    flat = indices.reshape(B, -1)
    gather = lambda p: torch.gather(p, 1, flat[..., None].expand(-1, -1, 2)).reshape(
        indices.shape + (2,))
    return eight_point(gather(pts1), gather(pts2), enforce_rank2=False, null_iters=3,
                       null_fallback=False)


def fmat_score_select_plain(Fs, pts1, pts2, valid, threshold: float):
    """Score (B, H, 3, 3) hypotheses on (B, N) points; returns (best_h, count)."""
    errors = symmetric_epipolar_distance(Fs, pts1[:, None], pts2[:, None])
    best, _, count = ransac_select(errors, valid, threshold)
    return best, count


def _masked_std(x, w):
    """Weighted std over the last axis."""
    n = torch.clamp(w.sum(-1), min=_EPS)
    mean = (x * w).sum(-1) / n
    var = (w * (x - mean[..., None]) ** 2).sum(-1) / n
    return torch.sqrt(var)


def fmat_refit_verify_plain(Fs, best, pts1, pts2, valid, threshold: float,
                            min_inliers: int = 15, min_inlier_ratio: float = 0.3,
                            max_reproj_error: float = 2.0, min_spread: float = 20.0):
    """From the winner ``best`` (B,) of the hypotheses Fs (B, H, 3, 3) on:
    its consensus over all (B, N) rows, the weighted eight-point refit with
    rank 2, the final inliers, and ``verify_pair``'s gates (>= 8 valid rows,
    inlier count and ratio, mean inlier error, point spread on both axes of
    both images). Returns F, inliers, errors, num_matches, num_inliers,
    inlier_ratio, reprojection_error, well_distributed, accept, ok."""
    B = valid.shape[0]
    ok = valid.sum(-1) >= 8
    F_best = Fs[torch.arange(B, device=Fs.device), best]
    err_h = symmetric_epipolar_distance(F_best, pts1, pts2)
    w = ((err_h < threshold) & valid).to(torch.float32)
    F = eight_point(pts1, pts2, w)
    final_err = symmetric_epipolar_distance(F, pts1, pts2)
    inl = (final_err < threshold) & valid & ok[:, None]

    wi = inl.to(torch.float32)
    n_matches = valid.sum(-1, dtype=torch.int32)
    n_inl = inl.sum(-1, dtype=torch.int32)
    ratio = n_inl.to(torch.float32) / torch.clamp(n_matches.to(torch.float32), min=1.0)
    mean_err = torch.where(inl, final_err, 0.0).sum(-1) / torch.clamp(
        n_inl.to(torch.float32), min=1.0)
    spread_ok = (
        (_masked_std(pts1[..., 0], wi) > min_spread)
        & (_masked_std(pts1[..., 1], wi) > min_spread)
        & (_masked_std(pts2[..., 0], wi) > min_spread)
        & (_masked_std(pts2[..., 1], wi) > min_spread)
    )
    accept = (ok & (n_inl >= min_inliers) & (ratio >= min_inlier_ratio)
              & (mean_err <= max_reproj_error) & spread_ok)
    return {"F": F, "inliers": inl, "errors": final_err, "num_matches": n_matches,
            "num_inliers": n_inl, "inlier_ratio": ratio, "reprojection_error": mean_err,
            "well_distributed": spread_ok, "accept": accept, "ok": ok}


def fmat_ransac_plain(pts1, pts2, valid, indices, threshold: float, score_budget: int = 0,
                      min_inliers: int = 15, min_inlier_ratio: float = 0.3,
                      max_reproj_error: float = 2.0, min_spread: float = 20.0):
    """K2 from the drawn samples on, in plain PyTorch: the hypotheses
    (:func:`fmat_hypotheses_plain`), the winner on the first ``score_budget``
    rows (:func:`fmat_score_select_plain`; all rows when 0 or >= N) and the
    refit with the gates (:func:`fmat_refit_verify_plain`). Returns the refit's
    dict with ``Fs`` (B, H, 3, 3), ``best`` and ``count`` (B,) added."""
    N = valid.shape[1]
    Fs = fmat_hypotheses_plain(pts1, pts2, indices)
    n = score_budget if score_budget and score_budget < N else N
    best, count = fmat_score_select_plain(Fs, pts1[:, :n].contiguous(), pts2[:, :n].contiguous(),
                                          valid[:, :n].contiguous(), threshold)
    out = fmat_refit_verify_plain(Fs, best, pts1, pts2, valid, threshold, min_inliers,
                                  min_inlier_ratio, max_reproj_error, min_spread)
    return {"Fs": Fs, "best": best, "count": count, **out}


def fmat_ransac_cuda(pts1, pts2, valid, indices, threshold: float, score_budget: int = 0,
                     min_inliers: int = 15, min_inlier_ratio: float = 0.3,
                     max_reproj_error: float = 2.0, min_spread: float = 20.0):
    B, N = valid.shape
    H = indices.shape[1]
    dev = pts1.device
    if N > _K2_MAX_ROWS:
        raise ValueError(f"fmat_ransac: N={N} exceeds {_K2_MAX_ROWS}")
    _kernels.check_tensor(pts1, "pts1", torch.float32, (B, N, 2), dev)
    _kernels.check_tensor(pts2, "pts2", torch.float32, (B, N, 2), dev)
    _kernels.check_tensor(valid, "valid", torch.bool, (B, N), dev)
    _kernels.check_tensor(indices, "indices", torch.int64, (B, H, 8), dev)
    n = score_budget if score_budget and score_budget < N else N
    tiles = -(-H // _K2_TILE)
    # Per pair a ticket and each tile's best; the kernel needs it zero.
    work = torch.zeros((B, 1 + 3 * tiles), dtype=torch.int32, device=dev)
    e = lambda dt, *sh: torch.empty(sh, dtype=dt, device=dev)
    f32, i32, i64, b8 = torch.float32, torch.int32, torch.int64, torch.bool
    out = {"Fs": e(f32, B, H, 3, 3), "best": e(i64, B), "count": e(i64, B),
           "F": e(f32, B, 3, 3), "inliers": e(b8, B, N), "errors": e(f32, B, N),
           "num_matches": e(i32, B), "num_inliers": e(i32, B), "inlier_ratio": e(f32, B),
           "reprojection_error": e(f32, B), "well_distributed": e(b8, B), "accept": e(b8, B),
           "ok": e(b8, B)}
    _kernels.launch("fmat_ransac", dev, pts1, pts2, valid, indices, B, H, N, n, tiles,
                    float(threshold), int(min_inliers), float(min_inlier_ratio),
                    float(max_reproj_error), float(min_spread), work, *out.values())
    return out


def fmat_ransac(pts1, pts2, valid, indices, threshold: float, score_budget: int = 0,
                min_inliers: int = 15, min_inlier_ratio: float = 0.3,
                max_reproj_error: float = 2.0, min_spread: float = 20.0):
    """Kernel K2 ``fmat_ransac`` on CUDA tensors, :func:`fmat_ransac_plain` on CPU."""
    args = (pts1, pts2, valid, indices, threshold, score_budget, min_inliers,
            min_inlier_ratio, max_reproj_error, min_spread)
    if pts1.is_cuda:
        return fmat_ransac_cuda(*args)
    if pts1.device.type == "cpu":
        return fmat_ransac_plain(*args)
    raise ValueError(f"fmat_ransac: unsupported device {pts1.device}")


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
    min_inliers: int = 15,
    min_inlier_ratio: float = 0.3,
    max_reproj_error: float = 2.0,
    min_spread: float = 20.0,
):
    """Robust F for a batch of padded correspondence sets, and its gates.

    pts1, pts2: (B, N, 2); valid: (B, N) bool. ``indices`` (B, iters, 8)
    replaces the draw from ``generator`` when given. ``score_budget`` > 0
    selects hypotheses on the first ``score_budget`` rows only; the consensus
    refit and reported inliers use all rows. Returns the
    :func:`fmat_refit_verify_plain` dict: F (B, 3, 3), inliers (B, N),
    num_inliers (B,), errors (B, N), ok (B,) and the verify gates' fields.
    """
    pts1 = pts1.to(torch.float32).contiguous()
    pts2 = pts2.to(torch.float32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    if indices is None:
        if generator is None:
            raise ValueError("estimate_fundamental_ransac needs a generator or indices")
        indices = ransac_sample_indices(valid, iters, 8, generator, prefix=prefix_valid)
    out = fmat_ransac(pts1, pts2, valid, indices.to(torch.int64).contiguous(), threshold,
                      score_budget, min_inliers, min_inlier_ratio, max_reproj_error, min_spread)
    return {k: v for k, v in out.items() if k not in ("Fs", "best", "count")}
