"""Fixed-budget RANSAC machinery: masked sampling and hypothesis selection.

Counterpart of ``sfm_tpu/estimators/ransac.py``. Draws come from an explicit
``torch.Generator`` (seeded from ``SfMConfig.seed`` by the callers), so they
differ from ``jax.random``'s; every estimator therefore also accepts
precomputed sample indices, which lets a test hand both packages the same
hypotheses.
"""
from __future__ import annotations

import torch

from sfm_tpu_torch import _kernels

# topk_rows sorts a row's top-k survivors in shared memory (8 bytes each on
# its route for rows that do not fit there).
_TOPK_MAX_K = 16384


def top_k_plain(x: torch.Tensor, k: int):
    """``lax.top_k`` on the last axis of a float32 tensor: largest first in
    IEEE total order (+0.0 above -0.0, a NaN above +inf, one with its sign
    bit set below -inf, as ``lax.top_k`` orders), ties to the lower index.

    ``torch.topk`` promises no order among ties and ``torch.sort`` takes -0.0
    and +0.0 as equal; a stable descending sort of the floats' bits mapped to
    integers of the same total order does neither.
    """
    bits = x.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    _, idx = torch.sort(key, dim=-1, descending=True, stable=True)
    idx = idx[..., :k]
    return torch.gather(x, -1, idx), idx


def top_k_rows(rows: torch.Tensor, k: int):
    """Kernel K4's ``topk_rows`` on a contiguous (R, n) float32 CUDA tensor:
    (values (R, k), indices (R, k) int64), ``lax.top_k``'s order."""
    R, n = rows.shape
    if k > min(n, _TOPK_MAX_K):
        raise ValueError(f"top_k: k={k} exceeds the row length {n} or {_TOPK_MAX_K}")
    dev = rows.device
    _kernels.check_tensor(rows, "x", torch.float32, (R, n), dev)
    vals = torch.empty((R, k), dtype=torch.float32, device=dev)
    idx = torch.empty((R, k), dtype=torch.int64, device=dev)
    _kernels.launch("topk_rows", dev, rows, R, n, k, vals, idx)
    return vals, idx


def top_k_cuda(x: torch.Tensor, k: int):
    n = x.shape[-1]
    rows = x if x.dim() == 2 else x.reshape(-1, n)
    if not rows.is_contiguous():
        rows = rows.contiguous()
    vals, idx = top_k_rows(rows, min(k, n))
    if x.dim() == 2:
        return vals, idx
    shape = x.shape[:-1] + (vals.shape[1],)
    return vals.view(shape), idx.view(shape)


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` on the last axis of a float32 tensor: kernel K4's
    ``topk_rows`` (``csrc/dog_select.cu``) on CUDA, :func:`top_k_plain` on CPU."""
    if x.is_cuda:
        return top_k_cuda(x, k)
    if x.device.type == "cpu":
        return top_k_plain(x, k)
    raise ValueError(f"top_k: unsupported device {x.device}")


def ransac_sample_indices(valid, iters: int, sample_size: int,
                          generator: torch.Generator, prefix: bool = False):
    """Draw ``iters`` samples of ``sample_size`` valid row indices.

    valid: (..., N) bool. Returns (..., iters, sample_size) int64.
    prefix=True (valid rows form a leading prefix, as in best-first match
    tables): uniform integers in [0, n_valid), with replacement.
    prefix=False: uniform noise over valid rows, top-k per hypothesis (a
    without-replacement sample).
    """
    lead = valid.shape[:-1]
    if prefix:
        n_valid = torch.clamp(valid.sum(-1, dtype=torch.int32), min=1)[..., None, None]
        u = torch.rand(lead + (iters, sample_size), generator=generator,
                       device=valid.device)
        return torch.minimum((u * n_valid).to(torch.int32), n_valid - 1).long()
    noise = torch.rand(lead + (iters, valid.shape[-1]), generator=generator,
                       device=valid.device)
    noise = torch.where(valid[..., None, :], noise, -torch.inf)
    return top_k(noise, sample_size)[1]


def ransac_select(errors, valid, threshold: float):
    """Best hypothesis of an (..., H, N) error matrix.

    Inliers are valid rows with error < threshold; the winner maximizes the
    count, with mean inlier error as the tie-breaker, first index on exact
    ties. Returns (best (...,), inlier mask (..., N), count (...,)).
    """
    inl = (errors < threshold) & valid[..., None, :]
    counts = inl.sum(-1)
    err_sum = torch.where(inl, errors, 0.0).sum(-1)
    mean_err = err_sum / torch.clamp(counts, min=1)
    score = counts.to(torch.float32) - mean_err / max(threshold, 1e-6)
    best = torch.argmax(score, dim=-1)
    pick = lambda t: torch.gather(t, -1, best[..., None])[..., 0]
    best_inl = torch.gather(inl, -2, best[..., None, None].expand(
        best.shape + (1, inl.shape[-1])))[..., 0, :]
    return best, best_inl, pick(counts)
