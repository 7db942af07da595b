"""Small-matrix linear algebra for the eight-point solver.

Counterpart of ``sfm_tpu/utils/linalg.py::smallest_eigvec`` on its
5 <= n <= 16 path (the 9x9 normal matrices of ``eight_point``): shifted
inverse iteration on a Cholesky factor whose nonpositive pivots are clamped
to ``eps`` instead of failing. The clamp matters: with a rank-8 normal
matrix the last pivot is the null direction, and a clamped tiny pivot still
steers inverse iteration onto the null vector, where a failing library
factorization (``torch.linalg.cholesky_ex``) would leave garbage. The
factorization runs column by column over the whole batch; the triangular
solves are ``torch.linalg.solve_triangular``.
"""
from __future__ import annotations

import torch


def _cholesky_clamped(A: torch.Tensor, eps: float = 1e-30):
    """Cholesky of (..., n, n); returns (L, bad) where ``bad`` marks a
    nonpositive pivot (A not positive definite), clamped to ``eps``."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    bad = torch.zeros(A.shape[:-2], dtype=torch.bool, device=A.device)
    for j in range(n):
        s = A[..., j, j] - (L[..., j, :j] * L[..., j, :j]).sum(-1)
        bad = bad | (s <= 0)
        d = torch.sqrt(torch.clamp(s, min=eps))
        L[..., j, j] = d
        if j + 1 < n:
            r = A[..., j + 1:, j] - (L[..., j + 1:, :j] * L[..., j:j + 1, :j]).sum(-1)
            L[..., j + 1:, j] = r / d[..., None]
    return L, bad


def smallest_eigvec(A: torch.Tensor, iters: int = 8, shift: float = 1e-6,
                    fallback_shift: float = 1e-3, fallback: bool = True):
    """Eigenvector of the smallest eigenvalue of PSD (..., n, n), 5 <= n <= 16.

    Factor ``A + shift*mean_eig*I`` once, then ``iters`` normalized solves.
    With ``fallback`` the batch entries whose small-shift factorization hit
    a nonpositive pivot use the ``fallback_shift`` factor instead; RANSAC
    hypothesis solves pass ``fallback=False`` (a degenerate sample may
    yield junk that simply scores no consensus).
    """
    n = A.shape[-1]
    if not 5 <= n <= 16:
        raise ValueError(f"smallest_eigvec is ported for 5 <= n <= 16, got n={n}")
    mean_eig = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None] / n
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    L, bad = _cholesky_clamped(A + (shift * mean_eig + 1e-20) * eye)
    if fallback:
        L2, _ = _cholesky_clamped(A + (fallback_shift * mean_eig + 1e-20) * eye)
        L = torch.where(bad[..., None, None], L2, L)
    x = torch.ones(n, dtype=A.dtype, device=A.device) + 1e-3 * torch.arange(
        n, dtype=A.dtype, device=A.device)
    x = x.expand(A.shape[:-1]).unsqueeze(-1)
    Lt = L.mT
    for _ in range(iters):
        y = torch.linalg.solve_triangular(L, x, upper=False)
        y = torch.linalg.solve_triangular(Lt, y, upper=True)
        x = y / torch.clamp(torch.linalg.vector_norm(y, dim=-2, keepdim=True), min=1e-30)
    return x[..., 0]
