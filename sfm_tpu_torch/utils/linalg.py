"""Small-matrix linear algebra: the null vectors of the geometry solvers.

Counterpart of ``sfm_tpu/utils/linalg.py::smallest_eigvec`` on its n <= 4
path (the 3x3 / 4x4 normal matrices of Horn's decomposition and the DLT
triangulation: inverse iteration with the explicit adjugate) and its
5 <= n <= 16 path (the 9x9 normal matrices of ``eight_point``): shifted
inverse iteration on a Cholesky factor whose nonpositive pivots are clamped
to ``eps`` instead of failing. The clamp matters: with a rank-8 normal
matrix the last pivot is the null direction, and a clamped tiny pivot still
steers inverse iteration onto the null vector, where a library
factorization that stops at the failing pivot would leave garbage. The
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


def _adjugate3(A: torch.Tensor):
    """adj(A) for (..., 3, 3): its columns are cross products of A's rows."""
    c0 = torch.linalg.cross(A[..., 1, :], A[..., 2, :])
    c1 = torch.linalg.cross(A[..., 2, :], A[..., 0, :])
    c2 = torch.linalg.cross(A[..., 0, :], A[..., 1, :])
    return torch.stack([c0, c1, c2], dim=-1)


def _adjugate4(A: torch.Tensor):
    """adj(A) for (..., 4, 4) by 2x2-minor (Laplace) expansion."""
    a = lambda i, j: A[..., i, j]
    s0 = a(0, 0) * a(1, 1) - a(1, 0) * a(0, 1)
    s1 = a(0, 0) * a(1, 2) - a(1, 0) * a(0, 2)
    s2 = a(0, 0) * a(1, 3) - a(1, 0) * a(0, 3)
    s3 = a(0, 1) * a(1, 2) - a(1, 1) * a(0, 2)
    s4 = a(0, 1) * a(1, 3) - a(1, 1) * a(0, 3)
    s5 = a(0, 2) * a(1, 3) - a(1, 2) * a(0, 3)
    c5 = a(2, 2) * a(3, 3) - a(3, 2) * a(2, 3)
    c4 = a(2, 1) * a(3, 3) - a(3, 1) * a(2, 3)
    c3 = a(2, 1) * a(3, 2) - a(3, 1) * a(2, 2)
    c2 = a(2, 0) * a(3, 3) - a(3, 0) * a(2, 3)
    c1 = a(2, 0) * a(3, 2) - a(3, 0) * a(2, 2)
    c0 = a(2, 0) * a(3, 1) - a(3, 0) * a(2, 1)
    rows = [
        [a(1, 1) * c5 - a(1, 2) * c4 + a(1, 3) * c3,
         -a(0, 1) * c5 + a(0, 2) * c4 - a(0, 3) * c3,
         a(3, 1) * s5 - a(3, 2) * s4 + a(3, 3) * s3,
         -a(2, 1) * s5 + a(2, 2) * s4 - a(2, 3) * s3],
        [-a(1, 0) * c5 + a(1, 2) * c2 - a(1, 3) * c1,
         a(0, 0) * c5 - a(0, 2) * c2 + a(0, 3) * c1,
         -a(3, 0) * s5 + a(3, 2) * s2 - a(3, 3) * s1,
         a(2, 0) * s5 - a(2, 2) * s2 + a(2, 3) * s1],
        [a(1, 0) * c4 - a(1, 1) * c2 + a(1, 3) * c0,
         -a(0, 0) * c4 + a(0, 1) * c2 - a(0, 3) * c0,
         a(3, 0) * s4 - a(3, 1) * s2 + a(3, 3) * s0,
         -a(2, 0) * s4 + a(2, 1) * s2 - a(2, 3) * s0],
        [-a(1, 0) * c3 + a(1, 1) * c1 - a(1, 2) * c0,
         a(0, 0) * c3 - a(0, 1) * c1 + a(0, 2) * c0,
         -a(3, 0) * s3 + a(3, 1) * s1 - a(3, 2) * s0,
         a(2, 0) * s3 - a(2, 1) * s1 + a(2, 2) * s0],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _smallest_eigvec_adjugate(A: torch.Tensor, iters: int, shift: float):
    """Inverse iteration for n in {3, 4} with the explicit adjugate:
    adj(A + shift) is proportional to (A + shift)^-1, and the determinant's
    scale and sign wash out in the normalization."""
    n = A.shape[-1]
    mean_eig = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None] / n
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    Ash = A + (shift * mean_eig + 1e-20) * eye
    M = _adjugate3(Ash) if n == 3 else _adjugate4(Ash)
    x = torch.ones(n, dtype=A.dtype, device=A.device) + 1e-3 * torch.arange(
        n, dtype=A.dtype, device=A.device)
    x = x.expand(A.shape[:-1])
    for _ in range(iters):
        y = (M @ x[..., None])[..., 0]
        x = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True), min=1e-30)
    return x


def smallest_eigvec(A: torch.Tensor, iters: int = 8, shift: float = 1e-6,
                    fallback_shift: float = 1e-3, fallback: bool = True):
    """Eigenvector of the smallest eigenvalue of PSD (..., n, n), 3 <= n <= 16.

    n in {3, 4}: inverse iteration with the adjugate (no factorization).
    5 <= n <= 16: factor ``A + shift*mean_eig*I`` once, then ``iters``
    normalized solves. With ``fallback`` the batch entries whose small-shift
    factorization hit a nonpositive pivot use the ``fallback_shift`` factor
    instead; RANSAC hypothesis solves pass ``fallback=False`` (a degenerate
    sample may yield junk that simply scores no consensus).
    """
    n = A.shape[-1]
    if n in (3, 4):
        return _smallest_eigvec_adjugate(A, iters, shift)
    if not 5 <= n <= 16:
        raise ValueError(f"smallest_eigvec is ported for 3 <= n <= 16, got n={n}")
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
