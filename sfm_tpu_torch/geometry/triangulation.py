"""DLT triangulation, two-view and multi-view.

Counterpart of ``sfm_tpu/geometry/triangulation.py``. The null vector of the
row-normalized DLT system comes from inverse iteration on the 4x4 normal
matrix (:func:`sfm_tpu_torch.utils.linalg.smallest_eigvec`, adjugate path),
as in the reference. Kernel K7 (``csrc/triangulate_tracks.cu``) does the
same arithmetic per track row.
"""
from __future__ import annotations

import torch

from sfm_tpu_torch.utils.linalg import smallest_eigvec

_EPS = 1e-12


def _solve_dlt(A):
    """Smallest right singular vector of A (..., M, 4), dehomogenized to 3-D."""
    A = A / torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True), min=_EPS)
    X = smallest_eigvec(A.mT @ A)
    w = X[..., 3]
    w = torch.where(w.abs() < _EPS, torch.full_like(w, _EPS), w)
    return X[..., :3] / w[..., None]


def triangulate_two_view(P1, P2, pts1, pts2):
    """Two-view DLT. P1, P2: (..., 3, 4); pts1, pts2: (..., N, 2) -> (..., N, 3)."""
    def rows(P, pts):
        x, y = pts[..., 0:1], pts[..., 1:2]
        return x * P[..., None, 2, :] - P[..., None, 0, :], y * P[..., None, 2, :] - P[..., None, 1, :]

    a0, a1 = rows(P1, pts1)
    b0, b1 = rows(P2, pts2)
    return _solve_dlt(torch.stack([a0, a1, b0, b1], dim=-2))


def triangulate_multiview(Ps, pts, valid=None):
    """Masked multi-view DLT. Ps: (..., V, 3, 4); pts: (..., V, 2);
    valid: (..., V) bool (invalid views contribute zero rows). -> (..., 3)."""
    x, y = pts[..., 0:1], pts[..., 1:2]
    A = torch.cat([x * Ps[..., 2, :] - Ps[..., 0, :], y * Ps[..., 2, :] - Ps[..., 1, :]], dim=-2)
    if valid is not None:
        v = torch.cat([valid, valid], dim=-1).to(A.dtype)
        A = A * v[..., None]
    return _solve_dlt(A)
