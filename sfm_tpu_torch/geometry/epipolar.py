"""Two-view epipolar geometry used by F-RANSAC.

Counterpart of ``sfm_tpu/geometry/epipolar.py``: ``normalize_points``,
``eight_point`` and ``symmetric_epipolar_distance``, batched over any
leading dimensions. Convention: ``x2^T F x1 = 0`` for homogeneous pixel
coordinates (OpenCV's). Estimators take a ``weights`` vector instead of a
boolean gather, so a row with weight 0 is excluded without changing shapes.
"""
from __future__ import annotations

import math

import torch

from sfm_tpu_torch.utils.linalg import smallest_eigvec

_EPS = 1e-12


def _homog(pts):
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def normalize_points(pts, weights=None):
    """Hartley normalization: centroid to the origin, mean norm to sqrt(2).

    pts: (..., N, 2); weights: (..., N) or None.
    Returns (pts_norm (..., N, 2), T (..., 3, 3)) with x_norm = T @ x_homog.
    """
    if weights is None:
        weights = torch.ones(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
    w = weights[..., None]
    wsum = torch.clamp(w.sum(-2, keepdim=True), min=_EPS)
    centroid = (pts * w).sum(-2, keepdim=True) / wsum
    centered = pts - centroid
    mean_dist = (torch.linalg.vector_norm(centered, dim=-1, keepdim=True) * w).sum(
        -2, keepdim=True) / wsum
    scale = math.sqrt(2.0) / torch.clamp(mean_dist, min=_EPS)
    pts_norm = centered * scale

    s = scale[..., 0, 0]
    cx = centroid[..., 0, 0]
    cy = centroid[..., 0, 1]
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    T = torch.stack(
        [
            torch.stack([s, zero, -s * cx], dim=-1),
            torch.stack([zero, s, -s * cy], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )
    return pts_norm, T


def eight_point(pts1, pts2, weights=None, enforce_rank2: bool = True,
                null_iters: int = 8, null_fallback: bool = True):
    """Weighted normalized eight-point estimate of F, unit Frobenius norm.

    pts1, pts2: (..., N, 2); weights: (..., N). ``enforce_rank2=False``
    skips the 3x3 SVD (hypothesis scoring is first-order insensitive to it).
    """
    if weights is None:
        weights = torch.ones(pts1.shape[:-1], dtype=pts1.dtype, device=pts1.device)
    n1, T1 = normalize_points(pts1, weights)
    n2, T2 = normalize_points(pts2, weights)

    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    ones = torch.ones_like(x1)
    # Row layout matches F.reshape(9): x2^T F x1 = A @ vec(F).
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], dim=-1)
    A = A * weights[..., None]

    AtA = A.mT @ A
    f = smallest_eigvec(AtA, iters=null_iters, fallback=null_fallback)
    F = f.reshape(f.shape[:-1] + (3, 3))

    if enforce_rank2:
        U, S, Vh = torch.linalg.svd(F)
        S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
        F = U @ (S[..., :, None] * Vh)

    # Denormalize: x2n^T Fn x1n = (T2 x2)^T Fn (T1 x1) -> F = T2^T Fn T1.
    F = T2.mT @ F @ T1
    return F / torch.clamp(torch.linalg.matrix_norm(F, keepdim=True), min=_EPS)


def symmetric_epipolar_distance(F, pts1, pts2):
    """Mean of the two point-to-epipolar-line distances, in pixels.

    F: (..., 3, 3); pts1, pts2: (..., N, 2), broadcast against F's leading
    dimensions. Lines in image 1 are F^T x2, in image 2 F x1.
    """
    x1 = _homog(pts1)
    x2 = _homog(pts2)
    l1 = x2 @ F       # (..., N, 3): F^T x2
    l2 = x1 @ F.mT    # (..., N, 3): F x1
    d1 = torch.abs((l1 * x1).sum(-1)) / torch.clamp(
        torch.linalg.vector_norm(l1[..., :2], dim=-1), min=_EPS)
    d2 = torch.abs((l2 * x2).sum(-1)) / torch.clamp(
        torch.linalg.vector_norm(l2[..., :2], dim=-1), min=_EPS)
    return 0.5 * (d1 + d2)


# ------------------------------------------------------- essential matrix + pose

def essential_from_fundamental(F, K1, K2=None):
    """E = K2^T F K1."""
    if K2 is None:
        K2 = K1
    return K2.mT @ F @ K1


def _cofactor(E):
    """Cofactor matrix of (..., 3, 3): Cof(E)[0] = E[1] x E[2], cyclic."""
    c0 = torch.linalg.cross(E[..., 1, :], E[..., 2, :])
    c1 = torch.linalg.cross(E[..., 2, :], E[..., 0, :])
    c2 = torch.linalg.cross(E[..., 0, :], E[..., 1, :])
    return torch.stack([c0, c1, c2], dim=-2)


def _skew(t):
    z = torch.zeros_like(t[..., 0])
    return torch.stack([
        torch.stack([z, -t[..., 2], t[..., 1]], dim=-1),
        torch.stack([t[..., 2], z, -t[..., 0]], dim=-1),
        torch.stack([-t[..., 1], t[..., 0], z], dim=-1),
    ], dim=-2)


def _orthonormalize(R, iters: int = 3):
    """Newton iteration toward the orthogonal polar factor:
    R <- 1.5 R - 0.5 R R^T R."""
    for _ in range(iters):
        R = 1.5 * R - 0.5 * (R @ R.mT @ R)
    return R


def decompose_essential(E):
    """E -> (R1, R2, t): the four candidate poses are (R{1,2}, +-t).

    Horn's closed form, no SVD: t = unit null vector of E E^T,
    R = Cof(E) - [t]x E (and the second rotation from -E).
    """
    En = E * (math.sqrt(2.0) / torch.clamp(
        torch.linalg.matrix_norm(E, keepdim=True), min=_EPS))
    t = smallest_eigvec(En @ En.mT)
    B = _skew(t)
    R1 = _orthonormalize(_cofactor(En) - B @ En)
    R2 = _orthonormalize(_cofactor(-En) - B @ (-En))
    return R1, R2, t


def _cheirality_counts(R, t, pts1, pts2, K, weights):
    """Cheirality for both (R, t) and (R, -t) from one triangulation: the
    DLT solution for -t is the mirrored point -X (see the reference)."""
    from sfm_tpu_torch.geometry.triangulation import triangulate_two_view

    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    zero = torch.zeros(R.shape[:-2] + (3, 1), dtype=R.dtype, device=R.device)
    P1 = K @ torch.cat([eye, zero], dim=-1)
    P2 = K @ torch.cat([R, t[..., None]], dim=-1)
    X = triangulate_two_view(P1, P2, pts1, pts2)
    z1 = X[..., 2]
    z2 = (X @ R[..., 2, :, None])[..., 0] + t[..., 2:3]
    good_p = (z1 > 0) & (z2 > 0)
    good_n = (z1 < 0) & (z2 < 0)
    return ((good_p * weights).sum(-1), good_p), ((good_n * weights).sum(-1), good_n)


def recover_pose(E, pts1, pts2, K, weights=None):
    """The (R, t) among E's four decompositions with the best cheirality.

    E: (..., 3, 3); pts: (..., N, 2); K: (3, 3); weights: (..., N).
    Returns (num_good, R, t, mask); ``t`` has unit norm, ``mask`` flags the
    rows in front of both cameras under the winning pose.
    """
    if weights is None:
        weights = torch.ones(pts1.shape[:-1], dtype=pts1.dtype, device=pts1.device)
    R1, R2, t = decompose_essential(E)
    (c1p, m1p), (c1n, m1n) = _cheirality_counts(R1, t, pts1, pts2, K, weights)
    (c2p, m2p), (c2n, m2n) = _cheirality_counts(R2, t, pts1, pts2, K, weights)
    counts = torch.stack([c1p, c1n, c2p, c2n], dim=-1)
    best = torch.argmax(counts, dim=-1)
    masks = torch.stack([m1p, m1n, m2p, m2n], dim=-2)
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)
    ts = torch.stack([t, -t, t, -t], dim=-2)
    pick = lambda x, tail: torch.gather(
        x, best.dim(), best.reshape(best.shape + (1,) * (len(tail) + 1)).expand(
            best.shape + (1,) + tail)).squeeze(best.dim())
    num = torch.gather(counts, -1, best[..., None])[..., 0]
    mask = pick(masks, masks.shape[-1:])
    return num, pick(Rs, (3, 3)), pick(ts, (3,)), mask & (weights > 0)
