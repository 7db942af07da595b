"""Global SfM initialization and pose-graph polish on one named device.

Counterpart of ``sfm_tpu/reconstruction/global_init.py`` (all of it but the
``mesh`` arguments). Its three device programs are kernel K13 on CUDA
tensors, each with a plain PyTorch twin for CPU tensors:

* :func:`relpose` -- the relative pose of every averaging pair: weighted
  eight-point E, ``recover_pose``, 10 Gauss-Newton steps on the Sampson
  residual, ``recover_pose`` again (``csrc/relpose.cu``; twin
  :func:`relpose_plain`);
* :func:`rotation_average` -- spectral init + Lie-algebra IRLS
  (``csrc/rotation_average.cu``; twin :func:`rotation_average_plain`);
* :func:`translation_average` -- the ridge-sign solve, the init score and
  the scale-explicit ALS rounds (``csrc/translation_average.cu``; twin
  :func:`translation_average_plain`).

The kernels apply the averaging operators as passes over each camera's
incident pairs; the twins keep the reference's dense (3N, 3N) and (N, N)
matrices. The rest is host numpy / scipy, as in the reference: the pair-row
choice and inlier subsample of :func:`pairwise_relative_poses`,
:func:`spanning_forest`, the tree inits, :func:`cycle_consistency_weights`,
:func:`global_poses`, :func:`polish_poses` and
:func:`pair_rotation_residuals`.

Convention: x_j = R_ij x_i + t_ij with |t_ij| = 1; poses are the engine's
x_cam = R x_world + t (t = -R C).
"""
from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from sfm_tpu_torch import _kernels
from sfm_tpu_torch.config import GlobalInitConfig
from sfm_tpu_torch.geometry.epipolar import eight_point, recover_pose
from sfm_tpu_torch.geometry.rotations import rodrigues, rotation_to_rvec, skew
from sfm_tpu_torch.utils.linalg import _cholesky_clamped

logger = logging.getLogger(__name__)

_EPS = 1e-12
# relpose: one thread a row (global_init.pair_matches <= 256).
_RELPOSE_MAX_ROWS = 256
# rotation_average / translation_average: up to this many cameras the
# solve's state (25 N and 21 N floats) lives in the shared memory of its one
# block; above it, in a global scratch (the same arithmetic, any N).
_AVG_SHARED_CAMERAS = 1024


# ------------------------------------------------------------ K13-a: relative poses

def _solve6(H, g):
    """SPD (..., 6, 6) solve by the reference's unrolled Cholesky (pivots
    clamped at 1e-30) and forward / back substitution."""
    L, _bad = _cholesky_clamped(H)
    n = H.shape[-1]
    y = [None] * n
    for i in range(n):
        s = g[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s / L[..., i, i]
    z = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * z[k]
        z[i] = s / L[..., i, i]
    return torch.stack(z, dim=-1)


def _sampson(params, x1, x2, wts):
    """Weighted Sampson residual (S,) of E = [t]x R(rvec), params (6,)."""
    E = skew(params[3:]) @ rodrigues(params[:3])
    one = torch.ones_like(x1[:, :1])
    x1h = torch.cat([x1, one], 1)
    x2h = torch.cat([x2, one], 1)
    Ex1 = x1h @ E.mT
    Etx2 = x2h @ E
    num = (x2h * Ex1).sum(1)
    den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    return wts * num / torch.sqrt(torch.clamp(den, min=1e-12))


def relpose_plain(xn1, xn2, w, iters: int = 10):
    """Relative pose of P pairs from S normalized rows each (twin of K13-a).

    xn1, xn2: (P, S, 2) normalized camera coordinates; w: (P, S) inlier
    weights (0/1). Returns (R (P, 3, 3), t (P, 3) unit, cheirality_good
    (P,) float): eight_point (rank 2 by SVD), recover_pose with K = I,
    ``iters`` Gauss-Newton steps on the Sampson residual (``jacfwd``), and
    recover_pose of the refined E.
    """
    eye3 = torch.eye(3, dtype=xn1.dtype, device=xn1.device)
    E = eight_point(xn1, xn2, weights=w)
    _n, R, t, mask = recover_pose(E, xn1, xn2, eye3, weights=w)
    params = torch.cat([rotation_to_rvec(R), t], dim=-1)
    wr = w * mask
    jac = torch.func.vmap(torch.func.jacfwd(_sampson))
    res = torch.func.vmap(_sampson)
    eye6 = torch.eye(6, dtype=xn1.dtype, device=xn1.device)
    for _ in range(iters):
        J = jac(params, xn1, xn2, wr)                           # (P, S, 6)
        r = res(params, xn1, xn2, wr)                           # (P, S)
        H = J.mT @ J
        # Gauge: E is invariant to |t| -- block that direction; ridge relative
        # to H's own scale; clip the step.
        tdir = torch.cat([torch.zeros_like(params[:, :3]), params[:, 3:]], dim=-1)
        tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
        H = H + tdir[:, :, None] * tdir[:, None, :] + (1e-4 * tr / 6 + 1e-12)[:, None, None] * eye6
        step = _solve6(H, (J.mT @ r[..., None])[..., 0])
        step = step * torch.clamp(
            0.5 / torch.clamp(torch.linalg.vector_norm(step, dim=-1, keepdim=True), min=1e-12),
            max=1.0)
        params = params - step
        tn = torch.clamp(torch.linalg.vector_norm(params[:, 3:], dim=-1, keepdim=True), min=1e-9)
        params = torch.cat([params[:, :3], params[:, 3:] / tn], dim=-1)
    E2 = skew(params[:, 3:]) @ rodrigues(params[:, :3])
    n2, R2, t2, _ = recover_pose(E2, xn1, xn2, eye3, weights=w)
    return R2, t2, n2


def relpose_cuda(xn1, xn2, w, iters: int = 10):
    P, S, _ = xn1.shape
    dev = xn1.device
    if not 1 <= S <= _RELPOSE_MAX_ROWS:
        raise ValueError(f"relpose: {S} rows a pair; the kernel takes 1..{_RELPOSE_MAX_ROWS}")
    _kernels.check_tensor(xn1, "xn1", torch.float32, (P, S, 2), dev)
    _kernels.check_tensor(xn2, "xn2", torch.float32, (P, S, 2), dev)
    _kernels.check_tensor(w, "w", torch.float32, (P, S), dev)
    R = torch.empty((P, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((P, 3), dtype=torch.float32, device=dev)
    good = torch.empty((P,), dtype=torch.float32, device=dev)
    _kernels.launch("relpose", dev, xn1, xn2, w, P, S, int(iters), R, t, good)
    return R, t, good


def relpose(xn1, xn2, w, iters: int = 10):
    """Kernel K13-a on CUDA tensors, :func:`relpose_plain` on CPU tensors."""
    if xn1.is_cuda:
        return relpose_cuda(xn1, xn2, w, iters)
    if xn1.device.type == "cpu":
        return relpose_plain(xn1, xn2, w, iters)
    raise ValueError(f"relpose: unsupported device {xn1.device}")


def pairwise_relative_poses(table, K, min_inliers: int = 15, refine_gn_iters: int = 10,
                            max_matches: int = 256, *, device):
    """Relative (R_ij, t_ij) for every accepted pair with enough inliers.

    The reference's host preparation: accepted pairs with >= min_inliers
    inliers, plus each otherwise pairless image's best accepted pair; the
    first ``max_matches`` inlier slots of each (stable argsort), in
    normalized coordinates. Then :func:`relpose` on ``device``.

    Returns dict of host arrays: ``pairs`` (P, 2) int32, ``R`` (P, 3, 3),
    ``t`` (P, 3), ``weight`` (P,) float32 (inlier count),
    ``cheirality_good`` (P,).
    """
    rows = np.nonzero(table.accept & (table.num_inliers >= min_inliers))[0]
    n_nodes = int(table.pairs.max(initial=0)) + 1
    deg = np.bincount(table.pairs[rows].ravel(), minlength=n_nodes)
    acc = np.nonzero(table.accept)[0]
    extra = []
    for img in np.nonzero(deg == 0)[0]:
        cand = acc[(table.pairs[acc] == img).any(axis=1)]
        if len(cand):
            extra.append(cand[np.argmax(table.num_inliers[cand])])
    if extra:
        rows = np.unique(np.concatenate([rows, np.asarray(extra)]))
    if len(rows) == 0:
        raise ValueError("no accepted pairs to average over")

    K = np.asarray(K, np.float32)
    f = np.array([K[0, 0], K[1, 1]], np.float32)
    c = np.array([K[0, 2], K[1, 2]], np.float32)
    inl = table.inliers[rows] & table.match_valid[rows]
    xy1 = table.xy1[rows]
    xy2 = table.xy2[rows]
    S = max_matches
    if xy1.shape[1] > S:
        order = np.argsort(~inl, axis=1, kind="stable")[:, :S]
        ridx = np.arange(len(rows))[:, None]
        xy1 = xy1[ridx, order]
        xy2 = xy2[ridx, order]
        inl = inl[ridx, order]
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
    R, t, n_good = relpose(as_t((xy1 - c) / f), as_t((xy2 - c) / f), as_t(inl),
                           refine_gn_iters)
    return {
        "pairs": table.pairs[rows].astype(np.int32),
        "R": R.cpu().numpy(),
        "t": t.cpu().numpy(),
        "weight": np.asarray(table.num_inliers[rows], np.float32),
        "cheirality_good": n_good.cpu().numpy(),
    }


# ------------------------------------------------------------ rotation algebra

def nearest_rotation(A):
    """Nearest det = +1 rotation to (..., 3, 3) by the Davenport q-method:
    24 power steps on B + c I from the one-hot start at B's largest
    diagonal entry (lands in SO(3) even when det(A) < 0)."""
    a11, a12, a13 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a21, a22, a23 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a31, a32, a33 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    B = torch.stack([
        torch.stack([a11 + a22 + a33, a32 - a23, a13 - a31, a21 - a12], -1),
        torch.stack([a32 - a23, a11 - a22 - a33, a12 + a21, a13 + a31], -1),
        torch.stack([a13 - a31, a12 + a21, a22 - a11 - a33, a23 + a32], -1),
        torch.stack([a21 - a12, a13 + a31, a23 + a32, a33 - a11 - a22], -1),
    ], -2)
    c = torch.linalg.matrix_norm(A, keepdim=True) * 2.0 + 1e-6
    Bs = B + c * torch.eye(4, dtype=A.dtype, device=A.device)
    diag = torch.diagonal(B, dim1=-2, dim2=-1)
    q = torch.nn.functional.one_hot(torch.argmax(diag, dim=-1), 4).to(A.dtype)
    for _ in range(24):
        q = (Bs @ q[..., None])[..., 0]
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _log_so3(R):
    """Rotation log (..., 3, 3) -> (..., 3), branchless small/large angle."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    sin_t = torch.clamp(torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0)), min=_EPS)
    scale = torch.where(theta < 1e-4, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_t))
    return v * scale[..., None]


def _gram_schmidt3(X):
    """Orthonormalize the 3 columns of (M, 3), closed form."""
    c0 = X[:, 0] / torch.clamp(torch.linalg.vector_norm(X[:, 0]), min=_EPS)
    c1 = X[:, 1] - (c0 @ X[:, 1]) * c0
    c1 = c1 / torch.clamp(torch.linalg.vector_norm(c1), min=_EPS)
    c2 = X[:, 2] - (c0 @ X[:, 2]) * c0 - (c1 @ X[:, 2]) * c1
    c2 = c2 / torch.clamp(torch.linalg.vector_norm(c2), min=_EPS)
    return torch.stack([c0, c1, c2], dim=1)


def _cg(A, b, iters: int, x0=None):
    """Conjugate gradient for SPD (N, N) against (N, k), ``iters`` steps; the
    scalars are sums over the whole right-hand side."""
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - A @ x0
    p = r
    rs = (r * r).sum()
    for _ in range(iters):
        Ap = A @ p
        alpha = rs / torch.clamp((p * Ap).sum(), min=_EPS)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = (r * r).sum()
        p = r + (rs_new / torch.clamp(rs, min=_EPS)) * p
        rs = rs_new
    return x


def _laplacian(i_idx, j_idx, wp, N):
    L = torch.zeros((N, N), dtype=wp.dtype, device=wp.device)
    L.index_put_((i_idx, j_idx), -wp, accumulate=True)
    L.index_put_((j_idx, i_idx), -wp, accumulate=True)
    L.index_put_((i_idx, i_idx), wp, accumulate=True)
    L.index_put_((j_idx, j_idx), wp, accumulate=True)
    return L + 1e-6 * torch.eye(N, dtype=wp.dtype, device=wp.device)


def _pair_sum(i_idx, j_idx, v, N):
    """(N, 3): + v at j, - v at i."""
    b = torch.zeros((N, 3), dtype=v.dtype, device=v.device)
    return b.index_add(0, j_idx, v).index_add(0, i_idx, -v)


# ------------------------------------------------------------ K13-b: rotation averaging

def rotation_average_plain(pairs, R_rel, w, X, power_iters: int = 48, refine_iters: int = 10):
    """The reference's rotation-averaging program (twin of K13-b).

    pairs (P, 2) int; R_rel (P, 3, 3); w (P,) normalized weights; X (3N, 3)
    the stacked start. Power iteration on the dense degree-normalized block
    matrix G (+ I) with Gram-Schmidt, nearest_rotation per block, then
    ``refine_iters`` Huber-IRLS rounds with 32 CG steps each on the dense
    Laplacian. Returns R_abs (N, 3, 3).
    """
    N = X.shape[0] // 3
    dt, dev = X.dtype, X.device
    i_idx, j_idx = pairs[:, 0].long(), pairs[:, 1].long()
    ar = torch.arange(3, device=dev)
    rows3 = (3 * i_idx[:, None, None] + ar[None, :, None]).expand(-1, 3, 3)
    cols3 = (3 * j_idx[:, None, None] + ar[None, None, :]).expand(-1, 3, 3)
    Rt_w = R_rel.mT * w[:, None, None]
    G = torch.zeros((3 * N, 3 * N), dtype=dt, device=dev)
    G.index_put_((rows3, cols3), Rt_w, accumulate=True)
    G.index_put_((cols3.mT, rows3.mT), Rt_w.mT, accumulate=True)
    deg = torch.zeros(N, dtype=dt, device=dev).index_add(0, i_idx, w).index_add(0, j_idx, w)
    Gn = G * torch.repeat_interleave(1.0 / torch.clamp(deg, min=1.0), 3)[:, None]
    for _ in range(power_iters):
        X = _gram_schmidt3(Gn @ X + X)
    R_abs = nearest_rotation(X.reshape(N, 3, 3))
    eye = torch.eye(3, dtype=dt, device=dev)
    for k in range(refine_iters):
        delta = max(0.3 * (0.6 ** k), 0.02)
        E = torch.einsum("pba,pbc,pcd->pad", R_abs[j_idx], R_rel, R_abs[i_idx])
        r = _log_so3(E)
        rn = torch.linalg.vector_norm(r, dim=-1)
        wp = w * torch.where(rn > delta, delta / torch.clamp(rn, min=_EPS), 1.0)
        d = _cg(_laplacian(i_idx, j_idx, wp, N), _pair_sum(i_idx, j_idx, wp[:, None] * r, N),
                iters=32)
        S = skew(d)
        R_abs = R_abs @ nearest_rotation(eye + S + 0.5 * (S @ S))
    return R_abs


def _avg_state(floats_a_camera: int, N: int, dev):
    """K13-b/c's global state scratch above ``_AVG_SHARED_CAMERAS`` cameras;
    None (a null pointer: the state in shared memory) at or below it."""
    if N <= _AVG_SHARED_CAMERAS:
        return None
    return torch.empty((floats_a_camera * N,), dtype=torch.float32, device=dev)


def rotation_average_cuda(pairs, R_rel, w, X, power_iters: int = 48, refine_iters: int = 10):
    P, N = pairs.shape[0], X.shape[0] // 3
    dev = X.device
    if N < 1:
        raise ValueError("rotation_average: no cameras")
    _kernels.check_tensor(pairs, "pairs", torch.int32, (P, 2), dev)
    _kernels.check_tensor(R_rel, "R_rel", torch.float32, (P, 3, 3), dev)
    _kernels.check_tensor(w, "w", torch.float32, (P,), dev)
    _kernels.check_tensor(X, "X", torch.float32, (3 * N, 3), dev)
    off = torch.empty((N + 1,), dtype=torch.int32, device=dev)
    adj = torch.empty((max(2 * P, 1),), dtype=torch.int32, device=dev)
    scratch = torch.empty((max(4 * P, 1),), dtype=torch.float32, device=dev)
    state = _avg_state(25, N, dev)
    R = torch.empty((N, 3, 3), dtype=torch.float32, device=dev)
    _kernels.launch("rotation_average", dev, pairs, R_rel, w, X, P, N, int(power_iters),
                    int(refine_iters), off, adj, scratch, state, R)
    return R


def rotation_average(pairs, R_rel, w, X, power_iters: int = 48, refine_iters: int = 10):
    """Kernel K13-b on CUDA tensors, :func:`rotation_average_plain` on CPU."""
    args = (pairs, R_rel, w, X, power_iters, refine_iters)
    if X.is_cuda:
        return rotation_average_cuda(*args)
    if X.device.type == "cpu":
        return rotation_average_plain(*args)
    raise ValueError(f"rotation_average: unsupported device {X.device}")


def _normalized(weights):
    w = np.asarray(weights, np.float32)
    return w / np.float32(max(float(np.mean(w)), _EPS)) if len(w) else w


def rotation_averaging(pairs, R_rel, weights, num_images, power_iters: int = 48,
                       refine_iters: int = 10, init=None, *, device):
    """Absolute rotations (N, 3, 3) from pairwise R_ij (x_j = R_ij x_i ...).

    ``init``: optional (N, 3, 3) start (:func:`tree_init_rotations`); the
    identity stack otherwise. Runs :func:`rotation_average` on ``device``.
    """
    N = num_images
    X0 = (np.tile(np.eye(3, dtype=np.float32), (N, 1)) if init is None
          else np.asarray(init, np.float32).reshape(3 * N, 3))
    as_t = lambda a, dt=torch.float32: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                                       device=device)
    R = rotation_average(as_t(pairs, torch.int32), as_t(R_rel), as_t(_normalized(weights)),
                         as_t(X0), power_iters, refine_iters)
    return R.cpu().numpy()


# ------------------------------------------------------------ K13-c: translation averaging

def _residual_weights(C, i_idx, j_idx, d, w):
    base = C[j_idx] - C[i_idx]
    bn = torch.clamp(torch.linalg.vector_norm(base, dim=-1), min=_EPS)
    proj = (base * d).sum(-1)
    sin_res = torch.linalg.vector_norm(base - proj[:, None] * d, dim=-1) / bn
    wp = w * torch.where(sin_res > 0.05, 0.05 / sin_res, 1.0)
    return torch.where(proj < 0, wp * 1e-2, wp), proj


def translation_average_plain(pairs, d, w, C, als_rounds: int = 3, cg_iters: int = 80,
                              has_init: bool = False):
    """The reference's translation-averaging program (twin of K13-c).

    pairs (P, 2) int; d (P, 3) unit baseline directions (C_j - C_i); w (P,)
    normalized weights; C (N, 3) the init (read when ``has_init``). Returns
    centred camera centers (N, 3), before the host's scale gauge.
    """
    N = C.shape[0]
    dt, dev = C.dtype, C.device
    i_idx, j_idx = pairs[:, 0].long(), pairs[:, 1].long()
    ar = torch.arange(3, device=dev)
    rows3 = (3 * i_idx[:, None, None] + ar[None, :, None]).expand(-1, 3, 3)
    cols3 = (3 * j_idx[:, None, None] + ar[None, None, :]).expand(-1, 3, 3)
    rows_t, cols_t = rows3.mT, cols3.mT
    Proj = torch.eye(3, dtype=dt, device=dev)[None] - d[:, :, None] * d[:, None, :]

    def assemble(wp):
        B = wp[:, None, None] * Proj
        M = torch.zeros((3 * N, 3 * N), dtype=dt, device=dev)
        M.index_put_((rows3, rows_t), B, accumulate=True)
        M.index_put_((cols_t, cols3), B, accumulate=True)
        M.index_put_((rows3, cols3), -B, accumulate=True)
        M.index_put_((cols_t, rows_t), -B, accumulate=True)
        return M, _pair_sum(i_idx, j_idx, wp[:, None] * d, N).reshape(-1)

    C_r = C * 0.0
    wp = w
    for k in range(max(als_rounds, 1)):
        if k > 0:
            wp, _ = _residual_weights(C_r, i_idx, j_idx, d, w)
        M, q = assemble(wp)
        eps = 1e-3 * torch.trace(M) / (3 * N) + 1e-8
        x = _cg(M + eps * torch.eye(3 * N, dtype=dt, device=dev), q[:, None],
                iters=cg_iters)[:, 0]
        C_r = x.reshape(N, 3)
        C_r = C_r - C_r.mean(0, keepdim=True)
    if not has_init:
        return C_r

    def score(Ce):
        base = Ce[j_idx] - Ce[i_idx]
        bn = torch.clamp(torch.linalg.vector_norm(base, dim=-1), min=_EPS)
        cos = (base * d).sum(-1) / bn
        return (w * (1.0 - cos)).sum() / torch.clamp(w.sum(), min=_EPS)

    C = torch.where(score(C_r) <= score(C), C_r, C)
    for _ in range(max(als_rounds, 1)):
        wp, proj = _residual_weights(C, i_idx, j_idx, d, w)
        s_p = torch.clamp(proj.abs(), min=0.05 * proj.abs().mean())
        b = _pair_sum(i_idx, j_idx, wp[:, None] * (s_p[:, None] * d), N)
        C = _cg(_laplacian(i_idx, j_idx, wp, N), b, iters=cg_iters, x0=C)
        C = C - C.mean(0, keepdim=True)
    return C


def translation_average_cuda(pairs, d, w, C, als_rounds: int = 3, cg_iters: int = 80,
                             has_init: bool = False):
    P, N = pairs.shape[0], C.shape[0]
    dev = C.device
    if N < 1 or P < 1:
        raise ValueError(f"translation_average: {N} cameras, {P} pairs; the kernel takes "
                         "at least one of each")
    _kernels.check_tensor(pairs, "pairs", torch.int32, (P, 2), dev)
    _kernels.check_tensor(d, "d", torch.float32, (P, 3), dev)
    _kernels.check_tensor(w, "w", torch.float32, (P,), dev)
    _kernels.check_tensor(C, "C", torch.float32, (N, 3), dev)
    off = torch.empty((N + 1,), dtype=torch.int32, device=dev)
    adj = torch.empty((2 * P,), dtype=torch.int32, device=dev)
    scratch = torch.empty((2 * P,), dtype=torch.float32, device=dev)
    state = _avg_state(21, N, dev)
    out = torch.empty((N, 3), dtype=torch.float32, device=dev)
    _kernels.launch("translation_average", dev, pairs, d, w, C, P, N, int(als_rounds),
                    int(cg_iters), int(bool(has_init)), off, adj, scratch, state, out)
    return out


def translation_average(pairs, d, w, C, als_rounds: int = 3, cg_iters: int = 80,
                        has_init: bool = False):
    """Kernel K13-c on CUDA tensors, :func:`translation_average_plain` on CPU."""
    args = (pairs, d, w, C, als_rounds, cg_iters, has_init)
    if C.is_cuda:
        return translation_average_cuda(*args)
    if C.device.type == "cpu":
        return translation_average_plain(*args)
    raise ValueError(f"translation_average: unsupported device {C.device}")


def translation_averaging(pairs, R_abs, t_rel, weights, num_images, als_rounds: int = 3,
                          cg_iters: int = 80, init=None, *, device):
    """Camera centers (N, 3) from pairwise baseline directions.

    Each pair fixes the direction d = unit(-R_j^T t_ij) of C_j - C_i.
    :func:`translation_average` on ``device``; then the scale gauge on the
    host: median pair baseline = 1.
    """
    N = num_images
    pairs = np.asarray(pairs)
    i_idx, j_idx = pairs[:, 0], pairs[:, 1]
    d = -np.einsum("pba,pb->pa", np.asarray(R_abs, np.float32)[j_idx],
                   np.asarray(t_rel, np.float32))
    d = (d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), _EPS)).astype(np.float32)
    C0 = np.zeros((N, 3), np.float32) if init is None else np.asarray(init, np.float32)
    as_t = lambda a, dt=torch.float32: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                                       device=device)
    C = translation_average(as_t(pairs, torch.int32), as_t(d), as_t(_normalized(weights)),
                            as_t(C0), als_rounds, cg_iters, init is not None).cpu().numpy()
    base = np.linalg.norm(C[j_idx] - C[i_idx], axis=-1)
    med = float(np.median(base)) if len(base) else 1.0
    return C / max(med, 1e-12)


# ------------------------------------------------------------ host: graph structure

def spanning_forest(pairs, weights, num_images):
    """Max-weight spanning forest of the pair graph, as BFS edge sequences.

    Returns (child, parent, edge, flip) arrays ordered so that every parent
    appears (as a child or a root) before its children; ``flip`` marks edges
    stored as (child, parent), whose relative measurement is inverted.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import breadth_first_order, minimum_spanning_tree

    pairs = np.asarray(pairs)
    w = np.asarray(weights, np.float64)
    N = num_images
    i_idx, j_idx = pairs[:, 0], pairs[:, 1]
    # Dedup parallel edges keeping the best weight (coo->csr would SUM them).
    key = np.minimum(i_idx, j_idx).astype(np.int64) * N + np.maximum(i_idx, j_idx)
    order = np.lexsort((w, key))
    last = np.r_[key[order][1:] != key[order][:-1], True]
    keep = order[last]
    eid = sp.csr_matrix((keep + 1, (i_idx[keep], j_idx[keep])), shape=(N, N))  # 1-based ids
    # Max-weight forest == min spanning tree on negated weights, shifted below 0.
    g = sp.csr_matrix((-(w[keep] + 1.0), (i_idx[keep], j_idx[keep])), shape=(N, N))
    T = minimum_spanning_tree(g + g.T)
    T = (T + T.T).tocsr()

    child, parent = [], []
    seen = np.zeros(N, bool)
    deg = np.diff(T.indptr)
    for root in np.nonzero(deg > 0)[0]:
        if seen[root]:
            continue
        nodes, preds = breadth_first_order(T, int(root), directed=False,
                                           return_predecessors=True)
        seen[nodes] = True
        child.append(nodes[1:])
        parent.append(preds[nodes[1:]])
    if not child:
        z = np.zeros(0, np.int32)
        return z, z, z, np.zeros(0, bool)
    child = np.concatenate(child).astype(np.int32)
    parent = np.concatenate(parent).astype(np.int32)
    e_fwd = np.asarray(eid[parent, child]).ravel()
    e_rev = np.asarray(eid[child, parent]).ravel()
    flip = e_fwd == 0
    edge = np.where(flip, e_rev, e_fwd).astype(np.int64) - 1
    return child, parent, edge, flip


def tree_init_rotations(forest, R_rel, num_images):
    """Compose absolute rotations along a spanning forest (R_j = R_ij R_i)."""
    child, parent, edge, flip = forest
    R_rel = np.asarray(R_rel, np.float64)
    R0 = np.tile(np.eye(3), (num_images, 1, 1))
    for c, p, e, f in zip(child, parent, edge, flip):
        Rij = R_rel[e]
        R0[c] = (Rij.T if f else Rij) @ R0[p]
    return R0.astype(np.float32)


def tree_init_centers(forest, R_abs, pairs, t_rel, num_images):
    """Compose camera centers along the forest with unit per-edge baselines
    in the measured directions d = unit(-R_j^T t_ij)."""
    child, parent, edge, flip = forest
    pairs = np.asarray(pairs)
    R_abs = np.asarray(R_abs, np.float64)
    t_rel = np.asarray(t_rel, np.float64)
    j = pairs[:, 1]
    d_all = -np.einsum("pba,pb->pa", R_abs[j], t_rel)
    d_all /= np.maximum(np.linalg.norm(d_all, axis=-1, keepdims=True), 1e-12)
    C0 = np.zeros((num_images, 3))
    for c, p, e, f in zip(child, parent, edge, flip):
        C0[c] = C0[p] - d_all[e] if f else C0[p] + d_all[e]
    return C0.astype(np.float32)


def cycle_consistency_weights(pairs, R_rel, sigma_deg: float = 15.0, max_triangles: int = 8,
                              floor: float = 1e-3):
    """Per-edge soft weight exp(-(median cycle angle / sigma)^2), floored,
    from up to ``max_triangles`` sampled triangles through each edge."""
    import scipy.sparse as sp

    pairs = np.asarray(pairs)
    R_rel = np.asarray(R_rel)
    P = len(pairs)
    N = int(pairs.max()) + 1
    i_idx, j_idx = pairs[:, 0], pairs[:, 1]
    A = sp.csr_matrix(
        (np.ones(2 * P, np.int8),
         (np.concatenate([i_idx, j_idx]), np.concatenate([j_idx, i_idx]))),
        shape=(N, N)).tocsr()
    eid = np.full((N, N), -1, np.int32)
    eid[i_idx, j_idx] = np.arange(P)
    eid[j_idx, i_idx] = np.arange(P)

    C0 = 3 * max_triangles  # candidate neighbors of i to probe per edge
    deg = np.diff(A.indptr)
    starts = A.indptr[i_idx]
    offs = np.arange(C0)
    cand = A.indices[np.minimum(starts[:, None] + offs[None, :], A.nnz - 1)]
    cand_ok = (offs[None, :] < deg[i_idx][:, None]) & (eid[cand, j_idx[:, None]] >= 0)
    rank = np.cumsum(cand_ok, axis=1)
    cand_ok &= rank <= max_triangles
    tri_edge, col = np.nonzero(cand_ok)
    tri_k = cand[tri_edge, col]
    tri_i = i_idx[tri_edge]
    tri_j = j_idx[tri_edge]

    def rot(a, b):
        # Rotation of edge (a, b) in the a -> b orientation.
        p = eid[a, b]
        R = R_rel[p]
        flip = pairs[p, 0] != a
        return np.where(flip[:, None, None], np.swapaxes(R, -1, -2), R)

    # Cycle i -> j (measured R_ij) -> k -> i: identity if consistent.
    C = np.einsum("tab,tbc,tcd->tad", rot(tri_k, tri_i), rot(tri_j, tri_k), R_rel[tri_edge])
    tr = np.clip((np.trace(C, axis1=-2, axis2=-1) - 1.0) * 0.5, -1.0, 1.0)
    tri_ang = np.degrees(np.arccos(tr)).astype(np.float32)

    counts = np.bincount(tri_edge, minlength=P)
    ang_tab = np.full((P, max(max_triangles, 1)), np.inf, np.float32)
    slot = rank[tri_edge, col] - 1
    ang_tab[tri_edge, slot] = tri_ang
    ang_tab.sort(axis=1)
    c = np.maximum(counts, 1)
    lo = ang_tab[np.arange(P), (c - 1) // 2]
    hi = ang_tab[np.arange(P), c // 2]
    ang = np.where(counts > 0, 0.5 * (lo + hi), 90.0).astype(np.float32)
    return np.maximum(np.exp(-((ang / sigma_deg) ** 2)), floor).astype(np.float32)


def _averaging_weights(rel, cfg):
    """Per-edge averaging weights: inlier count x cheirality evidence x cycle
    consistency. Returns (weights, n_cycle_downweighted)."""
    w = rel["weight"]
    cheir = np.clip(rel["cheirality_good"] / np.maximum(rel["weight"], 1.0),
                    0.1, 1.0).astype(np.float32)
    w = w * cheir
    if cfg.cycle_sigma_deg > 0:
        cyc = cycle_consistency_weights(rel["pairs"], rel["R"], sigma_deg=cfg.cycle_sigma_deg)
        return w * cyc, int((cyc < 0.5).sum())
    return w, 0


# ------------------------------------------------------------ poses for the scene

def _rvec_tvec(R_abs, C):
    rvec = rotation_to_rvec(torch.as_tensor(np.asarray(R_abs, np.float32))).numpy()
    tvec = -np.einsum("nab,nb->na", R_abs, C).astype(np.float32)
    return rvec.astype(np.float32), tvec


def global_poses(table, K, num_images, config=None, return_rel=False, *, device):
    """Solve all camera poses from the verified-pair table on ``device``.

    Returns (rvec (N, 3), tvec (N, 3), placed (N,) bool) in the engine's
    x_cam = R x_world + t convention; ``placed`` marks cameras covered by at
    least one averaging pair (the rest keep the identity). With
    ``return_rel``, also the relative-pose dict (with ``weight_eff``).
    """
    cfg = config or GlobalInitConfig()
    t0 = time.time()
    rel = pairwise_relative_poses(table, K, min_inliers=cfg.min_pair_inliers,
                                  refine_gn_iters=cfg.gn_iters, max_matches=cfg.pair_matches,
                                  device=device)
    t1 = time.time()
    P = rel["pairs"].shape[0]
    w, n_down = _averaging_weights(rel, cfg)
    t2 = time.time()
    forest = spanning_forest(rel["pairs"], w, num_images) if cfg.tree_init else None
    R_init = tree_init_rotations(forest, rel["R"], num_images) if forest is not None else None
    R_abs = rotation_averaging(rel["pairs"], rel["R"], w, num_images,
                               power_iters=cfg.power_iters, refine_iters=cfg.refine_iters,
                               init=R_init, device=device)
    t3 = time.time()
    C_init = (tree_init_centers(forest, R_abs, rel["pairs"], rel["t"], num_images)
              if forest is not None else None)
    C = translation_averaging(rel["pairs"], R_abs, rel["t"], w, num_images,
                              als_rounds=cfg.als_rounds, cg_iters=cfg.cg_iters, init=C_init,
                              device=device)
    t4 = time.time()
    logger.info("global init: %d pairs (%d cycle-downweighted); rel %.1fs cycle %.1fs "
                "rot %.1fs trans %.1fs", P, n_down, t1 - t0, t2 - t1, t3 - t2, t4 - t3)
    placed = np.zeros(num_images, bool)
    placed[rel["pairs"].ravel()] = True
    rvec, tvec = _rvec_tvec(R_abs, C)
    if return_rel:
        rel["weight_eff"] = w
        return rvec, tvec, placed, rel
    return rvec, tvec, placed


def polish_poses(table, K, num_images, rvec, tvec, registered, config=None, *, device):
    """Pose-graph drift correction for an incrementally built model.

    Relative poses over the registered-registered subgraph of the table,
    then two averaging solves -- seeded from the current poses and from the
    spanning tree -- of which the one that disagrees with fewer of its own
    pair rotations wins (an exact tie keeps the incremental seed); the
    output scale is re-aligned to the input model's.

    Returns ``(rvec', tvec', placed, rel)``; ``placed`` marks registered
    cameras covered by the averaging subgraph, and ``rel["seed_choice"]``
    names the seed that won.
    """
    cfg = config or GlobalInitConfig()
    registered = np.asarray(registered, bool)
    pairs_all = np.asarray(table.pairs)
    both = registered[pairs_all[:, 0]] & registered[pairs_all[:, 1]]
    sub = dataclasses.replace(table, accept=np.asarray(table.accept) & both)
    rel = pairwise_relative_poses(sub, K, min_inliers=cfg.min_pair_inliers,
                                  refine_gn_iters=cfg.gn_iters, max_matches=cfg.pair_matches,
                                  device=device)
    w, n_down = _averaging_weights(rel, cfg)
    R_cur = rodrigues(torch.as_tensor(np.asarray(rvec, np.float32))).numpy()
    C_cur = -np.einsum("nba,nb->na", R_cur, np.asarray(tvec, np.float32))
    # The reference builds the forest after the first solve, which may read it
    # (ROADMAP: its polish ordering); here it exists before either solve.
    forest = spanning_forest(rel["pairs"], w, num_images)

    def _solve(R_init, C_init):
        R_abs = rotation_averaging(rel["pairs"], rel["R"], w, num_images,
                                   power_iters=cfg.power_iters, refine_iters=cfg.refine_iters,
                                   init=R_init, device=device)
        if C_init is None:
            C_init = tree_init_centers(forest, R_abs, rel["pairs"], rel["t"], num_images)
        C = translation_averaging(rel["pairs"], R_abs, rel["t"], w, num_images,
                                  als_rounds=cfg.als_rounds, cg_iters=cfg.cg_iters,
                                  init=C_init, device=device)
        return R_abs, C

    def _score(R_abs):
        rv = rotation_to_rvec(torch.as_tensor(R_abs)).numpy()
        res = pair_rotation_residuals(rv, rel["pairs"], rel["R"])
        return float(np.mean(res > cfg.consistency_warn_deg)), float(np.median(res))

    R_inc, C_inc = _solve(R_cur, C_cur)
    R_tree, C_tree = _solve(tree_init_rotations(forest, rel["R"], num_images), None)
    s_inc, s_tree = _score(R_inc), _score(R_tree)
    if s_tree < s_inc:
        R_abs, C, seed_choice = R_tree, C_tree, "tree"
    else:
        R_abs, C, seed_choice = R_inc, C_inc, "incremental"
    rel["seed_choice"] = seed_choice
    rel["seed_scores"] = {"incremental": s_inc, "tree": s_tree}
    logger.info("polish seed selection: incremental (outliers %.1f%%, med %.2f deg) vs tree "
                "(%.1f%%, %.2f deg) -> %s", 100 * s_inc[0], s_inc[1], 100 * s_tree[0],
                s_tree[1], seed_choice)
    i_idx, j_idx = rel["pairs"][:, 0], rel["pairs"][:, 1]
    base_in = np.linalg.norm(C_cur[j_idx] - C_cur[i_idx], axis=-1)
    base_out = np.linalg.norm(C[j_idx] - C[i_idx], axis=-1)
    if len(base_out):
        C = C * (float(np.median(base_in)) / max(float(np.median(base_out)), 1e-12))
    placed = np.zeros(num_images, bool)
    placed[rel["pairs"].ravel()] = True
    placed &= registered
    logger.info("polish: %d pairs (%d cycle-downweighted) cover %d/%d registered cameras",
                rel["pairs"].shape[0], n_down, int(placed.sum()), int(registered.sum()))
    rvec_out, tvec_out = _rvec_tvec(R_abs, C)
    return rvec_out, tvec_out, placed, rel


def pair_rotation_residuals(rvec, pairs, R_rel):
    """Angular residual (deg) of the model's rotations against the measured
    pair rotations: the global path's self-diagnostic."""
    R_abs = rodrigues(torch.as_tensor(np.asarray(rvec, np.float32))).numpy()
    pairs = np.asarray(pairs)
    E = np.einsum("pba,pbc,pcd->pad", R_abs[pairs[:, 1]], np.asarray(R_rel), R_abs[pairs[:, 0]])
    tr = np.clip((np.trace(E, axis1=1, axis2=2) - 1.0) * 0.5, -1.0, 1.0)
    return np.degrees(np.arccos(tr))
