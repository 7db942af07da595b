"""Perspective-n-Point: RANSAC over minimal or DLT samples + Gauss-Newton
polish, batched over candidates.

Counterpart of ``sfm_tpu/estimators/pnp.py``, both of its hypothesis
branches. ``PnPConfig.sample_size = 3`` (the default) is minimal P3P: kernel
K6 (``csrc/pnp_ransac.cu``) entry ``p3p_ransac`` runs the round from the drawn
sample indices on in one launch -- each sample's Grunert quartic by
Durand-Kerner (up to 4 poses a sample), the reprojection error + cheirality
of every hypothesis over every correspondence and ``ransac_select``'s
winner. Any other sample size (>= 6) is the linear DLT branch (6 or more
rows to determine P; fewer give junk that scores no consensus, as in the
reference): ``csrc/pnp_dlt.cu`` entry ``pnp_dlt_solve`` solves each
sample's 12 x 12 DLT normal matrix, projects P onto SO(3) x R^3 and polishes
the pose by two Gauss-Newton steps on its own sample, one thread a
hypothesis; then ``pnp_score_select`` (``pnp_ransac.cu``'s scoring and winner
for hypotheses given). Both branches end in ``csrc/pnp_refine.cu`` (entry
``pnp_refine``): everything from the winner on in one launch, the two
10-step Gauss-Newton refits on the consensus set, the re-derived weights,
the final inliers and gates. ``p3p_solve`` is the round's solve alone, on
samples gathered by the caller. Their plain twins are
:func:`p3p_ransac_plain` (:func:`p3p_candidates` and
:func:`pnp_score_select_plain`), :func:`pnp_dlt_solve_plain`
(:func:`pnp_dlt` and :func:`_gn_sample_step`) and :func:`pnp_refine_plain`
(which, like the DLT polish, keeps ``torch.func.jacfwd``, the reference's
Jacobian).
Samples come from a ``torch.Generator`` or are injected (``indices``), so a
test can hand both packages the same draws.
"""
from __future__ import annotations

import numpy as np
import torch

from sfm_tpu_torch import _kernels
from sfm_tpu_torch.estimators.ransac import ransac_sample_indices
from sfm_tpu_torch.geometry.projection import intrinsics_vector, project
from sfm_tpu_torch.geometry.rotations import rodrigues, rotation_to_rvec
from sfm_tpu_torch.utils.linalg import smallest_eigvec

_EPS = 1e-12
# A block holds a candidate's correspondences in shared memory (the P3P
# round's and the scoring's 5 floats a row, pnp_refine's cluster).
_K6_MAX_POINTS = 8192
# Hypotheses a block of the round's and the scoring's kernel (pnp_ransac.cu's HT).
_K6_TILE = 256
# The scoring's pre-test margin (see pretest_margin): 2^-20 = 16 float32 units
# of roundoff.
_K6_KAPPA = 2.0 ** -20
_K6_TICKETS: dict = {}
# Hypotheses scored at once by the plain twin: bounds its (B, chunk, N) errors.
_SCORE_CHUNK = 1024


def _quartic_roots_dk(c4, c3, c2, c1, c0, iters: int = 30):
    """All four roots of c4 z^4 + ... + c0 (complex64, (..., 4)) by
    Durand-Kerner: a fixed-point iteration, no eigensolver."""
    scale = torch.where(c4.abs() > 1e-12, c4,
                        torch.where(c4 >= 0, torch.full_like(c4, 1e-12),
                                    torch.full_like(c4, -1e-12)))
    a3, a2, a1, a0 = c3 / scale, c2 / scale, c1 / scale, c0 / scale
    base = complex(0.4, 0.9)
    seed = torch.tensor([base**k for k in range(4)], dtype=torch.complex64, device=c4.device)
    z = seed * ((1.0 + a0.abs()) ** 0.25)[..., None].to(torch.complex64)
    a3, a2, a1, a0 = (a[..., None].to(torch.complex64) for a in (a3, a2, a1, a0))
    eye = torch.eye(4, dtype=torch.complex64, device=c4.device)
    for _ in range(iters):
        denom = torch.prod(z[..., :, None] - z[..., None, :] + eye, dim=-1)
        p = (((z + a3) * z + a2) * z + a1) * z + a0
        denom = torch.where(denom.abs() > 1e-20, denom, torch.full_like(denom, 1e-20))
        z = z - p / denom
    return z


def _triad(Q):
    """Orthonormal frame of 3 points (..., 3, 3): columns e1, e2, e3."""
    e1 = Q[..., 1, :] - Q[..., 0, :]
    e1 = e1 / torch.clamp(torch.linalg.vector_norm(e1, dim=-1, keepdim=True), min=_EPS)
    e2 = Q[..., 2, :] - Q[..., 0, :]
    e2 = e2 - (e2 * e1).sum(-1, keepdim=True) * e1
    n2 = torch.linalg.vector_norm(e2, dim=-1, keepdim=True)
    e2 = e2 / torch.clamp(n2, min=_EPS)
    e3 = torch.linalg.cross(e1, e2)
    return torch.stack([e1, e2, e3], dim=-1), n2[..., 0] > 1e-9


def p3p_candidates(s3, s2n):
    """Grunert's P3P (plain twin of K6's ``p3p_solve``).

    s3: (..., 3, 3) world points; s2n: (..., 3, 2) normalized image coords.
    Returns (Rs (..., 4, 3, 3), ts (..., 4, 3), ok (..., 4)); a masked
    candidate is (I, 0).
    """
    f = torch.cat([s2n, torch.ones_like(s2n[..., :1])], dim=-1)
    f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True), min=_EPS)
    P1, P2, P3 = s3[..., 0, :], s3[..., 1, :], s3[..., 2, :]
    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    a2 = ((P2 - P3) ** 2).sum(-1)
    b2 = torch.clamp(((P1 - P3) ** 2).sum(-1), min=_EPS)
    c2 = ((P1 - P2) ** 2).sum(-1)
    cos_a, cos_b, cos_c = (f2 * f3).sum(-1), (f1 * f3).sum(-1), (f1 * f2).sum(-1)
    q = (a2 - c2) / b2
    A4 = (q - 1.0) ** 2 - 4.0 * c2 / b2 * cos_a**2
    A3 = 4.0 * (q * (1.0 - q) * cos_b
                - (1.0 - (a2 + c2) / b2) * cos_a * cos_c
                + 2.0 * c2 / b2 * cos_a**2 * cos_b)
    A2 = 2.0 * (q**2 - 1.0 + 2.0 * q**2 * cos_b**2
                + 2.0 * (b2 - c2) / b2 * cos_a**2
                - 4.0 * (a2 + c2) / b2 * cos_a * cos_b * cos_c
                + 2.0 * (b2 - a2) / b2 * cos_c**2)
    A1 = 4.0 * (-q * (1.0 + q) * cos_b
                + 2.0 * a2 / b2 * cos_c**2 * cos_b
                - (1.0 - (a2 + c2) / b2) * cos_a * cos_c)
    A0 = (1.0 + q) ** 2 - 4.0 * a2 / b2 * cos_c**2

    roots = _quartic_roots_dk(A4, A3, A2, A1, A0)            # (..., 4)
    v = roots.real
    root_ok = (roots.imag.abs() < 1e-4 * (1.0 + v.abs())) & (v > _EPS)
    q_, cb, cc, ca = q[..., None], cos_b[..., None], cos_c[..., None], cos_a[..., None]
    num = (-1.0 + q_) * v * v - 2.0 * q_ * cb * v + 1.0 + q_
    den = 2.0 * (cc - v * ca)
    u = num / torch.where(den.abs() > 1e-9, den, torch.full_like(den, 1e-9))
    s = 1.0 + v * v - 2.0 * v * cb
    ok = root_ok & (u > _EPS) & (s > _EPS) & (den.abs() > 1e-9)
    d1 = torch.sqrt(b2[..., None] / torch.clamp(s, min=_EPS))     # (..., 4)
    Pc = torch.stack([d1[..., None] * f1[..., None, :],
                      (u * d1)[..., None] * f2[..., None, :],
                      (v * d1)[..., None] * f3[..., None, :]], dim=-2)  # (..., 4, 3, 3)
    Tw, w_ok = _triad(s3)
    Tc, c_ok = _triad(Pc)
    Rs = Tc @ Tw[..., None, :, :].mT
    ts = Pc[..., 0, :] - (Rs @ P1[..., None, :, None])[..., 0]
    ok = (ok & c_ok & w_ok[..., None] & torch.isfinite(Rs).all(-1).all(-1)
          & torch.isfinite(ts).all(-1))
    eye = torch.eye(3, dtype=Rs.dtype, device=Rs.device)
    Rs = torch.where(ok[..., None, None], Rs, eye)
    ts = torch.where(ok[..., None], ts, 0.0)
    return Rs, ts, ok


def p3p_solve_cuda(s3, s2n):
    B, H = s3.shape[:2]
    dev = s3.device
    _kernels.check_tensor(s3, "s3", torch.float32, (B, H, 3, 3), dev)
    _kernels.check_tensor(s2n, "s2n", torch.float32, (B, H, 3, 2), dev)
    Rs = torch.empty((B, H, 4, 3, 3), dtype=torch.float32, device=dev)
    ts = torch.empty((B, H, 4, 3), dtype=torch.float32, device=dev)
    ok = torch.empty((B, H, 4), dtype=torch.bool, device=dev)
    _kernels.launch("p3p_solve", dev, s3, s2n, B * H, Rs, ts, ok)
    return Rs, ts, ok


def p3p_solve(s3, s2n):
    """Kernel K6 ``p3p_solve`` on CUDA tensors, :func:`p3p_candidates` on CPU."""
    if s3.is_cuda:
        return p3p_solve_cuda(s3, s2n)
    if s3.device.type == "cpu":
        return p3p_candidates(s3, s2n)
    raise ValueError(f"p3p_solve: unsupported device {s3.device}")


def pnp_dlt(pts3d, pts2d_norm, weights=None, null_fallback: bool = True):
    """Linear PnP from >= 6 correspondences in normalized camera coordinates
    (the reference's ``pnp_dlt``), batched over leading dimensions.

    pts3d (..., N, 3); pts2d_norm (..., N, 2), pixels premultiplied by
    K^-1; weights (..., N) a soft row selector. The 2N x 12 DLT system
    (weighted, each row normalized) gives P = [M | p4] up to scale as the
    null vector of its normal matrix; P and -P are projected onto SO(3) x R^3
    (12 Newton-Schulz steps for the polar factor, the det < 0 flip
    X (I - 2 v v^T) with v the smallest right singular vector of M, the
    scale 3 / trace(X^T M)), and the sign whose weighted mean depth is the
    larger wins. Returns (R (..., 3, 3), t (..., 3)).
    """
    x, y = pts2d_norm[..., 0:1], pts2d_norm[..., 1:2]
    X1 = torch.cat([pts3d, torch.ones_like(pts3d[..., :1])], dim=-1)      # (..., N, 4)
    zeros = torch.zeros_like(X1)
    A = torch.cat([torch.cat([X1, zeros, -x * X1], dim=-1),
                   torch.cat([zeros, X1, -y * X1], dim=-1)], dim=-2)      # (..., 2N, 12)
    if weights is not None:
        A = A * torch.cat([weights, weights], dim=-1)[..., None]
    A = A / torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True), min=_EPS)
    p = smallest_eigvec(A.mT @ A, fallback=null_fallback)
    P = p.reshape(p.shape[:-1] + (3, 4))
    if weights is None:
        weights = torch.ones(pts3d.shape[:-1], dtype=pts3d.dtype, device=pts3d.device)

    def decompose(Pm):
        M = Pm[..., :3]
        nrm = torch.sqrt((M * M).sum((-2, -1), keepdim=True))
        X = M / torch.clamp(nrm, min=_EPS)          # sigma_max <= 1: Newton-Schulz converges
        for _ in range(12):
            X = 1.5 * X - 0.5 * (X @ X.mT @ X)
        nuclear = (X * M).sum((-2, -1))              # trace(X^T M)
        v = smallest_eigvec(M.mT @ M)                # (..., 3)
        R_flip = X - 2.0 * (X @ v[..., None]) * v[..., None, :]
        R = torch.where((torch.linalg.det(X) < 0)[..., None, None], R_flip, X)
        t = Pm[..., 3] * (3.0 / torch.clamp(nuclear, min=_EPS))[..., None]
        z = (pts3d @ R.mT)[..., 2] + t[..., 2:3]
        mean_z = (z * weights).sum(-1) / torch.clamp(weights.sum(-1), min=_EPS)
        return R, t, mean_z

    R_p, t_p, z_p = decompose(P)
    R_n, t_n, z_n = decompose(-P)
    front = z_p >= z_n
    return (torch.where(front[..., None, None], R_p, R_n),
            torch.where(front[..., None], t_p, t_n))


def _gn_sample_step(rvec, t, s3, s2, K):
    """One Gauss-Newton step on a fixed sample, batched over leading
    dimensions (the reference's per-hypothesis polish): the 6-column
    Jacobian of the sample's reprojection residual by ``torch.func.jacfwd``,
    (J^T J + 1e-4 I) delta = J^T r. Returns params - delta (..., 6)."""
    def residual(params, p3, p2):
        proj, _ = project(p3, rodrigues(params[:3]), params[3:], K)
        return (proj - p2).reshape(-1)

    lead = rvec.shape[:-1]
    params = torch.cat([rvec, t], dim=-1).reshape(-1, 6)
    p3, p2 = s3.reshape((-1,) + s3.shape[-2:]), s2.reshape((-1,) + s2.shape[-2:])
    J = torch.func.vmap(torch.func.jacfwd(residual))(params, p3, p2)     # (n, 2S, 6)
    r = torch.func.vmap(residual)(params, p3, p2)
    JtJ = J.mT @ J + 1e-4 * torch.eye(6, dtype=J.dtype, device=J.device)
    delta = torch.linalg.solve(JtJ, J.mT @ r[..., None])[..., 0]
    return (params - delta).reshape(lead + (6,))


def pnp_dlt_solve_plain(pts3d, pn, pts2d, idx, K):
    """Plain twin of ``pnp_dlt_solve``: each (candidate, hypothesis)'s sample
    (idx (B, H, S) rows of pts3d (B, N, 3), pn (B, N, 2) normalized and pts2d
    (B, N, 2) pixels) through :func:`pnp_dlt` without its fallback, then two
    :func:`_gn_sample_step` s from ``rotation_to_rvec(R0)``. Returns
    (Rs (B, H, 3, 3), ts (B, H, 3))."""
    B, H, S = idx.shape
    flat = idx.reshape(B, -1).long()
    take = lambda p: torch.gather(p, 1, flat[..., None].expand(-1, -1, p.shape[-1])).reshape(
        B, H, S, p.shape[-1])
    s3, s2n, s2 = take(pts3d), take(pn), take(pts2d)
    R0, t0 = pnp_dlt(s3, s2n, null_fallback=False)
    params = _gn_sample_step(rotation_to_rvec(R0), t0, s3, s2, K)
    params = _gn_sample_step(params[..., :3], params[..., 3:], s3, s2, K)
    return rodrigues(params[..., :3]), params[..., 3:]


def pnp_dlt_solve_cuda(pts3d, pn, pts2d, idx, K):
    B, H, S = idx.shape
    N = pts3d.shape[1]
    dev = pts3d.device
    _kernels.check_tensor(pts3d, "pts3d", torch.float32, (B, N, 3), dev)
    _kernels.check_tensor(pn, "pn", torch.float32, (B, N, 2), dev)
    _kernels.check_tensor(pts2d, "pts2d", torch.float32, (B, N, 2), dev)
    _kernels.check_tensor(idx, "idx", torch.int32, (B, H, S), dev)
    Rs = torch.empty((B, H, 3, 3), dtype=torch.float32, device=dev)
    ts = torch.empty((B, H, 3), dtype=torch.float32, device=dev)
    _kernels.launch("pnp_dlt_solve", dev, pts3d, pn, pts2d, idx, intrinsics_vector(K), B, H, S,
                    N, Rs, ts)
    return Rs, ts


def pnp_dlt_solve(pts3d, pn, pts2d, idx, K):
    """Kernel ``pnp_dlt_solve`` on CUDA tensors, :func:`pnp_dlt_solve_plain` on CPU."""
    if pts3d.is_cuda:
        return pnp_dlt_solve_cuda(pts3d, pn, pts2d, idx.to(torch.int32).contiguous(), K)
    if pts3d.device.type == "cpu":
        return pnp_dlt_solve_plain(pts3d, pn, pts2d, idx, K)
    raise ValueError(f"pnp_dlt_solve: unsupported device {pts3d.device}")


def pnp_score_select_plain(Rs, ts, cand_ok, pts3d, pts2d, valid, K, threshold: float):
    """Reprojection errors of (B, H) hypotheses over (B, N) correspondences
    (behind the camera or a masked candidate = inf), then ``ransac_select``'s
    winner. Returns (best (B,), count (B,))."""
    scores, counts = [], []
    for h0 in range(0, Rs.shape[1], _SCORE_CHUNK):
        sl = slice(h0, h0 + _SCORE_CHUNK)
        R, t, ok = Rs[:, sl], ts[:, sl], cand_ok[:, sl]
        proj, depth = project(pts3d[:, None], R[:, :, None], t[:, :, None], K)
        errors = torch.linalg.vector_norm(proj - pts2d[:, None], dim=-1)
        errors = torch.where((depth > 0) & ok[..., None], errors, torch.inf)
        inl = (errors < threshold) & valid[:, None]
        count = inl.sum(-1)
        mean_err = torch.where(inl, errors, 0.0).sum(-1) / torch.clamp(count, min=1)
        scores.append(count.to(torch.float32) - mean_err / max(threshold, 1e-6))
        counts.append(count)
    score, count = torch.cat(scores, dim=1), torch.cat(counts, dim=1)
    best = torch.argmax(score, dim=-1)
    return best, torch.gather(count, 1, best[:, None])[:, 0]


def pretest_margin(threshold: float):
    """(thr_pre, kap) of the scoring's exact pre-test for ``threshold``.

    The kernel skips a row's two divisions and square root when
    |fx x + (cx - u) z| > thr_pre z + kap |fx x| (or the same for v), where
    x, z are the row's camera coordinates and fx x, cx - u and the sums are
    float32 (thr_pre z + kap |fx x| as fma(kap, |fx x|, (thr_pre + kap (|cx|
    + |u|)) z)). With kap = 2^-20 (16 units of roundoff) and thr_pre the
    float32 at or above thr (1 + 2^-20), a rejected row has |du| >= thr under
    every rounding of the exact path, fused or not (its relative errors total
    < 8 units), so its error sqrt(du^2 + dv^2) >= thr: it does not count.
    ``tests/test_torch_pnp_layout.py`` holds this in emulation. Outside
    1e-6 <= thr <= 1e30 (where a subnormal or an overflow could beat the
    margin) thr_pre is inf, which rejects nothing."""
    thr = np.float32(threshold)
    if not 1e-6 <= float(thr) <= 1e30:
        return float("inf"), _K6_KAPPA
    want = float(thr) * (1.0 + _K6_KAPPA)
    pre = np.float32(want)
    if float(pre) < want:
        pre = np.nextafter(pre, np.float32(np.inf))
    return float(pre), _K6_KAPPA


def _k6_tickets(dev, B: int):
    """The per-candidate tickets of the round's and the scoring's kernel: int32
    zeros, one buffer a device, which each launch leaves at zero."""
    t = _K6_TICKETS.get(dev)
    if t is None or t.numel() < B:
        t = _K6_TICKETS[dev] = torch.zeros(max(B, 64), dtype=torch.int32, device=dev)
    return t


def pnp_score_select_cuda(Rs, ts, cand_ok, pts3d, pts2d, valid, K, threshold: float):
    B, H = Rs.shape[:2]
    N = pts3d.shape[1]
    dev = Rs.device
    if N > _K6_MAX_POINTS:
        raise ValueError(f"pnp_score_select: N={N} exceeds {_K6_MAX_POINTS}")
    _kernels.check_tensor(Rs, "Rs", torch.float32, (B, H, 3, 3), dev)
    _kernels.check_tensor(ts, "ts", torch.float32, (B, H, 3), dev)
    _kernels.check_tensor(cand_ok, "cand_ok", torch.bool, (B, H), dev)
    _kernels.check_tensor(pts3d, "pts3d", torch.float32, (B, N, 3), dev)
    _kernels.check_tensor(pts2d, "pts2d", torch.float32, (B, N, 2), dev)
    _kernels.check_tensor(valid, "valid", torch.bool, (B, N), dev)
    tiles = (H + _K6_TILE - 1) // _K6_TILE
    part = torch.empty((B, tiles, 3), dtype=torch.int32, device=dev)
    best = torch.empty((B,), dtype=torch.int32, device=dev)
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    _kernels.launch("pnp_score_select", dev, Rs, ts, cand_ok, pts3d, pts2d, valid,
                    intrinsics_vector(K), B, H, N, float(threshold), *pretest_margin(threshold),
                    part, _k6_tickets(dev, B), best, count)
    return best.long(), count.long()


def pnp_score_select(Rs, ts, cand_ok, pts3d, pts2d, valid, K, threshold: float):
    """Kernel K6 ``pnp_score_select`` on CUDA tensors, its twin on CPU."""
    args = (Rs, ts, cand_ok, pts3d, pts2d, valid, K, threshold)
    if Rs.is_cuda:
        return pnp_score_select_cuda(*args)
    if Rs.device.type == "cpu":
        return pnp_score_select_plain(*args)
    raise ValueError(f"pnp_score_select: unsupported device {Rs.device}")


def p3p_ransac_plain(pts3d, pn, pts2d, valid, idx, K, threshold: float):
    """Plain twin of K6's ``p3p_ransac``: the P3P round from the drawn samples
    idx (B, S, 3) on. The samples' rows of pts3d (B, N, 3) and pn (B, N, 2)
    through :func:`p3p_candidates`, then :func:`pnp_score_select_plain` over
    pts3d, pts2d (B, N, 2) pixels and valid (B, N). Returns a dict of Rs
    (B, 4S, 3, 3), ts (B, 4S, 3), ok (B, 4S) -- hypothesis 4s + k is root k
    of sample s -- best (B,) and count (B,)."""
    B = idx.shape[0]
    flat = idx.reshape(B, -1).long()
    take = lambda p: torch.gather(p, 1, flat[..., None].expand(-1, -1, p.shape[-1])).reshape(
        idx.shape + p.shape[-1:])
    Rs, ts, ok = p3p_candidates(take(pts3d), take(pn))
    H = Rs.shape[1] * 4
    Rs, ts, ok = Rs.reshape(B, H, 3, 3), ts.reshape(B, H, 3), ok.reshape(B, H)
    best, count = pnp_score_select_plain(Rs, ts, ok, pts3d, pts2d, valid, K, threshold)
    return {"Rs": Rs, "ts": ts, "ok": ok, "best": best, "count": count}


def p3p_ransac_cuda(pts3d, pn, pts2d, valid, idx, K, threshold: float):
    B, N = valid.shape
    S = idx.shape[1]
    dev = pts3d.device
    if N > _K6_MAX_POINTS:
        raise ValueError(f"p3p_ransac: N={N} exceeds {_K6_MAX_POINTS}")
    _kernels.check_tensor(idx, "indices", torch.int64, (B, S, 3), dev)
    _kernels.check_tensor(pts3d, "pts3d", torch.float32, (B, N, 3), dev)
    _kernels.check_tensor(pn, "pn", torch.float32, (B, N, 2), dev)
    _kernels.check_tensor(pts2d, "pts2d", torch.float32, (B, N, 2), dev)
    _kernels.check_tensor(valid, "valid", torch.bool, (B, N), dev)
    H = 4 * S
    tiles = (H + _K6_TILE - 1) // _K6_TILE
    Rs = torch.empty((B, H, 3, 3), dtype=torch.float32, device=dev)
    ts = torch.empty((B, H, 3), dtype=torch.float32, device=dev)
    ok = torch.empty((B, H), dtype=torch.bool, device=dev)
    part = torch.empty((B, tiles, 3), dtype=torch.int32, device=dev)
    best = torch.empty((B,), dtype=torch.int32, device=dev)
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    _kernels.launch("p3p_ransac", dev, idx, pts3d, pn, pts2d, valid, intrinsics_vector(K), B, S,
                    N, float(threshold), *pretest_margin(threshold), Rs, ts, ok, part,
                    _k6_tickets(dev, B), best, count)
    return {"Rs": Rs, "ts": ts, "ok": ok, "best": best.long(), "count": count.long()}


def p3p_ransac(pts3d, pn, pts2d, valid, idx, K, threshold: float):
    """Kernel K6 ``p3p_ransac`` on CUDA tensors, :func:`p3p_ransac_plain` on CPU."""
    args = (pts3d, pn, pts2d, valid, idx, K, threshold)
    if pts3d.is_cuda:
        return p3p_ransac_cuda(*args)
    if pts3d.device.type == "cpu":
        return p3p_ransac_plain(*args)
    raise ValueError(f"p3p_ransac: unsupported device {pts3d.device}")


def refine_pose_gn(R, t, pts3d, pts2d, K, weights, iters: int = 10):
    """Gauss-Newton refinement of (B) poses on weighted reprojection error.

    R (B, 3, 3), t (B, 3), pts3d (B, N, 3), pts2d (B, N, 2), weights (B, N).
    Each step: J from ``torch.func.jacfwd`` (as the reference's jacfwd),
    (J^T J + 1e-6 I) delta = J^T r.
    """
    def residual(params, p3, p2, w):
        proj, _ = project(p3, rodrigues(params[:3]), params[3:], K)
        return ((proj - p2) * w[:, None]).reshape(-1)

    jac = torch.func.vmap(torch.func.jacfwd(residual))
    res = torch.func.vmap(residual)
    params = torch.cat([rotation_to_rvec(R), t], dim=-1)
    eye = 1e-6 * torch.eye(6, dtype=params.dtype, device=params.device)
    for _ in range(iters):
        J = jac(params, pts3d, pts2d, weights)                   # (B, 2N, 6)
        r = res(params, pts3d, pts2d, weights)
        delta = torch.linalg.solve(J.mT @ J + eye, (J.mT @ r[..., None]))[..., 0]
        params = params - delta
    return rodrigues(params[:, :3]), params[:, 3:]


def pnp_ransac_batch(pts3d, pts2d, valid, K, min_inliers, iters: int = 1024,
                     threshold: float = 8.0, refine_iters: int = 10, sample_size: int = 3,
                     generator: torch.Generator | None = None, indices=None):
    """Robust registration of B candidates from padded 2D-3D correspondences.

    pts3d: (B, N, 3); pts2d: (B, N, 2) pixels; valid: (B, N) bool, a leading
    prefix; K: (3, 3); min_inliers: (B,) consensus gates. ``indices``
    (B, iters, sample_size) replaces the draw from ``generator``. Sample size
    3 takes P3P (up to 4 hypotheses a sample), any other (>= 6) the DLT with
    its per-hypothesis polish (one a sample). Returns a dict of R (B,3,3),
    rvec, t, inliers (B,N), num_inliers, errors, ok.
    """
    pts3d = pts3d.to(torch.float32)
    pts2d = pts2d.to(torch.float32)
    valid = valid.to(torch.bool)
    K = K.to(torch.float32)
    B, N = valid.shape
    dev = pts3d.device
    pn = (torch.cat([pts2d, torch.ones_like(pts2d[..., :1])], dim=-1)
          @ torch.linalg.inv(K).mT)[..., :2]
    if indices is None:
        if generator is None:
            raise ValueError("pnp_ransac_batch needs a generator or indices")
        indices = ransac_sample_indices(valid, iters, sample_size, generator, prefix=True)
    if sample_size == 3:
        rnd = p3p_ransac(pts3d.contiguous(), pn.contiguous(), pts2d.contiguous(),
                         valid.contiguous(), indices.long().contiguous(), K, threshold)
        Rs, ts, cand_ok, best = rnd["Rs"], rnd["ts"], rnd["ok"], rnd["best"]
    else:
        # The reference masks no DLT hypothesis: a degenerate sample's junk
        # pose simply scores no consensus.
        Rs, ts = pnp_dlt_solve(pts3d.contiguous(), pn.contiguous(), pts2d.contiguous(),
                               indices, K)
        cand_ok = torch.ones(Rs.shape[:2], dtype=torch.bool, device=dev)
        best, _ = pnp_score_select(Rs, ts, cand_ok, pts3d.contiguous(), pts2d.contiguous(),
                                   valid.contiguous(), K, threshold)

    ar = torch.arange(B, device=dev)
    min_inliers = torch.as_tensor(min_inliers, device=dev).expand(B)
    return pnp_refine(Rs[ar, best].contiguous(), ts[ar, best].contiguous(),
                      cand_ok[ar, best].contiguous(), pts3d.contiguous(), pts2d.contiguous(),
                      valid.contiguous(), K, threshold, min_inliers, refine_iters)


def pnp_refine_plain(R0, t0, ok0, pts3d, pts2d, valid, K, threshold: float, min_inliers,
                     iters: int = 10):
    """From the RANSAC winner (R0 (B,3,3), t0 (B,3), ok0 (B,)) on: GN refit on
    its consensus set, re-derived weights, a second refit, then the final
    inliers, the ``min_inliers`` (B,) gate and the finite guard. Plain twin
    of kernel K6's ``pnp_refine``; returns the :func:`pnp_ransac_batch` dict."""
    dev = pts3d.device
    proj0, depth0 = project(pts3d, R0[:, None], t0[:, None], K)
    err0 = torch.linalg.vector_norm(proj0 - pts2d, dim=-1)
    w = ((err0 < threshold) & (depth0 > 0) & valid & ok0[:, None]).to(torch.float32)
    R, t = refine_pose_gn(R0, t0, pts3d, pts2d, K, w, iters=iters)
    proj1, depth1 = project(pts3d, R[:, None], t[:, None], K)
    err1 = torch.linalg.vector_norm(proj1 - pts2d, dim=-1)
    w2 = ((err1 < threshold) & (depth1 > 0) & valid).to(torch.float32)
    R, t = refine_pose_gn(R, t, pts3d, pts2d, K, w2, iters=iters)

    projf, depthf = project(pts3d, R[:, None], t[:, None], K)
    err_f = torch.linalg.vector_norm(projf - pts2d, dim=-1)
    inliers = (err_f < threshold) & (depthf > 0) & valid
    num = inliers.sum(-1, dtype=torch.int32)
    ok = num >= torch.as_tensor(min_inliers, device=dev)
    # Outputs are finite even for degenerate input; callers gate on ``ok``.
    finite = torch.isfinite(R).all(-1).all(-1) & torch.isfinite(t).all(-1)
    R = torch.where(finite[:, None, None], R, torch.eye(3, dtype=R.dtype, device=dev))
    t = torch.where(finite[:, None], t, 0.0)
    return {
        "R": R,
        "rvec": rotation_to_rvec(R),
        "t": t,
        "inliers": inliers & finite[:, None],
        "num_inliers": torch.where(finite, num, 0),
        "errors": torch.where(torch.isfinite(err_f), err_f, torch.inf),
        "ok": ok & finite,
    }


def pnp_refine_cuda(R0, t0, ok0, pts3d, pts2d, valid, K, threshold: float, min_inliers,
                    iters: int = 10):
    B, N = valid.shape
    dev = pts3d.device
    if N > _K6_MAX_POINTS:
        raise ValueError(f"pnp_refine: N={N} exceeds {_K6_MAX_POINTS}")
    _kernels.check_tensor(R0, "R0", torch.float32, (B, 3, 3), dev)
    _kernels.check_tensor(t0, "t0", torch.float32, (B, 3), dev)
    _kernels.check_tensor(ok0, "ok0", torch.bool, (B,), dev)
    _kernels.check_tensor(pts3d, "pts3d", torch.float32, (B, N, 3), dev)
    _kernels.check_tensor(pts2d, "pts2d", torch.float32, (B, N, 2), dev)
    _kernels.check_tensor(valid, "valid", torch.bool, (B, N), dev)
    min_inl = torch.as_tensor(min_inliers, device=dev).to(torch.int32).expand(B).contiguous()
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    R, rvec, t, errors = f32(B, 3, 3), f32(B, 3), f32(B, 3), f32(B, N)
    inliers = torch.empty((B, N), dtype=torch.bool, device=dev)
    num = torch.empty((B,), dtype=torch.int32, device=dev)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    _kernels.launch("pnp_refine", dev, R0, t0, ok0, pts3d, pts2d, valid, intrinsics_vector(K),
                    B, N, float(threshold), min_inl, int(iters), R, rvec, t, inliers, num,
                    errors, ok)
    return {"R": R, "rvec": rvec, "t": t, "inliers": inliers, "num_inliers": num,
            "errors": errors, "ok": ok}


def pnp_refine(R0, t0, ok0, pts3d, pts2d, valid, K, threshold: float, min_inliers,
               iters: int = 10):
    """Kernel K6 ``pnp_refine`` on CUDA tensors, :func:`pnp_refine_plain` on CPU."""
    args = (R0, t0, ok0, pts3d, pts2d, valid, K, threshold, min_inliers, iters)
    if R0.is_cuda:
        return pnp_refine_cuda(*args)
    if R0.device.type == "cpu":
        return pnp_refine_plain(*args)
    raise ValueError(f"pnp_refine: unsupported device {R0.device}")


def pnp_ransac(pts3d, pts2d, valid, K, iters: int = 1024, threshold: float = 8.0,
               min_inliers: int = 15, refine_iters: int = 10, sample_size: int = 3,
               generator: torch.Generator | None = None, indices=None):
    """One candidate: :func:`pnp_ransac_batch` with B = 1, unbatched outputs."""
    out = pnp_ransac_batch(
        pts3d[None], pts2d[None], valid[None], K,
        torch.tensor([min_inliers], device=pts3d.device), iters=iters, threshold=threshold,
        refine_iters=refine_iters, sample_size=sample_size, generator=generator,
        indices=None if indices is None else indices[None])
    return {k: v[0] for k, v in out.items()}
