"""The linearized LM system and its exact dense Schur-complement solve.

Counterpart of ``sfm_tpu/ba/schur.py`` on the path the main path runs
(shared intrinsics, at most ``BAConfig.use_dense_schur_below`` cameras):

* :func:`linearize` computes everything that depends only on the
  parameters (whitened Jacobians, undamped U/V blocks, gradients) -- kernel
  K8+K9 (``csrc/ba_linearize.cu``) on a CUDA tensor; on a CPU tensor its
  twin, ``residuals_and_jacobians`` + :func:`linearize_system`;
* :func:`damp_operator` applies a given lambda -- kernel K10's
  ``schur_damp`` (``csrc/schur_damp.cu``: the adjugate inverses of the damped
  point blocks and the reduced right-hand side, walking the grouping), its
  twin :func:`schur_damp_plain`;
* :func:`dense_schur_direct` assembles the reduced camera + intrinsics
  system S from the per-point co-observation grouping
  (:func:`coobs_pairs`) -- the coupling accumulation is kernel K10
  (``csrc/schur_coupling.cu``, which also adds the camera blocks
  U_c + diag(lambda D_c)), its twin :func:`schur_matrix_plain` -- and
  solves it by Cholesky (``torch.linalg.cholesky_ex``, a library call);
* :func:`back_substitute` recovers the point step -- K10's
  ``schur_back_substitute``, its twin :func:`schur_back_substitute_plain`.

Not ported: the one-hot (O, C) camera reduction (a TPU matmul trick),
``dense_schur_solve`` and the matrix-free PCG path (more than
``use_dense_schur_below`` cameras; ROADMAP).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sfm_tpu_torch import _kernels
from sfm_tpu_torch.ba.residuals import huber_weights, residuals_and_jacobians

_EPS = 1e-10


class Linearization(NamedTuple):
    """Lambda-independent linearized system at the current parameters.
    All Jacobians are whitened (sqrt Huber weight x validity masks)."""

    Jc: torch.Tensor        # (O, 2, 6), zero for fixed/invalid cams and obs
    Jk: torch.Tensor        # (O, 2, 4), zero when the intrinsics are frozen
    Jp: torch.Tensor        # (O, 2, 3), zero for invalid points and obs
    rw: torch.Tensor        # (O, 2) whitened residuals
    obs_cam: torch.Tensor   # (O,) int32
    obs_point: torch.Tensor # (O,) int32
    V: torch.Tensor         # (P, 3, 3) undamped point blocks
    U: torch.Tensor         # (C, 6, 6) undamped camera blocks
    Uk: torch.Tensor        # (4, 4) intrinsics block, regularization included
    g_c: torch.Tensor       # (C, 6)
    g_k: torch.Tensor       # (4,), regularization gradient included
    g_p: torch.Tensor       # (P, 3)
    point_valid: torch.Tensor  # (P,) bool


class Damped(NamedTuple):
    """The per-lambda part of the system."""

    Vinv: torch.Tensor        # (P, 3, 3) damped inverse point blocks
    lam_diag_c: torch.Tensor  # (C, 6) damping diagonal (+ unit pin on dead entries)
    lam_diag_k: torch.Tensor  # (4,)


def _seg_sum(values, ids, n):
    out = torch.zeros((n,) + values.shape[1:], dtype=values.dtype, device=values.device)
    return out.index_add_(0, ids.long(), values)


def linearize_system(Jc, Jk, Jp, r, w, obs_cam, obs_point, obs_valid, cam_free,
                     point_valid, Hreg_k, num_cameras, num_points, g_k_extra=None):
    """Whiten Jacobians and reduce every lambda-independent block (twin of
    kernel K9's reductions). cam_free: (C,) float, 1 for optimized poses."""
    sw = torch.sqrt(w * obs_valid)[:, None]
    free_o = cam_free[obs_cam.long()][:, None]
    pv_o = point_valid[obs_point.long()].to(Jc.dtype)[:, None]
    Jc = Jc * (sw * free_o)[..., None]
    Jk = Jk * sw[..., None]
    Jp = Jp * (sw * pv_o)[..., None]
    rw = r * sw
    V = _seg_sum(Jp.mT @ Jp, obs_point, num_points)
    U = _seg_sum(Jc.mT @ Jc, obs_cam, num_cameras)
    Uk = torch.einsum("oci,ocj->ij", Jk, Jk) + Hreg_k
    g_c = _seg_sum((Jc.mT @ rw[..., None])[..., 0], obs_cam, num_cameras)
    g_k = torch.einsum("oci,oc->i", Jk, rw)
    if g_k_extra is not None:
        g_k = g_k + g_k_extra
    g_p = _seg_sum((Jp.mT @ rw[..., None])[..., 0], obs_point, num_points)
    return Linearization(Jc=Jc, Jk=Jk, Jp=Jp, rw=rw, obs_cam=obs_cam, obs_point=obs_point,
                         V=V, U=U, Uk=Uk, g_c=g_c, g_k=g_k, g_p=g_p,
                         point_valid=point_valid)


def linearize_plain(rvec, tvec, intr, points, obs_cam, obs_point, obs_xy, obs_w, cam_free,
                    point_valid, perm, perm_valid, delta, optimize_intrinsics, Hreg_k, g_k_reg):
    r, Jc, Jk, Jp = residuals_and_jacobians(rvec, tvec, intr, points, obs_cam, obs_point,
                                            obs_xy)
    if not optimize_intrinsics:
        Jk = Jk * 0.0
    return linearize_system(Jc, Jk, Jp, r, huber_weights(r, delta), obs_cam, obs_point,
                            obs_w, cam_free, point_valid, Hreg_k, rvec.shape[0],
                            points.shape[0], g_k_extra=g_k_reg)


def linearize_cuda(rvec, tvec, intr, points, obs_cam, obs_point, obs_xy, obs_w, cam_free,
                   point_valid, perm, perm_valid, delta, optimize_intrinsics, Hreg_k, g_k_reg):
    C, P, O = rvec.shape[0], points.shape[0], obs_cam.shape[0]
    G, Vs = perm.shape
    dev = rvec.device
    f32, i32 = torch.float32, torch.int32
    for name, x, dt, shape in (
            ("rvec", rvec, f32, (C, 3)), ("tvec", tvec, f32, (C, 3)), ("intr", intr, f32, (4,)),
            ("points", points, f32, (P, 3)), ("obs_cam", obs_cam, i32, (O,)),
            ("obs_point", obs_point, i32, (O,)), ("obs_xy", obs_xy, f32, (O, 2)),
            ("obs_w", obs_w, f32, (O,)), ("cam_free", cam_free, f32, (C,)),
            ("perm", perm, i32, (G, Vs)), ("perm_valid", perm_valid, torch.bool, (G, Vs))):
        _kernels.check_tensor(x, name, dt, shape, dev)
    pv = point_valid.to(f32).contiguous()
    e = lambda *s: torch.empty(s, dtype=f32, device=dev)
    z = lambda *s: torch.zeros(s, dtype=f32, device=dev)
    Jc, Jk, Jp, rw = e(O, 2, 6), e(O, 2, 4), e(O, 2, 3), e(O, 2)
    U, g_c, Uk, g_k, V, g_p = z(C, 6, 6), z(C, 6), z(4, 4), z(4), z(P, 3, 3), z(P, 3)
    _kernels.launch("ba_linearize", dev, rvec, tvec, intr, points, obs_cam, obs_point,
                    obs_xy, obs_w, cam_free, pv, perm, perm_valid, C, P, O, G, Vs,
                    float(delta), int(bool(optimize_intrinsics)),
                    Jc, Jk, Jp, rw, U, g_c, Uk, g_k, V, g_p)
    return Linearization(Jc=Jc, Jk=Jk, Jp=Jp, rw=rw, obs_cam=obs_cam, obs_point=obs_point,
                         V=V, U=U, Uk=Uk + Hreg_k, g_c=g_c, g_k=g_k + g_k_reg, g_p=g_p,
                         point_valid=point_valid)


def linearize(*args):
    """Kernel K8+K9 on CUDA tensors, its plain twin on CPU tensors.

    Arguments: rvec (C,3), tvec (C,3), intr (4,), points (P,3), obs_cam (O,)
    int32, obs_point (O,) int32, obs_xy (O,2), obs_w (O,) f32 (0 = row
    excluded), cam_free (C,) f32, point_valid (P,) bool, perm / perm_valid
    (the :func:`coobs_pairs` grouping, which the kernel walks for the
    point-side sums), delta (Huber), optimize_intrinsics, Hreg_k (4,4) and
    g_k_reg (4,) (the intrinsics regularization).
    """
    dev = args[0].device
    if dev.type == "cuda":
        return linearize_cuda(*args)
    if dev.type == "cpu":
        return linearize_plain(*args)
    raise ValueError(f"linearize: unsupported device {dev}")


def schur_damp_plain(lin: Linearization, lam: float, perm=None, perm_valid=None):
    """Apply LM damping at ``lam``; returns (Damped, rhs_c (C,6), rhs_k (4,)).
    Plain twin of kernel K10's ``schur_damp`` (the grouping is not needed)."""
    dt, dev = lin.U.dtype, lin.U.device
    diagV = torch.diagonal(lin.V, dim1=-2, dim2=-1)
    Vd = lin.V + (lam * diagV + _EPS)[..., None] * torch.eye(3, dtype=dt, device=dev)
    Vinv = torch.where(lin.point_valid[:, None, None], torch.linalg.inv(Vd), 0.0).contiguous()
    diagU = torch.diagonal(lin.U, dim1=-2, dim2=-1)
    # Unit pin on camera parameters with no observation support keeps S PD.
    lam_diag_c = lam * diagU + (diagU <= _EPS).to(dt)
    lam_diag_k = lam * torch.diagonal(lin.Uk) + _EPS
    # rhs_reduced = -g + W Vinv g_p.
    h_p = (Vinv @ lin.g_p[..., None])[..., 0]
    y_o = (lin.Jp @ h_p[lin.obs_point.long()][..., None])[..., 0]           # (O, 2)
    rhs_c = -lin.g_c + _seg_sum((lin.Jc.mT @ y_o[..., None])[..., 0], lin.obs_cam,
                                lin.U.shape[0])
    rhs_k = -lin.g_k + torch.einsum("oci,oc->i", lin.Jk, y_o)
    return Damped(Vinv=Vinv, lam_diag_c=lam_diag_c, lam_diag_k=lam_diag_k), rhs_c, rhs_k


def _check_system(lin: Linearization, perm, perm_valid, extra=()):
    """Check the Linearization tensors a K10 kernel reads (and ``extra``)."""
    C, P, O = lin.U.shape[0], lin.V.shape[0], lin.Jc.shape[0]
    G, Vs = perm.shape
    dev, f32 = lin.U.device, torch.float32
    for name, x, dt, shape in (
            ("Jc", lin.Jc, f32, (O, 2, 6)), ("Jk", lin.Jk, f32, (O, 2, 4)),
            ("Jp", lin.Jp, f32, (O, 2, 3)), ("obs_cam", lin.obs_cam, torch.int32, (O,)),
            ("obs_point", lin.obs_point, torch.int32, (O,)), ("g_p", lin.g_p, f32, (P, 3)),
            ("perm", perm, torch.int32, (G, Vs)),
            ("perm_valid", perm_valid, torch.bool, (G, Vs)), *extra):
        _kernels.check_tensor(x, name, dt, shape, dev)
    return C, P, G, Vs


def schur_damp_cuda(lin: Linearization, lam: float, perm, perm_valid):
    C, P = lin.U.shape[0], lin.V.shape[0]
    dev, f32 = lin.U.device, torch.float32
    _, _, G, Vs = _check_system(lin, perm, perm_valid, (
        ("V", lin.V, f32, (P, 3, 3)), ("point_valid", lin.point_valid, torch.bool, (P,)),
        ("U", lin.U, f32, (C, 6, 6)), ("Uk", lin.Uk, f32, (4, 4)), ("g_c", lin.g_c, f32, (C, 6)),
        ("g_k", lin.g_k, f32, (4,))))
    e = lambda *s: torch.empty(s, dtype=f32, device=dev)
    Vinv, lam_diag_c, lam_diag_k, rhs_c, rhs_k = e(P, 3, 3), e(C, 6), e(4), e(C, 6), e(4)
    _kernels.launch("schur_damp", dev, lin.V, lin.point_valid, lin.U, lin.Uk, lin.g_c, lin.g_k,
                    lin.g_p, lin.Jc, lin.Jk, lin.Jp, lin.obs_cam, lin.obs_point, perm,
                    perm_valid, P, C, G, Vs, float(lam), Vinv, lam_diag_c, lam_diag_k, rhs_c,
                    rhs_k)
    return Damped(Vinv=Vinv, lam_diag_c=lam_diag_c, lam_diag_k=lam_diag_k), rhs_c, rhs_k


def damp_operator(lin: Linearization, lam: float, perm, perm_valid):
    """Kernel K10 ``schur_damp`` on CUDA tensors, :func:`schur_damp_plain` on CPU.

    perm / perm_valid: the :func:`coobs_pairs` grouping, which the kernel
    walks for the reduced right-hand side."""
    dev = lin.U.device
    if dev.type == "cuda":
        return schur_damp_cuda(lin, lam, perm, perm_valid)
    if dev.type == "cpu":
        return schur_damp_plain(lin, lam, perm, perm_valid)
    raise ValueError(f"damp_operator: unsupported device {dev}")


def coobs_pairs(obs_point, obs_valid, v_bucket: int = 8):
    """Host-side per-point grouping of the valid observations.

    Returns (perm (G_pad, V) int32 obs indices, valid (G_pad, V) bool): each
    row holds one point's valid observations as a leading run of slots; V =
    max observations per point rounded up to ``v_bucket``; G_pad = number of
    observed points rounded up to a power of two (at least 64). Dead slots
    index 0 and are masked.
    """
    obs_point = np.asarray(obs_point)
    idx = np.nonzero(np.asarray(obs_valid, bool))[0].astype(np.int64)
    if len(idx) == 0:
        return np.zeros((1, v_bucket), np.int32), np.zeros((1, v_bucket), bool)
    pts = obs_point[idx]
    order = np.argsort(pts, kind="stable")
    idx, pts = idx[order], pts[order]
    _, counts = np.unique(pts, return_counts=True)
    G = len(counts)
    V = int(-(-counts.max() // v_bucket) * v_bucket)
    G_pad = 64
    while G_pad < G:
        G_pad *= 2
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(idx)) - np.repeat(starts, counts)
    row = np.repeat(np.arange(G), counts)
    perm = np.zeros((G_pad, V), np.int32)
    valid = np.zeros((G_pad, V), bool)
    perm[row, pos] = idx
    valid[row, pos] = True
    return perm, valid


def _base_matrix(lin: Linearization, op: Damped):
    """S before the coupling: blockdiag(U + lam D) and Uk + diag(lam_k)."""
    C = lin.U.shape[0]
    n = 6 * C + 4
    S = torch.zeros((n, n), dtype=lin.U.dtype, device=lin.U.device)
    Ud = lin.U + torch.diag_embed(op.lam_diag_c)
    S[: 6 * C, : 6 * C] = torch.block_diag(*Ud) if C else S[:0, :0]
    S[6 * C:, 6 * C:] = lin.Uk + torch.diag(op.lam_diag_k)
    return S


def schur_matrix_plain(lin: Linearization, op: Damped, perm, perm_valid):
    """The dense reduced system S ((6C+4)^2): blockdiag(U + lam D) minus the
    point-coupling sum over co-observation pairs, plus the k row/column."""
    C = lin.U.shape[0]
    P = op.Vinv.shape[0]
    dt = lin.U.dtype
    pl = perm.long()
    M = lin.Jc.mT @ lin.Jp                                      # (O, 6, 3)
    A = M @ op.Vinv[lin.obs_point.long()]                       # (O, 6, 3)
    pv = perm_valid.to(dt)[..., None, None]
    Mg, Ag = M[pl] * pv, A[pl] * pv                             # (G, V, 6, 3)
    onehot = torch.nn.functional.one_hot(lin.obs_cam.long()[pl], C).to(dt) * pv[..., 0]
    Z1 = torch.einsum("pvc,pvik->pkci", onehot, Mg).reshape(-1, 6 * C)
    Z2 = torch.einsum("pvc,pvik->pkci", onehot, Ag).reshape(-1, 6 * C)
    coupling = Z2.mT @ Z1
    coupling = 0.5 * (coupling + coupling.mT)
    S = _base_matrix(lin, op)
    S[: 6 * C, : 6 * C] -= coupling
    Wk = _seg_sum(lin.Jk.mT @ lin.Jp, lin.obs_point, P)         # (P, 4, 3)
    AkT = op.Vinv @ Wk.mT                                       # (P, 3, 4)
    cross = _seg_sum(lin.Jc.mT @ lin.Jk, lin.obs_cam, C)        # (C, 6, 4)
    coup_ck = _seg_sum(M @ AkT[lin.obs_point.long()], lin.obs_cam, C)
    S_ck = (cross - coup_ck).reshape(6 * C, 4)
    S[: 6 * C, 6 * C:] = S_ck
    S[6 * C:, : 6 * C] = S_ck.mT
    S[6 * C:, 6 * C:] -= torch.einsum("pik,pkj->ij", Wk, AkT)
    return S


def schur_matrix_cuda(lin: Linearization, op: Damped, perm, perm_valid):
    C, P, O = lin.U.shape[0], op.Vinv.shape[0], lin.Jc.shape[0]
    G, Vs = perm.shape
    dev = lin.U.device
    f32 = torch.float32
    for name, x, dt, shape in (
            ("Jc", lin.Jc, f32, (O, 2, 6)), ("Jk", lin.Jk, f32, (O, 2, 4)),
            ("Jp", lin.Jp, f32, (O, 2, 3)), ("obs_cam", lin.obs_cam, torch.int32, (O,)),
            ("obs_point", lin.obs_point, torch.int32, (O,)),
            ("Vinv", op.Vinv, f32, (P, 3, 3)), ("perm", perm, torch.int32, (G, Vs)),
            ("perm_valid", perm_valid, torch.bool, (G, Vs)), ("U", lin.U, f32, (C, 6, 6)),
            ("lam_diag_c", op.lam_diag_c, f32, (C, 6))):
        _kernels.check_tensor(x, name, dt, shape, dev)
    # The kernel adds the camera blocks U_c + diag(lam D_c) into the zeroed S.
    n = 6 * C + 4
    S = torch.zeros((n, n), dtype=f32, device=dev)
    S[6 * C:, 6 * C:] = lin.Uk + torch.diag(op.lam_diag_k)
    _kernels.launch("schur_coupling", dev, lin.Jc, lin.Jk, lin.Jp, lin.obs_cam,
                    lin.obs_point, op.Vinv, perm, perm_valid, lin.U, op.lam_diag_c, C, G, Vs,
                    S)
    return S


def schur_matrix(lin: Linearization, op: Damped, perm, perm_valid):
    """Kernel K10 on CUDA tensors, its plain twin on CPU tensors."""
    dev = lin.U.device
    if dev.type == "cuda":
        return schur_matrix_cuda(lin, op, perm, perm_valid)
    if dev.type == "cpu":
        return schur_matrix_plain(lin, op, perm, perm_valid)
    raise ValueError(f"schur_matrix: unsupported device {dev}")


def dense_schur_direct(op: Damped, lin: Linearization, rhs_c, rhs_k, perm, perm_valid):
    """Assemble S and solve S x = rhs by Cholesky. A factorization that
    fails (S not positive definite) yields a NaN step, which LM rejects."""
    C = rhs_c.shape[0]
    S = schur_matrix(lin, op, perm, perm_valid)
    n = S.shape[0]
    S = S + _EPS * torch.eye(n, dtype=S.dtype, device=S.device)
    L, info = torch.linalg.cholesky_ex(S)
    rhs = torch.cat([rhs_c.reshape(-1), rhs_k])[:, None]
    x = torch.cholesky_solve(rhs, L)[:, 0]
    x = torch.where(info == 0, x, torch.nan)
    return x[: 6 * C].reshape(C, 6), x[6 * C:]


def schur_back_substitute_plain(lin: Linearization, op: Damped, xc, xk, perm=None,
                                perm_valid=None):
    """Point step: dp = Vinv (-g_p - W^T dx). Plain twin of kernel K10's
    ``schur_back_substitute`` (the grouping is not needed)."""
    a = (lin.Jc @ xc[lin.obs_cam.long()][..., None])[..., 0] + lin.Jk @ xk
    u_p = _seg_sum((lin.Jp.mT @ a[..., None])[..., 0], lin.obs_point, op.Vinv.shape[0])
    return (op.Vinv @ (-lin.g_p - u_p)[..., None])[..., 0]


def schur_back_substitute_cuda(lin: Linearization, op: Damped, xc, xk, perm, perm_valid):
    C, P = lin.U.shape[0], lin.V.shape[0]
    f32 = torch.float32
    _, _, G, Vs = _check_system(lin, perm, perm_valid, (
        ("Vinv", op.Vinv, f32, (P, 3, 3)), ("xc", xc, f32, (C, 6)), ("xk", xk, f32, (4,))))
    dp = torch.empty((P, 3), dtype=f32, device=xc.device)
    _kernels.launch("schur_back_substitute", xc.device, lin.Jc, lin.Jk, lin.Jp, lin.obs_cam,
                    lin.obs_point, perm, perm_valid, op.Vinv, lin.g_p, xc, xk, P, G, Vs, dp)
    return dp


def back_substitute(lin: Linearization, op: Damped, xc, xk, perm, perm_valid):
    """Kernel K10 ``schur_back_substitute`` on CUDA tensors (deterministic: one
    thread per grouping row, no atomics), its plain twin on CPU tensors."""
    dev = xc.device
    if dev.type == "cuda":
        return schur_back_substitute_cuda(lin, op, xc.contiguous(), xk.contiguous(), perm,
                                          perm_valid)
    if dev.type == "cpu":
        return schur_back_substitute_plain(lin, op, xc, xk, perm, perm_valid)
    raise ValueError(f"back_substitute: unsupported device {dev}")
