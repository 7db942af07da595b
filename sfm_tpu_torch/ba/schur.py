"""The linearized LM system, its exact dense Schur-complement solve and its
matrix-free PCG solve.

Counterpart of ``sfm_tpu/ba/schur.py`` for shared intrinsics:

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
  ``schur_back_substitute``, its twin :func:`schur_back_substitute_plain`;
* past ``BAConfig.use_dense_schur_below`` cameras S is never formed:
  :func:`block_jacobi` inverts the damped camera blocks (K10's
  ``schur_block_jacobi``, twin :func:`block_jacobi_plain`),
  :func:`schur_matvec` applies S (kernel K11, ``csrc/schur_pcg.cu``, twin
  :func:`schur_matvec_plain`) and :func:`pcg_solve` runs the block-Jacobi
  preconditioned CG (K11's ``pcg_init`` / ``pcg_step`` around the matvec,
  twin :func:`pcg_solve_plain`).

Not ported: the one-hot (O, C) camera reduction (a TPU matmul trick),
``dense_schur_solve`` (the matvec-built dense S), and the per-camera
Hessian additions ``U_extra`` of the 10-parameter camera block (zero with
shared intrinsics; ROADMAP queue 2b).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

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
    Hreg_k: Optional[torch.Tensor] = None  # (4, 4) intrinsics regularization (in Uk too)


class Damped(NamedTuple):
    """The per-lambda part of the system."""

    Vinv: torch.Tensor        # (P, 3, 3) damped inverse point blocks
    lam_diag_c: torch.Tensor  # (C, 6) damping diagonal (+ unit pin on dead entries)
    lam_diag_k: torch.Tensor  # (4,)
    Mc: Optional[torch.Tensor] = None  # (C, 6, 6) block-Jacobi inverses (PCG only)
    Mk: Optional[torch.Tensor] = None  # (4, 4)


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
                         point_valid=point_valid, Hreg_k=Hreg_k)


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
    U, g_c, Uk, g_k, V, g_p = e(C, 6, 6), e(C, 6), e(4, 4), e(4), z(P, 3, 3), z(P, 3)
    # The order-free camera and intrinsics sums' scratch (ba_linearize.cu).
    fx_max = torch.empty(7 * C + 5, dtype=torch.int32, device=dev)
    fx_sh = torch.empty(27 * C + 14, dtype=torch.int32, device=dev)
    fx_acc = torch.empty(27 * C + 14, dtype=torch.int64, device=dev)
    _kernels.launch("ba_linearize", dev, rvec, tvec, intr, points, obs_cam, obs_point,
                    obs_xy, obs_w, cam_free, pv, perm, perm_valid, C, P, O, G, Vs,
                    float(delta), int(bool(optimize_intrinsics)),
                    Jc, Jk, Jp, rw, U, g_c, Uk, g_k, V, g_p, fx_max, fx_sh, fx_acc)
    return Linearization(Jc=Jc, Jk=Jk, Jp=Jp, rw=rw, obs_cam=obs_cam, obs_point=obs_point,
                         V=V, U=U, Uk=Uk + Hreg_k, g_c=g_c, g_k=g_k + g_k_reg, g_p=g_p,
                         point_valid=point_valid, Hreg_k=Hreg_k)


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


def _fx_scratch(n: int, dev):
    """Scratch of an order-free sum over n targets (``csrc/sfm_common.cuh``):
    the largest |term| of each target, its shift, its 64-bit integer sum."""
    return (torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.int64, device=dev))


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
                    rhs_k, *_fx_scratch(6 * C + 4, dev))
    return Damped(Vinv=Vinv, lam_diag_c=lam_diag_c, lam_diag_k=lam_diag_k), rhs_c, rhs_k


def damp_operator(lin: Linearization, lam: float, perm, perm_valid, precond: bool = False):
    """Kernel K10 ``schur_damp`` on CUDA tensors, :func:`schur_damp_plain` on CPU.

    perm / perm_valid: the :func:`coobs_pairs` grouping, which the kernel
    walks for the reduced right-hand side. ``precond``: also the
    block-Jacobi inverses ``Mc`` / ``Mk`` of :func:`block_jacobi` (the PCG
    path's; the dense path has no use for them)."""
    dev = lin.U.device
    if dev.type == "cuda":
        op, rhs_c, rhs_k = schur_damp_cuda(lin, lam, perm, perm_valid)
    elif dev.type == "cpu":
        op, rhs_c, rhs_k = schur_damp_plain(lin, lam, perm, perm_valid)
    else:
        raise ValueError(f"damp_operator: unsupported device {dev}")
    if precond:
        Mc, Mk = block_jacobi(lin.U, op.lam_diag_c, lin.Uk, op.lam_diag_k)
        op = op._replace(Mc=Mc, Mk=Mk)
    return op, rhs_c, rhs_k


def block_jacobi_plain(U, lam_diag_c, Uk, lam_diag_k):
    """The block-Jacobi preconditioner of the reduced system, as the
    reference's ``damp_operator`` (``sfm_tpu/ba/schur.py:197-200``): the
    inverses of the damped camera blocks and of the damped intrinsics block.
    A pinned camera (U = 0, unit damping) gets the identity."""
    dt, dev = U.dtype, U.device
    eye6 = torch.eye(6, dtype=dt, device=dev)
    Ud = U + lam_diag_c[..., None] * eye6
    Mc = torch.linalg.inv(Ud + _EPS * eye6)
    Mk = torch.linalg.inv(Uk + torch.diag(lam_diag_k) + _EPS * torch.eye(4, dtype=dt, device=dev))
    return Mc, Mk


def block_jacobi_cuda(U, lam_diag_c, Uk, lam_diag_k):
    C, dev, f32 = U.shape[0], U.device, torch.float32
    for name, x, shape in (("U", U, (C, 6, 6)), ("lam_diag_c", lam_diag_c, (C, 6)),
                           ("Uk", Uk, (4, 4)), ("lam_diag_k", lam_diag_k, (4,))):
        _kernels.check_tensor(x, name, f32, shape, dev)
    Mc = torch.empty((C, 6, 6), dtype=f32, device=dev)
    Mk = torch.empty((4, 4), dtype=f32, device=dev)
    _kernels.launch("schur_block_jacobi", dev, U, lam_diag_c, Uk, lam_diag_k, C, Mc, Mk)
    return Mc, Mk


def block_jacobi(U, lam_diag_c, Uk, lam_diag_k):
    """K10's ``schur_block_jacobi`` on CUDA tensors, :func:`block_jacobi_plain`
    on CPU tensors: (Mc (C, 6, 6), Mk (4, 4))."""
    dev = U.device
    if dev.type == "cuda":
        return block_jacobi_cuda(U.contiguous(), lam_diag_c.contiguous(), Uk.contiguous(),
                                 lam_diag_k.contiguous())
    if dev.type == "cpu":
        return block_jacobi_plain(U, lam_diag_c, Uk, lam_diag_k)
    raise ValueError(f"block_jacobi: unsupported device {dev}")


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
    # The kernel adds the camera blocks U_c + diag(lam D_c) into the zeroed S;
    # the coupling's order-free sums take an (n, n) int64 scratch.
    n = 6 * C + 4
    S = torch.zeros((n, n), dtype=f32, device=dev)
    S[6 * C:, 6 * C:] = lin.Uk + torch.diag(op.lam_diag_k)
    fx_acc = torch.empty((n, n), dtype=torch.int64, device=dev)
    fx_row = torch.empty(n + 1, dtype=torch.int32, device=dev)
    _kernels.launch("schur_coupling", dev, lin.Jc, lin.Jk, lin.Jp, lin.obs_cam,
                    lin.obs_point, op.Vinv, perm, perm_valid, lin.U, op.lam_diag_c, C, G, Vs,
                    S, fx_acc, fx_row)
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


# ------------------------------------------------------------ K11: matrix-free PCG

def schur_matvec_plain(lin: Linearization, op: Damped, xc, xk, perm=None, perm_valid=None):
    """S x for x = (xc (C, 6), xk (4,)), never forming S: the reference's
    ``schur_matvec`` (``sfm_tpu/ba/schur.py:232``),
    S x = Jc^T (B x - Jp Vinv Jp^T B x) + lam_diag o x (+ Hreg_k xk), with
    B x = Jc x_c + Jk xk per observation. Plain twin of kernel K11's
    ``schur_matvec`` (the grouping is not needed). The reference's
    ``U_extra`` term is zero with shared intrinsics and is left out: the
    per-camera 10-parameter block is not ported (ROADMAP queue 2b)."""
    C, P = xc.shape[0], op.Vinv.shape[0]
    a = (lin.Jc @ xc[lin.obs_cam.long()][..., None])[..., 0] + lin.Jk @ xk       # (O, 2)
    u_p = _seg_sum((lin.Jp.mT @ a[..., None])[..., 0], lin.obs_point, P)
    v_p = (op.Vinv @ u_p[..., None])[..., 0]
    d = a - (lin.Jp @ v_p[lin.obs_point.long()][..., None])[..., 0]
    Sx_c = _seg_sum((lin.Jc.mT @ d[..., None])[..., 0], lin.obs_cam, C)
    Sx_k = torch.einsum("oci,oc->i", lin.Jk, d)
    return Sx_c + op.lam_diag_c * xc, Sx_k + op.lam_diag_k * xk + lin.Hreg_k @ xk


# A matvec's per-block camera sums live in shared memory: 6C + 4 64-bit
# integers of the H100's 227 KB a block.
_K11_MAX_CAMERAS = (232_448 // 8 - 4) // 6


def _matvec_launch(lin: Linearization, op: Damped, x, perm, perm_valid, Sx, flag=None,
                   scratch=None):
    """K11's ``schur_matvec`` entry on the flat (6C + 4) vectors x -> Sx;
    with ``flag`` (the PCG state's "active" entry) a no-op once it is 0.
    ``scratch``: :func:`_fx_scratch` of 6C + 4, reused across a solve."""
    C = lin.U.shape[0]
    G, Vs = perm.shape
    if scratch is None:
        scratch = _fx_scratch(6 * C + 4, x.device)
    _kernels.launch("schur_matvec", x.device, lin.Jc, lin.Jk, lin.Jp, lin.obs_cam,
                    lin.obs_point, perm, perm_valid, op.Vinv, op.lam_diag_c, op.lam_diag_k,
                    lin.Hreg_k, x, C, G, Vs, flag, Sx, *scratch)


def _check_pcg_system(lin: Linearization, op: Damped, perm, perm_valid, extra=()):
    C, P = lin.U.shape[0], op.Vinv.shape[0]
    if C > _K11_MAX_CAMERAS:
        raise ValueError(f"K11: {C} cameras > {_K11_MAX_CAMERAS} (the camera sums of a "
                         "block no longer fit in shared memory)")
    f32 = torch.float32
    _check_system(lin, perm, perm_valid, (
        ("Vinv", op.Vinv, f32, (P, 3, 3)), ("lam_diag_c", op.lam_diag_c, f32, (C, 6)),
        ("lam_diag_k", op.lam_diag_k, f32, (4,)), ("Hreg_k", lin.Hreg_k, f32, (4, 4)),
        *extra))
    return C


def schur_matvec_cuda(lin: Linearization, op: Damped, xc, xk, perm, perm_valid):
    C = _check_pcg_system(lin, op, perm, perm_valid)
    x = torch.cat([xc.reshape(-1), xk]).to(torch.float32).contiguous()
    Sx = torch.empty_like(x)
    _matvec_launch(lin, op, x, perm, perm_valid, Sx)
    return Sx[: 6 * C].reshape(C, 6), Sx[6 * C:]


def schur_matvec(lin: Linearization, op: Damped, xc, xk, perm, perm_valid):
    """Kernel K11's ``schur_matvec`` on CUDA tensors (walking the
    :func:`coobs_pairs` grouping), :func:`schur_matvec_plain` on CPU
    tensors: (Sx_c (C, 6), Sx_k (4,))."""
    dev = xc.device
    if dev.type == "cuda":
        return schur_matvec_cuda(lin, op, xc, xk, perm, perm_valid)
    if dev.type == "cpu":
        return schur_matvec_plain(lin, op, xc, xk, perm, perm_valid)
    raise ValueError(f"schur_matvec: unsupported device {dev}")


def pcg_solve_plain(lin: Linearization, op: Damped, rhs_c, rhs_k, perm=None, perm_valid=None,
                    iters: int = 50, tol: float = 1e-6):
    """Block-Jacobi preconditioned CG on S x = rhs, the reference's
    ``pcg_solve`` (``sfm_tpu/ba/schur.py:261``): at most ``iters`` steps,
    stopping before a step once |r| <= tol |rhs|, with the same pAp and
    r.z > 1e-10 guards. Returns (xc, xk, steps taken). Plain twin of K11's
    ``pcg_init`` / ``pcg_step``."""
    def precond(rc, rk):
        return (op.Mc @ rc[..., None])[..., 0], op.Mk @ rk

    def dot(ac, ak, bc, bk):
        return (ac * bc).sum() + (ak * bk).sum()

    xc, xk = torch.zeros_like(rhs_c), torch.zeros_like(rhs_k)
    rc, rk = rhs_c, rhs_k
    zc, zk = precond(rc, rk)
    pc, pk = zc, zk
    rz = dot(rc, rk, zc, zk)
    rhs_norm = torch.sqrt(dot(rhs_c, rhs_k, rhs_c, rhs_k))
    steps = 0
    while steps < iters and bool(torch.sqrt(dot(rc, rk, rc, rk)) > tol * rhs_norm):
        Apc, Apk = schur_matvec_plain(lin, op, pc, pk)
        pAp = dot(pc, pk, Apc, Apk)
        alpha = torch.where(pAp > _EPS, rz / pAp, 0.0)
        xc, xk = xc + alpha * pc, xk + alpha * pk
        rc, rk = rc - alpha * Apc, rk - alpha * Apk
        zc, zk = precond(rc, rk)
        rz_new = dot(rc, rk, zc, zk)
        beta = torch.where(rz > _EPS, rz_new / rz, 0.0)
        pc, pk = zc + beta * pc, zk + beta * pk
        rz = rz_new
        steps += 1
    return xc, xk, torch.tensor(steps)


def pcg_solve_cuda(lin: Linearization, op: Damped, rhs_c, rhs_k, perm, perm_valid,
                   iters: int = 50, tol: float = 1e-6):
    """The CG loop launches all ``iters`` steps and never reads the device
    state: a converged state makes the remaining launches no-ops (reading
    the state every few steps to stop early gained nothing on the card,
    PERF.md)."""
    f32 = torch.float32
    C = lin.U.shape[0]
    _check_pcg_system(lin, op, perm, perm_valid, (
        ("Mc", op.Mc, f32, (C, 6, 6)), ("Mk", op.Mk, f32, (4, 4)),
        ("rhs_c", rhs_c, f32, (C, 6)), ("rhs_k", rhs_k, f32, (4,))))
    dev = rhs_c.device
    rhs = torch.cat([rhs_c.reshape(-1), rhs_k])
    x, r, z, p, Ap = (torch.empty_like(rhs) for _ in range(5))
    state = torch.zeros(5, dtype=f32, device=dev)   # r.z, |rhs|^2, r.r, active, steps
    cg = (op.Mc, op.Mk, C, int(iters), float(tol), x, r, z, p, state)
    scratch = _fx_scratch(6 * C + 4, dev)
    _kernels.launch("pcg_init", dev, rhs, *cg)
    for _ in range(int(iters)):
        _matvec_launch(lin, op, p, perm, perm_valid, Ap, flag=state[3:4], scratch=scratch)
        _kernels.launch("pcg_step", dev, Ap, *cg)
    return x[: 6 * C].reshape(C, 6), x[6 * C:], state[4]


def pcg_solve(lin: Linearization, op: Damped, rhs_c, rhs_k, perm, perm_valid,
              iters: int = 50, tol: float = 1e-6):
    """Kernel K11 (``pcg_init``, then per step the ``schur_matvec`` and
    ``pcg_step`` entries, no host sync) on CUDA tensors,
    :func:`pcg_solve_plain` on CPU tensors. ``op`` must carry ``Mc`` / ``Mk``
    (``damp_operator(..., precond=True)``). Returns (xc, xk, steps taken as a
    0-dim tensor, on the device)."""
    dev = rhs_c.device
    if dev.type == "cuda":
        return pcg_solve_cuda(lin, op, rhs_c, rhs_k, perm, perm_valid, iters, tol)
    if dev.type == "cpu":
        return pcg_solve_plain(lin, op, rhs_c, rhs_k, perm, perm_valid, iters, tol)
    raise ValueError(f"pcg_solve: unsupported device {dev}")
