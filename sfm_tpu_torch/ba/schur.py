"""The linearized LM system, its exact dense Schur-complement solve and its
matrix-free PCG solve.

Counterpart of ``sfm_tpu/ba/schur.py``. The camera block B (6, or 10 with
``BAConfig.per_camera_intrinsics``: pose | fx fy cx cy) and the scalar type
of the normal equations (float32, or float64 with
``BAConfig.f64_normal_equations``) are properties of the system, read off
its tensors; each kernel entry below has one instantiation a route
(:func:`variant`), the default route's (B = 6, float32) unchanged:

* :func:`linearize` computes everything that depends only on the
  parameters (whitened Jacobians, undamped U/V blocks, gradients) -- kernel
  K8+K9 (``csrc/ba_linearize.cu``: a row pass and a sum pass over the
  :func:`linearize_layout` of the grouping, chunks of one camera's rows,
  built once a problem) on a CUDA tensor; on a CPU tensor its twin,
  ``residuals_and_jacobians`` + :func:`linearize_system`;
* :func:`damp_operator` applies a given lambda -- kernel K10's
  ``schur_damp`` (``csrc/schur_damp.cu``: the adjugate inverses of the damped
  point blocks and the reduced right-hand side, its sums shifted by
  :func:`rhs_term_bound`), its twin :func:`schur_damp_plain`;
* :func:`dense_schur_direct` assembles the reduced camera + intrinsics
  system S from the per-point co-observation grouping
  (:func:`coobs_pairs`) -- kernel K10 (``csrc/schur_coupling.cu``: the
  coupling, the camera blocks U_c + diag(lambda D_c) and the intrinsics
  row and column, walking the :func:`coupling_layout` of the grouping,
  built once a problem), its twin :func:`schur_matrix_plain` -- and
  solves it by Cholesky (``torch.linalg.cholesky_ex``, a library call);
* :func:`back_substitute` recovers the point step -- K10's
  ``schur_back_substitute``, its twin :func:`schur_back_substitute_plain`;
* past ``BAConfig.use_dense_schur_below`` cameras S is never formed:
  :func:`block_jacobi` inverts the damped camera blocks (K10's
  ``schur_block_jacobi``, twin :func:`block_jacobi_plain`),
  :func:`schur_matvec` applies S (kernel K11, ``csrc/schur_pcg.cu``, over
  the :func:`matvec_layout` of the grouping, built once a problem; twin
  :func:`schur_matvec_plain`) and :func:`pcg_solve` runs the block-Jacobi
  preconditioned CG (K11's ``pcg_init`` / ``pcg_step`` around the matvec,
  twin :func:`pcg_solve_plain`).

The per-camera Hessian additions ``U_extra`` (the per-camera intrinsics
regularization, (C, B, B)) are part of U but not of the Jc products, so the
matvec adds them explicitly, as the reference's does.

Not ported: the one-hot (O, C) camera reduction (a TPU matmul trick) and
``dense_schur_solve`` (the matvec-built dense S).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from sfm_tpu_torch import _kernels
from sfm_tpu_torch.ba.residuals import (
    huber_weights, residuals_and_jacobians, residuals_and_jacobians_percam)

_EPS = 1e-10
# A slot pair of K10's coupling layout keeps its orientation in the bits of
# its second slot's number from here up (csrc/schur_coupling.cu).
_PAIR_FLAG_SHIFT = 30
# Bytes of shared memory a block of K10's rhs walk holds for its camera sums
# on the H100 (227 KB).
_SMEM_BYTES = 232_448


def variant(B: int, dtype) -> str:
    """The route suffix of a K8-K11 entry point: "" for the default route
    (B = 6, float32), "_b10" (per-camera intrinsics), "_f64" (the f64
    island), "_b10_f64" (both)."""
    if B not in (6, 10) or dtype not in (torch.float32, torch.float64):
        raise ValueError(f"BA kernels: no route for B = {B}, {dtype}")
    return ("_b10" if B == 10 else "") + ("_f64" if dtype == torch.float64 else "")


def _words(dtype) -> int:
    """64-bit words of an order-free sum's target: two in the f64 island
    (``csrc/sfm_common.cuh``)."""
    return 2 if dtype == torch.float64 else 1


def max_cameras(B: int, dtype) -> int:
    """The most cameras whose WORDS x (BC + 4) 64-bit sums a block of K10's
    rhs walk can stage in shared memory."""
    return (_SMEM_BYTES // (8 * _words(dtype)) - 4) // B


def camera_sums_in_shared(C: int, B: int, dtype) -> bool:
    """The route of K10's rhs walk: each block stages its camera sums in
    shared memory (True, up to :func:`max_cameras`), or adds them straight
    into the global words (False, any C). Both add the same 64-bit integers,
    so they give the same bits."""
    return C <= max_cameras(B, dtype)


class Linearization(NamedTuple):
    """Lambda-independent linearized system at the current parameters.
    All Jacobians are whitened (sqrt Huber weight x validity masks). B is the
    camera block (6 or 10); every float tensor has the island's dtype."""

    Jc: torch.Tensor        # (O, 2, B), zero for fixed/invalid cams and obs
    Jk: torch.Tensor        # (O, 2, 4), zero when the intrinsics are frozen
    Jp: torch.Tensor        # (O, 2, 3), zero for invalid points and obs
    rw: torch.Tensor        # (O, 2) whitened residuals
    obs_cam: torch.Tensor   # (O,) int32
    obs_point: torch.Tensor # (O,) int32
    V: torch.Tensor         # (P, 3, 3) undamped point blocks
    U: torch.Tensor         # (C, B, B) undamped camera blocks, U_extra included
    Uk: torch.Tensor        # (4, 4) intrinsics block, regularization included
    g_c: torch.Tensor       # (C, B), g_c_extra included
    g_k: torch.Tensor       # (4,), regularization gradient included
    g_p: torch.Tensor       # (P, 3)
    point_valid: torch.Tensor  # (P,) bool
    Hreg_k: Optional[torch.Tensor] = None  # (4, 4) intrinsics regularization (in Uk too)
    U_extra: Optional[torch.Tensor] = None  # (C, B, B) per-camera additions to U


class Damped(NamedTuple):
    """The per-lambda part of the system."""

    Vinv: torch.Tensor        # (P, 3, 3) damped inverse point blocks
    lam_diag_c: torch.Tensor  # (C, B) damping diagonal (+ unit pin on dead entries)
    lam_diag_k: torch.Tensor  # (4,)
    Mc: Optional[torch.Tensor] = None  # (C, B, B) block-Jacobi inverses (PCG only)
    Mk: Optional[torch.Tensor] = None  # (4, 4)


def _seg_sum(values, ids, n):
    out = torch.zeros((n,) + values.shape[1:], dtype=values.dtype, device=values.device)
    return out.index_add_(0, ids.long(), values)


def linearize_system(Jc, Jk, Jp, r, w, obs_cam, obs_point, obs_valid, cam_free,
                     point_valid, Hreg_k, num_cameras, num_points, g_k_extra=None,
                     U_extra=None, g_c_extra=None):
    """Whiten Jacobians and reduce every lambda-independent block (twin of
    kernel K9's reductions). cam_free: (C,) float, 1 for optimized poses.
    U_extra (C, B, B) / g_c_extra (C, B): per-camera additions to U and g_c
    (the per-camera intrinsics regularization)."""
    sw = torch.sqrt(w * obs_valid)[:, None]
    free_o = cam_free[obs_cam.long()][:, None]
    pv_o = point_valid[obs_point.long()].to(Jc.dtype)[:, None]
    Jc = Jc * (sw * free_o)[..., None]
    Jk = Jk * sw[..., None]
    Jp = Jp * (sw * pv_o)[..., None]
    rw = r * sw
    V = _seg_sum(Jp.mT @ Jp, obs_point, num_points)
    U = _seg_sum(Jc.mT @ Jc, obs_cam, num_cameras)
    if U_extra is not None:
        U = U + U_extra
    Uk = torch.einsum("oci,ocj->ij", Jk, Jk) + Hreg_k
    g_c = _seg_sum((Jc.mT @ rw[..., None])[..., 0], obs_cam, num_cameras)
    if g_c_extra is not None:
        g_c = g_c + g_c_extra
    g_k = torch.einsum("oci,oc->i", Jk, rw)
    if g_k_extra is not None:
        g_k = g_k + g_k_extra
    g_p = _seg_sum((Jp.mT @ rw[..., None])[..., 0], obs_point, num_points)
    return Linearization(Jc=Jc, Jk=Jk, Jp=Jp, rw=rw, obs_cam=obs_cam, obs_point=obs_point,
                         V=V, U=U, Uk=Uk, g_c=g_c, g_k=g_k, g_p=g_p,
                         point_valid=point_valid, Hreg_k=Hreg_k, U_extra=U_extra)


def linearize_plain(rvec, tvec, intr, points, obs_cam, obs_point, obs_xy, obs_w, cam_free,
                    point_valid, perm, perm_valid, delta, optimize_intrinsics, Hreg_k, g_k_reg,
                    U_extra=None, g_c_extra=None, dtype=torch.float32):
    if intr.dim() == 2:
        # Per-camera intrinsics (the reference's lm.py:171-198): the dead
        # shared-k system, and the gauge pins only the pose columns, so a
        # fixed camera's intrinsics stay free (obs_w already drops the
        # invalid cameras' rows, so every row's intrinsics columns count).
        r, Jc, Jp = residuals_and_jacobians_percam(rvec, tvec, intr, points, obs_cam,
                                                   obs_point, obs_xy)
        Jk = torch.zeros(r.shape[:1] + (2, 4), dtype=r.dtype, device=r.device)
        pose_free = cam_free[obs_cam.long()][:, None]
        Jc = Jc * torch.cat([pose_free.expand(-1, 6), torch.ones_like(pose_free).expand(-1, 4)],
                            -1)[:, None, :]
        cam_free = torch.ones_like(cam_free)
    else:
        r, Jc, Jk, Jp = residuals_and_jacobians(rvec, tvec, intr, points, obs_cam, obs_point,
                                                obs_xy)
        if not optimize_intrinsics:
            Jk = Jk * 0.0
    w = huber_weights(r, delta)
    # The f64 island (lm.py:204-212): everything from the whitening on.
    cast = lambda x: None if x is None else x.to(dtype)
    r, Jc, Jk, Jp, w, obs_w, cam_free, Hreg_k, g_k_reg, U_extra, g_c_extra = map(
        cast, (r, Jc, Jk, Jp, w, obs_w, cam_free, Hreg_k, g_k_reg, U_extra, g_c_extra))
    return linearize_system(Jc, Jk, Jp, r, w, obs_cam, obs_point, obs_w, cam_free, point_valid,
                            Hreg_k, rvec.shape[0], points.shape[0], g_k_extra=g_k_reg,
                            U_extra=U_extra, g_c_extra=g_c_extra)


# K8+K9's chunk table (linearize_layout) aims at four blocks an SM of the
# H100's 132, in chunks of at least this many rows.
_LIN_GRID = 4 * 132
_LIN_MIN_ROWS = 128


def grouping_order(perm, perm_valid, obs_cam):
    """The :func:`coobs_pairs` grouping's valid slots in camera-major order,
    on its device: (walk, cams, cam_walk). ``walk`` (Ov,): each row's
    leading run of valid slots, rows in order, as their observations;
    ``cams`` (Ov,): each slot's camera; ``cam_walk`` (Ov,) int64: the slots
    in camera-major order (a stable sort by camera). K8+K9's, K10's coupling
    and K11's layouts start from it (:func:`linearize_layout`,
    :func:`coupling_layout`, :func:`matvec_layout`), and ``run_ba`` makes it
    once for all three."""
    lead = torch.cumprod(perm_valid.to(torch.int32), dim=1).bool()
    walk = perm[lead]
    cams = obs_cam[walk.long()]
    return walk, cams, torch.argsort(cams, stable=True)


def linearize_layout(perm, perm_valid, obs_cam, obs_point, obs_w, C: int, P: int,
                     grouping=None):
    """K8+K9 ``ba_linearize``'s walk over the :func:`coobs_pairs` grouping, on
    its device: (rows, chunks, rest, orphans), int32.

    ``rows`` (Ov,): the grouping's valid rows in camera-major order
    (:func:`grouping_order`, given as ``grouping`` or made here); ``chunks``
    (N, 4): (camera, start, end, the camera's number of chunks), each
    camera's run of ``rows`` cut into near-equal chunks of at most
    max(``_LIN_MIN_ROWS``, Ov / ``_LIN_GRID``) rows, one empty chunk for a
    camera with no row (one chunk of camera -1 when C = 0); ``rest``
    (O - Ov,): the rows outside the grouping, in order; ``orphans``: the
    points that no grouping row holds. The kernel writes zeros for both, so
    every row with ``obs_w`` != 0 must be in the grouping, once: raises
    otherwise, and for a grouping row whose camera is not in [0, C). A few
    host syncs."""
    dev = perm.device
    O = obs_cam.shape[0]
    walk, cams, cam_walk = (grouping if grouping is not None
                            else grouping_order(perm, perm_valid, obs_cam))
    Ov = walk.shape[0]
    held = torch.zeros(O, dtype=torch.int32, device=dev).index_add_(
        0, walk.long(), torch.ones(Ov, dtype=torch.int32, device=dev))
    rest = torch.nonzero(held == 0).flatten()
    bad = torch.stack([(held > 1).any(), (obs_w[rest] != 0).any(),
                       ((cams < 0) | (cams >= C)).any()]).tolist()
    if bad[0] or bad[2]:
        raise ValueError("K8+K9 ba_linearize: a row twice in the grouping, or a grouping row's "
                         f"camera outside [0, {C})")
    if bad[1]:
        raise ValueError("K8+K9 ba_linearize: a row with obs_w != 0 is outside the grouping")
    counts = torch.bincount(cams.long(), minlength=C)
    L = max(_LIN_MIN_ROWS, -(-Ov // _LIN_GRID))
    n_ch = torch.clamp((counts + L - 1) // L, min=1)
    cam_of = torch.repeat_interleave(torch.arange(C, device=dev), n_ch)
    j = torch.arange(len(cam_of), device=dev) - (torch.cumsum(n_ch, 0) - n_ch)[cam_of]
    n, k, base = counts[cam_of], n_ch[cam_of], (torch.cumsum(counts, 0) - counts)[cam_of]
    chunks = torch.stack([cam_of, base + j * n // k, base + (j + 1) * n // k, k], 1)
    if C == 0:
        chunks = torch.tensor([[-1, 0, 0, 1]], device=dev)
    pts = torch.zeros(P, dtype=torch.bool, device=dev)
    pts[obs_point.long()[perm[:, 0][perm_valid[:, 0]].long()]] = True
    i32 = lambda t: t.to(torch.int32).contiguous()
    return (i32(walk[cam_walk]), i32(chunks), i32(rest),
            i32(torch.nonzero(~pts).flatten()))


class LinearizeWork(NamedTuple):
    """K8+K9 ``ba_linearize``'s layout (:func:`linearize_layout`) and scratch
    for one BA problem, made once a ``run_ba`` and reused by every
    linearization of its LM loop (``csrc/ba_linearize.cu``): ``cmax``,
    ``acc`` and ``tickets`` are zero between calls (the kernels clear
    them)."""

    rows: torch.Tensor     # (Ov,) int32
    chunks: torch.Tensor   # (N, 4) int32
    rest: torch.Tensor     # (O - Ov,) int32
    orphans: torch.Tensor  # (n,) int32
    cmax: torch.Tensor     # ((B + 1) C + 5,) int32: the largest |entry|s (float bits)
    acc: torch.Tensor      # (WORDS (C (B (B + 1) / 2 + B) + 14),) int64 fixed-point sums
    tickets: torch.Tensor  # (C + 1,) int32: a camera's chunks arrived, then all chunks


def _lin_sums(B: int, C: int) -> int:
    """The order-free sums of a linearization: U's upper triangle and g_c a
    camera, Uk's upper triangle and g_k."""
    return (B * (B + 1) // 2 + B) * C + 14


def linearize_workspace(perm, perm_valid, obs_cam, obs_point, obs_w, C: int, P: int, B: int,
                        dtype, grouping=None) -> LinearizeWork:
    """The :class:`LinearizeWork` of a problem with C cameras, P points and
    camera block B in ``dtype`` (the island's), on the grouping's device."""
    variant(B, dtype)
    dev = perm.device
    rows, chunks, rest, orphans = linearize_layout(perm, perm_valid, obs_cam, obs_point, obs_w,
                                                   C, P, grouping)
    return LinearizeWork(rows=rows, chunks=chunks, rest=rest, orphans=orphans,
                         cmax=torch.zeros((B + 1) * C + 5, dtype=torch.int32, device=dev),
                         acc=torch.zeros(_words(dtype) * _lin_sums(B, C), dtype=torch.int64,
                                         device=dev),
                         tickets=torch.zeros(C + 1, dtype=torch.int32, device=dev))


def linearize_cuda(rvec, tvec, intr, points, obs_cam, obs_point, obs_xy, obs_w, cam_free,
                   point_valid, perm, perm_valid, delta, optimize_intrinsics, Hreg_k, g_k_reg,
                   U_extra=None, g_c_extra=None, dtype=torch.float32,
                   work: Optional[LinearizeWork] = None):
    C, P, O = rvec.shape[0], points.shape[0], obs_cam.shape[0]
    G, Vs = perm.shape
    dev = rvec.device
    B = 10 if intr.dim() == 2 else 6
    route = variant(B, dtype)
    f32, i32 = torch.float32, torch.int32
    for name, x, dt, shape in (
            ("rvec", rvec, f32, (C, 3)), ("tvec", tvec, f32, (C, 3)),
            ("intr", intr, f32, (C, 4) if B == 10 else (4,)),
            ("points", points, f32, (P, 3)), ("obs_cam", obs_cam, i32, (O,)),
            ("obs_point", obs_point, i32, (O,)), ("obs_xy", obs_xy, f32, (O, 2)),
            ("obs_w", obs_w, f32, (O,)), ("cam_free", cam_free, f32, (C,)),
            ("point_valid", point_valid, torch.bool, (P,)),
            ("perm", perm, i32, (G, Vs)), ("perm_valid", perm_valid, torch.bool, (G, Vs)),
            *((("U_extra", U_extra, dtype, (C, B, B)),) if U_extra is not None else ()),
            *((("g_c_extra", g_c_extra, dtype, (C, B)),) if g_c_extra is not None else ())):
        _kernels.check_tensor(x, name, dt, shape, dev)
    if not route and (U_extra is not None or g_c_extra is not None):
        raise ValueError("ba_linearize: U_extra / g_c_extra need the per-camera route")
    if work is None:
        work = linearize_workspace(perm, perm_valid, obs_cam, obs_point, obs_w, C, P, B, dtype)
    Ov, N = work.rows.shape[0], work.chunks.shape[0]
    n_rest, n_orph = work.rest.shape[0], work.orphans.shape[0]
    for name, x, dt, shape in (
            ("rows", work.rows, i32, (Ov,)), ("chunks", work.chunks, i32, (N, 4)),
            ("rest", work.rest, i32, (n_rest,)), ("orphans", work.orphans, i32, (n_orph,)),
            ("cmax", work.cmax, i32, ((B + 1) * C + 5,)),
            ("acc", work.acc, torch.int64, (_words(dtype) * _lin_sums(B, C),)),
            ("tickets", work.tickets, i32, (C + 1,))):
        _kernels.check_tensor(x, name, dt, shape, dev)
    if Ov + n_rest != O or N < 1:
        raise ValueError("ba_linearize: the layout is not this problem's")
    # The kernels read a chunk 16 bytes a load.
    if work.chunks.data_ptr() % 16:
        raise ValueError("ba_linearize: the chunk table is not 16-byte aligned")
    e = lambda *s: torch.empty(s, dtype=dtype, device=dev)
    Jc, Jk, Jp, rw = e(O, 2, B), e(O, 2, 4), e(O, 2, 3), e(O, 2)
    U, g_c, Uk, g_k, V, g_p = e(C, B, B), e(C, B), e(4, 4), e(4), e(P, 3, 3), e(P, 3)
    # The per-camera route in f32 runs the first design's row kernel, which
    # reads point_valid as float (csrc/ba_linearize.cu).
    pv_f = point_valid.to(f32) if route == "_b10" else None
    _kernels.launch("ba_linearize" + route, dev, rvec, tvec, intr, points, obs_cam, obs_point,
                    obs_xy, obs_w, cam_free, point_valid, pv_f, perm, perm_valid, work.rows,
                    work.chunks, work.rest, work.orphans, C, O, G, Vs, N, n_rest, n_orph,
                    float(delta),
                    int(bool(optimize_intrinsics) and B == 6), Jc, Jk, Jp, rw, U, g_c, Uk, g_k,
                    V, g_p, work.cmax, work.acc, work.tickets,
                    *((U_extra, g_c_extra) if route else ()))
    Hreg_k = Hreg_k.to(dtype)
    return Linearization(Jc=Jc, Jk=Jk, Jp=Jp, rw=rw, obs_cam=obs_cam, obs_point=obs_point,
                         V=V, U=U, Uk=Uk + Hreg_k, g_c=g_c, g_k=g_k + g_k_reg.to(dtype),
                         g_p=g_p, point_valid=point_valid, Hreg_k=Hreg_k, U_extra=U_extra)


def linearize(*args, U_extra=None, g_c_extra=None, dtype=torch.float32,
              work: Optional[LinearizeWork] = None):
    """Kernel K8+K9 on CUDA tensors, its plain twin on CPU tensors.

    Arguments: rvec (C,3), tvec (C,3), intr (4,) shared or (C,4) per camera
    (the 10-parameter camera block), points (P,3), obs_cam (O,) int32,
    obs_point (O,) int32, obs_xy (O,2), obs_w (O,) f32 (0 = row excluded),
    cam_free (C,) f32 (with (C,4) intrinsics it pins the pose columns only),
    point_valid (P,) bool, perm / perm_valid (the :func:`coobs_pairs`
    grouping, which the kernel walks for the point-side sums), delta
    (Huber), optimize_intrinsics (of the shared K), Hreg_k (4,4) and g_k_reg
    (4,) (the shared intrinsics' regularization). U_extra (C,B,B) and
    g_c_extra (C,B): the per-camera additions, added after the sums. dtype:
    the island's (float64 with ``f64_normal_equations``); the Jacobians are
    computed in float32 and whitened in it. ``work``: the kernel's
    :func:`linearize_workspace`, reused across an LM loop (made here when
    None); the twin needs none.
    """
    dev = args[0].device
    kw = dict(U_extra=U_extra, g_c_extra=g_c_extra, dtype=dtype)
    if dev.type == "cuda":
        return linearize_cuda(*args, **kw, work=work)
    if dev.type == "cpu":
        return linearize_plain(*args, **kw)
    raise ValueError(f"linearize: unsupported device {dev}")


def schur_damp_plain(lin: Linearization, lam: float, perm=None, perm_valid=None):
    """Apply LM damping at ``lam``; returns (Damped, rhs_c (C,B), rhs_k (4,)).
    Plain twin of kernel K10's ``schur_damp`` (the grouping is not needed)."""
    dt, dev = lin.U.dtype, lin.U.device
    diagV = torch.diagonal(lin.V, dim1=-2, dim2=-1)
    Vd = lin.V + (lam * diagV + _EPS)[..., None] * torch.eye(3, dtype=dt, device=dev)
    Vinv = torch.where(lin.point_valid[:, None, None], torch.linalg.inv(Vd), 0.0).contiguous()
    diagU = torch.diagonal(lin.U, dim1=-2, dim2=-1)
    # Unit pin on camera parameters with no observation support keeps S PD
    # (per entry: the pose rows of a camera whose intrinsics stay free).
    lam_diag_c = lam * diagU + (diagU <= _EPS).to(dt)
    lam_diag_k = lam * torch.diagonal(lin.Uk) + _EPS
    # rhs_reduced = -g + W Vinv g_p.
    h_p = (Vinv @ lin.g_p[..., None])[..., 0]
    y_o = (lin.Jp @ h_p[lin.obs_point.long()][..., None])[..., 0]           # (O, 2)
    rhs_c = -lin.g_c + _seg_sum((lin.Jc.mT @ y_o[..., None])[..., 0], lin.obs_cam,
                                lin.U.shape[0])
    rhs_k = -lin.g_k + torch.einsum("oci,oc->i", lin.Jk, y_o)
    return Damped(Vinv=Vinv, lam_diag_c=lam_diag_c, lam_diag_k=lam_diag_k), rhs_c, rhs_k


def _block(lin: Linearization):
    """(B, dtype, route suffix) of a linearized system."""
    B, dt = lin.U.shape[-1], lin.U.dtype
    return B, dt, variant(B, dt)


def _check_system(lin: Linearization, perm, perm_valid, extra=()):
    """Check the Linearization tensors a K10 kernel reads (and ``extra``)."""
    C, P, O = lin.U.shape[0], lin.V.shape[0], lin.Jc.shape[0]
    G, Vs = perm.shape
    B, dt, _ = _block(lin)
    for name, x, dtype, shape in (
            ("Jc", lin.Jc, dt, (O, 2, B)), ("Jk", lin.Jk, dt, (O, 2, 4)),
            ("Jp", lin.Jp, dt, (O, 2, 3)), ("obs_cam", lin.obs_cam, torch.int32, (O,)),
            ("obs_point", lin.obs_point, torch.int32, (O,)), ("g_p", lin.g_p, dt, (P, 3)),
            ("perm", perm, torch.int32, (G, Vs)),
            ("perm_valid", perm_valid, torch.bool, (G, Vs)), *extra):
        _kernels.check_tensor(x, name, dtype, shape, lin.U.device)
    return C, P, G, Vs


class DampWork(NamedTuple):
    """K10 ``schur_damp``'s scratch for one BA problem, allocated once and
    reused across its LM iterations (``csrc/schur_damp.cu``): ``gmax``,
    ``ctrl`` and ``acc`` are zero between calls (the kernel clears them)."""

    h: torch.Tensor     # (P, 3) Vinv g_p
    gmax: torch.Tensor  # (BC + 4,) int32: each target's largest |term| (float bits)
    ctrl: torch.Tensor  # (2,) int32: the walk's blocks arrived, its finishers done
    acc: torch.Tensor   # (WORDS (BC + 4),) int64 fixed-point sums


def damp_workspace(lin: Linearization) -> DampWork:
    """The :class:`DampWork` of ``lin``'s shapes, on its device."""
    C, P = lin.U.shape[0], lin.V.shape[0]
    B, dt, _ = _block(lin)
    dev = lin.U.device
    n = B * C + 4
    return DampWork(h=torch.empty((P, 3), dtype=dt, device=dev),
                    gmax=torch.zeros(n, dtype=torch.int32, device=dev),
                    ctrl=torch.zeros(2, dtype=torch.int32, device=dev),
                    acc=torch.zeros(_words(dt) * n, dtype=torch.int64, device=dev))


def rhs_term_bound(lin: Linearization, Vinv, count: int) -> torch.Tensor:
    """The bound that shifts K10's reduced right-hand side sums, the twin of
    ``csrc/schur_damp.cu``'s (float64, (BC + 4,): the camera entries, then the
    four intrinsics): each target's largest term magnitude |Jc_o[:, r] .
    Jp_o h_p| (|Jk_o[:, r] . Jp_o h_p|), h_p = Vinv_p g_p, rounded up to
    float32 as the kernel keeps it, times ``count`` (the grouping's slots,
    G x Vs). A target's terms add up to at most it."""
    d = lambda x: x.double()
    h = (Vinv @ lin.g_p[..., None])[..., 0]
    y = d((lin.Jp @ h[lin.obs_point.long()][..., None])[..., 0])       # (O, 2)
    tc = (d(lin.Jc) * y[..., None]).sum(1).abs()                        # (O, B)
    tk = (d(lin.Jk) * y[..., None]).sum(1).abs()                        # (O, 4)
    C, B = lin.U.shape[0], lin.U.shape[-1]
    cam = torch.zeros((C, B), dtype=torch.float64).scatter_reduce_(
        0, lin.obs_cam.long()[:, None].expand(-1, B), tc, "amax")
    m = torch.cat([cam.reshape(-1), tk.amax(0) if len(tk) else torch.zeros(4,
                                                                         dtype=torch.float64)])
    up = m.float().double()
    m32 = torch.where(up < m, torch.nextafter(m.float(), torch.tensor(float("inf"))).double(),
                      up)
    return m32 * count


def schur_damp_cuda(lin: Linearization, lam: float, perm, perm_valid,
                    work: Optional[DampWork] = None):
    C, P, O = lin.U.shape[0], lin.V.shape[0], lin.Jc.shape[0]
    B, dt, route = _block(lin)
    dev = lin.U.device
    _, _, G, Vs = _check_system(lin, perm, perm_valid, (
        ("V", lin.V, dt, (P, 3, 3)), ("point_valid", lin.point_valid, torch.bool, (P,)),
        ("U", lin.U, dt, (C, B, B)), ("Uk", lin.Uk, dt, (4, 4)), ("g_c", lin.g_c, dt, (C, B)),
        ("g_k", lin.g_k, dt, (4,))))
    if work is None:
        work = damp_workspace(lin)
    n = B * C + 4
    for name, x, dtype, shape in (
            ("h", work.h, dt, (P, 3)), ("gmax", work.gmax, torch.int32, (n,)),
            ("ctrl", work.ctrl, torch.int32, (2,)),
            ("acc", work.acc, torch.int64, (_words(dt) * n,))):
        _kernels.check_tensor(x, name, dtype, shape, dev)
    e = lambda *s: torch.empty(s, dtype=dt, device=dev)
    Vinv, lam_diag_c, lam_diag_k, rhs_c, rhs_k = e(P, 3, 3), e(C, B), e(4), e(C, B), e(4)
    _kernels.launch("schur_damp" + route, dev, lin.V, lin.point_valid, lin.U, lin.Uk, lin.g_c,
                    lin.g_k, lin.g_p, lin.Jc, lin.Jk, lin.Jp, lin.obs_cam, lin.obs_point, P, C,
                    G, Vs, O, int(camera_sums_in_shared(C, B, dt)),
                    float(lam), Vinv, lam_diag_c, lam_diag_k, rhs_c, rhs_k, work.h, work.gmax,
                    work.ctrl, work.acc)
    return Damped(Vinv=Vinv, lam_diag_c=lam_diag_c, lam_diag_k=lam_diag_k), rhs_c, rhs_k


def damp_operator(lin: Linearization, lam: float, perm, perm_valid, precond: bool = False,
                  work: Optional[DampWork] = None):
    """Kernel K10 ``schur_damp`` on CUDA tensors, :func:`schur_damp_plain` on CPU.

    perm / perm_valid: the :func:`coobs_pairs` grouping, whose slot count
    sets the kernel's shifts (:func:`rhs_term_bound`). ``precond``: also the
    block-Jacobi inverses ``Mc`` / ``Mk`` of :func:`block_jacobi` (the PCG
    path's; the dense path has no use for them). ``work``: the kernel's
    :func:`damp_workspace`, reused across an LM loop (allocated here when
    None)."""
    dev = lin.U.device
    if dev.type == "cuda":
        op, rhs_c, rhs_k = schur_damp_cuda(lin, lam, perm, perm_valid, work)
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
    eyeB = torch.eye(U.shape[-1], dtype=dt, device=dev)
    Ud = U + lam_diag_c[..., None] * eyeB
    Mc = torch.linalg.inv(Ud + _EPS * eyeB)
    Mk = torch.linalg.inv(Uk + torch.diag(lam_diag_k) + _EPS * torch.eye(4, dtype=dt, device=dev))
    return Mc, Mk


def block_jacobi_cuda(U, lam_diag_c, Uk, lam_diag_k):
    C, B, dev, dt = U.shape[0], U.shape[-1], U.device, U.dtype
    route = variant(B, dt)
    for name, x, shape in (("U", U, (C, B, B)), ("lam_diag_c", lam_diag_c, (C, B)),
                           ("Uk", Uk, (4, 4)), ("lam_diag_k", lam_diag_k, (4,))):
        _kernels.check_tensor(x, name, dt, shape, dev)
    Mc = torch.empty((C, B, B), dtype=dt, device=dev)
    Mk = torch.empty((4, 4), dtype=dt, device=dev)
    _kernels.launch("schur_block_jacobi" + route, dev, U, lam_diag_c, Uk, lam_diag_k, C, Mc, Mk)
    return Mc, Mk


def block_jacobi(U, lam_diag_c, Uk, lam_diag_k):
    """K10's ``schur_block_jacobi`` on CUDA tensors, :func:`block_jacobi_plain`
    on CPU tensors: (Mc (C, B, B), Mk (4, 4))."""
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
    C, B = lin.U.shape[0], lin.U.shape[-1]
    n = B * C + 4
    S = torch.zeros((n, n), dtype=lin.U.dtype, device=lin.U.device)
    Ud = lin.U + torch.diag_embed(op.lam_diag_c)
    S[: B * C, : B * C] = torch.block_diag(*Ud) if C else S[:0, :0]
    S[B * C:, B * C:] = lin.Uk + torch.diag(op.lam_diag_k)
    return S


def schur_matrix_plain(lin: Linearization, op: Damped, perm, perm_valid):
    """The dense reduced system S ((BC+4)^2): blockdiag(U + lam D) minus the
    point-coupling sum over co-observation pairs, plus the k row/column."""
    C, B = lin.U.shape[0], lin.U.shape[-1]
    P = op.Vinv.shape[0]
    dt = lin.U.dtype
    pl = perm.long()
    M = lin.Jc.mT @ lin.Jp                                      # (O, B, 3)
    A = M @ op.Vinv[lin.obs_point.long()]                       # (O, B, 3)
    pv = perm_valid.to(dt)[..., None, None]
    Mg, Ag = M[pl] * pv, A[pl] * pv                             # (G, V, B, 3)
    onehot = torch.nn.functional.one_hot(lin.obs_cam.long()[pl], C).to(dt) * pv[..., 0]
    Z1 = torch.einsum("pvc,pvik->pkci", onehot, Mg).reshape(-1, B * C)
    Z2 = torch.einsum("pvc,pvik->pkci", onehot, Ag).reshape(-1, B * C)
    coupling = Z2.mT @ Z1
    coupling = 0.5 * (coupling + coupling.mT)
    S = _base_matrix(lin, op)
    S[: B * C, : B * C] -= coupling
    Wk = _seg_sum(lin.Jk.mT @ lin.Jp, lin.obs_point, P)         # (P, 4, 3)
    AkT = op.Vinv @ Wk.mT                                       # (P, 3, 4)
    cross = _seg_sum(lin.Jc.mT @ lin.Jk, lin.obs_cam, C)        # (C, B, 4)
    coup_ck = _seg_sum(M @ AkT[lin.obs_point.long()], lin.obs_cam, C)
    S_ck = (cross - coup_ck).reshape(B * C, 4)
    S[: B * C, B * C:] = S_ck
    S[B * C:, : B * C] = S_ck.mT
    S[B * C:, B * C:] -= torch.einsum("pik,pkj->ij", Wk, AkT)
    return S


def coupling_layout(perm, perm_valid, obs_cam, C: int, grouping=None):
    """K10 ``schur_coupling``'s walk over the :func:`coobs_pairs` grouping, on
    its device: (pairs, items, cam_slots, row_slot), int32.

    The valid slots are numbered row by row, each row's leading valid run in
    order (``row_slot`` (G,): the number of a row's first slot). ``pairs``
    (Np, 2): every point's slot pairs a <= b, as (slot a, slot b | flags <<
    30), sorted (stably) by their target block (P, Q) = (min, max) of the two
    slots' cameras. flags 1: the term A_a M_b^T lands at (c_a, c_b) in block
    (P, Q) as it is (c_a < c_b, or a == b); 2: at its mirror (c_a > c_b); 3:
    both (a != b in one camera). ``items`` (Ni, 4): (P, Q, start, end) of
    every camera's diagonal block, every camera pair with a slot pair, each
    camera's k block (Q = C, a run of ``cam_slots``) and the k-k block
    (P = Q = C), the longest runs first. ``cam_slots`` (Ov,): the slots in
    camera-major order (a stable sort: the ``cam_walk`` of
    :func:`grouping_order`, given as ``grouping`` or made here). Two host
    syncs."""
    dev = perm.device
    lead = torch.cumprod(perm_valid.to(torch.int32), dim=1).bool()
    nv = lead.sum(1)
    row_slot = torch.cumsum(nv, 0) - nv
    g, a = torch.nonzero(lead, as_tuple=True)            # the valid slots, in their order
    cnt = nv[g] - a                                       # the slots b >= a of each a
    n_pairs = int(cnt.sum())
    if n_pairs >= 2**31 or len(a) >= 2**_PAIR_FLAG_SHIFT:
        raise ValueError(f"K10 schur_coupling: {n_pairs} slot pairs over {len(a)} slots "
                         "exceed the int32 layout")
    rep = torch.repeat_interleave(torch.arange(len(a), device=dev), cnt)
    w_b = rep + (torch.arange(n_pairs, device=dev) - (torch.cumsum(cnt, 0) - cnt)[rep])
    _, slot_cams, cam_slots = (grouping if grouping is not None
                               else grouping_order(perm, perm_valid, obs_cam))
    cam = slot_cams.long()                                # each slot's camera
    ca, cb = cam[rep], cam[w_b]
    flags = torch.where((w_b == rep) | (ca < cb), 1, torch.where(ca > cb, 2, 3))
    key, order = torch.sort(torch.minimum(ca, cb) * C + torch.maximum(ca, cb), stable=True)
    pairs = torch.stack([rep[order], w_b[order] | (flags[order] << _PAIR_FLAG_SHIFT)], 1)
    # One item a target block: the diagonal blocks always (they hold U + lam D).
    keys, counts = torch.unique_consecutive(key, return_counts=True)
    ends = torch.cumsum(counts, 0)
    diag = torch.arange(C, device=dev) * (C + 1)
    empty = diag[~torch.isin(diag, keys)]          # cameras with no slot pair
    zero = torch.zeros_like(empty)
    keys = torch.cat([keys, empty])
    starts, ends = torch.cat([ends - counts, zero]), torch.cat([ends, zero])
    cam_start = torch.zeros(C + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(cam, minlength=C), 0, out=cam_start[1:])
    cams = torch.arange(C, device=dev)
    last = torch.tensor([[C, C, 0, 0]], device=dev)
    items = torch.cat([torch.stack([keys // C, keys % C, starts, ends], 1),
                       torch.stack([cams, torch.full_like(cams, C), cam_start[:-1],
                                    cam_start[1:]], 1), last])
    items = items[torch.argsort(items[:, 3] - items[:, 2], descending=True, stable=True)]
    i32 = lambda t: t.to(torch.int32).contiguous()
    return i32(pairs), i32(items), i32(cam_slots), i32(row_slot)


class CouplingWork(NamedTuple):
    """K10 ``schur_coupling``'s layout (:func:`coupling_layout`) and scratch for
    one BA problem, made once and reused by every S of its LM loop
    (``csrc/schur_coupling.cu``): ``kk`` and ``ctrl`` are zero between calls
    (the kernel clears them)."""

    pairs: torch.Tensor      # (Np, 2) int32
    items: torch.Tensor      # (Ni, 4) int32
    cam_slots: torch.Tensor  # (Ov,) int32
    row_slot: torch.Tensor   # (G,) int32
    terms: torch.Tensor      # (12 B Ov,) each valid slot's A, M and k-column rows of 4
    kk: torch.Tensor         # (16 WORDS,) int64 fixed-point sums of S_kk's coupling
    ctrl: torch.Tensor       # (2,) int32: the walk's blocks arrived, a term out of bounds
    er: torch.Tensor         # (BC + 4,) int32: each row's exponent, written a call


def coupling_workspace(lin: Linearization, perm, perm_valid, grouping=None) -> CouplingWork:
    """The :class:`CouplingWork` of ``lin``'s shapes and grouping, on its device
    (``grouping``: its :func:`grouping_order`, made here when None)."""
    C = lin.U.shape[0]
    B, dt, _ = _block(lin)
    dev = lin.U.device
    pairs, items, cam_slots, row_slot = coupling_layout(perm, perm_valid, lin.obs_cam, C,
                                                        grouping)
    return CouplingWork(pairs=pairs, items=items, cam_slots=cam_slots, row_slot=row_slot,
                        terms=torch.empty(12 * B * len(cam_slots), dtype=dt, device=dev),
                        kk=torch.zeros(16 * _words(dt), dtype=torch.int64, device=dev),
                        ctrl=torch.zeros(2, dtype=torch.int32, device=dev),
                        er=torch.empty(B * C + 4, dtype=torch.int32, device=dev))


def schur_matrix_cuda(lin: Linearization, op: Damped, perm, perm_valid,
                      work: Optional[CouplingWork] = None):
    C, P = lin.U.shape[0], op.Vinv.shape[0]
    B, dt, route = _block(lin)
    dev = lin.U.device
    _, _, G, Vs = _check_system(lin, perm, perm_valid, (
        ("Vinv", op.Vinv, dt, (P, 3, 3)), ("U", lin.U, dt, (C, B, B)),
        ("lam_diag_c", op.lam_diag_c, dt, (C, B)), ("Uk", lin.Uk, dt, (4, 4)),
        ("lam_diag_k", op.lam_diag_k, dt, (4,))))
    if work is None:
        work = coupling_workspace(lin, perm, perm_valid)
    Np, Ni, Ov = work.pairs.shape[0], work.items.shape[0], work.cam_slots.shape[0]
    for name, x, dtype, shape in (
            ("pairs", work.pairs, torch.int32, (Np, 2)), ("items", work.items, torch.int32, (Ni, 4)),
            ("cam_slots", work.cam_slots, torch.int32, (Ov,)),
            ("row_slot", work.row_slot, torch.int32, (G,)),
            ("terms", work.terms, dt, (12 * B * Ov,)),
            ("kk", work.kk, torch.int64, (16 * _words(dt),)),
            ("ctrl", work.ctrl, torch.int32, (2,)), ("er", work.er, torch.int32, (B * C + 4,))):
        _kernels.check_tensor(x, name, dtype, shape, dev)
    # The walk reads a slot pair 8 bytes, an item and a row of terms 16 bytes a load.
    if work.pairs.data_ptr() % 8 or work.items.data_ptr() % 16 or work.terms.data_ptr() % 16:
        raise ValueError("K10 schur_coupling: the layout is not aligned")
    n = B * C + 4
    S = torch.empty((n, n), dtype=dt, device=dev)
    _kernels.launch("schur_coupling" + route, dev, lin.Jc, lin.Jk, lin.Jp, lin.obs_point,
                    op.Vinv, perm, perm_valid, lin.U, op.lam_diag_c, lin.Uk, op.lam_diag_k,
                    work.pairs, work.items, work.cam_slots, work.row_slot, C, G, Vs, Ni, Ov, S,
                    work.terms, work.kk, work.ctrl, work.er)
    return S


def schur_matrix(lin: Linearization, op: Damped, perm, perm_valid,
                 work: Optional[CouplingWork] = None):
    """Kernel K10 on CUDA tensors (over ``work``, a :func:`coupling_workspace`
    made here when None), its plain twin on CPU tensors."""
    dev = lin.U.device
    if dev.type == "cuda":
        return schur_matrix_cuda(lin, op, perm, perm_valid, work)
    if dev.type == "cpu":
        return schur_matrix_plain(lin, op, perm, perm_valid)
    raise ValueError(f"schur_matrix: unsupported device {dev}")


def dense_schur_direct(op: Damped, lin: Linearization, rhs_c, rhs_k, perm, perm_valid,
                       work: Optional[CouplingWork] = None):
    """Assemble S and solve S x = rhs by Cholesky (cuSOLVER on the card, in
    the island's dtype). A factorization that fails (S not positive
    definite) yields a NaN step, which LM rejects. ``work``: the coupling's
    :func:`coupling_workspace`, reused across an LM loop."""
    C, B = rhs_c.shape
    S = schur_matrix(lin, op, perm, perm_valid, work)
    n = S.shape[0]
    S = S + _EPS * torch.eye(n, dtype=S.dtype, device=S.device)
    L, info = torch.linalg.cholesky_ex(S)
    rhs = torch.cat([rhs_c.reshape(-1), rhs_k])[:, None]
    x = torch.cholesky_solve(rhs, L)[:, 0]
    x = torch.where(info == 0, x, torch.nan)
    return x[: B * C].reshape(C, B), x[B * C:]


def schur_back_substitute_plain(lin: Linearization, op: Damped, xc, xk, perm=None,
                                perm_valid=None):
    """Point step: dp = Vinv (-g_p - W^T dx). Plain twin of kernel K10's
    ``schur_back_substitute`` (the grouping is not needed)."""
    a = (lin.Jc @ xc[lin.obs_cam.long()][..., None])[..., 0] + lin.Jk @ xk
    u_p = _seg_sum((lin.Jp.mT @ a[..., None])[..., 0], lin.obs_point, op.Vinv.shape[0])
    return (op.Vinv @ (-lin.g_p - u_p)[..., None])[..., 0]


def schur_back_substitute_cuda(lin: Linearization, op: Damped, xc, xk, perm, perm_valid):
    C, P = lin.U.shape[0], lin.V.shape[0]
    B, dt, route = _block(lin)
    _, _, G, Vs = _check_system(lin, perm, perm_valid, (
        ("Vinv", op.Vinv, dt, (P, 3, 3)), ("xc", xc, dt, (C, B)), ("xk", xk, dt, (4,))))
    dp = torch.empty((P, 3), dtype=dt, device=xc.device)
    _kernels.launch("schur_back_substitute" + route, xc.device, lin.Jc, lin.Jk, lin.Jp,
                    lin.obs_cam, lin.obs_point, perm, perm_valid, op.Vinv, lin.g_p, xc, xk, P,
                    G, Vs, dp)
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

def schur_matvec_plain(lin: Linearization, op: Damped, xc, xk, perm=None, perm_valid=None,
                       layout=None):
    """S x for x = (xc (C, B), xk (4,)), never forming S: the reference's
    ``schur_matvec`` (``sfm_tpu/ba/schur.py:232``),
    S x = Jc^T (B x - Jp Vinv Jp^T B x) + lam_diag o x + U_extra x_c
    (+ Hreg_k xk), with B x = Jc x_c + Jk xk per observation. U_extra (the
    per-camera intrinsics regularization) is part of U that the Jc products
    cannot rebuild, so it is applied here; without it PCG would solve
    another system than the dense path. Plain twin of kernel K11's
    ``schur_matvec`` (the grouping is not needed). With ``layout`` (a
    :func:`matvec_layout`) it walks the kernel's order instead of every
    observation: u per point over ``walk``'s runs, each slot's terms, the
    camera sums over the slots in ``cam_walk``'s order."""
    C, P = xc.shape[0], op.Vinv.shape[0]
    if layout is not None:
        return _schur_matvec_walk(lin, op, xc, xk, *(t.long() for t in layout))
    a = (lin.Jc @ xc[lin.obs_cam.long()][..., None])[..., 0] + lin.Jk @ xk       # (O, 2)
    u_p = _seg_sum((lin.Jp.mT @ a[..., None])[..., 0], lin.obs_point, P)
    v_p = (op.Vinv @ u_p[..., None])[..., 0]
    d = a - (lin.Jp @ v_p[lin.obs_point.long()][..., None])[..., 0]
    Sx_c = _seg_sum((lin.Jc.mT @ d[..., None])[..., 0], lin.obs_cam, C) + op.lam_diag_c * xc
    if lin.U_extra is not None:
        Sx_c = Sx_c + (lin.U_extra @ xc[..., None])[..., 0]
    Sx_k = torch.einsum("oci,oc->i", lin.Jk, d)
    return Sx_c, Sx_k + op.lam_diag_k * xk + lin.Hreg_k @ xk


def _schur_matvec_walk(lin: Linearization, op: Damped, xc, xk, walk, row_start, cam_walk,
                       cam_of):
    C, B = xc.shape
    o = walk
    R = len(row_start) - 1
    rows = torch.repeat_interleave(torch.arange(R, device=o.device), row_start.diff())
    Jc, Jk, Jp = lin.Jc[o], lin.Jk[o], lin.Jp[o]
    a = (Jc @ xc[lin.obs_cam.long()[o]][..., None])[..., 0] + Jk @ xk         # (Ov, 2)
    u = _seg_sum((Jp.mT @ a[..., None])[..., 0], rows, R)
    v = (op.Vinv[lin.obs_point.long()[o[row_start[:-1]]]] @ u[..., None])[..., 0]
    d = a - (Jp @ v[rows][..., None])[..., 0]
    terms = torch.cat([(Jc.mT @ d[..., None])[..., 0], (Jk.mT @ d[..., None])[..., 0]], -1)
    Sx_c = _seg_sum(terms[cam_walk, :B], cam_of, C) + op.lam_diag_c * xc
    if lin.U_extra is not None:
        Sx_c = Sx_c + (lin.U_extra @ xc[..., None])[..., 0]
    return Sx_c, terms[:, B:].sum(0) + op.lam_diag_k * xk + lin.Hreg_k @ xk


def matvec_layout(perm, perm_valid, obs_cam, grouping=None):
    """K11's walk order of the :func:`coobs_pairs` grouping, on its device:
    (walk, row_start, cam_walk, cam_of), int32. ``walk`` (Ov,): each row's
    leading run of valid slots, rows in order, slots in order (the
    observations point by point, as the reference's walk sums them);
    ``row_start`` (R + 1,): the offsets of the rows that have a slot;
    ``cam_walk`` (Ov,): the slots in camera-major order (a stable sort of
    the slots by camera: :func:`grouping_order`'s, given as ``grouping`` or
    made here); ``cam_of`` (Ov,): the camera of each of those. One host
    sync (the count of valid slots)."""
    lead = torch.cumprod(perm_valid.to(torch.int32), dim=1).bool()
    counts = lead.sum(1)
    counts = counts[counts > 0]
    walk, cams, cam_walk = (grouping if grouping is not None
                            else grouping_order(perm, perm_valid, obs_cam))
    row_start = torch.zeros(len(counts) + 1, dtype=torch.int64, device=perm.device)
    torch.cumsum(counts, 0, out=row_start[1:])
    i32 = lambda t: t.to(torch.int32).contiguous()
    return i32(walk), i32(row_start), i32(cam_walk), i32(cams[cam_walk])


class MatvecWork(NamedTuple):
    """K11 ``schur_matvec``'s layout (:func:`matvec_layout`) and scratch for
    one BA problem, made once and reused by every matvec of its PCG solves
    (``csrc/schur_pcg.cu``): ``gmax``, ``ctrl`` and ``acc`` are zero between
    calls (the kernel clears them)."""

    walk: torch.Tensor       # (Ov,) int32
    row_start: torch.Tensor  # (R + 1,) int32
    cam_walk: torch.Tensor   # (Ov,) int32
    cam_of: torch.Tensor     # (Ov,) int32
    terms: torch.Tensor      # ((B + 4) Ov,) each slot's terms, in walk order
    gmax: torch.Tensor       # (BC + 4,) int32: each target's largest |term| (float bits)
    ctrl: torch.Tensor       # (2,) int32: the add walk's blocks arrived, its finishers done
    acc: torch.Tensor        # (WORDS (BC + 4),) int64 fixed-point sums


def matvec_workspace(lin: Linearization, perm, perm_valid, grouping=None) -> MatvecWork:
    """The :class:`MatvecWork` of ``lin``'s shapes and grouping, on its device
    (``grouping``: its :func:`grouping_order`, made here when None)."""
    C = lin.U.shape[0]
    B, dt, _ = _block(lin)
    dev = lin.U.device
    walk, row_start, cam_walk, cam_of = matvec_layout(perm, perm_valid, lin.obs_cam, grouping)
    n = B * C + 4
    return MatvecWork(walk=walk, row_start=row_start, cam_walk=cam_walk, cam_of=cam_of,
                      terms=torch.empty((B + 4) * len(walk), dtype=dt, device=dev),
                      gmax=torch.zeros(n, dtype=torch.int32, device=dev),
                      ctrl=torch.zeros(2, dtype=torch.int32, device=dev),
                      acc=torch.zeros(_words(dt) * n, dtype=torch.int64, device=dev))


def _matvec_launch(lin: Linearization, op: Damped, x, perm, work: MatvecWork, Sx, flag=None):
    """K11's ``schur_matvec`` entry on the flat (BC + 4) vectors x -> Sx;
    with ``flag`` (the PCG state's "active" entry) a no-op once it is 0."""
    C = lin.U.shape[0]
    B, dt, route = _block(lin)
    G, Vs = perm.shape
    R, Ov = work.row_start.shape[0] - 1, work.walk.shape[0]
    _kernels.launch("schur_matvec" + route, x.device, lin.Jc, lin.Jk, lin.Jp, lin.obs_cam,
                    lin.obs_point, op.Vinv, op.lam_diag_c, op.lam_diag_k, lin.Hreg_k, x,
                    work.walk, work.row_start, work.cam_walk, work.cam_of, C, G, Vs, R, Ov, flag,
                    Sx, work.terms, work.gmax, work.ctrl, work.acc,
                    *((lin.U_extra,) if route else ()))


def _check_work(lin: Linearization, work: MatvecWork):
    C = lin.U.shape[0]
    B, dt, _ = _block(lin)
    R, Ov = work.row_start.shape[0] - 1, work.walk.shape[0]
    n, i32 = B * C + 4, torch.int32
    for name, x, dtype, shape in (
            ("walk", work.walk, i32, (Ov,)), ("row_start", work.row_start, i32, (R + 1,)),
            ("cam_walk", work.cam_walk, i32, (Ov,)), ("cam_of", work.cam_of, i32, (Ov,)),
            ("terms", work.terms, dt, ((B + 4) * Ov,)), ("gmax", work.gmax, i32, (n,)),
            ("ctrl", work.ctrl, i32, (2,)), ("acc", work.acc, torch.int64, (_words(dt) * n,))):
        _kernels.check_tensor(x, name, dtype, shape, lin.U.device)
    # The kernel reads the Jacobians' rows and the terms 16 or 8 bytes a load.
    for name, x in (("Jc", lin.Jc), ("Jk", lin.Jk), ("Jp", lin.Jp), ("terms", work.terms)):
        if x.data_ptr() % 16:
            raise ValueError(f"K11 schur_matvec: {name} is not 16-byte aligned")


def _check_pcg_system(lin: Linearization, op: Damped, perm, perm_valid, extra=()):
    C, P = lin.U.shape[0], op.Vinv.shape[0]
    B, dt, route = _block(lin)
    if not route and lin.U_extra is not None:
        raise ValueError("K11: U_extra needs the per-camera route")
    _check_system(lin, perm, perm_valid, (
        ("Vinv", op.Vinv, dt, (P, 3, 3)), ("lam_diag_c", op.lam_diag_c, dt, (C, B)),
        ("lam_diag_k", op.lam_diag_k, dt, (4,)), ("Hreg_k", lin.Hreg_k, dt, (4, 4)),
        *((("U_extra", lin.U_extra, dt, (C, B, B)),) if lin.U_extra is not None else ()),
        *extra))
    return C, B, dt


def schur_matvec_cuda(lin: Linearization, op: Damped, xc, xk, perm, perm_valid,
                      work: Optional[MatvecWork] = None):
    C, B, dt = _check_pcg_system(lin, op, perm, perm_valid)
    if work is None:
        work = matvec_workspace(lin, perm, perm_valid)
    _check_work(lin, work)
    x = torch.cat([xc.reshape(-1), xk]).to(dt).contiguous()
    Sx = torch.empty_like(x)
    _matvec_launch(lin, op, x, perm, work, Sx)
    return Sx[: B * C].reshape(C, B), Sx[B * C:]


def schur_matvec(lin: Linearization, op: Damped, xc, xk, perm, perm_valid,
                 work: Optional[MatvecWork] = None):
    """Kernel K11's ``schur_matvec`` on CUDA tensors (walking the
    :func:`coobs_pairs` grouping in the order of ``work``, a
    :func:`matvec_workspace` made here when None),
    :func:`schur_matvec_plain` on CPU tensors: (Sx_c (C, B), Sx_k (4,))."""
    dev = xc.device
    if dev.type == "cuda":
        return schur_matvec_cuda(lin, op, xc, xk, perm, perm_valid, work)
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
                   iters: int = 50, tol: float = 1e-6, work: Optional[MatvecWork] = None):
    """The CG loop launches all ``iters`` steps and never reads the device
    state: a converged state makes the remaining launches no-ops (reading
    the state every few steps to stop early gained nothing on the card,
    PERF.md)."""
    C, B = lin.U.shape[0], lin.U.shape[-1]
    dt = lin.U.dtype
    _check_pcg_system(lin, op, perm, perm_valid, (
        ("Mc", op.Mc, dt, (C, B, B)), ("Mk", op.Mk, dt, (4, 4)),
        ("rhs_c", rhs_c, dt, (C, B)), ("rhs_k", rhs_k, dt, (4,))))
    route = variant(B, dt)
    dev = rhs_c.device
    rhs = torch.cat([rhs_c.reshape(-1), rhs_k])
    x, r, z, p, Ap = (torch.empty_like(rhs) for _ in range(5))
    state = torch.zeros(5, dtype=dt, device=dev)   # r.z, |rhs|^2, r.r, active, steps
    cg = (op.Mc, op.Mk, C, int(iters), float(tol), x, r, z, p, state)
    if work is None:
        work = matvec_workspace(lin, perm, perm_valid)
    _check_work(lin, work)
    flag = state[3:4]
    _kernels.launch("pcg_init" + route, dev, rhs, *cg)
    for _ in range(int(iters)):
        _matvec_launch(lin, op, p, perm, work, Ap, flag=flag)
        _kernels.launch("pcg_step" + route, dev, Ap, *cg)
    return x[: B * C].reshape(C, B), x[B * C:], state[4]


def pcg_solve(lin: Linearization, op: Damped, rhs_c, rhs_k, perm, perm_valid,
              iters: int = 50, tol: float = 1e-6, work: Optional[MatvecWork] = None):
    """Kernel K11 (``pcg_init``, then per step the ``schur_matvec`` and
    ``pcg_step`` entries, no host sync) on CUDA tensors,
    :func:`pcg_solve_plain` on CPU tensors. ``op`` must carry ``Mc`` / ``Mk``
    (``damp_operator(..., precond=True)``). ``work``: the matvec's
    :func:`matvec_workspace`, reused across an LM loop (made here when
    None). Returns (xc, xk, steps taken as a 0-dim tensor, on the
    device)."""
    dev = rhs_c.device
    if dev.type == "cuda":
        return pcg_solve_cuda(lin, op, rhs_c, rhs_k, perm, perm_valid, iters, tol, work)
    if dev.type == "cpu":
        return pcg_solve_plain(lin, op, rhs_c, rhs_k, perm, perm_valid, iters, tol)
    raise ValueError(f"pcg_solve: unsupported device {dev}")
