"""K10's damping as redesigned for the H100: the bound that shifts the reduced
right-hand side's order-free sums (``csrc/schur_damp.cu``, twin
``sfm_tpu_torch.ba.schur.rhs_term_bound``), its scratch, and its wrappers.

The kernel's point pass takes each target's largest |term| over the
grouping's rows, and the observation walk adds at the shift of max x G Vs
(the bits of the two walks it replaces). Here every camera and intrinsics
target's terms |Jc_o[:, r] . y_o| (and |Jk_o[:, r] . y_o|), summed in
float64, must lie within that bound, on all four routes (B = 6 / 10,
float32 / float64), on the corridor that ``render_scene.py`` renders (its
cameras, K and surfaces; no pixels) and on a synthetic arc; and the bound
must leave the fixed-point sums far finer than the route's rounding. The
a-priori bound 4 sqrt(U_rr) sqrt(P max_p |h_p|^2 tr V_p), which would spare
the maxima, holds as well (it costs 11-13 bits of slack against the maxima's
8-10 here), but rounds the terms to another grid: the engine's models move,
and the kernel keeps the maxima (``PERF.md``, section 6).
"""
import numpy as np
import pytest
import torch

from test_ba import make_scene

from sfm_tpu_torch import _kernels
from sfm_tpu_torch.ba import schur as tschur
from sfm_tpu_torch.geometry.rotations import rotation_to_rvec
from sfm_tpu_torch.render_scene import build_corridor, corridor_poses
from sfm_tpu_torch.config import CameraConfig

ROUTES = [(6, torch.float32), (10, torch.float32), (6, torch.float64), (10, torch.float64)]
ROUTE_IDS = ["b6_f32", "b10_f32", "b6_f64", "b10_f64"]
# Bits below the bound a term keeps (csrc/sfm_common.cuh: TOP).
TOP = {torch.float32: 61, torch.float64: 93}


def corridor_system(rng, n_cams=12, n_pts=1500):
    """The rendered corridor's geometry: its cameras and K, points on its
    surfaces seen by every camera that frames them, 0.5 px noise, poses and
    points perturbed."""
    K = CameraConfig().K().astype(np.float64)
    quads = build_corridor(np.random.default_rng(0), n_cams * 0.5)
    Rs, centers = corridor_poses(n_cams)
    pick = rng.integers(0, len(quads), n_pts)
    pts = np.zeros((n_pts, 3))
    for i, q in enumerate(quads[j] for j in pick):
        pts[i, q.axis] = q.value
        pts[i, q.a_axis] = rng.uniform(q.a0, q.a1)
        pts[i, q.b_axis] = rng.uniform(q.b0, q.b1)
    cams, pids, xys = [], [], []
    for c in range(n_cams):
        Xc = (pts - centers[c]) @ Rs[c].T
        uv = Xc[:, :2] / Xc[:, 2:] * K[[0, 1], [0, 1]] + K[:2, 2]
        vis = (Xc[:, 2] > 0.1) & (uv[:, 0] > 0) & (uv[:, 0] < 1024) & (uv[:, 1] > 0) & (
            uv[:, 1] < 768)
        for p in np.nonzero(vis)[0]:
            cams.append(c)
            pids.append(p)
            xys.append(uv[p] + rng.normal(0, 0.5, 2))
    rvec = np.stack([np.asarray(rotation_to_rvec(torch.as_tensor(R, dtype=torch.float32)))
                     for R in Rs]).reshape(n_cams, 3)
    tvec = -np.einsum("cij,cj->ci", Rs, centers)
    rvec = rvec + rng.normal(0, 0.005, rvec.shape)
    tvec = tvec + rng.normal(0, 0.02, tvec.shape)
    pts = pts + rng.normal(0, 0.02, pts.shape)
    intr = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
    return rvec, tvec, intr, pts, np.array(cams), np.array(pids), np.array(xys)


def arc_system(rng):
    s = make_scene(rng, n_cams=8, n_pts=300, noise_px=0.5)
    return (s["rvec"] + rng.normal(0, 0.01, s["rvec"].shape),
            s["tvec"] + rng.normal(0, 0.05, s["tvec"].shape), s["intr"],
            s["points"] + rng.normal(0, 0.02, s["points"].shape), s["obs_cam"], s["obs_point"],
            s["obs_xy"])


def port_system(arrays, B, dtype, rng):
    """The port's linearization (twin of K8+K9) of ``arrays`` on a route, camera
    0 fixed, every 13th point invalid, and the reduced rhs's per-target terms."""
    rvec, tvec, intr, pts, cam, pid, xy = arrays
    C, P, O = len(rvec), len(pts), len(cam)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    i = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32)
    if B == 10:
        intr_t = f(np.asarray(intr)[None] + rng.normal(0, [5.0, 5.0, 2.0, 2.0], (C, 4)))
    else:
        intr_t = f(intr)
    cam_free = torch.ones(C)
    cam_free[0] = 0.0
    pv = torch.ones(P, dtype=torch.bool)
    pv[::13] = False
    perm, pvm = (torch.as_tensor(a) for a in tschur.coobs_pairs(np.asarray(pid),
                                                                 np.ones(O, bool)))
    extra = {}
    if B == 10:
        U_extra = torch.zeros((C, 10, 10))
        U_extra[:, 6:, 6:] = 0.01 * torch.eye(4)
        extra = {"U_extra": U_extra.to(dtype), "g_c_extra": torch.zeros((C, 10), dtype=dtype)}
    lin = tschur.linearize_plain(
        f(rvec), f(tvec), intr_t, f(pts), i(cam), i(pid), f(xy), torch.ones(O), cam_free, pv,
        perm, pvm, 2.0, True, 0.01 * torch.eye(4), torch.zeros(4), dtype=dtype, **extra)
    return lin, perm, pvm


def target_terms(lin, Vinv):
    """Each target's terms' magnitude sum (float64), as the max pass saw them."""
    d = lambda x: x.double()
    h = (d(Vinv) @ d(lin.g_p)[..., None])[..., 0]
    y = (d(lin.Jp) @ h[lin.obs_point.long()][..., None])[..., 0]          # (O, 2)
    tc = (d(lin.Jc) * y[..., None]).sum(1).abs()                           # (O, B)
    tk = (d(lin.Jk) * y[..., None]).sum(1).abs()                           # (O, 4)
    C = lin.U.shape[0]
    cam = torch.zeros((C, tc.shape[1]), dtype=torch.float64).index_add_(
        0, lin.obs_cam.long(), tc)
    return torch.cat([cam.reshape(-1), tk.sum(0)]), len(y)


def apriori_bound(lin, Vinv):
    """2^(a_r + b), 2 sqrt(diag_r) < 2^a_r (U's diagonal, then Uk's), 2 sqrt(P max
    e_p) < 2^b, e_p = |h_p|^2 tr V_p: at least 4 sqrt(U_rr P max e)."""
    P = lin.V.shape[0]
    h = (Vinv @ lin.g_p[..., None])[..., 0].double()
    trV = torch.diagonal(lin.V, dim1=-2, dim2=-1).double().sum(-1).abs()
    e = float(((h * h).sum(-1) * trV).max())
    d = torch.cat([torch.diagonal(lin.U, dim1=-2, dim2=-1).reshape(-1),
                   torch.diagonal(lin.Uk)]).double().abs()
    exp = lambda x: torch.frexp(2.0 * torch.sqrt(x)).exponent
    return torch.ldexp(torch.ones_like(d), exp(d) + exp(torch.tensor(P * e, dtype=torch.float64)))


@pytest.mark.parametrize("system", ["corridor", "arc"])
@pytest.mark.parametrize("B,dtype", ROUTES, ids=ROUTE_IDS)
def test_rhs_sums_lie_within_the_kernels_bound(rng, system, B, dtype):
    arrays = corridor_system(rng) if system == "corridor" else arc_system(rng)
    lin, perm, pvm = port_system(arrays, B, dtype, rng)
    for lam in (1e-4, 1e-1):
        op, rhs_c, rhs_k = tschur.schur_damp_plain(lin, lam)
        bound = tschur.rhs_term_bound(lin, op.Vinv, perm.numel())
        mag, O = target_terms(lin, op.Vinv)
        assert bound.shape == mag.shape == (B * lin.U.shape[0] + 4,)
        # Every target's terms within the bound, the reduced rhs's sums
        # among them: the integer sums cannot overflow.
        assert bool((mag <= bound).all())
        rhs = torch.cat([(rhs_c + lin.g_c).reshape(-1), rhs_k + lin.g_k]).double()
        assert bool((rhs.abs() <= bound * (1 + 1e-5)).all())
        # The fixed point keeps each term to 2^(e - TOP), bound < 2^e; over a
        # target's terms that stays below 2^-30 (f32) / 2^-60 (f64) of their
        # magnitude sum, far under the route's own rounding of the result.
        live = mag > 0
        err = O * 2 * bound[live] * 2.0 ** -TOP[dtype]
        floor = 2.0 ** (-30 if dtype == torch.float32 else -60)
        assert bool((err <= floor * mag[live]).all()), float((err / mag[live]).max())
        # The a-priori bound holds too, with its two bits of headroom.
        assert bool((mag <= apriori_bound(lin, op.Vinv) / 4).all())


def test_bound_is_nan_free_and_zero_safe():
    # No observation support and zero gradients: the bound is finite and zero.
    C, P, O, B = 3, 4, 0, 6
    z = lambda *s: torch.zeros(s)
    lin = tschur.Linearization(
        Jc=z(O, 2, B), Jk=z(O, 2, 4), Jp=z(O, 2, 3), rw=z(O, 2),
        obs_cam=torch.zeros(O, dtype=torch.int32), obs_point=torch.zeros(O, dtype=torch.int32),
        V=z(P, 3, 3), U=z(C, B, B), Uk=torch.eye(4), g_c=z(C, B), g_k=z(4), g_p=z(P, 3),
        point_valid=torch.ones(P, dtype=torch.bool), Hreg_k=torch.eye(4))
    op, _, _ = tschur.schur_damp_plain(lin, 1e-3)
    bound = tschur.rhs_term_bound(lin, op.Vinv, 64)
    assert bound.shape == (B * C + 4,) and bool((bound == 0).all())


@pytest.mark.parametrize("B,dtype", ROUTES, ids=ROUTE_IDS)
def test_damp_workspace_is_reused_and_passed_to_the_kernel(monkeypatch, B, dtype):
    # The LM loop allocates K10's scratch once (sums and control words zero)
    # and every call passes those very tensors; without one the wrapper makes
    # its own.
    m = lambda *s, dtype=dtype: torch.empty(s, device="meta", dtype=dtype)
    C, P, O = 5, 7, 11
    lin = tschur.Linearization(
        Jc=m(O, 2, B), Jk=m(O, 2, 4), Jp=m(O, 2, 3), rw=m(O, 2),
        obs_cam=m(O, dtype=torch.int32), obs_point=m(O, dtype=torch.int32), V=m(P, 3, 3),
        U=m(C, B, B), Uk=m(4, 4), g_c=m(C, B), g_k=m(4), g_p=m(P, 3),
        point_valid=m(P, dtype=torch.bool), Hreg_k=m(4, 4))
    work = tschur.damp_workspace(lin)
    words = 2 if dtype == torch.float64 else 1
    assert work.h.shape == (P, 3) and work.gmax.shape == (B * C + 4,)
    assert work.ctrl.shape == (2,) and work.acc.shape == (words * (B * C + 4),)
    perm, pvm = m(13, 8, dtype=torch.int32), m(13, 8, dtype=torch.bool)
    calls = []
    monkeypatch.setattr(_kernels, "launch", lambda name, dev, *a: calls.append((name, a)))
    for _ in range(2):
        tschur.schur_damp_cuda(lin, 1e-3, perm, pvm, work)
    tschur.schur_damp_cuda(lin, 1e-3, perm, pvm)
    assert [c[0] for c in calls] == ["schur_damp" + tschur.variant(B, dtype)] * 3
    # (..., obs_point, P, C, G, Vs, O, in_shared, lam, Vinv, lam_diag_c, lam_diag_k,
    # rhs_c, rhs_k, h, gmax, ctrl, acc)
    assert calls[0][1][12:17] == (P, C, 13, 8, O)
    for a in calls[:2]:
        assert all(x is y for x, y in zip(a[1][-4:], work))
    assert calls[2][1][-1] is not work.acc and calls[2][1][-1].shape == work.acc.shape
    with pytest.raises(ValueError, match="shape"):
        tschur.schur_damp_cuda(lin, 1e-3, perm, pvm,
                               work=work._replace(acc=m(3, dtype=torch.int64)))


def test_damp_operator_on_cpu_ignores_the_workspace(rng):
    lin, perm, pvm = port_system(arc_system(rng), 6, torch.float32, rng)
    a = tschur.damp_operator(lin, 1e-3, perm, pvm)
    b = tschur.damp_operator(lin, 1e-3, perm, pvm, work=None)
    for x, y in zip((a[0].Vinv, a[1], a[2]), (b[0].Vinv, b[1], b[2])):
        assert torch.equal(x, y)
