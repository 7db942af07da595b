"""Kernel K11's walk order of the grouping (``ba/schur.py::matvec_layout``),
and the matvec's workspace at its launches.

The kernel walks the :func:`coobs_pairs` grouping as a layout built once a
BA problem: each row's leading run of valid slots in order (u is summed in
slot order, as the reference's walk sums it), the rows' offsets, the slots
in camera-major order and the camera of each. Here the layout is held
against a numpy walk of the grouping, and ``schur_matvec_plain`` through it
(the kernel's order: u per row, each slot's terms, the camera sums over the
slots in camera-major order) against the JAX package's ``schur_matvec``
with pinned cameras, at B = 6 and B = 10 (1e-4 of the largest entry,
float32 in another order, as ``tests/test_torch_pcg.py``), and against the
plain product in float64 (1e-12). The wrappers' launches are recorded by a
monkeypatched ``_kernels.launch``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pcg import jax_system, pinned_problem, rel_err
from test_torch_percam import jax_percam_system, percam_problem
from torch_parity import n, t

from sfm_tpu.ba.schur import schur_matvec as j_matvec
from sfm_tpu_torch import _kernels
from sfm_tpu_torch.ba import schur as tschur


def numpy_layout(perm, valid, obs_cam):
    """The grouping walked row by row in numpy: each row's slots until its
    first invalid one; then a stable sort of the slots by camera."""
    walk, starts = [], [0]
    for row, ok in zip(perm, valid):
        run = [int(o) for o, v in zip(row, np.cumprod(ok)) if v]
        if run:
            walk += run
            starts.append(len(walk))
    walk = np.asarray(walk, np.int64)
    cams = obs_cam[walk]
    order = np.argsort(cams, kind="stable")
    return walk, np.asarray(starts), order, cams[order]


def _grouping(kind, rng):
    O, P, C = 400, 60, 9
    obs_point = rng.integers(0, P, O)
    obs_cam = rng.integers(0, C, O).astype(np.int32)
    if kind == "coobs_pairs":   # the engine's grouping: valid runs, padding rows
        perm, valid = tschur.coobs_pairs(obs_point, rng.random(O) > 0.25)
    else:                       # rows whose valid slots are not one leading run
        perm = rng.integers(0, O, (70, 12)).astype(np.int32)
        valid = rng.random((70, 12)) > 0.3
    return perm, valid, obs_cam


@pytest.mark.parametrize("kind", ["coobs_pairs", "gapped_rows"])
def test_matvec_layout_matches_a_numpy_walk(kind):
    perm, valid, obs_cam = _grouping(kind, np.random.default_rng(3))
    got = tschur.matvec_layout(torch.as_tensor(perm), torch.as_tensor(valid),
                               torch.as_tensor(obs_cam))
    want = numpy_layout(perm, valid, obs_cam)
    for name, a, b in zip(("walk", "row_start", "cam_walk", "cam_of"), got, want):
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    walk, row_start, cam_walk, cam_of = (a.numpy() for a in got)
    # cam_of is nondecreasing, it is each slot's own camera, and cam_walk
    # takes every slot once.
    assert (np.diff(cam_of) >= 0).all()
    np.testing.assert_array_equal(cam_of, obs_cam[walk[cam_walk]])
    np.testing.assert_array_equal(np.sort(cam_walk), np.arange(len(walk)))


def _port_b10_system(rng):
    prob, intr_c = percam_problem(rng)
    lin_j, (op_j, *_), obs_valid = jax_percam_system(prob, intr_c)
    C = prob.num_cameras
    fields = {f: t(np.asarray(getattr(lin_j, f))) for f in tschur.Linearization._fields
              if f != "U_extra"}
    lin = tschur.Linearization(**fields, U_extra=t(np.asarray(lin_j.U_extra)).expand(C, 10, 10))
    perm, pvm = (t(a) for a in tschur.coobs_pairs(np.asarray(prob.obs_point),
                                                   n(obs_valid) > 0))
    op, _, _ = tschur.damp_operator(lin, 1e-3, perm, pvm, precond=True)
    return op_j, lin, op, perm, pvm


def _port_b6_system(rng):
    (_, op_j, *_), (lin, op, _, _, perm, pvm) = jax_system(pinned_problem(rng))
    return op_j, lin, op, perm, pvm


@pytest.mark.parametrize("B", [6, 10])
def test_schur_matvec_plain_through_the_layout_matches_jax(rng, B):
    op_j, lin, op, perm, pvm = (_port_b6_system if B == 6 else _port_b10_system)(rng)
    C = lin.U.shape[0]
    xc = rng.normal(0, 1e-2, (C, B)).astype(np.float32)
    xk = rng.normal(0, 1e-1, 4).astype(np.float32)
    layout = tschur.matvec_layout(perm, pvm, lin.obs_cam)
    Sc, Sk = tschur.schur_matvec_plain(lin, op, t(xc), t(xk), layout=layout)
    Sc_j, Sk_j = j_matvec(op_j, jnp.asarray(xc), jnp.asarray(xk))
    assert rel_err(Sc, Sc_j) <= 1e-4 and rel_err(Sk, Sk_j) <= 1e-4
    # In float64 the walk and the plain product agree to rounding.
    d = lambda x: None if x is None else x.double()
    lin64 = lin._replace(**{f: d(getattr(lin, f)) for f in ("Jc", "Jk", "Jp", "Hreg_k",
                                                              "U_extra")})
    op64 = op._replace(Vinv=op.Vinv.double(), lam_diag_c=op.lam_diag_c.double(),
                       lam_diag_k=op.lam_diag_k.double())
    walked = tschur.schur_matvec_plain(lin64, op64, t(xc).double(), t(xk).double(),
                                       layout=layout)
    plain = tschur.schur_matvec_plain(lin64, op64, t(xc).double(), t(xk).double())
    for a, b in zip(walked, plain):
        assert rel_err(a, b) <= 1e-12


def test_matvec_wrappers_pass_the_layout_and_one_workspace(monkeypatch, rng):
    _, lin, op, perm, pvm = _port_b6_system(rng)
    lin = lin._replace(U_extra=None)   # the shared-intrinsics route has none
    op = op._replace(Mc=op.Mc.contiguous(), Mk=op.Mk.contiguous())
    calls = []
    monkeypatch.setattr(_kernels, "launch", lambda name, dev, *a: calls.append((name, a)))
    C = lin.U.shape[0]
    work = tschur.matvec_workspace(lin, perm, pvm)
    Ov, R = len(work.walk), len(work.row_start) - 1
    assert work.terms.shape == (10 * Ov,) and work.acc.shape == (6 * C + 4,)
    assert not work.gmax.any() and not work.ctrl.any() and not work.acc.any()
    Sc, Sk = tschur.schur_matvec_cuda(lin, op, torch.zeros(C, 6), torch.zeros(4), perm, pvm,
                                      work)
    name, a = calls[-1]
    assert name == "schur_matvec" and Sc.shape == (C, 6) and Sk.shape == (4,)
    # (Jc, Jk, Jp, obs_cam, obs_point, Vinv, lam_diag_c, lam_diag_k, Hreg_k, x,
    #  walk, row_start, cam_walk, cam_of, C, G, Vs, R, Ov, flag, Sx, terms, gmax,
    #  ctrl, acc)
    assert all(x is y for x, y in zip(a[10:14], work[:4]))
    assert a[14:19] == (C, *perm.shape, R, Ov) and a[19] is None
    assert all(x is y for x, y in zip(a[21:25], work[4:]))
    # A PCG solve launches every step's matvec on one workspace, no-op once
    # its flag (the state's "active" entry) is 0.
    calls.clear()
    rhs_c, rhs_k = torch.zeros(C, 6), torch.zeros(4)
    tschur.pcg_solve_cuda(lin, op, rhs_c, rhs_k, perm, pvm, 5, 1e-6)
    mv = [c[1] for c in calls if c[0] == "schur_matvec"]
    assert [c[0] for c in calls] == ["pcg_init"] + ["schur_matvec", "pcg_step"] * 5
    assert all(m[21] is mv[0][21] and m[10] is mv[0][10] for m in mv)
    assert all(m[19].shape == (1,) and m[19].data_ptr() == mv[0][19].data_ptr() for m in mv)
