"""Kernel K10's coupling as redesigned for the H100: the walk over the grouping
that ``ba/schur.py::coupling_layout`` builds once a BA problem, the dense S
that the plain twin builds, and the wrapper's launch.

The kernel (``csrc/schur_coupling.cu``) sums each entry of S as an order-free
fixed-point sum, walking every point's slot pairs a <= b sorted by their
target block, each camera's observations for its k block, and writing each
block once with its mirror. Here the layout is held against a numpy
enumeration of the slot pairs (each target block, the lower slot first, the
orientation flags), and a float64 walk through the layout, block by block as
the kernel walks it, against ``schur_matrix_plain`` at 1e-12 (float64, only
the order differs) on all four routes' shapes. ``schur_matrix_plain`` itself
is held against the dense S that the JAX package's own assembly code
(``sfm_tpu/ba/schur.py:360-418``) builds from the same linearization, at
1e-5 of its largest entry (float32, another summation order). The wrapper's launches are recorded by a
monkeypatched ``_kernels.launch``.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ba import perturbed_problem, port_linearization, rel_close
from torch_parity import n, t

from sfm_tpu.ba.schur import _cam_reduce, _seg_sum_pt
from sfm_tpu_torch import _kernels
from sfm_tpu_torch.ba import schur as tschur
from sfm_tpu_torch.ba.problem import problem_from_numpy

ROUTES = [(6, torch.float32), (10, torch.float32), (6, torch.float64), (10, torch.float64)]
ROUTE_IDS = ["b6_f32", "b10_f32", "b6_f64", "b10_f64"]
FLAG_SHIFT = 30


def random_grouping(seed, C, P, O, invalid=0.1):
    """Observations of random points by random cameras (some cameras see a
    point twice), a share of them invalid, and their grouping."""
    rng = np.random.default_rng(seed)
    obs_cam = rng.integers(0, C, O).astype(np.int32)
    obs_point = rng.integers(0, P, O).astype(np.int32)
    valid = rng.random(O) >= invalid
    perm, pvm = tschur.coobs_pairs(obs_point, valid)
    return obs_cam, obs_point, perm, pvm


def numpy_pairs(perm, pvm, obs_cam):
    """Every point's slot pairs a <= b of its leading valid slots:
    (P, Q, observation of a, observation of b, flags)."""
    out = []
    for row, ok in zip(perm, pvm):
        nv = int(np.cumprod(ok).sum())
        for a in range(nv):
            for b in range(a, nv):
                oa, ob = int(row[a]), int(row[b])
                ca, cb = int(obs_cam[oa]), int(obs_cam[ob])
                flags = 1 if a == b or ca < cb else (2 if ca > cb else 3)
                out.append((min(ca, cb), max(ca, cb), oa, ob, flags))
    return out


def layout_pairs(pairs, items, slots, C):
    """The layout's slot pairs as (P, Q, observation of a, observation of b,
    flags); ``slots``: each slot's observation."""
    words = pairs.numpy().astype(np.int64) & 0xFFFFFFFF
    out = []
    for P, Q, start, end in items.numpy().tolist():
        if Q == C:
            continue
        for k in range(start, end):
            out.append((P, Q, int(slots[words[k, 0]]),
                        int(slots[words[k, 1] & ((1 << FLAG_SHIFT) - 1)]),
                        int(words[k, 1] >> FLAG_SHIFT)))
    return out


@pytest.mark.parametrize("seed,C,P,O", [(0, 7, 40, 200), (1, 12, 300, 900), (2, 3, 5, 60)])
def test_coupling_layout_matches_a_numpy_enumeration(seed, C, P, O):
    obs_cam, _, perm, pvm = random_grouping(seed, C, P, O)
    pairs, items, cam_slots, row_slot = tschur.coupling_layout(t(perm), t(pvm), t(obs_cam), C)
    # The slots numbered row by row, each row's leading valid run in order.
    lead = np.cumprod(pvm, axis=1).astype(bool)
    slots = perm[lead]
    nv = lead.sum(1)
    np.testing.assert_array_equal(row_slot.numpy(), np.cumsum(nv) - nv)
    got = layout_pairs(pairs, items, slots, C)
    want = numpy_pairs(perm, pvm, obs_cam)
    assert sorted(got) == sorted(want)
    it = items.numpy()
    # One item a diagonal block (held U + lam D even without a pair), one a
    # camera pair with a slot pair, one a camera's k block, and the k-k block.
    diag = {(p, q) for p, q, _, _ in it if p == q < C}
    assert diag == {(c, c) for c in range(C)}
    off = {(p, q) for p, q, s, e in it if p < q < C}
    assert off == {(p, q) for p, q, *_ in want if p < q}
    assert all(e > s for p, q, s, e in it if p < q < C)
    assert sorted((p, q) for p, q, _, _ in it if q == C) == [(c, C) for c in range(C)] + [(C, C)]
    # The longest runs first.
    lengths = it[:, 3] - it[:, 2]
    assert (np.diff(lengths) <= 0).all()
    # k blocks: each camera's valid slots, camera-major, stable.
    np.testing.assert_array_equal(cam_slots.numpy(),
                                  np.argsort(obs_cam[slots], kind="stable"))
    for p, q, s, e in it:
        if q == C and p < C:
            assert (obs_cam[slots[cam_slots.numpy()[s:e]]] == p).all()
            assert e - s == int((obs_cam[slots] == p).sum())


def walk_schur(lin, op, perm, pvm):
    """S in float64 through the kernel's walk: each observation's A, M and
    k-column terms, then every item of the layout as the kernel sums it."""
    C, B = lin.U.shape[0], lin.U.shape[-1]
    P = op.Vinv.shape[0]
    pairs, items, cam_slots, _ = tschur.coupling_layout(perm, pvm, lin.obs_cam, C)
    slots = perm[torch.cumprod(pvm.to(torch.int32), 1).bool()].long()   # each slot's observation
    d = lambda x: x.to(torch.float64)
    Jc, Jk, Jp, Vinv = d(lin.Jc), d(lin.Jk), d(lin.Jp), d(op.Vinv)
    M = Jc.mT @ Jp                                                      # (O, B, 3)
    A = M @ Vinv[lin.obs_point.long()]
    Wk = tschur._seg_sum(Jk.mT @ Jp, lin.obs_point, P)                  # (P, 4, 3)
    AkT = Vinv @ Wk.mT
    Kt = Jc.mT @ Jk - M @ AkT[lin.obs_point.long()]                     # (O, B, 4)
    words = pairs.long() & 0xFFFFFFFF
    oa, ob = slots[words[:, 0]], slots[words[:, 1] & ((1 << FLAG_SHIFT) - 1)]
    flags = words[:, 1] >> FLAG_SHIFT
    X = A[oa] @ M[ob].mT                       # A of the lower slot, M of the higher
    f1 = (flags & 1).to(torch.float64)[:, None, None]
    f2 = (flags >> 1).to(torch.float64)[:, None, None]
    n_ = B * C + 4
    S = torch.zeros((n_, n_), dtype=torch.float64)
    U, lam = d(lin.U), d(op.lam_diag_c)
    for Pc, Qc, start, end in items.tolist():
        if Pc == C:    # the k-k block
            blk = d(lin.Uk) + torch.diag(d(op.lam_diag_k)) - torch.einsum("pik,pkj->ij", Wk, AkT)
            S[B * C:, B * C:] = blk
            continue
        if Qc == C:    # camera Pc's k block
            blk = Kt[slots[cam_slots[start:end].long()]].sum(0)
            S[Pc * B:(Pc + 1) * B, B * C:] = blk
            S[B * C:, Pc * B:(Pc + 1) * B] = blk.mT
            continue
        blk = U[Pc] + torch.diag(lam[Pc]) if Pc == Qc else torch.zeros((B, B), dtype=torch.float64)
        x = X[start:end]
        blk = blk - (x * (f1[start:end])).sum(0) - (x.mT * (f2[start:end])).sum(0)
        S[Pc * B:(Pc + 1) * B, Qc * B:(Qc + 1) * B] = blk
        S[Qc * B:(Qc + 1) * B, Pc * B:(Pc + 1) * B] = blk.mT
    return S


def walk_system(B, dtype, seed=3, C=5, P=60, O=400):
    """A linearized system of random Jacobians on a random grouping (some
    cameras see a point twice), damped."""
    g = torch.Generator().manual_seed(seed)
    obs_cam, obs_point, perm, pvm = random_grouping(seed, C, P, O)
    r = lambda *s: torch.randn(s, generator=g, dtype=torch.float64)
    Jc, Jk, Jp = r(O, 2, B), r(O, 2, 4), r(O, 2, 3)
    obs_w = torch.zeros(O, dtype=torch.float64)
    obs_w[perm[pvm].astype(np.int64)] = 1.0
    lin = tschur.linearize_system(
        Jc, Jk, Jp, r(O, 2), torch.ones(O, dtype=torch.float64), t(obs_cam), t(obs_point),
        obs_w, torch.ones(C, dtype=torch.float64), torch.ones(P, dtype=torch.bool),
        torch.eye(4, dtype=torch.float64), C, P)
    lin = lin._replace(**{f: getattr(lin, f).to(dtype).contiguous()
                          for f in ("Jc", "Jk", "Jp", "V", "U", "Uk", "g_c", "g_k", "g_p")})
    op, _, _ = tschur.schur_damp_plain(lin, 1e-2)
    return lin, op, t(perm), t(pvm)


@pytest.mark.parametrize("B,dtype", ROUTES, ids=ROUTE_IDS)
def test_walk_through_the_layout_rebuilds_the_plain_S(B, dtype):
    lin, op, perm, pvm = walk_system(B, dtype)
    # In float64, with Vinv exactly symmetric: the twin symmetrizes the
    # coupling, the kernel sums A_a M_b^T as it stands.
    d64 = lambda x: x.to(torch.float64)
    lin64 = lin._replace(**{f: d64(getattr(lin, f)) for f in ("Jc", "Jk", "Jp", "U", "Uk")})
    op64 = op._replace(Vinv=0.5 * (d64(op.Vinv) + d64(op.Vinv).mT),
                       lam_diag_c=d64(op.lam_diag_c), lam_diag_k=d64(op.lam_diag_k))
    got = walk_schur(lin64, op64, perm, pvm)
    want = tschur.schur_matrix_plain(lin64, op64, perm, pvm)
    assert got.shape == (B * lin.U.shape[0] + 4,) * 2
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def jax_dense_S(ref, op_j, perm, pvm):
    """The reduced system as the JAX package's dense_schur_direct assembles it
    (sfm_tpu/ba/schur.py:360-418), before its solve."""
    C, B = op_j.lam_diag_c.shape
    dt = op_j.Jc.dtype
    import jax

    onehot_cam = jax.nn.one_hot(op_j.obs_cam, C, dtype=dt)
    M = jnp.einsum("oci,ocj->oij", op_j.Jc, op_j.Jp)
    A = jnp.einsum("oij,ojk->oik", M, op_j.Vinv[op_j.obs_point])
    pv = jnp.asarray(pvm).astype(dt)[..., None, None]
    Mg, Ag = M[perm] * pv, A[perm] * pv
    onehot_pv = jax.nn.one_hot(op_j.obs_cam[perm], C, dtype=dt) * pv[..., 0]
    Z1 = jnp.einsum("pvc,pvik->pkci", onehot_pv, Mg)
    Z2 = jnp.einsum("pvc,pvik->pkci", onehot_pv, Ag)
    n3p = Z1.shape[0] * 3
    coupling = jnp.einsum("xu,xv->uv", Z2.reshape(n3p, C * B), Z1.reshape(n3p, C * B),
                          precision=jax.lax.Precision.HIGHEST).reshape(C, B, C, B)
    coupling = 0.5 * (coupling + coupling.transpose(2, 3, 0, 1))
    Ud = ref.U + op_j.lam_diag_c[..., None] * jnp.eye(B, dtype=dt)
    ar = jnp.arange(C)
    S_cc = (-coupling).at[ar, :, ar, :].add(Ud).reshape(C * B, C * B)
    P = op_j.Vinv.shape[0]
    Wk = _seg_sum_pt(jnp.einsum("oci,ocj->oij", op_j.Jk, op_j.Jp), op_j.obs_point, P)
    AkT = jnp.einsum("pij,pkj->pik", op_j.Vinv, Wk)
    cross = _cam_reduce(onehot_cam, jnp.einsum("oci,ocj->oij", op_j.Jc, op_j.Jk).reshape(
        -1, B * 4)).reshape(C, B, 4)
    coup_ck = _cam_reduce(onehot_cam, jnp.einsum("oik,okj->oij", M, AkT[op_j.obs_point]).reshape(
        -1, B * 4)).reshape(C, B, 4)
    S_ck = (cross - coup_ck).reshape(C * B, 4)
    S_kk = ref.Uk + jnp.diag(op_j.lam_diag_k) - jnp.einsum("pik,pkj->ij", Wk, AkT)
    n_ = C * B + 4
    S = jnp.zeros((n_, n_), dt)
    S = S.at[: C * B, : C * B].set(S_cc)
    S = S.at[: C * B, C * B:].set(S_ck)
    S = S.at[C * B:, : C * B].set(S_ck.T)
    return S.at[C * B:, C * B:].set(S_kk)


def test_schur_matrix_plain_matches_the_reference_assembly(rng):
    # The port's linearization of test_torch_ba.py's problem, assembled by
    # the twin and by the reference's own code on the same arrays.
    prob = perturbed_problem(rng, n_cams=7, n_pts=90)
    Hreg, greg = np.eye(4, dtype=np.float32) * 0.01, np.arange(4, dtype=np.float32) * 0.1
    got, perm, pvm = port_linearization(prob, problem_from_numpy(prob, device="cpu"),
                                        Hreg, greg)
    op, _, _ = tschur.damp_operator(got, 1e-3, t(perm), t(pvm))
    S = tschur.schur_matrix_plain(got, op, t(perm), t(pvm))
    j = lambda x: jnp.asarray(n(x))
    op_j = SimpleNamespace(Jc=j(got.Jc), Jk=j(got.Jk), Jp=j(got.Jp), obs_cam=j(got.obs_cam),
                           obs_point=j(got.obs_point), Vinv=j(op.Vinv),
                           lam_diag_c=j(op.lam_diag_c), lam_diag_k=j(op.lam_diag_k))
    S_j = jax_dense_S(SimpleNamespace(U=j(got.U), Uk=j(got.Uk)), op_j, jnp.asarray(perm), pvm)
    rel_close(S, S_j, 1e-5)
    # The walk through the layout agrees with both.
    rel_close(walk_schur(got, op, t(perm), t(pvm)), S_j, 1e-5)


@pytest.mark.parametrize("B,dtype", ROUTES, ids=ROUTE_IDS)
def test_coupling_workspace_is_reused_and_passed_to_the_kernel(monkeypatch, B, dtype):
    # The LM loop builds the coupling's layout and scratch once (its S_kk
    # sums and control words zero) and every call passes those very
    # tensors; without one the wrapper builds its own. The kernel writes S
    # whole, so the wrapper allocates it and writes nothing into it.
    obs_cam, obs_point, perm, pvm = random_grouping(5, 4, 30, 150)
    C, P, O = 4, 30, 150
    z = lambda *s, dtype=dtype: torch.zeros(s, dtype=dtype)
    lin = tschur.Linearization(
        Jc=z(O, 2, B), Jk=z(O, 2, 4), Jp=z(O, 2, 3), rw=z(O, 2), obs_cam=t(obs_cam),
        obs_point=t(obs_point), V=z(P, 3, 3), U=z(C, B, B), Uk=z(4, 4), g_c=z(C, B),
        g_k=z(4), g_p=z(P, 3), point_valid=torch.ones(P, dtype=torch.bool), Hreg_k=z(4, 4))
    op = tschur.Damped(Vinv=z(P, 3, 3), lam_diag_c=z(C, B), lam_diag_k=z(4))
    work = tschur.coupling_workspace(lin, t(perm), t(pvm))
    words = 2 if dtype == torch.float64 else 1
    Ni = work.items.shape[0]
    Ov = int(np.cumprod(pvm, axis=1).sum())
    assert work.terms.shape == (12 * B * Ov,) and work.terms.dtype == dtype
    assert work.row_slot.shape == (perm.shape[0],) and work.er.shape == (B * C + 4,)
    assert work.kk.shape == (16 * words,) and not work.kk.any()
    assert work.ctrl.shape == (2,) and not work.ctrl.any()
    calls = []
    monkeypatch.setattr(_kernels, "launch", lambda name, dev, *a: calls.append((name, a)))
    for _ in range(2):
        S = tschur.schur_matrix_cuda(lin, op, t(perm), t(pvm), work)
        assert S.shape == (B * C + 4,) * 2 and S.dtype == dtype
    tschur.schur_matrix_cuda(lin, op, t(perm), t(pvm))
    assert [c[0] for c in calls] == ["schur_coupling" + tschur.variant(B, dtype)] * 3
    # (Jc, Jk, Jp, obs_point, Vinv, perm, perm_valid, U, lam_diag_c, Uk,
    # lam_diag_k, pairs, items, cam_slots, row_slot, C, G, Vs, Ni, Ov, S,
    # terms, kk, ctrl, er)
    a = calls[0][1]
    assert a[3] is lin.obs_point and a[4] is op.Vinv and a[9] is lin.Uk
    assert a[10] is op.lam_diag_k
    assert a[15:20] == (C, perm.shape[0], perm.shape[1], Ni, Ov)
    for name, x in calls[:2]:
        assert all(y is w for y, w in zip(x[11:15], work[:4]))
        assert all(y is w for y, w in zip(x[21:], work[4:]))
    assert calls[2][1][11] is not work.pairs and torch.equal(calls[2][1][11], work.pairs)
    with pytest.raises(ValueError, match="shape"):
        tschur.schur_matrix_cuda(lin, op, t(perm), t(pvm),
                                 work._replace(kk=torch.zeros(3, dtype=torch.int64)))


def test_run_ba_builds_the_coupling_workspace_once(monkeypatch, rng):
    # One layout a BA problem on the dense route, whatever the LM iterations.
    from sfm_tpu_torch.ba import lm as tlm
    from sfm_tpu_torch.config import BAConfig as PortBAConfig

    prob = perturbed_problem(rng)
    built = []
    real = tschur.coupling_workspace
    monkeypatch.setattr(tlm, "coupling_workspace", lambda *a: built.append(1) or real(*a))
    seen = []
    monkeypatch.setattr(tlm, "dense_schur_direct",
                        lambda *a: seen.append(a[-1]) or tschur.dense_schur_direct(*a))
    tlm.run_ba(problem_from_numpy(prob, device="cpu"), PortBAConfig(max_iterations=3))
    # On CPU tensors the twin needs no layout: none is built, None is passed.
    assert built == [] and seen and all(w is None for w in seen)
