"""K10's dense BA solve: the plain twin of ``csrc/schur_cholesky.cu``
(``ba/schur.py::dense_solve_plain``) against the JAX package's
``cho_solve(cho_factor(S + _EPS I), rhs)`` (``sfm_tpu/ba/schur.py:420-423``).

The twin is the kernel's algorithm in plain PyTorch: a left-looking Cholesky
over panels of 32 columns (a panel's sums: the products over the panels
before the last, then the last panel's terms), the right-hand side riding
along as one more row, a left-looking back-substitution, the factor and the
back-substitution in float64 for both dtypes and the solution rounded once
to S's dtype. Inputs are made with numpy from a seed.

Tolerances: the twin and JAX round differently, so both are held to a float64
numpy solve of the same matrix, and the twin's error may be at most twice
JAX's own plus a floor (1e-6 in float32, 1e-13 in float64: the error of an
exact solve rounded to the dtype, times the condition number ~1e3, is of
that order). On BA systems (B = 6 and 10, float32 and float64) the port's
``dense_schur_direct`` and the reference's are held the same way to a
float64 solve of the symmetric part of S. The wrapper's launch is recorded
by a monkeypatched ``_kernels.launch``; the kernel itself runs on the card
(``chip_smoke.py``'s ``phase_dense_solve``).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pcg import jax_system, pinned_problem, rel_err
from test_torch_percam import jax_percam_system
from torch_parity import n, t

from sfm_tpu.ba.schur import dense_schur_direct as j_dense
from sfm_tpu_torch import _kernels
from sfm_tpu_torch.ba import schur as tschur

PORT = Path(__file__).resolve().parents[1] / "sfm_tpu_torch"
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
FLOOR = {"f32": 1e-6, "f64": 1e-13}


def spd(rng, size, dtype, cond=1e3):
    """A symmetric positive definite matrix with eigenvalues 1 .. cond (a
    damped reduced camera system's condition number)."""
    Q, _ = np.linalg.qr(rng.standard_normal((size, size)))
    A = (Q * np.logspace(0, np.log10(cond), size)) @ Q.T
    return ((A + A.T) / 2).astype(dtype)


def split(rhs, B=6):
    """rhs as (C, B) and (4,); one column a camera where n - 4 is no multiple
    of B (the twin reads the entries in order, whatever B)."""
    head = rhs[:-4]
    if len(head) % B:
        B = 1
    return head.reshape(-1, B), rhs[-4:]


def twin_solve(S, rhs, dt):
    rc, rk = split(rhs)
    xc, xk = tschur.dense_solve_plain(torch.from_numpy(S).to(dt), torch.from_numpy(rc).to(dt),
                                      torch.from_numpy(rk).to(dt))
    return np.concatenate([n(xc).reshape(-1), n(xk)])


def jax_solve(S, rhs, np_dt):
    with jax.enable_x64(np_dt == np.float64):
        Sj = jnp.asarray(S) + jnp.asarray(tschur._EPS, np_dt) * jnp.eye(len(S), dtype=np_dt)
        x = jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(Sj), jnp.asarray(rhs))
        return np.asarray(x)


def truth(S, rhs, np_dt):
    """The float64 solve of the matrix both solvers see (_EPS added in the dtype)."""
    Se = S.copy()
    Se[np.diag_indices(len(S))] += np_dt(tschur._EPS)
    return np.linalg.solve(Se.astype(np.float64), rhs.astype(np.float64))


def rel(x, ref):
    return float(np.abs(x.astype(np.float64) - ref).max() / np.abs(ref).max())


# Both sides of the kernel's boundaries: a sub-panel of the tile's
# factorization (8 columns), a panel (32), the first panel whose sums take
# the products of an earlier one (65: panel 2), the first whose products
# fill a 64-column row block of slices (97), a staged chunk of products
# (160 columns: the panels at 161 and 193), and 6 x 100 + 4.
@pytest.mark.parametrize("size", [4, 7, 8, 9, 31, 32, 33, 63, 64, 65, 97, 128, 129, 161, 193,
                                  604])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_twin_matches_the_reference_solve(size, dt):
    np_dt, torch_dt = DTYPES[dt]
    rng = np.random.default_rng(size)
    S = spd(rng, size, np_dt)
    rhs = rng.standard_normal(size).astype(np_dt)
    ref = truth(S, rhs, np_dt)
    x_twin, x_jax = twin_solve(S, rhs, torch_dt), jax_solve(S, rhs, np_dt)
    assert x_twin.dtype == np_dt
    assert rel(x_twin, ref) <= 2 * rel(x_jax, ref) + FLOOR[dt]


@pytest.mark.parametrize("size", [100, 300])
def test_float_twin_hardly_depends_on_the_panel_width(monkeypatch, size):
    # In the float32 route the factor is float64 and only the solution is
    # rounded to float32, so panels of 8 and of 32 give every entry of the
    # solution within one of its ulps (the float64 sums differ in their last
    # bits only).
    rng = np.random.default_rng(7)
    S, rhs = spd(rng, size, np.float32), rng.standard_normal(size).astype(np.float32)
    x32 = twin_solve(S, rhs, torch.float32)
    monkeypatch.setattr(tschur, "_PANEL", 8)
    x8 = twin_solve(S, rhs, torch.float32)
    assert (np.abs(x8 - x32) <= np.spacing(np.abs(x32))).all()


@pytest.mark.parametrize("case", ["negative_last_pivot", "nan_entry", "negative_first_pivot",
                                  "negative_pivot_at_a_sub_panel"])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_failure_gives_an_all_nan_step(case, dt):
    np_dt, torch_dt = DTYPES[dt]
    rng = np.random.default_rng(3)
    S = spd(rng, 100, np_dt)
    if case == "negative_last_pivot":   # the last panel is columns 96-99
        S[97, 97] = -5.0
    elif case == "nan_entry":           # a NaN below the diagonal, early on
        S[50, 3] = S[3, 50] = np.nan
    elif case == "negative_first_pivot":
        S[0, 0] = -1.0
    else:                               # the first column of panel 1's second sub-panel
        S[40, 40] = -5.0
    x = twin_solve(S, rng.standard_normal(100).astype(np_dt), torch_dt)
    assert np.isnan(x).all()
    # The same matrix without the fault solves.
    assert np.isfinite(twin_solve(spd(np.random.default_rng(3), 100, np_dt),
                                  np.ones(100, np_dt), torch_dt)).all()


def _as_f64(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def ba_systems(rng, B):
    """JAX's damped system at camera block B (6, or 10 with per-camera
    intrinsics) on a pinned problem, and the port's copy of the same arrays."""
    prob = pinned_problem(rng)
    if B == 6:
        (ref, op_j, rhs_cj, rhs_kj), (lin, op, rhs_c, rhs_k, perm, pvm) = jax_system(prob)
        return (ref, op_j, rhs_cj, rhs_kj), (lin, op, rhs_c, rhs_k, perm, pvm), prob
    C = prob.num_cameras
    intr_c = (np.asarray(prob.intr)[None] + rng.normal(0, [8.0, 8.0, 3.0, 3.0], (C, 4))).astype(
        np.float32)
    ref, (op_j, rhs_cj, rhs_kj, _), obs_valid = jax_percam_system(prob, intr_c)
    fields = {f: t(np.asarray(getattr(ref, f))) for f in tschur.Linearization._fields
              if f != "U_extra"}
    lin = tschur.Linearization(**fields, U_extra=t(np.asarray(ref.U_extra)).expand(C, 10, 10))
    perm, pvm = (t(a) for a in tschur.coobs_pairs(np.asarray(prob.obs_point),
                                                   n(obs_valid) > 0))
    op, rhs_c, rhs_k = tschur.damp_operator(lin, 1e-3, perm, pvm)
    return (ref, op_j, rhs_cj, rhs_kj), (lin, op, rhs_c, rhs_k, perm, pvm), prob


@pytest.mark.parametrize("B", [6, 10])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_dense_schur_direct_matches_jax_on_a_ba_system(rng, B, dt):
    (ref, op_j, _, _), (lin, op, rhs_c, rhs_k, perm, pvm), prob = ba_systems(rng, B)
    np_dt, torch_dt = DTYPES[dt]
    if dt == "f64":
        to64 = lambda x: None if x is None else x.double()
        lin = tschur.Linearization(*(to64(v) if isinstance(v, torch.Tensor)
                                     and v.is_floating_point() else v for v in lin))
        op = tschur.Damped(*(to64(v) for v in op))
        rhs_c, rhs_k = rhs_c.double(), rhs_k.double()
    xc, xk = tschur.dense_schur_direct(op, lin, rhs_c, rhs_k, perm, pvm)
    # JAX solves the same damped system: the port's damping and right-hand
    # side (float32, another summation order than JAX's own) in both.
    op_j = op_j._replace(Vinv=jnp.asarray(n(op.Vinv)), lam_diag_c=jnp.asarray(n(op.lam_diag_c)),
                         lam_diag_k=jnp.asarray(n(op.lam_diag_k)))
    with jax.enable_x64(dt == "f64"):
        args = (op_j, ref, jnp.asarray(n(rhs_c)), jnp.asarray(n(rhs_k)))
        if dt == "f64":
            args = _as_f64(args)
        xc_j, xk_j = j_dense(*args, jnp.asarray(n(perm)), jnp.asarray(n(pvm)))
        xc_j, xk_j = np.asarray(xc_j), np.asarray(xk_j)
    assert xc.dtype == torch_dt and xc_j.dtype == np_dt
    assert xc.shape == (prob.num_cameras, B) and xk.shape == (4,)
    # Both against a float64 solve of the symmetric part of the port's S:
    # the twin reads S's lower triangle, JAX's cho_factor its upper one,
    # and with S's condition number (up to ~1e8 here: the gauge of a fixed
    # camera) their last bits of asymmetry alone move the step far past
    # float64's precision.
    S = tschur.schur_matrix_plain(lin, op, perm, pvm).double().numpy()
    S = (S + S.T) / 2 + np.eye(len(S)) * tschur._EPS
    ref_x = np.linalg.solve(S, np.concatenate([n(rhs_c).reshape(-1), n(rhs_k)]).astype(
        np.float64))
    step = np.concatenate([n(xc).reshape(-1), n(xk)])
    step_j = np.concatenate([xc_j.reshape(-1), xk_j])
    assert np.isfinite(step).all()
    assert rel(step, ref_x) <= 2 * rel(step_j, ref_x) + FLOOR[dt]


def launch_of(monkeypatch, S, rhs_c, rhs_k, scratch=None):
    """The wrapper's one launch, recorded by a monkeypatched _kernels.launch
    on CPU tensors: (name, dev, S, rhs_c, rhs_k, n, B C, eps, x, factor, y,
    the next panel's partial sums, x as the back-substitution hands it
    between blocks), and the wrapper's (xc, xk)."""
    seen = []
    monkeypatch.setattr(_kernels, "launch", lambda *a: seen.append(a))
    out = tschur.dense_solve_cuda(S, rhs_c, rhs_k, scratch)
    (args,) = seen
    return args, out


def ends(*tensors):
    return sorted((a.data_ptr(), a.data_ptr() + a.numel() * a.itemsize) for a in tensors)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_wrapper_launches_one_entry_a_dtype(monkeypatch, dt):
    # On a CUDA tensor the wrapper launches schur_cholesky_solve(_f64) once
    # with S, rhs_c and rhs_k where they lie, n, B C, _EPS, a fresh x, the
    # float64 factor and y (S and x themselves in float64, where the factor
    # overwrites S; views of the float64 workspace in float32), the next
    # panel's partial sums (two steps x eight column slices x (n + 1) rows x
    # 32) and x as the back-substitution hands it between blocks (n entries,
    # an even count reserved); nothing is concatenated around it, and every
    # part starts 16 bytes aligned (the kernel stages rows with 16-byte
    # copies).
    _, torch_dt = DTYPES[dt]
    C, B = 5, 10
    n = B * C + 4
    S = torch.eye(n, dtype=torch_dt)
    rhs_c, rhs_k = torch.ones((C, B), dtype=torch_dt), torch.ones(4, dtype=torch_dt)
    args, (xc, xk) = launch_of(monkeypatch, S, rhs_c, rhs_k)
    (name, dev, S_, rc_, rk_, size, bc, eps, x, factor, y, part, xs) = args
    assert name == "schur_cholesky_solve" + ("_f64" if dt == "f64" else "")
    assert S_ is S and rc_ is rhs_c and rk_ is rhs_k and dev == S.device
    assert (size, bc, eps) == (n, B * C, tschur._EPS)
    assert x.shape == (n,) and x.dtype == torch_dt
    assert [a.numel() for a in (part, xs)] == [2 * 8 * (n + 1) * 32, n]
    assert all(a.dtype == torch.float64 for a in (part, xs))
    if dt == "f64":
        assert factor is S and y is x
        scratch = (part, xs)
    else:
        assert factor.dtype == torch.float64 and factor.numel() == n * n
        assert y.dtype == torch.float64 and y.numel() == n
        scratch = (part, xs, factor, y)
    assert all(a.data_ptr() % 16 == 0 for a in scratch)
    spans = ends(*scratch)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))   # disjoint
    reserved = 8 * (n % 2) if dt == "f64" else 0   # xs's even count, when it ends the span
    assert spans[-1][1] - spans[0][0] + reserved == 8 * tschur.dense_scratch_numel(n, torch_dt)
    assert xc.shape == (C, B) and xk.shape == (4,)
    assert xc.data_ptr() == x.data_ptr() and xk.data_ptr() == x.data_ptr() + B * C * x.itemsize
    with pytest.raises(ValueError):   # S of the wrong size
        tschur.dense_solve_cuda(torch.eye(7, dtype=torch_dt), rhs_c, rhs_k)
    with pytest.raises(ValueError):   # S off the 16-byte alignment its rows are read at
        tschur.dense_solve_cuda(torch.zeros(n * n + 1, dtype=torch_dt)[1:].view(n, n), rhs_c,
                                rhs_k)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_wrapper_takes_the_given_workspace(monkeypatch, dt):
    # A workspace handed in (the LM loop's CouplingWork.dense) is used as it
    # is, from its first entry; one too small, or not float64, is refused.
    _, torch_dt = DTYPES[dt]
    C, B = 3, 6
    n = B * C + 4
    need = tschur.dense_scratch_numel(n, torch_dt)
    work = torch.empty(need + 5, dtype=torch.float64)
    rhs_c, rhs_k = torch.ones((C, B), dtype=torch_dt), torch.ones(4, dtype=torch_dt)
    args, _ = launch_of(monkeypatch, torch.eye(n, dtype=torch_dt), rhs_c, rhs_k, work)
    scratch = args[11:] if dt == "f64" else args[9:]
    assert min(a.data_ptr() for a in scratch) == work.data_ptr()
    assert max(a.data_ptr() + a.numel() * 8 for a in scratch) == work.data_ptr() + 8 * need
    for bad in (torch.empty(need - 1, dtype=torch.float64), torch.empty(need)):
        with pytest.raises(ValueError):
            tschur.dense_solve_cuda(torch.eye(n, dtype=torch_dt), rhs_c, rhs_k, bad)


@pytest.mark.parametrize("C,B", [(256, 10), (400, 10), (600, 6), (900, 6)])
def test_wrapper_sizes_the_row_groups_past_the_old_cap(monkeypatch, C, B):
    # The dense route takes any n (ba.use_dense_schur_below is the user's):
    # past 32 rows a block (n >= 4,224 on 132 SMs) the kernel runs several
    # row groups a block, each group's sums in the partial sums and its
    # entries in L, so nothing in the workspace depends on the grid: the
    # wrapper sizes the partial sums by n + 1 rows and the handed-over x by
    # n, at every n.
    n = B * C + 4
    S = torch.empty((n, n), dtype=torch.float32)
    rhs_c, rhs_k = torch.ones((C, B)), torch.ones(4)
    args, _ = launch_of(monkeypatch, S, rhs_c, rhs_k)
    part, xs = args[11:]
    assert args[5] == n
    assert part.numel() == 2 * 8 * (n + 1) * 32 and xs.numel() == n


@pytest.mark.parametrize("B,dtype", [(6, torch.float32), (10, torch.float64)])
def test_coupling_workspace_carries_the_dense_solve_workspace(monkeypatch, B, dtype):
    # The LM loop's CouplingWork holds the dense solve's float64 workspace
    # (one a BA problem, beside the coupling's), and dense_schur_direct
    # hands it to the solve.
    from test_torch_coupling import random_grouping

    C, P, O = 4, 30, 150
    obs_cam, obs_point, perm, pvm = random_grouping(5, 4, P, O)
    z = lambda *s: torch.zeros(s, dtype=dtype)
    lin = tschur.Linearization(
        Jc=z(O, 2, B), Jk=z(O, 2, 4), Jp=z(O, 2, 3), rw=z(O, 2), obs_cam=t(obs_cam),
        obs_point=t(obs_point), V=z(P, 3, 3), U=z(C, B, B), Uk=z(4, 4), g_c=z(C, B),
        g_k=z(4), g_p=z(P, 3), point_valid=torch.ones(P, dtype=torch.bool), Hreg_k=z(4, 4))
    op = tschur.Damped(Vinv=z(P, 3, 3), lam_diag_c=z(C, B), lam_diag_k=z(4))
    work = tschur.coupling_workspace(lin, t(perm), t(pvm))
    assert work.dense.dtype == torch.float64
    assert work.dense.numel() == tschur.dense_scratch_numel(B * C + 4, dtype)
    seen = []
    monkeypatch.setattr(tschur, "schur_matrix", lambda *a: torch.eye(B * C + 4, dtype=dtype))
    monkeypatch.setattr(tschur, "dense_solve", lambda *a: seen.append(a) or (None, None))
    tschur.dense_schur_direct(op, lin, z(C, B), z(4), t(perm), t(pvm), work)
    tschur.dense_schur_direct(op, lin, z(C, B), z(4), t(perm), t(pvm))
    assert seen[0][3] is work.dense and seen[1][3] is None


def test_no_library_cholesky_in_the_port():
    # The dense route factors with the port's own kernel (or its twin):
    # no torch.linalg.cholesky_ex and no torch.cholesky_solve anywhere in
    # the package (the kernel's own name, schur_cholesky_solve, aside).
    pat = re.compile(r"cholesky_ex|(?<!schur_)cholesky_solve")
    hits = [f"{p.relative_to(PORT)}:{i}" for p in sorted(PORT.rglob("*"))
            if p.suffix in (".py", ".cu", ".cuh")
            for i, line in enumerate(p.read_text().splitlines(), 1) if pat.search(line)]
    assert hits == []
