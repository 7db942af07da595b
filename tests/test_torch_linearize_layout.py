"""K8+K9's walk over the co-observation grouping (``linearize_layout``) and
its workspace, against a numpy walk and the JAX package.

The kernel (``csrc/ba_linearize.cu``) runs a block a chunk of one camera's
rows; here the layout and its chunk table are held against an independent
numpy enumeration, the plain linearization fed the layout's row order
against JAX's ``linearize_system`` (tolerance: 1e-4 of each tensor's largest
entry, float32 in another summation order, as ``test_torch_ba.py``), the
workspace's shapes and dtypes on each route, and ``run_ba`` with a workspace
passed through its linearizations against ``run_ba`` without one (identical:
the twin takes no workspace).
"""
import numpy as np
import pytest
import torch

from torch_parity import n, t
from test_torch_ba import jax_linearization, perturbed_problem, rel_close

from sfm_tpu_torch.ba import lm as tlm
from sfm_tpu_torch.ba import schur as tschur
from sfm_tpu_torch.ba.problem import problem_from_numpy
from sfm_tpu_torch.config import BAConfig as PortBAConfig

ROUTES = {"default": (6, torch.float32), "b10": (10, torch.float32),
          "f64": (6, torch.float64), "b10_f64": (10, torch.float64)}


def numpy_layout(obs_cam, obs_point, obs_valid, C, P, grid=tschur._LIN_GRID,
                 min_rows=tschur._LIN_MIN_ROWS):
    """The layout by a plain walk: the grouping's rows camera by camera (in
    the grouping's order), each camera's run cut into near-equal chunks."""
    perm, pvm = tschur.coobs_pairs(obs_point, obs_valid)
    walk = [int(perm[g, s]) for g in range(perm.shape[0]) for s in range(perm.shape[1])
            if pvm[g, : s + 1].all()]
    L = max(min_rows, -(-len(walk) // grid))
    rows, chunks = [], []
    for c in range(C):
        run = [o for o in walk if obs_cam[o] == c]
        k = max(1, -(-len(run) // L))
        start = len(rows)
        chunks += [[c, start + j * len(run) // k, start + (j + 1) * len(run) // k, k]
                   for j in range(k)]
        rows += run
    in_walk = set(walk)
    rest = [o for o in range(len(obs_cam)) if o not in in_walk]
    held = {int(obs_point[perm[g, 0]]) for g in range(perm.shape[0]) if pvm[g, 0]}
    orphans = [p for p in range(P) if p not in held]
    return perm, pvm, rows, chunks, rest, orphans


def layout_problem(case, seed=0):
    """(obs_cam, obs_point, obs_valid, C, P) with the case's feature: runs of
    ragged lengths (several chunks a camera), an empty camera, pinned
    (unregistered) cameras whose rows are outside the grouping, or every
    camera a single chunk."""
    rng = np.random.default_rng(seed)
    C, P = 9, 400
    sizes = {"ragged": [300, 129, 1, 257, 40, 128, 513, 7, 90],
             "empty_camera": [150, 0, 200, 60, 0, 75, 300, 12, 44],
             "pinned": [220, 180, 35, 400, 9, 140, 60, 260, 31],
             "single_chunk": [100, 20, 128, 3, 64, 1, 127, 50, 9]}[case]
    obs_cam = np.repeat(np.arange(C, dtype=np.int32), sizes)
    order = rng.permutation(len(obs_cam))            # rows not sorted by camera
    obs_cam = obs_cam[order]
    obs_point = rng.integers(0, P - 20, len(obs_cam)).astype(np.int32)   # 20+ orphans
    obs_valid = rng.random(len(obs_cam)) > 0.1
    if case == "pinned":
        obs_valid &= ~np.isin(obs_cam, [2, 5])
    return obs_cam, obs_point, obs_valid, C, P


@pytest.mark.parametrize("case", ["ragged", "empty_camera", "pinned", "single_chunk"])
def test_layout_matches_numpy_walk(case):
    obs_cam, obs_point, obs_valid, C, P = layout_problem(case)
    perm, pvm, rows, chunks, rest, orphans = numpy_layout(obs_cam, obs_point, obs_valid, C, P)
    got = tschur.linearize_layout(t(perm), t(pvm), t(obs_cam), t(obs_point),
                                  t(obs_valid.astype(np.float32)), C, P)
    for g, want, name in zip(got, (rows, chunks, rest, orphans),
                             ("rows", "chunks", "rest", "orphans")):
        assert g.dtype == torch.int32 and g.is_contiguous(), name
        np.testing.assert_array_equal(n(g).reshape(-1), np.asarray(want, np.int64).reshape(-1),
                                      err_msg=name)
    ch = n(got[1])
    # Every camera has a chunk; a chunk is one camera's; the runs tile rows.
    assert sorted(set(ch[:, 0])) == list(range(C))
    assert (obs_cam[n(got[0])] == np.repeat(ch[:, 0], ch[:, 2] - ch[:, 1])).all()
    assert ch[0, 1] == 0 and (ch[1:, 1] == ch[:-1, 2]).all() and ch[-1, 2] == len(rows)
    assert (np.bincount(ch[:, 0], minlength=C) == ch[np.unique(ch[:, 0], return_index=True)[1],
                                                      3]).all()
    if case == "single_chunk":
        assert len(ch) == C
    if case == "ragged":
        assert len(ch) > C


def test_layout_splits_to_fill_the_card():
    # More rows than _LIN_GRID chunks of _LIN_MIN_ROWS: the chunk length grows.
    rng = np.random.default_rng(1)
    C, P = 3, 5000
    obs_cam = np.repeat(np.arange(C, dtype=np.int32), [40000, 25000, 7000])
    obs_point = rng.integers(0, P, len(obs_cam)).astype(np.int32)
    obs_valid = np.ones(len(obs_cam), bool)
    perm, pvm, rows, chunks, rest, orphans = numpy_layout(obs_cam, obs_point, obs_valid, C, P)
    got = tschur.linearize_layout(t(perm), t(pvm), t(obs_cam), t(obs_point),
                                  torch.ones(len(obs_cam)), C, P)
    np.testing.assert_array_equal(n(got[1]), np.asarray(chunks))
    ch = n(got[1])
    L = -(-len(obs_cam) // tschur._LIN_GRID)
    assert L > tschur._LIN_MIN_ROWS and (ch[:, 2] - ch[:, 1]).max() <= L
    assert len(ch) >= tschur._LIN_GRID - C


def test_layout_refuses_live_rows_outside_the_grouping():
    obs_cam, obs_point, obs_valid, C, P = layout_problem("pinned")
    perm, pvm = tschur.coobs_pairs(obs_point, obs_valid)
    w = np.ones(len(obs_cam), np.float32)        # live where the grouping has no slot
    with pytest.raises(ValueError, match="outside the grouping"):
        tschur.linearize_layout(t(perm), t(pvm), t(obs_cam), t(obs_point), t(w), C, P)
    with pytest.raises(ValueError, match="camera outside"):
        tschur.linearize_layout(t(perm), t(pvm), t(obs_cam), t(obs_point),
                                t(obs_valid.astype(np.float32)), C - 1, P)


@pytest.mark.parametrize("optimize_intrinsics", [True, False])
def test_plain_linearize_in_layout_order_matches_jax(rng, optimize_intrinsics):
    # Rows permuted into the kernel's order (the layout's rows, then the rest)
    # give JAX's system once the row outputs are put back.
    prob = perturbed_problem(rng, n_cams=7, n_pts=150)
    valid = np.asarray(prob.obs_valid).copy()
    valid[::11] = False
    prob = prob._replace(obs_valid=valid)
    ref, Hreg, greg = jax_linearization(prob, optimize_intrinsics)
    tp = problem_from_numpy(prob, device="cpu")
    C, P = tp.num_cameras, tp.num_points
    perm, pvm = tschur.coobs_pairs(np.asarray(prob.obs_point), valid)
    w = tp.obs_valid.to(torch.float32)
    rows, chunks, rest, _ = tschur.linearize_layout(t(perm), t(pvm), tp.obs_cam, tp.obs_point,
                                                    w, C, P)
    order = torch.cat([rows, rest]).long()
    assert sorted(order.tolist()) == list(range(len(order)))
    pm = lambda x: x[order].contiguous()
    perm2, pvm2 = tschur.coobs_pairs(n(pm(tp.obs_point)), n(pm(tp.obs_valid)))
    cam_free = (tp.cam_valid & ~tp.cam_fixed).to(torch.float32)
    got = tschur.linearize(tp.rvec, tp.tvec, tp.intr, tp.points, pm(tp.obs_cam),
                           pm(tp.obs_point), pm(tp.obs_xy), pm(w), cam_free, tp.point_valid,
                           t(perm2), t(pvm2), 2.0, optimize_intrinsics, t(np.asarray(Hreg)),
                           t(np.asarray(greg)))
    back = torch.empty_like(order)
    back[order] = torch.arange(len(order))
    for name in ("Jc", "Jk", "Jp", "rw"):
        rel_close(getattr(got, name)[back], getattr(ref, name), 1e-4)
    for name in ("V", "U", "Uk", "g_c", "g_k", "g_p"):
        rel_close(getattr(got, name), getattr(ref, name), 1e-4)


@pytest.mark.parametrize("route", list(ROUTES))
def test_workspace_shapes_on_each_route(route):
    B, dtype = ROUTES[route]
    obs_cam, obs_point, obs_valid, C, P = layout_problem("empty_camera", seed=2)
    perm, pvm = tschur.coobs_pairs(obs_point, obs_valid)
    w = tschur.linearize_workspace(t(perm), t(pvm), t(obs_cam), t(obs_point),
                                   t(obs_valid.astype(np.float32)), C, P, B, dtype)
    words = 2 if dtype == torch.float64 else 1
    nfx = (B * (B + 1) // 2 + B) * C + 14
    Ov = int(pvm.sum())
    for name, x, dt, shape in (
            ("rows", w.rows, torch.int32, (Ov,)), ("rest", w.rest, torch.int32,
                                                   (len(obs_cam) - Ov,)),
            ("cmax", w.cmax, torch.int32, ((B + 1) * C + 5,)),
            ("acc", w.acc, torch.int64, (words * nfx,)),
            ("tickets", w.tickets, torch.int32, (C + 1,))):
        assert x.dtype == dt and tuple(x.shape) == shape and x.is_contiguous(), name
    assert w.chunks.dtype == torch.int32 and w.chunks.shape[1] == 4
    assert w.orphans.dtype == torch.int32
    # The scratch starts zero (the kernels leave it so); the chunk table is
    # read 16 bytes a chunk.
    assert not w.cmax.any() and not w.acc.any() and not w.tickets.any()
    assert w.chunks.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="no route"):
        tschur.linearize_workspace(t(perm), t(pvm), t(obs_cam), t(obs_point),
                                   t(obs_valid.astype(np.float32)), C, P, 8, dtype)


def test_workspace_for_no_cameras():
    w = tschur.linearize_workspace(torch.zeros((1, 8), dtype=torch.int32),
                                   torch.zeros((1, 8), dtype=torch.bool),
                                   torch.zeros(0, dtype=torch.int32),
                                   torch.zeros(0, dtype=torch.int32), torch.zeros(0), 0, 0, 6,
                                   torch.float32)
    assert w.chunks.tolist() == [[-1, 0, 0, 1]] and w.tickets.shape == (1,)


@pytest.mark.parametrize("flags", [{}, {"per_camera_intrinsics": True},
                                   {"f64_normal_equations": True}])
def test_run_ba_with_and_without_a_workspace(rng, monkeypatch, flags):
    # Every linearization of run_ba handed a workspace of its problem (as on
    # the card) gives the twin's result bit for bit, and the workspace's
    # layout accepts run_ba's grouping with rows outside it.
    prob = perturbed_problem(rng, n_cams=6, n_pts=100)
    valid = np.asarray(prob.obs_valid).copy()
    valid[::9] = False
    tp = problem_from_numpy(prob._replace(obs_valid=valid), device="cpu")
    cfg = PortBAConfig(max_iterations=6, **flags)
    out0, st0 = tlm.run_ba(tp, cfg)
    real, made = tlm.linearize, []

    def with_work(*a, dtype=torch.float32, work=None, **kw):
        assert work is None               # run_ba makes none on the CPU
        B = 10 if a[2].dim() == 2 else 6
        work = tschur.linearize_workspace(a[10], a[11], a[4], a[5], a[7], a[0].shape[0],
                                          a[3].shape[0], B, dtype)
        made.append(work)
        return real(*a, dtype=dtype, work=work, **kw)

    monkeypatch.setattr(tlm, "linearize", with_work)
    out1, st1 = tlm.run_ba(tp, cfg)
    assert made and all(len(w.rest) == int((~torch.as_tensor(valid)).sum()) for w in made)
    assert st0 == st1
    for f in ("rvec", "tvec", "intr", "points"):
        assert torch.equal(getattr(out0, f), getattr(out1, f)), f
