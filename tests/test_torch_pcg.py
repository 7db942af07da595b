"""The port's BA past ``ba.use_dense_schur_below`` cameras, and windowed local
BA, against the JAX package.

Twins of kernel K11 (the matrix-free S x and the block-Jacobi PCG) and of
K10's block-Jacobi inverses on the same linearization as
``sfm_tpu.ba.schur``, with unregistered (pinned) cameras and a fixed one;
``run_ba`` through PCG (``use_dense_schur_below=0``) against JAX's and the
port's dense path; the routing; and the engine: the port's ``reconstruct``
on the 8-view rendered corridor with every BA call on PCG, and with
``ba.local_window`` 2, each beside JAX's reconstruct stage on the same
``pair_table.pkl``, under the pixel-pipeline gates. Tolerances: S x 1e-4 and
the inverses 1e-4 of each tensor's largest entry (float32, another order);
10 fixed CG steps 1e-3 (rounding grows through the recursion); a converged
CG 1e-3 of the dense solve; LM final costs 1e-3 relative, as
``tests/test_torch_ba.py``.
"""
import dataclasses
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_reconstruction import make_multiview
from test_torch_ba import perturbed_problem
from test_torch_slice import N_IMAGES, RECON_CONFIG, assert_pixel_gates
from torch_parity import n, render_scene, t

from sfm_tpu.ba import run_ba as j_run_ba
from sfm_tpu.ba.residuals import huber_weights as j_huber_weights
from sfm_tpu.ba.residuals import residuals_and_jacobians as j_res_jac
from sfm_tpu.ba.schur import damp_operator as j_damp
from sfm_tpu.ba.schur import linearize_system as j_linearize_system
from sfm_tpu.ba.schur import pcg_solve as j_pcg
from sfm_tpu.ba.schur import schur_matvec as j_matvec
from sfm_tpu.config import (BAConfig, FeatureConfig, MatchConfig, PnPConfig, SfMConfig,
                            VerifyConfig)
from sfm_tpu.matching import all_pairs_sweep as j_sweep
from sfm_tpu_torch.ba import lm as tlm
from sfm_tpu_torch.ba import schur as tschur
from sfm_tpu_torch.ba.problem import problem_from_numpy
from sfm_tpu_torch.config import BAConfig as PortBAConfig
from sfm_tpu_torch.config import SfMConfig as PortConfig
from sfm_tpu_torch.matching.pair_table import PairTable as TPairTable
from sfm_tpu_torch.reconstruction import incremental as tinc

UNREGISTERED = (2, 5)


def rel_err(a, b):
    a, b = n(a), n(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def pinned_problem(rng, n_cams=8, n_pts=120):
    """A perturbed arc scene with two cameras unregistered (their entries
    pinned) and camera 0 fixed."""
    prob = perturbed_problem(rng, n_cams=n_cams, n_pts=n_pts)
    cam_valid = np.ones(n_cams, bool)
    cam_valid[list(UNREGISTERED)] = False
    return prob._replace(cam_valid=jnp.asarray(cam_valid))


def jax_system(prob, lam=1e-3):
    """JAX's linearization of ``prob`` (observations of unregistered cameras
    excluded, as ``run_ba`` does), damped at ``lam``; and the port's copy of
    the same arrays."""
    r, Jc, Jk, Jp = j_res_jac((prob.rvec, prob.tvec, prob.intr, prob.points,
                               prob.obs_cam, prob.obs_point, prob.obs_xy))
    w = j_huber_weights(r, 2.0)
    cam_free = (prob.cam_valid & ~prob.cam_fixed).astype(jnp.float32)
    obs_valid = (prob.obs_valid & prob.cam_valid[prob.obs_cam]
                 & prob.point_valid[prob.obs_point]).astype(jnp.float32)
    Hreg = jnp.eye(4, dtype=jnp.float32) * 0.01
    greg = jnp.arange(4, dtype=jnp.float32) * 0.1
    ref = j_linearize_system(Jc, Jk, Jp, r, w, prob.obs_cam, prob.obs_point, obs_valid,
                             cam_free, prob.point_valid, Hreg, prob.num_cameras,
                             prob.num_points, g_k_extra=greg)
    op_j, rhs_cj, rhs_kj, _ = j_damp(ref, jnp.float32(lam))
    lin = tschur.Linearization(**{f: t(np.asarray(getattr(ref, f)))
                                  for f in tschur.Linearization._fields})
    perm, pvm = (t(a) for a in tschur.coobs_pairs(np.asarray(prob.obs_point),
                                                   n(obs_valid) > 0))
    op, rhs_c, rhs_k = tschur.damp_operator(lin, lam, perm, pvm, precond=True)
    return (ref, op_j, rhs_cj, rhs_kj), (lin, op, rhs_c, rhs_k, perm, pvm)


# ---------------------------------------------------------------- K10 + K11 twins

def test_block_jacobi_matches_jax_and_pins_to_the_identity(rng):
    (_, op_j, *_), (lin, op, *_) = jax_system(pinned_problem(rng))
    assert rel_err(op.Mc, op_j.Mc) <= 1e-4
    assert rel_err(op.Mk, op_j.Mk) <= 1e-4
    # Unregistered and fixed cameras have U = 0 and the unit pin: M = I.
    for c in (0, *UNREGISTERED):
        np.testing.assert_allclose(n(op.Mc[c]), np.eye(6), atol=1e-6)
    # Without the PCG route the preconditioner is not computed.
    assert tschur.damp_operator(lin, 1e-3, None, None)[0].Mc is None


def test_schur_matvec_plain_matches_jax(rng):
    (_, op_j, *_), (lin, op, _, _, perm, pvm) = jax_system(pinned_problem(rng))
    xc = rng.normal(0, 1e-2, (8, 6)).astype(np.float32)
    xk = rng.normal(0, 1e-1, 4).astype(np.float32)
    Sc, Sk = tschur.schur_matvec(lin, op, t(xc), t(xk), perm, pvm)
    Sc_j, Sk_j = j_matvec(op_j, jnp.asarray(xc), jnp.asarray(xk))
    assert rel_err(Sc, Sc_j) <= 1e-4
    assert rel_err(Sk, Sk_j) <= 1e-4
    # The product agrees with the dense S of the K10 path on the same system.
    S = tschur.schur_matrix(lin, op, perm, pvm)
    dense = S @ torch.cat([t(xc).reshape(-1), t(xk)])
    assert rel_err(torch.cat([Sc.reshape(-1), Sk]), dense) <= 1e-4


def test_pcg_solve_plain_matches_jax(rng):
    (_, op_j, rhs_cj, rhs_kj), (lin, op, rhs_c, rhs_k, perm, pvm) = jax_system(
        pinned_problem(rng))
    # Ten fixed steps (no early exit).
    xc, xk, steps = tschur.pcg_solve(lin, op, rhs_c, rhs_k, perm, pvm, 10, 0.0)
    xc_j, xk_j = j_pcg(op_j, rhs_cj, rhs_kj, 10, 0.0)
    assert int(steps) == 10
    assert rel_err(torch.cat([xc.reshape(-1), xk]),
                   np.concatenate([n(xc_j).reshape(-1), n(xk_j)])) <= 1e-3
    # Converged: both within 1e-3 of the dense solve of the same system.
    xd_c, xd_k = tschur.dense_schur_direct(op, lin, rhs_c, rhs_k, perm, pvm)
    dense = torch.cat([xd_c.reshape(-1), xd_k])
    xc, xk, steps = tschur.pcg_solve(lin, op, rhs_c, rhs_k, perm, pvm, 400, 1e-6)
    xc_j, xk_j = j_pcg(op_j, rhs_cj, rhs_kj, 400, 1e-6)
    assert rel_err(torch.cat([xc.reshape(-1), xk]), dense) <= 1e-3
    assert rel_err(np.concatenate([n(xc_j).reshape(-1), n(xk_j)]), dense) <= 1e-3
    assert 10 < int(steps) <= 400


def test_pcg_stops_before_a_step_once_the_residual_is_small(rng):
    # A zero right-hand side is converged before the first step; a tolerance
    # above 1 stops there too (|r| = |rhs|), as the reference's while_loop.
    _, (lin, op, rhs_c, rhs_k, perm, pvm) = jax_system(pinned_problem(rng))
    for rc, rk, tol in ((rhs_c * 0, rhs_k * 0, 1e-6), (rhs_c, rhs_k, 2.0)):
        xc, xk, steps = tschur.pcg_solve(lin, op, rc, rk, perm, pvm, 50, tol)
        assert int(steps) == 0
        assert float(xc.abs().max()) == 0.0 and float(xk.abs().max()) == 0.0


# --------------------------------------------------------------- LM and routing

@pytest.mark.parametrize("optimize_intrinsics", [False, True])
def test_run_ba_pcg_matches_jax_and_the_dense_path(rng, optimize_intrinsics):
    prob = pinned_problem(rng)
    if optimize_intrinsics:
        prob = prob._replace(intr=prob.intr + jnp.asarray([20.0, -10.0, 4.0, -3.0]))
    kw = dict(max_iterations=15, cg_iters=60)
    _, st_j = j_run_ba(prob, BAConfig(use_dense_schur_below=0, **kw),
                       optimize_intrinsics=optimize_intrinsics)
    tp = problem_from_numpy(prob, device="cpu")
    out, st = tlm.run_ba(tp, PortBAConfig(use_dense_schur_below=0, **kw),
                         optimize_intrinsics=optimize_intrinsics)
    _, st_d = tlm.run_ba(tp, PortBAConfig(**kw), optimize_intrinsics=optimize_intrinsics)
    assert st["solver"] == "pcg" and st_d["solver"] == "dense"
    assert st["cg_iterations"] > 0 and st_d["cg_iterations"] == 0
    assert st["final_cost"] < 0.5 * st["initial_cost"]
    np.testing.assert_allclose(st["initial_cost"], float(st_j["initial_cost"]), rtol=1e-5)
    np.testing.assert_allclose(st["final_cost"], float(st_j["final_cost"]), rtol=1e-3)
    np.testing.assert_allclose(st["final_cost"], st_d["final_cost"], rtol=1e-3)
    # Unregistered cameras never move.
    for c in UNREGISTERED:
        np.testing.assert_array_equal(n(out.rvec[c]), n(tp.rvec[c]))


def test_large_scenes_and_local_window_route_instead_of_raising():
    assert tlm.ba_route(PortBAConfig(), 300)["solver"] == "pcg"
    assert tlm.uses_pcg(PortBAConfig(), 300) and not tlm.uses_pcg(PortBAConfig(), 256)
    base = PortConfig()
    window = base.replace(ba=dataclasses.replace(base.ba, local_window=16))
    assert tlm.ba_route(window.ba, 300)["solver"] == "pcg"
    # Per-camera intrinsics and the f64 island route on PCG too.
    for field, key, value in (("per_camera_intrinsics", "cam_params", 10),
                              ("f64_normal_equations", "dtype", "float64")):
        route = tlm.ba_route(dataclasses.replace(PortBAConfig(), **{field: True}), 300)
        assert route["solver"] == "pcg" and route[key] == value


def test_k11_wrappers_refuse_other_devices():
    m = lambda *s: torch.empty(s, device="meta")
    lin = tschur.Linearization(*([None] * 7), U=m(2, 6, 6), Uk=m(4, 4), g_c=None, g_k=None,
                               g_p=None, point_valid=None)
    with pytest.raises(ValueError, match="device"):
        tschur.block_jacobi(m(2, 6, 6), m(2, 6), m(4, 4), m(4))
    with pytest.raises(ValueError, match="device"):
        tschur.schur_matvec(lin, None, m(2, 6), m(4), None, None)
    with pytest.raises(ValueError, match="device"):
        tschur.pcg_solve(lin, None, m(2, 6), m(4), None, None)


# ------------------------------------------------------------ windowed local BA

def test_windowed_ba_fixes_old_cameras():
    """The port of ``tests/test_config_knobs.py::TestLocalWindowBA``: a
    periodic BA leaves the cameras outside the window untouched, and the
    final BA stays global."""
    rng = np.random.default_rng(6)
    scene = make_multiview(rng, n_cams=6, n_pts=150, K_budget=128, D=32)
    cfg = SfMConfig(
        matching=MatchConfig(max_matches=128),
        verify=VerifyConfig(ransac_iters=256),
        pnp=PnPConfig(ransac_iters=256, candidate_batch=1),
        ba=BAConfig(max_iterations=6, cg_iters=20, optimize_intrinsics=False,
                    frequency=2, local_window=2),
    )
    jt = j_sweep(scene["xy"], scene["desc"], scene["valid"], cfg, chunk_size=4)
    table = TPairTable(**{f.name: np.array(getattr(jt, f.name))
                          for f in dataclasses.fields(TPairTable)})
    sfm = tinc.StructureFromMotion(table, scene["xy"], cfg, device="cpu")
    sfm.initialize()
    ranked = sfm.selector.find_next_best_images(sfm.reg_order, top_k=10)
    added = 0
    for img, _ in ranked:
        if sfm.register_image(int(img)):
            sfm._triangulate()
            added += 1
        if added == 2:
            break
    assert added == 2
    frozen = list(sfm.reg_order[:-2])
    before = {i: (sfm.rvec[i].copy(), sfm.tvec[i].copy()) for i in frozen}
    stats = sfm.bundle_adjust()
    assert stats is not None
    for i in frozen:
        np.testing.assert_array_equal(sfm.rvec[i], before[i][0])
        np.testing.assert_array_equal(sfm.tvec[i], before[i][1])
    moved_before = {i: sfm.rvec[i].copy() for i in frozen}
    sfm.bundle_adjust(final=True)
    assert any(not np.array_equal(sfm.rvec[i], moved_before[i]) for i in frozen)
    calls = [r for r in sfm.metrics.records if r["name"] == "ba/solve"]
    assert [r["local"] for r in calls] == [True, False]
    assert calls[0]["cameras"] <= 4 and calls[1]["cameras"] == 6


# ----------------------------------------------- the engine on the 8 rendered views

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return render_scene(tmp_path_factory.mktemp("pcg") / "scene", N_IMAGES)


@pytest.fixture(scope="module")
def pair_table(scene, tmp_path_factory):
    """The port's preprocess artifacts (``pair_table.pkl``) of the scene."""
    from sfm_tpu_torch import cli

    out = tmp_path_factory.mktemp("pcg_preprocess")
    SfMConfig(features=FeatureConfig(detect_batch=2)).to_json(out / "config.json")
    assert cli.main(["--log_dir", str(out / "logs"), "preprocess", "--data_dir", str(scene),
                     "--output_dir", str(out), "--device", "cpu", "--no_mask",
                     "--config", str(out / "config.json")]) == 0
    return out / "pair_table.pkl"


CASES = {"pcg": {"use_dense_schur_below": 4}, "local": {"local_window": 2}}


def case_config(case):
    """``RECON_CONFIG`` with the case's BA settings."""
    return RECON_CONFIG.replace(ba=dataclasses.replace(RECON_CONFIG.ba, **CASES[case]))


@pytest.fixture(scope="module")
def jax_results(scene, pair_table, tmp_path_factory):
    """JAX's reconstruct stage on the port's pair table, once per case."""
    from sfm_tpu.pipeline import PipelineArgs, SfMPipeline

    cache = {}

    def get(case):
        if case not in cache:
            d = tmp_path_factory.mktemp(f"jax_{case}")
            shutil.copy(pair_table, d / "pair_table.pkl")
            args = PipelineArgs(data_dir=str(scene), output_dir=str(d), use_mask=False,
                                num_images=N_IMAGES, export_colmap=False, export_meshlab=False)
            pipe = SfMPipeline(args, case_config(case))
            assert pipe.run_reconstruction()
            cache[case] = pipe.result
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_jax_reconstruct_case(jax_results, case):
    assert_pixel_gates(jax_results(case).stats)


def port_reconstruct(scene, pair_table, tmp_path, jax_result, case):
    """The port's reconstruct stage on the same pair table: the slice gates,
    JAX's seed pair and camera count, and every BA call's cost down and
    finite. Returns its ``ba/solve`` records."""
    from sfm_tpu_torch import cli

    shutil.copy(pair_table, tmp_path / "pair_table.pkl")
    case_config(case).replace(features=FeatureConfig(detect_batch=2)).to_json(
        tmp_path / "cfg.json")
    assert cli.main(["--log_dir", str(tmp_path / "logs"), "reconstruct", "--data_dir",
                     str(scene), "--output_dir", str(tmp_path), "--device", "cpu", "--no_mask",
                     "--num_images", str(N_IMAGES), "--config", str(tmp_path / "cfg.json")]) == 0
    s = json.loads((tmp_path / "reconstruction" / "stats.json").read_text())
    poses = json.loads((tmp_path / "reconstruction" / "poses.json").read_text())
    assert_pixel_gates(s)
    seed = [int(name.split(".")[0]) for name in list(poses)[:2]]
    assert seed == [int(i) for i in jax_result.image_ids[:2]]
    assert s["num_cameras"] == jax_result.stats["num_cameras"]
    calls = [r for r in json.loads((tmp_path / "metrics.json").read_text())
             if r["name"] == "ba/solve"]
    for r in calls:
        assert np.isfinite(r["final_cost"]) and r["final_cost"] <= r["initial_cost"]
    return calls


def test_port_reconstruct_with_every_ba_on_pcg(scene, pair_table, jax_results, tmp_path):
    calls = port_reconstruct(scene, pair_table, tmp_path, jax_results("pcg"), "pcg")
    assert calls and all(r["value"] == "pcg" and r["cg_iterations"] > 0 for r in calls)


def test_port_reconstruct_with_local_window(scene, pair_table, jax_results, tmp_path):
    calls = port_reconstruct(scene, pair_table, tmp_path, jax_results("local"), "local")
    assert [r["local"] for r in calls][-1] is False
    local = [r for r in calls if r["local"]]
    assert local and all(r["cameras"] < N_IMAGES for r in local)
