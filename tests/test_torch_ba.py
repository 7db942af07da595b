"""The port's bundle adjustment against the JAX package.

Twins of kernel K8+K9 (residuals + analytic-in-the-kernel Jacobians, Huber
whitening, reductions) and K10 (the dense Schur assembly), then the whole LM
loop through ``problem_from_numpy``. Same numpy-seeded scenes on both sides
(``tests/test_ba.py``'s generator). Tolerances: Jacobians 1e-4 of each
tensor's largest entry; the reductions and the Schur solution 1e-4 relative
(float32, another summation order); the LM result: final cost within 1e-3
relative and rms within 0.01 px (the accept/reject sequence may differ once
the cost stops moving).
"""
import numpy as np
import pytest
import torch

from torch_parity import n, t
from test_ba import make_scene, problem_from_scene

import jax.numpy as jnp

from sfm_tpu.ba import run_ba as j_run_ba
from sfm_tpu.ba.residuals import huber_cost as j_huber_cost
from sfm_tpu.ba.residuals import huber_weights as j_huber_weights
from sfm_tpu.ba.residuals import residuals_and_jacobians as j_res_jac
from sfm_tpu.ba.schur import coobs_pairs as j_coobs_pairs
from sfm_tpu.ba.schur import damp_operator as j_damp
from sfm_tpu.ba.schur import dense_schur_direct as j_dense
from sfm_tpu.ba.schur import linearize_system as j_linearize_system
from sfm_tpu.config import BAConfig
from sfm_tpu_torch.ba import lm as tlm
from sfm_tpu_torch.ba import residuals as tres
from sfm_tpu_torch.ba import schur as tschur
from sfm_tpu_torch.ba.problem import problem_from_numpy
from sfm_tpu_torch.config import BAConfig as PortBAConfig

CFG = dict(max_iterations=25, cg_iters=60)


def rel_close(a, b, rtol):
    a, b = n(a), n(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    assert float(np.abs(a - b).max()) <= rtol * scale, (float(np.abs(a - b).max()), scale)


def perturbed_problem(rng, n_cams=6, n_pts=120, noise_px=0.5):
    s = make_scene(rng, n_cams=n_cams, n_pts=n_pts, noise_px=noise_px)
    rvec = s["rvec"] + rng.normal(scale=0.01, size=s["rvec"].shape).astype(np.float32)
    tvec = s["tvec"] + rng.normal(scale=0.05, size=s["tvec"].shape).astype(np.float32)
    pts = s["points"] + rng.normal(scale=0.02, size=s["points"].shape).astype(np.float32)
    rvec[0], tvec[0] = 0.0, s["tvec"][0]       # the gauge camera at exactly rvec = 0
    return problem_from_scene(s, rvec=rvec, tvec=tvec, points=pts)


def jax_linearization(prob, optimize_intrinsics=True):
    r, Jc, Jk, Jp = j_res_jac((prob.rvec, prob.tvec, prob.intr, prob.points,
                               prob.obs_cam, prob.obs_point, prob.obs_xy))
    if not optimize_intrinsics:
        Jk = Jk * 0.0
    w = j_huber_weights(r, 2.0)
    cam_free = (prob.cam_valid & ~prob.cam_fixed).astype(jnp.float32)
    Hreg = jnp.eye(4, dtype=jnp.float32) * 0.01
    greg = jnp.arange(4, dtype=jnp.float32) * 0.1
    lin = j_linearize_system(Jc, Jk, Jp, r, w, prob.obs_cam, prob.obs_point,
                             prob.obs_valid.astype(jnp.float32), cam_free, prob.point_valid,
                             Hreg, prob.num_cameras, prob.num_points, g_k_extra=greg)
    return lin, Hreg, greg


def port_linearization(prob, tp, Hreg, greg, optimize_intrinsics=True):
    perm, pvm = tschur.coobs_pairs(np.asarray(prob.obs_point), np.asarray(prob.obs_valid))
    cam_free = (tp.cam_valid & ~tp.cam_fixed).to(torch.float32)
    lin = tschur.linearize(tp.rvec, tp.tvec, tp.intr, tp.points, tp.obs_cam, tp.obs_point,
                           tp.obs_xy, tp.obs_valid.to(torch.float32), cam_free,
                           tp.point_valid, t(perm), t(pvm), 2.0, optimize_intrinsics,
                           t(np.asarray(Hreg)), t(np.asarray(greg)))
    return lin, perm, pvm


def test_residuals_and_jacobians(rng):
    prob = perturbed_problem(rng)
    tp = problem_from_numpy(prob, device="cpu")
    got = tres.residuals_and_jacobians(tp.rvec, tp.tvec, tp.intr, tp.points, tp.obs_cam,
                                       tp.obs_point, tp.obs_xy)
    ref = j_res_jac((prob.rvec, prob.tvec, prob.intr, prob.points, prob.obs_cam,
                     prob.obs_point, prob.obs_xy))
    for g, r in zip(got, ref):
        assert np.isfinite(n(g)).all()
        rel_close(g, r, 1e-4)
    r_only = tres.residuals(tp.rvec, tp.tvec, tp.intr, tp.points, tp.obs_cam, tp.obs_point,
                            tp.obs_xy)
    rel_close(r_only, ref[0], 1e-4)


def test_huber_weights_and_cost(rng):
    r = (rng.normal(size=(500, 2)) * 3).astype(np.float32)
    valid = rng.random(500) > 0.2
    np.testing.assert_allclose(n(tres.huber_weights(t(r), 2.0)),
                               np.asarray(j_huber_weights(r, 2.0)), rtol=1e-6)
    np.testing.assert_allclose(float(tres.huber_cost(t(r), t(valid), 2.0)),
                               float(j_huber_cost(r, valid, 2.0)), rtol=1e-5)


def test_coobs_pairs_equal():
    rng = np.random.default_rng(0)
    obs_point = rng.integers(0, 300, 2000).astype(np.int32)
    obs_valid = rng.random(2000) > 0.1
    for a, b in zip(tschur.coobs_pairs(obs_point, obs_valid),
                    j_coobs_pairs(obs_point, obs_valid)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("optimize_intrinsics", [True, False])
def test_linearize_system_blocks(rng, optimize_intrinsics):
    prob = perturbed_problem(rng)
    ref, Hreg, greg = jax_linearization(prob, optimize_intrinsics)
    got, _, _ = port_linearization(prob, problem_from_numpy(prob, device="cpu"), Hreg, greg,
                                   optimize_intrinsics)
    for name in ("Jc", "Jk", "Jp", "rw", "V", "U", "Uk", "g_c", "g_k", "g_p"):
        rel_close(getattr(got, name), getattr(ref, name), 1e-4)


def test_dense_schur_direct_solution(rng):
    prob = perturbed_problem(rng, n_cams=7, n_pts=90)
    ref, Hreg, greg = jax_linearization(prob)
    op_j, rhs_cj, rhs_kj, _ = j_damp(ref, jnp.float32(1e-3))
    perm_j, pvm_j = j_coobs_pairs(np.asarray(prob.obs_point), np.asarray(prob.obs_valid))
    xc_j, xk_j = j_dense(op_j, ref, rhs_cj, rhs_kj, jnp.asarray(perm_j), jnp.asarray(pvm_j))

    got, perm, pvm = port_linearization(prob, problem_from_numpy(prob, device="cpu"),
                                        Hreg, greg)
    op, rhs_c, rhs_k = tschur.damp_operator(got, 1e-3, t(perm), t(pvm))
    rel_close(rhs_c, rhs_cj, 1e-4)
    rel_close(rhs_k, rhs_kj, 1e-4)
    rel_close(op.Vinv, op_j.Vinv, 1e-4)
    xc, xk = tschur.dense_schur_direct(op, got, rhs_c, rhs_k, t(perm), t(pvm))
    rel_close(xc, xc_j, 1e-4)
    rel_close(xk, xk_j, 1e-4)
    from sfm_tpu.ba.schur import back_substitute as j_back
    rel_close(tschur.back_substitute(got, op, xc, xk, t(perm), t(pvm)),
              j_back(op_j, ref.g_p, xc_j, xk_j), 1e-4)


@pytest.mark.parametrize("optimize_intrinsics", [False, True])
def test_run_ba_matches_reference(rng, optimize_intrinsics):
    prob = perturbed_problem(rng)
    if optimize_intrinsics:
        prob = prob._replace(intr=prob.intr + jnp.asarray([20.0, -10.0, 4.0, -3.0]))
    cfg = BAConfig(**CFG)
    out_j, st_j = j_run_ba(prob, cfg, optimize_intrinsics=optimize_intrinsics)
    out_t, st_t = tlm.run_ba(problem_from_numpy(prob, device="cpu"), PortBAConfig(**CFG),
                             optimize_intrinsics=optimize_intrinsics)
    assert st_t["final_cost"] < 0.5 * st_t["initial_cost"]
    np.testing.assert_allclose(st_t["initial_cost"], float(st_j["initial_cost"]), rtol=1e-5)
    np.testing.assert_allclose(st_t["final_cost"], float(st_j["final_cost"]), rtol=1e-3)
    assert abs(st_t["rms_px"] - float(st_j["rms_px"])) <= 0.01
    rel_close(out_t.points, out_j.points, 1e-3)


def test_routes_off_the_dense_path_raise():
    with pytest.raises(NotImplementedError, match="per_camera_intrinsics"):
        tlm.check_ba_config(PortBAConfig(per_camera_intrinsics=True), 10)
    with pytest.raises(NotImplementedError, match="f64"):
        tlm.check_ba_config(PortBAConfig(f64_normal_equations=True), 10)
    # More cameras than use_dense_schur_below run, on the PCG path.
    tlm.check_ba_config(PortBAConfig(), 257)
    assert tlm.uses_pcg(PortBAConfig(), 257)


def test_wrappers_refuse_other_devices():
    # K8+K9 and K10 run their twins on CPU tensors only; any other device
    # that is not CUDA is refused, never computed elsewhere.
    m = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="device"):
        tres.total_huber_cost(m(2, 3), m(2, 3), m(4), m(5, 3), m(6), m(6), m(6, 2), m(6), 2.0)
    with pytest.raises(ValueError, match="device"):
        tschur.linearize(m(2, 3), *([None] * 15))
    lin = tschur.Linearization(*([None] * 7), U=m(2, 6, 6), Uk=None, g_c=None, g_k=None,
                               g_p=None, point_valid=None)
    with pytest.raises(ValueError, match="device"):
        tschur.schur_matrix(lin, None, None, None)
