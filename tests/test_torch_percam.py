"""The port's per-camera intrinsics (a 10-parameter camera block) and its
f64 normal-equation island against the JAX package.

Twins of K8+K9's per-camera variant (``residuals_and_jacobians_percam``,
the linearization with the per-camera regularization ``U_extra`` /
``g_c_extra`` and the gauge pinning only the pose columns), of K10's damping
and K11's matvec and PCG at B = 10 with pinned cameras, held against
``sfm_tpu.ba``; ``run_ba`` in per-camera mode (the ports of
``tests/test_ba.py::TestPerCameraIntrinsics``) and with
``f64_normal_equations`` (JAX's ``run_ba`` enables x64 itself) against JAX's;
the port's own f64-versus-f32 test on an ill-conditioned 100-camera scene;
the 8-view rendered ``reconstruct`` with each flag through both packages on
one pair table; and the CUDA wrappers' refusals.

Tolerances: Jacobians, blocks and products 1e-4 of each tensor's largest
entry (float32, another order of the sums), 10 fixed CG steps 1e-3, LM final
costs 1e-3 relative (as ``tests/test_torch_ba.py``); the rest beside each
check.
"""
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_ba
from test_torch_pcg import UNREGISTERED, pinned_problem, rel_err
from test_torch_slice import N_IMAGES, RECON_CONFIG, assert_pixel_gates
from torch_parity import n, render_scene, t

from sfm_tpu.ba import run_ba as j_run_ba
from sfm_tpu.ba.lm import _intr_reg as j_intr_reg
from sfm_tpu.ba.problem import build_problem as j_build_problem
from sfm_tpu.ba.residuals import huber_weights as j_huber_weights
from sfm_tpu.ba.residuals import residuals_and_jacobians_percam as j_res_jac_percam
from sfm_tpu.ba.schur import damp_operator as j_damp
from sfm_tpu.ba.schur import linearize_system as j_linearize_system
from sfm_tpu.ba.schur import pcg_solve as j_pcg
from sfm_tpu.ba.schur import schur_matvec as j_matvec
from sfm_tpu.config import BAConfig, FeatureConfig, SfMConfig
from sfm_tpu.geometry import project, rotation_to_rvec
from sfm_tpu_torch.ba import lm as tlm
from sfm_tpu_torch.ba import schur as tschur
from sfm_tpu_torch.ba.problem import problem_from_numpy
from sfm_tpu_torch.ba.residuals import residuals_and_jacobians_percam
from sfm_tpu_torch.config import BAConfig as PortBAConfig

REG_W = 5.0   # large enough that U_extra matters


def percam_problem(rng):
    """``pinned_problem`` (camera 0 fixed, two cameras unregistered) with
    each camera's own intrinsics, a few px off the shared K."""
    prob = pinned_problem(rng)
    C = prob.num_cameras
    intr_c = np.asarray(prob.intr)[None] + rng.normal(0, [8.0, 8.0, 3.0, 3.0], (C, 4))
    return prob, intr_c.astype(np.float32)


def jax_percam_system(prob, intr_c, lam=1e-3):
    """JAX's per-camera linearization of ``prob`` as ``_run_ba_jit`` builds
    it (``sfm_tpu/ba/lm.py:139-198``), damped at ``lam``."""
    C = prob.num_cameras
    r, Jc, Jp = j_res_jac_percam((prob.rvec, prob.tvec, jnp.asarray(intr_c), prob.points,
                                  prob.obs_cam, prob.obs_point, prob.obs_xy))
    w = j_huber_weights(r, 2.0)
    cam_valid = prob.cam_valid.astype(jnp.float32)
    cam_free = (prob.cam_valid & ~prob.cam_fixed).astype(jnp.float32)
    obs_valid = (prob.obs_valid & prob.cam_valid[prob.obs_cam]
                 & prob.point_valid[prob.obs_point]).astype(jnp.float32)
    _, H, g = jax.vmap(lambda k: j_intr_reg(k, prob.intr, jnp.float32(REG_W)))(
        jnp.asarray(intr_c))
    U_extra = jnp.zeros((10, 10), jnp.float32).at[6:, 6:].set(H[0])[None]
    g_c_extra = jnp.concatenate([jnp.zeros((C, 6), jnp.float32), g * cam_valid[:, None]], -1)
    pose_free = cam_free[prob.obs_cam][:, None]
    colmask = jnp.concatenate([jnp.broadcast_to(pose_free, (len(r), 6)),
                               jnp.ones((len(r), 4), jnp.float32)], -1)
    lin = j_linearize_system(Jc * colmask[:, None, :], jnp.zeros((len(r), 2, 4)), Jp, r, w,
                             prob.obs_cam, prob.obs_point, obs_valid, cam_valid,
                             prob.point_valid, jnp.eye(4), C, prob.num_points,
                             g_k_extra=jnp.zeros(4), U_extra=U_extra, g_c_extra=g_c_extra)
    return lin, j_damp(lin, jnp.float32(lam)), obs_valid


def port_percam_linearization(prob, intr_c, obs_valid):
    """The port's ``linearize`` on the same problem, with the regularization
    ``run_ba`` gives it (masked to the valid cameras)."""
    _, U_extra, g_c_extra = tlm.percam_regularization(
        t(intr_c), t(np.asarray(prob.intr)), REG_W, t(np.asarray(prob.cam_valid)).float())
    perm, pvm = (t(a) for a in tschur.coobs_pairs(np.asarray(prob.obs_point),
                                                   n(obs_valid) > 0))
    cam_free = t(np.asarray(prob.cam_valid & ~prob.cam_fixed)).float()
    lin = tschur.linearize(t(np.asarray(prob.rvec)), t(np.asarray(prob.tvec)), t(intr_c),
                           t(np.asarray(prob.points)), t(np.asarray(prob.obs_cam)),
                           t(np.asarray(prob.obs_point)), t(np.asarray(prob.obs_xy)),
                           t(n(obs_valid)), cam_free, t(np.asarray(prob.point_valid)), perm, pvm,
                           2.0, True, torch.eye(4), torch.zeros(4), U_extra=U_extra,
                           g_c_extra=g_c_extra)
    return lin, perm, pvm


# ------------------------------------------------------------- K8+K9 per camera

def test_residuals_and_jacobians_percam_match_jax(rng):
    prob, intr_c = percam_problem(rng)
    args = (prob.rvec, prob.tvec, intr_c, prob.points, prob.obs_cam, prob.obs_point,
            prob.obs_xy)
    r_j, Jc_j, Jp_j = j_res_jac_percam(tuple(jnp.asarray(a) for a in args))
    r, Jc, Jp = residuals_and_jacobians_percam(*(t(np.asarray(a)) for a in args))
    assert Jc.shape == (prob.num_obs, 2, 10) and Jp.shape == (prob.num_obs, 2, 3)
    for a, b in ((r, r_j), (Jc, Jc_j), (Jp, Jp_j)):
        assert rel_err(a, b) <= 1e-4
    # The intrinsics columns are d(u, v) / d(fx, fy, cx, cy) at each camera's K.
    np.testing.assert_allclose(n(Jc[:, 0, 8]), 1.0)
    np.testing.assert_allclose(n(Jc[:, 1, 9]), 1.0)


def test_percam_linearize_matches_jax_and_pins_only_the_pose(rng):
    prob, intr_c = percam_problem(rng)
    lin_j, _, obs_valid = jax_percam_system(prob, intr_c)
    lin, _, _ = port_percam_linearization(prob, intr_c, obs_valid)
    valid = np.array(prob.cam_valid)
    for f in ("Jc", "Jp", "rw", "V", "g_p", "g_c"):
        assert rel_err(getattr(lin, f), getattr(lin_j, f)) <= 1e-4, f
    # U with U_extra; the port adds it to the valid cameras only (an
    # unregistered camera has no observations and a zero step either way).
    assert rel_err(lin.U[valid], np.asarray(lin_j.U)[valid]) <= 1e-4
    assert float(lin.U[~valid].abs().max()) == 0.0
    # The dead shared-k system: Jk = 0, Uk = I, g_k = 0.
    assert float(lin.Jk.abs().max()) == 0.0
    np.testing.assert_array_equal(n(lin.Uk), np.eye(4))
    assert float(lin.g_k.abs().max()) == 0.0
    # The fixed camera 0: pose columns zero, intrinsics columns free.
    rows = np.asarray(prob.obs_cam) == 0
    assert float(lin.Jc[rows][..., :6].abs().max()) == 0.0
    assert float(lin.Jc[rows][..., 6:].abs().max()) > 0.0
    assert float(lin.U[0, :6, :6].abs().max()) == 0.0
    assert float(torch.diagonal(lin.U[0, 6:, 6:]).min()) > 0.0


# ---------------------------------------------------- K10 + K11 at B = 10

def test_b10_damp_matvec_and_pcg_match_jax_with_pinned_cameras(rng):
    prob, intr_c = percam_problem(rng)
    lin_j, (op_j, rhs_cj, rhs_kj, _), obs_valid = jax_percam_system(prob, intr_c)
    C = prob.num_cameras
    fields = {f: t(np.asarray(getattr(lin_j, f))) for f in tschur.Linearization._fields
              if f != "U_extra"}
    # JAX's shared (1, 10, 10) block, as the port's per-camera (C, 10, 10).
    lin = tschur.Linearization(**fields, U_extra=t(np.asarray(lin_j.U_extra)).expand(C, 10, 10))
    perm, pvm = (t(a) for a in tschur.coobs_pairs(np.asarray(prob.obs_point),
                                                   n(obs_valid) > 0))
    op, rhs_c, rhs_k = tschur.damp_operator(lin, 1e-3, perm, pvm, precond=True)
    assert rel_err(rhs_c, rhs_cj) <= 1e-4 and rel_err(rhs_k, rhs_kj) <= 1e-4
    np.testing.assert_allclose(n(op.lam_diag_c), n(op_j.lam_diag_c), rtol=1e-6)
    assert rel_err(op.Mc, op_j.Mc) <= 1e-4
    # The per-entry pin: the fixed and unregistered cameras' pose rows get a
    # unit diagonal, their regularized intrinsics rows the damping alone.
    for c in (0, *UNREGISTERED):
        np.testing.assert_array_equal(n(op.lam_diag_c[c, :6]), 1.0)
        assert float(op.lam_diag_c[c, 6:].min()) < 1.0
    xc = rng.normal(0, 1e-2, (C, 10)).astype(np.float32)
    xk = rng.normal(0, 1e-1, 4).astype(np.float32)
    Sc, Sk = tschur.schur_matvec(lin, op, t(xc), t(xk), perm, pvm)
    Sc_j, Sk_j = j_matvec(op_j, jnp.asarray(xc), jnp.asarray(xk))
    assert rel_err(Sc, Sc_j) <= 1e-4 and rel_err(Sk, Sk_j) <= 1e-4
    # U_extra x_c is in the product (the term the reference's matvec once
    # dropped): without it the intrinsics rows change by exactly that.
    bare = tschur.schur_matvec(lin._replace(U_extra=None), op, t(xc), t(xk), perm, pvm)[0]
    ux = (lin.U_extra @ t(xc)[..., None])[..., 0]
    assert float(ux[:, 6:].abs().max()) > 1e-3
    assert rel_err(Sc - bare, ux) <= 1e-4
    # And the product agrees with the dense S of the K10 path.
    S = tschur.schur_matrix(lin, op, perm, pvm)
    assert rel_err(torch.cat([Sc.reshape(-1), Sk]),
                   S @ torch.cat([t(xc).reshape(-1), t(xk)])) <= 1e-4
    x_c, x_k, steps = tschur.pcg_solve(lin, op, rhs_c, rhs_k, perm, pvm, 10, 0.0)
    xj_c, xj_k = j_pcg(op_j, rhs_cj, rhs_kj, 10, 0.0)
    assert int(steps) == 10
    assert rel_err(torch.cat([x_c.reshape(-1), x_k]),
                   np.concatenate([n(xj_c).reshape(-1), n(xj_k)])) <= 1e-3
    for c in UNREGISTERED:
        assert float(x_c[c].abs().max()) == 0.0


# --------------------------------------------------------------- run_ba per camera

def two_focal_problem(rng):
    """``TestPerCameraIntrinsics.test_recovers_two_different_focals``'s
    scene: six arc cameras, fx = fy = 1,140 for three and 1,270 for three,
    noiseless, every camera starting from a shared fx = 1,200."""
    from scipy.spatial.transform import Rotation

    fx_true = np.array([1140.0] * 3 + [1270.0] * 3, np.float32)
    n_cams, n_pts = len(fx_true), 160
    pts = rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
    rvecs, tvecs, obs_cam, obs_point, obs_xy = [], [], [], [], []
    for c in range(n_cams):
        ang = (c - n_cams / 2) * 0.15
        R = Rotation.from_euler("y", ang).as_matrix().astype(np.float32)
        tc = -R @ np.array([6 * np.sin(ang), 0.3 * c, -6 * np.cos(ang)], np.float32)
        rvecs.append(np.asarray(rotation_to_rvec(R)))
        tvecs.append(tc)
        K = np.array([[fx_true[c], 0, 512], [0, fx_true[c], 384], [0, 0, 1]], np.float32)
        proj, depth = project(pts, R, tc, K)
        proj = np.asarray(proj)
        vis = ((np.asarray(depth) > 0) & (proj[:, 0] > 0) & (proj[:, 0] < 1024)
               & (proj[:, 1] > 0) & (proj[:, 1] < 768))
        for p in np.nonzero(vis)[0]:
            obs_cam.append(c)
            obs_point.append(p)
            obs_xy.append(proj[p])
    prob = j_build_problem(
        rvec=np.stack(rvecs), tvec=np.stack(tvecs), cam_valid=np.ones(n_cams, bool),
        intr=np.array([1200.0, 1200.0, 512.0, 384.0], np.float32), points=pts,
        point_valid=np.ones(n_pts, bool), obs_cam=np.array(obs_cam, np.int32),
        obs_point=np.array(obs_point, np.int32), obs_xy=np.array(obs_xy, np.float32),
        obs_valid=np.ones(len(obs_cam), bool))
    return prob, fx_true


def test_recovers_two_different_focals(rng):
    prob, fx_true = two_focal_problem(rng)
    # As the reference's test: the loop run out (ftol 0), the fx anchor off.
    kw = dict(per_camera_intrinsics=True, max_iterations=400, intrinsics_reg_weight=0.0,
              ftol=0.0)
    out, st = tlm.run_ba(problem_from_numpy(prob, device="cpu"), PortBAConfig(**kw))
    out_j, st_j = j_run_ba(prob, BAConfig(**kw), optimize_intrinsics=True)
    assert st["cam_params"] == 10 and st["solver"] == "dense"
    intr_c = n(out.intr_c)
    np.testing.assert_allclose(intr_c[:, 0], fx_true, rtol=0.01)
    np.testing.assert_allclose(intr_c[:, 1], fx_true, rtol=0.01)
    # The shared K refreshed to the valid cameras' mean.
    np.testing.assert_allclose(n(out.intr), intr_c.mean(0), rtol=1e-5)
    # Both packages end at the noise-free floor: final costs within 1e-6 of
    # the initial cost of each other, the focals within 1 px.
    np.testing.assert_allclose(st["initial_cost"], float(st_j["initial_cost"]), rtol=1e-5)
    assert abs(st["final_cost"] - float(st_j["final_cost"])) <= 1e-6 * st["initial_cost"]
    np.testing.assert_allclose(intr_c[:, :2], np.asarray(out_j.intr_c)[:, :2], atol=1.0)


def test_pcg_matches_dense_with_regularization(rng):
    """The port of the reference's regression test: with per-camera
    intrinsics the regularization lives in U as U_extra, which the PCG
    matvec must apply, or PCG solves another system than the dense path."""
    n_cams, n_pts = 5, 200
    pts = rng.uniform(-2, 2, (n_pts, 3)).astype(np.float32)
    pts[:, 2] += 8.0
    rvec = 0.01 * rng.normal(size=(n_cams, 3)).astype(np.float32)
    tvec = np.concatenate([rng.uniform(-1, 1, (n_cams, 2)), np.zeros((n_cams, 1))],
                          1).astype(np.float32)
    K = np.array([[900, 0, 256], [0, 900, 256], [0, 0, 1]], np.float32)
    from sfm_tpu.geometry import rodrigues

    obs_cam = np.repeat(np.arange(n_cams, dtype=np.int32), n_pts)
    obs_point = np.tile(np.arange(n_pts, dtype=np.int32), n_cams)
    xy = np.concatenate([np.asarray(project(pts, np.asarray(rodrigues(jnp.asarray(rvec[c]))),
                                            tvec[c], K)[0]) for c in range(n_cams)])
    obs_xy = xy + rng.normal(scale=0.4, size=xy.shape).astype(np.float32)
    prob = j_build_problem(
        rvec=rvec, tvec=tvec, cam_valid=np.ones(n_cams, bool),
        intr=np.array([900.0, 900.0, 256.0, 256.0], np.float32), points=pts,
        point_valid=np.ones(n_pts, bool), obs_cam=obs_cam, obs_point=obs_point,
        obs_xy=obs_xy, obs_valid=np.ones(len(obs_cam), bool))
    base = dict(per_camera_intrinsics=True, intrinsics_reg_weight=REG_W, max_iterations=8,
                cg_iters=200, cg_tol=1e-10, ftol=0.0)
    tp = problem_from_numpy(prob, device="cpu")
    _, s_pcg = tlm.run_ba(tp, PortBAConfig(use_dense_schur_below=0, **base))
    _, s_dense = tlm.run_ba(tp, PortBAConfig(use_dense_schur_below=64, **base))
    _, s_j = j_run_ba(prob, BAConfig(use_dense_schur_below=0, **base), optimize_intrinsics=True)
    assert s_pcg["solver"] == "pcg" and s_dense["solver"] == "dense"
    d, p = s_dense["final_cost"], s_pcg["final_cost"]
    assert abs(d - p) <= 1e-3 * max(abs(d), abs(p)), (d, p)
    np.testing.assert_allclose(p, float(s_j["final_cost"]), rtol=1e-3)


# ------------------------------------------------------------- the f64 island

@pytest.mark.parametrize("per_camera", [False, True])
def test_run_ba_f64_matches_jax(rng, per_camera):
    prob = pinned_problem(rng)
    prob = prob._replace(intr=prob.intr + jnp.asarray([20.0, -10.0, 4.0, -3.0]))
    kw = dict(max_iterations=15, f64_normal_equations=True, per_camera_intrinsics=per_camera)
    tp = problem_from_numpy(prob, device="cpu")
    out, st = tlm.run_ba(tp, PortBAConfig(**kw))
    _, st_p = tlm.run_ba(tp, PortBAConfig(use_dense_schur_below=0, cg_iters=60, **kw))
    _, st_j = j_run_ba(prob, BAConfig(**kw), optimize_intrinsics=True)
    assert st["dtype"] == "float64" and st["cam_params"] == (10 if per_camera else 6)
    assert out.rvec.dtype == torch.float32 and out.intr.dtype == torch.float32
    assert st["final_cost"] < 0.5 * st["initial_cost"]
    np.testing.assert_allclose(st["initial_cost"], float(st_j["initial_cost"]), rtol=1e-5)
    np.testing.assert_allclose(st["final_cost"], float(st_j["final_cost"]), rtol=1e-3)
    np.testing.assert_allclose(st_p["final_cost"], st["final_cost"], rtol=1e-3)


def test_f64_island_converges_past_the_f32_floor():
    """The port's own f64-versus-f32 test at 100 cameras, on
    ``TestF64NormalEquations``'s ill-conditioned scene (uncentered far
    cloud, 100k-px focal, noiseless: the floor is the arithmetic), with
    1,000 points of 100 observations a camera: on the CPU both packages'
    f32 runs stop at 1.5-3.3x the f64 cost there (at the reference's 6,000
    points of 40 the port's f32 twin floors no higher than its f64). f64
    must end below 0.75x f32 in both packages, and the two f64 runs within
    5% of each other (the scene is near-singular; on the CPU they read 1.7%)."""
    prob = test_ba.TestF64NormalEquations()._ill_conditioned_problem(n_cams=100, n_pts=1000,
                                                             obs_per_cam=100)
    base = dict(max_iterations=20, cg_iters=40, cg_tol=1e-10, ftol=0.0, use_dense_schur_below=0)
    tp = problem_from_numpy(prob, device="cpu")
    cost = {}
    for f64 in (False, True):
        _, st = tlm.run_ba(tp, PortBAConfig(f64_normal_equations=f64, **base),
                           optimize_intrinsics=False)
        _, st_j = j_run_ba(prob, BAConfig(f64_normal_equations=f64, **base),
                           optimize_intrinsics=False)
        assert st["solver"] == "pcg" and st["dtype"] == ("float64" if f64 else "float32")
        cost[f64] = (st["final_cost"], float(st_j["final_cost"]), st["rms_px"],
                     float(st_j["rms_px"]))
    (c32, j32, r32, jr32), (c64, j64, r64, jr64) = cost[False], cost[True]
    assert np.isfinite([c32, c64, j32, j64]).all()
    assert c64 < 0.75 * c32 and r64 < r32, (c32, c64)
    assert j64 < 0.75 * j32 and jr64 < jr32, (j32, j64)
    assert abs(c64 - j64) <= 0.05 * j64, (c64, j64)


# ----------------------------------------------- the engine on the 8 rendered views

@pytest.fixture(scope="module")
def pair_table(tmp_path_factory):
    """The port's preprocess artifacts of the 8 rendered views: (scene,
    ``pair_table.pkl``)."""
    from sfm_tpu_torch import cli

    scene = render_scene(tmp_path_factory.mktemp("percam") / "scene", N_IMAGES)
    out = tmp_path_factory.mktemp("percam_preprocess")
    SfMConfig(features=FeatureConfig(detect_batch=2)).to_json(out / "config.json")
    assert cli.main(["--log_dir", str(out / "logs"), "preprocess", "--data_dir", str(scene),
                     "--output_dir", str(out), "--device", "cpu", "--no_mask",
                     "--config", str(out / "config.json")]) == 0
    return scene, out / "pair_table.pkl"


# The BA settings of each case over RECON_CONFIG's (which fixes the shared K:
# per-camera mode needs the intrinsics optimized), and the route its BA
# calls must record.
FLAGS = {"per_camera": ({"per_camera_intrinsics": True, "optimize_intrinsics": True},
                        "cam_params", 10),
         "f64": ({"f64_normal_equations": True}, "dtype", "float64")}


@pytest.mark.parametrize("flag", list(FLAGS))
def test_reconstruct_with_each_flag_matches_jax(pair_table, tmp_path, flag):
    """``reconstruct`` with the flag set, in both packages on one pair table:
    the same camera count, mean reprojection within 0.05 px, and every BA
    call of the port on the flag's route with its cost finite and down. The
    f64 case is held to the pixel-pipeline gates. The per-camera case is held
    to JAX's own model instead: with free per-camera intrinsics (and the
    shared K refreshed to their mean after each BA) the reference itself
    misses the gates on these 8 views (on the CPU: 2.2088 px, GT rotation
    median 24.27 deg; the port 2.2093 px, 24.27 deg), so the port must land
    where it lands: the same points within 1%, GT rotation within 1 deg."""
    from sfm_tpu.pipeline import PipelineArgs, SfMPipeline
    from sfm_tpu_torch import cli

    scene, table = pair_table
    ba, key, value = FLAGS[flag]
    cfg = RECON_CONFIG.replace(ba=dataclasses.replace(RECON_CONFIG.ba, **ba))
    jd, pd = tmp_path / "jax", tmp_path / "port"
    for d in (jd, pd):
        d.mkdir()
        shutil.copy(table, d / "pair_table.pkl")
    pipe = SfMPipeline(PipelineArgs(data_dir=str(scene), output_dir=str(jd), use_mask=False,
                                    num_images=N_IMAGES, export_colmap=False,
                                    export_meshlab=False), cfg)
    assert pipe.run_reconstruction()
    js = pipe.result.stats
    cfg.replace(features=FeatureConfig(detect_batch=2)).to_json(pd / "cfg.json")
    assert cli.main(["--log_dir", str(pd / "logs"), "reconstruct", "--data_dir", str(scene),
                     "--output_dir", str(pd), "--device", "cpu", "--no_mask", "--num_images",
                     str(N_IMAGES), "--config", str(pd / "cfg.json")]) == 0
    s = json.loads((pd / "reconstruction" / "stats.json").read_text())
    assert s["num_cameras"] == js["num_cameras"] == N_IMAGES
    assert abs(s["mean_reprojection_error"] - js["mean_reprojection_error"]) <= 0.05
    if flag == "f64":
        assert_pixel_gates(js)
        assert_pixel_gates(s)
    else:
        assert abs(s["num_points"] - js["num_points"]) <= 0.01 * js["num_points"]
        assert abs(s["gt_rot_err_deg_median"] - js["gt_rot_err_deg_median"]) <= 1.0
    calls = [r for r in json.loads((pd / "metrics.json").read_text()) if r["name"] == "ba/solve"]
    assert calls
    for r in calls:
        assert r[key] == value
        assert np.isfinite(r["final_cost"]) and r["final_cost"] <= r["initial_cost"]


# ---------------------------------------------------------------- the refusals

def test_island_wrappers_refuse_what_they_cannot_run():
    m = lambda *s, dtype=torch.float32: torch.empty(s, device="meta", dtype=dtype)
    # Device: only CUDA tensors launch, only CPU tensors take the twins.
    with pytest.raises(ValueError, match="device"):
        tschur.linearize(m(2, 3), *([None] * 15), dtype=torch.float64)
    lin = tschur.Linearization(*([None] * 6), V=m(1, 3, 3), U=m(2, 10, 10), Uk=m(4, 4),
                               g_c=None, g_k=None, g_p=None, point_valid=None)
    for fn in (lambda: tschur.damp_operator(lin, 1e-3, None, None),
               lambda: tschur.block_jacobi(m(2, 10, 10), m(2, 10), m(4, 4), m(4)),
               lambda: tschur.schur_matvec(lin, None, m(2, 10), m(4), None, None),
               lambda: tschur.pcg_solve(lin, None, m(2, 10), m(4), None, None)):
        with pytest.raises(ValueError, match="device"):
            fn()
    # B and dtype: a route exists for B in (6, 10) and float32 / float64.
    assert [tschur.variant(b, d) for b in (6, 10) for d in (torch.float32, torch.float64)] == [
        "", "_f64", "_b10", "_b10_f64"]
    for b, d in ((8, torch.float32), (6, torch.float16)):
        with pytest.raises(ValueError, match="no route"):
            tschur.variant(b, d)
    with pytest.raises(TypeError, match="dtype"):   # a float32 damping with f64 blocks
        tschur.block_jacobi_cuda(m(2, 10, 10, dtype=torch.float64), m(2, 10), m(4, 4), m(4))
    with pytest.raises(ValueError, match="shape"):  # a 6-wide damping with 10-wide blocks
        tschur.block_jacobi_cuda(m(2, 10, 10), m(2, 6), m(4, 4), m(4))
    # The camera count is no refusal: a block's WORDS x (BC + 4) camera sums
    # stay in 227 KB of shared memory up to max_cameras, above it they go to
    # global memory (the route's launches: tests/test_torch_pnp_dlt.py).
    assert [tschur.max_cameras(b, d) for b in (6, 10)
            for d in (torch.float32, torch.float64)] == [4842, 2420, 2905, 1452]
    assert tschur.camera_sums_in_shared(1452, 10, torch.float64)
    assert not tschur.camera_sums_in_shared(1453, 10, torch.float64)
