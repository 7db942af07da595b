"""The engine's BA step against the JAX package on the corridor, and the
step-by-step trace that compares the two engines.

``tests/engine_trace_report.py`` ran both packages' reconstruct stage on the
card's 150-view corridor table, seed by seed, one line a registration and a
BA call. The port and JAX agree call by call until a registration with few
inliers lands tens of degrees off; from there either engine may fold the
corridor, JAX on some seeds as the port on others (``PERF.md``, section 6). A BA
call has no draws, so the cross-feed holds one: JAX's state before a BA
call, fed to both packages, gives the same final cost and intrinsics. Here
that is held on the corridor's geometry as ``render_scene.py`` renders it
(its cameras, K and surfaces), every camera registered, the shared
intrinsics free and started 6% off, as a drifted engine state hands them to
BA: with the f64 island both reach the same focal; in float32 both land
within the same rounding band around it. The trace script's own helpers
are held against the port's geometry. Tolerances beside each check.
"""
import logging

import numpy as np
import pytest
import torch

import engine_trace_report as etr
from test_torch_schur_damp import corridor_system

from sfm_tpu.ba import run_ba as j_run_ba
from sfm_tpu.ba.problem import build_problem as j_build_problem
from sfm_tpu.config import BAConfig
from sfm_tpu_torch.ba import lm as tlm
from sfm_tpu_torch.ba.problem import build_problem as t_build_problem
from sfm_tpu_torch.config import BAConfig as PortBAConfig
from sfm_tpu_torch.geometry.rotations import rodrigues, rotation_to_rvec


def drifted_state(rng, n_cams=12, fx_scale=1.06):
    rvec, tvec, intr, pts, cam, pid, xy = corridor_system(rng, n_cams=n_cams, n_pts=1200)
    intr = (np.asarray(intr) * np.array([fx_scale, fx_scale, 1.0, 1.0])).astype(np.float32)
    C, P, O = len(rvec), len(pts), len(cam)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    return dict(rvec=rvec.astype(np.float32), tvec=tvec.astype(np.float32),
                cam_valid=np.ones(C, bool), intr=intr, points=pts.astype(np.float32),
                point_valid=np.ones(P, bool), obs_cam=cam.astype(np.int32),
                obs_point=pid.astype(np.int32), obs_xy=xy.astype(np.float32),
                obs_valid=np.ones(O, bool), cam_fixed=fixed)


def run_both(state, **cfg):
    out_j, st_j = j_run_ba(j_build_problem(**state), BAConfig(**cfg))
    out_t, st_t = tlm.run_ba(t_build_problem(**state, device="cpu"), PortBAConfig(**cfg))
    return (np.asarray(out_j.intr), float(st_j["final_cost"]), float(st_j["initial_cost"]),
            out_t.intr.numpy(), st_t["final_cost"], st_t["initial_cost"])


@pytest.mark.parametrize("seed", [42, 1])
def test_ba_call_with_free_intrinsics_matches_jax_on_the_corridor(seed):
    # With the f64 island the two packages reach the same minimum (fx within
    # 1e-6 of each other). In float32 the focal is the system's flat
    # direction: each package lands within 2e-3 of the f64 focal (both
    # scatter by ~1 px of 1,301 here, neither biased), the final costs within
    # 1e-4 of the f64 one.
    state = drifted_state(np.random.default_rng(seed))
    kj64, cj64, ij64, kt64, ct64, it64 = run_both(state, f64_normal_equations=True)
    np.testing.assert_allclose(kt64, kj64, rtol=1e-6)
    assert abs(ct64 - cj64) <= 1e-6 * cj64 and ct64 < 0.5 * it64
    kj, cj, ij, kt, ct, it = run_both(state)
    assert abs(it - ij) <= 1e-5 * ij
    for k, c in ((kj, cj), (kt, ct)):
        np.testing.assert_allclose(k, kj64, atol=2e-3 * kj64[0])
        assert abs(c - cj64) <= 1e-4 * cj64


def test_trace_gt_errors_match_the_port_geometry(rng):
    # The report's numpy Rodrigues and per-camera errors: the true poses read
    # 0 deg; one camera turned by 10 deg about its own axis reads 10 deg
    # under the alignment of the other cameras (within 1e-3 deg).
    rvec, tvec, *_ = corridor_system(rng, n_cams=8, n_pts=50)
    R = etr.rot_matrices(rvec)
    np.testing.assert_allclose(R, rodrigues(torch.as_tensor(rvec)).double().numpy(), atol=1e-6)
    gt = {i: (None, R[i], tvec[i]) for i in range(8)}

    class Engine:
        reg_order = list(range(8))

    e = Engine()
    e.rvec, e.tvec = rvec.copy(), tvec.copy()
    assert etr.gt_errors(e, gt)["median"] < 1e-4
    turn = etr.rot_matrices(np.array([[0.0, np.radians(10.0), 0.0]]))[0]
    R5 = turn @ R[5]
    e.rvec[5] = np.asarray(rotation_to_rvec(torch.as_tensor(R5))).reshape(3)
    e.tvec[5] = turn @ tvec[5]   # the same center
    err = etr.gt_errors(e, gt)["per_camera"]
    assert abs(err[5] - 10.0) < 1e-3 and max(v for k, v in err.items() if k != 5) < 1e-3


def test_trace_records_registrations_and_ba_calls(tmp_path):
    # instrument() wraps an engine class's methods in place: one line a
    # registration (its inliers read off the engine's log record) and one a
    # BA call, and the state before the asked-for BA call on disk.
    log = logging.getLogger("engine_trace_test")

    class Engine:
        def __init__(self):
            self.reg_order, self._ba_calls = [], 0
            self.rvec, self.tvec = np.zeros((4, 3), np.float32), np.zeros((4, 3), np.float32)
            self.tvec[:, 0] = np.arange(4)
            self.intr = np.array([1228.0, 1228.0, 512.0, 384.0], np.float32)
            self.registered = np.zeros(4, bool)
            self.points = np.zeros((2, 3), np.float32)
            self.point_valid = np.ones(2, bool)
            self.view_valid = np.ones((2, 2), bool)

        def initialize(self):
            self.reg_order += [0, 1]
            self.registered[[0, 1]] = True
            return 0, 1

        def register_candidates(self, candidates, max_accept):
            for img in candidates[:max_accept]:
                self.reg_order.append(img)
                self.registered[img] = True
                log.info("registered image %d (%d/%d PnP inliers)", img, 40 + img, 50)
            return max_accept

        def register_image(self, img, weak=False):
            return False

        def guided_register(self, img):
            return False

        def _ba_problem_arrays(self):
            z = np.zeros(4, np.int32)
            return z, z, np.zeros((4, 2), np.float32), np.ones(4, bool)

        def bundle_adjust(self, final=False):
            self._ba_calls += 1
            return {"initial_cost": 2.0, "final_cost": 1.0, "iterations": 3,
                    "accepted_steps": 2, "final_lambda": 1e-4}

    lines = []
    gt = {i: (None, np.eye(3), np.array([float(i), 0.0, 0.0])) for i in range(4)}
    regs = etr.instrument(Engine, gt, lines, {1}, tmp_path)
    log.addHandler(regs)
    log.setLevel(logging.INFO)
    try:
        eng = Engine()
        eng.initialize()
        eng.register_candidates([2, 3], 2)
        eng.bundle_adjust()
    finally:
        log.removeHandler(regs)
    kinds = [r["kind"] for r in lines]
    assert kinds == ["seed", "register", "register", "ba"]
    assert [(r["image"], r["inliers"], r["pool"]) for r in lines[1:3]] == [(2, 42, 50),
                                                                          (3, 43, 50)]
    assert lines[2]["gt_rot_median_deg"] < 1e-6
    ba = lines[3]
    assert (ba["registered"], ba["iterations"], ba["final_cost"]) == (4, 3, 1.0)
    assert ba["intr"] == [1228.0, 1228.0, 512.0, 384.0]
    dump = np.load(tmp_path / "ba_1.npz")
    assert list(dump["reg_order"]) == [0, 1, 2, 3] and dump["obs_cam"].shape == (4,)
