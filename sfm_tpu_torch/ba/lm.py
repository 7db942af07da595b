"""The Levenberg-Marquardt outer loop (accept/reject with adaptive damping).

Counterpart of ``sfm_tpu/ba/lm.py::run_ba`` for shared intrinsics on the
exact dense-Schur path. The loop runs in Python: each iteration damps the
CACHED linearization, solves the reduced system, back-substitutes the point
step and compares the Huber cost (one host sync per iteration); the
linearization is recomputed only after an accepted step, the reference's
schedule (``lm.py:259-265``).

Routes off this path raise: per-camera intrinsics, the f64 island, and
more cameras than ``BAConfig.use_dense_schur_below`` (the PCG path).
"""
from __future__ import annotations

import numpy as np
import torch

from sfm_tpu_torch.config import BAConfig
from sfm_tpu_torch.ba.problem import BAProblem
from sfm_tpu_torch.ba.residuals import total_huber_cost
from sfm_tpu_torch.ba.schur import (
    back_substitute, coobs_pairs, damp_operator, dense_schur_direct, linearize)

_REG_A = np.array([
    [1.0, 0.0, 0.0, 0.0],   # fx anchored to its initial value
    [1.0, -1.0, 0.0, 0.0],  # fx ~ fy
    [0.0, 0.0, 1.0, 0.0],   # cx ~ image center
    [0.0, 0.0, 0.0, 1.0],   # cy ~ image center
], np.float32)


def _intr_reg(intr, intr_ref, weight: float):
    """Linear regularization residuals r = w (A intr - b) and their H, g."""
    A = torch.as_tensor(_REG_A, device=intr.device) * weight
    b = weight * torch.stack([intr_ref[0], torch.zeros_like(intr_ref[0]), intr_ref[2],
                              intr_ref[3]])
    r = A @ intr - b
    return r, A.mT @ A, A.mT @ r


def check_ba_config(config: BAConfig, num_cameras: int):
    """Raise on a BA configuration this port does not run yet (ROADMAP)."""
    if config.per_camera_intrinsics:
        raise NotImplementedError(
            "ba.per_camera_intrinsics is not ported yet (ROADMAP queue 1, item 6)")
    if config.f64_normal_equations:
        raise NotImplementedError(
            "ba.f64_normal_equations is not ported yet (ROADMAP queue 1, item 6)")
    if num_cameras > config.use_dense_schur_below:
        raise NotImplementedError(
            f"{num_cameras} cameras > ba.use_dense_schur_below="
            f"{config.use_dense_schur_below}: the PCG / blocked BA path is not ported "
            "yet (ROADMAP queue 1, item 2)")


def run_ba(problem: BAProblem, config: BAConfig = BAConfig(), intr_ref=None,
           optimize_intrinsics: bool = True, coobs=None):
    """Run LM bundle adjustment; returns (updated problem, stats dict).

    intr_ref: regularization anchor (fx0, _, cx0, cy0), by default the
    problem's initial intrinsics. coobs: optional (perm, valid) grouping
    from :func:`coobs_pairs` (computed here when not given).
    """
    C, P = problem.num_cameras, problem.num_points
    check_ba_config(config, C)
    dev = problem.rvec.device
    if coobs is None:
        perm, pvm = coobs_pairs(problem.obs_point.cpu().numpy(),
                                problem.obs_valid.cpu().numpy())
        coobs = (torch.as_tensor(perm, device=dev), torch.as_tensor(pvm, device=dev))
    perm, perm_valid = coobs
    if intr_ref is None:
        intr_ref = problem.intr
    intr_ref = torch.as_tensor(intr_ref, dtype=torch.float32, device=dev)
    reg_w = float(np.float32(config.intrinsics_reg_weight))
    delta = config.huber_delta

    cam_free = (problem.cam_valid & ~problem.cam_fixed).to(torch.float32)
    cam_ok = problem.cam_valid[problem.obs_cam.long()]
    pt_ok = problem.point_valid[problem.obs_point.long()]
    obs_w = (problem.obs_valid & cam_ok & pt_ok).to(torch.float32)
    obs = (problem.obs_cam, problem.obs_point, problem.obs_xy, obs_w)

    def total_cost(rvec, tvec, intr, points):
        c = total_huber_cost(rvec, tvec, intr, points, *obs, delta)
        if optimize_intrinsics:
            r_reg, _, _ = _intr_reg(intr, intr_ref, reg_w)
            c = c + 0.5 * (r_reg**2).sum()
        return c

    def linearize_at(rvec, tvec, intr, points):
        if optimize_intrinsics:
            _, Hreg, greg = _intr_reg(intr, intr_ref, reg_w)
        else:
            Hreg = torch.eye(4, dtype=torch.float32, device=dev)
            greg = torch.zeros(4, dtype=torch.float32, device=dev)
        return linearize(rvec, tvec, intr, points, *obs, cam_free, problem.point_valid,
                         perm, perm_valid, delta, optimize_intrinsics, Hreg, greg)

    rvec, tvec, intr, points = problem.rvec, problem.tvec, problem.intr, problem.points
    init_cost = total_cost(rvec, tvec, intr, points)
    lin = linearize_at(rvec, tvec, intr, points)
    cost = float(init_cost)
    lam = np.float32(config.init_lambda)
    it = n_acc = 0
    done = False
    while it < config.max_iterations and not done:
        op, rhs_c, rhs_k = damp_operator(lin, float(lam), perm, perm_valid)
        xc, xk = dense_schur_direct(op, lin, rhs_c, rhs_k, perm, perm_valid)
        dp = back_substitute(lin, op, xc, xk, perm, perm_valid)
        cand = (rvec + xc[:, :3], tvec + xc[:, 3:6], intr + xk, points + dp)
        new_cost = float(total_cost(*cand))          # the one host sync per iteration
        accept = new_cost < cost
        rel = np.float32(cost - new_cost) / np.float32(max(cost, 1e-12))
        done = accept and rel < config.ftol
        if accept:
            lam = np.float32(max(lam / np.float32(config.lambda_down), config.min_lambda))
            rvec, tvec, intr, points = cand
            cost = new_cost
            n_acc += 1
            lin = linearize_at(rvec, tvec, intr, points)
        else:
            lam = np.float32(min(lam * np.float32(config.lambda_up), config.max_lambda))
        it += 1

    out = problem._replace(rvec=rvec, tvec=tvec, intr=intr, points=points)
    num_obs = float(obs_w.sum())
    stats = {
        "initial_cost": float(init_cost),
        "final_cost": cost,
        "iterations": it,
        "accepted_steps": n_acc,
        "final_lambda": float(lam),
        "rms_px": float(np.sqrt(2.0 * cost / max(num_obs, 1.0))),
    }
    return out, stats
