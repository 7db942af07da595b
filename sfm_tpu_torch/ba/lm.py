"""The Levenberg-Marquardt outer loop (accept/reject with adaptive damping).

Counterpart of ``sfm_tpu/ba/lm.py::run_ba``. The loop runs in Python: each
iteration damps the CACHED linearization, solves the reduced system,
back-substitutes the point step and compares the Huber cost (one host sync
per iteration); the linearization is recomputed only
after an accepted step, the reference's schedule (``lm.py:259-265``). The
solve routes on the problem's camera count as the reference's ``lm_solve``
does (``lm.py:220-232``): the exact dense Schur solve up to
``BAConfig.use_dense_schur_below`` cameras, the matrix-free block-Jacobi PCG
(kernel K11; no host sync inside it) above. With
``BAConfig.per_camera_intrinsics`` the camera block is 10 parameters (pose
and each camera's fx, fy, cx, cy, regularized per camera; the shared K
comes back as the valid cameras' mean), and with
``BAConfig.f64_normal_equations`` the normal equations, from the whitening
to the solved step, are float64 (the reference's ``lm.py:130-303``).
"""
from __future__ import annotations

import numpy as np
import torch

from sfm_tpu_torch.config import BAConfig
from sfm_tpu_torch.ba.problem import BAProblem
from sfm_tpu_torch.ba.residuals import total_huber_cost
from sfm_tpu_torch.ba.schur import (
    back_substitute, coobs_pairs, coupling_workspace, damp_operator, damp_workspace,
    dense_schur_direct, grouping_order, linearize, linearize_workspace, matvec_workspace,
    pcg_solve)

_REG_A = np.array([
    [1.0, 0.0, 0.0, 0.0],   # fx anchored to its initial value
    [1.0, -1.0, 0.0, 0.0],  # fx ~ fy
    [0.0, 0.0, 1.0, 0.0],   # cx ~ image center
    [0.0, 0.0, 0.0, 1.0],   # cy ~ image center
], np.float32)


def _reg_system(intr_ref, weight: float, dev):
    """A and b of the regularization residuals r = A intr - b (weighted)."""
    A = torch.as_tensor(_REG_A, device=dev) * weight
    b = weight * torch.stack([intr_ref[0], torch.zeros_like(intr_ref[0]), intr_ref[2],
                              intr_ref[3]])
    return A, b


def _intr_reg(intr, intr_ref, weight: float):
    """Linear regularization residuals r = w (A intr - b) and their H, g."""
    A, b = _reg_system(intr_ref, weight, intr.device)
    r = A @ intr - b
    return r, A.mT @ A, A.mT @ r


def percam_regularization(intr_c, intr_ref, weight: float, cam_valid):
    """The per-camera intrinsics regularization, masked to the valid cameras
    (the reference's ``_reg_percam``, ``sfm_tpu/ba/lm.py:139-144``), and its
    place in the 10-parameter camera system (``:178-183``): r (C, 4),
    U_extra (C, 10, 10) (A^T A on the intrinsics block) and g_c_extra
    (C, 10) (A^T r on the intrinsics entries). ``cam_valid``: (C,) float."""
    C, dev = len(intr_c), intr_c.device
    A, b = _reg_system(intr_ref, weight, dev)
    m = cam_valid[:, None]
    r = (intr_c @ A.mT - b) * m
    U_extra = torch.zeros((C, 10, 10), dtype=torch.float32, device=dev)
    U_extra[:, 6:, 6:] = (A.mT @ A) * m[..., None]
    g_c_extra = torch.cat([torch.zeros((C, 6), dtype=torch.float32, device=dev), r @ A], -1)
    return r, U_extra, g_c_extra


def uses_pcg(config: BAConfig, num_cameras: int) -> bool:
    """The reference's route (``sfm_tpu/ba/lm.py:223``): PCG above
    ``use_dense_schur_below`` cameras, the dense Schur solve up to it."""
    return num_cameras > config.use_dense_schur_below


def ba_route(config: BAConfig, num_cameras: int, optimize_intrinsics: bool = True) -> dict:
    """The route a BA call takes: its solver ("pcg" or "dense"), its camera
    block (6, or 10 with per-camera intrinsics being optimized) and the
    dtype of its normal equations ("float32" or "float64")."""
    percam = bool(config.per_camera_intrinsics) and optimize_intrinsics
    return {"solver": "pcg" if uses_pcg(config, num_cameras) else "dense",
            "cam_params": 10 if percam else 6,
            "dtype": "float64" if config.f64_normal_equations else "float32"}


def run_ba(problem: BAProblem, config: BAConfig = BAConfig(), intr_ref=None,
           optimize_intrinsics: bool = True, coobs=None):
    """Run LM bundle adjustment; returns (updated problem, stats dict).

    intr_ref: regularization anchor (fx0, _, cx0, cy0), by default the
    problem's initial intrinsics. coobs: optional (perm, valid) grouping
    from :func:`coobs_pairs` (computed here when not given).
    """
    C, P = problem.num_cameras, problem.num_points
    route = ba_route(config, C, optimize_intrinsics)
    pcg, percam = route["solver"] == "pcg", route["cam_params"] == 10
    dtype = getattr(torch, route["dtype"])
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
    cam_valid = problem.cam_valid.to(torch.float32)
    cam_ok = problem.cam_valid[problem.obs_cam.long()]
    pt_ok = problem.point_valid[problem.obs_point.long()]
    obs_w = (problem.obs_valid & cam_ok & pt_ok).to(torch.float32)
    obs = (problem.obs_cam, problem.obs_point, problem.obs_xy, obs_w)
    # The grouping's camera-major order and K8+K9's layout and scratch, once
    # for the problem (its kernels clear the scratch); K10's and K11's walk
    # orders start from the same order below.
    cuda = dev.type == "cuda"
    grouping = grouping_order(perm, perm_valid, problem.obs_cam) if cuda else None
    lin_work = (linearize_workspace(perm, perm_valid, problem.obs_cam, problem.obs_point, obs_w,
                                    C, P, route["cam_params"], dtype, grouping)
                if cuda else None)

    def total_cost(rvec, tvec, intr, points):
        c = total_huber_cost(rvec, tvec, intr, points, *obs, delta)
        if percam:
            r_reg = percam_regularization(intr, intr_ref, reg_w, cam_valid)[0]
            c = c + 0.5 * (r_reg**2).sum()
        elif optimize_intrinsics:
            r_reg, _, _ = _intr_reg(intr, intr_ref, reg_w)
            c = c + 0.5 * (r_reg**2).sum()
        return c

    def linearize_at(rvec, tvec, intr, points):
        extra = {}
        if optimize_intrinsics and not percam:
            _, Hreg, greg = _intr_reg(intr, intr_ref, reg_w)
        else:
            # Frozen shared K, or the dead shared-k system of per-camera mode.
            Hreg = torch.eye(4, dtype=torch.float32, device=dev)
            greg = torch.zeros(4, dtype=torch.float32, device=dev)
        if percam:
            # The regularization joins the camera system.
            _, U_extra, g_c_extra = percam_regularization(intr, intr_ref, reg_w, cam_valid)
            extra = {"U_extra": U_extra.to(dtype), "g_c_extra": g_c_extra.to(dtype)}
        return linearize(rvec, tvec, intr, points, *obs, cam_free, problem.point_valid,
                         perm, perm_valid, delta, optimize_intrinsics, Hreg, greg, dtype=dtype,
                         work=lin_work, **extra)

    intr0 = problem.intr
    if percam:
        # Every camera starts from its own K, or from the shared one
        # (the reference tiles it, lm.py:97-104).
        intr0 = (problem.intr_c if problem.intr_c is not None
                 else problem.intr[None].expand(C, 4)).contiguous()
    rvec, tvec, intr, points = problem.rvec, problem.tvec, intr0, problem.points
    init_cost = total_cost(rvec, tvec, intr, points)
    lin = linearize_at(rvec, tvec, intr, points)
    # K10's and K11's scratch, once for the problem's shapes (their kernels
    # clear it), and the coupling's and K11's walk orders of the grouping.
    work = damp_workspace(lin) if cuda else None
    mv_work = matvec_workspace(lin, perm, perm_valid, grouping) if pcg and cuda else None
    s_work = coupling_workspace(lin, perm, perm_valid, grouping) if not pcg and cuda else None
    cost = float(init_cost)
    lam = np.float32(config.init_lambda)
    it = n_acc = 0
    done = False
    cg_steps = []
    while it < config.max_iterations and not done:
        op, rhs_c, rhs_k = damp_operator(lin, float(lam), perm, perm_valid, precond=pcg,
                                         work=work)
        if pcg:
            xc, xk, steps = pcg_solve(lin, op, rhs_c, rhs_k, perm, perm_valid,
                                      config.cg_iters, config.cg_tol, work=mv_work)
            cg_steps.append(steps)
        else:
            xc, xk = dense_schur_direct(op, lin, rhs_c, rhs_k, perm, perm_valid, s_work)
        dp = back_substitute(lin, op, xc, xk, perm, perm_valid)
        # The step leaves the island as float32 (lm.py:229-231).
        xc, xk, dp = (x.to(torch.float32) for x in (xc, xk, dp))
        cand = (rvec + xc[:, :3], tvec + xc[:, 3:6], intr + (xc[:, 6:10] if percam else xk),
                points + dp)
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

    if percam:
        # The shared K refreshed to the valid cameras' mean (lm.py:295-303).
        mean = (intr * cam_valid[:, None]).sum(0) / cam_valid.sum().clamp(min=1.0)
        out = problem._replace(rvec=rvec, tvec=tvec, intr=mean, points=points, intr_c=intr)
    else:
        out = problem._replace(rvec=rvec, tvec=tvec, intr=intr, points=points)
    num_obs = float(obs_w.sum())
    stats = {
        "initial_cost": float(init_cost),
        "final_cost": cost,
        "iterations": it,
        "accepted_steps": n_acc,
        "final_lambda": float(lam),
        "rms_px": float(np.sqrt(2.0 * cost / max(num_obs, 1.0))),
        **route,
        # CG steps over all LM iterations, read once here (not in the loop).
        "cg_iterations": int(torch.stack(cg_steps).sum()) if cg_steps else 0,
    }
    return out, stats
