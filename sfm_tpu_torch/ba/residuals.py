"""Per-observation residuals, Jacobians, Huber weights and cost.

Counterpart of ``sfm_tpu/ba/residuals.py``: shared intrinsics, and the
per-camera variant (a 10-parameter camera block, the reference's
``residuals_and_jacobians_percam``). The plain twins differentiate
:func:`residual_one` with ``torch.func.jacrev``, as the reference does with
``jax.jacrev``. On a CUDA tensor the work runs in kernel K8+K9
(``csrc/ba_linearize.cu``), whose Jacobians are analytic:
:func:`sfm_tpu_torch.ba.schur.linearize` for the linearization and
:func:`total_huber_cost` (entries ``ba_cost`` and, with (C, 4) intrinsics,
``ba_cost_b10``) for the LM cost.
"""
from __future__ import annotations

import torch

from sfm_tpu_torch import _kernels
from sfm_tpu_torch.geometry.projection import camera_matrix, project
from sfm_tpu_torch.geometry.rotations import rodrigues

_EPS = 1e-12


def residual_one(rvec, tvec, intr, point, xy):
    """Reprojection residual (2,) of one observation."""
    xc = rodrigues(rvec) @ point + tvec
    z = torch.where(xc[2].abs() < _EPS, torch.full_like(xc[2], _EPS), xc[2])
    u = intr[0] * xc[0] / z + intr[2]
    v = intr[1] * xc[1] / z + intr[3]
    return torch.stack([u, v]) - xy


def _res_packed(camp, intr, point, xy):
    return residual_one(camp[:3], camp[3:], intr, point, xy)


def residuals_and_jacobians(rvec, tvec, intr, points, obs_cam, obs_point, obs_xy):
    """r (O, 2), J_c (O, 2, 6), J_k (O, 2, 4), J_p (O, 2, 3) for every row."""
    camp = torch.cat([rvec, tvec], dim=-1)[obs_cam.long()]
    pt = points[obs_point.long()]
    r = torch.func.vmap(_res_packed, in_dims=(0, None, 0, 0))(camp, intr, pt, obs_xy)
    jac = torch.func.jacrev(_res_packed, argnums=(0, 1, 2))
    J_c, J_k, J_p = torch.func.vmap(jac, in_dims=(0, None, 0, 0))(camp, intr, pt, obs_xy)
    return r, J_c, J_k, J_p


def _res_packed10(camp, point, xy):
    return residual_one(camp[:3], camp[3:6], camp[6:10], point, xy)


def residuals_and_jacobians_percam(rvec, tvec, intr_c, points, obs_cam, obs_point, obs_xy):
    """Per-camera intrinsics: r (O, 2), J_c (O, 2, 10) = d r / d (rvec, t,
    fx, fy, cx, cy) and J_p (O, 2, 3); no separate intrinsics Jacobian."""
    camp = torch.cat([rvec, tvec, intr_c], dim=-1)[obs_cam.long()]
    pt = points[obs_point.long()]
    r = torch.func.vmap(_res_packed10)(camp, pt, obs_xy)
    J_c, J_p = torch.func.vmap(torch.func.jacrev(_res_packed10, argnums=(0, 1)))(camp, pt,
                                                                                 obs_xy)
    return r, J_c, J_p


def residuals(rvec, tvec, intr, points, obs_cam, obs_point, obs_xy):
    """r (O, 2) alone: the same arithmetic as :func:`residual_one`, batched.
    ``intr``: the shared (4,) or each camera's (C, 4)."""
    cam = obs_cam.long()
    if intr.dim() == 2:
        xc = (rodrigues(rvec)[cam] @ points[obs_point.long()][..., None])[..., 0] + tvec[cam]
        z = torch.where(xc[:, 2].abs() < _EPS, torch.full_like(xc[:, 2], _EPS), xc[:, 2])
        k = intr[cam]
        return torch.stack([k[:, 0] * xc[:, 0] / z + k[:, 2],
                            k[:, 1] * xc[:, 1] / z + k[:, 3]], -1) - obs_xy
    K = camera_matrix(*intr, dtype=intr.dtype, device=intr.device)
    xy, _ = project(points[obs_point.long()], rodrigues(rvec)[cam], tvec[cam], K)
    return xy - obs_xy


def huber_weights(r, delta: float):
    """IRLS weights of the Huber loss on |r|: 1 inside delta, delta/|r| outside."""
    norm = torch.linalg.vector_norm(r, dim=-1)
    return torch.where(norm <= delta, 1.0, delta / torch.clamp(norm, min=_EPS))


def huber_cost(r, valid, delta: float):
    """Total Huber cost of the rows where ``valid``."""
    norm = torch.linalg.vector_norm(r, dim=-1)
    c = torch.where(norm <= delta, 0.5 * norm**2, delta * (norm - 0.5 * delta))
    return torch.where(valid, c, 0.0).sum()


def total_huber_cost_plain(rvec, tvec, intr, points, obs_cam, obs_point, obs_xy, obs_w,
                           delta: float):
    r = residuals(rvec, tvec, intr, points, obs_cam, obs_point, obs_xy)
    return huber_cost(r, obs_w > 0, delta)


def total_huber_cost_cuda(rvec, tvec, intr, points, obs_cam, obs_point, obs_xy, obs_w,
                          delta: float):
    C, P, O = rvec.shape[0], points.shape[0], obs_cam.shape[0]
    dev = rvec.device
    percam = intr.dim() == 2
    for name, x, dt, shape in (
            ("rvec", rvec, torch.float32, (C, 3)), ("tvec", tvec, torch.float32, (C, 3)),
            ("intr", intr, torch.float32, (C, 4) if percam else (4,)),
            ("points", points, torch.float32, (P, 3)),
            ("obs_cam", obs_cam, torch.int32, (O,)), ("obs_point", obs_point, torch.int32, (O,)),
            ("obs_xy", obs_xy, torch.float32, (O, 2)), ("obs_w", obs_w, torch.float32, (O,))):
        _kernels.check_tensor(x, name, dt, shape, dev)
    out = torch.zeros((1,), dtype=torch.float64, device=dev)
    partial = torch.empty(512, dtype=torch.float64, device=dev)   # the blocks' sums
    _kernels.launch("ba_cost_b10" if percam else "ba_cost", dev, rvec, tvec, intr, points,
                    obs_cam, obs_point, obs_xy, obs_w, O, float(delta), out, partial)
    return out[0].to(torch.float32)


def total_huber_cost(rvec, tvec, intr, points, obs_cam, obs_point, obs_xy, obs_w,
                     delta: float):
    """Huber cost of every row with ``obs_w > 0``: the LM accept/reject metric.
    ``intr``: the shared (4,) or each camera's (C, 4).

    Kernel K8's ``ba_cost`` entry (``ba_cost_b10`` with (C, 4) intrinsics)
    on a CUDA tensor (f64 accumulation), the plain twin on a CPU tensor.
    """
    args = (rvec, tvec, intr, points, obs_cam, obs_point, obs_xy, obs_w, delta)
    if rvec.is_cuda:
        return total_huber_cost_cuda(*args)
    if rvec.device.type == "cpu":
        return total_huber_cost_plain(*args)
    raise ValueError(f"total_huber_cost: unsupported device {rvec.device}")
