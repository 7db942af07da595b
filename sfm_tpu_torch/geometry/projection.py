"""Pinhole projection.

Counterpart of ``sfm_tpu/geometry/projection.py`` (``camera_matrix``,
``project``). Convention: world -> camera ``x_cam = R @ X + t``; pixels are
(x, y).
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def camera_matrix(fx, fy, cx, cy, dtype=torch.float32, device=None):
    """K (..., 3, 3) from scalars or tensors of one shape."""
    fx, fy, cx, cy = (torch.as_tensor(v, dtype=dtype, device=device) for v in (fx, fy, cx, cy))
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    return torch.stack(
        [
            torch.stack([fx, zero, cx], dim=-1),
            torch.stack([zero, fy, cy], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def intrinsics_vector(K):
    """(fx, fy, cx, cy) of K (3, 3), contiguous float32: the kernels' form."""
    return torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).to(torch.float32).contiguous()


def project(points, R, t, K):
    """Project world points to pixels.

    points: (..., 3); R: (..., 3, 3); t: (..., 3); K: (..., 3, 3) or (3, 3).
    Returns (pixels (..., 2), depth (...,)).
    """
    x_cam = (R @ points[..., None])[..., 0] + t
    depth = x_cam[..., 2]
    z = torch.where(depth.abs() < _EPS, torch.full_like(depth, _EPS), depth)
    u = K[..., 0, 0] * x_cam[..., 0] / z + K[..., 0, 2]
    v = K[..., 1, 1] * x_cam[..., 1] / z + K[..., 1, 2]
    return torch.stack([u, v], dim=-1), depth
