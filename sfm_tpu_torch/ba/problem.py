"""The flat observation-table form of a bundle-adjustment problem.

Counterpart of ``sfm_tpu/ba/problem.py``: every observation row knows its
camera id and point id, invalid (padding) rows carry ``obs_valid=False``.
The arrays are tensors on one named device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class BAProblem(NamedTuple):
    """Padded BA problem. Shapes: C cameras, P points, O observations."""

    rvec: torch.Tensor        # (C, 3) axis-angle world->cam, f32
    tvec: torch.Tensor        # (C, 3) f32
    cam_valid: torch.Tensor   # (C,) bool
    cam_fixed: torch.Tensor   # (C,) bool: gauge anchors (step forced to 0)
    intr: torch.Tensor        # (4,) fx, fy, cx, cy (shared pinhole)
    points: torch.Tensor      # (P, 3) f32
    point_valid: torch.Tensor # (P,) bool
    obs_cam: torch.Tensor     # (O,) int32
    obs_point: torch.Tensor   # (O,) int32
    obs_xy: torch.Tensor      # (O, 2) f32 pixels
    obs_valid: torch.Tensor   # (O,) bool
    intr_c: Optional[torch.Tensor] = None  # (C, 4) per-camera intrinsics (only with
                                           # BAConfig.per_camera_intrinsics)

    @property
    def num_cameras(self) -> int:
        return self.rvec.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]


_DTYPES = {
    "rvec": np.float32, "tvec": np.float32, "cam_valid": bool, "cam_fixed": bool,
    "intr": np.float32, "points": np.float32, "point_valid": bool,
    "obs_cam": np.int32, "obs_point": np.int32, "obs_xy": np.float32, "obs_valid": bool,
    "intr_c": np.float32,
}


def problem_from_numpy(arrays, *, device) -> BAProblem:
    """A :class:`BAProblem` from host arrays, one per field, on ``device``.

    ``arrays`` is a mapping or any object with the fields as attributes
    (a JAX ``BAProblem``'s arrays pass through ``np.asarray``); an absent or
    None ``intr_c`` stays None.
    """
    get = ((lambda k: arrays.get(k)) if isinstance(arrays, dict)
           else lambda k: getattr(arrays, k, None))
    dev = torch.device(device)
    return BAProblem(**{
        k: None if get(k) is None else torch.as_tensor(np.array(get(k), dtype=dt), device=dev)
        for k, dt in _DTYPES.items()
    })


def build_problem(rvec, tvec, cam_valid, intr, points, point_valid,
                  obs_cam, obs_point, obs_xy, obs_valid, *, device,
                  cam_fixed=None) -> BAProblem:
    """Assemble a BAProblem from host arrays on ``device``.

    ``cam_fixed`` defaults to fixing the first valid camera (gauge freedom).
    The reference pads shapes to buckets so that its jitted program is
    reused; eager PyTorch has no such need.
    """
    if cam_fixed is None:
        cv = np.asarray(cam_valid, bool)
        cam_fixed = np.zeros(len(cv), bool)
        if cv.any():
            cam_fixed[np.argmax(cv)] = True
    return problem_from_numpy({
        "rvec": rvec, "tvec": tvec, "cam_valid": cam_valid, "cam_fixed": cam_fixed,
        "intr": intr, "points": points, "point_valid": point_valid, "obs_cam": obs_cam,
        "obs_point": obs_point, "obs_xy": obs_xy, "obs_valid": obs_valid,
    }, device=device)
