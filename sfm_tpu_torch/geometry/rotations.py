"""Rotation parameterizations: axis-angle (Rodrigues), matrices, quaternions.

Counterpart of ``sfm_tpu/geometry/rotations.py``: ``skew``, ``rodrigues``
(with the same theta^2 < 1e-8 Taylor branch, so ``torch.func`` Jacobians
through it stay exact and finite at rvec = 0), ``rotation_to_rvec`` and
``quaternion_from_matrix``. Every function broadcasts over leading
dimensions and is branch-free (``torch.where``), as the reference is.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-12


def skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def rodrigues(rvec):
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3).

    R = I + a K + b K^2 with a = sin(t)/t, b = (1 - cos t)/t^2, K = skew(rvec),
    and Taylor branches below t^2 = 1e-8.
    """
    # keepdim: torch.func's forward mode promotes the tangents of 0-dim
    # tensors times Python floats to float64; a trailing unit dim avoids it.
    theta2 = (rvec * rvec).sum(-1, keepdim=True)
    small = theta2 < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, torch.ones_like(theta2),
                                                           theta2))
    K = skew(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + a[..., None] * K + b[..., None] * (K @ K)


def rotation_to_rvec(R):
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3).

    The reference's three regimes: generic, theta -> 0 (rvec ~ v / 2) and
    theta -> pi (axis from the diagonal of (R + I) / 2, signs from the
    off-diagonal sums).
    """
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    near_zero = theta < 1e-5
    near_pi = theta > math.pi - 1e-3

    vnorm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    generic = v / torch.clamp(vnorm, min=_EPS) * theta[..., None]
    tiny = 0.5 * v

    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_abs = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, min=0.0))
    i_max = torch.argmax(axis_abs, dim=-1)
    s01 = torch.sign(R[..., 0, 1] + R[..., 1, 0])
    s02 = torch.sign(R[..., 0, 2] + R[..., 2, 0])
    s12 = torch.sign(R[..., 1, 2] + R[..., 2, 1])
    one = torch.ones_like(s01)

    def sign_for(comp):
        # Sign of component ``comp`` when the largest component is positive.
        if comp == 0:
            s = torch.where(i_max == 1, s01, s02)
        elif comp == 1:
            s = torch.where(i_max == 0, s01, s12)
        else:
            s = torch.where(i_max == 0, s02, s12)
        return torch.where(i_max == comp, one, torch.where(s == 0, one, s))

    signs = torch.stack([sign_for(c) for c in range(3)], dim=-1)
    axis_pi = axis_abs * signs
    axis_pi = axis_pi / torch.clamp(torch.linalg.vector_norm(axis_pi, dim=-1, keepdim=True),
                                    min=_EPS)
    pi_branch = axis_pi * theta[..., None]
    return torch.where(near_zero[..., None], tiny,
                       torch.where(near_pi[..., None], pi_branch, generic))


def quaternion_from_matrix(R):
    """(..., 3, 3) -> unit quaternion (w, x, y, z) with w >= 0.

    Shepperd's construction: all four candidates, the best-conditioned one
    selected (the reference's branch-free form).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    k = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)

    def s_of(q2):
        return torch.sqrt(torch.clamp(q2, min=_EPS)) * 2.0

    s = s_of(qw2)
    c0 = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s], dim=-1)
    s = s_of(qx2)
    c1 = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s], dim=-1)
    s = s_of(qy2)
    c2 = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s], dim=-1)
    s = s_of(qz2)
    c3 = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s], dim=-1)
    q = torch.gather(torch.stack([c0, c1, c2, c3], dim=-2), -2,
                     k[..., None, None].expand(k.shape + (1, 4)))[..., 0, :]
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)
