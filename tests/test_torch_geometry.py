"""The port's geometry against the JAX package: rotations, projection,
small-matrix inverse iteration, triangulation and essential-matrix pose
recovery. Inputs come from numpy with a seed; tolerance 1e-5 relative
(float32 on both sides, another summation order) unless stated.
"""
import numpy as np
import pytest
import torch

from torch_parity import n, t

import sfm_tpu.geometry.epipolar as jepi
import sfm_tpu.geometry.projection as jproj
import sfm_tpu.geometry.rotations as jrot
import sfm_tpu.geometry.triangulation as jtri
import sfm_tpu.utils.linalg as jlin
import sfm_tpu_torch.geometry.epipolar as tepi
import sfm_tpu_torch.geometry.projection as tproj
import sfm_tpu_torch.geometry.rotations as trot
import sfm_tpu_torch.geometry.triangulation as ttri
import sfm_tpu_torch.utils.linalg as tlin

K = np.array([[1228.0, 0, 512.0], [0, 1228.0, 384.0], [0, 0, 1]], np.float32)


def close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(n(a), n(b), rtol=rtol, atol=atol)


def random_rvecs(rng, m):
    """Generic angles, exact zero, the Taylor branch, and angles near pi."""
    r = rng.normal(0, 1.0, (m, 3)).astype(np.float32)
    r[0] = 0.0
    r[1] = [3e-5, -2e-5, 1e-5]
    axis = rng.normal(size=(2, 3))
    r[2:4] = (axis / np.linalg.norm(axis, axis=1, keepdims=True) * (np.pi - 2e-4)).astype(
        np.float32)
    return r


def pose_pair(rng):
    a = rng.uniform(0.1, 0.3)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]], np.float32)
    tv = np.array([rng.uniform(0.5, 1.0), 0.05, 0.1], np.float32)
    return R, tv


def two_view(rng, N=64, noise=0.3):
    R, tv = pose_pair(rng)
    X = rng.uniform([-2, -2, 4], [2, 2, 8], (N, 3))
    x1 = X @ K.T
    x2 = (X @ R.T + tv) @ K.T
    p1 = (x1[:, :2] / x1[:, 2:] + rng.normal(0, noise, (N, 2))).astype(np.float32)
    p2 = (x2[:, :2] / x2[:, 2:] + rng.normal(0, noise, (N, 2))).astype(np.float32)
    return R, tv, X.astype(np.float32), p1, p2


def test_rodrigues_and_back(rng):
    rv = random_rvecs(rng, 64)
    close(trot.rodrigues(t(rv)), jrot.rodrigues(rv))
    close(trot.skew(t(rv)), jrot.skew(rv))
    R = np.asarray(jrot.rodrigues(rv))
    # rvec near pi: the axis sign is ambiguous by nature; compare rotations.
    back_t, back_j = trot.rotation_to_rvec(t(R)), jrot.rotation_to_rvec(R)
    close(trot.rodrigues(back_t), jrot.rodrigues(back_j), rtol=1e-4, atol=1e-5)
    close(back_t[4:], back_j[4:], rtol=1e-4, atol=1e-5)


def test_rodrigues_jacobian_is_finite_at_zero():
    # The seed camera sits exactly at rvec = 0: the Taylor branch keeps the
    # torch.func Jacobian finite there and equal to the skew generators.
    J = torch.func.jacrev(trot.rodrigues)(torch.zeros(3))
    assert torch.isfinite(J).all()
    e = torch.eye(3)
    for k in range(3):
        torch.testing.assert_close(J[..., k], trot.skew(e[k]))


def test_quaternion_from_matrix(rng):
    R = np.asarray(jrot.rodrigues(random_rvecs(rng, 64)))
    close(trot.quaternion_from_matrix(t(R)), jrot.quaternion_from_matrix(R), rtol=1e-5,
          atol=2e-6)


def test_project(rng):
    rv = random_rvecs(rng, 8)
    R = np.asarray(jrot.rodrigues(rv))
    tv = rng.uniform([-1, -1, 4], [1, 1, 6], (8, 3)).astype(np.float32)
    X = rng.uniform(-1, 1, (8, 50, 3)).astype(np.float32)
    X[0, 0] = -tv[0] @ R[0]                       # depth 0: the clamped branch
    pt, dt = tproj.project(t(X), t(R)[:, None], t(tv)[:, None], t(K))
    pj, dj = jproj.project(X, R[:, None], tv[:, None], K)
    close(dt, dj)
    finite = np.isfinite(n(pj)).all(-1) & (np.abs(n(pj)) < 1e8).all(-1)
    close(n(pt)[finite], n(pj)[finite], rtol=1e-5, atol=1e-3)
    close(tproj.camera_matrix(1228.0, 1230.0, 512.0, 384.0),
          jproj.camera_matrix(1228.0, 1230.0, 512.0, 384.0))


@pytest.mark.parametrize("size", [3, 4])
def test_smallest_eigvec_adjugate(rng, size):
    A = rng.normal(size=(32, 6, size)).astype(np.float32)
    AtA = np.einsum("bmi,bmj->bij", A, A)
    AtA[:, :, :] += np.eye(size, dtype=np.float32) * 1e-3
    got, ref = n(tlin.smallest_eigvec(t(AtA))), n(jlin.smallest_eigvec(AtA))
    # Unit vectors up to sign.
    sign = np.sign((got * ref).sum(-1, keepdims=True))
    np.testing.assert_allclose(got * sign, ref, rtol=1e-5, atol=1e-5)


def test_triangulation(rng):
    R, tv, X, p1, p2 = two_view(rng)
    P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32)
    P2 = K @ np.hstack([R, tv[:, None]]).astype(np.float32)
    got = ttri.triangulate_two_view(t(P1), t(P2), t(p1), t(p2))
    ref = jtri.triangulate_two_view(P1, P2, p1, p2)
    close(got, ref, rtol=1e-5, atol=1e-5)
    # Multi-view with a masked view.
    Ps = np.stack([P1, P2, P2 + 0.01, P1]).astype(np.float32)
    pts = np.stack([p1[0], p2[0], p2[0] + 3.0, p1[0]])
    valid = np.array([True, True, False, True])
    close(ttri.triangulate_multiview(t(Ps), t(pts), t(valid)),
          jtri.triangulate_multiview(Ps, pts, valid), rtol=1e-5, atol=1e-5)


def test_recover_pose(rng):
    # Batched over 4 pairs in the port; the reference once per pair.
    Es, p1s, p2s, ws = [], [], [], []
    for _ in range(4):
        R, tv, X, p1, p2 = two_view(rng, noise=0.0)
        ex = np.array([[0, -tv[2], tv[1]], [tv[2], 0, -tv[0]], [-tv[1], tv[0], 0]])
        F = np.linalg.inv(K).T @ ex @ R @ np.linalg.inv(K)
        Es.append(np.asarray(jepi.essential_from_fundamental(F.astype(np.float32), K)))
        p1s.append(p1)
        p2s.append(p2)
        w = np.ones(len(p1), np.float32)
        w[:5] = 0.0
        ws.append(w)
    E, p1, p2, w = (np.stack(a).astype(np.float32) for a in (Es, p1s, p2s, ws))
    nt, Rt, tt, mt = tepi.recover_pose(t(E), t(p1), t(p2), t(K), t(w))
    for b in range(4):
        nj, Rj, tj, mj = jepi.recover_pose(E[b], p1[b], p2[b], K, w[b])
        assert float(nt[b]) == pytest.approx(float(nj), abs=1)
        close(Rt[b], Rj, rtol=1e-5, atol=1e-5)
        close(tt[b], tj, rtol=1e-5, atol=1e-5)
        assert (n(mt[b]) != np.asarray(mj)).sum() <= 1
    close(tepi.essential_from_fundamental(t(E[0]), t(K)),
          jepi.essential_from_fundamental(E[0], K), rtol=1e-5, atol=1e-3)
