"""Kernel K7's triangulation: the first-best rule of its seed-pair hypotheses,
and the wrapper's launch.

The kernel (``csrc/triangulate_tracks.cu``) scores the C(n_seed, 2) two-view
hypotheses of a row a lane each and keeps the first best by a warp argmax:
the highest score, then the lowest hypothesis index, as the JAX package's
``jnp.argmax`` (``sfm_tpu/reconstruction/incremental.py:121``) and the
twin's ``torch.argmax`` keep it (its thread-a-row layout keeps it by the
serial loop's strict ``>``). Here rows are built so that two hypotheses
tie: two clusters of views, each seeing its own point, so every pair inside
either cluster scores the cluster's size. The adopted views, and so the
point, are those of the cluster whose pairs come first. The twin is held
against the JAX package on them (``ok`` equal, points within 1e-4 relative:
the same solves in float32), and both must land on the first cluster's
point. The wrapper's launch, and its choice of layout, are recorded by a
monkeypatched ``_kernels.launch``.
"""
import numpy as np
import pytest
import torch

from test_torch_reconstruct import K, project, ring_cameras
from torch_parity import n, t

from sfm_tpu.geometry.rotations import rotation_to_rvec
from sfm_tpu.reconstruction.incremental import _triangulate_tracks as j_triangulate
from sfm_tpu_torch import _kernels
from sfm_tpu_torch.geometry.projection import intrinsics_vector
from sfm_tpu_torch.geometry.rotations import rodrigues
from sfm_tpu_torch.reconstruction import incremental as tinc


def tied_rows(rng, T=48, V=10, C=12, sizes=(4, 4)):
    """Rows of two clusters of views (sizes[0] then sizes[1] slots, then
    empty slots), each cluster seeing its own point 0.3-0.5 m from the
    other's; which cluster leads the row alternates."""
    Rs, ts = ring_cameras(C)
    view_img = np.full((T, V), -1, np.int32)
    view_xy = np.zeros((T, V, 2), np.float32)
    first = np.zeros((T, 3), np.float32)
    for r in range(T):
        X1 = rng.uniform(-1, 1, 3)
        X2 = X1 + rng.choice([-1, 1], 3) * rng.uniform(0.3, 0.5, 3)
        if r % 2:
            X1, X2 = X2, X1
        L = sum(sizes)
        cams = np.sort(rng.choice(C, L, replace=False))
        rng.shuffle(cams)
        pts = np.concatenate([np.repeat(X1[None], sizes[0], 0), np.repeat(X2[None], sizes[1], 0)])
        xy = np.stack([project(p, Rs[c], ts[c]) for p, c in zip(pts, cams)])
        view_img[r, :L] = cams
        view_xy[r, :L] = xy + rng.normal(0, 0.2, (L, 2))
        first[r] = X1
    rvec = np.asarray(rotation_to_rvec(Rs)).astype(np.float32)
    return view_img, view_xy, rvec, ts, first


@pytest.mark.parametrize("sizes,n_seed", [((4, 4), 8), ((3, 3), 6), ((4, 4), 4)])
def test_tied_seed_pairs_keep_the_first_best(rng, sizes, n_seed):
    view_img, view_xy, rvec, tvec, first = tied_rows(rng, sizes=sizes)
    T, V = view_img.shape
    C = rvec.shape[0]
    registered = np.ones(C, bool)
    active = np.ones(T, bool)
    pj, okj = j_triangulate(view_img, view_xy, view_img >= 0, rvec, tvec, registered, K, active,
                            max_err=4.0, min_parallax_deg=0.0, robust_rounds=1,
                            seed_pairs_on=True, n_seed=n_seed)
    pj, okj = np.asarray(pj), np.asarray(okj)
    use = t(view_img) >= 0
    pt, okt = tinc.triangulate_tracks(t(view_img), t(view_xy), use, t(active), t(rvec), t(tvec),
                                      t(K), max_err=4.0, robust_rounds=1, seed_pairs_on=True,
                                      n_seed=n_seed)
    pt, okt = n(pt), n(okt)
    np.testing.assert_array_equal(okt, okj)
    assert okt.all()
    err = np.linalg.norm(pt - pj, axis=-1) / np.maximum(np.linalg.norm(pj, axis=-1), 1.0)
    assert err.max() <= 1e-4
    # Both adopted the cluster whose pairs come first.
    assert np.linalg.norm(pt - first, axis=-1).max() < 0.05
    assert np.linalg.norm(pj - first, axis=-1).max() < 0.05


def test_triangulate_tracks_cuda_launch_arguments(monkeypatch, rng):
    # The wrapper hands the kernel P = K [R | t], R, t, the camera centers and
    # (fx, fy, cx, cy), the gates as Python numbers, the seed-view count
    # clamped to V, and (T, 3) / (T,) outputs; more seed views than the
    # kernel holds raise before launch.
    T, V, C = 9, 5, 6
    Rs, ts = ring_cameras(C)
    rvec = t(np.asarray(rotation_to_rvec(Rs)).astype(np.float32))
    view_img = t(rng.integers(-1, C, (T, V)).astype(np.int32))
    args = (view_img, t(rng.normal(size=(T, V, 2)).astype(np.float32)), view_img >= 0,
            torch.ones(T, dtype=torch.bool), rvec, t(ts), t(K))
    calls = []
    monkeypatch.setattr(_kernels, "launch", lambda name, dev, *a: calls.append((name, a)))
    pts, ok = tinc.triangulate_tracks_cuda(*args, 3.5, 1.5, 2, True, 8)
    assert [c[0] for c in calls] == ["triangulate_tracks"]
    a = calls[0][1]
    assert all(x is y for x, y in zip(a[:4], args[:4]))
    R = rodrigues(rvec)
    torch.testing.assert_close(a[4], t(K) @ torch.cat([R, t(ts)[..., None]], -1), rtol=0, atol=0)
    torch.testing.assert_close(a[5], R, rtol=0, atol=0)
    torch.testing.assert_close(a[7], -(R.mT @ t(ts)[..., None])[..., 0], rtol=0, atol=0)
    torch.testing.assert_close(a[8], intrinsics_vector(t(K)), rtol=0, atol=0)
    assert a[9:18] == (T, V, C, 3.5, 1.5, 2, 1, V, 0)
    assert a[18] is pts and a[19] is ok
    assert pts.shape == (T, 3) and pts.dtype == torch.float32
    assert ok.shape == (T,) and ok.dtype == torch.bool
    assert all(x.is_contiguous() for x in a[4:9])
    tinc.triangulate_tracks_cuda(*args, 4.0, 0.0, 1, False, 40)
    assert calls[1][1][9:18] == (T, V, C, 4.0, 0.0, 1, 0, V, 0)
    # The camera tensors a caller made once (triangulate_cameras) go to the
    # launch as they are, and equal the wrapper's own.
    cams = tinc.triangulate_cameras(rvec, t(ts), t(K))
    tinc.triangulate_tracks_cuda(*args, 4.0, 0.0, 1, False, 8, cams=cams)
    assert all(x is y for x, y in zip(calls[2][1][4:9], cams))
    assert all(torch.equal(x, y) for x, y in zip(calls[2][1][4:9], calls[0][1][4:9]))
    with pytest.raises(ValueError, match="shape"):
        tinc.triangulate_tracks_cuda(*args, 4.0, 0.0, 1, False, 8, cams=(cams[0][:2],) + cams[1:])
    wide = (t(np.zeros((2, 40), np.int32)), torch.zeros(2, 40, 2), torch.ones(2, 40, dtype=torch.bool),
            torch.ones(2, dtype=torch.bool), rvec, t(ts), t(K))
    with pytest.raises(ValueError, match="seed-pair views"):
        tinc.triangulate_tracks_cuda(*wide, 4.0, 0.0, 1, True, 33)
    assert len(calls) == 3


@pytest.mark.parametrize("T,seed_pairs_on,layout", [
    (tinc._K7_THREAD_ROWS_FROM - 1, False, 0), (tinc._K7_THREAD_ROWS_FROM, False, 1),
    (tinc._K7_THREAD_ROWS_FROM, True, 0)])
def test_triangulate_tracks_cuda_layout(monkeypatch, T, seed_pairs_on, layout):
    # A thread a row (layout 1) for launches of at least _K7_THREAD_ROWS_FROM
    # rows with seed pairs off, else a warp a row; a caller may name either,
    # and nothing else.
    V, C = 3, 4
    Rs, ts = ring_cameras(C)
    rvec = t(np.asarray(rotation_to_rvec(Rs)).astype(np.float32))
    args = (torch.zeros((T, V), dtype=torch.int32), torch.zeros((T, V, 2)),
            torch.ones((T, V), dtype=torch.bool), torch.ones(T, dtype=torch.bool), rvec, t(ts),
            t(K), 4.0, 0.0, 1, seed_pairs_on, 8)
    calls = []
    monkeypatch.setattr(_kernels, "launch", lambda name, dev, *a: calls.append(a))
    tinc.triangulate_tracks_cuda(*args)
    tinc.triangulate_tracks_cuda(*args, layout=1 - layout)
    assert [c[17] for c in calls] == [layout, 1 - layout]
    with pytest.raises(ValueError, match="layout"):
        tinc.triangulate_tracks_cuda(*args, layout=2)
