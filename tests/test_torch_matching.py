"""Parity of the port's matcher, F-RANSAC, gates and sweep with ``sfm_tpu``.

RANSAC draws differ between ``jax.random`` and ``torch.Generator``, so the
estimator tests hand the port the very sample indices the JAX estimator draws
from its key; the sweep test instead compares accept sets on a scene whose
pairs are clearly in or out.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n, t, unit_rows

from sfm_tpu.config import MatchConfig, SfMConfig, VerifyConfig
from sfm_tpu.estimators.fundamental import estimate_fundamental_ransac as j_est
from sfm_tpu.estimators.ransac import ransac_sample_indices as j_sample
from sfm_tpu.matching.core import _match_descriptors as j_match
from sfm_tpu.matching.sweep import all_pairs_sweep as j_sweep
from sfm_tpu.matching.verify import verify_pair as j_verify
from sfm_tpu_torch.estimators.fundamental import estimate_fundamental_ransac as t_est
from sfm_tpu_torch.estimators.fundamental import fmat_score_select_plain
from sfm_tpu_torch.estimators.ransac import ransac_sample_indices as t_sample
from sfm_tpu_torch.features.frontend import features_from_numpy
from sfm_tpu_torch.geometry.epipolar import eight_point
from sfm_tpu_torch.matching.core import match_descriptors as t_match
from sfm_tpu_torch.matching.core import match_top2
from sfm_tpu_torch.matching.sweep import all_pairs_sweep as t_sweep
from sfm_tpu_torch.matching.verify import verify_pair as t_verify

KMAT = np.array([[1228.0, 0, 512.0], [0, 1228.0, 384.0], [0, 0, 1.0]])


def _rot(rv):
    th = np.linalg.norm(rv)
    k = rv / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _project(X, R, tvec):
    x = (X @ R.T + tvec) @ KMAT.T
    return (x[:, :2] / x[:, 2:]).astype(np.float32)


def two_view(rng, n_pts=300, noise=0.3, outlier_frac=0.25):
    X = rng.uniform([-2, -2, 4], [2, 2, 8], (n_pts, 3))
    p1 = _project(X, np.eye(3), np.zeros(3)) + rng.normal(0, noise, (n_pts, 2))
    p2 = _project(X, _rot(np.array([0.05, 0.3, 0.02])), np.array([0.8, 0.05, 0.1]))
    p2 = p2 + rng.normal(0, noise, (n_pts, 2))
    out = rng.choice(n_pts, int(outlier_frac * n_pts), replace=False)
    p2[out] = rng.uniform([0, 0], [1024, 768], (len(out), 2))
    return p1.astype(np.float32), p2.astype(np.float32)


def _descriptor_pair(rng, K=256, D=128):
    """Two sets sharing 150 noisy duplicates, with near-ties for the ratio
    test, invalid rows on both sides and shuffled columns."""
    common = unit_rows(rng, (150, D))
    d1 = np.concatenate([common, unit_rows(rng, (K - 150, D))])
    twin = common + 0.04 * rng.standard_normal((150, D))
    d2 = np.concatenate([twin / np.linalg.norm(twin, axis=-1, keepdims=True),
                         unit_rows(rng, (K - 150, D))]).astype(np.float32)
    d2[150:170] = d2[:20] + 0.01 * rng.standard_normal((20, D))   # ambiguous twins
    d2[150:170] /= np.linalg.norm(d2[150:170], axis=-1, keepdims=True)
    d2 = d2[rng.permutation(K)]
    v1 = np.ones(K, bool)
    v2 = np.ones(K, bool)
    v1[rng.choice(K, 20, replace=False)] = False
    v2[rng.choice(K, 20, replace=False)] = False
    return d1.astype(np.float32), v1, d2.astype(np.float32), v2


@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("max_matches", [128, 512])
def test_match_descriptors_matches_jax(mutual, max_matches):
    # K1's plain twin + the epilogue. Compared as sets (tie order may differ);
    # distances within 1e-5 (another summation order in the matmul).
    d1, v1, d2, v2 = _descriptor_pair(np.random.default_rng(5))
    ref = j_match(d1, v1, d2, v2, ratio_threshold=0.75, max_matches=max_matches,
                  mutual_check=mutual)
    got = t_match(t(d1)[None], t(v1)[None], t(d2)[None], t(v2)[None],
                  ratio_threshold=0.75, max_matches=max_matches, mutual_check=mutual)
    rv, gv = n(ref["valid"]), n(got["valid"][0])
    assert 60 < rv.sum() and rv.sum() == gv.sum()
    np.testing.assert_array_equal(gv, rv)   # valid rows form the same prefix
    rs = set(zip(n(ref["idx1"])[rv], n(ref["idx2"])[rv]))
    gs = set(zip(n(got["idx1"][0])[gv], n(got["idx2"][0])[gv]))
    assert rs == gs
    assert v1[n(got["idx1"][0])[gv]].all() and v2[n(got["idx2"][0])[gv]].all()
    np.testing.assert_allclose(n(got["distance"][0]), n(ref["distance"]), atol=1e-5)


def test_match_top2_ties_and_invalid_rows():
    # Ties go to the lowest index; an all-inf row returns index 0 (argmin).
    a = unit_rows(np.random.default_rng(0), (4, 32))
    d1 = np.stack([a[0], a[1], a[2], a[3]])
    d2 = np.stack([a[1], a[0], a[0], a[3], a[2]])
    v1 = np.array([True, True, False, True])
    v2 = np.array([True, True, True, False, True])
    idx, best, second = match_top2(t(d1)[None], t(v1)[None], t(d2)[None], t(v2)[None])
    dist = np.where(v2, np.maximum(2 - 2 * d1 @ d2.T, 0), np.inf)
    assert n(idx[0]).tolist() == [1, 0, 0, int(np.argmin(dist[3]))]
    assert np.isinf(n(best[0])[2]) and np.isinf(n(second[0])[2])
    assert n(best[0])[0] == pytest.approx(0.0, abs=1e-6)
    assert n(second[0])[0] == pytest.approx(0.0, abs=1e-6)   # the tied twin


@pytest.mark.parametrize("prefix", [True, False])
def test_fundamental_ransac_same_indices(prefix):
    # Same hypotheses on both sides: F up to sign within 1e-4, inliers equal.
    rng = np.random.default_rng(9)
    p1, p2 = two_view(rng)
    valid = np.ones(len(p1), bool)
    valid[260:] = False
    if not prefix:
        valid[rng.choice(260, 30, replace=False)] = False
    key = jax.random.key(3)
    ref = j_est(key, p1, p2, valid, iters=256, threshold=3.0, prefix_valid=prefix,
                score_budget=128)
    idx = n(j_sample(key, jnp.asarray(valid), 256, 8, prefix=prefix))
    got = t_est(t(p1)[None], t(p2)[None], t(valid)[None], iters=256, threshold=3.0,
                prefix_valid=prefix, score_budget=128, indices=t(idx)[None].long())
    F, Fr = n(got["F"][0]), n(ref["F"])
    assert min(np.abs(F - Fr).max(), np.abs(F + Fr).max()) <= 1e-4
    np.testing.assert_array_equal(n(got["inliers"][0]), n(ref["inliers"]))
    assert int(got["num_inliers"][0]) == int(ref["num_inliers"]) > 150
    assert bool(got["ok"][0]) == bool(ref["ok"])


@pytest.mark.parametrize("case", ["good", "noise", "concentrated"])
def test_verify_pair_gates_match_jax(case):
    rng = np.random.default_rng(13)
    p1, p2 = two_view(rng)
    if case == "noise":
        p2 = rng.uniform([0, 0], [1024, 768], p2.shape).astype(np.float32)
    if case == "concentrated":
        p1 = (p1 - p1.mean(0)) * 0.02 + 500
        p2 = (p2 - p2.mean(0)) * 0.02 + 400
    valid = np.ones(len(p1), bool)
    key = jax.random.key(1)
    ref = j_verify(key, p1, p2, valid, ransac_iters=256, prefix_valid=True,
                   score_budget=128)
    idx = n(j_sample(key, jnp.asarray(valid), 256, 8, prefix=True))
    got = t_verify(t(p1)[None], t(p2)[None], t(valid)[None], ransac_iters=256,
                   prefix_valid=True, score_budget=128, indices=t(idx)[None].long())
    for k in ("accept", "well_distributed", "num_matches"):
        assert n(got[k][0]) == n(ref[k]), k
    assert bool(got["accept"][0]) == (case == "good")
    if case == "good":
        assert int(got["num_inliers"][0]) == int(ref["num_inliers"])
        for k in ("inlier_ratio", "reprojection_error"):
            np.testing.assert_allclose(n(got[k][0]), n(ref[k]), rtol=1e-4, atol=1e-5)
    else:
        # Degenerate sets: the refit F is ill-conditioned, so a point or two
        # may cross the threshold under another rounding; the verdict may not.
        assert abs(int(got["num_inliers"][0]) - int(ref["num_inliers"])) <= 3


def test_score_select_first_index_on_ties():
    # ransac_select's rule: max(count - mean_err / thr), first index on ties.
    p1, p2 = two_view(np.random.default_rng(4), n_pts=64, outlier_frac=0.0)
    good = eight_point(t(p1), t(p2))
    bad = torch.eye(3)
    Fs = torch.stack([bad, good, good, bad])[None]
    best, count = fmat_score_select_plain(Fs, t(p1)[None], t(p2)[None],
                                          torch.ones(1, 64, dtype=torch.bool), 3.0)
    assert int(best[0]) == 1 and int(count[0]) == 64


def _six_view_scene(rng, K=256, D=128):
    """6 views along a track; view c sees points [100c, 100c + 256), so each
    view shares 156 points with its neighbour and none beyond the next one
    but one."""
    X = rng.uniform([-3, -1.5, 5], [6, 1.5, 9], (100 * 5 + K, 3))
    X[:, 0] = np.linspace(-3, 6, len(X)) + rng.normal(0, 0.2, len(X))
    feats = unit_rows(rng, (len(X), D))
    xy = np.zeros((6, K, 2), np.float32)
    desc = np.zeros((6, K, D), np.float32)
    for c in range(6):
        ids = np.arange(100 * c, 100 * c + K)
        R = _rot(np.array([0.0, 0.02 * c + 1e-6, 0.0]))
        tvec = -R @ np.array([1.2 * c - 1.5, 0.0, 0.0])
        xy[c] = _project(X[ids], R, tvec) + rng.normal(0, 0.3, (K, 2))
        d = feats[ids] + 0.05 * rng.standard_normal((K, D))
        desc[c] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    valid = np.ones((6, K), bool)
    valid[:, -8:] = False
    xy[~valid] = 0
    desc[~valid] = 0
    return xy, desc, valid


def test_all_pairs_sweep_accept_sets_match():
    xy, desc, valid = _six_view_scene(np.random.default_rng(21))
    cfg = SfMConfig(matching=MatchConfig(max_matches=256),
                    verify=VerifyConfig(ransac_iters=256))
    ref = j_sweep(xy, desc, valid, cfg, chunk_size=8)
    got = t_sweep(*features_from_numpy(xy, desc, valid, "cpu"), cfg, chunk_size=8)
    np.testing.assert_array_equal(got.pairs, ref.pairs)
    acc_r = {tuple(p) for p in ref.pairs[ref.accepted()]}
    acc_g = {tuple(p) for p in got.pairs[got.accepted()]}
    assert acc_g == acc_r and {(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)} <= acc_g
    np.testing.assert_array_equal(got.num_matches, ref.num_matches)
    for p in got.accepted():
        assert abs(int(got.num_inliers[p]) - int(ref.num_inliers[p])) <= 3
        mv = got.match_valid[p]
        np.testing.assert_allclose(got.xy1[p][mv], xy[got.pairs[p, 0]][got.idx1[p][mv]])
    assert len(got.to_records()) == len(acc_g)


def test_sampler_prefix_range():
    valid = torch.zeros(2, 50, dtype=torch.bool)
    valid[0, :30] = True
    valid[1, :9] = True
    g = torch.Generator().manual_seed(0)
    idx = t_sample(valid, 64, 8, g, prefix=True)
    assert idx.shape == (2, 64, 8)
    assert int(idx[0].max()) <= 29 and int(idx[1].max()) <= 8 and int(idx.min()) >= 0
    idx = t_sample(valid, 64, 8, g, prefix=False)
    assert bool(valid.gather(1, idx.reshape(2, -1)).all())
