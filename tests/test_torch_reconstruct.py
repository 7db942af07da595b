"""The port's reconstruct-stage pieces against the JAX package.

PnP (kernel K6's twins, with JAX's own sample indices injected), track
triangulation and reprojection statistics (K7's twins), seed-pair scoring
(K14), view selection, pair rescue, the exporters, and the DLT branch
(``pnp.sample_size`` 6). Scenes are synthetic and numpy-seeded. Tolerances are stated
per test.
"""

import jax
import numpy as np
import pytest
import torch

from torch_parity import n, t

from sfm_tpu.config import SelectConfig
from sfm_tpu.estimators.pnp import pnp_ransac as j_pnp_ransac
from sfm_tpu.estimators.ransac import ransac_sample_indices as j_sample
from sfm_tpu.graph.view_selection import SfMGraphSelector as JSelector
from sfm_tpu.io import export as jexport
from sfm_tpu.matching.sweep import PairTable as JPairTable
from sfm_tpu.matching.sweep import rescue_disconnected as j_rescue
from sfm_tpu.reconstruction.incremental import _reproj_stats as j_reproj_stats
from sfm_tpu.reconstruction.incremental import _triangulate_tracks as j_triangulate
from sfm_tpu.reconstruction.seed import find_best_initial_pair as j_seed
from sfm_tpu_torch import cli
from sfm_tpu_torch.estimators.pnp import pnp_ransac as t_pnp_ransac
from sfm_tpu_torch.graph.view_selection import SfMGraphSelector as TSelector
from sfm_tpu_torch.io import export as texport
from sfm_tpu_torch.matching.pair_table import PairTable as TPairTable
from sfm_tpu_torch.matching.pair_table import rescue_disconnected as t_rescue
from sfm_tpu_torch.reconstruction import incremental as tinc
from sfm_tpu_torch.reconstruction.seed import find_best_initial_pair as t_seed

K = np.array([[1228.0, 0, 512.0], [0, 1228.0, 384.0], [0, 0, 1]], np.float32)


def ring_cameras(C, radius=6.0):
    Rs, ts = [], []
    for k in range(C):
        a = 2 * np.pi * k / C * 0.25                  # a quarter arc
        c = np.array([radius * np.sin(a), 0.3 * (k % 3), -radius * np.cos(a)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        Rs.append(R)
        ts.append(-R @ c)
    return np.stack(Rs).astype(np.float32), np.stack(ts).astype(np.float32)


def project(X, R, tv):
    x = ((R @ X[..., None])[..., 0] + tv) @ K.T
    return x[..., :2] / x[..., 2:]


# ------------------------------------------------------------------------ PnP

def pnp_scene(rng, N=300, n_valid=260, outliers=0.3):
    from scipy.spatial.transform import Rotation

    R = Rotation.from_rotvec(rng.normal(0, 0.2, 3)).as_matrix().astype(np.float32)
    tv = rng.uniform([-0.5, -0.5, 5], [0.5, 0.5, 7], 3).astype(np.float32)
    p3 = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    p2 = (project(p3, R, tv) + rng.normal(0, 0.5, (N, 2))).astype(np.float32)
    out = rng.random(N) < outliers
    p2[out] = rng.uniform([0, 0], [1024, 768], (out.sum(), 2))
    valid = np.arange(N) < n_valid
    return p3 * valid[:, None], p2 * valid[:, None], valid, R, tv


def test_pnp_ransac_with_jax_sample_indices(rng):
    # Tolerance: pose within 1e-3 rad and 1e-3 relative translation, inlier
    # counts within 1 (the f32 P3P roots may come out in another order and
    # the GN refits sum in another order).
    for seed in range(3):
        p3, p2, valid, R_gt, t_gt = pnp_scene(rng)
        key = jax.random.key(seed)
        ref = j_pnp_ransac(key, p3, p2, valid, K, iters=256, threshold=8.0, min_inliers=15,
                           refine_iters=10, sample_size=3)
        idx = np.asarray(j_sample(key, valid, 256, 3, prefix=True))
        got = t_pnp_ransac(t(p3), t(p2), t(valid), t(K), iters=256, threshold=8.0,
                           min_inliers=15, refine_iters=10, sample_size=3,
                           indices=torch.as_tensor(idx).long())
        Rt, Rj = n(got["R"]), np.asarray(ref["R"])
        ang = np.arccos(np.clip((np.trace(Rt.T @ Rj) - 1) / 2, -1, 1))
        assert ang <= 1e-3, ang
        tj = np.asarray(ref["t"])
        assert np.linalg.norm(n(got["t"]) - tj) <= 1e-3 * np.linalg.norm(tj)
        assert abs(int(got["num_inliers"]) - int(ref["num_inliers"])) <= 1
        assert bool(got["ok"]) == bool(ref["ok"])
        np.testing.assert_allclose(n(got["rvec"]), np.asarray(ref["rvec"]), atol=1e-3)
        # And both found the rendered pose.
        assert np.arccos(np.clip((np.trace(Rt.T @ R_gt) - 1) / 2, -1, 1)) < 5e-3


def test_pnp_runs_the_dlt_path(rng):
    # sample_size != 3 takes the DLT branch (held against JAX in
    # tests/test_torch_pnp_dlt.py): drawn samples, finite outputs, the
    # rendered pose found.
    p3, p2, valid, R_gt, _ = pnp_scene(rng)
    out = tinc.pnp_ransac_batch(t(p3)[None], t(p2)[None], t(valid)[None], torch.as_tensor(K),
                                torch.tensor([15]), iters=128, sample_size=6,
                                generator=torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(out[k]).all()) for k in ("R", "rvec", "t"))
    assert bool(out["ok"][0]) and int(out["num_inliers"][0]) > 100
    Rt = n(out["R"][0])
    assert np.arccos(np.clip((np.trace(Rt.T @ R_gt) - 1) / 2, -1, 1)) < 5e-3


# --------------------------------------------------------------- triangulation

def track_table(rng, T=300, V=10, C=10):
    Rs, ts = ring_cameras(C)
    X = rng.uniform(-1, 1, (T, 3)).astype(np.float32)
    view_img = np.full((T, V), -1, np.int32)
    view_xy = np.zeros((T, V, 2), np.float32)
    for r in range(T):
        L = rng.integers(2, V + 1)
        cams = np.sort(rng.choice(C, L, replace=False))
        xy = project(X[r], Rs[cams], ts[cams]) + rng.normal(0, 0.5, (L, 2))
        bad = rng.random(L) < 0.15
        xy[bad] += rng.normal(0, 30, (bad.sum(), 2))
        view_img[r, :L], view_xy[r, :L] = cams, xy
    from sfm_tpu.geometry.rotations import rotation_to_rvec

    rvec = np.asarray(rotation_to_rvec(Rs)).astype(np.float32)
    registered = np.ones(C, bool)
    registered[3] = False
    return view_img, view_xy, view_img >= 0, rvec, ts, registered


@pytest.mark.parametrize("seed_pairs_on,min_parallax", [(False, 0.0), (True, 0.0), (True, 2.0)])
def test_triangulate_tracks(rng, seed_pairs_on, min_parallax):
    # Tolerance: points within 1e-3 relative where both accept; ``ok`` equal
    # except on rows that sit within 1% of a gate (their JAX verdict flips
    # between the gates scaled by 0.99 and by 1.01).
    view_img, view_xy, view_valid, rvec, tvec, registered = track_table(rng)
    T = len(view_img)
    active = rng.random(T) > 0.1
    kw = dict(robust_rounds=1, n_seed=8)

    def jax_run(scale):
        pts, ok = j_triangulate(view_img, view_xy, view_valid, rvec, tvec, registered, K,
                                active, max_err=4.0 * scale,
                                min_parallax_deg=min_parallax * (2 - scale),
                                seed_pairs_on=seed_pairs_on, **kw)
        return np.asarray(pts), np.asarray(ok)

    pj, okj = jax_run(1.0)
    use = t(view_valid) & t(registered)[t(view_img).long().clamp(min=0)]
    pt, okt = tinc.triangulate_tracks(t(view_img), t(view_xy), use, t(active), t(rvec), t(tvec),
                                      t(K), max_err=4.0, min_parallax_deg=min_parallax,
                                      seed_pairs_on=seed_pairs_on, **kw)
    pt, okt = n(pt), n(okt)
    near = jax_run(0.99)[1] != jax_run(1.01)[1]
    assert not ((okt != okj) & ~near).any(), np.nonzero((okt != okj) & ~near)
    both = okt & okj
    assert both.sum() > 0.3 * T
    err = np.linalg.norm(pt - pj, axis=-1) / np.maximum(np.linalg.norm(pj, axis=-1), 1.0)
    assert err[both].max() <= 1e-3


def test_reproj_stats(rng):
    view_img, view_xy, view_valid, rvec, tvec, registered = track_table(rng)
    T = len(view_img)
    pts = rng.uniform(-1, 1, (T, 3)).astype(np.float32)
    pvalid = rng.random(T) > 0.2
    ej, uj = j_reproj_stats(view_img, view_xy, view_valid, rvec, tvec, registered, K, pts,
                            pvalid)
    et, ut = tinc.reproj_stats(t(view_img), t(view_xy), t(view_valid), t(rvec), t(tvec),
                               t(registered), t(K), t(pts), t(pvalid))
    np.testing.assert_array_equal(n(ut), np.asarray(uj))
    np.testing.assert_allclose(n(et), np.asarray(ej), rtol=1e-5, atol=1e-3)


# ------------------------------------------------- pair table: seed, selection

def pair_table(rng, C=6, M=200, cls=JPairTable):
    Rs, ts = ring_cameras(C)
    X = rng.uniform(-1, 1, (M, 3))
    pairs = np.stack(np.triu_indices(C, k=1), -1).astype(np.int32)
    P = len(pairs)
    xy = np.stack([project(X, Rs[c], ts[c]) for c in range(C)]).astype(np.float32)
    f = dict(pairs=pairs, accept=np.ones(P, bool), num_matches=np.zeros(P, np.int32),
             num_inliers=np.zeros(P, np.int32), inlier_ratio=np.zeros(P, np.float32),
             reprojection_error=np.zeros(P, np.float32), well_distributed=np.ones(P, bool),
             F=np.zeros((P, 3, 3), np.float32), xy1=np.zeros((P, M, 2), np.float32),
             xy2=np.zeros((P, M, 2), np.float32), idx1=np.zeros((P, M), np.int32),
             idx2=np.zeros((P, M), np.int32), match_valid=np.zeros((P, M), bool),
             inliers=np.zeros((P, M), bool))
    Kinv = np.linalg.inv(K)
    for p, (i, j) in enumerate(pairs):
        R = Rs[j] @ Rs[i].T
        tv = ts[j] - R @ ts[i]
        ex = np.array([[0, -tv[2], tv[1]], [tv[2], 0, -tv[0]], [-tv[1], tv[0], 0]])
        F = Kinv.T @ ex @ R @ Kinv
        f["F"][p] = F / np.linalg.norm(F)
        m = rng.integers(40, M)
        ids = rng.permutation(M)[:m]
        f["idx1"][p, :m] = f["idx2"][p, :m] = ids
        f["xy1"][p, :m] = xy[i, ids] + rng.normal(0, 0.3, (m, 2))
        f["xy2"][p, :m] = xy[j, ids] + rng.normal(0, 0.3, (m, 2))
        f["match_valid"][p, :m] = True
        f["inliers"][p, :m] = rng.random(m) > 0.1
        f["num_matches"][p] = m
        f["num_inliers"][p] = f["inliers"][p].sum()
        f["inlier_ratio"][p] = f["num_inliers"][p] / m
    # Image 5 ends up pairless; two of its pairs clear the relaxed gates.
    f["accept"][(pairs == 5).any(1)] = False
    return cls(**f), xy


def test_seed_pair_same_row(rng):
    table, _ = pair_table(rng)
    row_j, R_j, t_j, s_j = j_seed(table, K)
    row_t, R_t, t_t, s_t = t_seed(table, K, device="cpu")
    assert row_t == row_j
    np.testing.assert_allclose(R_t, np.asarray(R_j), atol=1e-4)
    np.testing.assert_allclose(t_t, np.asarray(t_j), atol=1e-4)
    assert s_t == pytest.approx(s_j, rel=1e-3)


def test_selection_and_rescue_equal(rng):
    jt, _ = pair_table(rng)
    tt, _ = pair_table(np.random.default_rng(42), cls=TPairTable)
    assert t_rescue(tt, 6, 8, 0.15) == j_rescue(jt, 6, 8, 0.15) == 1
    np.testing.assert_array_equal(tt.accept, jt.accept)
    sel = SelectConfig()
    js, ts_ = JSelector.from_pair_table(jt, select=sel), TSelector.from_pair_table(tt, select=sel)
    for built in ([0], [0, 3], [1, 2, 4], [0, 1, 2, 3, 4]):
        assert ts_.find_next_best_images(built, top_k=6) == js.find_next_best_images(
            built, top_k=6)
    np.testing.assert_allclose(ts_.betweenness_centrality(), js.betweenness_centrality())


# -------------------------------------------------------------------- export

def test_exporters_write_the_same_bytes(rng, tmp_path):
    from sfm_tpu.geometry.rotations import rodrigues

    R = 4
    V = 5
    M = 40
    img = np.full((M, V), -1, np.int32)
    for m in range(M):
        L = rng.integers(1, V + 1)
        img[m, :L] = np.sort(rng.choice([0, 2, 5, 7, 9], L, replace=False))
    result = tinc.ReconstructionResult(
        image_ids=np.array([2, 0, 7, 5], np.int64),
        rotations=np.asarray(rodrigues(rng.normal(0, 1, (R, 3)).astype(np.float32))),
        translations=rng.normal(0, 2, (R, 3)).astype(np.float32),
        intrinsics=np.array([1230.5, 1227.25, 511.0, 385.5], np.float32),
        points3d=rng.normal(0, 3, (M, 3)).astype(np.float32),
        track_ids=np.arange(M, dtype=np.int64), obs_img=img,
        obs_xy=rng.uniform(0, 1000, (M, V, 2)).astype(np.float32),
        stats={"num_cameras": R, "mean_reprojection_error": 0.25})
    outs = {}
    for name, mod in (("jax", jexport), ("port", texport)):
        d = tmp_path / name
        mod.save_reconstruction(result, d / "reconstruction")
        mod.SfMExporter(result=result).export_all(d / "exports")
        outs[name] = d
    files = sorted(p.relative_to(outs["jax"]) for p in outs["jax"].rglob("*")
                   if p.is_file() and p.suffix != ".db")
    assert len(files) >= 12
    for rel in files:
        assert (outs["port"] / rel).read_bytes() == (outs["jax"] / rel).read_bytes(), rel


# ------------------------------------------------------- routes not ported yet

@pytest.mark.parametrize("flag", ["--visualize", "--checkpoint_dir=ck",
                                  "--resume_checkpoint=ck.npz"])
def test_unported_flags_raise(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["--log_dir", str(tmp_path / "logs"), "pipeline", "--data_dir",
                  str(tmp_path), "--device", "cpu", flag])


def test_wrappers_refuse_other_devices():
    from sfm_tpu_torch.estimators.pnp import p3p_solve, pnp_score_select

    m = lambda *s, **k: torch.empty(s, device="meta", **k)
    with pytest.raises(ValueError, match="device"):
        p3p_solve(m(1, 4, 3, 3), m(1, 4, 3, 2))
    with pytest.raises(ValueError, match="device"):
        pnp_score_select(m(1, 4, 3, 3), m(1, 4, 3), m(1, 4, dtype=torch.bool), m(1, 8, 3),
                         m(1, 8, 2), m(1, 8, dtype=torch.bool), m(3, 3), 8.0)
    with pytest.raises(ValueError, match="device"):
        tinc.triangulate_tracks(m(4, 3, dtype=torch.int32), m(4, 3, 2), m(4, 3, dtype=torch.bool),
                                m(4, dtype=torch.bool), m(2, 3), m(2, 3), m(3, 3))
    with pytest.raises(ValueError, match="device"):
        tinc.reproj_stats(m(4, 3, dtype=torch.int32), *([None] * 8))


def test_triangulate_kernel_refuses_too_many_seed_views():
    """K7 holds the seed-pair views in a 32-entry array: more must raise
    before launch, not write past it."""
    m = lambda *s, **k: torch.empty(s, device="meta", **k)
    args = (m(4, 40, dtype=torch.int32), m(4, 40, 2), m(4, 40, dtype=torch.bool),
            m(4, dtype=torch.bool), m(2, 3), m(2, 3), m(3, 3), 4.0, 0.0, 1)
    with pytest.raises(ValueError, match="seed-pair views"):
        tinc.triangulate_tracks_cuda(*args, True, 33)
