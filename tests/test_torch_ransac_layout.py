"""K2's F-RANSAC and K6's ``pnp_refine`` at the main path's full shapes.

The redesigned kernels (``csrc/fmat_ransac.cu``: one launch a sweep chunk,
tiles of 64 hypotheses; ``csrc/pnp_refine.cu``: a cluster of 8 blocks a
candidate) keep the first design's arithmetic, so the card holds them to
the parent's bits (``tests/bits_report.py``); here their twins are held
against the JAX package at the shapes path d gives them -- a 32-pair chunk
of 1,024 rows with 512 hypotheses scored on the first 256, and 8
registration candidates of 2,048 padded rows -- on numpy-seeded inputs with
the JAX sampler's indices handed to the port. Then the selection rule on
ties planted across the kernel's tiles, and the wrappers' launch arguments
and refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n, t
from test_torch_twins import K_NP, jax_pnp_refit, rot_angle

from sfm_tpu.estimators.ransac import ransac_sample_indices as j_sample
from sfm_tpu.estimators.ransac import ransac_select as j_select
from sfm_tpu.geometry.epipolar import eight_point as j_eight_point
from sfm_tpu.geometry.epipolar import symmetric_epipolar_distance as j_sym
from sfm_tpu.matching.verify import verify_pair as j_verify
from sfm_tpu_torch import _kernels
from sfm_tpu_torch.estimators import fundamental as tfm
from sfm_tpu_torch.estimators import pnp as tpnp
from sfm_tpu_torch.geometry.epipolar import symmetric_epipolar_distance
from sfm_tpu_torch.geometry.rotations import rodrigues

B, M, H, BUDGET, THR = 32, 1024, 512, 256, 3.0
TILE = tfm._K2_TILE   # csrc/fmat_ransac.cu's hypotheses a block


def sweep_chunk(seed=0):
    """B match tables of M rows, best-first: projections of random points into
    two cameras, 0.5 px noise, 30% outliers, a valid prefix of 300..M rows,
    zeros past it."""
    rng = np.random.default_rng(seed)
    p1 = np.zeros((B, M, 2), np.float32)
    p2 = np.zeros((B, M, 2), np.float32)
    valid = np.zeros((B, M), bool)
    for b in range(B):
        X = rng.uniform([-2, -2, 4], [2, 2, 8], (M, 3))
        a = rng.uniform(0.05, 0.3)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        tv = np.array([rng.uniform(0.3, 1.0), 0.05, 0.1])
        for dst, (Rc, tc) in ((p1, (np.eye(3), np.zeros(3))), (p2, (R, tv))):
            x = (X @ Rc.T + tc) @ K_NP.T
            dst[b] = x[:, :2] / x[:, 2:] + rng.normal(0, 0.5, (M, 2))
        out = rng.random(M) < 0.3
        p2[b, out] = rng.uniform([0, 0], [1024, 768], (out.sum(), 2))
        valid[b, : rng.integers(300, M + 1)] = True
    return p1 * valid[..., None], p2 * valid[..., None], valid


@pytest.fixture(scope="module")
def chunk():
    p1, p2, valid = sweep_chunk()
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    idx = np.stack([np.asarray(j_sample(keys[b], jnp.asarray(valid[b]), H, 8, prefix=True))
                    for b in range(B)]).astype(np.int64)
    got = tfm.fmat_ransac_plain(t(p1), t(p2), t(valid), torch.as_tensor(idx), THR, BUDGET)
    return p1, p2, valid, idx, keys, got


def test_k2_winners_match_jax_at_the_sweep_shape(chunk):
    # The winner of every pair exactly, and its count: JAX's hypotheses from
    # the same samples, scored on the first 256 rows by ransac_select.
    p1, p2, valid, idx, _, got = chunk
    hyp = jax.vmap(jax.vmap(lambda a, b: j_eight_point(a, b, enforce_rank2=False, null_iters=3,
                                                       null_fallback=False)))
    rows = np.arange(B)[:, None, None]
    Fs = hyp(jnp.asarray(p1[rows, idx]), jnp.asarray(p2[rows, idx]))
    errs = jax.vmap(jax.vmap(j_sym, in_axes=(0, None, None)))(
        Fs, jnp.asarray(p1[:, :BUDGET]), jnp.asarray(p2[:, :BUDGET]))
    best, _, count = jax.vmap(j_select, in_axes=(0, 0, None))(
        errs, jnp.asarray(valid[:, :BUDGET]), THR)
    np.testing.assert_array_equal(n(got["best"]), np.asarray(best))
    # The winner's count within 2: its F differs in the last bits between the
    # packages, and a row on the threshold may flip.
    assert np.abs(n(got["count"]) - np.asarray(count)).max() <= 2


def test_k2_refit_and_gates_match_jax_verify_pair_at_the_sweep_shape(chunk):
    # verify_pair on the same keys draws the same samples. Gates equal on
    # every pair; inliers equal on >= 99.9% of the rows (a row on the
    # threshold may flip with the refit's last bits). F: the refit's f32 null
    # vector moves by ~eps lambda_max / lambda_2 of the weighted 9x9 normal
    # matrix, which reaches ~1e-3 on these corridor-like pairs (and 0.17 for
    # JAX's on one of them), so both are held against the float64 refit from
    # the same winner: the port's F (sign-aligned) within max(2e-3, 3x JAX's
    # distance) on every accepted pair.
    p1, p2, valid, idx, keys, got = chunk
    ref = jax.vmap(lambda k, a, b, v: j_verify(k, a, b, v, ransac_iters=H, prefix_valid=True,
                                               score_budget=BUDGET))(
        keys, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid))
    for k in ("accept", "well_distributed", "num_matches"):
        np.testing.assert_array_equal(n(got[k]), np.asarray(ref[k]), err_msg=k)
    assert n(got["accept"]).sum() >= B - 2
    inl, inl_ref = n(got["inliers"]), np.asarray(ref["inliers"])
    assert (inl == inl_ref).mean() >= 0.999
    assert np.abs(n(got["num_inliers"]) - np.asarray(ref["num_inliers"])).max() <= 2
    acc = n(got["accept"])
    f64 = tfm.fmat_refit_verify_plain(got["Fs"].double(), got["best"], t(p1).double(),
                                      t(p2).double(), t(valid), THR)
    Fd = n(f64["F"])[acc]
    dist = lambda F: np.minimum(np.abs(F - Fd).reshape(-1, 9).max(1),
                                np.abs(F + Fd).reshape(-1, 9).max(1))
    d_port, d_jax = dist(n(got["F"])[acc]), dist(np.asarray(ref["F"])[acc])
    assert (d_port <= np.maximum(2e-3, 3 * d_jax)).all(), (d_port, d_jax)


TIES = {
    # Tiles 1-3 of pairs 0-3 are copies of tile 0: every hypothesis ties with
    # three others, one in each later tile.
    "copies_of_tile_0": lambda idx: idx[:4, :TILE].repeat(1, H // TILE, 1),
    # Tile 3 copied into tile 1: the later tile's best ties with its copy.
    "tile_3_into_tile_1": lambda idx: torch.cat(
        [idx[:4, :TILE], idx[:4, 3 * TILE:4 * TILE], idx[:4, 2 * TILE:]], 1),
    # One sample 512 times: every hypothesis ties, hypothesis 0 wins.
    "one_sample": lambda idx: idx[:4, 5:6].expand(-1, H, -1),
}


@pytest.mark.parametrize("case", sorted(TIES))
def test_k2_ties_across_tiles_go_to_the_lowest_index(case):
    # ransac_select's rule: the highest score, then the lowest index. The
    # kernel's tiles each keep their best and the pair's last tile picks among
    # them; the twin scores the whole (H, N) matrix at once. Both must name the
    # lowest index of the tied winners.
    p1, p2, valid = (x[:4] for x in sweep_chunk(seed=3))
    rng = np.random.default_rng(4)
    n_valid = valid.sum(1)
    base = torch.as_tensor((rng.random((4, H, 8)) * n_valid[:, None, None]).astype(np.int64))
    idx = TIES[case](base).contiguous()
    got = tfm.fmat_ransac_plain(t(p1), t(p2), t(valid), idx, THR, BUDGET)
    errs = symmetric_epipolar_distance(got["Fs"], t(p1[:, :BUDGET])[:, None],
                                       t(p2[:, :BUDGET])[:, None])
    inl = (errs < THR) & t(valid[:, :BUDGET])[:, None]
    cnt = inl.sum(-1)
    score = cnt.float() - torch.where(inl, errs, 0.0).sum(-1) / cnt.clamp(min=1) / THR
    ties = {"copies_of_tile_0": H // TILE, "one_sample": H}.get(case, 1)
    for b in range(4):
        top = torch.nonzero(score[b] == score[b].max()).flatten()
        assert len(top) >= ties
        assert int(got["best"][b]) == int(top.min())
        assert int(got["count"][b]) == int(cnt[b, top.min()])
    if case == "one_sample":
        assert (n(got["best"]) == 0).all()
    if case == "copies_of_tile_0":
        assert (n(got["best"]) < TILE).all()


def test_pnp_refine_twin_matches_jax_at_the_registration_shape():
    # 8 candidates of 2,048 rows with a padded tail (valid prefixes of
    # 1,024-2,048 rows), one gated off: R within 1e-4 rad, t within 1e-4 |t|,
    # inliers equal (LU on both sides; the kernel's Cholesky is held to the
    # parent's bits on the card).
    rng = np.random.default_rng(31)
    Bp, Np = 8, 2048
    R = n(rodrigues(t(rng.normal(0, 0.3, (Bp, 3)))))
    tv = rng.uniform([-1, -1, 4], [1, 1, 6], (Bp, 3)).astype(np.float32)
    p3 = rng.uniform(-2, 2, (Bp, Np, 3)).astype(np.float32)
    cam = np.einsum("bij,bnj->bni", R, p3) + tv[:, None]
    p2 = (cam[..., :2] / cam[..., 2:]) * K_NP[0, 0] + K_NP[:2, 2]
    p2 = (p2 + rng.normal(0, 0.5, p2.shape)).astype(np.float32)
    out = rng.random((Bp, Np)) < 0.3
    p2[out] = rng.uniform([0, 0], [1024, 768], (out.sum(), 2))
    valid = np.arange(Np)[None] < rng.integers(Np // 2, Np + 1, (Bp, 1))
    p3[~valid], p2[~valid] = 0.0, 0.0
    R0 = (n(rodrigues(t(rng.normal(0, 0.006, (Bp, 3))))) @ R).astype(np.float32)
    t0 = (tv * (1 + rng.normal(0, 0.01, (Bp, 3)))).astype(np.float32)
    ok0 = np.ones(Bp, bool)
    ok0[5] = False
    got = tpnp.pnp_refine_plain(t(R0), t(t0), t(ok0), t(p3), t(p2), t(valid), t(K_NP), 8.0,
                                torch.full((Bp,), 15), 10)
    for b in range(Bp):
        Rj, tj, inl = jax_pnp_refit(R0[b], t0[b], p3[b], p2[b], valid[b], ok0[b])
        assert rot_angle(n(got["R"][b]), Rj) <= 1e-4
        assert np.linalg.norm(n(got["t"][b]) - n(tj)) <= 1e-4 * np.linalg.norm(n(tj))
        np.testing.assert_array_equal(n(got["inliers"][b]), n(inl))
        assert not n(got["inliers"][b])[~valid[b]].any()
    assert n(got["ok"]).all()


def _record_launch(monkeypatch):
    calls = []
    monkeypatch.setattr(_kernels, "launch", lambda name, dev, *a: calls.append((name, a)))
    return calls


@pytest.mark.parametrize("budget,n_scored", [(256, 256), (0, 1024), (2048, 1024)])
def test_fmat_ransac_wrapper_launch_arguments(monkeypatch, budget, n_scored):
    # One launch a chunk: the scoring rows min(budget, N) (all of them for 0),
    # a zeroed work tensor of a ticket and three ints a tile a pair, and the
    # thirteen outputs in the kernel's order.
    calls = _record_launch(monkeypatch)
    p1, p2, valid = (t(x) for x in sweep_chunk(seed=1))
    idx = torch.zeros((B, H, 8), dtype=torch.int64)
    out = tfm.fmat_ransac_cuda(p1, p2, valid, idx, THR, budget)
    (name, a), = calls
    assert name == "fmat_ransac"
    assert a[4:9] == (B, H, M, n_scored, H // TILE)
    work = a[14]
    assert work.dtype == torch.int32 and tuple(work.shape) == (B, 1 + 3 * (H // TILE))
    assert not work.any()
    assert list(a[15:]) == list(out.values())
    assert tuple(out["Fs"].shape) == (B, H, 3, 3) and out["best"].dtype == torch.int64


def test_new_wrappers_refuse_devices_and_shapes():
    m = lambda *s, **k: torch.empty(s, device="meta", **k)
    b8, i64 = torch.bool, torch.int64
    with pytest.raises(ValueError, match="device"):
        tfm.fmat_ransac(m(2, 9, 2), m(2, 9, 2), m(2, 9, dtype=b8), m(2, 4, 8, dtype=i64), 3.0)
    with pytest.raises(ValueError, match="exceeds"):
        tfm.fmat_ransac_cuda(m(1, 1025, 2), m(1, 1025, 2), m(1, 1025, dtype=b8),
                             m(1, 4, 8, dtype=i64), 3.0)
    with pytest.raises(ValueError, match="exceeds"):
        tpnp.pnp_refine_cuda(m(1, 3, 3), m(1, 3), m(1, dtype=b8), m(1, 8193, 3), m(1, 8193, 2),
                             m(1, 8193, dtype=b8), m(3, 3), 8.0, 15)
    with pytest.raises(TypeError, match="indices"):
        p = torch.zeros(1, 16, 2)
        tfm.fmat_ransac_cuda(p, p, torch.ones(1, 16, dtype=b8),
                             torch.zeros(1, 4, 8, dtype=torch.int32), 3.0)


def test_pnp_refine_wrapper_launch_arguments(monkeypatch):
    # One launch for the candidates: B and N as given, the gates as int32.
    calls = _record_launch(monkeypatch)
    Bp, Np = 8, 2048
    z = lambda *s, **k: torch.zeros(s, **k)
    tpnp.pnp_refine_cuda(z(Bp, 3, 3), z(Bp, 3), z(Bp, dtype=torch.bool), z(Bp, Np, 3),
                         z(Bp, Np, 2), z(Bp, Np, dtype=torch.bool), t(K_NP), 8.0, 15, 10)
    (name, a), = calls
    assert name == "pnp_refine" and a[7:10] == (Bp, Np, 8.0) and a[11] == 10
    assert a[10].dtype == torch.int32 and tuple(a[10].shape) == (Bp,)
