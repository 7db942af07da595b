"""K6's P3P round at the main path's full shapes, its selection rule on ties
across the kernel's tiles, its wrappers and the scoring's exact pre-test.

The round is one launch on the card (``csrc/pnp_ransac.cu``'s ``p3p_ransac``:
the samples' solve, the scoring and the winner), held there to the first
design's bits (``tests/bits_report.py``); here its twin
(``p3p_ransac_plain``) is held against the JAX package at path d's shape --
8 registration candidates of 2,048 padded rows with ragged valid prefixes,
2,048 samples each -- with the JAX sampler's indices handed to the port. The
kernel's walk skips a row's divisions and square root when a division-free
test shows that the row cannot count; the margin of that test
(``pnp.pretest_margin``) is held here in float32 emulation against every
rounding of the exact path, fused or not.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n, t
from test_torch_twins import K_NP

from sfm_tpu.estimators.pnp import _p3p_candidates as j_p3p
from sfm_tpu.estimators.ransac import ransac_sample_indices as j_sample
from sfm_tpu.estimators.ransac import ransac_select as j_select
from sfm_tpu.geometry.projection import project as j_project
from sfm_tpu_torch import _kernels
from sfm_tpu_torch.estimators import pnp as tpnp
from sfm_tpu_torch.geometry.projection import project
from sfm_tpu_torch.geometry.rotations import rodrigues

B, N, S, THR = 8, 2048, 2048, 8.0
TILE = tpnp._K6_TILE // 4   # samples a block of the round's kernel
F32 = np.float32


def registration_batch(seed=0, b=B):
    """b candidates of N rows: projections of random points under random
    poses, 0.5 px noise, 30% outliers, a valid prefix of 64..N rows, zeros
    past it."""
    rng = np.random.default_rng(seed)
    R = n(rodrigues(t(rng.normal(0, 0.3, (b, 3)))))
    tv = rng.uniform([-1, -1, 4], [1, 1, 6], (b, 3)).astype(F32)
    p3 = rng.uniform(-2, 2, (b, N, 3)).astype(F32)
    cam = np.einsum("bij,bnj->bni", R, p3) + tv[:, None]
    p2 = (cam[..., :2] / cam[..., 2:]) * K_NP[0, 0] + K_NP[:2, 2]
    p2 = (p2 + rng.normal(0, 0.5, p2.shape)).astype(F32)
    out = rng.random((b, N)) < 0.3
    p2[out] = rng.uniform([0, 0], [1024, 768], (out.sum(), 2))
    valid = np.arange(N)[None] < rng.integers(64, N + 1, (b, 1))
    return p3 * valid[..., None], p2 * valid[..., None], valid


def normalized(p2):
    return (np.concatenate([p2, np.ones_like(p2[..., :1])], -1)
            @ np.linalg.inv(K_NP).T.astype(F32))[..., :2].astype(F32)


@pytest.fixture(scope="module")
def round_at_path_d_shape():
    p3, p2, valid = registration_batch()
    pn = normalized(p2)
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    idx = np.stack([np.asarray(j_sample(keys[b], jnp.asarray(valid[b]), S, 3, prefix=True))
                    for b in range(B)]).astype(np.int64)
    got = tpnp.p3p_ransac_plain(t(p3), t(pn), t(p2), t(valid), torch.as_tensor(idx), t(K_NP),
                                THR)

    @jax.jit
    def ref(p3b, pnb, p2b, vb, ib):
        Rs, ts, ok = jax.vmap(j_p3p)(p3b[ib], pnb[ib])
        Rs, ts, ok = Rs.reshape(-1, 3, 3), ts.reshape(-1, 3), ok.reshape(-1)
        proj, depth = jax.vmap(j_project, in_axes=(None, 0, 0, None))(p3b, Rs, ts,
                                                                      jnp.asarray(K_NP))
        err = jnp.linalg.norm(proj - p2b[None], axis=-1)
        err = jnp.where((depth > 0) & ok[:, None], err, jnp.inf)
        inl = (err < THR) & vb[None]
        cnt = inl.sum(-1)
        score = cnt - jnp.where(inl, err, 0.0).sum(-1) / jnp.maximum(cnt, 1) / THR
        best, _, count = j_select(err, vb, THR)
        return Rs, ts, ok, score, cnt, best, count

    refs = [ref(*(jnp.asarray(x[b]) for x in (p3, pn, p2, valid, idx))) for b in range(B)]
    return got, [[np.asarray(r) for r in rb] for rb in refs]


def test_p3p_round_twin_against_jax_at_the_registration_shape(round_at_path_d_shape):
    # float32 Durand-Kerner from the same samples in two frameworks: an
    # ill-conditioned sample's roots move with rounding and may change
    # slots, so, as chip_smoke's K6 phase holds the kernel against this twin:
    # the count of poses within 1% of JAX's (measured <= 0.3%), the same
    # masks slot by slot on >= 99% of the 8,192 hypotheses a candidate
    # (measured >= 99.3%), and in >= 90% of the samples every pose of either
    # side has one on the other within 1e-2 (R, and t relative to max(1,
    # |t|); measured 94-96%). The winner: the port's pick scores within 1e-3
    # of JAX's best under JAX's own scores (a tie up to the error sum's
    # order; measured: the same winner in 7 of 8, a tie in the 8th), and its
    # count within 2 of JAX's (measured equal).
    got, refs = round_at_path_d_shape
    Rs, ts, ok = (n(got[k]) for k in ("Rs", "ts", "ok"))
    for b, (Rj, tj, okj, score, cnt, best, count) in enumerate(refs):
        assert abs(int(ok[b].sum()) - int(okj.sum())) <= 0.01 * okj.sum()
        assert (ok[b] == okj).mean() >= 0.99
        Rk, Rp = Rs[b].reshape(S, 4, 9), Rj.reshape(S, 4, 9)
        tk, tp = ts[b].reshape(S, 4, 3), tj.reshape(S, 4, 3)
        okk, okp = ok[b].reshape(S, 4), okj.reshape(S, 4)
        d = (np.abs(Rk[:, :, None] - Rp[:, None]).max(-1)
             + np.abs(tk[:, :, None] - tp[:, None]).max(-1)
             / np.maximum(np.abs(tp[:, None]).max(-1), 1.0))           # (S, 4 port, 4 JAX)
        dk = np.where(okp[:, None, :], d, np.inf).min(-1)
        dp = np.where(okk[:, :, None], d, np.inf).min(-2)
        agree = (np.where(okk, dk <= 1e-2, True).all(-1)
                 & np.where(okp, dp <= 1e-2, True).all(-1)).mean()
        assert agree >= 0.9, agree
        pick = int(got["best"][b])
        assert score[pick] >= score[int(best)] - 1e-3, (b, pick, int(best))
        assert abs(int(got["count"][b]) - int(count)) <= 2


TIES = {
    # Tiles 1.. are copies of tile 0's samples: every hypothesis ties with one
    # in each later tile; the winner lies in tile 0.
    "copies_of_tile_0": lambda idx: idx[:, :TILE].repeat(1, S // TILE, 1),
    # Tile 3 copied into tile 1: the later tile's best ties with its copy.
    "tile_3_into_tile_1": lambda idx: torch.cat(
        [idx[:, :TILE], idx[:, 3 * TILE:4 * TILE], idx[:, 2 * TILE:]], 1),
    # One sample throughout: hypotheses 4s + k tie for each root k.
    "one_sample": lambda idx: idx[:, 5:6].expand(-1, S, -1),
}


@pytest.mark.parametrize("case", sorted(TIES))
def test_p3p_round_ties_across_tiles_go_to_the_lowest_index(case):
    # ransac_select's rule: the highest score, then the lowest index. The
    # kernel's tiles each keep their best and the candidate's last tile picks
    # among them; the twin takes torch.argmax over all hypotheses at once.
    # Both must name the lowest index of the tied winners.
    p3, p2, valid = (x[:3] for x in registration_batch(seed=5))
    rng = np.random.default_rng(6)
    base = torch.as_tensor((rng.random((3, S, 3)) * valid.sum(1)[:, None, None]).astype(np.int64))
    idx = TIES[case](base).contiguous()
    got = tpnp.p3p_ransac_plain(t(p3), t(normalized(p2)), t(p2), t(valid), idx, t(K_NP), THR)
    Rs, ts, ok = got["Rs"], got["ts"], got["ok"]
    proj, depth = project(t(p3)[:, None], Rs[:, :, None], ts[:, :, None], t(K_NP))
    err = torch.linalg.vector_norm(proj - t(p2)[:, None], dim=-1)
    inl = (err < THR) & (depth > 0) & ok[..., None] & t(valid)[:, None]
    cnt = inl.sum(-1)
    score = cnt.float() - torch.where(inl, err, 0.0).sum(-1) / cnt.clamp(min=1) / THR
    ties = {"copies_of_tile_0": S // TILE, "one_sample": S}.get(case, 1)
    for b in range(3):
        top = torch.nonzero(score[b] == score[b].max()).flatten()
        assert len(top) >= ties
        assert int(got["best"][b]) == int(top.min())
        assert int(got["count"][b]) == int(cnt[b, top.min()])
    if case == "copies_of_tile_0":
        assert (n(got["best"]) < 4 * TILE).all()
    if case == "one_sample":
        assert (n(got["best"]) < 4).all()


def _record_launch(monkeypatch):
    calls = []
    monkeypatch.setattr(_kernels, "launch", lambda name, dev, *a: calls.append((name, a)))
    return calls


@pytest.mark.parametrize("samples", [2048, 8192, 33])
def test_p3p_ransac_wrapper_launch_arguments(monkeypatch, samples):
    # One launch a round: B, S, N as given, the threshold with the pre-test's
    # margin, the outputs (every hypothesis's pose and mask, the winner and
    # its count), a part of three ints a tile and the zeroed tickets.
    calls = _record_launch(monkeypatch)
    Bq = 3
    z = lambda *s, **k: torch.zeros(s, **k)
    idx = z(Bq, samples, 3, dtype=torch.int64)
    out = tpnp.p3p_ransac_cuda(z(Bq, N, 3), z(Bq, N, 2), z(Bq, N, 2),
                               z(Bq, N, dtype=torch.bool), idx, t(K_NP), THR)
    (name, a), = calls
    assert name == "p3p_ransac"
    assert a[0] is idx and a[6:9] == (Bq, samples, N)
    assert a[9:12] == (THR, *tpnp.pretest_margin(THR))
    tiles = -(-4 * samples // tpnp._K6_TILE)
    Rs, ts, ok, part, tickets, best, count = a[12:]
    assert tuple(Rs.shape) == (Bq, 4 * samples, 3, 3) and tuple(ts.shape) == (Bq, 4 * samples, 3)
    assert ok.dtype == torch.bool and tuple(ok.shape) == (Bq, 4 * samples)
    assert part.dtype == torch.int32 and tuple(part.shape) == (Bq, tiles, 3)
    assert tickets.dtype == torch.int32 and tickets.numel() >= Bq and not tickets.any()
    assert best.dtype == count.dtype == torch.int32 and tuple(best.shape) == (Bq,)
    assert out["Rs"] is Rs and out["best"].dtype == torch.int64


def test_pnp_score_select_wrapper_launch_arguments(monkeypatch):
    # The DLT branch's scoring: hypotheses given, the same walk and winner.
    calls = _record_launch(monkeypatch)
    Bq, H = 2, 2048
    z = lambda *s, **k: torch.zeros(s, **k)
    tpnp.pnp_score_select_cuda(z(Bq, H, 3, 3), z(Bq, H, 3), z(Bq, H, dtype=torch.bool),
                               z(Bq, N, 3), z(Bq, N, 2), z(Bq, N, dtype=torch.bool), t(K_NP), 2.5)
    (name, a), = calls
    assert name == "pnp_score_select" and a[7:10] == (Bq, H, N)
    assert a[10:13] == (2.5, *tpnp.pretest_margin(2.5))
    assert tuple(a[13].shape) == (Bq, H // tpnp._K6_TILE, 3) and not a[14].any()


def test_pnp_ransac_batch_runs_one_round_call(monkeypatch):
    # The P3P branch hands the drawn samples to p3p_ransac once (on the card
    # one launch, no torch gathers of the sample rows) and no scoring call.
    seen = []
    real = tpnp.p3p_ransac

    def record(*a):
        seen.append(a)
        return real(*a)

    monkeypatch.setattr(tpnp, "p3p_ransac", record)
    monkeypatch.setattr(tpnp, "pnp_score_select", lambda *a: pytest.fail("scoring called"))
    p3, p2, valid = (x[:2] for x in registration_batch(seed=2))
    idx = torch.as_tensor(np.random.default_rng(3).integers(0, 64, (2, 64, 3)))
    out = tpnp.pnp_ransac_batch(t(p3), t(p2), t(valid), t(K_NP), torch.full((2,), 15),
                                iters=64, threshold=THR, indices=idx)
    (a,) = seen
    pts3d, pn, pts2d, vq, iq, K, thr = a
    assert iq.dtype == torch.int64 and torch.equal(iq, idx) and thr == THR
    np.testing.assert_allclose(n(pn), normalized(p2), rtol=1e-6, atol=1e-6)
    assert out["ok"].all()


def test_new_wrappers_refuse_devices_and_shapes():
    m = lambda *s, **k: torch.empty(s, device="meta", **k)
    b8, i64 = torch.bool, torch.int64
    with pytest.raises(ValueError, match="device"):
        tpnp.p3p_ransac(m(1, 8, 3), m(1, 8, 2), m(1, 8, 2), m(1, 8, dtype=b8),
                        m(1, 4, 3, dtype=i64), m(3, 3), 8.0)
    with pytest.raises(ValueError, match="exceeds"):
        tpnp.p3p_ransac_cuda(m(1, 8193, 3), m(1, 8193, 2), m(1, 8193, 2),
                             m(1, 8193, dtype=b8), m(1, 4, 3, dtype=i64), m(3, 3), 8.0)
    with pytest.raises(ValueError, match="exceeds"):
        tpnp.pnp_score_select_cuda(m(1, 4, 3, 3), m(1, 4, 3), m(1, 4, dtype=b8), m(1, 8193, 3),
                                   m(1, 8193, 2), m(1, 8193, dtype=b8), m(3, 3), 8.0)
    with pytest.raises(TypeError, match="indices"):
        z = torch.zeros
        tpnp.p3p_ransac_cuda(z(1, 16, 3), z(1, 16, 2), z(1, 16, 2), torch.ones(1, 16, dtype=b8),
                             z(1, 4, 3, dtype=torch.int32), t(K_NP), 8.0)


# ----------------------------------------------------------- the pre-test


def fma32(a, b, c):
    """float32 fma(a, b, c), rounded once: the product is exact in float64,
    the sum's low part (TwoSum) decides a float64 sum that lands half-way
    between two floats."""
    a, b, c = (np.asarray(v, F32).astype(np.float64) for v in (a, b, c))
    with np.errstate(all="ignore"):
        p = a * b
        s = p + c
        bb = s - p
        low = (p - (s - bb)) + (c - bb)
        r = s.astype(F32)
        r64 = r.astype(np.float64)
        other = np.nextafter(r, np.where(s > r64, F32(np.inf), F32(-np.inf)))
        tie = np.isfinite(s) & (s != r64) & (s == (r64 + other.astype(np.float64)) / 2) & (low != 0)
        return np.where(tie, np.where(low > 0, np.maximum(r, other), np.minimum(r, other)), r)


def exact_counts(x, y, d, uo, vo, k4, thr, variant):
    """The first design's row test, float32: sfm_project's u, v, then
    sqrt(du^2 + dv^2) < thr and depth > 0, the sum of squares unfused or as
    either fma."""
    fx, fy, cx, cy = (F32(v) for v in k4)
    with np.errstate(all="ignore"):
        z = np.where(np.abs(d) < F32(1e-12), F32(1e-12), d)
        du = ((fx * x) / z + cx) - uo
        dv = ((fy * y) / z + cy) - vo
        s = {"unfused": du * du + dv * dv, "fma_u": fma32(du, du, dv * dv),
             "fma_v": fma32(dv, dv, du * du)}[variant]
        return (d > 0) & (np.sqrt(s) < F32(thr))


def pretest_rejects(x, y, d, uo, vo, k4, thr):
    """The kernel's pre-test as it computes it (pnp_ransac.cu's walk)."""
    thr_pre, kap = tpnp.pretest_margin(thr)
    fx, fy, cx, cy = (F32(v) for v in k4)
    kap, thr_pre = F32(kap), F32(thr_pre)
    with np.errstate(all="ignore"):
        z = np.where(np.abs(d) < F32(1e-12), F32(1e-12), d)
        need = d > 0
        for f, c, w, o in ((fx, cx, x, uo), (fy, cy, y, vo)):
            a = f * w
            T = fma32(kap, np.abs(c) + np.abs(o), thr_pre)
            need &= ~(np.abs(fma32(c - o, z, a)) > fma32(kap, np.abs(a), T * z))
        return ~need


def ulps(v, k):
    """v moved by k (an array of -8..8) float32 units in the last place."""
    out = np.asarray(v, F32).copy()
    to = np.where(k > 0, F32(np.inf), F32(-np.inf))
    for j in range(int(np.abs(k).max(initial=0))):
        out = np.where(np.abs(k) > j, np.nextafter(out, to), out)
    return out


def near_threshold_rows(rng, m, thr, k4, u_scale, depth):
    """Rows whose exact error lies within a few float32 units of thr: the
    observation placed thr (split between u and v at a random angle) away
    from the float64 projection, then nudged by -8..8 units."""
    fx, fy, cx, cy = k4
    d = depth(rng, m).astype(F32)
    u = rng.uniform(-u_scale, u_scale, m)
    v = rng.uniform(-u_scale, u_scale, m)
    x = ((u - cx) * d / fx).astype(F32)
    y = ((v - cy) * d / fy).astype(F32)
    z = np.where(np.abs(d) < 1e-12, 1e-12, d).astype(np.float64)
    u64 = fx * x.astype(np.float64) / z + cx
    v64 = fy * y.astype(np.float64) / z + cy
    ang = rng.choice([0.0, np.pi / 2, np.pi, 3 * np.pi / 2], m) + rng.normal(0, 0.3, m) * (
        rng.random(m) < 0.5)
    uo = (u64 + thr * np.cos(ang)).astype(F32)
    vo = (v64 + thr * np.sin(ang)).astype(F32)
    k = rng.integers(-8, 9, m)
    uo = np.where(rng.random(m) < 0.5, ulps(uo, k), uo).astype(F32)
    vo = np.where(rng.random(m) < 0.5, ulps(vo, -k), vo).astype(F32)
    return x, y, d, uo, vo


FAMILIES = {
    # A registration's depths and image extent.
    "near_thr": lambda rng, m, thr, k4: near_threshold_rows(
        rng, m, thr, k4, 1200.0, lambda r, q: r.uniform(0.5, 50.0, q)),
    # Projections and observations up to ~10^4 px from the centre.
    "large_u": lambda rng, m, thr, k4: near_threshold_rows(
        rng, m, thr, k4, 1.2e4, lambda r, q: r.uniform(0.01, 500.0, q)),
    # Depths at and around the 1e-12 clamp (positive: a depth <= 0 never counts).
    "z_at_the_clamp": lambda rng, m, thr, k4: near_threshold_rows(
        rng, m, thr, k4, 1200.0, lambda r, q: r.choice(
            [1e-13, 5e-13, 1e-12, 1.0000001e-12, 2e-12, 1e-11, 1e-9], q)),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("thr", [8.0, 2.5])
@pytest.mark.parametrize("k4", [(1228.0, 1228.0, 512.0, 384.0), (3100.0, 2900.0, 0.0, -4000.0)])
def test_pretest_never_rejects_a_row_the_exact_path_counts(family, thr, k4):
    rng = np.random.default_rng(zlib.crc32(f"{family} {thr} {k4}".encode()))
    rows = FAMILIES[family](rng, 4000, thr, k4)
    rejected = pretest_rejects(*rows, k4, thr)
    counted = {v: exact_counts(*rows, k4, thr, v) for v in ("unfused", "fma_u", "fma_v")}
    for v, c in counted.items():
        assert not (rejected & c).any(), (v, np.nonzero(rejected & c)[0][:5])
    # The family straddles the threshold: both outcomes occur.
    assert counted["unfused"].any() and (~counted["unfused"]).any()


def test_pretest_rejects_far_rows_and_sends_non_finite_rows_on():
    # Far rows (a random hypothesis's projections) are rejected; NaN, an
    # infinite or overflowing coordinate and a depth <= 0 are never counted
    # by the exact path, and a NaN never passes the pre-test's compare.
    k4 = (1228.0, 1228.0, 512.0, 384.0)
    rng = np.random.default_rng(7)
    m = 20000
    d = rng.uniform(0.5, 20, m).astype(F32)
    x, y = (rng.uniform(-3, 3, m).astype(F32) for _ in range(2))
    uo, vo = rng.uniform(0, 1024, m).astype(F32), rng.uniform(0, 768, m).astype(F32)
    rejected = pretest_rejects(x, y, d, uo, vo, k4, THR)
    counted = exact_counts(x, y, d, uo, vo, k4, THR, "unfused")
    assert not (rejected & counted).any()
    assert rejected.mean() > 0.99
    inf, nan = F32(np.inf), F32(np.nan)
    odd = [  # x, y, d, uo, vo
        (nan, 0, 1, 512, 384), (0, 0, nan, 512, 384), (0, 0, 1, nan, 384),
        (inf, 0, 1, 512, 384), (0, 0, inf, 512, 384), (0, 0, 1, inf, 384),
        (3e38, 0, 1, 512, 384), (0, 0, 1, 3.3e38, 384), (0, 0, -1, 512, 384), (0, 0, 0, 512, 384),
        (0, 0, 3e38, 515, 384), (1e-3, 0, 3e38, 512, 384)]
    cols = [np.array(c, F32) for c in zip(*odd)]
    rejected = pretest_rejects(*cols, k4, THR)
    for v in ("unfused", "fma_u", "fma_v"):
        assert not (rejected & exact_counts(*cols, k4, THR, v)).any()
    # A depth of 3e38 with the observation at the centre counts; the pre-test
    # must let it through.
    assert exact_counts(*cols, k4, THR, "unfused")[-2:].all() and not rejected[-2:].any()


def test_pretest_margin():
    # thr_pre: the float32 at or above thr (1 + 2^-20), kap 2^-20; outside
    # 1e-6 <= thr <= 1e30 the pre-test is off (thr_pre = inf).
    for thr in (8.0, 2.5, 1e-5, 3.0, 1e29):
        pre, kap = tpnp.pretest_margin(thr)
        assert kap == 2.0 ** -20 and F32(pre) == pre
        assert pre >= float(F32(thr)) * (1 + 2.0 ** -20)
        assert float(np.nextafter(F32(pre), F32(0))) < float(F32(thr)) * (1 + 2.0 ** -20)
    for thr in (0.0, 1e-7, float("nan"), float("inf"), 1e31):
        assert tpnp.pretest_margin(thr)[0] == float("inf")
