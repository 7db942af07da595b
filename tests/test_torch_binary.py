"""Parity of the port's binary (FAST + steered BRIEF) frontend with
``sfm_tpu.features.binary``, and the frontend's own cases.

Inputs are made from numpy seeds and handed to both packages. On the CPU the
port's K12 wrappers (``fast_nms``, ``orb_blur``, ``orb_describe``) and K4's
selection run their plain twins, so these tests pin the twins -- the oracles
the CUDA kernels are held to on the card -- to the JAX reference. The last
test runs ``python -m sfm_tpu_torch pipeline --feature_kind orb`` on the
rendered corridor of ``tests/test_torch_slice.py``.
"""
import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n, render_scene, t, textured_image

from sfm_tpu.config import FeatureConfig as JFeatureConfig
from sfm_tpu.features import binary as jbin
from sfm_tpu.features import detect_and_describe as jdetect
from sfm_tpu.features.pyramid import gaussian_blur_mm
from sfm_tpu_torch import config as tcfg
from sfm_tpu_torch.config import FeatureConfig, MatchConfig, SfMConfig, VerifyConfig
from sfm_tpu_torch.features import binary as tbin
from sfm_tpu_torch.features.frontend import detect_and_describe

ORB1 = FeatureConfig(kind="orb", orb_levels=1)


def _detect(img, mask=None, config=FeatureConfig(kind="orb")):
    f = detect_and_describe(img, mask, config=config, device="cpu")
    return {k: n(v) for k, v in f._asdict().items()}


def _texture(h=200, w=240, seed=7):
    """Blurred noise: dense FAST corners with meaningful BRIEF structure."""
    from scipy.ndimage import gaussian_filter

    img = gaussian_filter(np.random.default_rng(seed).random((h, w)), 1.5)
    img = (img - img.min()) / (img.max() - img.min())
    return img.astype(np.float32)


def _jax_gated_nms(img, t_, mask=None):
    """The reference's FAST plane as _detect_orb_level builds it: score,
    border band, mask gate, _nms3."""
    h, w = img.shape
    score = jbin.fast_scores(jnp.asarray(img), t_)
    yy, xx = jnp.arange(h)[:, None], jnp.arange(w)[None, :]
    b = jbin.BORDER
    score = jnp.where((yy >= b) & (yy < h - b) & (xx >= b) & (xx < w - b), score, 0.0)
    if mask is not None:
        score = jnp.where(jnp.asarray(mask), score, 0.0)
    return np.asarray(jbin._nms3(score))


def _fast_oracle(img, thr):
    """Brute-force FAST-9/16 (9 contiguous circular ring samples all > c + t
    or all < c - t) and its score, the passing polarity's summed contrast."""
    h, w = img.shape
    passed = np.zeros((h, w), bool)
    score = np.zeros((h, w))
    for y in range(3, h - 3):
        for x in range(3, w - 3):
            c = img[y, x]
            vals = np.array([img[y + dy, x + dx] for dy, dx in tbin._RING])
            for m, s in ((vals > c + thr, vals - c - thr), (vals < c - thr, c - vals - thr)):
                run = best = 0
                for bit in np.concatenate([m, m]):
                    run = run + 1 if bit else 0
                    best = max(best, run)
                if best >= 9:
                    passed[y, x] = True
                    score[y, x] = max(score[y, x], s[m].sum())
    return passed, score


# ---------------------------------------------------------------- fast_nms

@pytest.mark.parametrize("thr,with_mask", [(20, False), (20, True), (5, False)])
def test_fast_nms_matches_jax(thr, with_mask):
    # Tolerance: the kept set exact; scores within 1e-6 relative (the port
    # sums the 16 ring terms in ring order, XLA in its own).
    rng = np.random.default_rng(3)
    img = textured_image(rng, 96, 128, blobs=200)
    mask = rng.random((96, 128)) > 0.3 if with_mask else None
    ref = _jax_gated_nms(img, thr / 255.0, mask)
    got = n(tbin.fast_nms(t(img)[None], thr / 255.0,
                          None if mask is None else torch.as_tensor(mask)[None]))[0]
    np.testing.assert_array_equal(got > 0, ref > 0)
    kept = ref > 0
    assert kept.sum() > 20
    np.testing.assert_allclose(got[kept], ref[kept], rtol=1e-6)


def test_fast_scores_match_bruteforce():
    # The arc test exactly, and the score is the PASSING polarity's sum
    # (within 1e-5 relative of the float64 oracle).
    img = np.random.default_rng(5).random((40, 48)).astype(np.float32)
    thr = 0.12
    got = n(tbin.fast_scores(t(img)[None], thr))[0]
    passed, score = _fast_oracle(img, np.float32(thr))
    sl = (slice(3, -3), slice(3, -3))     # the rolls wrap at the edge
    np.testing.assert_array_equal(got[sl] > 0, passed[sl])
    np.testing.assert_allclose(got[sl], score[sl], rtol=1e-5)


def test_fast_nms_keeps_ties_and_zeroes_the_border():
    img = np.zeros((60, 60), np.float32)
    img[20:40, 20:40] = 1.0
    got = n(tbin.fast_nms(t(img)[None], 0.1))[0]
    assert (got[:tbin.BORDER] == 0).all() and (got[:, -tbin.BORDER:] == 0).all()
    assert set(map(tuple, np.argwhere(got > 0).tolist())) == {(20, 20), (20, 39), (39, 20),
                                                              (39, 39)}


# ---------------------------------------------------------------- orb_blur

@pytest.mark.parametrize("shape", [(100, 120), (200, 240)])
def test_blur_matches_jax(shape):
    # Below 128 px the reference blurs with the same exact shift-add (equal
    # bits); above, with banded matmuls: within 1e-6, and the bf16 planes
    # equal except where the f32 values sit on a rounding boundary.
    img = textured_image(np.random.default_rng(1), *shape, blobs=100)
    ref = np.asarray(gaussian_blur_mm(jnp.asarray(img), 2.0))
    got = n(tbin.gaussian_blur(t(img)[None], tbin.BLUR_SIGMA))[0]
    np.testing.assert_allclose(got, ref, atol=1e-6)
    ref16 = np.asarray(jnp.asarray(ref).astype(jnp.bfloat16).astype(jnp.float32))
    got16 = n(tbin.orb_blur(t(img)[None]).to(torch.float32))[0]
    assert (got16 == ref16).mean() >= 0.999
    if shape[0] < 128:
        np.testing.assert_array_equal(got16, ref16)


# ---------------------------------------------------------------- the resize

@pytest.mark.parametrize("n_in,n_out", [(768, 569), (1024, 759), (768, 421), (1024, 562),
                                        (120, 89), (160, 119)])
def test_resize_weights_match_jax(n_in, n_out):
    # Tolerance 1e-6: the reference's weights are float32 and XLA's fusion
    # rounds a few of them an ulp otherwise. jax.image.resize of the identity
    # along one axis is that axis's weight matrix.
    eye = jnp.eye(n_in, dtype=jnp.float32)
    ref = np.asarray(jax.image.resize(eye, (n_out, n_in), "linear")).T
    np.testing.assert_allclose(tbin.resize_weights(n_in, n_out), ref, atol=1e-6)


@pytest.mark.parametrize("level", [1, 2])
def test_resize_linear_matches_jax(level):
    # The main path's level shapes from 768 x 1024; two f32 matmuls against
    # XLA's two dots: within 1e-6 (another summation order).
    img = np.random.default_rng(2).random((768, 1024), dtype=np.float32)
    hl, wl = tbin.level_shape(768, 1024, level, 1.35)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (hl, wl), "linear"))
    got = n(tbin.resize_linear(t(img)[None], hl, wl))[0]
    assert got.shape == ref.shape == ((569, 759) if level == 1 else (421, 562))
    np.testing.assert_allclose(got, ref, atol=1e-6)


# ---------------------------------------------------------------- orb_describe

def _assert_features_match(got, ref, xy_atol, resp_atol=0.0, plane_flips=False):
    """Valid sets and order equal; xy within ``xy_atol``; response within
    ``resp_atol`` (upper levels: each of the 16 ring terms reads two resized
    pixels, which differ from the reference's by the resize's own error)
    and 1e-6 relative; sigma within 1e-6; angles within 1e-6 rad;
    descriptors identical on every keypoint whose steering bin is away from
    a boundary (|frac - round(frac)| < 0.5 - 1e-3) and on >= 99% of all.

    ``plane_flips``: the reference's blurred plane was made by banded f32
    matmuls (~1e-7 from the shift-add), and a value on a bf16 rounding
    boundary rounds one bf16 step (2^-8 relative) the other way, moving its
    patch's moments and the tests it takes part in: then >= 99% of angles
    within 1e-6 rad and all within 1e-2, >= 99% of rows and 99.9% of bits
    identical."""
    v = np.asarray(ref["valid"])
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_allclose(got["xy"], np.asarray(ref["xy"]), atol=xy_atol)
    np.testing.assert_allclose(got["response"], np.asarray(ref["response"]), rtol=1e-6,
                               atol=resp_atol)
    np.testing.assert_allclose(got["sigma"], np.asarray(ref["sigma"]), rtol=1e-6)
    ang = np.asarray(ref["angle"])
    bits = got["desc"] == np.asarray(ref["desc"]).astype(np.float32)
    same = bits.all(-1)
    if plane_flips:
        d_ang = np.abs(got["angle"] - ang)
        assert (d_ang[v] <= 1e-6).mean() >= 0.99 and d_ang.max() <= 1e-2
        assert bits[v].mean() >= 0.999
    else:
        np.testing.assert_allclose(got["angle"], ang, atol=1e-6)
        frac = ang * tbin._BIN_SCALE
        away = np.abs(frac - np.round(frac)) < 0.5 - 1e-3
        assert same[v & away].all()
    assert same[v].mean() >= 0.99
    assert (got["desc"][~v] == 0).all()


def test_describe_one_level_matches_jax():
    img = _texture(160, 180, seed=9)
    cfg = JFeatureConfig(kind="orb", orb_levels=1)
    ref = jbin._detect_orb_level(jnp.asarray(img), jnp.ones(img.shape, bool), cfg, False,
                                 cfg.max_keypoints)
    got = tbin._detect_orb_level(t(img)[None], None, ORB1, ORB1.max_keypoints)
    got = {k: n(v)[0] for k, v in got.items()}
    assert got["desc"].shape == (2048, 256) and got["valid"].sum() > 100
    _assert_features_match(got, ref._asdict(), xy_atol=0)


def _assert_tables_agree(got, ref, min_common, resp_atol, plane_flips=False):
    """Merged tables: the keypoints (level-0 xy to 0.01 px, sigma naming the
    level) of ``ref`` found in ``got`` on >= ``min_common`` of its valid rows
    and the valid counts as close; both response-ordered with the valid rows
    first; the common rows held as :func:`_assert_features_match` holds
    them. (Near-equal responses may trade places in the merge, so rows are
    paired by keypoint, not by position.)"""
    ref = {k: np.asarray(v) for k, v in ref.items()}
    rows = {}
    for name, f in (("got", got), ("ref", ref)):
        v = f["valid"]
        assert not v[int(v.sum()):].any() and (np.diff(f["response"][v]) <= 0).all()
        rows[name] = {(round(float(x), 2), round(float(y), 2), round(float(sg), 3)): i
                      for i, ((x, y), sg) in enumerate(zip(f["xy"], f["sigma"])) if v[i]}
    common = sorted(set(rows["got"]) & set(rows["ref"]))
    n_ref = len(rows["ref"])
    assert len(common) >= min_common * n_ref, (len(common), n_ref)
    assert abs(len(rows["got"]) - n_ref) <= (1 - min_common) * n_ref
    ig = np.array([rows["got"][k] for k in common])
    ir = np.array([rows["ref"][k] for k in common])
    _assert_features_match({k: v[ig] for k, v in got.items()},
                           {k: v[ir] for k, v in ref.items()}, xy_atol=1e-4,
                           resp_atol=resp_atol, plane_flips=plane_flips)


@pytest.mark.parametrize("with_mask", [False, True])
def test_detect_orb_pyramid_matches_jax(with_mask):
    # Three levels and the response-ordered merge, through both packages'
    # detect_and_describe: the same keypoints; xy within 1e-4 px (the
    # level-to-image map is x * s + o, which XLA may fuse into one rounding).
    # Responses within 1e-4: at 200 px the reference's level-1 resize is
    # itself off by up to 1.9e-6 (one weight column sums to 1 - 2.2e-6), and
    # a score sums 16 ring terms of two such pixels each (<= 6.1e-5).
    img = _texture(200, 240, seed=4)
    mask = None
    if with_mask:
        mask = np.zeros(img.shape, bool)
        mask[30:170, 20:200] = True
    ref = jdetect(img, mask=mask, config=JFeatureConfig(kind="orb"))
    got = _detect(img, mask)
    assert got["desc"].shape == (sum(tbin._level_budgets(2048, 3, 1.35)), 256)
    assert got["valid"].sum() > 200
    _assert_tables_agree(got, ref._asdict(), min_common=1.0, resp_atol=1e-4)


def test_descriptor_matches_numpy_oracle():
    # Every step recomputed in numpy from the port's own blurred bf16 plane:
    # float64 moments, the bin, the steered compares -- bit-identical.
    img = _texture(160, 180, seed=9)
    f = _detect(img, config=ORB1)
    v = f["valid"]
    xy = f["xy"][v].astype(int)
    blur = n(tbin.orb_blur(t(img)[None]).to(torch.float32))[0]
    H, P = tbin.HALF, tbin.PATCH
    assert len(xy) >= 20
    for k in range(len(xy)):
        x, y = xy[k]
        bp = blur[y - H:y + H + 1, x - H:x + H + 1].ravel()
        m10 = np.float32((bp.astype(np.float64) * tbin._IC_WX).sum())
        m01 = np.float32((bp.astype(np.float64) * tbin._IC_WY).sum())
        ang = np.arctan2(m01, m10)
        np.testing.assert_allclose(f["angle"][v][k], ang, atol=1e-6)
        b = int(np.round(np.float32(ang) * np.float32(tbin._BIN_SCALE))) % tbin.N_ANGLE_BINS
        bits = bp[tbin._STEER1[b]] < bp[tbin._STEER2[b]]
        np.testing.assert_array_equal(f["desc"][v][k], np.where(bits, 1 / 16, -1 / 16))
        assert bp.size == P * P


# ---------------------------------------------------------------- the frontend's cases

def test_square_corners_detected():
    img = np.zeros((120, 160), np.float32)
    img[40:80, 50:110] = 1.0
    f = _detect(img, config=ORB1)
    assert f["valid"].sum() == 4
    got = {tuple(p) for p in f["xy"][f["valid"]].astype(int).tolist()}
    assert got == {(50, 40), (109, 40), (50, 79), (109, 79)}


def test_flat_image_yields_nothing():
    f = _detect(np.full((100, 100), 0.3, np.float32))
    assert f["valid"].sum() == 0 and (f["desc"] == 0).all()


@pytest.mark.parametrize("dilate,cut,want", [(0, 80, 2), (0, 49, 0), (2, 49, 2)])
def test_mask_gates_keypoints(dilate, cut, want):
    # Keep the columns < cut: the two left corners sit at x = 50, just
    # outside cut 49 unless the mask is dilated by 2.
    img = np.zeros((120, 160), np.float32)
    img[40:80, 50:110] = 1.0
    mask = np.zeros((120, 160), bool)
    mask[:, :cut] = True
    f = _detect(img, mask, dataclasses.replace(ORB1, mask_dilate=dilate))
    assert f["valid"].sum() == want
    assert (f["xy"][f["valid"]][:, 0] < 80).all()


def test_descriptor_is_unit_and_binary():
    f = _detect(_texture())
    d = f["desc"][f["valid"]].astype(np.float64)
    assert f["desc"].dtype == np.float32 and d.shape[1] == tbin.N_BITS
    np.testing.assert_allclose((d ** 2).sum(1), 1.0, atol=1e-6)
    assert set(np.unique(np.abs(d))) == {1.0 / 16.0}


def test_rotation_steering():
    """Descriptors survive a 90-degree rotation: (x, y) -> (y, W-1-x) maps
    pixels exactly, so only the steering compensates; 90 deg falls between
    12-degree bins, so corresponding Hamming sits well below chance, not at 0."""
    img = _texture()
    h, w = img.shape
    f1, f2 = _detect(img, config=ORB1), _detect(np.ascontiguousarray(np.rot90(img)), config=ORB1)
    v1, v2 = f1["valid"], f2["valid"]
    xy1, xy2 = f1["xy"][v1], f2["xy"][v2]
    d1, d2 = f1["desc"][v1].astype(np.float64), f2["desc"][v2].astype(np.float64)
    mapped = np.stack([xy1[:, 1], w - 1 - xy1[:, 0]], 1)
    dist = np.abs(mapped[:, None, :] - xy2[None, :, :]).sum(-1)
    j = dist.argmin(1)
    ok = dist[np.arange(len(mapped)), j] < 0.5
    assert ok.sum() >= 30
    hamm = (1.0 - (d1[ok] * d2[j[ok]]).sum(1)) * (tbin.N_BITS / 2.0)
    rand = (1.0 - (d1[ok] * np.roll(d2[j[ok]], 7, axis=0)).sum(1)) * 128.0
    assert np.median(hamm) < 60 and np.median(rand) > 100
    assert np.median(hamm) < 0.5 * np.median(rand)


def test_level_budgets():
    b = tbin._level_budgets(2048, 3, 1.35)
    assert b == list(jbin._level_budgets(2048, 3, 1.35)) == [2048, 1128, 624]
    assert all(x % 8 == 0 for x in b[1:])


def test_merged_table_is_response_ordered():
    f = _detect(_texture())
    v = f["valid"]
    r = f["response"][v]
    assert v.sum() > 0 and (np.diff(r) <= 0).all()
    # invalid rows last: the valid rows are a prefix
    assert not v[int(v.sum()):].any()


def test_scale_bridging_match():
    """A texture and its 1.5x downscale link far above chance only with the
    pyramid on (the port's own matcher, the mapped Hamming ratio)."""
    from sfm_tpu_torch.matching.core import match_descriptors

    img = _texture(240, 300, seed=11)
    h, w = img.shape
    small = np.asarray(jax.image.resize(jnp.asarray(img), (int(h / 1.5), int(w / 1.5)),
                                        "linear"))

    def n_matches(levels):
        cfg = FeatureConfig(kind="orb", orb_levels=levels)
        f1, f2 = _detect(img, config=cfg), _detect(small.astype(np.float32), config=cfg)
        out = match_descriptors(t(f1["desc"])[None], t(f1["valid"])[None],
                                t(f2["desc"])[None], t(f2["valid"])[None], max_matches=512,
                                ratio_threshold=tcfg.map_ratio_for_kind(0.75, "orb"))
        m = n(out["valid"])[0]
        xy1 = f1["xy"][n(out["idx1"])[0][m]]
        xy2 = f2["xy"][n(out["idx2"])[0][m]]
        return int((np.abs(xy1 / 1.5 - xy2).max(1) < 3.0).sum())

    n1, n3 = n_matches(1), n_matches(3)
    assert n3 >= max(2 * n1, 20), (n1, n3)


def test_fast_threshold_consumed():
    img = _texture()
    lo = _detect(img, config=FeatureConfig(kind="orb", fast_threshold=8.0))
    hi = _detect(img, config=FeatureConfig(kind="orb", fast_threshold=60.0))
    assert lo["valid"].sum() > hi["valid"].sum()


def test_kind_switches_descriptor_class():
    img = _texture(140, 150)
    assert _detect(img)["desc"].shape[1] == 256
    assert _detect(img, config=FeatureConfig())["desc"].shape[1] == 128


def test_batch_equals_single_images():
    # The sub-batched frontend gives each image what it gives it alone.
    from sfm_tpu_torch.features.frontend import detect_and_describe_batch

    imgs = np.stack([_texture(120, 140, seed=s) for s in (1, 2, 3)])
    cfg = FeatureConfig(kind="orb")
    batch = detect_and_describe_batch(imgs, config=cfg, batch_size=2, device="cpu")
    for i in range(3):
        one = _detect(imgs[i], config=cfg)
        for k, v in one.items():
            np.testing.assert_array_equal(n(getattr(batch, k))[i], v)


@pytest.mark.parametrize("call", [
    lambda m: tbin.fast_nms(m(2, 64, 64), 0.1),
    lambda m: tbin.orb_blur(m(2, 64, 64)),
    lambda m: tbin.orb_describe(m(2, 64, 64, dtype=torch.bfloat16), m(2, 8, dtype=torch.int64),
                                m(2, 8, dtype=torch.int64), m(2, 8, dtype=torch.bool))])
def test_wrappers_refuse_other_devices(call):
    # A wrapper runs its twin on the CPU, its kernel on CUDA, and raises
    # elsewhere: no silent fallback.
    with pytest.raises(ValueError, match="unsupported device"):
        call(lambda *s, **k: torch.empty(s, device="meta", **k))


# ---------------------------------------------------------------- the matcher contract

def test_ratio_mappings_for_binary():
    cfg = SfMConfig(features=FeatureConfig(kind="orb"),
                    matching=MatchConfig(ratio_threshold=0.75),
                    pnp=tcfg.PnPConfig(guided_ratio=0.9))
    assert tcfg.effective_match_config(cfg).ratio_threshold == pytest.approx(0.75 ** 0.5)
    assert tcfg.effective_retrieval_config(cfg).ratio_threshold == pytest.approx(
        cfg.retrieval.ratio_threshold ** 0.5)
    assert tcfg.effective_guided_ratio(cfg) == pytest.approx(0.9 ** 0.5)
    sift = SfMConfig()
    assert tcfg.effective_match_config(sift).ratio_threshold == 0.75
    assert tcfg.effective_guided_ratio(sift) == sift.pnp.guided_ratio


def _binarize_scene(scene):
    """Sign-binarize a make_multiview scene's descriptors into the ORB wire
    encoding (+-1/sqrt(D)); invalid rows stay zero."""
    d = scene["desc"]
    b = np.where(d >= 0, 1.0, -1.0).astype(np.float32) / np.sqrt(d.shape[-1])
    b[~scene["valid"]] = 0.0
    return dict(scene, desc=b)


def test_sweep_applies_ratio_mapping():
    """The port's sweep reads the kind-aware match config: an orb config
    sweeps like a sift config with the ratio hand-mapped to sqrt(r), and
    finds more matches than one that forgot the mapping."""
    from test_reconstruction import make_multiview

    from sfm_tpu_torch.matching.sweep import all_pairs_sweep

    scene = _binarize_scene(make_multiview(np.random.default_rng(0), n_cams=6, n_pts=200,
                                           K_budget=128, D=64))
    base = dict(matching=MatchConfig(ratio_threshold=0.75, max_matches=128),
                verify=VerifyConfig(ransac_iters=256))
    args = (t(scene["xy"]), t(scene["desc"]), t(scene["valid"]))
    t_orb = all_pairs_sweep(*args, SfMConfig(features=FeatureConfig(kind="orb"), **base),
                            chunk_size=8)
    t_manual = all_pairs_sweep(*args, SfMConfig(
        matching=dataclasses.replace(base["matching"], ratio_threshold=0.75 ** 0.5),
        verify=base["verify"]), chunk_size=8)
    t_raw = all_pairs_sweep(*args, SfMConfig(**base), chunk_size=8)
    np.testing.assert_array_equal(t_orb.accept, t_manual.accept)
    np.testing.assert_array_equal(t_orb.num_matches, t_manual.num_matches)
    assert t_raw.num_matches.sum() < t_orb.num_matches.sum()


# ---------------------------------------------------------------- the slice

# FAST's contrast gate on the rendered corridor (u8 scale): its band-limited
# texture keeps ~30 level-0 corners per image at the default 20; at 5 every
# image fills the 3,800-row table, as the card's smoke run does
# (tests/orb_parity_report.py prints the level-0 counts).
SLICE_FAST_THRESHOLD = 5.0
N_IMAGES = 8


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return render_scene(tmp_path_factory.mktemp("orb_slice") / "scene", N_IMAGES)


def test_orb_first_image_matches_jax(scene):
    # One rendered 1024 x 768 u8 view through both frontends at the slice's
    # threshold. The compiled reference fuses the u8 normalization into the
    # FAST compares and rounds them otherwise than an op-by-op evaluation
    # (which the port reproduces exactly: the tests above); u8 contrasts tie
    # with the threshold exactly, so an ulp moves a ring sample in or out.
    # Hence >= 98% of the reference's keypoints, not all (99.29%:
    # tests/orb_parity_report.py).
    from sfm_tpu_torch.io.images import load_image_gray_u8

    img = load_image_gray_u8(scene / "images" / "0000.pgm")
    ref = jdetect(img, config=JFeatureConfig(kind="orb", fast_threshold=SLICE_FAST_THRESHOLD))
    got = _detect(img, config=FeatureConfig(kind="orb", fast_threshold=SLICE_FAST_THRESHOLD))
    assert got["valid"].sum() == 3800
    # Responses within 1e-5: the main path's level resizes are within 2e-7 of
    # the reference's, times 16 ring terms of two pixels each (<= 6.4e-6).
    _assert_tables_agree(got, ref._asdict(), min_common=0.98, resp_atol=1e-5, plane_flips=True)


def test_orb_pipeline_end_to_end(scene, tmp_path):
    """``pipeline --feature_kind orb`` with retrieval on (K1-r on binary
    descriptors) from pixels to model. Gates: 8/8 cameras, > 200 points,
    < 0.6 px, ATE < 5% of the scene, and GT rotation median < 2 deg:
    FAST keypoints sit on integer pixels (no subpixel refinement), and the
    JAX package's own ORB run on this scene at this threshold reads 1.40 deg
    (8/8 cameras, 5,133 points, 0.39 px; tests/orb_parity_report.py); the
    SIFT slice's 1 deg is not this frontend's."""
    from sfm_tpu_torch import cli

    out = tmp_path / "out"
    cfg = tmp_path / "cfg.json"
    SfMConfig(features=FeatureConfig(detect_batch=2, fast_threshold=SLICE_FAST_THRESHOLD)
              ).to_json(cfg)
    rc = cli.main(["--log_dir", str(tmp_path / "logs"), "pipeline", "--data_dir", str(scene),
                   "--output_dir", str(out), "--device", "cpu", "--no_mask", "--num_images",
                   str(N_IMAGES), "--feature_kind", "orb", "--match_mode", "on",
                   "--config", str(cfg)])
    assert rc == 0
    s = json.loads((out / "reconstruction" / "stats.json").read_text())
    assert s["num_cameras"] == N_IMAGES, s["num_cameras"]
    assert s["num_points"] > 200, s["num_points"]
    assert s["mean_reprojection_error"] < 0.6, s["mean_reprojection_error"]
    assert s["gt_ate_rel"] < 0.05, s["gt_ate_rel"]
    assert s["gt_rot_err_deg_median"] < 2.0, s["gt_rot_err_deg_median"]
    blob = pickle.loads((out / "pair_table.pkl").read_bytes())
    assert blob["desc"].shape == (N_IMAGES, 3800, 256) and blob["desc"].dtype == np.float16
    assert set(np.unique(np.abs(blob["desc"][blob["valid"]]))) == {np.float16(1 / 16)}
    metrics = {r["name"] for r in json.loads((out / "metrics.json").read_text())}
    assert {"stage/detect", "stage/retrieval", "stage/sweep"} <= metrics
