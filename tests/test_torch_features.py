"""Parity of the port's SIFT frontend with ``sfm_tpu.features``.

Every comparison feeds both packages the same numpy inputs, made from a seed.
On the CPU the port's kernel wrappers run their plain PyTorch twins, so these
tests pin the twins (the oracles the CUDA kernels are held to on the card)
to the JAX reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n, t, textured_image

from sfm_tpu.config import FeatureConfig
from sfm_tpu.features import descriptor as jdesc
from sfm_tpu.features import detect as jdet
from sfm_tpu.features import frontend as jfront
from sfm_tpu.features import pyramid as jpyr
from sfm_tpu_torch.features import descriptor as tdesc
from sfm_tpu_torch.features import detect as tdet
from sfm_tpu_torch.features import frontend as tfront
from sfm_tpu_torch.features import pyramid as tpyr


@pytest.fixture(scope="module")
def image():
    return textured_image(np.random.default_rng(7), 128, 160)


@pytest.fixture(scope="module")
def jax_pyramid(image):
    return jpyr.build_pyramid(jnp.asarray(image), num_octaves=3, upsample=True)


@pytest.mark.parametrize("shape", [(5, 7), (12, 9)])
def test_upsample_matches_jax_resize(shape):
    # jax.image.resize renormalizes the triangle kernel where taps leave the
    # image; F.interpolate(align_corners=False) clamps instead. The port
    # follows JAX: equal to float32 rounding.
    img = np.random.default_rng(1).random(shape, dtype=np.float32)
    ref = jax.image.resize(jnp.asarray(img), (2 * shape[0], 2 * shape[1]), "bilinear")
    np.testing.assert_allclose(n(tpyr.upsample2x(t(img))), n(ref), atol=1e-6)


def test_build_pyramid_matches_jax(image, jax_pyramid):
    # Tolerance 1e-5 on DoG: the reference blurs >=128-px images with banded
    # f32 matmuls, the port with the exact shift-add (another summation order).
    jg, jd = jax_pyramid
    tg, td = tpyr.build_pyramid(t(image)[None], num_octaves=3, upsample=True)
    assert len(td) == len(jd) == 3
    for a, b in zip(td, jd):
        assert a.shape[1:] == b.shape
        np.testing.assert_allclose(n(a[0]), n(b), atol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(n(a[0]), n(b), atol=1e-5)


def test_dog_extrema_scores_exact(jax_pyramid):
    # Kernel K4's semantics: compares only, so bit-exact.
    cfg = FeatureConfig()
    for dog in jax_pyramid[1]:
        ref = jdet._dog_extrema_scores_ref(dog, cfg.contrast_threshold, cfg.edge_threshold)
        prod = jdet.dog_extrema_scores(dog, cfg.contrast_threshold, cfg.edge_threshold)
        got = tdet.dog_extrema_scores(t(dog)[None], cfg.contrast_threshold,
                                      cfg.edge_threshold)["score"][0]
        np.testing.assert_array_equal(n(got), n(ref["score"]))
        np.testing.assert_array_equal(n(got), n(prod["score"]))


@pytest.mark.parametrize("budget", [64, 512])
def test_select_and_refine_match_jax(jax_pyramid, budget):
    cfg = FeatureConfig()
    for dog in jax_pyramid[1]:
        fields = jdet.dog_extrema_scores(dog, cfg.contrast_threshold, cfg.edge_threshold)
        jc = jdet.select_octave_candidates(fields, budget)
        tc = tdet.select_octave_candidates({"score": t(fields["score"])[None]}, budget)
        for k in ("layer", "y", "x", "score"):
            np.testing.assert_array_equal(n(tc[k][0]), n(jc[k]), err_msg=k)
        jr = jdet.refine_and_gate(dog, jc["layer"], jc["y"], jc["x"],
                                  cfg.contrast_threshold, cfg.edge_threshold)
        tr = tdet.refine_and_gate(t(dog)[None], tc["layer"], tc["y"], tc["x"],
                                  cfg.contrast_threshold, cfg.edge_threshold)
        for a, b in zip(tr, jr):
            np.testing.assert_allclose(n(a[0]), n(b), atol=1e-6, rtol=1e-5)


def _circ(a, b):
    d = np.abs(a - b) % (2 * np.pi)
    return np.minimum(d, 2 * np.pi - d)


def test_descriptor_canvas_matches_jax(jax_pyramid):
    # Kernel K5's tolerance: >=99.5% of keypoints within 1e-3 rad and 1e-3 L2
    # (histogram sums run in another order); the rest are orientation near-ties.
    gaussians = jax_pyramid[0]
    S = 3
    widths = [g.shape[-1] for g in gaussians]
    heights = [g.shape[-2] for g in gaussians]
    wmax = max(max(widths), jdesc._GPATCH)
    canvas = np.concatenate(
        [np.pad(np.asarray(g[1:S + 1]), ((0, 0), (0, max(0, jdesc._GPATCH - g.shape[-2])),
                                         (0, wmax - g.shape[-1]))) for g in gaussians],
        axis=1).astype(np.float16)
    row_off = np.cumsum([0] + [max(h, jdesc._GPATCH) for h in heights[:-1]])
    rng = np.random.default_rng(3)
    K = 300
    octv = rng.integers(0, len(gaussians), K)
    w_o = np.asarray(widths, np.int32)[octv]
    h_o = np.asarray(heights, np.int32)[octv]
    x = (rng.random(K) * (w_o - 1)).astype(np.float32)
    y = (rng.random(K) * (h_o - 1)).astype(np.float32)
    gl = rng.integers(0, S, K).astype(np.int32)
    sig = (1.6 * 2 ** (rng.random(K) * 1.2 + 0.3)).astype(np.float32)
    ro = row_off[octv].astype(np.int32)

    ja, jdsc = jdesc.orientation_and_descriptor_canvas(
        jnp.asarray(canvas), *(jnp.asarray(a) for a in (gl, x, y, sig, ro, w_o, h_o)))
    ta, tdsc = tdesc.orientation_and_descriptor_canvas(
        t(canvas)[None], *(t(a)[None] for a in (gl, x, y, sig, ro, w_o, h_o)))
    ang_ok = _circ(n(ta[0]), n(ja)) <= 1e-3
    desc_ok = np.linalg.norm(n(tdsc[0]) - n(jdsc), axis=-1) <= 1e-3
    assert (ang_ok & desc_ok).mean() >= 0.995, (ang_ok.mean(), desc_ok.mean())


@pytest.mark.parametrize("with_mask", [False, True])
def test_detect_impl_matches_jax(with_mask):
    img = textured_image(np.random.default_rng(11), 160, 192, blobs=120)
    cfg = FeatureConfig(max_keypoints=256, num_octaves=3, mask_dilate=2 if with_mask else 0)
    mask = None
    if with_mask:
        mask = np.zeros(img.shape, bool)
        mask[20:140, 30:170] = True
    jf = jfront.detect_and_describe(img, mask, config=cfg)
    tf = tfront.detect_and_describe(img, mask, config=cfg, device="cpu")
    jv, tv = n(jf.valid), n(tf.valid)
    assert jv.sum() > 50
    jxy, txy = n(jf.xy)[jv], n(tf.xy)[tv]
    d = np.linalg.norm(jxy[:, None] - txy[None], axis=-1)
    near = d.argmin(1)
    hit = d[np.arange(len(jxy)), near] <= 1e-3
    assert hit.mean() >= 0.99, hit.mean()
    cos = np.sum(n(jf.desc)[jv][hit] * n(tf.desc)[tv][near[hit]], axis=-1)
    assert np.median(cos) >= 0.9999 and (cos >= 0.9999).mean() >= 0.99, cos.min()
    assert abs(int(jv.sum()) - int(tv.sum())) <= max(2, int(0.01 * jv.sum()))


def test_dilate_mask_matches_jax():
    m = np.random.default_rng(2).random((1, 23, 31)) > 0.93
    ref = jfront.dilate_mask(jnp.asarray(m[0]), 2)
    np.testing.assert_array_equal(n(tfront.dilate_mask(torch.as_tensor(m), 2)[0]), n(ref))
