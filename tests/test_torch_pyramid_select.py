"""The edge cases of kernels K3 (``build_pyramid``) and K4 (``dog_select``).

K3 runs a block a tile with its halo, at the next instantiated radius with
the taps zero-padded; K4 cuts each image's block maxima into blocks of keys,
picks the k1-th largest key 8 bits a pass and compacts the ties in index
order. The CPU tests hold the plain twins, which the card holds the kernels
to bit for bit, against the JAX package where the kernels' new cases are:
odd sizes, images shorter than a blur's footprint, tie-heavy score grids.
They also hold the wrappers' host-side plans (radius dispatch and padded
taps, the selection's blocks and workspace) against a numpy reckoning, and
a numpy walk of the selection's passes against ``lax.top_k``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n, t, textured_image

from sfm_tpu.features import detect as jdet
from sfm_tpu.features import pyramid as jpyr
from sfm_tpu_torch.estimators.ransac import top_k_plain
from sfm_tpu_torch.features import detect as tdet
from sfm_tpu_torch.features import pyramid as tpyr


# ------------------------------------------------------------------ K3


@pytest.mark.parametrize("h,w,upsample", [(13, 41, False), (13, 41, True), (17, 30, True),
                                          (9, 45, False)])
def test_build_pyramid_plain_matches_jax_at_odd_sizes(h, w, upsample):
    # Tolerance 1e-5, as test_build_pyramid_matches_jax: the reference's
    # banded-matmul blur is another summation order (at these sizes JAX takes
    # its exact shift-add, so the two agree far closer). Widths that are not
    # a multiple of 4, heights under a blur's 2R + 1 taps (R = 10 at the last
    # increment), odd octave sizes.
    img = textured_image(np.random.default_rng(h * w), h, w, blobs=6)
    jg, jd = jpyr.build_pyramid(jnp.asarray(img), num_octaves=3, upsample=upsample)
    tg, td = tpyr.build_pyramid_plain(t(img)[None], num_octaves=3, upsample=upsample)
    assert len(tg) == len(jg) == 3
    for a, b in zip(tg + td, list(jg) + list(jd)):
        assert a.shape[1:] == b.shape
        np.testing.assert_allclose(n(a[0]), n(b), atol=1e-5)


@pytest.mark.parametrize("sigma", [1.2489996, 1.2262608, 1.5450025, 1.9465837, 2.4525003,
                                   3.0900044, 2.0, 1.5198684, 0.3, 0.9, 2.3, 2.9])
def test_k3_blur_plan_against_numpy(sigma):
    # The default configuration's blurs run at their own radius; any other
    # radius at the next instantiated one, its taps centred among zeros.
    taps, radii = tpyr.k3_blur_plan([sigma])
    r = max(1, math.ceil(3 * sigma))
    R = min(q for q in (4, 5, 6, 8, 10) if q >= r)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    want = np.zeros(21, np.float32)
    want[R - r:R + r + 1] = (k / k.sum()).astype(np.float32)
    assert radii.tolist() == [R] and radii.dtype == np.int32
    np.testing.assert_array_equal(taps[0], want)


def test_k3_blur_plan_defaults_and_limits():
    # The default SIFT pyramid's radii (with and without the -1 octave) and
    # K12's blur are instantiated as they are; past radius 10 the plan raises.
    for upsample, want in ((True, [4, 4, 5, 6, 8, 10]), (False, [5, 4, 5, 6, 8, 10])):
        _, radii = tpyr.k3_blur_plan(tpyr._blur_sigmas(3, 1.6, 0.5, upsample))
        assert radii.tolist() == want
    assert tpyr.k3_blur_plan([2.0])[1].tolist() == [6]
    with pytest.raises(ValueError, match="radius"):
        tpyr.k3_blur_plan([3.4])


def _blur_with_taps(img, taps):
    """The kernel's blur with its (zero-padded) 2R + 1 taps: the same
    shift-add, rows then columns, each sum from zero in tap order."""
    R = (len(taps) - 1) // 2
    h, w = img.shape[-2:]
    x = torch.nn.functional.pad(img, (R, R))
    out = sum(float(taps[i]) * x[..., :, i:i + w] for i in range(2 * R + 1))
    x = torch.nn.functional.pad(out, (0, 0, R, R))
    return sum(float(taps[i]) * x[..., i:i + h, :] for i in range(2 * R + 1))


@pytest.mark.parametrize("sigma", [0.3, 0.9, 1.2489996, 2.3, 2.9])
def test_padded_taps_keep_the_blur_bits(sigma):
    # The zero taps add products 0 * v = 0 to sums that are never -0: on a
    # finite image the padded blur is bit-identical to gaussian_blur, so the
    # kernel may run any radius <= 10 at an instantiated one.
    rng = np.random.default_rng(31)
    img = t(np.concatenate([textured_image(rng, 19, 33, blobs=5)[None],
                            rng.normal(0, 1, (1, 19, 33)).astype(np.float32)]))
    taps, radii = tpyr.k3_blur_plan([sigma])
    got = _blur_with_taps(img, taps[0, :2 * int(radii[0]) + 1])
    assert torch.equal(got, tpyr.gaussian_blur(img, sigma))


# ------------------------------------------------------------------ K4


def _tie_heavy(kind, shape):
    rng = np.random.default_rng(sum(shape))
    score = np.zeros(shape, np.float32)
    if kind == "few_positives":      # fewer positives than the budget: zeros fill by index
        flat = score.reshape(-1)
        flat[rng.choice(flat.size, 5, replace=False)] = rng.uniform(0.01, 0.1, 5)
    elif kind == "equal_positives":  # many exactly equal scores across blocks and cells
        score[rng.random(shape) < 0.4] = 0.5
    elif kind == "two_levels":
        score = rng.choice(np.float32([0.0, 0.03125, 0.0625]), size=shape, p=[0.6, 0.3, 0.1])
    return score


CASES = [("all_zero", (3, 37, 45), 64), ("few_positives", (3, 37, 45), 64),
         ("equal_positives", (3, 30, 41), 128), ("two_levels", (3, 29, 31), 96),
         ("equal_positives", (3, 9, 7), 200), ("all_zero", (1, 13, 18), 40)]


@pytest.mark.parametrize("kind,shape,budget", CASES)
def test_select_plain_matches_jax_on_tie_heavy_grids(kind, shape, budget):
    # Exact: lax.top_k's order at both levels, ties to the lower index,
    # padding past k2 (the (3, 9, 7) grid has 18 blocks and 72 cells for a
    # budget of 200), windows over the edge taking the max-pools' zero.
    score = _tie_heavy(kind, shape)
    ref = jdet.select_octave_candidates({"score": jnp.asarray(score)}, budget)
    got = tdet.select_octave_candidates_plain({"score": t(score)[None]}, budget)
    for k in ("layer", "y", "x", "score"):
        np.testing.assert_array_equal(n(got[k][0]), n(ref[k]), err_msg=k)


@pytest.mark.parametrize("B,S,h,w,budget", [(12, 3, 1536, 2048, 2048), (12, 3, 768, 1024, 1024),
                                            (12, 1, 569, 759, 1128), (3, 3, 301, 517, 2048),
                                            (2, 3, 9, 7, 200), (1, 1, 5, 5, 1)])
def test_dog_select_plan_against_numpy(B, S, h, w, budget):
    p = tdet.dog_select_plan(B, S, h, w, budget)
    h4, w4 = -(-(-(-h // 2)) // 2), -(-(-(-w // 2)) // 2)   # two ceil-halvings
    n1 = S * h4 * w4
    k1 = min(budget, n1)
    k2 = min(budget, 4 * k1)
    blocks = math.ceil(n1 / 4096)
    parts = [n1, n1, 2 * 3 * 256 + 9, blocks, k1, k1, k1, 4 * k1, k2]   # 32-bit words an image
    words32 = B * sum(parts)
    want = words32 + words32 % 2 + 2 * B * k2                    # + the int64 top cells
    assert p == {"n1": n1, "k1": k1, "k2": k2, "blocks": blocks, "words": want}


def _order_keys(x):
    b = np.asarray(x, np.float32).view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def _passes(keys, k1):
    """The kernel's selection on one image's keys: 8-bit digits from the top,
    each pass over the keys under the chosen prefix, stopping once the keys
    equal to the prefix are all taken or are all one key (then the prefix is
    that key); then the compaction and each
    survivor's place: the survivors above it (larger keys, then lower
    indices among equal ones)."""
    prefix = mask = np.uint32(0)
    need, done, shift = k1, False, 24
    while not done:
        sel = (keys & mask) == prefix
        hist = np.bincount(((keys[sel] >> shift) & 255).astype(np.int64), minlength=256)
        cum, d = 0, 255
        while cum + hist[d] < need:
            cum, d = cum + hist[d], d - 1
        need -= cum
        prefix |= np.uint32(d << shift)
        mask |= np.uint32(255 << shift)
        bin_ = keys[(keys & mask) == prefix]
        one = bin_.min() == bin_.max()
        if one:
            prefix, mask = bin_[0], np.uint32(0xFFFFFFFF)
        done = one or hist[d] == need or shift == 0
        shift -= 8
    um = keys & mask
    gt, eq = um > prefix, um == prefix
    take = gt | (eq & (np.cumsum(eq) - eq < need))
    surv = np.random.default_rng(k1).permutation(np.nonzero(take)[0])   # slots in any order
    assert surv.size == k1
    u = keys[surv]
    place = ((u[None, :] > u[:, None])
             | ((u[None, :] == u[:, None]) & (surv[None, :] < surv[:, None]))).sum(1)
    out = np.empty(k1, np.int64)
    out[place] = surv
    return out


@pytest.mark.parametrize("kind,shape,budget", CASES + [("random", (3, 40, 52), 150)])
def test_selection_passes_match_top_k(kind, shape, budget):
    # The first level's top-k1 as the kernel computes it equals lax.top_k's
    # (top_k_plain, held to JAX above) on the same block maxima, ties and
    # early stops included.
    score = (np.random.default_rng(3).random(shape).astype(np.float32) if kind == "random"
             else _tie_heavy(kind, shape))
    blk = tdet._maxpool2(tdet._maxpool2(t(score)[None]))
    k1 = min(budget, blk[0].numel())
    _, want = top_k_plain(blk.reshape(1, -1), k1)
    got = _passes(_order_keys(n(blk).reshape(-1)), k1)
    np.testing.assert_array_equal(got, n(want[0]))
