"""K5's descriptors and K1-r's retrieval counts at the main path's shapes, the
wrappers' launches, and the constants and rules the redesigned kernels rest on.

On the card K5 (``csrc/sift_describe.cu``: a warp a keypoint) and K1-r
(``csrc/retrieval_score.cu``: rows resident, a persistent block an SM) are
held to the first designs' bits (``tests/bits_report.py --cases
describe,retrieval``); here their twins are held against the JAX package at
path d's launch shapes -- one rendered 1024 x 768 view at 2,048 keypoints
(with keypoints forced onto every octave's borders and the selection's
invalid rows), and a 1,024-pair retrieval chunk at S = 256, D = 128 whose dot
products are exact (so the counts must be equal), with ties planted across
the kernels' tile edges. Then what K5's kernel rests on: the fixed-point
shifts' range, over which a product with 2^sh is ldexp exactly; its 64-bit
sums kept as two 32-bit words; its half differences rounded once; the
spatial weights' two-bin rows; the orientation peak's first-maximum rule as
a warp reduces it.
"""
import importlib.util
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import REPO, n, t
from describe_inputs import describe_border

from sfm_tpu.features import descriptor as jdesc
from sfm_tpu.matching import retrieval as jret
from sfm_tpu_torch import _kernels
from sfm_tpu_torch.config import FeatureConfig
from sfm_tpu_torch.features import descriptor as tdesc
from sfm_tpu_torch.features.frontend import select_keypoints
from sfm_tpu_torch.matching import retrieval as tret
from sfm_tpu_torch.render_scene import _scene, render_view

F32 = np.float32
TWO_PI = F32(2 * np.pi)


# ---- K5 ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def view_inputs(tmp_path_factory):
    """K5's inputs on view 0 of the rendered corridor (1024 x 768) at the
    default 2,048 keypoints, the first of them moved onto octave borders."""
    quads, K, Rs, centers, cam, _, _ = _scene(tmp_path_factory.mktemp("scene"), 36, 0, 1)
    img = render_view(quads, K, Rs[0], centers[0], cam.width, cam.height, supersample=1)
    assert img.shape == (768, 1024)
    fc = FeatureConfig()
    kp = select_keypoints(torch.as_tensor(np.asarray(img))[None], None, fc)
    args = describe_border(torch, kp["describe"])
    return args, kp["valid"], fc


def test_describe_twin_against_jax_at_the_detection_shape(view_inputs):
    # Kernel K5's tolerance (chip_smoke's): >= 99.5% of the keypoints within
    # 1e-3 rad and 1e-3 L2 (the histograms are summed in another order); the
    # rest must be orientation near-ties. Every row is held, the border rows
    # and the selection's invalid rows too: the kernel writes them all.
    args, valid, fc = view_inputs
    canvas, gl, x, y, sr, ro, wo, ho = args
    assert canvas.shape[0] == 1 and x.shape == (1, fc.max_keypoints)
    assert 0 < int(valid.sum()) < fc.max_keypoints      # invalid rows present
    kw = dict(descriptor_scale=fc.descriptor_scale, clip=fc.descriptor_clip)
    ta, td = tdesc.orientation_and_descriptor_canvas(*args, **kw)
    ja, jd = jdesc.orientation_and_descriptor_canvas(
        jnp.asarray(n(canvas[0])), *(jnp.asarray(n(a[0])) for a in args[1:]), **kw)
    d = np.abs(n(ta[0]) - n(ja)) % (2 * np.pi)
    ok = (np.minimum(d, 2 * np.pi - d) <= 1e-3) & (
        np.linalg.norm(n(td[0]) - n(jd), axis=-1) <= 1e-3)
    assert ok.mean() >= 0.995, ok.mean()
    ties = n(tdesc.orientation_near_tie(*args))[0]
    assert (ok | ties).all(), np.nonzero(~(ok | ties))[0][:10]
    # The moved rows reach every octave's clamped borders.
    corner = (n(x[0]) < 1) & (n(y[0]) < 1)
    far = n(x[0]) > n(wo[0]) - 1
    assert corner.sum() >= 4 and far.sum() >= 4


def test_describe_twin_is_the_wrapper_on_cpu(view_inputs):
    args, _, fc = view_inputs
    sub = tuple(a[:, :64].contiguous() if a.dim() == 2 else a for a in args)
    a1, d1 = tdesc.orientation_and_descriptor_canvas(*sub)
    a2, d2 = tdesc.orientation_and_descriptor_canvas_plain(*sub)
    assert torch.equal(a1, a2) and torch.equal(d1, d2)


def _record_launch(monkeypatch):
    calls = []
    monkeypatch.setattr(_kernels, "launch", lambda name, dev, *a: calls.append((name, a)))
    return calls


def _k5_args(B=2, S=3, H=300, W=520, K=40):
    z = lambda *s, **k: torch.zeros(s, **k)
    return (z(B, S, H, W, dtype=torch.float16), z(B, K, dtype=torch.int64), z(B, K),
            z(B, K), torch.full((B, K), 1.6, dtype=torch.float64), z(B, K, dtype=torch.int64),
            torch.full((B, K), W), torch.full((B, K), H))


def test_describe_wrapper_launch_arguments(monkeypatch):
    # One launch: the canvas's four sizes, the keypoints' int32 / float32
    # parameters, K, the sample tables (uploaded once a device), the scale
    # and the clip, then the (B, K) angles and (B, K, 128) descriptors.
    calls = _record_launch(monkeypatch)
    args = _k5_args()
    angle, desc = tdesc.orientation_and_descriptor_canvas_cuda(*args, descriptor_scale=3.0,
                                                               clip=0.2)
    (name, a), = calls
    assert name == "sift_describe" and a[1:5] == (2, 3, 300, 520) and a[12] == 40
    assert a[0] is args[0]
    for i, dt in zip(range(5, 12), (torch.int32,) + (torch.float32,) * 3 + (torch.int32,) * 3):
        assert a[i].dtype == dt and a[i].shape == (2, 40) and a[i].is_contiguous()
    np.testing.assert_array_equal(n(a[13]), tdesc._K5_TABLES)
    assert a[13] is tdesc._k5_tables(args[0].device)
    assert a[14:16] == (3.0, pytest.approx(0.2)) and a[16] is angle and a[17] is desc
    assert angle.shape == (2, 40) and desc.shape == (2, 40, 128)


def test_describe_wrapper_refusals(monkeypatch):
    _record_launch(monkeypatch)
    args = _k5_args()
    with pytest.raises(ValueError, match="smaller than the patch"):
        tdesc.orientation_and_descriptor_canvas_cuda(*_k5_args(H=65))
    with pytest.raises(TypeError, match="canvas"):
        tdesc.orientation_and_descriptor_canvas_cuda(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="^y: shape"):
        tdesc.orientation_and_descriptor_canvas_cuda(*args[:3], args[3][:, :7], *args[4:])
    with pytest.raises(ValueError, match="device"):
        tdesc.orientation_and_descriptor_canvas(args[0].to("meta"), *args[1:])


def _frexp_shift(bound):
    """sfm_fx_shift of a finite double bound: 61 - e with bound < 2^e."""
    return 61 - math.frexp(bound)[1]


def test_fixed_point_shift_range_keeps_the_power_of_two_product_exact():
    # K5's terms are floats and its bounds a float sum (pass 1) or 16 x one
    # (pass 2), so its shifts lie in [-71, 209]: there x * 2^sh in double is
    # ldexp(x, sh) exactly for every finite float x (no overflow, no
    # subnormal), and an accumulated int64 times 2^-sh is ldexp(acc, -sh).
    tiny, big = float(np.float32(2.0 ** -149)), float(np.finfo(F32).max)
    shifts = [_frexp_shift(b) for b in (tiny, big, 16 * tiny, 16 * big)]
    assert (min(shifts), max(shifts)) == (-71, 209)
    assert _frexp_shift(0.0) == 61
    rng = np.random.default_rng(0)
    xs = np.concatenate([rng.standard_normal(2000).astype(F32) * F32(10.0) ** rng.integers(
        -40, 30, 2000).astype(F32), np.array([tiny, -tiny, big, -big, 1.0, 0.0], F32),
        np.float32(2.0) ** np.arange(-149, 128, dtype=F32)]).astype(np.float64)
    xs = xs[np.isfinite(xs)]
    for sh in range(-71, 210):
        scale = np.float64(2.0) ** sh
        np.testing.assert_array_equal(xs * scale, np.ldexp(xs, sh))
        # the kernel's 2^sh: the exponent field 1023 + sh
        assert np.array([(1023 + sh) << 52], np.int64).view(np.float64)[0] == scale
    accs = np.array([1, -1, 2**62, -(2**63), 123456789123, 2**53 + 1], np.int64).astype(np.float64)
    for sh in range(-71, 210):
        np.testing.assert_array_equal(accs * np.float64(2.0) ** -sh, np.ldexp(accs, -sh))


M32 = (1 << 32) - 1


def _two_word_sum(values):
    """The kernel's fx_add and fx_value on one bin: each term's low word added
    with a returned old word (its carry into the high word), then the pair
    read back as one int64."""
    lo = hi = 0
    for x in values:
        if x == 0:
            continue
        u = int(x) & ((1 << 64) - 1)
        vl, vh, carry = u & M32, u >> 32, 0
        if vl:
            old, lo = lo, (lo + vl) & M32
            carry = int(lo < old)
        if (vh + carry) & M32:
            hi = (hi + vh + carry) & M32
    total = (hi << 32) | lo
    return total - (1 << 64) if total >> 63 else total


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_word_fixed_point_sum_is_the_64_bit_sum_in_any_order(seed):
    # K5 keeps each 64-bit fixed-point bin as two 32-bit words (a 64-bit
    # shared-memory atomic add is a compare-and-swap loop on the card): the
    # pair must hold the int64 sum whatever the order of the terms, carries,
    # negative terms and wraps of either word included.
    rng = np.random.default_rng(seed)
    v = rng.integers(-(2**61), 2**61, 400, dtype=np.int64)
    v[::5] = rng.integers(0, 2**33, 80)
    v[1::9] = (2**32 - 1) * rng.integers(1, 4, 45)
    v[::13] = 0
    ref = int(np.sum(v.astype(object))) % (1 << 64)
    ref = ref - (1 << 64) if ref >> 63 else ref
    for _ in range(4):
        assert _two_word_sum(rng.permutation(v)) == ref


def test_half_differences_round_once():
    # The first design rounded each half difference to float, then to f16;
    # the kernel's __hsub2 rounds the exact difference to f16 once. Float's
    # 24 bits are at least 2 x 11 + 2, so the double rounding is innocuous:
    # every finite f16 minuend against 1,080 subtrahends (random, and every
    # power of two of either sign), overflow to inf included. The halving
    # that follows is exact in float, one rounding either way.
    finite = np.arange(65536, dtype=np.uint16).view(np.float16)
    finite = finite[np.isfinite(finite)]
    rng = np.random.default_rng(4)
    twos = np.float16(2.0) ** np.arange(-24, 16).astype(np.float16)
    lows = np.concatenate([rng.choice(finite, 1000, replace=False), twos, -twos])
    hi32, hi64 = finite.astype(np.float32)[:, None], finite.astype(np.float64)[:, None]
    with np.errstate(over="ignore"):
        for c in range(0, lows.size, 120):
            lo = lows[c:c + 120]
            twice = (hi32 - lo.astype(np.float32)[None]).astype(np.float16)
            once = (hi64 - lo.astype(np.float64)[None]).astype(np.float16)
            np.testing.assert_array_equal(twice.view(np.uint16), once.view(np.uint16))
    half32 = (np.float32(0.5) * finite.astype(np.float32)).astype(np.float16)
    half64 = (0.5 * finite.astype(np.float64)).astype(np.float16)
    np.testing.assert_array_equal(half32.view(np.uint16), half64.view(np.uint16))


def test_spatial_weights_rows_have_two_consecutive_bins():
    # The kernel visits, for each axis position, the first bin with a nonzero
    # weight and the next one: the first design's loop over all four bins
    # skipped the zero weights, so the terms are the same.
    w = tdesc._W_AXIS
    np.testing.assert_array_equal(tdesc._K5_TABLES[1536:], w.reshape(-1))
    for i in range(w.shape[0]):
        lo = next((b for b in range(3) if w[i, b] != 0), 3)
        nz = set(np.nonzero(w[i])[0])
        assert nz <= {lo, lo + 1} and lo in nz, (i, w[i])
    # Axis positions 0-1 and 14-15 weigh one bin, the rest two.
    assert [int((w[i] != 0).sum()) for i in range(16)] == [1] * 2 + [2] * 12 + [1] * 2


def _serial_peak(h):
    p = 0
    for i in range(1, len(h)):
        if h[i] > h[p]:
            p = i
    return p


def _warp_peak(h):
    """The kernel's rule: lane l takes bins l and 32 + l (l < 4, the later
    only if greater), NaN as -inf; an xor butterfly keeps the larger value,
    the lower bin on ties; a NaN bin 0 wins."""
    best = [(-np.inf if np.isnan(h[l]) else h[l], l) for l in range(32)]
    for l in range(len(h) - 32):
        if h[32 + l] > best[l][0]:
            best[l] = (h[32 + l], 32 + l)
    for off in (16, 8, 4, 2, 1):
        best = [max(best[l], best[l ^ off], key=lambda vp: (vp[0], -vp[1])) for l in range(32)]
    assert len(set(best)) == 1
    return 0 if np.isnan(h[0]) else best[0][1]


def test_orientation_peak_rule_as_the_warp_reduces_it():
    rng = np.random.default_rng(1)
    cases = [rng.random(36).astype(F32) for _ in range(200)]
    for _ in range(200):   # ties, within one lane's pair and across lanes
        h = rng.integers(0, 4, 36).astype(F32)
        cases.append(h)
    flat = np.zeros(36, F32)
    nan0 = rng.random(36).astype(F32)
    nan0[0] = np.nan
    some_nan = rng.random(36).astype(F32)
    some_nan[[3, 33, 20]] = np.nan
    cases += [flat, np.full(36, np.nan, F32), nan0, some_nan, np.full(36, -np.inf, F32)]
    for h in cases:
        assert _warp_peak(h) == _serial_peak(h), h


def test_pos_mod_fast_path_is_the_float_remainder():
    # fmodf(a, 2 pi) is a itself where |a| < 2 pi (pass 1's atan2, most of
    # pass 2's differences, the peak), so the kernel calls fmodf only past it.
    rng = np.random.default_rng(2)
    a = np.concatenate([rng.uniform(-20, 20, 5000), [0.0, -0.0, np.pi, -np.pi, 6.2831853,
                                                     -6.2831855, 1e-30]]).astype(F32)
    fast = np.where(np.abs(a) < TWO_PI, a, np.fmod(a, TWO_PI))
    np.testing.assert_array_equal(fast.view(np.int32), np.fmod(a, TWO_PI).view(np.int32))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k5_bound_reads_each_covered_canvas_element_once(view_inputs):
    # chip_smoke's K5 bound counts the canvas elements that the union of the
    # clamped patches covers, held here against marking every patch the
    # twin's slice reads; plus 7 parameters in and 129 floats out a keypoint.
    args, _, _ = view_inputs
    canvas, gl, x, y, _, ro, wo, ho = args
    B, S, sumH, W = canvas.shape
    g0x, g0y = tdesc._patch_origin(x, y, wo, ho)
    r0 = torch.clamp(ro + g0y, 0, sumH - tdesc._GPATCH)
    c0 = torch.clamp(g0x, 0, W - tdesc._GPATCH)
    lay = torch.clamp(gl, 0, S - 1)
    seen = torch.zeros(canvas.shape, dtype=torch.bool)
    for b, l, r, c in zip(*(np.broadcast_to(np.arange(B)[:, None], x.shape).ravel(),
                            n(lay).ravel(), n(r0).ravel(), n(c0).ravel())):
        seen[b, l, r:r + tdesc._GPATCH, c:c + tdesc._GPATCH] = True
    K = x.numel()
    got = _chip_smoke().k5_moved_bytes(torch, *args)
    assert got == int(seen.sum()) * 2 + K * (7 * 4 + 129 * 4)
    assert got < K * (66 * 66 * 2 + 7 * 4 + 129 * 4)   # the patches overlap


# ---- K1-r --------------------------------------------------------------------

N_IMG, S_RET, D_RET, STEP = 150, 256, 128, 40


def exact_unit_table(rng, N=N_IMG, S=S_RET, D=D_RET, step=STEP):
    """(N, S, D) unit descriptors whose dot products are exact in float32:
    64 of 128 entries +-1/8, so every dot is a multiple of 1/64. Image k sees
    points step*k .. step*k + S - 1 of a strip in a shuffled order, each with
    0-3 signs flipped (distance k/16); ties planted across the kernels' tile
    edges (rows and columns 63 / 64 and 127 / 128 repeated in every third
    image); image 5 has no valid keypoint, 8% of the rest are invalid."""
    pts = np.zeros((step * N + S, D), F32)
    for i in range(pts.shape[0]):
        on = rng.choice(D, 64, replace=False)
        pts[i, on] = np.where(rng.random(64) < 0.5, -0.125, 0.125)
    ids = np.stack([rng.permutation(np.arange(S) + step * k) for k in range(N)])
    desc = pts[ids]
    flips = rng.integers(0, 4, (N, S))
    for k in range(N):
        for s in range(S):
            nz = np.nonzero(desc[k, s])[0]
            desc[k, s, rng.choice(nz, flips[k, s], replace=False)] *= -1
    for a, b in ((63, 64), (127, 128)):
        desc[::3, b] = desc[::3, a]
    valid = rng.random((N, S)) > 0.08
    valid[5] = False
    return desc, valid


def chunk_pairs(N=N_IMG):
    p = [(k, k + d) for d in range(1, 8) for k in range(N - d)] + [(0, 149), (3, 90)]
    return np.asarray(p, np.int32)


@pytest.fixture(scope="module")
def retrieval_chunk():
    desc, valid = exact_unit_table(np.random.default_rng(11))
    pairs = chunk_pairs()
    assert pairs.shape == (1024, 2)
    np.testing.assert_array_equal(np.linalg.norm(desc, axis=-1), 1.0)
    return pairs, desc, valid


def _jax_counts(pairs, desc, valid, ratio, step=256):
    return np.concatenate([np.asarray(jret._score_chunk(
        jnp.asarray(pairs[c:c + step]), jnp.asarray(desc), jnp.asarray(valid), ratio))
        for c in range(0, pairs.shape[0], step)])


@pytest.mark.parametrize("S", [256, 100])
def test_score_chunk_twin_against_jax_on_a_full_chunk(retrieval_chunk, S):
    # Exact dot products: the counts must be equal, pair for pair.
    pairs, desc, valid = retrieval_chunk
    desc, valid = np.ascontiguousarray(desc[:, :S]), np.ascontiguousarray(valid[:, :S])
    ref = _jax_counts(pairs, desc, valid, 0.75)
    got = n(tret.score_chunk_plain(t(pairs), t(desc), t(valid), 0.75))
    np.testing.assert_array_equal(got, ref)
    assert got.max() >= 10 and (got[(pairs == 5).any(1)] == 0).all()
    assert (got[pairs[:, 1] - pairs[:, 0] == 7] < got[pairs[:, 1] - pairs[:, 0] == 1].mean()).all()


def test_planted_ties_cross_the_tile_edges(retrieval_chunk):
    # Rows 63 / 64 and 127 / 128 of every third image are equal: a column
    # matching them ties in both directions, and the lowest index wins in
    # the twin and in JAX alike (here with the whole chunk's counts).
    pairs, desc, valid = retrieval_chunk
    assert np.array_equal(desc[0, 127], desc[0, 128]) and np.array_equal(desc[3, 63], desc[3, 64])
    d = (2 - 2 * desc[1] @ desc[3].T).astype(F32)
    assert (d[:, 127] == d[:, 128]).all()
    sel = (pairs % 3 == 0).any(1)
    ref = _jax_counts(pairs[sel], desc, valid, 0.9)
    got = n(tret.score_chunk_plain(t(pairs[sel]), t(desc), t(valid), 0.9))
    np.testing.assert_array_equal(got, ref)


def test_retrieval_scores_runs_the_chunk_loop(monkeypatch, retrieval_chunk):
    # retrieval_scores keeps its loop over chunk_size pairs: 11 chunks for
    # path d's 11,175 pairs, the last of 935.
    from sfm_tpu_torch.config import RetrievalConfig

    pairs, desc, valid = retrieval_chunk
    sizes = []
    real = tret.score_chunk

    def record(p, *a):
        sizes.append(p.shape[0])
        return real(p, *a)

    monkeypatch.setattr(tret, "score_chunk", record)
    i, j = np.triu_indices(N_IMG, k=1)
    all_pairs = np.stack([i, j], -1).astype(np.int32)
    cfg = RetrievalConfig(subsample=8)
    out = tret.retrieval_scores(t(desc), valid, all_pairs, cfg)
    assert sizes == [cfg.chunk_size] * 10 + [935] and out.shape == (11175,)


def test_retrieval_wrapper_launch_arguments_and_refusals(monkeypatch):
    calls = _record_launch(monkeypatch)
    z = lambda *s, **k: torch.zeros(s, **k)
    pairs = z(1024, 2, dtype=torch.int32)
    desc, valid = z(150, 256, 128), z(150, 256, dtype=torch.bool)
    counts = tret.score_chunk_cuda(pairs, desc, valid, 0.75)
    (name, a), = calls
    assert name == "retrieval_score" and all(x is y for x, y in zip(a[:3], (desc, valid, pairs)))
    assert a[3:7] == (150, 256, 128, 1024) and a[7] == pytest.approx(0.5625)
    assert a[8] is counts and counts.dtype == torch.int32 and counts.shape == (1024,)
    tret.score_chunk_cuda(pairs[:0], desc, valid, 0.75)      # no pairs: no launch
    assert len(calls) == 1
    with pytest.raises(ValueError, match="S=1025"):
        tret.score_chunk_cuda(pairs, z(2, 1025, 128), z(2, 1025, dtype=torch.bool), 0.75)
    with pytest.raises(ValueError, match="D=100"):
        tret.score_chunk_cuda(pairs, z(2, 8, 100), z(2, 8, dtype=torch.bool), 0.75)
    with pytest.raises(TypeError, match="pairs"):
        tret.score_chunk_cuda(pairs.long(), desc, valid, 0.75)
    with pytest.raises(ValueError, match="device"):
        tret.score_chunk(pairs.to("meta"), desc.to("meta"), valid.to("meta"), 0.75)
