"""The FAST + ORB-class binary frontend, batched over images.

Counterpart of ``sfm_tpu/features/binary.py`` (kernel K12): FAST-9/16
corners with 3x3 non-max suppression on a small pyramid, and 256 rotation
-steered BRIEF tests per keypoint on a sigma = 2 blurred bf16 plane, emitted
as +-1/16 unit vectors so that the SIFT path's squared-L2 matcher, sweep,
retrieval and guided rescue run unchanged (squared-L2 = Hamming / 64).

Three CUDA kernels carry the per-pixel and per-keypoint work: ``fast_nms``
(arc test, score, border and mask gates, NMS) and ``orb_describe`` (patch,
intensity-centroid angle, steering bin, the 256 tests) in ``csrc/orb.cu``,
and ``orb_blur`` (kernel K3's tiled blur, stored as bf16) as a second
entry of ``csrc/pyramid.cu``. Each has a
plain PyTorch twin here that runs on CPU tensors; a CUDA tensor launches
the kernel or raises. Candidate selection is kernel K4's ``dog_select``
with one layer, the merge of the levels K4's ``topk_rows``, and each upper
level's resize two float32 matmuls with ``jax.image.resize``'s weights.

The module keeps its own copy of the reference's constants (the BRIEF
pattern, its steering tables, the FAST ring and the moment weights);
``tests/test_torch_host_copies.py`` holds them against the originals.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from sfm_tpu_torch import _kernels
from sfm_tpu_torch.config import FeatureConfig
from sfm_tpu_torch.estimators.ransac import top_k
from sfm_tpu_torch.features.detect import select_octave_candidates
from sfm_tpu_torch.features.pyramid import gaussian_blur, k3_blur_plan

PATCH = 33          # descriptor/orientation patch edge (center at 16)
HALF = PATCH // 2
N_BITS = 256        # descriptor length (ORB parity)
N_ANGLE_BINS = 30   # 12-degree steering resolution (ORB's)
BORDER = HALF + 1   # min keypoint distance from the image edge
BLUR_SIGMA = 2.0    # the blur of the plane the moments and tests read
KP_SIGMA = 7.0 / 2.0  # FAST keypoint size 7
# angle -> steering bin factor, as the reference's f32 product rounds it.
_BIN_SCALE = float(np.float32(N_ANGLE_BINS / (2.0 * np.pi)))

# Radius-3 Bresenham circle, 16 samples clockwise from 12 o'clock -- the
# standard FAST-9/16 test ring. (dy, dx), y down.
_RING = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], np.int32)


def _make_pattern(seed: int = 20140413, n: int = N_BITS, sigma: float = 6.2,
                  rmax: float = 14.5, min_sep: float = 2.0):
    """BRIEF test pattern: n (p, q) point pairs, Gaussian about the center,
    inside a radius-``rmax`` disk so every steered rotation stays inside the
    33x33 patch; pairs closer than ``min_sep`` are re-drawn."""
    rng = np.random.default_rng(seed)

    def draw(k):
        out = np.empty((0, 2))
        while len(out) < k:
            c = rng.normal(0.0, sigma, size=(4 * k, 2))
            c = c[np.hypot(c[:, 0], c[:, 1]) <= rmax]
            out = np.concatenate([out, c])
        return out[:k]

    p, q = draw(n), draw(n)
    for _ in range(64):
        close = np.hypot(*(p - q).T) < min_sep
        if not close.any():
            break
        q[close] = draw(int(close.sum()))
    return p, q


def _steer_tables():
    """(N_ANGLE_BINS, N_BITS) int32 flat patch indices of each test point,
    one row per quantized orientation (nearest-pixel sampling)."""
    p, q = _make_pattern()
    t1 = np.zeros((N_ANGLE_BINS, N_BITS), np.int32)
    t2 = np.zeros((N_ANGLE_BINS, N_BITS), np.int32)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        for tbl, pts in ((t1, p), (t2, q)):
            x = pts[:, 0] * c - pts[:, 1] * s
            y = pts[:, 0] * s + pts[:, 1] * c
            xi = np.clip(np.round(x).astype(np.int64) + HALF, 0, PATCH - 1)
            yi = np.clip(np.round(y).astype(np.int64) + HALF, 0, PATCH - 1)
            tbl[b] = (yi * PATCH + xi).astype(np.int32)
    return t1, t2


_STEER1, _STEER2 = _steer_tables()

# Intensity-centroid moment weights: circular radius-15 window (ORB's
# IC_Angle footprint) on the patch's local coordinates.
_UU = np.arange(PATCH) - HALF
_IC_DISK = (np.hypot(*np.meshgrid(_UU, _UU)) <= 15.0)
_IC_WX = (_IC_DISK * _UU[None, :]).astype(np.float32).ravel()   # weight = x
_IC_WY = (_IC_DISK * _UU[:, None]).astype(np.float32).ravel()   # weight = y


# ---------------------------------------------------------------- fast_nms

def fast_scores(image: torch.Tensor, threshold: float) -> torch.Tensor:
    """(B, H, W) f32 [0, 1] -> (B, H, W) FAST-9/16 corner score (0 = none).

    A pixel passes if >= 9 contiguous ring samples are all brighter than
    center + t or all darker than center - t; its score is the summed
    contrast beyond t of the polarity that passed. The ring is read with
    circular rolls (the border band keeps the wrap from a kept pixel); the
    16 terms are summed in ring order.
    """
    t = float(np.float32(threshold))
    hi, lo = image + t, image - t
    bright, dark = [], []
    sb = torch.zeros_like(image)
    sd = torch.zeros_like(image)
    for dy, dx in _RING:
        r = torch.roll(image, (-int(dy), -int(dx)), dims=(-2, -1))
        b, d = r > hi, r < lo
        bright.append(b)
        dark.append(d)
        sb = sb + torch.where(b, (r - image) - t, 0.0)
        sd = sd + torch.where(d, (image - r) - t, 0.0)

    def has_arc9(m):
        # AND over 9 consecutive ring positions, all 16 circular starts.
        m = torch.stack(m)
        w2 = m & torch.roll(m, -1, 0)
        w4 = w2 & torch.roll(w2, -2, 0)
        w8 = w4 & torch.roll(w4, -4, 0)
        return (w8 & torch.roll(m, -8, 0)).any(0)

    return torch.maximum(torch.where(has_arc9(bright), sb, 0.0),
                         torch.where(has_arc9(dark), sd, 0.0))


def _nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression of (B, H, W) over a -inf padded window (ties
    survive)."""
    mx = F.max_pool2d(score[:, None], 3, stride=1, padding=1)[:, 0]
    return torch.where(score >= mx, score, 0.0)


def fast_nms_plain(image: torch.Tensor, threshold: float, mask=None) -> torch.Tensor:
    """The FAST score, zeroed in the ``BORDER`` band and outside ``mask``
    (B, H, W bool, or None), then :func:`_nms3`. Plain twin of kernel K12's
    ``fast_nms``."""
    score = fast_scores(image, threshold)
    h, w = image.shape[-2:]
    yy = torch.arange(h, device=image.device)[:, None]
    xx = torch.arange(w, device=image.device)[None, :]
    inb = (yy >= BORDER) & (yy < h - BORDER) & (xx >= BORDER) & (xx < w - BORDER)
    score = torch.where(inb, score, 0.0)
    if mask is not None:
        score = torch.where(mask, score, 0.0)
    return _nms3(score)


def fast_nms_cuda(image: torch.Tensor, threshold: float, mask=None) -> torch.Tensor:
    B, h, w = image.shape
    dev = image.device
    _kernels.check_tensor(image, "image", torch.float32, (B, h, w), dev)
    if mask is not None:
        _kernels.check_tensor(mask, "mask", torch.bool, (B, h, w), dev)
    out = torch.empty((B, h, w), dtype=torch.float32, device=dev)
    _kernels.launch("orb_fast_nms", dev, image, None if mask is None else mask, B, h, w,
                    float(np.float32(threshold)), out)
    return out


def fast_nms(image: torch.Tensor, threshold: float, mask=None) -> torch.Tensor:
    """Kernel K12 ``fast_nms`` on a CUDA tensor, :func:`fast_nms_plain` on CPU."""
    if image.is_cuda:
        return fast_nms_cuda(image.contiguous(), threshold,
                             None if mask is None else mask.contiguous())
    if image.device.type == "cpu":
        return fast_nms_plain(image, threshold, mask)
    raise ValueError(f"fast_nms: unsupported device {image.device}")


# ---------------------------------------------------------------- orb_blur

def orb_blur_plain(image: torch.Tensor) -> torch.Tensor:
    """(B, H, W) f32 -> the sigma = 2 blur (SAME zero pad, the reference's
    exact shift-add order), rounded to bf16. Plain twin of ``orb_blur``."""
    return gaussian_blur(image, BLUR_SIGMA).to(torch.bfloat16)


def orb_blur_cuda(image: torch.Tensor) -> torch.Tensor:
    B, h, w = image.shape
    dev = image.device
    _kernels.check_tensor(image, "image", torch.float32, (B, h, w), dev)
    taps, radii = k3_blur_plan([BLUR_SIGMA])
    out = torch.empty((B, h, w), dtype=torch.bfloat16, device=dev)
    _kernels.launch("orb_blur", dev, image, B, h, w, torch.from_numpy(taps[0]), int(radii[0]),
                    out)
    return out


def orb_blur(image: torch.Tensor) -> torch.Tensor:
    """Kernel K12 ``orb_blur`` on a CUDA tensor, :func:`orb_blur_plain` on CPU."""
    if image.is_cuda:
        return orb_blur_cuda(image.contiguous())
    if image.device.type == "cpu":
        return orb_blur_plain(image)
    raise ValueError(f"orb_blur: unsupported device {image.device}")


# ---------------------------------------------------------------- orb_describe

def orb_describe_plain(blur16: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                       valid: torch.Tensor):
    """Steered BRIEF of each keypoint. blur16 (B, H, W) bf16; x, y (B, K)
    int64 pixel centers; valid (B, K). Returns angle (B, K) f32 and desc
    (B, K, 256) f32 in {+-1/16}; invalid rows are zero.

    The moments are summed in float64, where every bf16 x integer product
    and their sum are exact, and rounded once to f32; bit i is
    ``patch[p_i] < patch[q_i]`` on the bf16 values (equal values give -1/16).
    Plain twin of kernel K12's ``orb_describe``.
    """
    B, H, W = blur16.shape
    K = x.shape[1]
    dev = blur16.device
    off = torch.arange(PATCH, device=dev)
    # dynamic_slice's clamp keeps padding rows inside the plane.
    y0 = torch.clamp(y - HALF, 0, H - PATCH)
    x0 = torch.clamp(x - HALF, 0, W - PATCH)
    idx = ((y0[..., None] + off)[..., :, None] * W
           + (x0[..., None] + off)[..., None, :]).reshape(B, K * PATCH * PATCH)
    patch = torch.gather(blur16.reshape(B, H * W), 1, idx).reshape(B, K, PATCH * PATCH)
    pd = patch.to(torch.float64)
    m10 = (pd @ torch.as_tensor(_IC_WX, dtype=torch.float64, device=dev)).to(torch.float32)
    m01 = (pd @ torch.as_tensor(_IC_WY, dtype=torch.float64, device=dev)).to(torch.float32)
    angle = torch.atan2(m01, m10)
    frac = angle * torch.tensor(_BIN_SCALE, dtype=torch.float32, device=dev)
    bins = torch.remainder(torch.round(frac).to(torch.int64), N_ANGLE_BINS)
    s1 = torch.as_tensor(_STEER1, dtype=torch.int64, device=dev)[bins]
    s2 = torch.as_tensor(_STEER2, dtype=torch.int64, device=dev)[bins]
    bits = torch.gather(patch, 2, s1) < torch.gather(patch, 2, s2)
    desc = torch.where(bits, 1.0 / 16.0, -1.0 / 16.0).to(torch.float32)
    desc = torch.where(valid[..., None], desc, 0.0)
    return torch.where(valid, angle, 0.0), desc


@functools.lru_cache(maxsize=None)
def _steer_on(device: torch.device) -> torch.Tensor:
    """The (2, 30, 256) int16 steering tables on ``device`` (the kernel
    copies them into constant memory at each launch)."""
    return torch.as_tensor(np.stack([_STEER1, _STEER2]).astype(np.int16), device=device)


def orb_describe_cuda(blur16, x, y, valid):
    B, H, W = blur16.shape
    K = x.shape[1]
    dev = blur16.device
    if H < PATCH or W < PATCH:
        raise ValueError(f"orb_describe: plane {H}x{W} smaller than the {PATCH}-px patch")
    _kernels.check_tensor(blur16, "blur16", torch.bfloat16, (B, H, W), dev)
    for name, t in (("x", x), ("y", y)):
        _kernels.check_tensor(t, name, torch.int64, (B, K), dev)
    _kernels.check_tensor(valid, "valid", torch.bool, (B, K), dev)
    angle = torch.empty((B, K), dtype=torch.float32, device=dev)
    desc = torch.empty((B, K, N_BITS), dtype=torch.float32, device=dev)
    _kernels.launch("orb_describe", dev, blur16, B, H, W, x, y, valid, K, _steer_on(dev),
                    _BIN_SCALE, angle, desc)
    return angle, desc


def orb_describe(blur16, x, y, valid):
    """Kernel K12 ``orb_describe`` on CUDA tensors, :func:`orb_describe_plain` on CPU."""
    if blur16.is_cuda:
        return orb_describe_cuda(blur16.contiguous(), x.contiguous(), y.contiguous(),
                                 valid.contiguous())
    if blur16.device.type == "cpu":
        return orb_describe_plain(blur16, x, y, valid)
    raise ValueError(f"orb_describe: unsupported device {blur16.device}")


# ---------------------------------------------------------------- the pyramid

def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize(..., "linear")``
    along one axis (``jax.image.compute_weight_mat`` with antialias): a
    triangle kernel at half-pixel centers, widened by the downscale,
    renormalized per output, outputs sampled outside the input zeroed.

    The arithmetic is float32, as JIT-compiled JAX rounds it: the sample
    positions (o + 0.5) * inv_scale - 0.5 in one fused multiply-add (one
    rounding, emulated in float64, where the product is exact), the
    distances scaled by the reciprocal of the kernel width. Near 768 px a
    sample's float32 step is 6e-5, so the rounding is not a detail."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    inv_width = f32(1) / f32(max(1.0 / (n_out / n_in), 1.0))
    center = np.arange(n_out, dtype=f32) + f32(0.5)
    sample = (center.astype(np.float64) * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) * inv_width
    wts = np.maximum(f32(0), f32(1) - x).astype(f32)
    total = np.zeros((1, n_out), f32)
    for row in wts:              # the reduction in input order
        total = total + row[None]
    wts = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                   wts / np.where(total != 0, total, f32(1)), f32(0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], wts, f32(0)).astype(f32)


def resize_linear(image: torch.Tensor, hl: int, wl: int) -> torch.Tensor:
    """(B, H, W) f32 -> (B, hl, wl): ``jax.image.resize(image, (hl, wl),
    "linear")`` (antialiased) as two float32 matmuls, rows then columns."""
    H, W = image.shape[-2:]
    as_t = lambda a: torch.as_tensor(a, device=image.device)
    out = image
    if hl != H:
        out = as_t(np.ascontiguousarray(resize_weights(H, hl).T)) @ out
    if wl != W:
        out = out @ as_t(resize_weights(W, wl))
    return out


def _level_budgets(base: int, n_levels: int, factor: float):
    """Per-level keypoint budgets: level 0 keeps the full ``base``; upper
    levels add rows in proportion to their pixel count (1 / factor^2l),
    rounded up to a multiple of 8."""
    w = np.power(1.0 / (factor * factor), np.arange(1, n_levels))
    extra = [int(np.ceil(base * wi / 8) * 8) for wi in w]
    return [int(base)] + extra


def level_shape(h: int, w: int, level: int, factor: float):
    s = float(factor) ** level
    return (max(int(round(h / s)), 2 * BORDER + 2), max(int(round(w / s)), 2 * BORDER + 2))


def _detect_orb_level(image: torch.Tensor, mask, config: FeatureConfig, budget: int) -> dict:
    """Single-scale FAST + steered BRIEF on (B, H, W) f32 ``image`` (mask:
    (B, H, W) bool or None). Returns (B, budget) fields xy, sigma, angle,
    response, desc (B, budget, 256), valid; invalid rows zeroed."""
    from sfm_tpu_torch.features.frontend import dilate_mask  # no import cycle

    if mask is not None and config.mask_dilate > 0:
        mask = dilate_mask(mask, config.mask_dilate)
    score = fast_nms(image, config.fast_threshold / 255.0, mask)
    cands = select_octave_candidates({"score": score[:, None]}, budget)
    x, y, resp = cands["x"], cands["y"], cands["score"]
    valid = resp > 0
    angle, desc = orb_describe(orb_blur(image), x, y, valid)
    xy = torch.stack([x.to(torch.float32), y.to(torch.float32)], dim=-1)
    return {
        "xy": torch.where(valid[..., None], xy, 0.0),
        "sigma": torch.where(valid, KP_SIGMA, 0.0).to(torch.float32),
        "angle": angle,
        "response": torch.where(valid, resp, 0.0),
        "desc": desc,
        "valid": valid,
    }


FIELDS = ("xy", "sigma", "angle", "response", "desc", "valid")


def detect_orb(image: torch.Tensor, mask, config: FeatureConfig) -> dict:
    """(B, H, W) f32 [0, 1] images (+ optional (B, H, W) bool masks) -> the
    fields of :class:`~sfm_tpu_torch.features.frontend.Features`: the
    single-scale core, or with ``config.orb_levels > 1`` the pyramid."""
    if config.orb_levels > 1:
        return _detect_orb_pyramid(image, mask, config)
    return _detect_orb_level(image, mask, config, config.max_keypoints)


def _detect_orb_pyramid(image: torch.Tensor, mask, config: FeatureConfig) -> dict:
    """The single-scale core on ``jax.image.resize`` levels too (1 /
    orb_scale_factor per level); their keypoints map back to level-0 pixels
    (half-pixel centers: x * sx + (sx - 1) / 2, sx = W / w_l) and all levels
    merge into one response-ordered table (invalid rows last, ties in row
    order) of sum(:func:`_level_budgets`) rows."""
    from sfm_tpu_torch.features.frontend import _take  # no import cycle

    H, W = image.shape[-2:]
    budgets = _level_budgets(config.max_keypoints, config.orb_levels,
                             config.orb_scale_factor)
    parts = []
    for lvl, budget in enumerate(budgets):
        if budget <= 0:
            continue
        if lvl == 0:
            parts.append(_detect_orb_level(image, mask, config, budget))
            continue
        hl, wl = level_shape(H, W, lvl, config.orb_scale_factor)
        im_l = resize_linear(image, hl, wl)
        mk_l = None if mask is None else resize_linear(mask.to(torch.float32), hl, wl) > 0.5
        f = _detect_orb_level(im_l, mk_l, config, budget)
        sy, sx = H / hl, W / wl
        scale = torch.tensor([sx, sy], dtype=torch.float32, device=image.device)
        off = torch.tensor([(sx - 1) / 2, (sy - 1) / 2], dtype=torch.float32,
                           device=image.device)
        f["xy"] = torch.where(f["valid"][..., None], f["xy"] * scale + off, 0.0)
        f["sigma"] = f["sigma"] * torch.tensor((sx + sy) / 2, dtype=torch.float32,
                                               device=image.device)
        parts.append(f)
    cat = {k: torch.cat([p[k] for p in parts], dim=1) for k in FIELDS}
    key = torch.where(cat["valid"], cat["response"], -torch.inf)
    _, order = top_k(key, key.shape[1])
    return {k: _take(v, order) for k, v in cat.items()}
