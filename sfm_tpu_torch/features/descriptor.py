"""Orientation assignment + 128-D SIFT descriptor from a multi-octave canvas.

Counterpart of the canvas path of ``sfm_tpu/features/descriptor.py``
(``orientation_and_descriptor_canvas`` and the helpers it calls). Per
keypoint: a 66x66 Gaussian patch, half-precision central differences, 256
bilinear samples into a soft-binned 36-bin orientation histogram (two
[1,4,6,4,1]/16 smoothings, parabolic peak), then 256 rotated samples into a
4x4x8 trilinear histogram, normalized, clipped and renormalized.

The whole per-keypoint computation is kernel K5 (``csrc/sift_describe.cu``);
:func:`orientation_and_descriptor_canvas_plain` is its plain twin. Both read
the same static sample tables, built here with the reference's numpy
expressions.
"""
from __future__ import annotations

import numpy as np
import torch

from sfm_tpu_torch import _kernels

_TWO_PI = 2.0 * np.pi

PATCH = 64
_GPATCH = PATCH + 2  # Gaussian patch incl. a 1-px border for central differences


def _unit_grid(n: int):
    """n x n sample offsets with unit half-extent, flattened to (n*n, [x, y])."""
    c = (np.arange(n, dtype=np.float32) + 0.5) / n * 2.0 - 1.0
    u, v = np.meshgrid(c, c)
    return np.stack([u.reshape(-1), v.reshape(-1)], axis=-1)


def _spatial_weights(n_samples_axis: int = 16, n_bins: int = 4):
    """Per-axis bilinear weights from sample position (bin units) to bin."""
    coords = ((np.arange(n_samples_axis) + 0.5) / n_samples_axis) * n_bins - n_bins / 2.0
    centers = np.arange(n_bins) - (n_bins - 1) / 2.0
    d = np.abs(coords[:, None] - centers[None, :])
    return np.maximum(0.0, 1.0 - d).astype(np.float32)


_ORI_GRID = _unit_grid(16)                                   # (256, 2) in [-1, 1]
_ORI_W = np.exp(-4.5 * np.sum(_ORI_GRID**2, axis=-1)).astype(np.float32)
_DESC_N = 16
_DESC_BINS = 4
_DESC_GRID = _unit_grid(_DESC_N) * (_DESC_BINS / 2.0)         # (256, 2) bin units
_W_AXIS = _spatial_weights(_DESC_N, _DESC_BINS)               # (16, 4)
_W_SPATIAL = np.einsum(
    "ib,jc->ijbc", _W_AXIS, _W_AXIS
).reshape(_DESC_N, _DESC_N, -1).reshape(-1, _DESC_BINS * _DESC_BINS)
_DESC_WG = np.exp(
    -np.sum(_DESC_GRID**2, axis=-1) / (2.0 * (_DESC_BINS / 2.0) ** 2)
).astype(np.float32)
# Packed for the kernel: ori grid (512) | ori weight (256) | desc grid (512)
# | desc window (256) | per-axis spatial weights (64).
_K5_TABLES = np.concatenate([
    _ORI_GRID.reshape(-1), _ORI_W, _DESC_GRID.reshape(-1).astype(np.float32),
    _DESC_WG, _W_AXIS.reshape(-1)]).astype(np.float32)


def _t(a, device):
    return torch.as_tensor(a, device=device)


_TABLES_ON: dict = {}  # device -> _K5_TABLES there


def _k5_tables(device):
    """The kernel's tables on ``device``, uploaded once: a copy from pageable
    host memory holds the host until the device has run every kernel before it."""
    t = _TABLES_ON.get(device)
    if t is None:
        t = _TABLES_ON[device] = _t(_K5_TABLES, device)
    return t


def _patch_origin(x, y, w_o, h_o):
    """Patch corner (g0x, g0y) in octave coordinates, as the reference clips it."""
    cx = torch.round(x).to(torch.int64)
    cy = torch.round(y).to(torch.int64)
    g0x = torch.minimum(torch.clamp(cx - (PATCH // 2 + 1), min=0), torch.clamp(w_o - _GPATCH, min=0))
    g0y = torch.minimum(torch.clamp(cy - (PATCH // 2 + 1), min=0), torch.clamp(h_o - _GPATCH, min=0))
    return g0x, g0y


def _extract_grad_patches(canvas, grad_layer, x, y, row_off, w_o, h_o):
    """(B, S, sumH, Wmax) f16 canvas -> (B, K, 64, 64) float32 gradients.

    The slice start is clamped into the canvas like ``lax.dynamic_slice``;
    differences are taken in float16 and then widened.
    """
    B, S, sumH, Wmax = canvas.shape
    g0x, g0y = _patch_origin(x, y, w_o, h_o)
    r0 = torch.clamp(row_off + g0y, 0, sumH - _GPATCH)
    c0 = torch.clamp(g0x, 0, Wmax - _GPATCH)
    lay = torch.clamp(grad_layer, 0, S - 1)
    ar = torch.arange(_GPATCH, device=canvas.device)
    bidx = torch.arange(B, device=canvas.device)[:, None, None, None]
    patch = canvas[bidx, lay[..., None, None], (r0[..., None] + ar)[..., :, None],
                   (c0[..., None] + ar)[..., None, :]]                # (B, K, 66, 66)
    gxp = (0.5 * (patch[..., 1:-1, 2:] - patch[..., 1:-1, :-2])).to(torch.float32)
    gyp = (0.5 * (patch[..., 2:, 1:-1] - patch[..., :-2, 1:-1])).to(torch.float32)
    return gxp, gyp, g0x + 1, g0y + 1


def _sample(gxp, gyp, xr, yr):
    """Bilinear samples of (B, K, P, P) gradient patches at (B, K, n) patch
    coordinates; returns (vx, vy, ok)."""
    P = gxp.shape[-1]
    ok = (xr >= 0) & (xr <= P - 1.001) & (yr >= 0) & (yr <= P - 1.001)
    # A NaN coordinate is masked by ``ok``; it must still index inside the
    # patch (XLA clamps a gather index, torch.gather raises).
    xc = torch.clamp(torch.nan_to_num(xr), 0.0, P - 1.001)
    yc = torch.clamp(torch.nan_to_num(yr), 0.0, P - 1.001)
    x0 = torch.floor(xc)
    y0 = torch.floor(yc)
    fx = xc - x0
    fy = yc - y0
    i00 = (y0 * P + x0).to(torch.int64)

    def tap(g, off):
        return torch.gather(g.flatten(-2), -1, i00 + off)

    def interp(g):
        t0 = (1.0 - fy) * tap(g, 0) + fy * tap(g, P)
        t1 = (1.0 - fy) * tap(g, 1) + fy * tap(g, P + 1)
        return (1.0 - fx) * t0 + fx * t1

    return interp(gxp), interp(gyp), ok


def _soft_bins(theta, num_bins: int):
    b = theta * (num_bins / _TWO_PI)
    b0 = torch.floor(b)
    frac = b - b0
    b0 = torch.remainder(b0.to(torch.int64), num_bins)
    return b0, torch.remainder(b0 + 1, num_bins), frac


def _in_image(xs, ys, w_o, h_o):
    w = w_o[..., None].to(torch.float32)
    h = h_o[..., None].to(torch.float32)
    return (xs >= 0) & (xs <= w - 1.001) & (ys >= 0) & (ys <= h - 1.001)


def _orientation_hist(gxp, gyp, sx, sy, x, y, sigma_rel, w_o, h_o, num_bins: int = 36):
    """The smoothed (B, K, num_bins) orientation histogram."""
    dev = x.device
    grid = _t(_ORI_GRID, dev)
    offs = grid * (4.5 * sigma_rel)[..., None, None]              # (B, K, 256, 2)
    xs = x[..., None] + offs[..., 0]
    ys = y[..., None] + offs[..., 1]
    inb = _in_image(xs, ys, w_o, h_o)
    vx, vy, ok = _sample(gxp, gyp, xs - sx[..., None], ys - sy[..., None])
    mag = torch.sqrt(vx * vx + vy * vy)
    theta = torch.remainder(torch.atan2(vy, vx), _TWO_PI)
    wgt = mag * _t(_ORI_W, dev) * (inb & ok)
    b0, b1, frac = _soft_bins(theta, num_bins)
    hist = torch.zeros(wgt.shape[:-1] + (num_bins,), dtype=torch.float32, device=dev)
    hist.scatter_add_(-1, b0, wgt * (1 - frac))
    hist.scatter_add_(-1, b1, wgt * frac)
    for _ in range(2):
        roll = lambda s: torch.roll(hist, s, dims=-1)
        hist = (6 * hist + 4 * (roll(1) + roll(-1)) + (roll(2) + roll(-2))) / 16.0
    return hist


def _orientation(gxp, gyp, sx, sy, x, y, sigma_rel, w_o, h_o, num_bins: int = 36):
    hist = _orientation_hist(gxp, gyp, sx, sy, x, y, sigma_rel, w_o, h_o, num_bins)
    p = torch.argmax(hist, dim=-1, keepdim=True)
    pick = lambda s: torch.gather(hist, -1, torch.remainder(p + s, num_bins))[..., 0]
    hl, hc, hr = pick(-1), pick(0), pick(1)
    denom = hl - 2 * hc + hr
    shift = torch.where(denom.abs() < 1e-12, 0.0, 0.5 * (hl - hr) / denom)
    return torch.remainder((p[..., 0].to(torch.float32) + 0.5 + shift)
                           * (_TWO_PI / num_bins), _TWO_PI)


def _descriptor(gxp, gyp, sx, sy, x, y, sigma_rel, angle, w_o, h_o,
                descriptor_scale: float, clip: float):
    dev = x.device
    bin_size = (descriptor_scale * sigma_rel)[..., None]
    ca = torch.cos(angle)[..., None]
    sa = torch.sin(angle)[..., None]
    grid = _t(_DESC_GRID, dev)
    g0 = grid[:, 0] * bin_size
    g1 = grid[:, 1] * bin_size
    xs = x[..., None] + ca * g0 - sa * g1
    ys = y[..., None] + sa * g0 + ca * g1
    inb = _in_image(xs, ys, w_o, h_o)
    vx, vy, ok = _sample(gxp, gyp, xs - sx[..., None], ys - sy[..., None])
    mag = torch.sqrt(vx * vx + vy * vy)
    theta = torch.remainder(torch.atan2(vy, vx) - angle[..., None], _TWO_PI)
    b0, b1, frac = _soft_bins(theta, 8)
    obins = torch.arange(8, device=dev)
    w_orient = ((obins == b0[..., None]) * (1 - frac[..., None])
                + (obins == b1[..., None]) * frac[..., None])        # (B, K, 256, 8)
    contrib = mag * _t(_DESC_WG, dev) * (inb & ok)
    weighted = _t(_W_SPATIAL, dev) * contrib[..., None]             # (B, K, 256, 16)
    desc = (weighted.mT @ w_orient).flatten(-2)                      # (B, K, 128)
    norm = torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-12)
    desc = torch.clamp(desc / norm, max=clip)
    return desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-12)


def orientation_and_descriptor_canvas_plain(
    canvas, grad_layer, x, y, sigma_rel, row_off, w_o, h_o,
    descriptor_scale: float = 3.0, clip: float = 0.2,
):
    """(B, S, sumH, Wmax) f16 canvas + (B, K) keypoints -> angle (B, K), desc (B, K, 128)."""
    gxp, gyp, sx, sy = _extract_grad_patches(canvas, grad_layer, x, y, row_off, w_o, h_o)
    angle = _orientation(gxp, gyp, sx, sy, x, y, sigma_rel, w_o, h_o)
    desc = _descriptor(gxp, gyp, sx, sy, x, y, sigma_rel, angle, w_o, h_o,
                       descriptor_scale, clip)
    return angle, desc


def orientation_near_tie(canvas, grad_layer, x, y, sigma_rel, row_off, w_o, h_o,
                         rel: float = 0.01):
    """(B, K) bool: the two largest smoothed orientation bins lie within
    ``rel`` of each other, so another summation order may pick either peak."""
    gxp, gyp, sx, sy = _extract_grad_patches(canvas, grad_layer, x, y, row_off, w_o, h_o)
    hist = _orientation_hist(gxp, gyp, sx, sy, x, y, sigma_rel, w_o, h_o)
    top2 = torch.topk(hist, 2, dim=-1).values
    return top2[..., 1] >= (1.0 - rel) * top2[..., 0]


def orientation_and_descriptor_canvas_cuda(
    canvas, grad_layer, x, y, sigma_rel, row_off, w_o, h_o,
    descriptor_scale: float = 3.0, clip: float = 0.2,
):
    B, S, sumH, Wmax = canvas.shape
    K = x.shape[1]
    dev = canvas.device
    if sumH < _GPATCH or Wmax < _GPATCH:
        raise ValueError(f"sift_describe: canvas {sumH}x{Wmax} smaller than the patch")
    _kernels.check_tensor(canvas, "canvas", torch.float16, (B, S, sumH, Wmax), dev)
    ints = [t.to(torch.int32).contiguous() for t in (grad_layer, row_off, w_o, h_o)]
    flts = [t.to(torch.float32).contiguous() for t in (x, y, sigma_rel)]
    for name, t in zip(("grad_layer", "row_off", "w_o", "h_o", "x", "y", "sigma_rel"),
                       ints + flts):
        _kernels.check_tensor(t, name, t.dtype, (B, K), dev)
    tables = _k5_tables(dev)
    angle = torch.empty((B, K), dtype=torch.float32, device=dev)
    desc = torch.empty((B, K, 128), dtype=torch.float32, device=dev)
    gl, ro, wo, ho = ints
    xx, yy, sr = flts
    _kernels.launch("sift_describe", dev, canvas, B, S, sumH, Wmax,
                    gl, xx, yy, sr, ro, wo, ho, K, tables,
                    float(descriptor_scale), float(clip), angle, desc)
    return angle, desc


def orientation_and_descriptor_canvas(
    canvas, grad_layer, x, y, sigma_rel, row_off, w_o, h_o,
    descriptor_scale: float = 3.0, clip: float = 0.2,
):
    """Kernel K5 on a CUDA tensor, its plain twin on a CPU tensor."""
    args = (canvas, grad_layer, x, y, sigma_rel, row_off, w_o, h_o)
    if canvas.is_cuda:
        return orientation_and_descriptor_canvas_cuda(
            *args, descriptor_scale=descriptor_scale, clip=clip)
    if canvas.device.type == "cpu":
        return orientation_and_descriptor_canvas_plain(
            *args, descriptor_scale=descriptor_scale, clip=clip)
    raise ValueError(f"sift_describe: unsupported device {canvas.device}")
