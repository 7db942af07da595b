"""Gaussian scale-space pyramid, batched over images.

Counterpart of ``sfm_tpu/features/pyramid.py``: ``gaussian_blur`` (the
exact float32 shift-add), ``layer_sigmas`` and ``build_pyramid``. Each
octave holds S+3 Gaussian layers built by incremental blurs and S+2 DoG
layers; the next octave's base is layer S subsampled 2x. The optional -1
octave upsamples 2x with ``jax.image.resize``'s bilinear weights, which
renormalize at the image edge.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_taps(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W) float32, zero padding.

    Shift-and-add in exact float32, taps summed in the reference's order.
    """
    if sigma <= 0:
        return img
    radius = max(1, int(math.ceil(3.0 * sigma)))
    k = _gaussian_taps(sigma, radius)
    h, w = img.shape[-2], img.shape[-1]
    x = F.pad(img, (radius, radius))
    out = sum(float(k[i]) * x[..., :, i:i + w] for i in range(2 * radius + 1))
    x = F.pad(out, (0, 0, radius, radius))
    return sum(float(k[i]) * x[..., i:i + h, :] for i in range(2 * radius + 1))


def _upsample2x_taps(n: int):
    """Two taps per output for n -> 2n, as ``jax.image.resize(..., "bilinear")``
    weighs them: triangle kernel at half-pixel centers, weights of taps that
    fall outside the image dropped and the rest renormalized."""
    s = (np.arange(2 * n, dtype=np.float32) + np.float32(0.5)) * np.float32(0.5) - np.float32(0.5)
    i0 = np.floor(s).astype(np.int64)
    f = (s - i0).astype(np.float32)
    w0 = np.where(i0 >= 0, np.float32(1) - f, np.float32(0)).astype(np.float32)
    w1 = np.where(i0 + 1 <= n - 1, f, np.float32(0)).astype(np.float32)
    tot = w0 + w1
    return (np.clip(i0, 0, n - 1), np.clip(i0 + 1, 0, n - 1),
            (w0 / tot).astype(np.float32), (w1 / tot).astype(np.float32))


def upsample2x(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., 2H, 2W) bilinear, rows first then columns."""
    for axis in (-2, -1):
        ia, ib, wa, wb = _upsample2x_taps(img.shape[axis])
        as_t = lambda a: torch.as_tensor(a, device=img.device)
        shape = [1] * img.ndim
        shape[axis] = -1
        img = (as_t(wa).reshape(shape) * img.index_select(axis, as_t(ia))
               + as_t(wb).reshape(shape) * img.index_select(axis, as_t(ib)))
    return img


def layer_sigmas(num_layers: int, sigma0: float, scales_per_octave: int):
    """Absolute blur of each layer within an octave (octave-relative units)."""
    k = 2.0 ** (1.0 / scales_per_octave)
    return [sigma0 * (k**i) for i in range(num_layers)]


def build_pyramid(
    image: torch.Tensor,
    num_octaves: int = 4,
    scales_per_octave: int = 3,
    sigma0: float = 1.6,
    assumed_blur: float = 0.5,
    upsample: bool = False,
):
    """(B, H, W) float32 in [0, 1] -> (gaussians, dogs).

    gaussians: per-octave (B, S+3, h_o, w_o); dogs: per-octave (B, S+2, h_o, w_o).
    With ``upsample`` the first octave is the 2x-upsampled image and callers
    scale coordinates by 0.5.
    """
    S = scales_per_octave
    sigmas = layer_sigmas(S + 3, sigma0, S)

    img = image.to(torch.float32)
    if upsample:
        img = upsample2x(img)
        assumed_blur = assumed_blur * 2.0

    base = gaussian_blur(img, math.sqrt(max(sigma0**2 - assumed_blur**2, 1e-8)))
    gaussians, dogs = [], []
    for _ in range(num_octaves):
        layers = [base]
        for i in range(1, S + 3):
            inc = math.sqrt(max(sigmas[i] ** 2 - sigmas[i - 1] ** 2, 1e-8))
            layers.append(gaussian_blur(layers[-1], inc))
        g = torch.stack(layers, dim=1)
        gaussians.append(g)
        dogs.append(g[:, 1:] - g[:, :-1])
        base = layers[S][..., ::2, ::2].contiguous()
    return gaussians, dogs
