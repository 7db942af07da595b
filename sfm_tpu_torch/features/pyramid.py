"""Gaussian scale-space pyramid, batched over images.

Counterpart of ``sfm_tpu/features/pyramid.py``: ``gaussian_blur`` (the
exact float32 shift-add), ``layer_sigmas`` and ``build_pyramid``. Each
octave holds S+3 Gaussian layers built by incremental blurs and S+2 DoG
layers; the next octave's base is layer S subsampled 2x. The optional -1
octave upsamples 2x with ``jax.image.resize``'s bilinear weights, which
renormalize at the image edge. ``build_pyramid`` is kernel K3
(``csrc/pyramid.cu``) on a CUDA tensor, bit-identical to its plain twin
:func:`build_pyramid_plain`, which runs on a CPU tensor. The reference's
banded-matmul blur (an MXU idiom) is not ported.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from sfm_tpu_torch import _kernels

# The kernel takes at most 21 taps per blur (radius 10) and 16 blurs, and is
# instantiated for these radii: the default configuration's (the SIFT
# pyramid's 4, 5, 6, 8 and 10 with and without the upsample; K12's 6).
_K3_MAX_TAPS = 21
_K3_MAX_LAYERS = 16
K3_RADII = (4, 5, 6, 8, 10)


def _blur_radius(sigma: float) -> int:
    return max(1, int(math.ceil(3.0 * sigma)))


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
    radius = _blur_radius(sigma)
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


def _blur_sigmas(S: int, sigma0: float, assumed_blur: float, upsample: bool):
    """The base blur, then the S+2 incremental blurs of every octave."""
    sigmas = layer_sigmas(S + 3, sigma0, S)
    if upsample:
        assumed_blur = assumed_blur * 2.0
    return [math.sqrt(max(sigma0**2 - assumed_blur**2, 1e-8))] + [
        math.sqrt(max(sigmas[i] ** 2 - sigmas[i - 1] ** 2, 1e-8)) for i in range(1, S + 3)]


def build_pyramid_plain(image: torch.Tensor, num_octaves: int = 4, scales_per_octave: int = 3,
                        sigma0: float = 1.6, assumed_blur: float = 0.5,
                        upsample: bool = False):
    """The twin of K3: see :func:`build_pyramid`."""
    S = scales_per_octave
    blurs = _blur_sigmas(S, sigma0, assumed_blur, upsample)
    img = image.to(torch.float32)
    if upsample:
        img = upsample2x(img)
    base = gaussian_blur(img, blurs[0])
    gaussians, dogs = [], []
    for _ in range(num_octaves):
        layers = [base]
        for i in range(1, S + 3):
            layers.append(gaussian_blur(layers[-1], blurs[i]))
        g = torch.stack(layers, dim=1)
        gaussians.append(g)
        dogs.append(g[:, 1:] - g[:, :-1])
        base = layers[S][..., ::2, ::2].contiguous()
    return gaussians, dogs


def k3_blur_plan(sigmas):
    """Each blur's kernel radius and taps, as ``sfm_build_pyramid`` and
    ``sfm_orb_blur`` take them: (taps (L, 21) float32, radii (L,) int32).

    The kernel is instantiated for the radii of :data:`K3_RADII`; a blur of
    radius r runs at the first of them >= r, its 2 r + 1 taps centred in
    that radius's 2 R + 1 slots, zeros around them (which leave every sum's
    bits as they are on finite images). Raises past radius 10.
    """
    taps = np.zeros((len(sigmas), _K3_MAX_TAPS), np.float32)
    radii = np.zeros(len(sigmas), np.int32)
    for layer, sigma in enumerate(sigmas):
        r = _blur_radius(sigma)
        if r > K3_RADII[-1]:
            raise ValueError(f"build_pyramid: blur sigma {sigma:.3f} needs radius {r} > "
                             f"{K3_RADII[-1]}")
        R = next(q for q in K3_RADII if q >= r)
        taps[layer, R - r:R + r + 1] = _gaussian_taps(sigma, r)
        radii[layer] = R
    return taps, radii


def build_pyramid_cuda(image: torch.Tensor, num_octaves: int = 4, scales_per_octave: int = 3,
                       sigma0: float = 1.6, assumed_blur: float = 0.5,
                       upsample: bool = False):
    S = scales_per_octave
    L = S + 3
    image = image.to(torch.float32).contiguous()
    B, H, W = image.shape
    dev = image.device
    _kernels.check_tensor(image, "image", torch.float32, (B, H, W), dev)
    if L > _K3_MAX_LAYERS:
        raise ValueError(f"build_pyramid: {L} layers per octave exceed {_K3_MAX_LAYERS}")
    taps, radii = k3_blur_plan(_blur_sigmas(S, sigma0, assumed_blur, upsample))
    sizes = [(2 * H, 2 * W) if upsample else (H, W)]
    for _ in range(num_octaves - 1):
        h, w = sizes[-1]
        sizes.append(((h + 1) // 2, (w + 1) // 2))
    g_flat = torch.empty(sum(B * L * h * w for h, w in sizes), dtype=torch.float32, device=dev)
    d_flat = torch.empty(sum(B * (L - 1) * h * w for h, w in sizes), dtype=torch.float32,
                         device=dev)
    _kernels.launch("build_pyramid", dev, image, B, H, W, int(upsample), num_octaves, S,
                    torch.from_numpy(taps), torch.from_numpy(radii), g_flat, d_flat)
    gaussians, dogs, go, do = [], [], 0, 0
    for h, w in sizes:
        gaussians.append(g_flat[go:go + B * L * h * w].view(B, L, h, w))
        dogs.append(d_flat[do:do + B * (L - 1) * h * w].view(B, L - 1, h, w))
        go += B * L * h * w
        do += B * (L - 1) * h * w
    return gaussians, dogs


def build_pyramid(image: torch.Tensor, num_octaves: int = 4, scales_per_octave: int = 3,
                  sigma0: float = 1.6, assumed_blur: float = 0.5, upsample: bool = False):
    """(B, H, W) float32 in [0, 1] -> (gaussians, dogs).

    gaussians: per-octave (B, S+3, h_o, w_o); dogs: per-octave (B, S+2, h_o, w_o).
    With ``upsample`` the first octave is the 2x-upsampled image and callers
    scale coordinates by 0.5. Kernel K3 on a CUDA tensor, the twin on CPU.
    """
    args = (image, num_octaves, scales_per_octave, sigma0, assumed_blur, upsample)
    if image.is_cuda:
        return build_pyramid_cuda(*args)
    if image.device.type == "cpu":
        return build_pyramid_plain(*args)
    raise ValueError(f"build_pyramid: unsupported device {image.device}")
