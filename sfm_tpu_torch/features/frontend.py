"""The feature frontend: images -> fixed-K keypoints + descriptors.

Counterpart of ``sfm_tpu/features/frontend.py``, batched over images. The
SIFT branch: pyramid (kernel K3) -> per-octave extremum grid, candidate
selection and subpixel refinement (kernel K4) -> mask gate + global top-k on
candidate metadata -> orientation + descriptor of the selected budget only
(kernel K5) against a multi-octave f16 "canvas". ``FeatureConfig.kind ==
"orb"`` routes to the binary frontend (kernel K12, :mod:`.binary`). Returns
padded arrays and a validity mask so the sweep downstream sees fixed shapes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sfm_tpu_torch.config import FeatureConfig
from sfm_tpu_torch.estimators.ransac import top_k
from sfm_tpu_torch.features.binary import detect_orb
from sfm_tpu_torch.features.descriptor import _GPATCH, orientation_and_descriptor_canvas
from sfm_tpu_torch.features.detect import (
    dog_extrema_scores,
    dog_refine,
    select_octave_candidates,
)
from sfm_tpu_torch.features.pyramid import build_pyramid


class Features(NamedTuple):
    """Padded per-image features with a leading image axis. Invalid rows are zeroed."""

    xy: torch.Tensor        # (B, K, 2) full-resolution pixel coords
    sigma: torch.Tensor     # (B, K)
    angle: torch.Tensor     # (B, K)
    response: torch.Tensor  # (B, K) |refined DoG contrast| (SIFT), FAST score (ORB)
    desc: torch.Tensor      # (B, K, D) unit-norm: D = 128 (SIFT), 256 in +-1/16 (ORB)
    valid: torch.Tensor     # (B, K) bool


def features_from_numpy(xy, desc, valid, device) -> tuple:
    """(xy, desc, valid) numpy arrays (e.g. the JAX frontend's outputs) ->
    float32 / float32 / bool tensors on ``device``, ready for the sweep."""
    return (torch.as_tensor(np.asarray(xy, np.float32), device=device),
            torch.as_tensor(np.asarray(desc, np.float32), device=device),
            torch.as_tensor(np.asarray(valid, bool), device=device))


def _octave_budget(max_keypoints: int, octave: int) -> int:
    return max(max_keypoints >> octave, 256)


def _normalize_image(image: torch.Tensor, reciprocal: bool = False) -> torch.Tensor:
    """u8 / u16 quantized grayscale -> float32 in [0, 1]; float passes through.

    ``reciprocal``: multiply by the float32 reciprocal of 255 (65535), as XLA
    compiles the reference's ``/ 255.0``, instead of dividing. The ORB branch
    needs it: the quotient differs by an ulp on half the u8 values, and FAST
    compares u8 contrasts that tie its threshold exactly (99.29% of the
    compiled reference's keypoints with it, 96.66% without:
    ``tests/orb_parity_report.py``). The SIFT branch keeps the quotient: its
    parity tests pass either way, and with the reciprocal the 150-view
    corridor of ``chip_smoke.py`` registered 102/150 cameras in one of two
    runs on the card, below the smoke's gate, which every run with the
    quotient has met (ROADMAP queue 3)."""
    scale = {torch.uint8: 255.0, torch.uint16: 65535.0}.get(image.dtype)
    if scale is None:
        return image.to(torch.float32)
    if reciprocal:
        return image.to(torch.float32) * float(np.float32(1.0 / scale))
    return image.to(torch.float32) / scale


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (B, k) of (B, n, ...) ``a`` along dim 1."""
    idx = idx.reshape(idx.shape + (1,) * (a.ndim - 2)).expand(idx.shape + a.shape[2:])
    return torch.gather(a, 1, idx)


def dilate_mask(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Grow a (B, H, W) boolean foreground mask by ``radius`` px (OR max-pool)."""
    d = 2 * radius + 1
    m = F.max_pool2d(mask[:, None].to(torch.float32), d, stride=1, padding=radius)
    return m[:, 0] > 0.5


def select_keypoints(images: torch.Tensor, masks: Optional[torch.Tensor],
                     config: FeatureConfig) -> dict:
    """Stages 1-2 of the frontend: the selected keypoints' metadata and the
    inputs of :func:`orientation_and_descriptor_canvas` (the f16 canvas and
    per-keypoint ``grad_layer, x, y, sigma_rel, row_off, w_o, h_o``).
    The SIFT branch; the ORB branch is :func:`.binary.detect_orb`."""
    image = _normalize_image(images)
    B, H, W = image.shape
    dev = image.device
    S = config.scales_per_octave
    gaussians, dogs = build_pyramid(
        image,
        num_octaves=config.num_octaves,
        scales_per_octave=S,
        sigma0=config.sigma0,
        assumed_blur=config.assumed_blur,
        upsample=config.upsample_first_octave,
    )
    # With the -1 octave, octave o sits at resolution scale 2^(o-1).
    oct_base = 0.5 if config.upsample_first_octave else 1.0

    # ---- stage 1: candidate metadata per octave (no descriptors) ----------
    per_octave = []
    for o in range(config.num_octaves):
        fields = dog_extrema_scores(dogs[o], config.contrast_threshold,
                                    config.edge_threshold)
        cands = select_octave_candidates(fields, _octave_budget(config.max_keypoints, o))
        layer = cands["layer"]                         # 1..S (DoG interior)
        # Selection padding (score 0) stays invalid whatever the gates compute.
        off_x, off_y, off_s, gated = dog_refine(
            dogs[o].contiguous(), layer, cands["y"], cands["x"], cands["score"],
            config.contrast_threshold, config.edge_threshold,
        )
        x_o = cands["x"].to(torch.float32) + off_x
        y_o = cands["y"].to(torch.float32) + off_y
        sigma_rel = config.sigma0 * torch.pow(
            2.0, (layer.to(torch.float32) + off_s) / S)
        scale = float(1 << o) * oct_base
        per_octave.append({
            "xy": torch.stack([x_o * scale, y_o * scale], dim=-1),
            "sigma": sigma_rel * scale,
            "sigma_rel": sigma_rel,
            "response": gated,
            "grad_idx": layer - 1,
            "x_o": x_o,
            "y_o": y_o,
            "octave": torch.full_like(layer, o),
        })

    cat = lambda key: torch.cat([p[key] for p in per_octave], dim=1)
    xy = cat("xy")
    response = cat("response")
    valid = response > 0

    # ---- stage 2: mask gate + global selection on metadata only -----------
    if masks is not None:
        if config.mask_dilate > 0:
            masks = dilate_mask(masks, config.mask_dilate)
        xi = torch.clamp(torch.round(xy[..., 0]).to(torch.int64), 0, W - 1)
        yi = torch.clamp(torch.round(xy[..., 1]).to(torch.int64), 0, H - 1)
        valid = valid & torch.gather(masks.reshape(B, -1), 1, yi * W + xi)

    score = torch.where(valid, response, -1.0)
    top, idx = top_k(score, config.max_keypoints)
    sel = lambda key: _take(cat(key), idx)
    valid = torch.gather(valid, 1, idx) & (top > 0)
    xy = sel("xy")
    sigma = sel("sigma")
    response = torch.gather(response, 1, idx)

    # ---- stage 3: describe only the selected budget ------------------------
    # Canvas: every octave's interior Gaussian layers (1..S, the only ones the
    # descriptor samples), padded to a common width and stacked along rows.
    heights = [g.shape[-2] for g in gaussians]
    widths = [g.shape[-1] for g in gaussians]
    wmax = max(max(widths), _GPATCH)
    canvas = torch.cat(
        [F.pad(g[:, 1:S + 1], (0, wmax - g.shape[-1], 0, max(0, _GPATCH - g.shape[-2])))
         for g in gaussians],
        dim=2,
    ).to(torch.float16)
    row_off, acc = [], 0
    for h in heights:
        row_off.append(acc)
        acc += max(h, _GPATCH)

    octv = sel("octave")
    as_i32 = lambda v: torch.as_tensor(v, dtype=torch.int32, device=dev)[octv]
    return {
        "xy": xy, "sigma": sigma, "response": response, "valid": valid,
        "describe": (canvas, sel("grad_idx"), sel("x_o"), sel("y_o"), sel("sigma_rel"),
                     as_i32(row_off), as_i32(widths), as_i32(heights)),
    }


def _detect_impl(images: torch.Tensor, masks: Optional[torch.Tensor],
                 config: FeatureConfig) -> Features:
    """(B, H, W) images (+ (B, H, W) bool masks) -> batched :class:`Features`."""
    if config.kind == "orb":
        return Features(**detect_orb(_normalize_image(images, reciprocal=True), masks, config))
    kp = select_keypoints(images, masks, config)
    angle, desc = orientation_and_descriptor_canvas(
        *kp["describe"],
        descriptor_scale=config.descriptor_scale,
        clip=config.descriptor_clip,
    )
    valid = kp["valid"]
    zero = lambda a: torch.where(valid.reshape(valid.shape + (1,) * (a.ndim - 2)), a, 0)
    return Features(
        xy=zero(kp["xy"]),
        sigma=zero(kp["sigma"]),
        angle=zero(angle),
        response=zero(kp["response"]),
        desc=zero(desc),
        valid=valid,
    )


def detect_and_describe(image, mask=None, config: FeatureConfig = FeatureConfig(), *,
                        device) -> Features:
    """One (H, W) image (u8/u16 or float32 in [0, 1]) -> Features without the
    image axis. ``mask``: optional (H, W) bool foreground mask."""
    img = torch.as_tensor(np.asarray(image), device=device)[None]
    mk = None if mask is None else torch.as_tensor(np.asarray(mask, bool), device=device)[None]
    return Features(*(t[0] for t in _detect_impl(img, mk, config)))


def detect_and_describe_batch(images, masks=None, config: FeatureConfig = FeatureConfig(),
                              batch_size: int = 4, *, device) -> Features:
    """(N, H, W) images -> Features with leading axis N, in sub-batches of
    ``batch_size`` images (the cap bounds the pyramid's working set)."""
    images = torch.as_tensor(np.asarray(images), device=device)
    if masks is not None:
        masks = torch.as_tensor(np.asarray(masks, bool), device=device)
    n = images.shape[0]
    outs = []
    for c in range(0, n, batch_size):
        mk = None if masks is None else masks[c:c + batch_size]
        outs.append(_detect_impl(images[c:c + batch_size], mk, config))
    return Features(*(torch.cat(parts) for parts in zip(*outs)))
