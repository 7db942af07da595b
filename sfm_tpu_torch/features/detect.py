"""Scale-space extremum detection, candidate selection and subpixel refinement.

Counterpart of ``sfm_tpu/features/detect.py``, batched over images. The
dense extremum score grid is kernel K4 (``csrc/dog_extrema.cu``); its plain
twin :func:`dog_extrema_scores_plain` is the transcription of the JAX
oracle ``_dog_extrema_scores_ref`` (26 strict shifted compares). Selection
and refinement are K4's ``dog_select`` and ``dog_refine``
(``csrc/dog_select.cu``): :func:`select_octave_candidates` and
:func:`dog_refine` on CUDA tensors, their twins
:func:`select_octave_candidates_plain` and :func:`dog_refine_plain` (built on
:func:`refine_and_gate`) on CPU tensors. Both are exact: the same candidates
in the same order, bit-identical offsets and scores.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from sfm_tpu_torch import _kernels
from sfm_tpu_torch.estimators.ransac import top_k_plain

_EPS = 1e-12
_BORDER = 5


def dog_extrema_scores_plain(dog, contrast_threshold: float, edge_threshold: float):
    """(B, S+2, h, w) DoG -> {"score": (B, S, h, w)}.

    score = |DoG| where the pixel is a strict 26-neighbour extremum at least
    5 px inside the image with |DoG| >= contrast_threshold / 2, else 0.
    (``torch.roll`` wraps at the edge, but the border keeps every wrapped
    value away from a scored pixel.)
    """
    D = dog
    center = D[:, 1:-1]
    is_max = torch.ones_like(center, dtype=torch.bool)
    is_min = torch.ones_like(center, dtype=torch.bool)
    for ds in (-1, 0, 1):
        layer = D[:, 1 + ds: D.shape[1] - 1 + ds]
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == 0 and dy == 0 and dx == 0:
                    continue
                nb = torch.roll(layer, (dy, dx), dims=(-2, -1))
                is_max &= center > nb
                is_min &= center < nb
    h, w = center.shape[-2:]
    yy = torch.arange(h, device=D.device)[:, None]
    xx = torch.arange(w, device=D.device)[None, :]
    in_bounds = ((yy >= _BORDER) & (yy < h - _BORDER)
                 & (xx >= _BORDER) & (xx < w - _BORDER))
    raw = torch.abs(center)
    good = (is_max | is_min) & in_bounds & (raw >= 0.5 * contrast_threshold)
    return {"score": torch.where(good, raw, 0.0)}


def dog_extrema_scores_cuda(dog, contrast_threshold: float, edge_threshold: float):
    B, Sp2, h, w = dog.shape
    dev = dog.device
    _kernels.check_tensor(dog, "dog", torch.float32, (B, Sp2, h, w), dev)
    score = torch.empty((B, Sp2 - 2, h, w), dtype=torch.float32, device=dev)
    _kernels.launch("dog_extrema", dev, dog, B, Sp2, h, w,
                    float(0.5 * contrast_threshold), score)
    return {"score": score}


def dog_extrema_scores(dog, contrast_threshold: float, edge_threshold: float):
    """Kernel K4 on a CUDA tensor, its plain twin on a CPU tensor."""
    if dog.shape[1] < 3:
        raise ValueError(f"dog_extrema_scores: need >= 3 DoG layers, got {dog.shape[1]}")
    if dog.is_cuda:
        return dog_extrema_scores_cuda(dog.contiguous(), contrast_threshold, edge_threshold)
    if dog.device.type == "cpu":
        return dog_extrema_scores_plain(dog, contrast_threshold, edge_threshold)
    raise ValueError(f"dog_extrema_scores: unsupported device {dog.device}")


def dog_refine_plain(dog, layer, y, x, cand_score, contrast_threshold: float,
                     edge_threshold: float):
    """:func:`refine_and_gate`, then selection padding (``cand_score`` 0)
    stays invalid whatever the gates computed on its clamped neighbourhood.
    Plain twin of kernel K4's ``dog_refine``."""
    off_x, off_y, off_s, gated = refine_and_gate(dog, layer, y, x, contrast_threshold,
                                                 edge_threshold)
    return off_x, off_y, off_s, torch.where(cand_score > 0, gated, 0.0)


def dog_refine_cuda(dog, layer, y, x, cand_score, contrast_threshold: float,
                    edge_threshold: float):
    B, Sp2, h, w = dog.shape
    K = layer.shape[1]
    dev = dog.device
    _kernels.check_tensor(dog, "dog", torch.float32, (B, Sp2, h, w), dev)
    for name, t in (("layer", layer), ("y", y), ("x", x)):
        _kernels.check_tensor(t, name, torch.int64, (B, K), dev)
    _kernels.check_tensor(cand_score, "cand_score", torch.float32, (B, K), dev)
    off_x, off_y, off_s, gated = (torch.empty((B, K), dtype=torch.float32, device=dev)
                                  for _ in range(4))
    r = float(edge_threshold)
    _kernels.launch("dog_refine", dev, dog, B, Sp2, h, w, layer, y, x, cand_score, K,
                    float(contrast_threshold), r, (r + 1.0) ** 2, off_x, off_y, off_s, gated)
    return off_x, off_y, off_s, gated


def dog_refine(dog, layer, y, x, cand_score, contrast_threshold: float, edge_threshold: float):
    """Kernel K4 ``dog_refine`` on CUDA tensors, :func:`dog_refine_plain` on
    CPU. dog (B, S+2, h, w); layer / y / x (B, K) int64 and cand_score (B, K)
    from :func:`select_octave_candidates`. Returns (off_x, off_y, off_s, score)."""
    args = (dog, layer, y, x, cand_score, contrast_threshold, edge_threshold)
    if dog.is_cuda:
        return dog_refine_cuda(*args)
    if dog.device.type == "cpu":
        return dog_refine_plain(*args)
    raise ValueError(f"dog_refine: unsupported device {dog.device}")


def refine_and_gate(dog, layer, y, x, contrast_threshold: float, edge_threshold: float):
    """Subpixel refinement + SIFT gates for selected candidates.

    dog: (B, S+2, h, w); layer/y/x: (B, K) grid coordinates. Returns
    (off_x, off_y, off_s, score) with score = |refined contrast| where the
    offset converged (< 0.6), the refined contrast clears the threshold and
    the Hessian edge-ratio test passes, else 0.
    """
    off_x, off_y, off_s, (refined, dxx, dyy, dxy) = _refine_cubes(dog, layer, y, x)
    converged = (off_x.abs() < 0.6) & (off_y.abs() < 0.6) & (off_s.abs() < 0.6)
    contrast_ok = refined.abs() >= contrast_threshold
    tr = dxx + dyy
    det2 = dxx * dyy - dxy * dxy
    r = edge_threshold
    edge_ok = (det2 > 0) & (tr * tr * r < (r + 1.0) ** 2 * det2)
    score = torch.where(converged & contrast_ok & edge_ok, refined.abs(), 0.0)
    return off_x, off_y, off_s, score


def _refine_cubes(dog, layer, y, x):
    """Gather each candidate's 3x3x3 neighbourhood (clamped) and solve the
    offset system in closed form (adjugate)."""
    B, Sp2, h, w = dog.shape
    ds = torch.arange(-1, 2, device=dog.device)
    l_idx = torch.clamp(layer[..., None] + ds, 0, Sp2 - 1)      # (B, K, 3)
    y_idx = torch.clamp(y[..., None] + ds, 0, h - 1)
    x_idx = torch.clamp(x[..., None] + ds, 0, w - 1)
    idx = (l_idx[..., :, None, None] * (h * w)
           + y_idx[..., None, :, None] * w
           + x_idx[..., None, None, :])                          # (B, K, 3, 3, 3)
    C = torch.gather(dog.reshape(B, -1), 1, idx.reshape(B, -1)).reshape(idx.shape)
    c = C[..., 1, 1, 1]
    gx = 0.5 * (C[..., 1, 1, 2] - C[..., 1, 1, 0])
    gy = 0.5 * (C[..., 1, 2, 1] - C[..., 1, 0, 1])
    gs = 0.5 * (C[..., 2, 1, 1] - C[..., 0, 1, 1])
    dxx = C[..., 1, 1, 2] + C[..., 1, 1, 0] - 2 * c
    dyy = C[..., 1, 2, 1] + C[..., 1, 0, 1] - 2 * c
    dss = C[..., 2, 1, 1] + C[..., 0, 1, 1] - 2 * c
    dxy = 0.25 * (C[..., 1, 2, 2] + C[..., 1, 0, 0] - C[..., 1, 0, 2] - C[..., 1, 2, 0])
    dxs = 0.25 * (C[..., 2, 1, 2] - C[..., 2, 1, 0] - C[..., 0, 1, 2] + C[..., 0, 1, 0])
    dys = 0.25 * (C[..., 2, 2, 1] - C[..., 2, 0, 1] - C[..., 0, 2, 1] + C[..., 0, 0, 1])

    det = (dxx * (dyy * dss - dys * dys)
           - dxy * (dxy * dss - dys * dxs)
           + dxs * (dxy * dys - dyy * dxs))
    small = det.abs() < _EPS
    inv_det = torch.where(small, 0.0, 1.0 / torch.where(small, 1.0, det))
    a00 = dyy * dss - dys * dys
    a01 = dxs * dys - dxy * dss
    a02 = dxy * dys - dxs * dyy
    a11 = dxx * dss - dxs * dxs
    a12 = dxy * dxs - dxx * dys
    a22 = dxx * dyy - dxy * dxy
    off_x = -(a00 * gx + a01 * gy + a02 * gs) * inv_det
    off_y = -(a01 * gx + a11 * gy + a12 * gs) * inv_det
    off_s = -(a02 * gx + a12 * gy + a22 * gs) * inv_det
    refined = c + 0.5 * (gx * off_x + gy * off_y + gs * off_s)
    return off_x, off_y, off_s, (refined, dxx, dyy, dxy)


def _maxpool2(x):
    """2x2 / stride-2 max over the last two axes of (B, S, h, w), odd edges
    zero-padded (scores are >= 0)."""
    h, w = x.shape[-2:]
    return F.max_pool2d(F.pad(x, (0, w % 2, 0, h % 2)), 2, 2)


def select_octave_candidates_plain(fields, budget: int):
    """Top-``budget`` candidates of one octave's (B, S, h, w) score grid.

    Exact and hierarchical, as in the reference: 2x2 cell max, 4x4 block
    max, top-k over blocks, top-k over the surviving blocks' cells, then the
    winning pixel inside each cell. Returns (B, budget) layer (1-based DoG
    layer), y, x (int64) and score; score 0 marks padding. Plain twin of
    kernel K4's ``dog_select``.
    """
    score = fields["score"]
    B, S, h, w = score.shape
    dev = score.device
    cell = _maxpool2(score)
    h2, w2 = cell.shape[-2:]
    blk = _maxpool2(cell)
    h4, w4 = blk.shape[-2:]

    k1 = min(budget, S * h4 * w4)
    _, bidx = top_k_plain(blk.reshape(B, -1), k1)
    bl = bidx // (h4 * w4)
    brem = bidx % (h4 * w4)
    by = brem // w4
    bx = brem % w4

    dy = torch.tensor([0, 0, 1, 1], device=dev)
    dx = torch.tensor([0, 1, 0, 1], device=dev)
    cy = by[..., None] * 2 + dy                                   # (B, k1, 4)
    cx = bx[..., None] * 2 + dx
    cell_ok = (cy < h2) & (cx < w2)
    cidx = (bl[..., None] * (h2 * w2) + torch.clamp(cy, max=h2 - 1) * w2
            + torch.clamp(cx, max=w2 - 1))
    cs = torch.gather(cell.reshape(B, -1), 1, cidx.reshape(B, -1)).reshape(cidx.shape)
    cs = torch.where(cell_ok, cs, -1.0)

    k2 = min(budget, k1 * 4)
    ctop, cpos = top_k_plain(cs.reshape(B, -1), k2)
    sel_b = cpos // 4
    sub = cpos % 4
    layer = torch.gather(bl, 1, sel_b)
    cell_y = torch.gather(by, 1, sel_b) * 2 + dy[sub]
    cell_x = torch.gather(bx, 1, sel_b) * 2 + dx[sub]

    py = cell_y[..., None] * 2 + dy                               # (B, k2, 4)
    px = cell_x[..., None] * 2 + dx
    pix_ok = (py < h) & (px < w)
    pidx = (layer[..., None] * (h * w) + torch.clamp(py, max=h - 1) * w
            + torch.clamp(px, max=w - 1))
    ps = torch.gather(score.reshape(B, -1), 1, pidx.reshape(B, -1)).reshape(pidx.shape)
    ps = torch.where(pix_ok, ps, -1.0)
    sub_arg = torch.argmax((ps == ctop[..., None]).to(torch.int32), dim=-1)
    y = cell_y * 2 + dy[sub_arg]
    x = cell_x * 2 + dx[sub_arg]
    top = torch.clamp(ctop, min=0.0)

    if k2 < budget:
        pad = (0, budget - k2)
        top, layer, y, x = (F.pad(t, pad) for t in (top, layer, y, x))
    return {
        "layer": layer + 1,
        "y": torch.clamp(y, max=h - 1),
        "x": torch.clamp(x, max=w - 1),
        "score": top,
    }


# dog_select sorts each image's top-k2 cells in shared memory (8 bytes each).
_K4_MAX_BUDGET = 16384
# dog_select's passes over an image's block maxima cut them into blocks of
# this many keys; an image keeps this many control words (for each of the two
# passes over all of them a 256-bin histogram and each bin's largest and
# smallest key; the selection's state).
_K4_KEYS_A_BLOCK = 4096
_K4_CONTROL_WORDS = 2 * 3 * 256 + 9


def dog_select_plan(B: int, S: int, h: int, w: int, budget: int) -> dict:
    """What ``sfm_dog_select`` is given for a (B, S, h, w) score grid: the
    block maxima an image (n1), the two levels' k (k1, k2), the blocks of
    keys an image (blocks) and its workspace in 32-bit words (words): the
    keys and room for as many candidates, the control words, a count a
    block, seven words a survivor (its value and index, the selected block
    in its place, its four cells), one a top cell, then, 8-byte aligned, the
    top cells' int64 positions."""
    n1 = S * ((h + 3) // 4) * ((w + 3) // 4)
    k1 = min(budget, n1)
    k2 = min(budget, 4 * k1)
    blocks = -(-n1 // _K4_KEYS_A_BLOCK)
    words = B * (2 * n1 + _K4_CONTROL_WORDS + blocks + 7 * k1 + k2)
    words += words % 2
    return {"n1": n1, "k1": k1, "k2": k2, "blocks": blocks, "words": words + 2 * B * k2}


def select_octave_candidates_cuda(fields, budget: int):
    score = fields["score"]
    B, S, h, w = score.shape
    dev = score.device
    if not 1 <= budget <= _K4_MAX_BUDGET:
        raise ValueError(f"dog_select: budget {budget} outside [1, {_K4_MAX_BUDGET}]")
    _kernels.check_tensor(score, "score", torch.float32, (B, S, h, w), dev)
    words = dog_select_plan(B, S, h, w, budget)["words"]
    work = torch.empty(words, dtype=torch.int32, device=dev)
    e = lambda dt: torch.empty((B, budget), dtype=dt, device=dev)
    layer, y, x, top = e(torch.int64), e(torch.int64), e(torch.int64), e(torch.float32)
    _kernels.launch("dog_select", dev, score, B, S, h, w, budget, work, words, layer, y, x, top)
    return {"layer": layer, "y": y, "x": x, "score": top}


def select_octave_candidates(fields, budget: int):
    """Kernel K4 ``dog_select`` on a CUDA score grid, its plain twin on CPU."""
    score = fields["score"]
    if score.is_cuda:
        return select_octave_candidates_cuda({"score": score.contiguous()}, budget)
    if score.device.type == "cpu":
        return select_octave_candidates_plain(fields, budget)
    raise ValueError(f"select_octave_candidates: unsupported device {score.device}")
