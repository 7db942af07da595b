"""Retrieval-based candidate-pair preselection for large scenes.

Counterpart of ``sfm_tpu/matching/retrieval.py``. Every candidate pair is
scored by its mutual ratio-test match count over both images' top-S
keypoints (``desc[:, :S]``: the frontend orders keypoints by response); the
full match + verify sweep then runs only on the pairs that clear the score
bar or rank among an image's top-k neighbours. The count is kernel K1-r
(``csrc/retrieval_score.cu``): a block finishes both directions of a pair's
S x S distance matrix inside the block and writes one int32 (at S <= 256,
D <= 128 a persistent block an SM walks its pairs with their rows resident;
past that, a block a pair); :func:`score_chunk_plain` is its twin. Scores are computed in float32 (the
reference allows bf16 on the TPU). The selection rules run on the host.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from sfm_tpu_torch import _kernels
from sfm_tpu_torch.config import RetrievalConfig

# The kernel keeps per-row and per-column state for S rows in shared memory
# and stages descriptors in chunks of 32 floats (csrc/retrieval_score.cu's
# header: which shapes take which of its two designs).
_K1R_MAX_S = 1024
_K1R_D_MULTIPLE = 32


def score_chunk_plain(pairs, desc_s, valid_s, ratio_threshold: float):
    """(C, 2) pair indices -> (C,) int32 mutual ratio-test match counts.

    desc_s: (N, S, D) unit descriptors; valid_s: (N, S). Ties go to the
    lowest index in both directions, as ``jnp.argmin``.
    """
    i, j = pairs[:, 0].long(), pairs[:, 1].long()
    v1, v2 = valid_s[i], valid_s[j]
    sim = desc_s[i] @ desc_s[j].mT
    dist = torch.clamp(2.0 - 2.0 * sim, min=0.0)
    dist = torch.where(v2[:, None, :], dist, torch.inf)
    dist = torch.where(v1[:, :, None], dist, torch.inf)
    d_best, best_j = torch.min(dist, dim=2)
    d_second = torch.min(dist.scatter(2, best_j[..., None], torch.inf), dim=2).values
    back = torch.argmin(dist, dim=1)                              # column argmin
    rows = torch.arange(dist.shape[1], device=dist.device)
    good = ((d_best < (ratio_threshold ** 2) * d_second) & v1 & torch.isfinite(d_best)
            & (torch.gather(back, 1, best_j) == rows))
    return good.sum(1, dtype=torch.int32)


def score_chunk_cuda(pairs, desc_s, valid_s, ratio_threshold: float):
    N, S, D = desc_s.shape
    C = pairs.shape[0]
    dev = desc_s.device
    if S > _K1R_MAX_S or D % _K1R_D_MULTIPLE:
        raise ValueError(f"retrieval_score: S={S} must be <= {_K1R_MAX_S} and D={D} a "
                         f"multiple of {_K1R_D_MULTIPLE}")
    _kernels.check_tensor(pairs, "pairs", torch.int32, (C, 2), dev)
    _kernels.check_tensor(desc_s, "desc_s", torch.float32, (N, S, D), dev)
    _kernels.check_tensor(valid_s, "valid_s", torch.bool, (N, S), dev)
    counts = torch.empty((C,), dtype=torch.int32, device=dev)
    if C:
        _kernels.launch("retrieval_score", dev, desc_s, valid_s, pairs, N, S, D, C,
                        float(ratio_threshold ** 2), counts)
    return counts


def score_chunk(pairs, desc_s, valid_s, ratio_threshold: float):
    """Kernel K1-r on CUDA tensors, :func:`score_chunk_plain` on CPU."""
    if desc_s.is_cuda:
        return score_chunk_cuda(pairs, desc_s, valid_s, ratio_threshold)
    if desc_s.device.type == "cpu":
        return score_chunk_plain(pairs, desc_s, valid_s, ratio_threshold)
    raise ValueError(f"retrieval_score: unsupported device {desc_s.device}")


def retrieval_scores(desc, valid, pairs: np.ndarray,
                     config: RetrievalConfig = RetrievalConfig()) -> np.ndarray:
    """Mini-match scores of every candidate pair, (P,) int32 on the host.

    ``desc`` (N, K, D) is a tensor (it names the device) or a numpy array
    (the CPU); ``valid`` (N, K) is moved to its device. Pairs run in chunks
    of ``config.chunk_size``; the counts come back in one copy.
    """
    desc = torch.as_tensor(desc)
    dev = desc.device
    S = min(config.subsample, desc.shape[1])
    desc_s = desc[:, :S].to(torch.float32).contiguous()
    valid_s = torch.as_tensor(valid, device=dev)[:, :S].to(torch.bool).contiguous()
    pairs = torch.as_tensor(np.asarray(pairs, np.int32), device=dev)
    counts = [score_chunk(pairs[c0:c0 + config.chunk_size], desc_s, valid_s,
                          config.ratio_threshold)
              for c0 in range(0, pairs.shape[0], config.chunk_size)]
    if not counts:
        return np.zeros(0, np.int32)
    return torch.cat(counts).cpu().numpy().astype(np.int32)


def select_pairs_from_scores(scores: np.ndarray, pairs: np.ndarray, num_images: int,
                             min_score: int, top_k: int) -> np.ndarray:
    """Keep mask over ``pairs``: score >= min_score OR in either image's
    top-k scoring neighbours (the connectivity floor)."""
    scores = np.asarray(scores)
    pairs = np.asarray(pairs)
    keep = scores >= min_score
    if top_k > 0:
        # Each pair under both endpoints, sorted by (image, -score); a pair's
        # rank is its position within its image's group.
        img = np.concatenate([pairs[:, 0], pairs[:, 1]])
        pidx = np.tile(np.arange(len(pairs)), 2)
        order = np.lexsort((-np.tile(scores, 2), img))
        img_sorted = img[order]
        group_start = np.searchsorted(img_sorted, np.arange(num_images))
        ranks = np.arange(len(order)) - group_start[img_sorted]
        keep[pidx[order[ranks < top_k]]] = True
    return keep


def select_pairs_adaptive(scores: np.ndarray, pairs: np.ndarray, num_images: int,
                          config: RetrievalConfig = RetrievalConfig()):
    """Per-image-calibrated keep mask: image i's bar is ``adaptive_beta`` x
    its top_k-th best incident score, clamped to [min_score_floor,
    min_score]; a pair must clear the lower of its two endpoint bars, or be
    in an endpoint's top-k. Returns (keep_mask, median_effective_threshold).
    """
    scores = np.asarray(scores)
    pairs = np.asarray(pairs)
    img = np.concatenate([pairs[:, 0], pairs[:, 1]])
    sc2 = np.tile(scores, 2)
    order = np.lexsort((-sc2, img))
    img_sorted = img[order]
    group_start = np.searchsorted(img_sorted, np.arange(num_images))
    k = max(config.top_k, 1)
    s_k = np.zeros(num_images, scores.dtype)
    # Each image's score at rank min(k, count) - 1: its k-th best, or its
    # worst incident score when it has fewer than k candidates.
    counts = np.searchsorted(img_sorted, np.arange(num_images), side="right") - group_start
    take = group_start + np.minimum(counts, k) - 1
    nonempty = counts > 0
    s_k[nonempty] = sc2[order][take[nonempty]]
    bar_img = np.clip(config.adaptive_beta * s_k, config.min_score_floor, config.min_score)
    thr = np.minimum(bar_img[pairs[:, 0]], bar_img[pairs[:, 1]])
    keep = scores >= thr
    if config.top_k > 0:
        keep |= select_pairs_from_scores(scores, pairs, num_images,
                                         np.iinfo(np.int32).max, config.top_k)
    return keep, float(np.median(thr))


def select_candidate_pairs(desc, valid, num_images: int,
                           config: RetrievalConfig = RetrievalConfig(),
                           pairs: Optional[np.ndarray] = None):
    """Score the candidate pairs (default all i < j) and return
    (kept_pairs, stats dict)."""
    from sfm_tpu_torch.matching.sweep import candidate_pairs

    t0 = time.time()
    n_all = num_images * (num_images - 1) // 2
    if config.mode == "sequential":
        kept = sequential_pairs(num_images, config.sequential_window)
        return kept, {"candidates": n_all, "kept": int(kept.shape[0]),
                      "keep_frac": kept.shape[0] / max(n_all, 1),
                      "seconds": time.time() - t0}
    if pairs is None:
        pairs = candidate_pairs(num_images)
    scores = retrieval_scores(desc, valid, pairs, config)
    if config.adaptive:
        keep, thr = select_pairs_adaptive(scores, pairs, num_images, config)
    else:
        keep = select_pairs_from_scores(scores, pairs, num_images, config.min_score,
                                        config.top_k)
        thr = float(config.min_score)
    stats = {"candidates": int(pairs.shape[0]), "kept": int(keep.sum()),
             "keep_frac": float(keep.mean()), "threshold_median": thr,
             "seconds": time.time() - t0}
    return pairs[keep], stats


def sequential_pairs(num_images: int, window: int) -> np.ndarray:
    """Candidate pairs of an ordered capture: (i, j) with 0 < j - i <= window."""
    i = np.repeat(np.arange(num_images), window)
    j = i + np.tile(np.arange(1, window + 1), num_images)
    ok = j < num_images
    return np.stack([i[ok], j[ok]], axis=-1).astype(np.int32)


def retrieval_enabled(config: RetrievalConfig, num_images: int) -> bool:
    if config.mode in ("on", "sequential"):
        return True
    if config.mode == "auto":
        return num_images >= config.auto_min_images
    return False
