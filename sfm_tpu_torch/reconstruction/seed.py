"""Seed-pair selection: pose recovery + parallax/consistency scoring.

Counterpart of ``sfm_tpu/reconstruction/seed.py``. ``_score_pairs`` is
kernel K14 (``csrc/seed_score.cu``, one block per pair) on a CUDA tensor and
its plain twin :func:`_score_pairs_plain`, batched over the pair axis, on a
CPU tensor. It runs once per reconstruction over at most 256 pairs x 256
matches.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from sfm_tpu_torch import _kernels
from sfm_tpu_torch.geometry.epipolar import essential_from_fundamental, recover_pose
from sfm_tpu_torch.geometry.projection import project
from sfm_tpu_torch.geometry.triangulation import triangulate_two_view

_EPS = 1e-12
# The kernel runs one thread per match in one block per pair.
_K14_MAX_MATCHES = 1024


def _masked_median(x, mask, iters: int = 24):
    """Median of x (..., N) where mask, by bisection on the value range
    (sort(x)[(n-1)//2] to within range/2^iters); +inf where mask is empty."""
    n = mask.sum(-1)
    target = (n + 1) // 2
    lo = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    hi = torch.where(mask, x, 0.0).amax(-1)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        hit = (mask & (x <= mid[..., None])).sum(-1) >= target
        lo = torch.where(hit, lo, mid)
        hi = torch.where(hit, mid, hi)
    return torch.where(n > 0, hi, torch.inf)


def _score_pairs_plain(Fs, xy1, xy2, valid, K):
    """Pose recovery + parallax/consistency scoring over a pair batch.

    Fs: (P, 3, 3); xy1, xy2: (P, N, 2); valid: (P, N); K: (3, 3). Returns
    (scores (P,), Rs, ts, med_parallax_deg, med_err): score =
    cheirality count * clip(median parallax, 0, 10 deg), zeroed unless the
    recovered geometry reprojects its own inliers to < 3 px median.
    """
    E = essential_from_fundamental(Fs, K)
    n_good, R, t, mask = recover_pose(E, xy1, xy2, K, valid.to(torch.float32))
    P = Fs.shape[0]
    eye = torch.eye(3, dtype=Fs.dtype, device=Fs.device).expand(P, 3, 3)
    zero = torch.zeros((P, 3), dtype=Fs.dtype, device=Fs.device)
    P1 = K @ torch.cat([eye, zero[..., None]], dim=-1)
    P2 = K @ torch.cat([R, t[..., None]], dim=-1)
    X = triangulate_two_view(P1, P2, xy1, xy2)                  # (P, N, 3)

    pr1, z1 = project(X, eye[:, None], zero[:, None], K)
    pr2, z2 = project(X, R[:, None], t[:, None], K)
    err = torch.maximum(torch.linalg.vector_norm(pr1 - xy1, dim=-1),
                        torch.linalg.vector_norm(pr2 - xy2, dim=-1))
    use = mask & (z1 > 0) & (z2 > 0)
    med_err = _masked_median(err, use)

    c2 = -(R.mT @ t[..., None])[..., 0]                          # camera-2 center
    r2 = X - c2[:, None]
    cosang = (X * r2).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(X, dim=-1) * torch.linalg.vector_norm(r2, dim=-1), min=_EPS)
    ang = torch.arccos(torch.clamp(cosang, -1.0, 1.0)) * (180.0 / math.pi)
    med_par = _masked_median(ang, use)
    consistent = med_err < 3.0
    score = n_good.to(torch.float32) * torch.clamp(med_par, 0.0, 10.0) * consistent.to(
        torch.float32)
    return score, R, t, med_par, med_err


def _score_pairs_cuda(Fs, xy1, xy2, valid, K):
    P, N = valid.shape
    dev = Fs.device
    if N > _K14_MAX_MATCHES:
        raise ValueError(f"seed_score: N={N} matches exceed {_K14_MAX_MATCHES}")
    _kernels.check_tensor(Fs, "Fs", torch.float32, (P, 3, 3), dev)
    _kernels.check_tensor(xy1, "xy1", torch.float32, (P, N, 2), dev)
    _kernels.check_tensor(xy2, "xy2", torch.float32, (P, N, 2), dev)
    _kernels.check_tensor(valid, "valid", torch.bool, (P, N), dev)
    _kernels.check_tensor(K, "K", torch.float32, (3, 3), dev)
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    score, R, t, med_par, med_err = f32(P), f32(P, 3, 3), f32(P, 3), f32(P), f32(P)
    _kernels.launch("seed_score", dev, Fs, xy1, xy2, valid, K, P, N, score, R, t, med_par,
                    med_err)
    return score, R, t, med_par, med_err


def _score_pairs(Fs, xy1, xy2, valid, K):
    """Kernel K14 on CUDA tensors, :func:`_score_pairs_plain` on CPU."""
    if Fs.is_cuda:
        return _score_pairs_cuda(Fs, xy1, xy2, valid, K)
    if Fs.device.type == "cpu":
        return _score_pairs_plain(Fs, xy1, xy2, valid, K)
    raise ValueError(f"seed_score: unsupported device {Fs.device}")


def find_best_initial_pair(table, K, *, device, max_candidates: int = 256,
                           max_matches: int = 256):
    """Pick the seed pair. Returns (pair_row, R, t, score) as numpy/floats.

    Only the ``max_candidates`` highest-inlier accepted pairs compete, each
    scored on its first ``max_matches`` (quality-sorted) correspondences.
    """
    acc = table.accepted()
    if len(acc) == 0:
        raise ValueError("no accepted pairs to seed from")
    if len(acc) > max_candidates:
        order = np.argsort(-table.num_inliers[acc])[:max_candidates]
        acc = acc[order]
    M = min(max_matches, table.xy1.shape[1])
    dev = torch.device(device)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    valid = torch.as_tensor(np.ascontiguousarray(
        (table.inliers[acc] & table.match_valid[acc])[:, :M]), device=dev)
    scores, Rs, ts, _, _ = _score_pairs(f32(table.F[acc]), f32(table.xy1[acc][:, :M]),
                                        f32(table.xy2[acc][:, :M]), valid, f32(K))
    scores = scores.cpu().numpy()
    best = int(np.argmax(scores))
    if scores[best] <= 0:
        # Every pair failed the consistency gate; fall back to raw inliers.
        best = int(np.argmax(np.asarray(table.num_inliers[acc])))
    return (int(acc[best]), Rs[best].cpu().numpy(), ts[best].cpu().numpy(),
            float(scores[best]))
