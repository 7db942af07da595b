#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sfm_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--views 36] [--large_views 150]

1. Builds the port's CUDA kernels from ``sfm_tpu_torch/csrc`` (nvcc, sm_90a).
2. Holds each kernel against its plain PyTorch twin at the main path's shapes
   (K1, K1-r and K1-g also on +-1/16 binary descriptors at D = 256; K4's
   ``dog_select`` also on the binary frontend's FAST planes and
   ``topk_rows`` on its merge of the levels, where scores tie exactly),
   times both with CUDA events (and one PyTorch library call where one
   computes the same function), and computes each kernel's bound: the larger
   of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s (f32).
3. Renders ``--views`` and then ``--large_views`` 1024x768 views of the
   textured corridor (the port's own ``sfm_tpu_torch/render_scene.py``, in
   one background subprocess, so that the renders overlap the kernel
   phases).
4. Drives the port's main path through ``sfm_tpu_torch.cli`` in this process,
   with the default SfMConfig, every kernel launch counter reset just before
   each path and read just after it:
   a. ``preprocess --device cuda --no_mask`` on the ``--views`` scene: every
      preprocess kernel launched, >= 500 valid keypoints per image, every
      image in an accepted pair, the artifacts written, and the accepted
      pairs' inliers consistent with the rendered cameras' ground-truth
      epipolar geometry;
   b. ``reconstruct`` on those artifacts: every reconstruct kernel launched,
      all but at most one camera registered, > 1,000 points, < 0.6 px mean
      reprojection error, ground-truth rotation median < 1 deg and ATE < 5%
      of the scene, the model and the COLMAP export written;
   c. the guided rescue: ``reconstruct`` on a copy of the pair table with
      every pair of one middle image rejected (``verify.rescue_disconnected``
      off): all cameras registered, the cut image through the guided 2D-3D
      matcher within 2 deg of ground truth, < 0.6 px;
   d. ``pipeline`` on the ``--large_views`` scene, where retrieval turns on:
      fewer pairs swept than all, every image in an accepted pair, the
      ground-truth epipolar check, recall >= 0.95 of the pairs an exhaustive
      (``--match_mode off``) preprocess accepts, all but at most one camera,
      > 1,000 points, < 0.6 px;
   e. ``reconstruct --global_init`` on path a's artifacts (global SfM):
      kernel K13 launched, all but at most one camera, > 1,000 points,
      < 0.6 px, the global model kept (median pair-rotation residual < 1 deg,
      outlier pairs <= ``global_init.fallback_outlier_frac``); ground-truth
      pose printed, not gated;
   f. ``reconstruct --polish`` on path d's artifacts (pose-graph polish of
      the 150-view model): K13 launched, polish ran, all but at most one
      camera, > 1,000 points, < 0.6 px; its adoption, seed and ground-truth
      pose printed beside path d's;
   g. ``pipeline --feature_kind orb`` on the ``--views`` scene (the binary
      frontend, kernel K12), with ``features.fast_threshold`` =
      ``ORB_FAST_THRESHOLD``: every K12 entry, ``dog_select``, ``topk_rows``,
      K1, K2 and the reconstruct kernels launched, and SIFT's ``pyramid``,
      ``dog_extrema``, ``dog_refine`` and ``sift_describe`` not; every image
      in an accepted pair, the ground-truth epipolar check, all but at most
      one camera, > 1,000 points, < 0.6 px; ground-truth pose printed, not
      gated.

Prints the card (nvidia-smi), per-kernel and stage numbers, a JSON line of
the kernels and, last, ``{"ok": true, "device": {...}}``. Any failure raises;
without a card, or outside a checkout of the repository, it exits non-zero
before printing any result. It takes about two minutes on one H100 (``PERF.md``).
"""
from __future__ import annotations

import argparse
import json
import math
import pickle
import subprocess
import sys
import time
from collections import deque
from pathlib import Path

REPO = Path(__file__).resolve().parent

KERNELS = {
    # name: (C entry points, source, the JAX program it replaces)
    "match_top2": (("match_top2",), "sfm_tpu_torch/csrc/match_top2.cu",
                   "sfm_tpu/matching/core.py:51"),
    "fmat_score_select": (("fmat_score_select",), "sfm_tpu_torch/csrc/fmat_ransac.cu",
                          "sfm_tpu/estimators/fundamental.py:20"),
    "dog_extrema": (("dog_extrema",), "sfm_tpu_torch/csrc/dog_extrema.cu",
                    "sfm_tpu/features/detect.py:23"),
    "sift_describe": (("sift_describe",), "sfm_tpu_torch/csrc/sift_describe.cu",
                      "sfm_tpu/features/descriptor.py:371"),
    "pnp_ransac": (("p3p_solve", "pnp_score_select"), "sfm_tpu_torch/csrc/pnp_ransac.cu",
                   "sfm_tpu/estimators/pnp.py:228"),
    "triangulate_tracks": (("triangulate_tracks", "reproj_stats"),
                           "sfm_tpu_torch/csrc/triangulate_tracks.cu",
                           "sfm_tpu/reconstruction/incremental.py:48"),
    "ba_linearize": (("ba_linearize", "ba_cost"), "sfm_tpu_torch/csrc/ba_linearize.cu",
                     "sfm_tpu/ba/residuals.py:68"),
    "schur_coupling": (("schur_coupling",), "sfm_tpu_torch/csrc/schur_coupling.cu",
                       "sfm_tpu/ba/schur.py:348"),
    "retrieval_score": (("retrieval_score",), "sfm_tpu_torch/csrc/retrieval_score.cu",
                        "sfm_tpu/matching/retrieval.py:37"),
    "guided_match": (("guided_match",), "sfm_tpu_torch/csrc/guided_match.cu",
                     "sfm_tpu/reconstruction/incremental.py:159"),
    "pyramid": (("build_pyramid",), "sfm_tpu_torch/csrc/pyramid.cu",
                "sfm_tpu/features/pyramid.py:123"),
    "seed_score": (("seed_score",), "sfm_tpu_torch/csrc/seed_score.cu",
                   "sfm_tpu/reconstruction/seed.py:51"),
    "pnp_refine": (("pnp_refine",), "sfm_tpu_torch/csrc/pnp_refine.cu",
                   "sfm_tpu/estimators/pnp.py:201"),
    "schur_damp": (("schur_damp", "schur_back_substitute"), "sfm_tpu_torch/csrc/schur_damp.cu",
                   "sfm_tpu/ba/schur.py:174"),
    "fmat_solve": (("fmat_hypotheses", "fmat_refit_verify"), "sfm_tpu_torch/csrc/fmat_solve.cu",
                   "sfm_tpu/estimators/fundamental.py:20"),
    "dog_select": (("dog_select", "dog_refine"), "sfm_tpu_torch/csrc/dog_select.cu",
                   "sfm_tpu/features/detect.py:121"),
    "topk_rows": (("topk_rows",), "sfm_tpu_torch/csrc/dog_select.cu",
                  "sfm_tpu/features/frontend.py:169"),
    "match_epilogue": (("match_epilogue", "match_compact"), "sfm_tpu_torch/csrc/match_top2.cu",
                       "sfm_tpu/matching/core.py:81"),
    "relpose": (("relpose",), "sfm_tpu_torch/csrc/relpose.cu",
                "sfm_tpu/reconstruction/global_init.py:147"),
    "rotation_average": (("rotation_average",), "sfm_tpu_torch/csrc/rotation_average.cu",
                         "sfm_tpu/reconstruction/global_init.py:438"),
    "translation_average": (("translation_average",),
                            "sfm_tpu_torch/csrc/translation_average.cu",
                            "sfm_tpu/reconstruction/global_init.py:598"),
    "orb_fast_nms": (("orb_fast_nms",), "sfm_tpu_torch/csrc/orb.cu",
                     "sfm_tpu/features/binary.py:110"),
    "orb_blur": (("orb_blur",), "sfm_tpu_torch/csrc/pyramid.cu",
                 "sfm_tpu/features/binary.py:289"),
    "orb_describe": (("orb_describe",), "sfm_tpu_torch/csrc/orb.cu",
                     "sfm_tpu/features/binary.py:240"),
}
# The kernels each path must launch.
PREPROCESS_KERNELS = ("match_top2", "fmat_score_select", "dog_extrema", "sift_describe",
                      "pyramid", "fmat_solve", "dog_select", "topk_rows", "match_epilogue")
RECONSTRUCT_KERNELS = ("pnp_ransac", "triangulate_tracks", "ba_linearize", "schur_coupling",
                       "seed_score", "pnp_refine", "schur_damp")
RESCUE_KERNELS = RECONSTRUCT_KERNELS + ("guided_match",)
LARGE_KERNELS = PREPROCESS_KERNELS + RECONSTRUCT_KERNELS + ("retrieval_score",)
K13_KERNELS = ("relpose", "rotation_average", "translation_average")
GLOBAL_KERNELS = K13_KERNELS + ("triangulate_tracks", "ba_linearize", "schur_coupling",
                                "schur_damp")
POLISH_KERNELS = RECONSTRUCT_KERNELS + K13_KERNELS
K12_KERNELS = ("orb_fast_nms", "orb_blur", "orb_describe")
# Path g: K4's dog_select and dog_refine share a row; only dog_select runs there.
ORB_KERNELS = K12_KERNELS + ("topk_rows", "match_top2", "match_epilogue", "fmat_score_select",
                             "fmat_solve") + RECONSTRUCT_KERNELS
ORB_ENTRIES = ("dog_select",)
SIFT_ONLY_ENTRIES = ("build_pyramid", "dog_extrema", "dog_refine", "sift_describe")
# FAST's contrast gate (u8 scale) on the rendered corridor. Its band-limited
# fractal texture has few sharp corners: at the default 20 the 3,800-row
# tables stay mostly padding (tests/orb_parity_report.py counts them); at 5
# they fill, so path g runs the binary frontend at its full width (PERF.md,
# section 4).
ORB_FAST_THRESHOLD = 5.0


def log(msg: str):
    print(msg, flush=True)


def check(cond, msg: str):
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# The H100's published peaks (NVIDIA's data sheet, SXM part, at 700 W): HBM
# at 3.35 TB/s and float32 outside the tensor cores at 67 TFLOP/s. Every
# kernel here computes in f32 (compares and integer steps counted alike).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def result(err, ms, plain_ms, moved, ops, library_ms=None) -> dict:
    """A kernel phase's numbers. ``moved``: the bytes its function must move
    (each input read once, each output written once); ``ops``: the
    operations it does on this run's inputs (estimated from its loops);
    ``library_ms``: one PyTorch call computing the same function, if any."""
    return {"max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms, "bytes": int(moved),
            "ops": int(ops), "library_ms": library_ms}


def bound(r: dict):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = r["bytes"] / PEAK_BYTES_PER_S, r["ops"] / PEAK_F32_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- synthetic data

def _unit(torch, x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def two_view_batch(np, B: int, M: int, seed: int = 0):
    """B synthetic match tables of M rows: projections of random points into
    two cameras, 0.5 px noise, 30% outliers, a valid prefix of min(300, M/2)..M
    rows. Returns (p1, p2, valid, F), F the cameras' unit-norm fundamental
    matrices."""
    rng = np.random.default_rng(seed)
    K = np.array([[1228.0, 0, 512.0], [0, 1228.0, 384.0], [0, 0, 1.0]])
    Kinv = np.linalg.inv(K)
    p1 = np.zeros((B, M, 2), np.float32)
    p2 = np.zeros((B, M, 2), np.float32)
    valid = np.zeros((B, M), bool)
    F = np.zeros((B, 3, 3), np.float32)
    for b in range(B):
        X = rng.uniform([-2, -2, 4], [2, 2, 8], (M, 3))
        a = rng.uniform(0.05, 0.3)
        R = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0], [-math.sin(a), 0, math.cos(a)]])
        t = np.array([rng.uniform(0.3, 1.0), 0.05, 0.1])
        for dst, (Rc, tc) in ((p1, (np.eye(3), np.zeros(3))), (p2, (R, t))):
            x = (X @ Rc.T + tc) @ K.T
            dst[b] = x[:, :2] / x[:, 2:] + rng.normal(0, 0.5, (M, 2))
        out = rng.random(M) < 0.3
        p2[b, out] = rng.uniform([0, 0], [1024, 768], (out.sum(), 2))
        valid[b, : rng.integers(min(300, M // 2), M + 1)] = True
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        Fb = Kinv.T @ tx @ R @ Kinv
        F[b] = Fb / np.linalg.norm(Fb)
    return p1 * valid[..., None], p2 * valid[..., None], valid, F


# ---------------------------------------------------------------- kernel phases

def sweep_descriptors(torch, dev, B: int, K: int, D: int, seed: int):
    """B pairs of K unit descriptors, 1,200 of each pair's second set near a
    row of its first; 5% of the rows and columns invalid."""
    g = torch.Generator(device=dev).manual_seed(seed)
    d1 = _unit(torch, torch.randn(B, K, D, generator=g, device=dev))
    d2 = _unit(torch, torch.randn(B, K, D, generator=g, device=dev))
    perm = torch.randperm(K, generator=g, device=dev)[:1200]
    d2[:, :1200] = _unit(torch, d1[:, perm] + 0.08 * torch.randn(B, 1200, D, generator=g,
                                                                 device=dev))
    v1 = torch.rand(B, K, generator=g, device=dev) > 0.05
    v2 = torch.rand(B, K, generator=g, device=dev) > 0.05
    return d1, v1, d2, v2


def tie_heavy_descriptors(torch, dev, B: int, K: int, D: int = 256, seed: int = 4):
    """+-1/16 descriptors drawn from a small set: every dot product is a
    multiple of 1/256, exact in f32, so distances tie exactly (duplicated
    rows and columns); 10% of the rows and columns invalid."""
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.where(torch.rand(96, D, generator=g, device=dev) < 0.5, -1.0, 1.0) / 16.0
    d1 = base[torch.randint(0, 96, (B, K), generator=g, device=dev)]
    d2 = base[torch.randint(0, 96, (B, K), generator=g, device=dev)]
    d2 = torch.where(torch.rand(B, K, D, generator=g, device=dev) < 0.04, -d2, d2)
    v1 = torch.rand(B, K, generator=g, device=dev) > 0.1
    v2 = torch.rand(B, K, generator=g, device=dev) > 0.1
    return d1.contiguous(), v1, d2.contiguous(), v2


def phase_match_top2(torch, dev):
    """K1 at 32 pairs x K=2048 x D=128 (one sweep chunk), with the mutual
    check's column argmin from the same tiles; and a tie-heavy input."""
    from sfm_tpu_torch.matching.core import match_top2_cuda, match_top2_plain

    B, K, D = 32, 2048, 128
    args = sweep_descriptors(torch, dev, B, K, D, seed=1)
    err = 0.0
    for what, a in (("random", args), ("tie-heavy", tie_heavy_descriptors(torch, dev, 8, K))):
        idx_k, best_k, sec_k, back_k = match_top2_cuda(*a, mutual=True)
        idx_p, best_p, sec_p, back_p = match_top2_plain(*a, mutual=True)
        torch.cuda.synchronize()
        # Tolerance: row and column indices equal (no tie allowance); distances
        # within 1e-5 absolute (another summation order).
        fin = torch.isfinite(best_p)
        check(torch.equal(torch.isfinite(best_k), fin), f"K1 ({what}): finite pattern differs")
        fin2 = torch.isfinite(sec_p)
        e = max(float((best_k - best_p)[fin].abs().max()),
                float((sec_k - sec_p)[fin2].abs().max()))
        check(e <= 1e-5, f"K1 ({what}): distance error {e}")
        check(torch.equal(idx_k.long(), idx_p),
              f"K1 ({what}): best index differs in {int((idx_k.long() != idx_p).sum())} rows")
        check(torch.equal(back_k.long(), back_p),
              f"K1 ({what}): column argmin differs in {int((back_k.long() != back_p).sum())} "
              "columns")
        err = max(err, e)
        log(f"K1 match_top2 ({what}, {tuple(a[0].shape)}): max_abs_err {e:.3g}, row and "
            f"column indices equal in all {idx_k.numel()} rows and {back_k.numel()} columns")
    ms = time_ms(torch, lambda: match_top2_cuda(*args, mutual=True))
    plain_ms = time_ms(torch, lambda: match_top2_plain(*args, mutual=True))
    idx_k, best_k, sec_k, back_k = match_top2_cuda(*args, mutual=True)
    # 2 K^2 D FMA-FLOP per pair: one product serves both directions.
    return result(err, ms, plain_ms, nbytes(*args, idx_k, best_k, sec_k, back_k),
                  2 * B * K * K * D)


def phase_match_epilogue(torch, dev):
    """K1's epilogue at one sweep chunk (32 pairs x 2,048 rows -> 1,024
    matches): match_epilogue's ratio / mutual test / score, then topk_rows,
    then match_compact, against the twins on the same top-2 outputs, on the
    random and the tie-heavy input."""
    from sfm_tpu_torch.estimators.ransac import top_k_plain, top_k_rows
    from sfm_tpu_torch.matching.core import (
        match_compact_cuda, match_compact_plain, match_epilogue_cuda, match_epilogue_plain,
        match_top2_cuda)

    B, K, D, M = 32, 2048, 128, 1024
    for what, a in (("random", sweep_descriptors(torch, dev, B, K, D, seed=2)),
                    ("tie-heavy", tie_heavy_descriptors(torch, dev, B, K))):
        best_j, d_best, d_second, back = match_top2_cuda(*a, mutual=True)
        ep = (best_j, d_best, d_second, a[1], back, 0.75)
        sk, sp = match_epilogue_cuda(*ep), match_epilogue_plain(*ep)
        vk, ik = top_k_rows(sk, M)
        vp, ip = top_k_plain(sp, M)
        ok_, op_ = match_compact_cuda(vk, ik, best_j, M), match_compact_plain(vp, ip, best_j, M)
        torch.cuda.synchronize()
        # Tolerance: identical scores, compaction order and match table.
        check(torch.equal(sk, sp), f"K1 epilogue ({what}): scores differ")
        for k in ("idx1", "idx2", "valid", "distance"):
            check(torch.equal(ok_[k], op_[k]), f"K1 compaction ({what}): {k} differs")
        log(f"K1 match_epilogue + match_compact ({what}): scores and the (B, {M}) match table "
            f"identical to the twins; {int(ok_['valid'].sum())} matches kept")
    # The two entries of this kernel, timed apart (topk_rows runs between them).
    ms = (time_ms(torch, lambda: match_epilogue_cuda(*ep))
          + time_ms(torch, lambda: match_compact_cuda(vk, ik, best_j, M)))
    plain_ms = (time_ms(torch, lambda: match_epilogue_plain(*ep))
                + time_ms(torch, lambda: match_compact_plain(vp, ip, best_j, M)))
    moved = nbytes(best_j, d_best, d_second, a[1], back, sk) + nbytes(vk, ik, *ok_.values())
    # ~6 operations a row (ratio, mutual gather, compares, select) and ~4 a slot.
    return result(0.0, ms, plain_ms, moved, 6 * B * K + 4 * B * M)


def phase_fmat(torch, np, dev):
    """K2 at 32 pairs x 512 hypotheses x 1,024 rows (one sweep chunk):
    fmat_hypotheses, fmat_score_select on the first 256 rows, then
    fmat_refit_verify on all rows. Returns (score_select, fmat_solve)."""
    from sfm_tpu_torch.estimators.fundamental import (
        fmat_hypotheses_cuda, fmat_hypotheses_plain, fmat_refit_verify_cuda,
        fmat_refit_verify_plain, fmat_score_select_cuda, fmat_score_select_plain)
    from sfm_tpu_torch.estimators.ransac import ransac_sample_indices
    from sfm_tpu_torch.geometry.epipolar import normalize_points, symmetric_epipolar_distance

    B, M, H, N, thr = 32, 1024, 512, 256, 3.0
    p1, p2, valid = (torch.as_tensor(a, device=dev) for a in two_view_batch(np, B, M)[:3])
    g = torch.Generator(device=dev).manual_seed(2)
    idx = ransac_sample_indices(valid, H, 8, g, prefix=True).contiguous()
    hargs = (p1, p2, idx)
    Fs_k = fmat_hypotheses_cuda(*hargs)
    Fs = fmat_hypotheses_plain(*hargs).contiguous()
    torch.cuda.synchronize()
    # Tolerance, hypotheses: sign-aligned within 1e-4 on >= 99% of the
    # well-conditioned samples: the second-smallest eigenvalue of the
    # normalized 9x9 A^T A (in f64) >= 1e-3 of its largest, which bounds the
    # null vector's f32 rounding (~eps lambda_max / lambda_2) near 6e-5. A
    # degenerate sample's junk scores no consensus on either side.
    flat = idx.reshape(B, -1, 1).expand(-1, -1, 2)
    take = lambda p: torch.gather(p.double(), 1, flat).reshape(B, H, 8, 2)
    n1, _ = normalize_points(take(p1))
    n2, _ = normalize_points(take(p2))
    x1, y1, x2, y2 = n1[..., 0], n1[..., 1], n2[..., 0], n2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)],
                    dim=-1)
    lam = torch.linalg.eigvalsh(A.mT @ A)
    well = lam[..., 1] >= 1e-3 * lam[..., -1]
    d_hyp = torch.minimum((Fs_k - Fs).flatten(-2).abs().amax(-1),
                          (Fs_k + Fs).flatten(-2).abs().amax(-1))
    frac_h = float((d_hyp[well] <= 1e-4).float().mean())
    fair = lam[..., 1] >= 1e-4 * lam[..., -1]
    log(f"  fmat_hypotheses at lambda_2 >= 1e-4 lambda_max: "
        f"{float((d_hyp[fair] <= 1e-4).float().mean()):.4%} of {int(fair.sum())} within 1e-4")
    check(int(well.sum()) >= 1000 and frac_h >= 0.99,
          f"K2 fmat_hypotheses: {frac_h:.4f} of {int(well.sum())} well-conditioned samples "
          "within 1e-4")
    log(f"K2 fmat_hypotheses: {frac_h:.4%} of {int(well.sum())}/{B * H} well-conditioned "
        f"samples within 1e-4, max difference there {float(d_hyp[well].max()):.3g}")
    args = (Fs, p1[:, :N].contiguous(), p2[:, :N].contiguous(), valid[:, :N].contiguous(), thr)
    best_k, count_k = fmat_score_select_cuda(*args)
    best_p, count_p = fmat_score_select_plain(*args)
    torch.cuda.synchronize()
    # Tolerance: the same winner, or one whose score is within 1e-4 of the
    # plain winner's (a tie under another summation order of the error sum).
    errs = symmetric_epipolar_distance(Fs, args[1][:, None], args[2][:, None])
    inl = (errs < thr) & args[3][:, None]
    counts = inl.sum(-1)
    score = counts.float() - torch.where(inl, errs, 0.0).sum(-1) / counts.clamp(min=1) / thr
    pick = lambda h: score.gather(1, h[:, None])[:, 0]
    gap = float((pick(best_p) - pick(best_k)).abs().max())
    check(gap <= 1e-4, f"K2: winner score gap {gap}")
    check(torch.equal(count_k, counts.gather(1, best_k[:, None])[:, 0]), "K2: count")
    log(f"K2 fmat_score_select: same winner in {int((best_k == best_p).sum())}/{B} pairs, "
        f"max score gap {gap:.3g}")
    ms = time_ms(torch, lambda: fmat_score_select_cuda(*args))
    plain_ms = time_ms(torch, lambda: fmat_score_select_plain(*args))
    # ~45 FLOP per (hypothesis, row): two lines, two distances.
    score = result(gap, ms, plain_ms, nbytes(*args[:4], best_k, count_k), 45 * B * H * N)

    # The refit from the kernel pipeline's winner, both sides on the same input.
    best = fmat_score_select_cuda(Fs_k, *args[1:])[0].contiguous()
    rargs = (Fs_k, best, p1, p2, valid, thr)
    rk, rp = fmat_refit_verify_cuda(*rargs), fmat_refit_verify_plain(*rargs)
    rd = fmat_refit_verify_plain(Fs_k.double(), best, p1.double(), p2.double(), valid, thr)
    torch.cuda.synchronize()
    # Tolerance, refit: the refit's f32 null vector moves by ~eps lambda_max /
    # lambda_2 of its 9x9 normal matrix (~3e-4 at 0.5 px noise, more once
    # denormalized), with the summation order, so kernel and twin are each
    # held against the f64 refit, pair by pair: the kernel's F (unit-norm,
    # sign-aligned) no farther from it than max(1e-4, 3x the twin's), and the
    # inlier rows' epipolar distances under it no farther from the f64 F's
    # than max(1e-2 px, 3x the twin's); inliers equal on >= 99.9% of rows (a
    # row on the threshold may flip); accept equal on every pair.
    dist = lambda a, b: torch.minimum((a - b).flatten(-2).abs().amax(-1),
                                      (a + b).flatten(-2).abs().amax(-1))
    d_f = float(dist(rk["F"], rp["F"]).max())
    ek, ep = dist(rk["F"].double(), rd["F"]), dist(rp["F"].double(), rd["F"])
    both = rk["inliers"] & rp["inliers"]
    px = lambda r: float((r["errors"].double() - rd["errors"]).abs()[both].max())
    pk_, pp_ = px(rk), px(rp)
    inl_eq = float((rk["inliers"] == rp["inliers"]).float().mean())
    check(bool((ek <= torch.clamp(3 * ep, min=1e-4)).all()) and pk_ <= max(1e-2, 3 * pp_)
          and inl_eq >= 0.999, f"K2 fmat_refit_verify: F to f64: kernel {float(ek.max())}, "
          f"twin {float(ep.max())}; inlier distances to f64: kernel {pk_} px, twin {pp_} px; "
          f"inliers equal on {inl_eq:.5f} of rows")
    check(torch.equal(rk["accept"], rp["accept"]) and torch.equal(rk["ok"], rp["ok"]),
          "K2 fmat_refit_verify: accept differs")
    check(bool(rk["accept"].any()), "K2 fmat_refit_verify: no pair accepted")
    log(f"K2 fmat_refit_verify: F max difference {d_f:.3g} (to the f64 refit: kernel "
        f"{float(ek.max()):.3g}, twin {float(ep.max()):.3g}); inlier rows' distances to the "
        f"f64 F's: kernel {pk_:.3g} px, twin {pp_:.3g} px; inliers equal on {inl_eq:.4%} of "
        f"{B * M} rows, accept equal on all {B} pairs ({int(rk['accept'].sum())} accepted)")
    hyp_ms = time_ms(torch, lambda: fmat_hypotheses_cuda(*hargs))
    hyp_plain = time_ms(torch, lambda: fmat_hypotheses_plain(*hargs))
    ref_ms = time_ms(torch, lambda: fmat_refit_verify_cuda(*rargs))
    ref_plain = time_ms(torch, lambda: fmat_refit_verify_plain(*rargs))
    log(f"  fmat_hypotheses {hyp_ms:.4f} ms (plain torch {hyp_plain:.4f} ms); "
        f"fmat_refit_verify {ref_ms:.4f} ms (plain torch {ref_plain:.4f} ms)")
    # Hypotheses: ~1.7 kFLOP a sample (A^T A 720, Cholesky ~330, 3 solves ~490,
    # normalization and denormalization ~150). Refit: ~300 FLOP a row over its
    # five passes, ~3 kFLOP of thread 0's solve per pair.
    solve = result(max(float(d_hyp[well].max()), d_f), hyp_ms + ref_ms, hyp_plain + ref_plain,
                   nbytes(p1, p2, idx, Fs_k, valid, best) + 36 * B
                   + sum(nbytes(v) for v in rk.values()),
                   1700 * B * H + 300 * B * M + 3000 * B)
    return score, solve


def phase_dog_extrema(torch, dev, image, cfg):
    """K4 on every octave of one rendered image, octave -1 (1536 x 2048) included."""
    from sfm_tpu_torch.features.detect import (
        dog_extrema_scores_cuda, dog_extrema_scores_plain)
    from sfm_tpu_torch.features.pyramid import build_pyramid

    fc = cfg.features
    _, dogs = build_pyramid(image, num_octaves=fc.num_octaves,
                            scales_per_octave=fc.scales_per_octave, sigma0=fc.sigma0,
                            assumed_blur=fc.assumed_blur, upsample=fc.upsample_first_octave)
    dogs = [d.contiguous() for d in dogs]
    check(tuple(dogs[0].shape[-2:]) == (1536, 2048), f"octave -1 is {tuple(dogs[0].shape)}")
    ct, et = fc.contrast_threshold, fc.edge_threshold
    for d in dogs:
        got = dog_extrema_scores_cuda(d, ct, et)["score"]
        ref = dog_extrema_scores_plain(d, ct, et)["score"]
        torch.cuda.synchronize()
        # Tolerance: bit-exact (the kernel only compares).
        check(torch.equal(got, ref), f"K4: differs on octave {tuple(d.shape)}")
    n = sum(int((dog_extrema_scores_cuda(d, ct, et)["score"] > 0).sum()) for d in dogs)
    log(f"K4 dog_extrema: bit-exact on {len(dogs)} octaves, {n} extrema")
    ms = time_ms(torch, lambda: [dog_extrema_scores_cuda(d, ct, et) for d in dogs])
    plain_ms = time_ms(torch, lambda: [dog_extrema_scores_plain(d, ct, et) for d in dogs])
    # 26 compares per interior-layer pixel; the DoG read, the scores written.
    interior = sum(d[:, 1:-1].numel() for d in dogs)
    return result(0.0, ms, plain_ms, sum(nbytes(d) for d in dogs) + 4 * interior, 26 * interior)


def phase_describe(torch, dev, image, cfg):
    """K5 on the 2048 selected keypoints and the canvas of one rendered image."""
    from sfm_tpu_torch.features.descriptor import (
        orientation_and_descriptor_canvas_cuda, orientation_and_descriptor_canvas_plain,
        orientation_near_tie)
    from sfm_tpu_torch.features.frontend import select_keypoints

    fc = cfg.features
    kp = select_keypoints(image, None, fc)
    args = kp["describe"]
    kw = dict(descriptor_scale=fc.descriptor_scale, clip=fc.descriptor_clip)
    ang_k, desc_k = orientation_and_descriptor_canvas_cuda(*args, **kw)
    ang_p, desc_p = orientation_and_descriptor_canvas_plain(*args, **kw)
    torch.cuda.synchronize()
    # Tolerance: >= 99.5% of valid keypoints within 1e-3 rad and 1e-3 L2
    # (atomics reorder the histogram sums); the rest must be orientation
    # near-ties (the two largest smoothed bins within 1%).
    valid = kp["valid"]
    d_ang = (ang_k - ang_p).abs() % (2 * math.pi)
    d_ang = torch.minimum(d_ang, 2 * math.pi - d_ang)
    ok = (d_ang <= 1e-3) & (torch.linalg.vector_norm(desc_k - desc_p, dim=-1) <= 1e-3)
    ties = orientation_near_tie(*args)
    nv = int(valid.sum())
    frac = float(ok[valid].float().mean())
    off = valid & ~ok
    check(nv >= 500 and frac >= 0.995, f"K5: {frac:.4f} of {nv} keypoints in tolerance")
    check(int((off & ~ties).sum()) == 0, "K5: a keypoint outside tolerance is no near-tie")
    err = float((desc_k - desc_p).abs()[valid & ok].max())
    log(f"K5 sift_describe: {frac:.4%} of {nv} valid keypoints in tolerance, "
        f"{int(off.sum())} outside (all orientation near-ties)")
    ms = time_ms(torch, lambda: orientation_and_descriptor_canvas_cuda(*args, **kw))
    plain_ms = time_ms(torch, lambda: orientation_and_descriptor_canvas_plain(*args, **kw))
    # Per keypoint: its 66 x 66 f16 patch and 7 parameters in, 129 floats out;
    # ~512 samples of ~40 FLOP for the orientation and again for the descriptor.
    K = valid.numel()
    return result(err, ms, plain_ms, K * (66 * 66 * 2 + 7 * 4 + 129 * 4), K * 512 * 80)


def orb_levels(torch, images, cfg):
    """The binary frontend's pyramid of one detection sub-batch: (level, image
    plane, keypoint budget) for each level, as ``features.binary.detect_orb``
    builds it."""
    from sfm_tpu_torch.features.binary import _level_budgets, level_shape, resize_linear

    fc = cfg.features
    H, W = images.shape[-2:]
    out = []
    for lvl, budget in enumerate(_level_budgets(fc.max_keypoints, fc.orb_levels,
                                                fc.orb_scale_factor)):
        im = images if lvl == 0 else resize_linear(images, *level_shape(
            H, W, lvl, fc.orb_scale_factor))
        out.append((lvl, im.contiguous(), budget))
    return out


def phase_orb_fast_nms(torch, dev, levels):
    """K12's fast_nms on the three levels of one detection sub-batch of
    rendered images, at path g's threshold; level 0 also under a mask."""
    from sfm_tpu_torch.features.binary import fast_nms_cuda, fast_nms_plain

    t = ORB_FAST_THRESHOLD / 255.0
    g = torch.Generator(device=dev).manual_seed(9)
    worst, ms, plain_ms, moved, ops = 0.0, 0.0, 0.0, 0, 0
    for lvl, im, _ in levels:
        B, H, W = im.shape
        cases = [("no mask", None)]
        if lvl == 0:
            blobs = torch.rand(B, 1, H // 32 + 1, W // 32 + 1, generator=g, device=dev) > 0.3
            mask = torch.repeat_interleave(torch.repeat_interleave(blobs, 32, 2), 32, 3)
            cases.append(("mask", mask[:, 0, :H, :W].contiguous()))
        for what, mk in cases:
            k, p = fast_nms_cuda(im, t, mk), fast_nms_plain(im, t, mk)
            torch.cuda.synchronize()
            # Tolerance: the pass/fail map exact; scores within 1e-6 relative
            # (the kernel sums the 16 terms in the twin's order, unfused, so
            # they are expected bit-identical).
            check(torch.equal(k > 0, p > 0),
                  f"K12 fast_nms level {lvl} ({what}): the kept sets differ in "
                  f"{int(((k > 0) != (p > 0)).sum())} pixels")
            kept = p > 0
            rel = float(((k - p).abs()[kept] / p[kept]).max()) if bool(kept.any()) else 0.0
            check(rel <= 1e-6, f"K12 fast_nms level {lvl} ({what}): relative error {rel}")
            worst = max(worst, float((k - p).abs().max()))
            log(f"K12 fast_nms level {lvl} {tuple(im.shape)} ({what}): "
                f"{'bit-identical' if torch.equal(k, p) else f'max rel err {rel:.3g}'}, "
                f"{int(kept.sum())} pixels kept")
        ms += time_ms(torch, lambda: fast_nms_cuda(im, t))
        plain_ms += time_ms(torch, lambda: fast_nms_plain(im, t), reps=3, warmup=1)
        # The image read once and the plane written once; per pixel 16 ring
        # samples x (2 compares, 2 subtractions, an add) + the arc test's 8
        # bit operations x 2 + 9 NMS maxima: ~110 operations.
        moved += nbytes(im, k)
        ops += 110 * im.numel()
    return result(worst, ms, plain_ms, moved, ops)


def phase_orb_blur(torch, dev, levels):
    """K12's orb_blur (sigma 2, bf16 out) on the three levels of one
    detection sub-batch; library: one float32 2-D convolution."""
    import torch.nn.functional as F

    from sfm_tpu_torch.features.binary import BLUR_SIGMA, orb_blur_cuda, orb_blur_plain
    from sfm_tpu_torch.features.pyramid import _blur_radius, _gaussian_taps

    r = _blur_radius(BLUR_SIGMA)
    taps = torch.as_tensor(_gaussian_taps(BLUR_SIGMA, r), device=dev)
    k2d = (taps[:, None] * taps[None, :])[None, None]
    worst, ms, plain_ms, lib_ms, moved, ops = 0.0, 0.0, 0.0, 0.0, 0, 0
    for lvl, im, _ in levels:
        k, p = orb_blur_cuda(im), orb_blur_plain(im)
        torch.cuda.synchronize()
        # Tolerance: within 1e-6 after the bf16 rounding (the kernel rounds
        # every product and sum as the twin does: expected bit-identical).
        err = float((k.float() - p.float()).abs().max())
        check(err <= 1e-6, f"K12 orb_blur level {lvl}: max_abs_err {err}")
        worst = max(worst, err)
        log(f"K12 orb_blur level {lvl} {tuple(im.shape)}: "
            f"{'bit-identical' if torch.equal(k, p) else f'max_abs_err {err:.3g}'}")
        ms += time_ms(torch, lambda: orb_blur_cuda(im))
        plain_ms += time_ms(torch, lambda: orb_blur_plain(im))
        lib_ms += time_ms(torch, lambda: F.conv2d(im[:, None], k2d, padding=r))
        # f32 in, bf16 out; two passes of 2r + 1 taps, a multiply and an add each.
        moved += nbytes(im, k)
        ops += 2 * 2 * (2 * r + 1) * im.numel()
    return result(worst, ms, plain_ms, moved, ops, library_ms=lib_ms)


def phase_orb_describe(torch, dev, levels):
    """K12's orb_describe on the keypoints each level of one detection
    sub-batch selects (2,048 + 1,128 + 624 = 3,800 rows per image), and K4's
    dog_select with one layer on each level's FAST plane, as the ORB path
    calls it. Returns the phase's result and the sub-batch's merge key (the
    levels' responses, -inf for invalid rows), which phase_topk holds."""
    from sfm_tpu_torch.features.binary import (
        _BIN_SCALE, orb_blur_cuda, orb_describe_cuda, orb_describe_plain, fast_nms_cuda)
    from sfm_tpu_torch.features.detect import (
        select_octave_candidates_cuda, select_octave_candidates_plain)

    t = ORB_FAST_THRESHOLD / 255.0
    worst, ms, plain_ms, moved, ops = 0.0, 0.0, 0.0, 0, 0
    n_valid = n_exact = 0
    keys = []
    for lvl, im, budget in levels:
        plane = {"score": fast_nms_cuda(im, t)[:, None]}
        c = select_octave_candidates_cuda(plane, budget)
        cp = select_octave_candidates_plain(plane, budget)
        torch.cuda.synchronize()
        # Tolerance: x, y and score identical and in the same order. FAST
        # scores of u8 contrasts tie exactly and often, and the order among
        # ties decides which keypoints the level keeps.
        for key in ("layer", "y", "x", "score"):
            check(torch.equal(c[key], cp[key]),
                  f"K4 dog_select on K12 level {lvl}: {key} differs")
        ties = int((c["score"][:, 1:] == c["score"][:, :-1]).logical_and(
            c["score"][:, 1:] > 0).sum())
        log(f"K4 dog_select on K12 level {lvl} {tuple(plane['score'].shape)}: {budget} "
            f"candidates identical in order ({int((c['score'] > 0).sum())} nonzero, {ties} "
            "adjacent ties)")
        keys.append(torch.where(c["score"] > 0, c["score"], -torch.inf))
        args = (orb_blur_cuda(im), c["x"], c["y"], c["score"] > 0)
        ak, dk = orb_describe_cuda(*args)
        ap, dp = orb_describe_plain(*args)
        torch.cuda.synchronize()
        # Tolerance: the descriptor bits exact on every keypoint whose
        # steering bin is away from a boundary (|frac - round(frac)| < 0.5 -
        # 1e-3: the moments are exact sums, but atan2 may differ by an ulp),
        # and exact on >= 99% of the valid keypoints overall; angles within
        # 1e-6 rad.
        valid = args[3]
        frac = ap * _BIN_SCALE
        away = (frac - torch.round(frac)).abs() < 0.5 - 1e-3
        rows = (dk == dp).all(-1)
        bad = valid & away & ~rows
        check(int(bad.sum()) == 0, f"K12 orb_describe level {lvl}: {int(bad.sum())} "
              "keypoints away from a bin boundary differ")
        check(torch.equal(dk[~valid], dp[~valid]) and bool((dk[~valid] == 0).all()),
              f"K12 orb_describe level {lvl}: padding rows not zero")
        err = float((ak - ap).abs().max())
        check(err <= 1e-6, f"K12 orb_describe level {lvl}: angle error {err}")
        worst = max(worst, err)
        n_valid += int(valid.sum())
        n_exact += int((valid & rows).sum())
        log(f"K12 orb_describe level {lvl} {tuple(dk.shape)}: {int((valid & rows).sum())} of "
            f"{int(valid.sum())} valid keypoints bit-identical, angle max_abs_err {err:.3g}")
        ms += time_ms(torch, lambda: orb_describe_cuda(*args))
        plain_ms += time_ms(torch, lambda: orb_describe_plain(*args))
        # Per row: x, y, valid in, angle and 256 floats out. The patches
        # overlap: per image the bytes read are those of its valid rows'
        # 33 x 33 bf16 patches, at most its whole bf16 plane. Per valid row
        # 709 disk pixels x 2 moments x 2 operations and 256 tests x 3 (two
        # reads, a compare).
        B, K = valid.shape
        plane_bytes = im.shape[-2] * im.shape[-1] * 2
        moved += B * K * (8 + 8 + 1 + 4 + 256 * 4) + int(
            (valid.sum(1) * 33 * 33 * 2).clamp(max=plane_bytes).sum())
        ops += int(valid.sum()) * (709 * 4 + 256 * 3)
    check(n_exact >= 0.99 * n_valid, f"K12 orb_describe: {n_exact} of {n_valid} exact")
    log(f"K12 orb_describe: {n_exact} of {n_valid} valid keypoints bit-identical over the "
        "three levels")
    return result(worst, ms, plain_ms, moved, ops), torch.cat(keys, 1).contiguous()


def binary_descriptors(torch, d):
    """Sign of unit descriptors as the binary frontend's +-1/16 encoding."""
    return (torch.where(d >= 0, 1.0, -1.0) / 16.0).contiguous()


def phase_match_binary(torch, dev):
    """K1 (match_top2, then match_epilogue / topk_rows / match_compact) at one
    sweep chunk of the binary frontend: 32 pairs x K = 3,800 x D = 256 +-1/16
    descriptors, and a tie-heavy binary input. Every dot product is a
    multiple of 1/256, exact in f32 in any order: results must be identical."""
    from sfm_tpu_torch.estimators.ransac import top_k_plain, top_k_rows
    from sfm_tpu_torch.matching.core import (
        match_compact_cuda, match_compact_plain, match_epilogue_cuda, match_epilogue_plain,
        match_top2_cuda, match_top2_plain)

    B, K, D, M = 32, 3800, 256, 1024
    d1, v1, d2, v2 = sweep_descriptors(torch, dev, B, K, D, seed=10)
    args = (binary_descriptors(torch, d1), v1, binary_descriptors(torch, d2), v2)
    ratio = 0.75 ** 0.5  # map_ratio_for_kind(0.75, "orb")
    for what, a in (("binary", args), ("tie-heavy", tie_heavy_descriptors(torch, dev, 8, K))):
        tk, tp = match_top2_cuda(*a, mutual=True), match_top2_plain(*a, mutual=True)
        torch.cuda.synchronize()
        # Tolerance: none -- indices, column argmins and distances identical.
        for name, x, y in zip(("best index", "best", "second", "column argmin"), tk, tp):
            check(torch.equal(x.to(y.dtype), y), f"K1 D=256 ({what}): {name} differs")
        ep = (tk[0], tk[1], tk[2], a[1], tk[3], ratio)
        sk, sp = match_epilogue_cuda(*ep), match_epilogue_plain(*ep)
        vk, ik = top_k_rows(sk, M)
        vp, ip = top_k_plain(sp, M)
        ok_, op_ = match_compact_cuda(vk, ik, tk[0], M), match_compact_plain(vp, ip, tk[0], M)
        torch.cuda.synchronize()
        check(torch.equal(sk, sp), f"K1 D=256 epilogue ({what}): scores differ")
        for k in ("idx1", "idx2", "valid", "distance"):
            check(torch.equal(ok_[k], op_[k]), f"K1 D=256 compaction ({what}): {k} differs")
        log(f"K1 at D=256 ({what}, {tuple(a[0].shape)}): top-2, column argmin, epilogue and "
            f"the (B, {M}) match table identical to the twins; {int(ok_['valid'].sum())} "
            "matches kept")
    top2 = {"ms": time_ms(torch, lambda: match_top2_cuda(*args, mutual=True)),
            "plain_ms": time_ms(torch, lambda: match_top2_plain(*args, mutual=True), reps=3,
                                warmup=1)}
    tk = match_top2_cuda(*args, mutual=True)
    top2.update(bytes=nbytes(*args, *tk), ops=2 * B * K * K * D, max_abs_err=0.0)
    ep = (tk[0], tk[1], tk[2], args[1], tk[3], ratio)
    sk = match_epilogue_cuda(*ep)
    vk, ik = top_k_rows(sk, M)
    vp, ip = top_k_plain(sk, M)
    ok_ = match_compact_cuda(vk, ik, tk[0], M)
    epi = {"ms": time_ms(torch, lambda: match_epilogue_cuda(*ep))
           + time_ms(torch, lambda: match_compact_cuda(vk, ik, tk[0], M)),
           "plain_ms": time_ms(torch, lambda: match_epilogue_plain(*ep))
           + time_ms(torch, lambda: match_compact_plain(vp, ip, tk[0], M)),
           "bytes": nbytes(*tk, args[1], sk) + nbytes(vk, ik, *ok_.values()),
           "ops": 6 * B * K + 4 * B * M, "max_abs_err": 0.0}
    return top2, epi


def phase_guided_binary(torch, dev):
    """K1-g on the binary frontend's tables: K = 3,800 keypoints x M = 8,192
    pool entries (2 per track, the last 300 padding) of +-1/16 descriptors at
    D = 256; the pool and the seen keypoints are their track's pattern with
    3% / 12% of the signs flipped."""
    from sfm_tpu_torch.reconstruction.incremental import guided_match_cuda, guided_match_plain

    g = torch.Generator(device=dev).manual_seed(11)
    K, M, D = 3800, 8192, 256
    sign = lambda *s: torch.where(torch.rand(*s, generator=g, device=dev) < 0.5, -1.0, 1.0)
    flip = lambda x, p: torch.where(torch.rand(*x.shape, generator=g, device=dev) < p, -x, x)
    base = sign(M // 2, D)
    pool = (flip(base.repeat_interleave(2, 0), 0.03) / 16.0).contiguous()
    pool_valid = torch.arange(M, device=dev) < M - 300
    track = torch.where(pool_valid, torch.arange(M, device=dev) // 2, -1).to(torch.int32)
    src = torch.randint(0, M // 2 - 150, (K,), generator=g, device=dev)
    seen = torch.rand(K, generator=g, device=dev) < 0.6
    desc = torch.where(seen[:, None], flip(base[src], 0.12), sign(K, D)) / 16.0
    valid = torch.rand(K, generator=g, device=dev) > 0.05
    args = (desc.contiguous(), valid, pool, pool_valid, track, 0.9 ** 0.5)
    got, ref = guided_match_cuda(*args), guided_match_plain(*args)
    torch.cuda.synchronize()
    # Tolerance: none -- the dot products are exact, so tracks, distances and
    # the ratio test agree on every row (ties to the lowest index).
    for name, x, y in zip(("track", "distance", "ok"), got, ref):
        check(torch.equal(x, y.to(x.dtype)), f"K1-g D=256: {name} differs on "
              f"{int((x != y.to(x.dtype)).sum())} rows")
    log(f"K1-g guided_match at D=256: tracks, distances and ok identical on all {K} rows, "
        f"{int(ref[2].sum())} ok")
    return {"ms": time_ms(torch, lambda: guided_match_cuda(*args)),
            "plain_ms": time_ms(torch, lambda: guided_match_plain(*args)),
            "bytes": nbytes(*args[:5], *got), "ops": 2 * K * M * D, "max_abs_err": 0.0}


def phase_retrieval_binary(torch, dev):
    """K1-r at N = 150 x S = 256 x D = 256 on +-1/16 descriptors (the
    corridor strip of :func:`phase_retrieval_score`, binarized)."""
    from sfm_tpu_torch.matching.retrieval import score_chunk_cuda, score_chunk_plain

    N, S = 150, 256
    desc, valid = corridor_descriptors(torch, dev, N, S, D=256)
    desc = binary_descriptors(torch, desc)
    pairs = [(k, k + d) for d in range(1, 8) for k in range(N - d)] + [(0, 149), (3, 90)]
    pairs = torch.tensor(pairs, dtype=torch.int32, device=dev)
    args = (pairs, desc, valid, 0.75 ** 0.5)
    got, ref = score_chunk_cuda(*args), score_chunk_plain(*args)
    torch.cuda.synchronize()
    # Tolerance: none -- the dot products are exact, so the counts are equal.
    check(torch.equal(got, ref), f"K1-r D=256: counts differ on "
          f"{int((got != ref).sum())} of {pairs.shape[0]} pairs")
    log(f"K1-r retrieval_score at D=256: counts identical on all {pairs.shape[0]} pairs; "
        f"counts {int(ref.min())}..{int(ref.max())}")
    return {"ms": time_ms(torch, lambda: score_chunk_cuda(*args)),
            "plain_ms": time_ms(torch, lambda: score_chunk_plain(*args)),
            "bytes": nbytes(pairs, desc, valid, got), "ops": 2 * pairs.shape[0] * S * S * 256,
            "max_abs_err": 0.0}


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def ba_scene(torch, np, dev, n_cams=100, n_pts=20000, obs_per_cam=2000, seed=0):
    """bench.py's BA scene (100 cams / 20k pts / 200k obs): projections + 0.5 px
    noise, points perturbed by 1 cm so that LM has work; camera 0 at rvec = 0."""
    from sfm_tpu_torch.ba.residuals import residuals

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3, 3, (n_pts, 3)).astype(np.float32)
    pts[:, 2] += 10.0
    rvec = (0.02 * rng.normal(size=(n_cams, 3))).astype(np.float32)
    rvec[0] = 0.0
    tvec = np.concatenate([rng.uniform(-2, 2, (n_cams, 2)), np.zeros((n_cams, 1))],
                          1).astype(np.float32)
    obs_cam = np.repeat(np.arange(n_cams, dtype=np.int32), obs_per_cam)
    obs_point = rng.integers(0, n_pts, n_cams * obs_per_cam).astype(np.int32)
    T = lambda a: torch.as_tensor(a, device=dev)
    intr = T(np.array([1200.0, 1200.0, 512.0, 384.0], np.float32))
    xy = residuals(T(rvec), T(tvec), intr, T(pts), T(obs_cam), T(obs_point),
                   torch.zeros((len(obs_cam), 2), device=dev))
    xy = xy + T(rng.normal(scale=0.5, size=xy.shape).astype(np.float32))
    pts = pts + rng.normal(scale=0.01, size=pts.shape).astype(np.float32)
    return T(rvec), T(tvec), intr, T(pts), T(obs_cam), T(obs_point), xy.contiguous()


def phase_ba(torch, np, dev):
    """K8+K9 (linearize + cost) and K10 (Schur coupling) on the 100-camera scene."""
    from sfm_tpu_torch.ba.residuals import total_huber_cost_cuda, total_huber_cost_plain
    from sfm_tpu_torch.ba.schur import (
        coobs_pairs, damp_operator, linearize_cuda, linearize_plain, schur_matrix_cuda,
        schur_matrix_plain)

    rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy = ba_scene(torch, np, dev)
    C, P, O = rvec.shape[0], pts.shape[0], obs_cam.shape[0]
    perm, pvm = coobs_pairs(obs_point.cpu().numpy(), np.ones(O, bool))
    perm, pvm = torch.as_tensor(perm, device=dev), torch.as_tensor(pvm, device=dev)
    obs_w = torch.ones(O, device=dev)
    cam_free = torch.ones(C, device=dev)
    cam_free[0] = 0.0
    Hreg = torch.eye(4, device=dev)
    greg = torch.zeros(4, device=dev)
    args = (rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy, obs_w, cam_free,
            torch.ones(P, dtype=torch.bool, device=dev), perm, pvm, 2.0, True, Hreg, greg)
    lk = linearize_cuda(*args)
    lp = linearize_plain(*args)
    torch.cuda.synchronize()
    # Tolerance: the analytic Jacobians against torch.func.jacrev (an
    # independent derivation), 1e-4 of each tensor's largest entry; the
    # reductions (float atomics, another order) 1e-3.
    for name in lk._fields:
        x = getattr(lk, name)
        if x.is_floating_point():
            check(bool(torch.isfinite(x).all()), f"K8: {name} not finite")
    errs = {f: _rel(getattr(lk, f), getattr(lp, f))
            for f in ("Jc", "Jk", "Jp", "rw", "V", "g_p", "U", "g_c", "Uk", "g_k")}
    for f, e in errs.items():
        check(e <= (1e-4 if f in ("Jc", "Jk", "Jp", "rw") else 1e-3), f"K8/K9: {f} rel err {e}")
    cargs = (rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy, obs_w, 2.0)
    ck, cp = total_huber_cost_cuda(*cargs), total_huber_cost_plain(*cargs)
    cost_err = abs(float(ck) - float(cp)) / float(cp)
    check(cost_err <= 1e-5, f"K8 ba_cost: rel err {cost_err}")
    log("K8+K9 ba_linearize: rel err " + ", ".join(f"{f} {e:.2g}" for f, e in errs.items())
        + f"; ba_cost rel err {cost_err:.2g} ({O} obs, {C} cams, {P} points)")
    ms = time_ms(torch, lambda: linearize_cuda(*args))
    plain_ms = time_ms(torch, lambda: linearize_plain(*args))
    lin_bytes = nbytes(*(a for a in args if isinstance(a, torch.Tensor))) + sum(
        nbytes(getattr(lk, f)) for f in ("Jc", "Jk", "Jp", "rw", "V", "U", "Uk", "g_c", "g_k",
                                         "g_p"))
    cost_ms = time_ms(torch, lambda: total_huber_cost_cuda(*cargs))
    cost_plain_ms = time_ms(torch, lambda: total_huber_cost_plain(*cargs))
    log(f"  ba_cost: {cost_ms:.4f} ms (plain torch {cost_plain_ms:.4f} ms)")
    # ~400 FLOP per observation (projection, analytic Jacobians, whitening, sums).
    k89 = result(max(errs.values()), ms, plain_ms, lin_bytes, 400 * O)

    op, rhs_c, rhs_k = damp_operator(lk, 1e-3, perm, pvm)
    Sk = schur_matrix_cuda(lk, op, perm, pvm)
    Sp = schur_matrix_plain(lk, op, perm, pvm)
    torch.cuda.synchronize()
    rhs = torch.cat([rhs_c.reshape(-1), rhs_k])[:, None]
    solve = lambda S: torch.cholesky_solve(rhs, torch.linalg.cholesky(S))[:, 0]
    s_err = _rel(Sk, Sp)
    x_err = _rel(solve(Sk), solve(Sp))
    # Tolerance: S within 1e-4 of its largest entry (float atomics sum the
    # coupling in another order); the solved step within 1e-2, since S's
    # condition number (100 cameras + the intrinsics column) multiplies that
    # difference (on an H100, a 5e-6 difference in S moved the step by 1.1e-3).
    check(bool(torch.isfinite(Sk).all()), "K10: S not finite")
    check(s_err <= 1e-4 and x_err <= 1e-2, f"K10: S rel err {s_err}, step rel err {x_err}")
    log(f"K10 schur_coupling: S ({Sk.shape[0]}^2) rel err {s_err:.2g}, solved step rel err "
        f"{x_err:.2g} (grouping {tuple(perm.shape)})")
    ms = time_ms(torch, lambda: schur_matrix_cuda(lk, op, perm, pvm))
    plain_ms = time_ms(torch, lambda: schur_matrix_plain(lk, op, perm, pvm))
    # ~200 FLOP per pair of one point's observation slots (this scene's data).
    pairs = int((pvm.sum(1).long() ** 2).sum())
    coupling = result(s_err, ms, plain_ms,
                      nbytes(lk.Jc, lk.Jk, lk.Jp, lk.obs_cam, lk.obs_point, op.Vinv, perm, pvm, Sk),
                      200 * pairs)
    return k89, coupling


def track_scene(torch, np, dev, T, V=36, C=36, seed=0):
    """T synthetic track rows over C ring cameras: 2-12 views each, 0.5 px
    noise, 10% outlier observations, 4 cameras unregistered."""
    from sfm_tpu_torch.geometry.rotations import rotation_to_rvec

    rng = np.random.default_rng(seed)
    Rs, ts = [], []
    for k in range(C):
        a = 2 * math.pi * k / C
        c = np.array([6 * math.sin(a), 0.3 * (k % 3), -6 * math.cos(a)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        Rs.append(R)
        ts.append(-R @ c)
    Rs, ts = np.stack(Rs), np.stack(ts)
    K = np.array([[1228.0, 0, 512.0], [0, 1228.0, 384.0], [0, 0, 1]])
    X = rng.uniform(-1, 1, (T, 3))
    view_img = np.full((T, V), -1, np.int32)
    view_xy = np.zeros((T, V, 2), np.float32)
    for t in range(T):
        L = rng.integers(2, 13)
        cams = np.sort(rng.choice(C, L, replace=False))
        x = (X[t] @ Rs[cams].transpose(0, 2, 1) + ts[cams]) @ K.T
        xy = x[:, :2] / x[:, 2:] + rng.normal(0, 0.5, (L, 2))
        out = rng.random(L) < 0.1
        xy[out] = rng.uniform([0, 0], [1024, 768], (out.sum(), 2))
        view_img[t, :L], view_xy[t, :L] = cams, xy
    registered = np.ones(C, bool)
    registered[rng.choice(C, 4, replace=False)] = False
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    rvec = rotation_to_rvec(f32(Rs))
    return (torch.as_tensor(view_img, device=dev), f32(view_xy),
            torch.as_tensor(registered, device=dev), rvec, f32(ts), f32(K))


def phase_triangulate(torch, np, dev):
    """K7 on a 2048-row bucket (seed pairs off) and a 1024-row bucket (seed
    pairs on, 8 seed views), then reproj_stats on the 2048-row table."""
    from sfm_tpu_torch.reconstruction.incremental import (
        reproj_stats_cuda, reproj_stats_plain, triangulate_tracks_cuda,
        triangulate_tracks_plain)

    worst, ms, plain_ms, moved, ops = 0.0, 0.0, 0.0, 0, 0
    for T, seed_on in ((2048, False), (1024, True)):
        view_img, view_xy, registered, rvec, tvec, K = track_scene(torch, np, dev, T, seed=T)
        use = (view_img >= 0) & registered[view_img.long().clamp(min=0)]
        active = torch.ones(T, dtype=torch.bool, device=dev)
        args = (view_img, view_xy, use, active, rvec, tvec, K, 4.0, 0.0, 1, seed_on, 8)
        pk, ok_k = triangulate_tracks_cuda(*args)
        pp, ok_p = triangulate_tracks_plain(*args)
        torch.cuda.synchronize()
        # Tolerance: ok equal in >= 99.5% of rows (another summation order
        # moves rows that sit on a gate); points of rows ok in both within 1e-3
        # relative.
        both = ok_k & ok_p
        mism = int((ok_k != ok_p).sum())
        err = float(((pk - pp).norm(dim=-1) / pp.norm(dim=-1).clamp(min=1.0))[both].max())
        check(mism <= 0.005 * T, f"K7: ok differs in {mism} of {T} rows")
        check(err <= 1e-3, f"K7: point rel err {err}")
        log(f"K7 triangulate_tracks T={T} seed_pairs={seed_on}: {int(ok_p.sum())} ok, "
            f"{mism} rows differ in ok, point rel err {err:.2g}")
        worst = max(worst, err)
        ms += time_ms(torch, lambda: triangulate_tracks_cuda(*args))
        plain_ms += time_ms(torch, lambda: triangulate_tracks_plain(*args))
        # Per row of L used views: L DLT rows (~100 FLOP each with their
        # reprojection), 8 4x4 inverse-iteration steps (~300); with seed pairs,
        # ~200 FLOP per pair of its first 8 views.
        L = use.sum(1).long()
        moved += nbytes(view_img, view_xy, use, active, rvec, tvec, pk, ok_k)
        ops += int((100 * L + 300).sum()) + (int((200 * L.clamp(max=8) ** 2).sum()) if seed_on
                                             else 0)
        if T == 2048:
            rargs = (view_img, view_xy, view_img >= 0, rvec, tvec, registered, K, pp, ok_p)
            ek, uk = reproj_stats_cuda(*rargs)
            ep, up = reproj_stats_plain(*rargs)
            torch.cuda.synchronize()
            e_err = float((ek - ep).abs().max())
            check(torch.equal(uk, up) and e_err <= 1e-3, f"K7 reproj_stats: err {e_err}")
            log(f"  reproj_stats: use equal, max abs err {e_err:.3g} px; "
                f"{time_ms(torch, lambda: reproj_stats_cuda(*rargs)):.4f} ms (plain torch "
                f"{time_ms(torch, lambda: reproj_stats_plain(*rargs)):.4f} ms)")
    return result(worst, ms, plain_ms, moved, ops)


def phase_pnp(torch, np, dev):
    """K6 at B = 8 candidates x 2048 P3P samples (8192 hypotheses) x N = 2048."""
    from sfm_tpu_torch.estimators.pnp import (
        p3p_candidates, p3p_solve_cuda, pnp_score_select_cuda, pnp_score_select_plain)
    from sfm_tpu_torch.estimators.ransac import ransac_sample_indices
    from sfm_tpu_torch.geometry.projection import project
    from sfm_tpu_torch.geometry.rotations import rodrigues

    B, N, iters, thr = 8, 2048, 2048, 8.0
    rng = np.random.default_rng(3)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    K = f32([[1228.0, 0, 512.0], [0, 1228.0, 384.0], [0, 0, 1]])
    R = rodrigues(f32(rng.normal(0, 0.3, (B, 3))))
    t = f32(rng.uniform([-1, -1, 4], [1, 1, 6], (B, 3)))
    p3 = f32(rng.uniform(-2, 2, (B, N, 3)))
    p2, _ = project(p3, R[:, None], t[:, None], K)
    p2 = p2 + f32(rng.normal(0, 0.5, (B, N, 2)))
    out = torch.as_tensor(rng.random((B, N)) < 0.3, device=dev)
    p2 = torch.where(out[..., None], f32(rng.uniform([0, 0], [1024, 768], (B, N, 2))), p2)
    valid = torch.as_tensor(np.arange(N)[None] < rng.integers(300, N + 1, (B, 1)), device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    idx = ransac_sample_indices(valid, iters, 3, g, prefix=True).reshape(B, -1)
    pn = (torch.cat([p2, torch.ones_like(p2[..., :1])], -1) @ torch.linalg.inv(K).mT)[..., :2]
    take = lambda x: torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1])).reshape(
        B, iters, 3, x.shape[-1]).contiguous()
    s3, s2n = take(p3), take(pn)
    Rk, tk, okk = p3p_solve_cuda(s3, s2n)
    Rp, tp, okp = p3p_candidates(s3, s2n)
    torch.cuda.synchronize()
    # P3P in f32: the Durand-Kerner roots may come out in another order and
    # an ill-conditioned sample's poses move with rounding, so the candidate
    # slots are not compared one to one. Held: the count of valid candidates
    # within 1% of the twin's; each side's valid candidates interpolate their
    # own sample (max reprojection error of the 3 points <= 1 px) as often as
    # the twin's do, within 1 point of percentage; in >= 90% of the samples,
    # every valid pose of either side has one on the other within 1e-2; and
    # below, the selected pose and its inlier count.
    def interp_ok(Rc, tc, okc):
        pr, dep = project(s3[:, :, None], Rc[:, :, :, None], tc[:, :, :, None], K)
        px = take(p2)[:, :, None]                                     # (B, S, 1, 3, 2)
        e = ((pr - px).norm(dim=-1).amax(-1))                         # (B, S, 4)
        return float((e[okc] <= 1.0).float().mean()), int(okc.sum())

    (fk, nk_ok), (fp, np_ok) = interp_ok(Rk, tk, okk), interp_ok(Rp, tp, okp)
    check(fk >= fp - 0.01, f"K6 p3p_solve: {fk:.4f} of kernel candidates interpolate their "
          f"sample, twin {fp:.4f}")
    d = ((Rk[:, :, :, None] - Rp[:, :, None]).flatten(-2).norm(dim=-1)
         + (tk[:, :, :, None] - tp[:, :, None]).norm(dim=-1)
         / tp[:, :, None].norm(dim=-1).clamp(min=1.0))              # (B, S, 4k, 4p)
    big = torch.full_like(d, float("inf"))
    dk = torch.where(okp[:, :, None], d, big).amin(-1)
    dp = torch.where(okk[..., None], d, big).amin(-2)
    agree = {tol: float((torch.where(okk, dk <= tol, True).all(-1)
                         & torch.where(okp, dp <= tol, True).all(-1)).float().mean())
             for tol in (1e-3, 1e-2)}
    check(abs(nk_ok - np_ok) <= 0.01 * np_ok,
          f"K6 p3p_solve: {nk_ok} valid candidates, twin {np_ok}")
    check(agree[1e-2] >= 0.9, f"K6 p3p_solve: candidate sets agree within 1e-2 in "
          f"{agree[1e-2]:.4f} of the samples")
    # Tolerance, scoring (on the twin's hypotheses): the same winner, or one
    # whose score is within 1e-3 of the plain winner's (a tie up to the error
    # sum's order).
    H = iters * 4
    hyp = (Rp.reshape(B, H, 3, 3), tp.reshape(B, H, 3), okp.reshape(B, H))
    sargs = (*hyp, p3, p2, valid, K, thr)
    bk, ck = pnp_score_select_cuda(*sargs)
    bp, cp = pnp_score_select_plain(*sargs)
    pick = lambda h: (hyp[0][torch.arange(B), h], hyp[1][torch.arange(B), h])

    def score(h):
        Rh, th = pick(h)
        proj, depth = project(p3, Rh[:, None], th[:, None], K)
        e = (proj - p2).norm(dim=-1)
        inl = (e < thr) & (depth > 0) & valid & hyp[2][torch.arange(B), h][:, None]
        n = inl.sum(-1)
        return n.float() - torch.where(inl, e, 0.0).sum(-1) / n.clamp(min=1) / thr, n

    (sk, nk), (sp, _) = score(bk), score(bp)
    gap = float((sp - sk).abs().max())
    check(gap <= 1e-3 and torch.equal(nk, ck), f"K6 pnp_score_select: score gap {gap}")
    # End to end, kernel P3P + kernel scoring against twin + twin: the selected
    # rotations within 1e-2 rad of each other (both come from some all-inlier
    # sample under 0.5 px noise) and inlier counts within 1%.
    bk2, ck2 = pnp_score_select_cuda(Rk.reshape(B, H, 3, 3), tk.reshape(B, H, 3),
                                     okk.reshape(B, H), p3, p2, valid, K, thr)
    Rsel_k = Rk.reshape(B, H, 3, 3)[torch.arange(B), bk2]
    Rsel_p = hyp[0][torch.arange(B), bp]
    cos = ((Rsel_k * Rsel_p).sum((-2, -1)) - 1.0) / 2.0
    ang = float(torch.arccos(cos.clamp(-1.0, 1.0)).max())
    dn = float(((ck2 - cp).abs().float() / cp.float().clamp(min=1)).max())
    check(ang <= 1e-2 and dn <= 0.01, f"K6 end to end: rotation {ang} rad, count {dn}")
    log(f"K6 pnp_ransac: p3p valid candidates kernel {nk_ok} / twin {np_ok}, interpolating "
        f"their sample {fk:.4%} / {fp:.4%}; candidate sets agree in {agree[1e-3]:.2%} (1e-3) / "
        f"{agree[1e-2]:.2%} (1e-2) of {B * iters} samples; scoring: same winner "
        f"in {int((bk == bp).sum())}/{B} candidates, max score gap {gap:.3g}; end to end: "
        f"selected rotations within {ang:.3g} rad, inlier counts within {100 * dn:.3g}%")
    ms = time_ms(torch, lambda: (p3p_solve_cuda(s3, s2n), pnp_score_select_cuda(*sargs)))
    plain_ms = time_ms(torch, lambda: (p3p_candidates(s3, s2n), pnp_score_select_plain(*sargs)))
    # P3P: ~6 kFLOP a sample (30 Durand-Kerner steps on 4 roots, the poses);
    # scoring: ~25 FLOP per (hypothesis, correspondence).
    return result(gap, ms, plain_ms,
                  nbytes(s3, s2n, Rk, tk, okk, p3, p2, valid) + 16 * B,
                  6000 * B * iters + 25 * B * H * N)


def corridor_descriptors(torch, dev, N: int, S: int, D: int = 128, step: int = 40,
                         seed: int = 5):
    """Unit descriptors of N images along a strip of points: image k sees
    points step*k .. step*k + S - 1 in a shuffled order, with noise; 5% of
    the keypoints invalid."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pts = _unit(torch, torch.randn(step * N + S, D, generator=g, device=dev))
    ids = torch.arange(S, device=dev)[None] + step * torch.arange(N, device=dev)[:, None]
    ids = torch.gather(ids, 1, torch.argsort(torch.rand(N, S, generator=g, device=dev), dim=1))
    desc = _unit(torch, pts[ids] + 0.03 * torch.randn(N, S, D, generator=g, device=dev))
    return desc.contiguous(), torch.rand(N, S, generator=g, device=dev) > 0.05


def phase_retrieval_score(torch, np, dev):
    """K1-r at N = 150 images x S = 256 x D = 128 over one 1,024-pair chunk:
    every pair (k, k + d), d = 1..7 (neighbours that share 216..0 points),
    and two far pairs."""
    from sfm_tpu_torch.matching.retrieval import score_chunk_cuda, score_chunk_plain

    N, S = 150, 256
    desc, valid = corridor_descriptors(torch, dev, N, S)
    pairs = [(k, k + d) for d in range(1, 8) for k in range(N - d)] + [(0, 149), (3, 90)]
    pairs = torch.tensor(pairs, dtype=torch.int32, device=dev)
    check(pairs.shape[0] == 1024, f"{pairs.shape[0]} pairs")
    args = (pairs, desc, valid, 0.75)
    got, ref = score_chunk_cuda(*args), score_chunk_plain(*args)
    torch.cuda.synchronize()
    # Tolerance: counts equal on >= 99% of pairs and within 2 on all (the dot
    # products are summed in another order, so a near-tie can flip a match).
    diff = (got - ref).abs()
    frac = float((diff == 0).float().mean())
    check(frac >= 0.99 and int(diff.max()) <= 2,
          f"K1-r: counts equal on {frac:.4f} of pairs, max difference {int(diff.max())}")
    log(f"K1-r retrieval_score: counts equal on {frac:.2%} of {pairs.shape[0]} pairs, max "
        f"difference {int(diff.max())}; counts {int(ref.min())}..{int(ref.max())}")
    ms = time_ms(torch, lambda: score_chunk_cuda(*args))
    plain_ms = time_ms(torch, lambda: score_chunk_plain(*args))
    # 2 S^2 D FMA-FLOP per pair; the descriptor table read once.
    return result(float(diff.max()), ms, plain_ms, nbytes(pairs, desc, valid, got),
                  2 * pairs.shape[0] * S * S * desc.shape[-1])


def phase_guided_match(torch, dev):
    """K1-g at K = 2048 keypoints x M = 8192 pool entries (2 per track, the
    last 300 slots padding) x D = 128."""
    from sfm_tpu_torch.reconstruction.incremental import guided_match_cuda, guided_match_plain

    g = torch.Generator(device=dev).manual_seed(6)
    K, M, D = 2048, 8192, 128
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
    base = _unit(torch, rnd(M // 2, D))
    pool = _unit(torch, base.repeat_interleave(2, 0) + 0.05 * rnd(M, D)).contiguous()
    pool_valid = torch.arange(M, device=dev) < M - 300
    track = torch.where(pool_valid, torch.arange(M, device=dev) // 2, -1).to(torch.int32)
    src = torch.randint(0, M // 2 - 150, (K,), generator=g, device=dev)
    seen = torch.rand(K, generator=g, device=dev) < 0.6
    desc = _unit(torch, torch.where(seen[:, None], base[src] + 0.12 * rnd(K, D), rnd(K, D)))
    valid = torch.rand(K, generator=g, device=dev) > 0.05
    args = (desc.contiguous(), valid, pool, pool_valid, track, 0.9)
    tk, dk, okk = guided_match_cuda(*args)
    tp, dp, okp = guided_match_plain(*args)
    torch.cuda.synchronize()
    # Tolerance: track and ok equal on >= 99.9% of rows (another summation
    # order can flip a near-tie); distances within 1e-5.
    agree = float(((tk == tp) & (okk == okp)).float().mean())
    fin = torch.isfinite(dp)
    check(torch.equal(torch.isfinite(dk), fin), "K1-g: finite pattern differs")
    err = float((dk - dp)[fin].abs().max())
    check(agree >= 0.999 and err <= 1e-5, f"K1-g: {agree:.5f} of rows agree, d_best err {err}")
    log(f"K1-g guided_match: track and ok equal on {agree:.3%} of {K} rows, {int(okp.sum())} "
        f"ok, d_best max_abs_err {err:.3g}")
    ms = time_ms(torch, lambda: guided_match_cuda(*args))
    plain_ms = time_ms(torch, lambda: guided_match_plain(*args))
    return result(err, ms, plain_ms, nbytes(*args[:5], tk, dk, okk), 2 * K * M * D)


def phase_pyramid(torch, dev, images, cfg):
    """K3 on one detection sub-batch of rendered images, the -1 octave included."""
    from sfm_tpu_torch.features.detect import dog_extrema_scores_cuda
    from sfm_tpu_torch.features.pyramid import build_pyramid_cuda, build_pyramid_plain

    fc = cfg.features
    kw = dict(num_octaves=fc.num_octaves, scales_per_octave=fc.scales_per_octave,
              sigma0=fc.sigma0, assumed_blur=fc.assumed_blur, upsample=fc.upsample_first_octave)
    gk, dk = build_pyramid_cuda(images, **kw)
    gp, dp = build_pyramid_plain(images, **kw)
    torch.cuda.synchronize()
    check(tuple(dk[0].shape[-2:]) == (1536, 2048), f"octave -1 is {tuple(dk[0].shape)}")
    # Tolerance: bit-identical (the kernel rounds every product and sum as
    # the twin does); otherwise the DoG difference is printed and K4's
    # extremum sets must be equal.
    exact = all(torch.equal(a, b) for a, b in zip(gk + dk, gp + dp))
    err = max(float((a - b).abs().max()) for a, b in zip(dk, dp))
    if not exact:
        log(f"K3 pyramid: not bit-identical, max |dDoG| {err:.3g}")
        ct, et = fc.contrast_threshold, fc.edge_threshold
        for a, b in zip(dk, dp):
            check(torch.equal(dog_extrema_scores_cuda(a, ct, et)["score"] > 0,
                              dog_extrema_scores_cuda(b, ct, et)["score"] > 0),
                  f"K3: extremum sets differ on octave {tuple(a.shape)}")
    log(f"K3 pyramid: {'bit-identical' if exact else 'equal extremum sets'} on "
        f"{images.shape[0]} images x {len(dk)} octaves")
    ms = time_ms(torch, lambda: build_pyramid_cuda(images, **kw))
    plain_ms = time_ms(torch, lambda: build_pyramid_plain(images, **kw), reps=3, warmup=1)
    # The images in, every Gaussian and DoG layer out; ~76 FLOP per Gaussian
    # pixel (two separable passes of ~19 taps, a multiply and an add each).
    return result(err, ms, plain_ms, nbytes(images, *gk, *dk),
                  76 * sum(g.numel() for g in gk))


def phase_seed_score(torch, np, dev):
    """K14 on 256 two-view pairs x 256 matches."""
    from sfm_tpu_torch.reconstruction.seed import _score_pairs_cuda, _score_pairs_plain

    P, N = 256, 256
    p1, p2, valid, F = (torch.as_tensor(a, device=dev) for a in two_view_batch(np, P, N, seed=7))
    K = torch.tensor([[1228.0, 0, 512.0], [0, 1228.0, 384.0], [0, 0, 1.0]], device=dev)
    args = (F, p1, p2, valid, K)
    sk, Rk, tk, park, errk = _score_pairs_cuda(*args)
    sp, Rp, tp, parp, errp = _score_pairs_plain(*args)
    torch.cuda.synchronize()
    # Tolerance: the same argmax pair; scores within 1e-3 relative (of
    # max(|score|, 1)); R and t within 1e-4 (another summation order).
    s_err = float(((sk - sp).abs() / sp.abs().clamp(min=1.0)).max())
    r_err = max(float((Rk - Rp).abs().max()), float((tk - tp).abs().max()))
    check(int(sk.argmax()) == int(sp.argmax()), "K14: another best pair")
    check(s_err <= 1e-3 and r_err <= 1e-4, f"K14: score rel err {s_err}, R/t err {r_err}")
    log(f"K14 seed_score: same best pair ({int(sp.argmax())}), score rel err {s_err:.3g}, "
        f"R/t max_abs_err {r_err:.3g}, median parallax {float(parp.median()):.3f} deg")
    ms = time_ms(torch, lambda: _score_pairs_cuda(*args))
    plain_ms = time_ms(torch, lambda: _score_pairs_plain(*args))
    # ~2 kFLOP per match (three 4x4 DLT solves, the cheirality tests).
    return result(r_err, ms, plain_ms, nbytes(*args, sk, Rk, tk, park, errk), 2000 * P * N)


def pnp_scene(torch, np, dev, B: int, N: int, seed: int):
    """B registration candidates of N 2D-3D correspondences: random poses,
    0.5 px noise, 30% outliers, a valid prefix of 300..N rows."""
    from sfm_tpu_torch.geometry.projection import project
    from sfm_tpu_torch.geometry.rotations import rodrigues

    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    K = f32([[1228.0, 0, 512.0], [0, 1228.0, 384.0], [0, 0, 1]])
    R = rodrigues(f32(rng.normal(0, 0.3, (B, 3))))
    t = f32(rng.uniform([-1, -1, 4], [1, 1, 6], (B, 3)))
    p3 = f32(rng.uniform(-2, 2, (B, N, 3)))
    p2, _ = project(p3, R[:, None], t[:, None], K)
    p2 = p2 + f32(rng.normal(0, 0.5, (B, N, 2)))
    out = torch.as_tensor(rng.random((B, N)) < 0.3, device=dev)
    p2 = torch.where(out[..., None], f32(rng.uniform([0, 0], [1024, 768], (B, N, 2))), p2)
    valid = torch.as_tensor(np.arange(N)[None] < rng.integers(300, N + 1, (B, 1)), device=dev)
    return p3, p2.contiguous(), valid, K, R, t, rng


def phase_pnp_refine(torch, np, dev):
    """K6's pnp_refine at B = 8 candidates x N = 2,048 (registration) and
    B = 1 x N = 8,192 (the guided rescue), from the true pose rotated by
    ~0.6 deg and moved by ~1%; one registration candidate gated off."""
    from sfm_tpu_torch.estimators.pnp import pnp_refine_cuda, pnp_refine_plain
    from sfm_tpu_torch.geometry.rotations import rodrigues

    worst, ms, plain_ms, moved, ops = 0.0, 0.0, 0.0, 0, 0
    for B, N in ((8, 2048), (1, 8192)):
        p3, p2, valid, K, R, t, rng = pnp_scene(torch, np, dev, B, N, seed=10 + B)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        R0 = (rodrigues(f32(rng.normal(0, 0.006, (B, 3)))) @ R).contiguous()
        t0 = (t * f32(1 + rng.normal(0, 0.01, (B, 3)))).contiguous()
        ok0 = torch.ones(B, dtype=torch.bool, device=dev)
        ok0[B // 2] = B == 1
        args = (R0, t0, ok0, p3, p2, valid, K, 8.0, torch.full((B,), 15, device=dev), 10)
        k, pl = pnp_refine_cuda(*args), pnp_refine_plain(*args)
        torch.cuda.synchronize()
        # Tolerance: R within 1e-4 rad and t within 1e-4 |t| (Cholesky in the
        # kernel, LU in the twin, on the same SPD system); inlier sets equal on
        # >= 99.9% of rows; ok equal.
        M = (k["R"].double().mT @ pl["R"].double())
        vee = torch.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0],
                           M[:, 1, 0] - M[:, 0, 1]], -1)
        ang = float(torch.asin((vee.norm(dim=-1) / 2).clamp(max=1.0)).max())
        t_err = float(((k["t"] - pl["t"]).norm(dim=-1) / pl["t"].norm(dim=-1).clamp(min=1e-6))
                      .max())
        inl_eq = float((k["inliers"] == pl["inliers"]).float().mean())
        check(ang <= 1e-4 and t_err <= 1e-4 and inl_eq >= 0.999,
              f"K6 pnp_refine B={B}: R {ang} rad, t {t_err} rel, inliers equal {inl_eq}")
        check(torch.equal(k["ok"], pl["ok"]) and bool(k["ok"].any()),
              f"K6 pnp_refine B={B}: ok {k['ok'].tolist()} vs {pl['ok'].tolist()}")
        log(f"K6 pnp_refine B={B} N={N}: R within {ang:.3g} rad, t within {t_err:.3g} |t|, "
            f"inliers equal on {inl_eq:.4%} of rows, ok {k['ok'].tolist()}")
        worst = max(worst, float((k["R"] - pl["R"]).abs().max()),
                    float((k["t"] - pl["t"]).abs().max()))
        ms += time_ms(torch, lambda: pnp_refine_cuda(*args))
        plain_ms += time_ms(torch, lambda: pnp_refine_plain(*args))
        # 20 steps of ~250 FLOP per weighted row (6 tangents, 27 sums), three
        # passes of ~30 FLOP per row for the weights and the final errors.
        moved += nbytes(*args[:6]) + sum(nbytes(v) for v in k.values())
        ops += 20 * 250 * int(k["num_inliers"].sum()) + 3 * 30 * B * N
    return result(worst, ms, plain_ms, moved, ops)


def phase_schur_damp(torch, np, dev):
    """K10's schur_damp and schur_back_substitute on the 100-camera /
    200k-observation scene and a 150-camera / 300k one; then one run_ba on a
    40-camera scene on the card, against the plain twins on the host."""
    from sfm_tpu_torch.ba.lm import run_ba
    from sfm_tpu_torch.ba.problem import BAProblem
    from sfm_tpu_torch.ba.schur import (
        coobs_pairs, dense_schur_direct, linearize_cuda, schur_back_substitute_cuda,
        schur_back_substitute_plain, schur_damp_cuda, schur_damp_plain)
    from sfm_tpu_torch.config import BAConfig

    worst, ms, plain_ms, lib_ms, moved, ops = 0.0, 0.0, 0.0, 0.0, 0, 0
    lam = 1e-3
    for n_cams, n_pts in ((100, 20000), (150, 30000)):
        rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy = ba_scene(
            torch, np, dev, n_cams=n_cams, n_pts=n_pts, seed=n_cams)
        C, P, O = rvec.shape[0], pts.shape[0], obs_cam.shape[0]
        perm, pvm = coobs_pairs(obs_point.cpu().numpy(), np.ones(O, bool))
        perm, pvm = torch.as_tensor(perm, device=dev), torch.as_tensor(pvm, device=dev)
        cam_free = torch.ones(C, device=dev)
        cam_free[0] = 0.0
        pv = torch.ones(P, dtype=torch.bool, device=dev)
        pv[::97] = False
        lin = linearize_cuda(rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy,
                             torch.ones(O, device=dev), cam_free, pv, perm, pvm, 2.0, True,
                             torch.eye(4, device=dev), torch.zeros(4, device=dev))
        (opk, rck, rkk), (opp, rcp, rkp) = (schur_damp_cuda(lin, lam, perm, pvm),
                                            schur_damp_plain(lin, lam))
        xc, xk = dense_schur_direct(opk, lin, rck, rkk, perm, pvm)
        dpk = schur_back_substitute_cuda(lin, opk, xc, xk, perm, pvm)
        dpp = schur_back_substitute_plain(lin, opk, xc, xk)
        torch.cuda.synchronize()
        # Tolerance: rhs_c / rhs_k within 1e-3 relative (camera sums by float
        # atomics, another order); Vinv within 1e-4 of each block's largest
        # entry where the damped block's condition number is <= 100 (the
        # adjugate and LU round differently); on the other valid blocks the
        # residual |Vd Vinv - I| no larger than max(1e-3, 10x the twin's LU
        # inverse's own); the diagonals exactly; dp within 1e-3 relative.
        diag = torch.diagonal(lin.V, dim1=-2, dim2=-1)
        Vd = lin.V + (lam * diag + 1e-10)[..., None] * torch.eye(3, device=dev)
        cond = torch.linalg.cond(Vd.double())
        well = pv & (cond <= 100)
        blk_err = ((opk.Vinv - opp.Vinv).flatten(1).abs().amax(1)
                   / opp.Vinv.flatten(1).abs().amax(1).clamp(min=1e-30))
        v_err = float(blk_err[well].max())
        resid = lambda Vi: (Vd @ Vi - torch.eye(3, device=dev)).flatten(1).abs().amax(1)
        ill = pv & ~well
        ident = float(resid(opk.Vinv)[ill].max()) if bool(ill.any()) else 0.0
        ident_ok = bool((resid(opk.Vinv) <= torch.clamp(10 * resid(opp.Vinv), min=1e-3))[ill]
                        .all())
        errs = {"rhs_c": _rel(rck, rcp), "rhs_k": _rel(rkk, rkp), "dp": _rel(dpk, dpp)}
        check(max(errs.values()) <= 1e-3 and v_err <= 1e-4 and ident_ok,
              f"K10 schur_damp C={C}: {errs}, Vinv {v_err}, Vd Vinv - I {ident}")
        check(torch.equal(opk.lam_diag_c, opp.lam_diag_c)
              and bool((opk.Vinv[~pv] == 0).all()), f"K10 schur_damp C={C}: diagonals")
        log(f"K10 schur_damp / back_substitute C={C} O={O}: rel err " + ", ".join(
            f"{k} {v:.2g}" for k, v in errs.items()) + f"; Vinv {v_err:.2g} on "
            f"{int(well.sum())} well-conditioned blocks, |Vd Vinv - I| {ident:.2g} on "
            f"{int((pv & ~well).sum())} others")
        worst = max(worst, *errs.values(), v_err)
        dk = time_ms(torch, lambda: schur_damp_cuda(lin, lam, perm, pvm))
        bk = time_ms(torch, lambda: schur_back_substitute_cuda(lin, opk, xc, xk, perm, pvm))
        dpl = time_ms(torch, lambda: schur_damp_plain(lin, lam))
        bpl = time_ms(torch, lambda: schur_back_substitute_plain(lin, opk, xc, xk))
        inv_ms = time_ms(torch, lambda: torch.linalg.inv(Vd))
        log(f"  C={C}: schur_damp {dk:.4f} ms (plain torch {dpl:.4f} ms, torch.linalg.inv of "
            f"the damped blocks alone {inv_ms:.4f} ms); schur_back_substitute {bk:.4f} ms "
            f"(plain torch {bpl:.4f} ms)")
        ms, plain_ms, lib_ms = ms + dk + bk, plain_ms + dpl + bpl, lib_ms + inv_ms
        # Damping: ~60 FLOP a point (scaling, adjugate), ~60 an observation
        # (h_p, y_o, Jc^T y, Jk^T y). Back-substitution: ~64 an observation, 18 a point.
        sys_in = nbytes(lin.Jc, lin.Jk, lin.Jp, lin.obs_cam, lin.obs_point, perm, pvm, lin.g_p)
        moved += (sys_in + nbytes(lin.V, lin.point_valid, lin.U, lin.Uk, lin.g_c, lin.g_k,
                                  opk.Vinv, opk.lam_diag_c, opk.lam_diag_k, rck, rkk)
                  + sys_in + nbytes(opk.Vinv, xc, xk, dpk))
        ops += 60 * P + 60 * O + 64 * O + 18 * P

    # One LM run on the card against the twins on the host: the final costs
    # within 1e-3 relative (atomics may flip an accept at convergence, so the
    # iteration counts are not compared).
    rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy = ba_scene(
        torch, np, dev, n_cams=40, n_pts=8000, seed=40)
    C, P, O = rvec.shape[0], pts.shape[0], obs_cam.shape[0]
    ones = lambda n: torch.ones(n, dtype=torch.bool, device=dev)
    fixed = torch.zeros(C, dtype=torch.bool, device=dev)
    fixed[0] = True
    prob = BAProblem(rvec, tvec, ones(C), fixed, intr, pts, ones(P), obs_cam, obs_point, obs_xy,
                     ones(O))
    cfg = BAConfig(max_iterations=10)
    t0 = time.perf_counter()
    _, st_k = run_ba(prob, cfg)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, st_p = run_ba(BAProblem(*(x.cpu() for x in prob)), cfg)
    t_host = time.perf_counter() - t0
    cost_err = abs(st_k["final_cost"] - st_p["final_cost"]) / st_p["final_cost"]
    check(cost_err <= 1e-3 and st_k["final_cost"] < 0.5 * st_k["initial_cost"],
          f"K10 run_ba: final cost {st_k['final_cost']} vs twin {st_p['final_cost']}")
    log(f"K10 run_ba C={C} O={O}: final cost {st_k['final_cost']:.6g} (card, {t_card:.2f} s) vs "
        f"{st_p['final_cost']:.6g} (twins on the host, {t_host:.2f} s), rel {cost_err:.2g}; "
        f"{st_k['iterations']} / {st_p['iterations']} iterations")
    return result(worst, ms, plain_ms, moved, ops, library_ms=lib_ms)


def phase_dog_select(torch, dev, images, cfg):
    """K4's dog_select and dog_refine on octave 0 and the -1 octave of one
    detection sub-batch of rendered images."""
    from sfm_tpu_torch.features.detect import (
        dog_extrema_scores_cuda, dog_refine_cuda, dog_refine_plain,
        select_octave_candidates_cuda, select_octave_candidates_plain)
    from sfm_tpu_torch.features.frontend import _octave_budget
    from sfm_tpu_torch.features.pyramid import build_pyramid_cuda

    fc = cfg.features
    _, dogs = build_pyramid_cuda(images, num_octaves=fc.num_octaves,
                                 scales_per_octave=fc.scales_per_octave, sigma0=fc.sigma0,
                                 assumed_blur=fc.assumed_blur, upsample=fc.upsample_first_octave)
    ct, et = fc.contrast_threshold, fc.edge_threshold
    worst, ms, plain_ms, moved, ops = 0.0, 0.0, 0.0, 0, 0
    for o in (1, 0):
        dog = dogs[o].contiguous()
        score = dog_extrema_scores_cuda(dog, ct, et)["score"]
        budget = _octave_budget(fc.max_keypoints, o)
        ck = select_octave_candidates_cuda({"score": score}, budget)
        cp = select_octave_candidates_plain({"score": score}, budget)
        rargs = lambda c: (dog, c["layer"], c["y"], c["x"], c["score"], ct, et)
        rk, rp = dog_refine_cuda(*rargs(ck)), dog_refine_plain(*rargs(cp))
        torch.cuda.synchronize()
        # Tolerance: the candidates (layer, y, x, score) identical and in the
        # same order; the refined offsets and gated scores bit-identical (every
        # operation rounded as the twin rounds it), or else the largest
        # difference is printed and the gated sets must be equal.
        for key in ("layer", "y", "x", "score"):
            check(torch.equal(ck[key], cp[key]), f"K4 dog_select octave {o - 1}: {key} differs")
        exact = all(torch.equal(a, b) for a, b in zip(rk, rp))
        diff = max(float((a - b).abs().max()) for a, b in zip(rk, rp))
        if not exact:
            check(torch.equal(rk[3] > 0, rp[3] > 0), f"K4 dog_refine octave {o - 1}: gated sets")
        log(f"K4 dog_select octave {o - 1} {tuple(score.shape)}: {budget} candidates "
            f"identical in order ({int((ck['score'] > 0).sum())} nonzero); dog_refine "
            f"{'bit-identical' if exact else f'max difference {diff:.3g}, equal gated sets'} "
            f"({int((rk[3] > 0).sum())} kept)")
        worst = max(worst, diff)
        sk = time_ms(torch, lambda: select_octave_candidates_cuda({"score": score}, budget))
        rkm = time_ms(torch, lambda: dog_refine_cuda(*rargs(ck)))
        sp = time_ms(torch, lambda: select_octave_candidates_plain({"score": score}, budget))
        rpm = time_ms(torch, lambda: dog_refine_plain(*rargs(cp)))
        log(f"  octave {o - 1}: dog_select {sk:.4f} ms (plain torch {sp:.4f} ms); dog_refine "
            f"{rkm:.4f} ms (plain torch {rpm:.4f} ms)")
        ms, plain_ms = ms + sk + rkm, plain_ms + sp + rpm
        # Selection: every score read once, the candidates written; a compare
        # per pixel for the block maxima and 5 passes over them. Refinement:
        # 27 values gathered and ~120 FLOP per candidate.
        n1 = score.numel() // 16
        K = ck["score"].numel()
        moved += nbytes(score, *ck.values()) + K * (27 * 4 + 28) + nbytes(*rk)
        ops += score.numel() + 5 * n1 + 120 * K
    return result(worst, ms, plain_ms, moved, ops)


def phase_topk(torch, dev, cfg, merge_key):
    """K4's topk_rows at the frontend's global keypoint selection (12 images
    x every octave's budget -> max_keypoints, with planted ties and the -1
    rows of invalid candidates), the sweep's match compaction (32 pairs x
    2,048 -> 1,024, -inf padding) and the ORB path's merge of the levels
    (one sub-batch's real key, 12 x 3,800 -> all 3,800 rows, and that key
    with more ties and -inf rows planted)."""
    from sfm_tpu_torch.estimators.ransac import top_k_cuda, top_k_plain
    from sfm_tpu_torch.features.frontend import _octave_budget

    fc = cfg.features
    g = torch.Generator(device=dev).manual_seed(8)
    n = sum(_octave_budget(fc.max_keypoints, o) for o in range(fc.num_octaves))
    x1 = torch.round(torch.rand(12, n, generator=g, device=dev) * 200) / 200
    x1 = torch.where(torch.rand(12, n, generator=g, device=dev) < 0.3, -1.0, x1)
    x2 = -torch.rand(32, 2048, generator=g, device=dev) * 4
    x2 = torch.where(torch.rand(32, 2048, generator=g, device=dev) < 0.6, -torch.inf, x2)
    # Planted: a quarter of the rows copy another row's key of the same
    # image (ties across levels, -inf copies among them), a tenth become -inf.
    B, n3 = merge_key.shape
    src = torch.randint(0, n3, (B, n3), generator=g, device=dev)
    x3 = torch.where(torch.rand(B, n3, generator=g, device=dev) < 0.25,
                     torch.gather(merge_key, 1, src), merge_key)
    x3 = torch.where(torch.rand(B, n3, generator=g, device=dev) < 0.1, -torch.inf, x3)
    cases = ((x1, fc.max_keypoints), (x2, 1024), (merge_key, n3), (x3.contiguous(), n3))
    ms = plain_ms = lib_ms = 0.0
    moved = ops = 0
    for x, k in cases:
        vk, ik = top_k_cuda(x, k)
        vp, ip = top_k_plain(x, k)
        torch.cuda.synchronize()
        # Tolerance: values and indices identical (lax.top_k's order).
        check(torch.equal(vk, vp) and torch.equal(ik, ip), f"K4 topk_rows {tuple(x.shape)} k={k}")
        ms += time_ms(torch, lambda: top_k_cuda(x, k))
        plain_ms += time_ms(torch, lambda: top_k_plain(x, k))
        lib_ms += time_ms(torch, lambda: torch.topk(x, k))
        moved += nbytes(x) + x.shape[0] * k * 8
        ops += 5 * x.numel()
    ties = int(((merge_key[:, 1:] == merge_key[:, :-1])
                & torch.isfinite(merge_key[:, 1:])).sum())
    log(f"K4 topk_rows: identical to the stable sort at {tuple(x1.shape)} k={fc.max_keypoints}, "
        f"{tuple(x2.shape)} k=1024 and the ORB merge {tuple(merge_key.shape)} k={n3} "
        f"({int(torch.isinf(merge_key).sum())} -inf rows, {ties} adjacent ties; and with "
        f"ties planted); {ms:.4f} ms (plain torch {plain_ms:.4f} ms, torch.topk "
        f"{lib_ms:.4f} ms)")
    return result(0.0, ms, plain_ms, moved, ops, library_ms=lib_ms)


# ---------------------------------------------------------------- ground truth

# ---------------------------------------------------------------- K13: global SfM

def _rot(np, rv):
    """Rodrigues of a rotation vector (numpy, f64)."""
    th = float(np.linalg.norm(rv))
    if th < 1e-12:
        return np.eye(3)
    k = np.asarray(rv) / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(th) * Kx + (1 - math.cos(th)) * Kx @ Kx


def relpose_batch(np, P: int, S: int = 256, seed: int = 5):
    """P two-view tables of S rows in normalized coordinates, as
    pairwise_relative_poses feeds K13-a: the inlier rows first (weight 1,
    0.5 px noise at f = 1228), outliers after them (weight 0)."""
    rng = np.random.default_rng(seed)
    xn1 = np.zeros((P, S, 2), np.float32)
    xn2 = np.zeros((P, S, 2), np.float32)
    w = np.zeros((P, S), np.float32)
    R_gt = np.zeros((P, 3, 3))
    for p in range(P):
        X = rng.uniform([-2, -2, 4], [2, 2, 8], (S, 3))
        R = _rot(np, rng.normal(scale=0.05, size=3) + [0, rng.uniform(0.02, 0.3), 0])
        t = np.array([rng.uniform(0.3, 1.0), 0.05, 0.1])
        Xc = X @ R.T + t
        xn1[p] = X[:, :2] / X[:, 2:] + rng.normal(scale=0.5 / 1228, size=(S, 2))
        xn2[p] = Xc[:, :2] / Xc[:, 2:] + rng.normal(scale=0.5 / 1228, size=(S, 2))
        n_inl = int(rng.integers(60, S + 1))
        w[p, :n_inl] = 1.0
        xn2[p, n_inl:] = rng.uniform(-0.4, 0.4, (S - n_inl, 2))
        R_gt[p] = R
    return xn1, xn2, w, R_gt


def _angle_deg(torch, A, B):
    """Geodesic angle (deg) of A B^T, robust near 0 (trace and skew part)."""
    dR = A.double() @ B.double().mT
    cos = (dR.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2
    v = torch.stack([dR[..., 2, 1] - dR[..., 1, 2], dR[..., 0, 2] - dR[..., 2, 0],
                     dR[..., 1, 0] - dR[..., 0, 1]], -1)
    return torch.rad2deg(torch.atan2(0.5 * torch.linalg.vector_norm(v, dim=-1), cos))


def phase_relpose(torch, np, dev, P: int = 232):
    """K13-a at the 36-view table's accepted pairs (JAX's own table: 232)
    x 256 rows, against its twin (torch.func's jacfwd, SVD rank 2)."""
    from sfm_tpu_torch.reconstruction.global_init import relpose_cuda, relpose_plain

    xn1, xn2, w, R_gt = relpose_batch(np, P)
    args = tuple(torch.as_tensor(a, device=dev) for a in (xn1, xn2, w))
    Rk, tk, gk = relpose_cuda(*args)
    Rp, tp, gp = relpose_plain(*args)
    torch.cuda.synchronize()
    ang = _angle_deg(torch, Rk, Rp)
    t_err = float((tk - tp).abs().max())
    same = float((gk == gp).float().mean())
    gt_err = _angle_deg(torch, Rk, torch.as_tensor(R_gt, device=dev))
    # Tolerance: after the 10 GN steps, which pull both to one minimum (the
    # kernel's rank 2 is F (I - v v^T), the twin's an SVD): rotations within
    # 0.05 deg and unit t within 1e-3 for every pair, cheirality counts equal
    # for >= 99% of the pairs (a row near the cheirality boundary may flip).
    check(bool(torch.isfinite(Rk).all() and torch.isfinite(tk).all()), "K13-a: not finite")
    check(float(ang.max()) <= 0.05 and t_err <= 1e-3,
          f"K13-a: rotation {float(ang.max())} deg, t {t_err} from the twin")
    check(same >= 0.99, f"K13-a: cheirality counts equal in {same:.4f} of the pairs")
    check(float(gt_err.median()) <= 0.1, f"K13-a: median {float(gt_err.median())} deg from GT")
    log(f"K13-a relpose: {P} pairs x {xn1.shape[1]} rows, rotation within "
        f"{float(ang.max()):.3g} deg and t within {t_err:.3g} of the twin, counts equal in "
        f"{same:.4f}; median {float(gt_err.median()):.4f} deg from the synthetic truth")
    ms = time_ms(torch, lambda: relpose_cuda(*args))
    plain_ms = time_ms(torch, lambda: relpose_plain(*args), reps=3, warmup=1)
    # ~4,200 FLOP a row: 10 GN steps (~330: residual, 6 tangents, J^T J),
    # the eight-point sums and two recover_pose's triangulations (~860).
    return result(float(ang.max()), ms, plain_ms, nbytes(*args, Rk, tk, gk),
                  4200 * xn1.shape[0] * xn1.shape[1])


def corridor_graph(np, N: int, window: int, seed: int = 6, outliers: float = 0.02):
    """Pairs within ``window`` along a drifting corridor: (pairs, R_rel, t_rel,
    weights, R_gt, C_gt), 0.3 deg rotation noise, 1% direction noise and a
    share of gross rotation outliers."""
    rng = np.random.default_rng(seed)
    yaw = np.cumsum(rng.normal(scale=0.02, size=N))
    R_gt = np.stack([_rot(np, [0.0, y, 0.0]) for y in yaw])
    k = np.arange(N)
    C_gt = np.stack([k * 0.3, np.sin(k * 0.3), 0.5 * np.cos(k * 0.17)], 1)
    pairs = np.array([(i, j) for i in range(N) for j in range(i + 1, min(i + 1 + window, N))],
                     np.int32)
    R_rel, t_rel = [], []
    for i, j in pairs:
        R_rel.append(_rot(np, rng.normal(scale=np.deg2rad(0.3), size=3)) @ R_gt[j] @ R_gt[i].T)
        t = R_gt[j] @ (C_gt[i] - C_gt[j])
        t_rel.append(t / np.linalg.norm(t) + rng.normal(scale=0.01, size=3))
    R_rel = np.stack(R_rel)
    bad = rng.random(len(pairs)) < outliers
    R_rel[bad] = np.stack([_rot(np, rng.normal(size=3)) for _ in range(int(bad.sum()))])
    w = rng.uniform(20, 300, len(pairs)).astype(np.float32)
    return (pairs, R_rel.astype(np.float32), np.stack(t_rel).astype(np.float32), w, R_gt,
            C_gt)


def _avg_ops(N: int, P: int, power: int, refine: int, rounds: int, cg: int):
    """Operations of one rotation and one translation solve: a pass over the
    pair list costs ~54 FLOP a pair and side for a 3x3 block product, ~25 for
    a Laplacian or projected row; per camera ~10 FLOP a CG vector entry and
    ~1,000 for nearest_rotation's 24 steps."""
    rot = (power * (2 * P * 54 + 9 * N * 8) + N * 1000
           + refine * (P * 150 + N * 1000 + cg * (2 * P * 3 * 4 + 3 * N * 10)))
    trans = 2 * rounds * (P * 30 + cg * (2 * P * 3 * 8 + 3 * N * 10)) + 2 * P * 20
    return rot, trans


def phase_averaging(torch, np, dev):
    """K13-b and K13-c at N = 36 and 150 cameras on corridor pair graphs
    (window 7 and 8: ~the pair counts of the 36- and 150-view tables),
    seeded from the spanning tree as the global path and polish seed them,
    against their dense twins."""
    from sfm_tpu_torch.config import GlobalInitConfig
    from sfm_tpu_torch.io.calib import umeyama
    from sfm_tpu_torch.reconstruction import global_init as gi

    cfg = GlobalInitConfig()
    out = {}
    for N, window in ((36, 7), (150, 8)):
        pairs, R_rel, t_rel, w, R_gt, C_gt = corridor_graph(np, N, window)
        P = len(pairs)
        forest = gi.spanning_forest(pairs, w, N)
        X0 = gi.tree_init_rotations(forest, R_rel, N).reshape(3 * N, 3)
        T = lambda a, dt=torch.float32: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                                        device=dev)
        rargs = (T(pairs, torch.int32), T(R_rel), T(gi._normalized(w)), T(X0), cfg.power_iters,
                 cfg.refine_iters)
        Rk = gi.rotation_average_cuda(*rargs)
        Rp = gi.rotation_average_plain(*rargs)
        torch.cuda.synchronize()
        rel = lambda R: R @ R[:1].mT
        r_err = float(_angle_deg(torch, rel(Rk), rel(Rp)).max())
        r_gt = float(_angle_deg(torch, rel(Rk), rel(T(R_gt))).median())
        # Tolerance: gauge-free rotations within 0.1 deg of the dense twin
        # (f32 CG in another summation order), median within 2 deg of truth.
        check(bool(torch.isfinite(Rk).all()) and r_err <= 0.1,
              f"K13-b at N={N}: {r_err} deg from the twin")
        check(r_gt <= 2.0, f"K13-b at N={N}: median {r_gt} deg from the truth")
        R_np = Rk.cpu().numpy()
        d = -np.einsum("pba,pb->pa", R_np[pairs[:, 1]], t_rel)
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
        C0 = gi.tree_init_centers(forest, R_np, pairs, t_rel, N)
        targs = (T(pairs, torch.int32), T(d), T(gi._normalized(w)), T(C0), cfg.als_rounds,
                 cfg.cg_iters, True)
        Ck = gi.translation_average_cuda(*targs)
        Cp = gi.translation_average_plain(*targs)
        torch.cuda.synchronize()

        def aligned(A, B):
            """Max error of A similarity-aligned to B, over B's extent."""
            A, B = A.double().cpu().numpy(), np.asarray(B, np.float64)
            s_, Q, T_ = umeyama(A, B)
            return float(np.linalg.norm(s_ * A @ Q.T + T_ - B, axis=1).max()
                         / np.linalg.norm(B - B.mean(0), axis=1).mean())

        c_err, c_gt = aligned(Ck, Cp.cpu().numpy()), aligned(Ck, C_gt)
        # Tolerance: centers within 1e-3 of the extent of the twin's after a
        # similarity alignment (80 f32 CG steps, another summation order).
        check(bool(torch.isfinite(Ck).all()) and c_err <= 1e-3,
              f"K13-c at N={N}: {c_err} of the extent from the twin")
        log(f"K13-b/c at N={N}, {P} pairs: rotations within {r_err:.3g} deg of the twin "
            f"(median {r_gt:.4f} deg from the truth); centers within {c_err:.3g} of the "
            f"extent of the twin's ({c_gt:.4f} from the truth)")
        rot_ms = time_ms(torch, lambda: gi.rotation_average_cuda(*rargs), reps=5, warmup=1)
        rot_plain = time_ms(torch, lambda: gi.rotation_average_plain(*rargs), reps=3, warmup=1)
        tr_ms = time_ms(torch, lambda: gi.translation_average_cuda(*targs), reps=5, warmup=1)
        tr_plain = time_ms(torch, lambda: gi.translation_average_plain(*targs), reps=3,
                           warmup=1)
        rot_ops, tr_ops = _avg_ops(N, P, cfg.power_iters, cfg.refine_iters, cfg.als_rounds,
                                   cfg.cg_iters)
        log(f"  N={N}: rotation_average {rot_ms:.4f} ms (plain {rot_plain:.4f} ms), "
            f"translation_average {tr_ms:.4f} ms (plain {tr_plain:.4f} ms)")
        out[N] = (result(r_err, rot_ms, rot_plain, nbytes(*rargs[:4], Rk), rot_ops),
                  result(c_err, tr_ms, tr_plain, nbytes(*targs[:4], Ck), tr_ops))
    # The kernels' rows: N = 150, polish's size on the 150-view corridor.
    return out[150]


def _load_projection(np, path: Path):
    vals = path.read_text().split()
    check(vals[0] == "CONTOUR", f"{path}: not a CONTOUR file")
    return np.array([float(v) for v in vals[1:13]]).reshape(3, 4)


def _fundamental_from_projections(np, P1, P2):
    C1 = np.linalg.svd(P1)[2][-1]
    e2 = P2 @ C1
    ex = np.array([[0, -e2[2], e2[1]], [e2[2], 0, -e2[0]], [-e2[1], e2[0], 0]])
    return ex @ P2 @ np.linalg.pinv(P1)


# ---------------------------------------------------------------- main path checks

def gt_epipolar_check(np, torch, scene: Path, blob) -> np.ndarray:
    """Per accepted pair, the median symmetric epipolar error of its inliers
    under the rendered cameras' fundamental matrix; checks median <= 1 px and
    worst pair <= 3 px. Returns the per-pair medians."""
    from sfm_tpu_torch.geometry.epipolar import symmetric_epipolar_distance

    table = blob["table"]
    P = [_load_projection(np, scene / "calib" / f"{Path(p).stem}.txt")
         for p in blob["image_paths"]]
    med = []
    for p in table.accepted():
        i, j = table.pairs[p]
        inl = table.inliers[p]
        F = torch.as_tensor(_fundamental_from_projections(np, P[i], P[j]))
        err = symmetric_epipolar_distance(F, *(torch.as_tensor(x[p][inl], dtype=torch.float64)
                                               for x in (table.xy1, table.xy2)))
        med.append(float(err.median()))
    med = np.asarray(med)
    check(np.median(med) <= 1.0 and med.max() <= 3.0,
          f"GT epipolar error of inliers: median {np.median(med)}, worst pair {med.max()}")
    return med


def accepted_degree(np, table, n_img: int):
    return np.bincount(table.pairs[table.accepted()].reshape(-1), minlength=n_img)


def connected_without(np, table, n_img: int, drop: int) -> bool:
    """Whether the accepted-pair graph minus image ``drop`` is connected."""
    adj = [[] for _ in range(n_img)]
    for i, j in table.pairs[table.accepted()]:
        if drop not in (i, j):
            adj[i].append(j)
            adj[j].append(i)
    start = 0 if drop != 0 else 1
    seen, todo = {start}, deque([start])
    while todo:
        for k in adj[todo.popleft()]:
            if k not in seen:
                seen.add(k)
                todo.append(k)
    return len(seen) == n_img - 1


def rotation_error_deg(np, scene: Path, poses: dict, img: int, ref: int) -> float:
    """Error of img's rotation relative to ref's, against the calib files."""
    Kinv = np.linalg.inv(np.array([[1228.0, 0, 512.0], [0, 1228.0, 384.0], [0, 0, 1.0]]))
    gt = lambda k: Kinv @ _load_projection(np, scene / "calib" / f"{k:04d}.txt")[:, :3]
    est = lambda k: np.asarray(poses[f"{k:04d}.ppm"]["R"])
    dR = (est(img) @ est(ref).T) @ (gt(img) @ gt(ref).T).T
    return float(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))))


def stage_seconds(out: Path) -> dict:
    totals = {}
    for r in json.loads((out / "metrics.json").read_text()):
        if r["name"].split("/")[0] in ("stage", "engine"):
            totals[r["name"]] = totals.get(r["name"], 0.0) + r["value"]
    return totals


def check_model(st: dict, n_img: int, what: str):
    check(st["num_cameras"] >= n_img - 1, f"{what}: {st['num_cameras']}/{n_img} cameras")
    check(st["num_points"] > 1000, f"{what}: {st['num_points']} points")
    check(st["mean_reprojection_error"] < 0.6,
          f"{what}: mean reprojection {st['mean_reprojection_error']}")


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=36, help="rendered 1024x768 views")
    ap.add_argument("--large_views", type=int, default=150,
                    help="views of the retrieval-scale pipeline run")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a card")
    if not (REPO / "sfm_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: {REPO} is not a checkout of the repository")
    sys.path.insert(0, str(REPO))
    import numpy as np

    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]} | torch {torch.__version__} | cuda {torch.version.cuda}")
    work = REPO / ".chip_smoke"   # scenes and artifacts, inside the checkout
    scene, out = work / f"scene_{args.views}", work / f"preprocess_{args.views}"
    large = work / f"scene_{args.large_views}"
    work.mkdir(parents=True, exist_ok=True)

    render = subprocess.Popen(
        [sys.executable, "-c",
         "import sys; from sfm_tpu_torch.render_scene import render_dataset; "
         "[render_dataset(d, int(n), supersample=1, log=print) "
         "for d, n in zip(sys.argv[1::2], sys.argv[2::2])]",
         str(scene), str(args.views), str(large), str(args.large_views)], cwd=REPO)

    def wait_for(d: Path):
        while not (d / ".render_meta").exists():
            check(render.poll() is None or (d / ".render_meta").exists(),
                  f"rendering stopped before {d} was written")
            time.sleep(0.5)

    from sfm_tpu_torch import _kernels, cli

    def run_path(name: str, argv_: list, required, entries=(), forbidden=()) -> tuple:
        """One path of the main path through the CLI, its launch counts reset
        just before and read just after; every kernel of ``required`` and
        every C entry of ``entries`` must have launched, no entry of
        ``forbidden``."""
        _kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = cli.main(["--log_level", "WARNING", "--log_dir", str(work / "logs"), *argv_,
                       "--device", "cuda", "--no_mask"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _kernels.launch_counts()
        check(rc == 0, f"{name} returned {rc}")
        for entry in [e for k in required for e in KERNELS[k][0]] + list(entries):
            check(counts[entry] > 0, f"kernel {entry} was not launched by {name}")
        for entry in forbidden:
            check(counts[entry] == 0, f"kernel {entry} was launched by {name}")
        log(f"{name}: cli wall {wall:.3f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
            + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
        return counts, wall

    try:
        from sfm_tpu_torch.config import FeatureConfig, SfMConfig, VerifyConfig
        from sfm_tpu_torch.io.images import load_image_gray_u8
        from sfm_tpu_torch.device import resolve_device

        dev = resolve_device("cuda")
        t0 = time.perf_counter()
        _kernels.load_library()
        log(f"kernels built in {time.perf_counter() - t0:.1f} s "
            f"({_kernels.build_info['library']})")
        for line in (_kernels.BUILD_DIR / "ptxas.log").read_text().splitlines():
            if "registers" in line or "Compiling entry" in line:
                log("  ptxas: " + line.split("ptxas info    : ")[-1])

        results = {"match_top2": phase_match_top2(torch, dev),
                   "match_epilogue": phase_match_epilogue(torch, dev),
                   "relpose": phase_relpose(torch, np, dev),
                   "pnp_ransac": phase_pnp(torch, np, dev),
                   "pnp_refine": phase_pnp_refine(torch, np, dev),
                   "triangulate_tracks": phase_triangulate(torch, np, dev),
                   "retrieval_score": phase_retrieval_score(torch, np, dev),
                   "guided_match": phase_guided_match(torch, dev),
                   "seed_score": phase_seed_score(torch, np, dev)}
        results["fmat_score_select"], results["fmat_solve"] = phase_fmat(torch, np, dev)
        results["ba_linearize"], results["schur_coupling"] = phase_ba(torch, np, dev)
        results["schur_damp"] = phase_schur_damp(torch, np, dev)
        results["rotation_average"], results["translation_average"] = phase_averaging(
            torch, np, dev)
        torch.cuda.empty_cache()
        wait_for(scene)
        cfg = SfMConfig()
        paths = sorted((scene / "images").glob("*.pgm"))
        images = torch.stack([torch.as_tensor(load_image_gray_u8(p), device=dev)
                              for p in paths[:cfg.features.detect_batch]]).float() / 255.0
        results["pyramid"] = phase_pyramid(torch, dev, images, cfg)
        results["dog_extrema"] = phase_dog_extrema(torch, dev, images[:1], cfg)
        results["sift_describe"] = phase_describe(torch, dev, images[:1], cfg)
        results["dog_select"] = phase_dog_select(torch, dev, images, cfg)
        levels = orb_levels(torch, images, cfg)
        results["orb_fast_nms"] = phase_orb_fast_nms(torch, dev, levels)
        results["orb_blur"] = phase_orb_blur(torch, dev, levels)
        results["orb_describe"], merge_key = phase_orb_describe(torch, dev, levels)
        results["topk_rows"] = phase_topk(torch, dev, cfg, merge_key)
        del images, levels
        torch.cuda.empty_cache()
        results["match_top2"]["d256"], results["match_epilogue"]["d256"] = (
            phase_match_binary(torch, dev))
        results["retrieval_score"]["d256"] = phase_retrieval_binary(torch, dev)
        results["guided_match"]["d256"] = phase_guided_binary(torch, dev)
        torch.cuda.empty_cache()
        launches = {k: 0 for k in _kernels.KERNELS}
        by_path = {}

        def add(counts, path):
            by_path[path] = counts
            for k, v in counts.items():
                launches[k] += v

        # ---- path a: python -m sfm_tpu_torch preprocess --device cuda
        c, pre_wall = run_path("preprocess", ["preprocess", "--data_dir", str(scene),
                                              "--output_dir", str(out)], PREPROCESS_KERNELS)
        add(c, "preprocess")
        pre_metrics = stage_seconds(out)
        pre_peak = torch.cuda.max_memory_allocated()

        # ---- path b: python -m sfm_tpu_torch reconstruct --device cuda (default config)
        c, rec_wall = run_path("reconstruct", ["reconstruct", "--data_dir", str(scene),
                                               "--output_dir", str(out)], RECONSTRUCT_KERNELS)
        add(c, "reconstruct")
        rec_metrics = stage_seconds(out)
        rec_peak = torch.cuda.max_memory_allocated()

        # ---- path c: the guided rescue of an image whose pairs are all rejected
        cut_blob = pickle.loads((out / "pair_table.pkl").read_bytes())
        n_img = len(cut_blob["image_paths"])
        victim = n_img // 2
        cut = cut_blob["table"]
        cut.accept = cut.accept & ~(cut.pairs == victim).any(1)
        check(connected_without(np, cut, n_img, victim),
              "the pair graph falls apart without the cut image")
        rescue = work / f"rescue_{args.views}"
        rescue.mkdir(parents=True, exist_ok=True)
        (rescue / "pair_table.pkl").write_bytes(pickle.dumps(cut_blob))
        SfMConfig(verify=VerifyConfig(rescue_disconnected=False)).to_json(rescue / "config.json")
        c, _ = run_path("rescue", ["reconstruct", "--data_dir", str(scene), "--output_dir",
                                   str(rescue), "--config", str(rescue / "config.json")],
                        RESCUE_KERNELS)
        add(c, "rescue")
        rescue_metrics = stage_seconds(rescue)

        # ---- path d: python -m sfm_tpu_torch pipeline on the retrieval-scale scene
        wait_for(large)
        check(render.wait(timeout=900) == 0, "rendering the scenes failed")
        out_off = work / f"preprocess_{args.large_views}_off"
        out_large = work / f"pipeline_{args.large_views}"
        check(cli.main(["--log_level", "WARNING", "--log_dir", str(work / "logs"), "preprocess",
                        "--data_dir", str(large), "--output_dir", str(out_off), "--device",
                        "cuda", "--no_mask", "--match_mode", "off"]) == 0,
              "the exhaustive preprocess failed")
        c, large_wall = run_path("pipeline", ["pipeline", "--data_dir", str(large),
                                              "--output_dir", str(out_large)], LARGE_KERNELS)
        add(c, "pipeline")
        large_metrics = stage_seconds(out_large)
        large_peak = torch.cuda.max_memory_allocated()

        # ---- path e: reconstruct --global_init on path a's 36-view artifacts
        glob = work / f"global_{args.views}"
        glob.mkdir(parents=True, exist_ok=True)
        (glob / "pair_table.pkl").write_bytes((out / "pair_table.pkl").read_bytes())
        c, glob_wall = run_path("global", ["reconstruct", "--data_dir", str(scene),
                                           "--output_dir", str(glob), "--global_init"],
                                GLOBAL_KERNELS)
        add(c, "global")
        glob_metrics = stage_seconds(glob)

        # ---- path f: reconstruct --polish on path d's 150-view artifacts
        pol = work / f"polish_{args.large_views}"
        pol.mkdir(parents=True, exist_ok=True)
        (pol / "pair_table.pkl").write_bytes((out_large / "pair_table.pkl").read_bytes())
        c, pol_wall = run_path("polish", ["reconstruct", "--data_dir", str(large),
                                          "--output_dir", str(pol), "--polish"],
                               POLISH_KERNELS)
        add(c, "polish")
        pol_metrics = stage_seconds(pol)

        # ---- path g: pipeline --feature_kind orb on the --views scene
        orb = work / f"orb_{args.views}"
        orb.mkdir(parents=True, exist_ok=True)
        SfMConfig(features=FeatureConfig(fast_threshold=ORB_FAST_THRESHOLD)).to_json(
            orb / "config.json")
        c, orb_wall = run_path("orb", ["pipeline", "--data_dir", str(scene), "--output_dir",
                                       str(orb), "--feature_kind", "orb", "--config",
                                       str(orb / "config.json")],
                               ORB_KERNELS, entries=ORB_ENTRIES, forbidden=SIFT_ONLY_ENTRIES)
        add(c, "orb")
        orb_metrics = stage_seconds(orb)
        orb_peak = torch.cuda.max_memory_allocated()
    finally:
        if render.poll() is None:
            render.kill()
            render.wait()

    # ---- path a's checks: the verified pairs
    blob = pickle.loads((out / "pair_table.pkl").read_bytes())
    table, valid = blob["table"], blob["valid"]
    check(n_img == args.views, f"{n_img} images")
    check(table.num_pairs == n_img * (n_img - 1) // 2, f"{table.num_pairs} pairs")
    per_img = valid.sum(1)
    check(per_img.min() >= 500, f"an image has {per_img.min()} valid keypoints")
    acc = table.accepted()
    deg = accepted_degree(np, table, n_img)
    check((deg > 0).all(), f"images in no accepted pair: {np.nonzero(deg == 0)[0]}")
    check((out / "matching_results.csv").exists(), "matching_results.csv missing")
    rows = (out / "matching_results.csv").read_text().strip().splitlines()
    check(len(rows) == 1 + len(acc), "CSV rows != accepted pairs")
    med = gt_epipolar_check(np, torch, scene, blob)

    # ---- path b's checks: the reconstruction
    st = json.loads((out / "reconstruction" / "stats.json").read_text())
    check_model(st, n_img, "reconstruct")
    check(st.get("gt_rot_err_deg_median", 99.0) < 1.0,
          f"GT rotation median {st.get('gt_rot_err_deg_median')} deg")
    check(st.get("gt_ate_rel", 1.0) < 0.05, f"GT ATE {st.get('gt_ate_rel')} of the scene")
    for f in ("reconstruction/poses.json", "reconstruction/points3D.json",
              "reconstruction/reconstruction.ply", "exports/colmap/cameras.txt",
              "exports/colmap/images.txt", "exports/colmap/points3D.txt", "exports/meshlab.ply"):
        check((out / f).exists(), f"{f} missing")

    # ---- path c's checks: the rescue
    rs = json.loads((rescue / "reconstruction" / "stats.json").read_text())
    poses = json.loads((rescue / "reconstruction" / "poses.json").read_text())
    order = [int(k.split(".")[0]) for k in poses]
    check(rs["num_cameras"] == n_img, f"rescue: {rs['num_cameras']}/{n_img} cameras")
    check(victim not in order[:2], f"rescue: the cut image {victim} is in the seed pair")
    check("engine/guided" in rescue_metrics, "rescue: no engine/guided span")
    victim_err = rotation_error_deg(np, scene, poses, victim, order[0])
    check(victim_err < 2.0, f"rescue: the cut image's rotation is {victim_err} deg off")
    check(rs["mean_reprojection_error"] < 0.6,
          f"rescue: mean reprojection {rs['mean_reprojection_error']}")

    # ---- path d's checks: retrieval at scale, and the model
    L = args.large_views
    big = pickle.loads((out_large / "pair_table.pkl").read_bytes())
    off = pickle.loads((out_off / "pair_table.pkl").read_bytes())["table"]
    bt = big["table"]
    check(len(big["image_paths"]) == L, f"{len(big['image_paths'])} images")
    check(bt.num_pairs < L * (L - 1) // 2, f"retrieval kept all {bt.num_pairs} pairs")
    check((accepted_degree(np, bt, L) > 0).all(), "an image is in no accepted pair")
    big_med = gt_epipolar_check(np, torch, large, big)
    acc_on = {tuple(p) for p in bt.pairs[bt.accepted()].tolist()}
    acc_off = {tuple(p) for p in off.pairs[off.accepted()].tolist()}
    recall = len(acc_on & acc_off) / max(len(acc_off), 1)
    check(recall >= 0.95, f"retrieval recall {recall:.4f} of the exhaustive accepted pairs")
    ls = json.loads((out_large / "reconstruction" / "stats.json").read_text())
    check_model(ls, L, "pipeline")
    from sfm_tpu_torch.reconstruction.tracks import build_tracks

    tracks = build_tracks(bt, big["xy"], L)

    # ---- path e's checks: the global model is kept and consistent
    gcfg = SfMConfig().global_init
    gs = json.loads((glob / "reconstruction" / "stats.json").read_text())
    check_model(gs, n_img, "global")
    check("global_pair_residual_deg" in gs, "global: the model came from the incremental "
          "fallback, not the global path")
    check(gs["global_pair_residual_deg"] < 1.0,
          f"global: median pair residual {gs['global_pair_residual_deg']} deg")
    check(gs["global_pair_outlier_frac"] <= gcfg.fallback_outlier_frac,
          f"global: {gs['global_pair_outlier_frac']} of the pairs disagree")

    # ---- path f's checks: polish ran on the 150-view model
    ps = json.loads((pol / "reconstruction" / "stats.json").read_text())
    check_model(ps, L, "polish")
    check(any(k.startswith("polish_") for k in ps), "polish: no polish_* stats (it never ran)")
    check("engine/polish" in pol_metrics, "polish: no engine/polish span")

    # ---- path g's checks: the binary frontend's pairs and model
    ob = pickle.loads((orb / "pair_table.pkl").read_bytes())
    ot = ob["table"]
    from sfm_tpu_torch.features.binary import _level_budgets

    fc = SfMConfig().features
    orb_rows = sum(_level_budgets(fc.max_keypoints, fc.orb_levels, fc.orb_scale_factor))
    check(ob["desc"].shape == (n_img, orb_rows, 256), f"path g: descriptors {ob['desc'].shape}")
    check(set(np.unique(np.abs(ob["desc"][ob["valid"]]))) == {np.float16(1 / 16)},
          "path g: descriptors are not +-1/16")
    check((accepted_degree(np, ot, n_img) > 0).all(), "path g: an image is in no accepted pair")
    orb_med = gt_epipolar_check(np, torch, scene, ob)
    os_ = json.loads((orb / "reconstruction" / "stats.json").read_text())
    check_model(os_, n_img, "orb")
    check("jax" not in sys.modules and "sfm_tpu" not in sys.modules, "JAX was imported")

    # ---- report
    det_s, sweep_s = pre_metrics["stage/detect"], pre_metrics["stage/sweep"]
    log(f"preprocess: {n_img} images, {table.num_pairs} pairs, {len(acc)} accepted, "
        f"keypoints/image min {per_img.min()} mean {per_img.mean():.0f}")
    log(f"detect {det_s:.3f} s = {n_img / det_s:.2f} imgs/s | sweep {sweep_s:.3f} s = "
        f"{table.num_pairs / sweep_s:.1f} pairs/s | stage {pre_metrics['stage/preprocess']:.3f} s "
        f"| cli wall {pre_wall:.3f} s | peak device memory {pre_peak / 2**30:.2f} GiB")
    log(f"GT check: median inlier epipolar error per pair, median {np.median(med):.3f} px, "
        f"worst {med.max():.3f} px")
    engine = lambda m: ", ".join(f"{k.split('/')[1]} {v:.3f} s" for k, v in sorted(m.items())
                                 if k.startswith("engine/"))
    log(f"reconstruct: {st['num_cameras']}/{n_img} cameras, {st['num_points']} points, "
        f"{st['num_observations']} observations, mean reprojection "
        f"{st['mean_reprojection_error']:.4f} px, GT rotation median "
        f"{st['gt_rot_err_deg_median']:.4f} deg, ATE {100 * st['gt_ate_rel']:.3f}% of the scene")
    log(f"reconstruct stage {rec_metrics['stage/reconstruct']:.3f} s | cli wall {rec_wall:.3f} s "
        f"| peak device memory {rec_peak / 2**30:.2f} GiB | engine: {engine(rec_metrics)}")
    log(f"rescue: image {victim} cut, {rs['num_cameras']}/{n_img} cameras, its rotation "
        f"{victim_err:.4f} deg from ground truth, mean reprojection "
        f"{rs['mean_reprojection_error']:.4f} px, stage {rescue_metrics['stage/reconstruct']:.3f}"
        f" s, engine/guided {rescue_metrics['engine/guided']:.3f} s")
    log(f"pipeline at {L} views: {bt.num_pairs} of {L * (L - 1) // 2} pairs swept, "
        f"{len(acc_on)} accepted (exhaustive: {len(acc_off)}), recall {recall:.4f}; GT check "
        f"median {np.median(big_med):.3f} px, worst {big_med.max():.3f} px")
    log(f"pipeline at {L} views: {ls['num_cameras']}/{L} cameras, {ls['num_points']} points, "
        f"mean reprojection {ls['mean_reprojection_error']:.4f} px, GT rotation median "
        f"{ls.get('gt_rot_err_deg_median', float('nan')):.4f} deg, ATE "
        f"{100 * ls.get('gt_ate_rel', float('nan')):.3f}% of the scene (recorded, not gated); "
        f"{tracks.num_tracks} tracks x {tracks.max_views} view slots = "
        f"{tracks.view_img.size} BA table rows before compaction")
    log(f"pipeline at {L} views: cli wall {large_wall:.3f} s | peak device memory "
        f"{large_peak / 2**30:.2f} GiB | " + ", ".join(
            f"{k} {v:.3f} s" for k, v in sorted(large_metrics.items())))
    gt = lambda st: (f"GT rotation median {st.get('gt_rot_err_deg_median', float('nan')):.4f} "
                     f"deg, ATE {100 * st.get('gt_ate_rel', float('nan')):.3f}% of the scene")
    log(f"global at {n_img} views: {gs['num_cameras']}/{n_img} cameras, {gs['num_points']} "
        f"points, mean reprojection {gs['mean_reprojection_error']:.4f} px, pair residual "
        f"median {gs['global_pair_residual_deg']:.4f} deg, outlier pairs "
        f"{gs['global_pair_outlier_frac']:.4f}; {gt(gs)} (recorded, not gated); cli wall "
        f"{glob_wall:.3f} s | " + ", ".join(f"{k} {v:.3f} s"
                                          for k, v in sorted(glob_metrics.items())))
    log(f"polish at {L} views: applied {ps.get('polish_applied')}, rolled back "
        f"{ps.get('polish_rolled_back', False)}, seed {ps.get('polish_seed_choice')} (scores "
        f"(outlier share, median deg) {ps.get('polish_seed_scores')}), pair "
        f"residual {ps.get('polish_pair_residual_deg_before', float('nan')):.4f} -> "
        f"{ps.get('polish_pair_residual_deg_after', float('nan')):.4f} deg, outlier pairs "
        f"{ps.get('polish_pair_outlier_frac', float('nan')):.4f}; {ps['num_cameras']}/{L} "
        f"cameras, {ps['num_points']} points, {ps['mean_reprojection_error']:.4f} px; {gt(ps)} "
        f"(path d, unpolished: {gt(ls)}); cli wall {pol_wall:.3f} s | " + ", ".join(
            f"{k} {v:.3f} s" for k, v in sorted(pol_metrics.items())))
    o_det, o_sweep = orb_metrics["stage/detect"], orb_metrics["stage/sweep"]
    log(f"orb at {n_img} views: keypoints/image min {ob['valid'].sum(1).min()} mean "
        f"{ob['valid'].sum(1).mean():.0f} of {orb_rows}, {len(ot.accepted())} of {ot.num_pairs} "
        f"pairs accepted; GT check median {np.median(orb_med):.3f} px, worst "
        f"{orb_med.max():.3f} px")
    log(f"orb: detect {o_det:.3f} s = {n_img / o_det:.2f} imgs/s | sweep {o_sweep:.3f} s = "
        f"{ot.num_pairs / o_sweep:.1f} pairs/s | preprocess stage "
        f"{orb_metrics['stage/preprocess']:.3f} s | reconstruct stage "
        f"{orb_metrics['stage/reconstruct']:.3f} s | cli wall {orb_wall:.3f} s | peak device "
        f"memory {orb_peak / 2**30:.2f} GiB")
    log(f"orb: {os_['num_cameras']}/{n_img} cameras, {os_['num_points']} points, mean "
        f"reprojection {os_['mean_reprojection_error']:.4f} px; {gt(os_)} (recorded, not "
        f"gated) | engine: {engine(orb_metrics)}")
    log("launches by entry, all paths: " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    kernels = []
    for name, (entries, source, replaces) in KERNELS.items():
        r = results[name]
        n = sum(launches[e] for e in entries)
        per_path = {path: sum(c[e] for e in entries) for path, c in by_path.items()}
        bound_ms, bound_by = bound(r)
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"{name}: {r['ms']:.4f} ms (plain torch {r['plain_ms']:.4f} ms, library {lib}, "
            f"bound {bound_ms:.4f} ms by {bound_by}: {r['bytes']} B, {r['ops']} op), {n} "
            f"launches in the main path ({per_path})")
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": n, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": r["library_ms"], "launches_by_path": per_path,
               "entries": list(entries)}
        if "d256" in r:   # the same kernel held on +-1/16 descriptors at D = 256
            b = r["d256"]
            b_ms, b_by = bound(b)
            row["d256"] = {"ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b_ms,
                           "bound_by": b_by, "max_abs_err": b["max_abs_err"]}
            log(f"  {name} at D=256: {b['ms']:.4f} ms (plain torch {b['plain_ms']:.4f} ms, "
                f"bound {b_ms:.4f} ms by {b_by}: {b['bytes']} B, {b['ops']} op)")
        kernels.append(row)
    log(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
