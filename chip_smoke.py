#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sfm_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--views 36] [--large_views 150] [--huge_views 300]

1. Builds the port's CUDA kernels from ``sfm_tpu_torch/csrc`` (nvcc, sm_90a).
2. Holds each kernel against its plain PyTorch twin at the main path's shapes
   (K1, K1-r and K1-g also on +-1/16 binary descriptors at D = 256; K4's
   ``dog_select`` also on the binary frontend's FAST planes and
   ``topk_rows`` on its merge of the levels, where scores tie exactly),
   times both with CUDA events (and one PyTorch library call where one
   computes the same function), and computes each kernel's bound: the larger
   of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s (f32).
   ``topk_rows`` runs at each caller's shape (RANSAC's sampling without
   replacement too: 16,384 rows of 1,024 -> 8), each case's wrapper and
   ``torch.topk`` timed alike and its device time traced.
   K3's pyramid and K4's ``dog_select`` / ``dog_refine`` (every octave of
   one detection sub-batch, ``dog_select`` also on path g's FAST planes) must
   be bit-identical to their twins and repeat bit for bit; each prints its
   wrapper and device time (``dog_select`` and ``dog_refine`` on rows of
   their own). K10's dense solve (``schur_cholesky_solve`` / ``_f64``, one
   cooperative launch that factors S and solves) is held against its twin,
   cuSOLVER (``torch.linalg.cholesky_ex`` + ``cholesky_solve``, timed as the
   library call) and a float64 solve on thirteen S: path d's largest
   (``DENSE_SOLVE_N``), the BA phases' real S, the dense route's cap sizes
   (``DENSE_CAP_N``) and two sizes past the kernel's one row group a block
   and its shared-memory z (``DENSE_PAST_N``) in both types, with the
   all-NaN rule for an S that is not positive definite.
   K10's coupling runs with its layout made once, as ``run_ba`` makes it,
   and prints its wrapper and device time on every route; K7 runs its two
   buckets, a bucket of the shape path d's engine launches most
   (``PATH_D_TRIANGULATE``) and one of its whole-table launches
   (``PATH_D_TABLE``), each case timed alone, with the camera tensors made
   once as the engine makes them, and each also on the layout (a warp or a
   thread a row) that the wrapper does not pick, which must give the same
   bits.
   K11 (the matrix-free S x and the block-Jacobi PCG) and K10's block-Jacobi
   inverses run on a 300-camera / 60k-point / 600k-observation scene with
   20 cameras pinned, the matvec also with the observations in point-major
   order (the same bits) and each matvec and PCG entry with its wrapper and
   device time; one ``run_ba`` at 256 cameras runs through PCG and
   through the dense path. The kernels with scattered sums (K5, K8-K11)
   must give the same bits on a second launch. The BA island's other
   routes (``ISLAND_ROUTES``: per-camera intrinsics, B = 10; the f64 island;
   both) run K8-K11's entries of that route on the same two scenes against
   their twins (float64 bounds over the card's FP64 peak), then ``run_ba``
   on the card: two focal groups (fx 1,140 / 1,270) recovered within 1% at
   300 cameras through PCG and 200 through the dense path, PCG against
   dense with the per-camera regularization, and the f64 island ending
   below 0.75x the f32 cost on the reference's ill-conditioned
   1,000-camera scene. K6's P3P round (``p3p_ransac``: the samples' solve,
   the scoring and the winner in one launch) runs at 8 candidates x 2,048
   samples x 2,048 rows beside its two halves alone (``p3p_solve``,
   ``pnp_score_select``), each against its twin and repeating bit for bit,
   the round bit for bit its halves' outputs. K6's DLT branch
   (``pnp_dlt_solve``) runs on the P3P phase's scene at sample size 6
   against its twin, hypothesis by hypothesis and through the whole branch
   to the refined winner. Past the
   old shared-memory caps: K13-b/c at 2,000 cameras (their state in global
   memory), and K10's damping and K11's matvec on every route at 5,000
   cameras (the camera sums straight into global memory), each against
   its twin and repeating bitwise, with one PCG solve there.
3. Renders ``--views``, ``--large_views`` and ``--huge_views`` 1024x768
   views of the textured corridor (the port's own
   ``sfm_tpu_torch/render_scene.py``, in one background subprocess with a
   pool of processes, one view a task, so that the renders overlap the
   kernel phases).
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
      of the scene, the model and the COLMAP export written; then the same
      ``reconstruct`` again on the same pair table, whose model must be
      the same bytes (the BA kernels' sums are order-free);
   c. the guided rescue: ``reconstruct`` on a copy of the pair table with
      every pair of one middle image rejected (``verify.rescue_disconnected``
      off): all cameras registered, the cut image through the guided 2D-3D
      matcher within 2 deg of ground truth, < 0.6 px;
   d. ``pipeline`` on the ``--large_views`` scene, where retrieval turns on:
      fewer pairs swept than all, every image in an accepted pair, the
      ground-truth epipolar check, recall >= 0.95 of the pairs an exhaustive
      (``--match_mode off``) preprocess accepts, >= ``PATH_D_MIN_CAMERAS``
      cameras, > 1,000 points, < 0.6 px, ground-truth rotation median <
      ``PATH_D_MAX_GT_DEG`` (both from the JAX reference's seeds on the
      card's own table); then its preprocess once more with the CLI's
      ``torch.profiler`` trace, whose device time of K3's and K4's kernels
      (``PATH_D_TRACED``) is printed beside ``stage/detect``, and its
      reconstruct once more, traced, for the dense solve's device total;
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
      gated;
   h. ``pipeline`` on the ``--huge_views`` scene, more images than
      ``ba.use_dense_schur_below``: K11 launched and no dense S assembled
      or solved (``DENSE_ENTRIES``) in the whole
      pipeline; every BA call a PCG call, its final cost finite and no
      higher than its initial one; every image in an accepted pair, the
      ground-truth epipolar check, > 1,000 points, < 0.6 px and the camera
      gate ``HUGE_MIN_CAMERA_SHARE``; then two ``reconstruct``s on its
      artifacts with ``ba.local_window`` = ``LOCAL_WINDOW``
      (``WINDOW_CONFIGS``): periodic calls on restricted problems, every BA
      call's cost finite and down, the final call global on PCG; the run
      with the reference's long-sequence settings held to the model gates
      above, the window alone (intrinsics free) checked finite and printed.
      Ground-truth pose and the track table's fill printed, not gated;
   i. ``reconstruct`` on the artifacts of paths a, d and h with the BA
      island's other routes (``PATH_I``): per-camera intrinsics and the f64
      island on the 150-view table (dense), per-camera intrinsics on the
      300-view one (PCG at B = 10), both flags on the 36-view one, dense
      and on PCG, and the f64 island alone on PCG: every entry of those
      routes launched, every BA call on its route (``ba/solve``'s
      ``cam_params`` and ``dtype``) with its cost finite and down; the runs
      of ``PATH_I_GATED`` held to path d's model gates, the others checked
      finite and printed; each run's ``engine/ba`` seconds beside path d's
      and path h's. Every path prints its model beside the one it read
      with cuSOLVER's dense solve (``MODELS_BEFORE``), and the runs that
      take no dense step (``PCG_ONLY_RUNS``) must read it exactly; every run
      must read ``MODELS_PINNED`` (the models of K10's redesigned Cholesky
      kernel: the redesigns since keep every kernel's bits) exactly; on every path the dense solves
      equal the assembled S;
   j. ``reconstruct`` on path a's artifacts with ``PATH_J_CONFIG``
      (``pnp.sample_size`` 6, PnP's DLT branch): ``pnp_dlt_solve``,
      ``pnp_score_select`` and ``pnp_refine`` launched and ``p3p_ransac``
      and ``p3p_solve`` not, every BA call's cost finite and down, at least
      ``PATH_J_MIN_CAMERAS`` cameras, < 0.6 px; ground-truth pose printed,
      not gated.

Prints the card (nvidia-smi), per-kernel and stage numbers, a JSON line of
the kernels and, last, ``{"ok": true, "device": {...}}``. Any failure raises;
without a card, or outside a checkout of the repository, it exits non-zero
before printing any result. It takes about four minutes on one H100 (``PERF.md``).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import time
from collections import deque
from pathlib import Path

REPO = Path(__file__).resolve().parent

KERNELS = {
    # name: (C entry points, source, the JAX program it replaces)
    "match_top2": (("match_top2",), "sfm_tpu_torch/csrc/match_top2.cu",
                   "sfm_tpu/matching/core.py:51"),
    "fmat_ransac": (("fmat_ransac",), "sfm_tpu_torch/csrc/fmat_ransac.cu",
                    "sfm_tpu/estimators/fundamental.py:20"),
    "dog_extrema": (("dog_extrema",), "sfm_tpu_torch/csrc/dog_extrema.cu",
                    "sfm_tpu/features/detect.py:23"),
    "sift_describe": (("sift_describe",), "sfm_tpu_torch/csrc/sift_describe.cu",
                      "sfm_tpu/features/descriptor.py:371"),
    # The P3P round in one launch (p3p_ransac); p3p_solve, its solve alone on
    # gathered samples, is held in phase_pnp and launched by no path.
    "pnp_ransac": (("p3p_ransac", "p3p_solve"), "sfm_tpu_torch/csrc/pnp_ransac.cu",
                   "sfm_tpu/estimators/pnp.py:228"),
    # The same scoring and winner for hypotheses given: the DLT branch's.
    "pnp_score_select": (("pnp_score_select",), "sfm_tpu_torch/csrc/pnp_ransac.cu",
                         "sfm_tpu/estimators/pnp.py:322"),
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
    "pnp_dlt": (("pnp_dlt_solve",), "sfm_tpu_torch/csrc/pnp_dlt.cu",
                "sfm_tpu/estimators/pnp.py:27"),
    "schur_damp": (("schur_damp", "schur_back_substitute"), "sfm_tpu_torch/csrc/schur_damp.cu",
                   "sfm_tpu/ba/schur.py:174"),
    "dog_select": (("dog_select",), "sfm_tpu_torch/csrc/dog_select.cu",
                   "sfm_tpu/features/detect.py:230"),
    "dog_refine": (("dog_refine",), "sfm_tpu_torch/csrc/dog_select.cu",
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
    "schur_block_jacobi": (("schur_block_jacobi",), "sfm_tpu_torch/csrc/schur_damp.cu",
                           "sfm_tpu/ba/schur.py:197"),
    "schur_matvec": (("schur_matvec",), "sfm_tpu_torch/csrc/schur_pcg.cu",
                     "sfm_tpu/ba/schur.py:232"),
    "pcg": (("pcg_init", "pcg_step"), "sfm_tpu_torch/csrc/schur_pcg.cu",
            "sfm_tpu/ba/schur.py:261"),
    # The dense step's Cholesky factorization and solve, one entry a scalar
    # type (both camera blocks); the f64 row is the f64 island's.
    "schur_cholesky": (("schur_cholesky_solve",), "sfm_tpu_torch/csrc/schur_cholesky.cu",
                       "sfm_tpu/ba/schur.py:420"),
    "schur_cholesky_f64": (("schur_cholesky_solve_f64",), "sfm_tpu_torch/csrc/schur_cholesky.cu",
                           "sfm_tpu/ba/schur.py:420"),
}
# The BA island's other routes, one row a kernel and route: per-camera
# intrinsics ("b10", the 10-parameter camera block), the f64 island ("f64")
# and both ("b10_f64"); the entry points are the default route's with the
# route's suffix (the cost at each camera's own K is ba_cost_b10, which the
# b10_f64 route shares: it is the b10 row's).
for _r in ("b10", "f64", "b10_f64"):
    KERNELS.update({
        f"ba_linearize_{_r}": (
            (f"ba_linearize_{_r}",) + (("ba_cost_b10",) if _r == "b10" else ()),
            "sfm_tpu_torch/csrc/ba_linearize.cu",
            "sfm_tpu/ba/lm.py:204" if _r == "f64" else "sfm_tpu/ba/residuals.py:97"),
        f"schur_coupling_{_r}": ((f"schur_coupling_{_r}",), "sfm_tpu_torch/csrc/schur_coupling.cu",
                                 "sfm_tpu/ba/schur.py:348"),
        f"schur_damp_{_r}": ((f"schur_damp_{_r}", f"schur_back_substitute_{_r}"),
                             "sfm_tpu_torch/csrc/schur_damp.cu", "sfm_tpu/ba/schur.py:174"),
        f"schur_block_jacobi_{_r}": ((f"schur_block_jacobi_{_r}",),
                                     "sfm_tpu_torch/csrc/schur_damp.cu", "sfm_tpu/ba/schur.py:197"),
        f"schur_matvec_{_r}": ((f"schur_matvec_{_r}",), "sfm_tpu_torch/csrc/schur_pcg.cu",
                               "sfm_tpu/ba/schur.py:232"),
        f"pcg_{_r}": ((f"pcg_init_{_r}", f"pcg_step_{_r}"), "sfm_tpu_torch/csrc/schur_pcg.cu",
                      "sfm_tpu/ba/schur.py:261"),
    })
ISLAND_ROWS = tuple(k for k in KERNELS if k.endswith(("_b10", "_f64")))
# The kernels each path must launch.
PREPROCESS_KERNELS = ("match_top2", "fmat_ransac", "dog_extrema", "sift_describe",
                      "pyramid", "dog_select", "dog_refine", "topk_rows",
                      "match_epilogue")
RECONSTRUCT_KERNELS = ("pnp_ransac", "triangulate_tracks", "ba_linearize", "schur_coupling",
                       "seed_score", "pnp_refine", "schur_damp", "schur_cholesky")
RESCUE_KERNELS = RECONSTRUCT_KERNELS + ("guided_match",)
LARGE_KERNELS = PREPROCESS_KERNELS + RECONSTRUCT_KERNELS + ("retrieval_score",)
K13_KERNELS = ("relpose", "rotation_average", "translation_average")
GLOBAL_KERNELS = K13_KERNELS + ("triangulate_tracks", "ba_linearize", "schur_coupling",
                                "schur_damp", "schur_cholesky")
POLISH_KERNELS = RECONSTRUCT_KERNELS + K13_KERNELS
K12_KERNELS = ("orb_fast_nms", "orb_blur", "orb_describe")
ORB_KERNELS = K12_KERNELS + ("dog_select", "topk_rows", "match_top2", "match_epilogue",
                             "fmat_ransac") + RECONSTRUCT_KERNELS
SIFT_ONLY_ENTRIES = ("build_pyramid", "dog_extrema", "dog_refine", "sift_describe")
# Path h: more images than ba.use_dense_schur_below, so every BA call of the
# pipeline is a PCG call (K11 and K10's block-Jacobi inverses) and no dense S
# is assembled or factorized; with ba.local_window the periodic calls run on
# restricted problems of at most 256 cameras (dense S), the final one on PCG.
K11_KERNELS = ("schur_block_jacobi", "schur_matvec", "pcg")
HUGE_KERNELS = PREPROCESS_KERNELS + ("retrieval_score", "pnp_ransac", "triangulate_tracks",
                                     "ba_linearize", "seed_score", "pnp_refine",
                                     "schur_damp") + K11_KERNELS
DENSE_ENTRIES = ("schur_coupling", "schur_cholesky_solve", "schur_cholesky_solve_f64")
# A dense BA step assembles S (the coupling, on its route) and solves it
# (the Cholesky, by type): on every path the two launch counts agree.
COUPLING_ENTRIES = tuple(e for k, (es, _, _) in KERNELS.items()
                         if k.startswith("schur_coupling") for e in es)
CHOLESKY_ENTRIES = ("schur_cholesky_solve", "schur_cholesky_solve_f64")
WINDOW_KERNELS = RECONSTRUCT_KERNELS + K11_KERNELS
# Path h's two windowed runs on the pipeline's artifacts: the window of 16
# alone (the rest of the default config: shared intrinsics optimized), and
# the reference's own settings for long ordered sequences
# (scripts/image_scale_bench.py:62-73, its incremental modes: intrinsics
# fixed, 15 LM iterations, 40 CG steps, triangulation every 2 registrations).
LOCAL_WINDOW = 16
WINDOW_CONFIGS = {
    "local_window": {"ba": {"local_window": LOCAL_WINDOW}},
    "long_sequence": {"ba": {"local_window": LOCAL_WINDOW, "optimize_intrinsics": False,
                             "prune_multiplier": 3.0, "max_iterations": 15, "cg_iters": 40},
                      "triangulation": {"cadence": 2}},
}
# Path i: reconstruct on artifacts paths a, d and h wrote, with the BA
# island's other routes. name: (the artifacts: "views" (36), "large" (150)
# or "huge" (300), its --config, the (cam_params, dtype) every BA call must
# record, the solver every BA call must take).
_PERCAM, _F64 = {"per_camera_intrinsics": True}, {"f64_normal_equations": True}
PATH_I = {
    "percam_150": ("large", {"ba": _PERCAM}, (10, "float32"), "dense"),
    "f64_150": ("large", {"ba": _F64}, (6, "float64"), "dense"),
    "percam_300": ("huge", {"ba": _PERCAM}, (10, "float32"), "pcg"),
    "both_36": ("views", {"ba": {**_PERCAM, **_F64}}, (10, "float64"), "dense"),
    "both_pcg_36": ("views", {"ba": {**_PERCAM, **_F64, "use_dense_schur_below": 4}},
                    (10, "float64"), "pcg"),
    "f64_pcg_36": ("views", {"ba": {**_F64, "use_dense_schur_below": 4}}, (6, "float64"), "pcg"),
}
# The runs of path i held to path d's model gates (> 1,000 points, < 0.6 px)
# and each one's camera gate, a share of the images: what the final tree's
# three smokes read, less 5% (PERF.md, section 6). The others are
# checked finite and printed. The per-camera runs are not gated because
# the reference breaks the same way: on the card's 150-view table without
# descriptors the JAX package's reconstruct with per-camera intrinsics, on
# the CPU, kept 21 cameras and 7 points (fx 1,230.77), where the port on
# the card kept 21 cameras and 30 points (fx 1,230.75)
# (tests/local_window_report.py, cases percam and percam_nodesc).
PATH_I_GATED = {"f64_150": 0.95 * 140 / 150}
# The runs of path h whose model is gated, and each one's camera gate: all
# but at most one image when None, else this share of the images. The BA
# sums are order-free, so a tree reads the same models in every smoke; each
# gate is what the final tree's three smokes from `git archive` read, less
# 5%: the pipeline 235 cameras in each, the long-sequence run 153 (PERF.md,
# section 6). The "local_window" run's model is checked finite and printed,
# not held to the model gates: on one 300-view table the JAX reference's own
# windowed reconstruct, with the intrinsics free, ended at 0.6581 px with
# 1,041 points and fx 2,371 against the rendered 1,228, as the port's does
# (tests/local_window_report.py; PERF.md, section 6).
DLT_SAMPLE = 6        # pnp.sample_size of the DLT branch's phase and of path j
DLT_MIN_INLIERS = 15  # PnPConfig.min_inliers: below it a hypothesis is no consensus
# Path j: reconstruct on path a's 36-view artifacts with PnP's DLT branch
# (pnp.sample_size 6: kernels pnp_dlt_solve and pnp_score_select, never the P3P
# round's p3p_ransac).
PATH_J_CONFIG = {"pnp": {"sample_size": DLT_SAMPLE}}
DLT_KERNELS = tuple(k for k in RECONSTRUCT_KERNELS if k != "pnp_ransac") + ("pnp_dlt",
                                                                          "pnp_score_select")
# Entries of a path's kernel rows that only the phases launch.
PHASE_ONLY_ENTRIES = ("p3p_solve",)
# The JAX reference's camera count less one: its reconstruct stage with
# PATH_J_CONFIG, on the CPU, on the card's path a table kept 36 of 36
# cameras (5,135 points, 0.1308 px, GT rotation median 0.9821 deg;
# tests/local_window_report.py, case dlt6, on pair_table_full.pkl.xz).
PATH_J_MIN_CAMERAS = 36 - 1
# Path d's gates. The JAX reference's reconstruct stage on the card's own
# 150-view table, on the CPU, with SfMConfig.seed 0-7 (its draws), kept
# 140-150 cameras at a ground-truth rotation median of 3.06-78.52 deg: it
# folds this corridor on some seeds, as the port does on its own draws
# (tests/engine_trace_report.py; PERF.md, section 6). The gates: its fewest
# cameras less 5%, and its worst median plus 10%.
PATH_D_MIN_CAMERAS = 140 - 7
PATH_D_MAX_GT_DEG = 1.1 * 78.52
# The models every path read while the dense BA step was solved by cuSOLVER
# (cameras, points, mean reprojection px, GT rotation median deg, None where
# that run does not print it; one smoke on an NVIDIA H100 80GB HBM3 at 700 W,
# PERF.md section 6), the same since K10's coupling and K7 were redesigned.
# K10's own Cholesky kernel rounds otherwise than cuSOLVER, so a run that
# takes a dense step reads a new model, and the gates decide; the runs that
# take none (PCG_ONLY_RUNS: PCG throughout) must read these exactly, which
# shows that nothing but the dense step moved. Each run prints its model
# beside these.
MODELS_BEFORE = {
    "reconstruct": (36, 5138, 0.1318, 0.9620),
    "rescue": (36, None, 0.1309, None),
    "pipeline": (150, 18587, 0.5564, 22.6208),
    "global": (36, 4813, 0.2279, 2.0195),
    "polish": (150, 20221, 0.2495, 2.7112),
    "orb": (36, 19316, 0.4209, 0.1754),
    "pipeline_huge": (235, 29097, 0.3227, 123.0414),
    "local_window": (300, 4229, 0.2148, 78.3882),
    "long_sequence": (153, 19836, 0.1570, 17.7777),
    "percam_150": (21, 30, 0.1286, 16.7955),
    "f64_150": (140, 18189, 0.2105, 1.4213),
    "percam_300": (21, 31, 0.9718, 101.8903),
    "both_36": (14, 351, 1.8570, 48.5770),
    "both_pcg_36": (14, 356, 1.8879, 65.1932),
    "f64_pcg_36": (36, 5140, 0.1322, 0.7697),
    "dlt": (36, 5137, 0.1312, 0.9771),
}
PCG_ONLY_RUNS = ("pipeline_huge", "both_pcg_36", "f64_pcg_36")
# The models every run read with the first design of K10's Cholesky kernel
# (left-looking, its products on the CUDA cores, the back-substitution on
# one SM; one smoke of that design on an NVIDIA H100 80GB HBM3 at 700 W,
# PERF.md section 6). The redesign sums the products on the float64 tensor
# cores, in another order, so the runs with a dense BA step may read new
# models; each run prints its model beside these too.
MODELS_FIRST_CHOLESKY = {
    "reconstruct": (36, 5140, 0.1322, 0.9501),
    "rescue": (36, None, 0.1305, None),
    "pipeline": (150, 19633, 0.4484, 62.8108),
    "global": (36, 4817, 0.2267, 1.5463),
    "polish": (150, 20165, 0.1518, 18.2821),
    "orb": (36, 19316, 0.4208, 0.4525),
    "pipeline_huge": (235, 29097, 0.3227, 123.0414),
    "local_window": (168, 1017, 2.0439, 46.7649),
    "long_sequence": (194, 23976, 0.4610, 25.4052),
    "percam_150": (21, 8, 0.2599, 16.6162),
    "f64_150": (150, 19939, 0.1340, 2.3412),
    "percam_300": (21, 31, 0.9718, 101.8903),
    "both_36": (14, 351, 1.7838, 40.5339),
    "both_pcg_36": (14, 356, 1.8879, 65.1932),
    "f64_pcg_36": (36, 5140, 0.1322, 0.7697),
    "dlt": (36, 5129, 0.1313, 0.9669),
}
# The models every run reads with K10's redesigned Cholesky kernel (two
# smokes of that tree on an NVIDIA H100 80GB HBM3 at 700 W read them to the
# digit, PERF.md section 6). The redesigns since (K2, K6's pnp_refine) keep
# every kernel's bits, so every run must read these exactly: a run that reads
# another fails the smoke.
MODELS_PINNED = {
    "reconstruct": (36, 5141, 0.1325, 0.7708),
    "rescue": (36, 5089, 0.1308, 0.8375),
    "pipeline": (150, 18529, 0.5724, 42.3094),
    "global": (36, 4817, 0.2267, 1.5463),
    "polish": (150, 19735, 0.1491, 47.3371),
    "orb": (36, 19316, 0.4208, 0.4525),
    "pipeline_huge": (235, 29097, 0.3227, 123.0414),
    "local_window": (168, 1017, 2.0439, 46.7649),
    "long_sequence": (300, 39093, 0.3736, 32.5732),
    "percam_150": (21, 8, 0.2638, 16.6172),
    "f64_150": (150, 18339, 0.2697, 10.4629),
    "percam_300": (21, 31, 0.9718, 101.8903),
    "both_36": (14, 352, 1.8564, 48.2575),
    "both_pcg_36": (14, 356, 1.8879, 65.1932),
    "f64_pcg_36": (36, 5140, 0.1322, 0.7697),
    "dlt": (36, 5121, 0.1307, 0.9704),
}
# The output directory of every run whose model log_model printed.
MODEL_DIRS: dict = {}
# The shape path d's engine launches K7 at most often: (rows, view slots,
# cameras, seed pairs on); 548 of its 660 launches on the card's table
# (PERF.md section 5).
PATH_D_TRIANGULATE = (1024, 19, 150, True)
# Its whole-table launch (27 of the 660, seed pairs off; path h's are 60 of
# 41,090 rows): the wrapper runs it a thread a row.
PATH_D_TABLE = (21267, 19, 150, False)
HUGE_MIN_CAMERA_SHARE = {"pipeline_huge": 0.95 * 235 / 300,
                         "long_sequence": 0.95 * 153 / 300}
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


def result(err, ms, plain_ms, moved, ops, library_ms=None, peak=PEAK_F32_PER_S,
           device_ms=None) -> dict:
    """A kernel phase's numbers. ``moved``: the bytes its function must move
    (each input read once, each output written once); ``ops``: the
    operations it does on this run's inputs (estimated from its loops);
    ``library_ms``: one PyTorch call computing the same function, if any;
    ``peak``: the operations' peak rate (float32, or float64 for the f64
    island's entries); ``device_ms``: the profiler's kernel time, where
    measured (``ms`` is the wrapper's, host work included)."""
    out = {"max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms, "bytes": int(moved),
           "ops": int(ops), "library_ms": library_ms, "peak": peak}
    if device_ms is not None:
        out["device_ms"] = device_ms
    return out


def bound(r: dict):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes = r["bytes"] / PEAK_BYTES_PER_S
    t_ops = r["ops"] / r.get("peak", PEAK_F32_PER_S)
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


def device_ms(torch, fn, reps: int = 10, warmup: int = 2, tries: int = 3, name: str = None):
    """The device time of ``fn`` a call: its kernels' durations summed over one
    ``torch.profiler`` trace of ``reps`` calls (the host's launch work left
    out, as ``time_ms`` keeps it in; only the kernels whose name holds
    ``name``, when given); None when ``tries`` traces hold no device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            path = Path(d) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        us = sum(e["dur"] for e in events if e.get("ph") == "X"
                 and e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")
                 and (name is None or name in e.get("name", "")))
        if us > 0:
            return us / 1e3 / reps
    return None


def median_ms(torch, fn, batches: int = 5, reps: int = 10) -> float:
    """The median over ``batches`` of ``time_ms``'s mean of ``reps`` calls: a
    wrapper whose host work is most of its time is timed against a library
    call this way, both sides alike, so that one stall of the host does not
    decide the comparison."""
    return float(sorted(time_ms(torch, fn, reps=reps) for _ in range(batches))[batches // 2])


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def coupling_ops(B, pvm) -> int:
    """The operations of K10's coupling on this data, B parameters a camera:
    5 B^2 for each of a point's slot pairs a <= b (the B x B block A_a M_b^T;
    its mirror is a copy), 60 B + 48 for each valid slot (M = Jc^T Jp, A = M
    Vinv, the k column Jc^T Jk - A Wk^T, its terms of Wk) and 140 for each
    point (Wk Vinv Wk^T)."""
    n = pvm.sum(1).long()
    return int(5 * B * B * (n * (n + 1) // 2).sum() + (60 * B + 48) * n.sum()
               + 140 * (n > 0).sum())


def time_damp(torch, S, lin, lam, perm, pvm, op, xc, xk):
    """K10's damping and back-substitution together as the LM loop calls them
    (one ``damp_workspace`` for the problem): (wrapper ms by CUDA events,
    device ms from the profiler)."""
    work = S.damp_workspace(lin)
    both = lambda: (S.schur_damp_cuda(lin, lam, perm, pvm, work),
                    S.schur_back_substitute_cuda(lin, op, xc, xk, perm, pvm))
    return median_ms(torch, both), device_ms(torch, both)


def damp_bytes(lin, op, perm, pvm, rhs_c, rhs_k, xc, xk, dp):
    """The bytes K10's damping and back-substitution must move: the damping
    reads the observations' Jacobians and ids, V, U, Uk, the gradients and
    writes Vinv, the diagonals and the rhs; the back-substitution reads the
    Jacobians, the grouping, Vinv, g_p and the step and writes dp."""
    obs = nbytes(lin.Jc, lin.Jk, lin.Jp, lin.obs_cam, lin.obs_point, lin.g_p)
    return (obs + nbytes(lin.V, lin.point_valid, lin.U, lin.Uk, lin.g_c, lin.g_k, op.Vinv,
                         op.lam_diag_c, op.lam_diag_k, rhs_c, rhs_k)
            + obs + nbytes(perm, pvm, op.Vinv, xc, xk, dp))


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
    call = lambda: match_top2_cuda(*args, mutual=True)
    ms, dev_ms = median_ms(torch, call), device_ms(torch, call)
    plain_ms = time_ms(torch, lambda: match_top2_plain(*args, mutual=True))
    idx_k, best_k, sec_k, back_k = match_top2_cuda(*args, mutual=True)
    # 2 K^2 D FMA-FLOP per pair: one product serves both directions.
    out = result(err, ms, plain_ms, nbytes(*args, idx_k, best_k, sec_k, back_k),
                 2 * B * K * K * D, device_ms=dev_ms)
    out["bmm_ms"] = bmm_ms(torch, args[0], args[2])
    log(f"K1 match_top2 {B} x {K} x {K} x {D}: wrapper {ms:.4f} ms, device {fmt_ms(dev_ms)}, "
        f"bound {bound(out)[0]:.4f} ms by {bound(out)[1]}; torch.bmm of the product alone in "
        f"f32 {out['bmm_ms']:.4f} ms (a reference, not the same function)")
    return out


def bmm_ms(torch, d1, d2) -> float:
    """``torch.bmm`` of K1's product alone, in full f32 (TF32 off): a reference
    beside the kernel, not a library call of the same function (no distance,
    top-2 or column argmin)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return median_ms(torch, lambda: torch.bmm(d1, d2.mT))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


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
    """K2 at 32 pairs x 512 hypotheses x 1,024 rows (one sweep chunk), scored
    on the first 256 rows: ``fmat_ransac`` (one launch) against its twins'
    composition -- the hypotheses against ``fmat_hypotheses_plain``, the
    winner against ``fmat_score_select_plain`` on the kernel's hypotheses,
    the refit and gates against ``fmat_refit_verify_plain`` from the kernel's
    winner and, both, against the float64 refit."""
    from sfm_tpu_torch.estimators.fundamental import (
        fmat_hypotheses_plain, fmat_ransac_cuda, fmat_ransac_plain, fmat_refit_verify_plain,
        fmat_score_select_plain)
    from sfm_tpu_torch.estimators.ransac import ransac_sample_indices
    from sfm_tpu_torch.geometry.epipolar import normalize_points, symmetric_epipolar_distance

    B, M, H, N, thr = 32, 1024, 512, 256, 3.0
    p1, p2, valid = (torch.as_tensor(a, device=dev) for a in two_view_batch(np, B, M)[:3])
    g = torch.Generator(device=dev).manual_seed(2)
    idx = ransac_sample_indices(valid, H, 8, g, prefix=True).contiguous()
    kargs = (p1, p2, valid, idx, thr, N)
    k = fmat_ransac_cuda(*kargs)
    Fs_k = k["Fs"]
    Fs = fmat_hypotheses_plain(p1, p2, idx).contiguous()
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
    log(f"  fmat_ransac's hypotheses at lambda_2 >= 1e-4 lambda_max: "
        f"{float((d_hyp[fair] <= 1e-4).float().mean()):.4%} of {int(fair.sum())} within 1e-4")
    check(int(well.sum()) >= 1000 and frac_h >= 0.99,
          f"K2 hypotheses: {frac_h:.4f} of {int(well.sum())} well-conditioned samples "
          "within 1e-4")
    log(f"K2 hypotheses: {frac_h:.4%} of {int(well.sum())}/{B * H} well-conditioned "
        f"samples within 1e-4, max difference there {float(d_hyp[well].max()):.3g}")
    # The winner, on the kernel's own hypotheses. Tolerance: the same winner,
    # or one whose score is within 1e-4 of the plain winner's (a tie under
    # another summation order of the error sum); the winner's count exact.
    sc = (p1[:, :N].contiguous(), p2[:, :N].contiguous(), valid[:, :N].contiguous())
    best_p, _ = fmat_score_select_plain(Fs_k, *sc, thr)
    errs = symmetric_epipolar_distance(Fs_k, sc[0][:, None], sc[1][:, None])
    inl = (errs < thr) & sc[2][:, None]
    counts = inl.sum(-1)
    score = counts.float() - torch.where(inl, errs, 0.0).sum(-1) / counts.clamp(min=1) / thr
    pick = lambda h: score.gather(1, h[:, None])[:, 0]
    gap = float((pick(best_p) - pick(k["best"])).abs().max())
    check(gap <= 1e-4, f"K2: winner score gap {gap}")
    check(torch.equal(k["count"], counts.gather(1, k["best"][:, None])[:, 0]), "K2: count")
    log(f"K2 winner: the same as the twin's in {int((k['best'] == best_p).sum())}/{B} pairs, "
        f"max score gap {gap:.3g}")
    # The refit from the kernel's winner, both sides on the same input.
    rp = fmat_refit_verify_plain(Fs_k, k["best"], p1, p2, valid, thr)
    rd = fmat_refit_verify_plain(Fs_k.double(), k["best"], p1.double(), p2.double(), valid, thr)
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
    d_f = float(dist(k["F"], rp["F"]).max())
    ek, ep = dist(k["F"].double(), rd["F"]), dist(rp["F"].double(), rd["F"])
    both = k["inliers"] & rp["inliers"]
    px = lambda r: float((r["errors"].double() - rd["errors"]).abs()[both].max())
    pk_, pp_ = px(k), px(rp)
    inl_eq = float((k["inliers"] == rp["inliers"]).float().mean())
    check(bool((ek <= torch.clamp(3 * ep, min=1e-4)).all()) and pk_ <= max(1e-2, 3 * pp_)
          and inl_eq >= 0.999, f"K2 refit: F to f64: kernel {float(ek.max())}, "
          f"twin {float(ep.max())}; inlier distances to f64: kernel {pk_} px, twin {pp_} px; "
          f"inliers equal on {inl_eq:.5f} of rows")
    check(torch.equal(k["accept"], rp["accept"]) and torch.equal(k["ok"], rp["ok"]),
          "K2 refit: accept differs")
    check(bool(k["accept"].any()), "K2 refit: no pair accepted")
    log(f"K2 refit: F max difference {d_f:.3g} (to the f64 refit: kernel "
        f"{float(ek.max()):.3g}, twin {float(ep.max()):.3g}); inlier rows' distances to the "
        f"f64 F's: kernel {pk_:.3g} px, twin {pp_:.3g} px; inliers equal on {inl_eq:.4%} of "
        f"{B * M} rows, accept equal on all {B} pairs ({int(k['accept'].sum())} accepted)")
    check_repeatable(torch, "K2 fmat_ransac", lambda: list(fmat_ransac_cuda(*kargs).values()),
                     list(k.values()))
    fn = lambda: fmat_ransac_cuda(*kargs)
    ms = median_ms(torch, fn)
    dev_ms = device_ms(torch, fn, name="fmat_ransac")
    plain_ms = time_ms(torch, lambda: fmat_ransac_plain(*kargs), reps=3, warmup=1)
    log(f"  fmat_ransac: wrapper {ms:.4f} ms, device {fmt_ms(dev_ms)} (plain torch "
        f"{plain_ms:.4f} ms)")
    # ~45 FLOP per (hypothesis, scored row): two lines, two distances; ~1.7
    # kFLOP a sample (A^T A 720, Cholesky ~330, 3 solves ~490, normalization
    # and denormalization ~150); the refit ~300 FLOP a row over its five
    # passes and ~3 kFLOP of thread 0's solve a pair.
    err = max(float(d_hyp[well].max()), d_f, gap)
    moved = nbytes(p1, p2, valid, idx) + sum(nbytes(v) for v in k.values())
    return result(err, ms, plain_ms, moved, 45 * B * H * N + 1700 * B * H + 300 * B * M + 3000 * B,
                  device_ms=dev_ms)


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
    octave = lambda: dog_extrema_scores_cuda(dogs[0], ct, et)["score"]
    check_repeatable(torch, "K4 dog_extrema", octave, octave())
    n = sum(int((dog_extrema_scores_cuda(d, ct, et)["score"] > 0).sum()) for d in dogs)
    log(f"K4 dog_extrema: bit-exact on {len(dogs)} octaves and repeatable, {n} extrema")
    ms = time_ms(torch, lambda: [dog_extrema_scores_cuda(d, ct, et) for d in dogs])
    plain_ms = time_ms(torch, lambda: [dog_extrema_scores_plain(d, ct, et) for d in dogs])
    # 26 compares per interior-layer pixel; the DoG read, the scores written.
    interior = sum(d[:, 1:-1].numel() for d in dogs)
    return result(0.0, ms, plain_ms, sum(nbytes(d) for d in dogs) + 4 * interior, 26 * interior)


def k5_moved_bytes(torch, canvas, grad_layer, x, y, sigma_rel, row_off, w_o, h_o) -> int:
    """The bytes K5's function must move on these inputs: each canvas element
    that the union of the keypoints' clamped 66 x 66 patches covers, read once
    (patches of nearby keypoints on one layer overlap), each keypoint's 7
    parameters read and its angle and 128-float descriptor written."""
    from sfm_tpu_torch.features.descriptor import _GPATCH, _patch_origin

    B, S, sumH, W = canvas.shape
    g0x, g0y = _patch_origin(x, y, w_o, h_o)
    r0 = torch.clamp(row_off + g0y, 0, sumH - _GPATCH)
    c0 = torch.clamp(g0x, 0, W - _GPATCH)
    lay = torch.clamp(grad_layer, 0, S - 1).to(torch.int64)
    b = torch.arange(B, device=canvas.device)[:, None].expand_as(r0)
    # A patch adds 1 over its rectangle as four corners of a difference array;
    # two prefix sums give each element's cover count.
    diff = torch.zeros((B, S, sumH + 1, W + 1), dtype=torch.int32, device=canvas.device)
    for dr, dc, sign in ((0, 0, 1), (0, _GPATCH, -1), (_GPATCH, 0, -1), (_GPATCH, _GPATCH, 1)):
        diff.index_put_((b, lay, r0 + dr, c0 + dc),
                        torch.full(r0.shape, sign, dtype=torch.int32, device=canvas.device),
                        accumulate=True)
    covered = int((diff.cumsum(2, dtype=torch.int32).cumsum(3, dtype=torch.int32) > 0).sum())
    return covered * canvas.element_size() + x.numel() * (7 * 4 + 129 * 4)


def phase_describe(torch, dev, images, cfg):
    """K5 on the selected keypoints and the canvas of one rendered image, and of
    the smoke's 12-image detection batch (path d's launch shape: 12 x 2,048
    keypoints); the batch's numbers are the row's, the one image's a case."""
    from sfm_tpu_torch.features.descriptor import (
        orientation_and_descriptor_canvas_cuda, orientation_and_descriptor_canvas_plain,
        orientation_near_tie)
    from sfm_tpu_torch.features.frontend import select_keypoints

    fc = cfg.features
    kw = dict(descriptor_scale=fc.descriptor_scale, clip=fc.descriptor_clip)
    rows = {}
    for what, ims in (("one image", images[:1]), (f"{images.shape[0]} images", images)):
        kp = select_keypoints(ims, None, fc)
        args = kp["describe"]
        kernel = lambda: orientation_and_descriptor_canvas_cuda(*args, **kw)
        ang_k, desc_k = kernel()
        ang_p, desc_p = orientation_and_descriptor_canvas_plain(*args, **kw)
        torch.cuda.synchronize()
        check_repeatable(torch, f"K5 sift_describe ({what})", kernel, (ang_k, desc_k))
        # Tolerance: >= 99.5% of valid keypoints within 1e-3 rad and 1e-3 L2
        # (the kernel's histograms are fixed-point sums, the twin's sequential
        # float sums); the rest must be orientation near-ties (the two largest
        # smoothed bins within 1%).
        valid = kp["valid"]
        d_ang = (ang_k - ang_p).abs() % (2 * math.pi)
        d_ang = torch.minimum(d_ang, 2 * math.pi - d_ang)
        ok = (d_ang <= 1e-3) & (torch.linalg.vector_norm(desc_k - desc_p, dim=-1) <= 1e-3)
        ties = orientation_near_tie(*args)
        nv = int(valid.sum())
        frac = float(ok[valid].float().mean())
        off = valid & ~ok
        check(nv >= 500 * ims.shape[0] and frac >= 0.995,
              f"K5 ({what}): {frac:.4f} of {nv} keypoints in tolerance")
        check(int((off & ~ties).sum()) == 0,
              f"K5 ({what}): a keypoint outside tolerance is no near-tie")
        err = float((desc_k - desc_p).abs()[valid & ok].max())
        log(f"K5 sift_describe ({what}): {frac:.4%} of {nv} valid keypoints in tolerance, "
            f"{int(off.sum())} outside (all orientation near-ties); a second launch "
            f"bit-identical")
        ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch, lambda: orientation_and_descriptor_canvas_plain(*args, **kw))
        # Bytes: the union of the keypoints' patches, their parameters and
        # outputs (k5_moved_bytes); operations: per keypoint ~512 samples of
        # ~40 FLOP for the orientation and again for the descriptor.
        K = valid.numel()
        moved = k5_moved_bytes(torch, *args)
        rows[what] = result(err, ms, plain_ms, moved, K * 512 * 80,
                            device_ms=device_ms(torch, kernel, name="sift_describe"))
        rows[what]["keypoints"] = K
        log(f"K5 sift_describe ({what}): {moved} bytes to move (the patches' union), "
            f"{K * (66 * 66 * 2 + 7 * 4 + 129 * 4)} counted a patch a keypoint")
        del kp, args, ang_k, desc_k, ang_p, desc_p
        torch.cuda.empty_cache()
    one, batch = rows.values()
    log(f"K5 sift_describe: {images.shape[0]} images ({batch['keypoints']} keypoints) "
        f"{batch['ms']:.4f} ms, device {fmt_ms(batch['device_ms'])}; one image "
        f"{one['ms']:.4f} ms, device {fmt_ms(one['device_ms'])}")
    batch["cases"] = {"one_image": {k: one[k] for k in ("ms", "plain_ms", "device_ms",
                                                        "keypoints", "max_abs_err")}}
    return batch


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
    worst, ms, dms, plain_ms, lib_ms, moved, ops = 0.0, 0.0, 0.0, 0.0, 0.0, 0, 0
    for lvl, im, _ in levels:
        k, p = orb_blur_cuda(im), orb_blur_plain(im)
        torch.cuda.synchronize()
        # Tolerance: bit-identical (the kernel rounds every product and sum
        # as the twin does, then to bf16 as torch does).
        err = float((k.float() - p.float()).abs().max())
        check(torch.equal(k.view(torch.int16), p.view(torch.int16)),
              f"K12 orb_blur level {lvl}: not bit-identical, max_abs_err {err}")
        worst = max(worst, err)
        log(f"K12 orb_blur level {lvl} {tuple(im.shape)}: bit-identical")
        ms += time_ms(torch, lambda: orb_blur_cuda(im))
        d = device_ms(torch, lambda: orb_blur_cuda(im))
        dms = None if None in (dms, d) else dms + d
        plain_ms += time_ms(torch, lambda: orb_blur_plain(im))
        lib_ms += time_ms(torch, lambda: F.conv2d(im[:, None], k2d, padding=r))
        # f32 in, bf16 out; two passes of 2r + 1 taps, a multiply and an add each.
        moved += nbytes(im, k)
        ops += 2 * 2 * (2 * r + 1) * im.numel()
    return result(worst, ms, plain_ms, moved, ops, library_ms=lib_ms, device_ms=dms)


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
    call = lambda: match_top2_cuda(*args, mutual=True)
    top2 = {"ms": median_ms(torch, call, batches=5, reps=3),
            "device_ms": device_ms(torch, call, reps=5),
            "plain_ms": time_ms(torch, lambda: match_top2_plain(*args, mutual=True), reps=3,
                                warmup=1),
            "bmm_ms": bmm_ms(torch, args[0], args[2])}
    tk = match_top2_cuda(*args, mutual=True)
    top2.update(bytes=nbytes(*args, *tk), ops=2 * B * K * K * D, max_abs_err=0.0)
    log(f"K1 match_top2 {B} x {K} x {K} x {D}: wrapper {top2['ms']:.4f} ms, device "
        f"{fmt_ms(top2['device_ms'])}, bound {bound(top2)[0]:.4f} ms by {bound(top2)[1]}; "
        f"torch.bmm of the product alone in f32 {top2['bmm_ms']:.4f} ms (a reference, not the "
        "same function)")
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
    check_repeatable(torch, "K1-r retrieval_score (D=256)", lambda: score_chunk_cuda(*args),
                     got)
    log(f"K1-r retrieval_score at D=256: counts identical on all {pairs.shape[0]} pairs; "
        f"counts {int(ref.min())}..{int(ref.max())}; a second launch bit-identical")
    return {"ms": time_ms(torch, lambda: score_chunk_cuda(*args)),
            "plain_ms": time_ms(torch, lambda: score_chunk_plain(*args)),
            "bytes": nbytes(pairs, desc, valid, got), "ops": 2 * pairs.shape[0] * S * S * 256,
            "max_abs_err": 0.0}


def _tensors(x):
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return [x] if hasattr(x, "is_cuda") else []


def check_repeatable(torch, what: str, fn, first):
    """A second launch of ``fn`` gives the same bits as ``first``: the
    kernels' scattered sums are order-free (``csrc/sfm_common.cuh``), so the
    engine's decisions do not move from run to run."""
    again = fn()
    torch.cuda.synchronize()
    a, b = _tensors(first), _tensors(again)
    check(len(a) == len(b) and all(torch.equal(_bits(torch, x), _bits(torch, y))
                                   for x, y in zip(a, b)),
          f"{what}: a second launch gave other bits")


def _bits(torch, x):
    """x's bit patterns (a NaN equals itself here, as torch.equal's does not)."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64, torch.float16: torch.int16}
    return x.view(ints[x.dtype]) if x.dtype in ints else x


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


def linearize_result(torch, what, call, args, lk, err, plain_ms, ops, peak=PEAK_F32_PER_S):
    """K8+K9's row: the wrapper's time (median of five means of 10, over the
    workspace made once, as ``run_ba`` calls it), the profiler's device time
    and the bound (each input read once, each output written once)."""
    ms, dev_ms = median_ms(torch, call), device_ms(torch, call)
    moved = nbytes(*(a for a in args if isinstance(a, torch.Tensor))) + sum(
        nbytes(getattr(lk, f)) for f in ("Jc", "Jk", "Jp", "rw", "V", "U", "Uk", "g_c", "g_k",
                                         "g_p"))
    out = result(err, ms, plain_ms, moved, ops, peak=peak, device_ms=dev_ms)
    log(f"{what}: wrapper {ms:.4f} ms, device {fmt_ms(dev_ms)}, bound {bound(out)[0]:.4f} ms "
        f"by {bound(out)[1]} (plain torch {plain_ms:.4f} ms)")
    return out


def cost_result(torch, what, call, plain, cargs, err):
    """K8's ``ba_cost`` (``_b10``): wrapper, device and bound; ~80 FLOP an
    observation (rotation, projection, Huber), its inputs read once."""
    ms, dev_ms = median_ms(torch, call), device_ms(torch, call)
    O = cargs[4].shape[0]
    out = result(err, ms, time_ms(torch, plain),
                 nbytes(*(a for a in cargs if isinstance(a, torch.Tensor))) + 8, 80 * O,
                 device_ms=dev_ms)
    log(f"{what}: wrapper {ms:.4f} ms, device {fmt_ms(dev_ms)}, bound {bound(out)[0]:.4f} ms "
        f"by {bound(out)[1]} (plain torch {out['plain_ms']:.4f} ms)")
    return out


def phase_ba(torch, np, dev, systems: dict):
    """K8+K9 (linearize + cost) and K10 (Schur coupling) on the 100-camera scene;
    its S and right-hand side go to ``systems`` for the dense solve's phase."""
    from sfm_tpu_torch.ba.residuals import total_huber_cost_cuda, total_huber_cost_plain
    from sfm_tpu_torch.ba.schur import (
        coobs_pairs, coupling_workspace, damp_operator, linearize_cuda, linearize_plain,
        linearize_workspace, schur_matrix_cuda, schur_matrix_plain)

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
    # The layout and scratch once, as run_ba makes them for its LM loop.
    lw = linearize_workspace(perm, pvm, obs_cam, obs_point, obs_w, C, P, 6, torch.float32)
    lk = linearize_cuda(*args, work=lw)
    lp = linearize_plain(*args)
    torch.cuda.synchronize()
    check_repeatable(torch, "K8+K9 ba_linearize", lambda: linearize_cuda(*args, work=lw), lk)
    check_repeatable(torch, "K8+K9 ba_linearize (its own layout)",
                     lambda: linearize_cuda(*args), lk)
    # Tolerance: the analytic Jacobians against torch.func.jacrev (an
    # independent derivation), 1e-4 of each tensor's largest entry; the
    # reductions (fixed-point sums against the twin's float sums) 1e-3.
    for name in lk._fields:
        x = getattr(lk, name)
        if x is not None and x.is_floating_point():
            check(bool(torch.isfinite(x).all()), f"K8: {name} not finite")
    errs = {f: _rel(getattr(lk, f), getattr(lp, f))
            for f in ("Jc", "Jk", "Jp", "rw", "V", "g_p", "U", "g_c", "Uk", "g_k")}
    for f, e in errs.items():
        check(e <= (1e-4 if f in ("Jc", "Jk", "Jp", "rw") else 1e-3), f"K8/K9: {f} rel err {e}")
    cargs = (rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy, obs_w, 2.0)
    ck, cp = total_huber_cost_cuda(*cargs), total_huber_cost_plain(*cargs)
    check_repeatable(torch, "K8 ba_cost", lambda: total_huber_cost_cuda(*cargs), ck)
    cost_err = abs(float(ck) - float(cp)) / float(cp)
    check(cost_err <= 1e-5, f"K8 ba_cost: rel err {cost_err}")
    log("K8+K9 ba_linearize: rel err " + ", ".join(f"{f} {e:.2g}" for f, e in errs.items())
        + f"; ba_cost rel err {cost_err:.2g} ({O} obs, {C} cams, {P} points)")
    plain_ms = time_ms(torch, lambda: linearize_plain(*args))
    # ~400 FLOP per observation (projection, analytic Jacobians, whitening, sums).
    k89 = linearize_result(torch, "K8+K9 ba_linearize", lambda: linearize_cuda(*args, work=lw),
                           args, lk, max(errs.values()), plain_ms, 400 * O)
    k89["cost"] = cost_result(torch, "K8 ba_cost", lambda: total_huber_cost_cuda(*cargs),
                              lambda: total_huber_cost_plain(*cargs), cargs, cost_err)

    op, rhs_c, rhs_k = damp_operator(lk, 1e-3, perm, pvm)
    # The layout and scratch once, as run_ba makes them for its LM loop.
    cw = coupling_workspace(lk, perm, pvm)
    coupling = lambda: schur_matrix_cuda(lk, op, perm, pvm, cw)
    Sk = coupling()
    Sp = schur_matrix_plain(lk, op, perm, pvm)
    torch.cuda.synchronize()
    check_repeatable(torch, "K10 schur_coupling", coupling, Sk)
    check_repeatable(torch, "K10 schur_coupling (its own layout)",
                     lambda: schur_matrix_cuda(lk, op, perm, pvm), Sk)
    rhs = torch.cat([rhs_c.reshape(-1), rhs_k])[:, None]
    solve = lambda S: torch.cholesky_solve(rhs, torch.linalg.cholesky(S))[:, 0]
    s_err = _rel(Sk, Sp)
    x_err = _rel(solve(Sk), solve(Sp))
    # Tolerance: S within 1e-4 of its largest entry (the kernel's fixed-point
    # sums against the twin's float sums); the solved step within 1e-2, since S's
    # condition number (100 cameras + the intrinsics column) multiplies that
    # difference (on an H100, a 5e-6 difference in S moved the step by 1.1e-3).
    check(bool(torch.isfinite(Sk).all()), "K10: S not finite")
    check(s_err <= 1e-4 and x_err <= 1e-2, f"K10: S rel err {s_err}, step rel err {x_err}")
    log(f"K10 schur_coupling: S ({Sk.shape[0]}^2) rel err {s_err:.2g}, solved step rel err "
        f"{x_err:.2g} (grouping {tuple(perm.shape)}; layout {cw.pairs.shape[0]} slot pairs, "
        f"{cw.items.shape[0]} target blocks)")
    ms = median_ms(torch, coupling)
    dev_ms = device_ms(torch, coupling)
    plain_ms = time_ms(torch, lambda: schur_matrix_plain(lk, op, perm, pvm))
    out = result(s_err, ms, plain_ms,
                 nbytes(lk.Jc, lk.Jk, lk.Jp, lk.obs_cam, lk.obs_point, op.Vinv, perm, pvm, Sk),
                 coupling_ops(6, pvm), device_ms=dev_ms)
    log(f"K10 schur_coupling: wrapper {ms:.4f} ms, device {fmt_ms(dev_ms)}, bound "
        f"{bound(out)[0]:.4f} ms by {bound(out)[1]}")
    systems["phase_ba"] = (Sk, rhs_c, rhs_k)
    return k89, out


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
    pairs on, 8 seed views), each case timed alone, then on a bucket of the
    shape path d's engine launches most (``PATH_D_TRIANGULATE``) and on one of
    its whole table's (``PATH_D_TABLE``); each case also on the layout the
    wrapper does not pick, which must give the same bits; then reproj_stats
    on the 2048-row table."""
    from sfm_tpu_torch.reconstruction.incremental import (
        reproj_stats_cuda, reproj_stats_plain, triangulate_cameras, triangulate_layout,
        triangulate_tracks_cuda, triangulate_tracks_plain)

    cases = (("bucket, seed pairs off", 2048, 36, 36, False, 2048),
             ("failures, seed pairs on", 1024, 36, 36, True, 1024),
             ("path d's bucket", *PATH_D_TRIANGULATE, 7),
             ("path d's whole table", *PATH_D_TABLE, 11))
    worst, ms, plain_ms, dev_ms, moved, ops = 0.0, 0.0, 0.0, 0.0, 0, 0
    rows = []
    for what, T, V, C, seed_on, seed in cases:
        view_img, view_xy, registered, rvec, tvec, K = track_scene(torch, np, dev, T, V=V, C=C,
                                                                   seed=seed)
        use = (view_img >= 0) & registered[view_img.long().clamp(min=0)]
        active = torch.ones(T, dtype=torch.bool, device=dev)
        args = (view_img, view_xy, use, active, rvec, tvec, K, 4.0, 0.0, 1, seed_on, 8)
        # The camera tensors once, as the engine makes them for a pass's buckets.
        cams = triangulate_cameras(rvec, tvec, K)
        kernel = lambda: triangulate_tracks_cuda(*args, cams=cams)
        pk, ok_k = kernel()
        check_repeatable(torch, f"K7 {what} (its own camera tensors)",
                         lambda: triangulate_tracks_cuda(*args), (pk, ok_k))
        layout = triangulate_layout(T, seed_on)
        other = lambda: triangulate_tracks_cuda(*args, cams=cams, layout=1 - layout)
        po, ok_o = other()
        pp, ok_p = triangulate_tracks_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(po.view(torch.int32), pk.view(torch.int32)) and torch.equal(ok_o, ok_k),
              f"K7 {what}: the two layouts differ")
        # Tolerance: ok equal in >= 99.5% of rows (another summation order
        # moves rows that sit on a gate); points of rows ok in both within 1e-3
        # relative.
        both = ok_k & ok_p
        mism = int((ok_k != ok_p).sum())
        err = float(((pk - pp).norm(dim=-1) / pp.norm(dim=-1).clamp(min=1.0))[both].max())
        check(mism <= 0.005 * T, f"K7 {what}: ok differs in {mism} of {T} rows")
        check(err <= 1e-3, f"K7 {what}: point rel err {err}")
        wrap = median_ms(torch, kernel)
        dk = device_ms(torch, kernel)
        dk_other = device_ms(torch, other)
        plain = time_ms(torch, lambda: triangulate_tracks_plain(*args))
        # Per row of L used views: L DLT rows (~100 FLOP each with their
        # reprojection), 8 4x4 inverse-iteration steps (~300); with seed pairs,
        # ~200 FLOP per pair of its first 8 views.
        L = use.sum(1).long()
        case = result(err, wrap, plain, nbytes(view_img, view_xy, use, active, rvec, tvec, pk,
                                               ok_k),
                      int((100 * L + 300).sum()) + (int((200 * L.clamp(max=8) ** 2).sum())
                                                    if seed_on else 0), device_ms=dk)
        b_ms, b_by = bound(case)
        log(f"K7 triangulate_tracks, {what} (T={T}, V={V}, C={C}, seed pairs {seed_on}): "
            f"{int(ok_p.sum())} ok, {mism} rows differ in ok, point rel err {err:.2g}; wrapper "
            f"{wrap:.4f} ms, device {fmt_ms(dk)} a {('warp', 'thread')[layout]} a row (a "
            f"{('warp', 'thread')[1 - layout]} a row: {fmt_ms(dk_other)}, the same bits), bound "
            f"{b_ms:.4f} ms by {b_by} (plain torch {plain:.4f} ms)")
        rows.append({"case": what, "shape": [T, V, C], "seed_pairs": seed_on, "ms": wrap,
                     "device_ms": dk, "layout": layout, "other_layout_device_ms": dk_other,
                     "plain_ms": plain, "bound_ms": b_ms, "max_abs_err": err})
        if what.startswith("path d"):
            continue
        # The kernel's row: the two buckets of the first design's smoke.
        worst = max(worst, err)
        ms, plain_ms = ms + wrap, plain_ms + plain
        dev_ms = None if dk is None or dev_ms is None else dev_ms + dk
        moved, ops = moved + case["bytes"], ops + case["ops"]
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
    out = result(worst, ms, plain_ms, moved, ops, device_ms=dev_ms)
    out["cases"] = rows
    return out


def phase_pnp(torch, np, dev):
    """K6's P3P round at B = 8 candidates x 2048 samples (8192 hypotheses) x N =
    2048: ``p3p_ransac`` (the samples' solve, the scoring and the winner in one
    launch) and its two halves alone, ``p3p_solve`` on gathered samples and
    ``pnp_score_select`` on given hypotheses, each against its twin and
    repeating bit for bit. Returns the rows ``pnp_ransac`` and
    ``pnp_score_select``."""
    from sfm_tpu_torch.estimators.pnp import (
        p3p_candidates, p3p_ransac_cuda, p3p_ransac_plain, p3p_solve_cuda, pnp_score_select_cuda,
        pnp_score_select_plain)
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
    idx3 = ransac_sample_indices(valid, iters, 3, g, prefix=True).contiguous()
    idx = idx3.reshape(B, -1)
    pn = (torch.cat([p2, torch.ones_like(p2[..., :1])], -1) @ torch.linalg.inv(K).mT)[..., :2]
    pn = pn.contiguous()
    take = lambda x: torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1])).reshape(
        B, iters, 3, x.shape[-1]).contiguous()
    s3, s2n = take(p3), take(pn)
    Rk, tk, okk = p3p_solve_cuda(s3, s2n)
    Rp, tp, okp = p3p_candidates(s3, s2n)
    rnd = lambda: p3p_ransac_cuda(p3, pn, p2, valid, idx3, K, thr)
    rk = rnd()
    rp = p3p_ransac_plain(p3, pn, p2, valid, idx3, K, thr)
    torch.cuda.synchronize()
    check_repeatable(torch, "K6 p3p_solve", lambda: p3p_solve_cuda(s3, s2n), (Rk, tk, okk))
    check_repeatable(torch, "K6 p3p_ransac", lambda: list(rnd().values()), list(rk.values()))
    # P3P in f32: the Durand-Kerner roots may come out in another order and
    # an ill-conditioned sample's poses move with rounding, so the candidate
    # slots are not compared one to one. Held, for p3p_solve and for the
    # round's poses: the count of valid candidates within 1% of the twin's;
    # each side's valid candidates interpolate their own sample (max
    # reprojection error of the 3 points <= 1 px) as often as the twin's do,
    # within 1 point of percentage; in >= 90% of the samples, every valid
    # pose of either side has one on the other within 1e-2; and below, the
    # selected pose and its inlier count.
    def interp_ok(Rc, tc, okc):
        pr, dep = project(s3[:, :, None], Rc[:, :, :, None], tc[:, :, :, None], K)
        px = take(p2)[:, :, None]                                     # (B, S, 1, 3, 2)
        e = ((pr - px).norm(dim=-1).amax(-1))                         # (B, S, 4)
        return float((e[okc] <= 1.0).float().mean()), int(okc.sum())

    def pose_checks(what, Rk, tk, okk):
        (fk, nk_ok), (fp, np_ok) = interp_ok(Rk, tk, okk), interp_ok(Rp, tp, okp)
        check(fk >= fp - 0.01, f"K6 {what}: {fk:.4f} of kernel candidates interpolate their "
              f"sample, twin {fp:.4f}")
        d = ((Rk[:, :, :, None] - Rp[:, :, None]).flatten(-2).norm(dim=-1)
             + (tk[:, :, :, None] - tp[:, :, None]).norm(dim=-1)
             / tp[:, :, None].norm(dim=-1).clamp(min=1.0))          # (B, S, 4k, 4p)
        big = torch.full_like(d, float("inf"))
        dk = torch.where(okp[:, :, None], d, big).amin(-1)
        dp = torch.where(okk[..., None], d, big).amin(-2)
        agree = {tol: float((torch.where(okk, dk <= tol, True).all(-1)
                             & torch.where(okp, dp <= tol, True).all(-1)).float().mean())
                 for tol in (1e-3, 1e-2)}
        check(abs(nk_ok - np_ok) <= 0.01 * np_ok,
              f"K6 {what}: {nk_ok} valid candidates, twin {np_ok}")
        check(agree[1e-2] >= 0.9, f"K6 {what}: candidate sets agree within 1e-2 in "
              f"{agree[1e-2]:.4f} of the samples")
        return (f"valid candidates kernel {nk_ok} / twin {np_ok}, interpolating their sample "
                f"{fk:.4%} / {fp:.4%}; candidate sets agree in {agree[1e-3]:.2%} (1e-3) / "
                f"{agree[1e-2]:.2%} (1e-2) of {B * iters} samples")

    solve_note = pose_checks("p3p_solve", Rk, tk, okk)
    round_note = pose_checks("p3p_ransac", rk["Rs"].reshape(Rk.shape), rk["ts"].reshape(tk.shape),
                             rk["ok"].reshape(okk.shape))
    # Tolerance, scoring (on the twin's hypotheses): the same winner, or one
    # whose score is within 1e-3 of the plain winner's (a tie up to the error
    # sum's order).
    H = iters * 4
    hyp = (Rp.reshape(B, H, 3, 3), tp.reshape(B, H, 3), okp.reshape(B, H))
    sargs = (*hyp, p3, p2, valid, K, thr)
    bk, ck = pnp_score_select_cuda(*sargs)
    bp, cp = pnp_score_select_plain(*sargs)
    check_repeatable(torch, "K6 pnp_score_select", lambda: pnp_score_select_cuda(*sargs),
                     (bk, ck))
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
    # The round end to end against its twin, as its halves are held above.
    Rsel_k = rk["Rs"][torch.arange(B), rk["best"]]
    Rsel_p = rp["Rs"][torch.arange(B), rp["best"]]
    cos = ((Rsel_k * Rsel_p).sum((-2, -1)) - 1.0) / 2.0
    ang_r = float(torch.arccos(cos.clamp(-1.0, 1.0)).max())
    dn_r = float(((rk["count"] - rp["count"]).abs().float() / rp["count"].float().clamp(min=1))
                 .max())
    check(ang_r <= 1e-2 and dn_r <= 0.01,
          f"K6 p3p_ransac end to end: rotation {ang_r} rad, count {dn_r}")
    log(f"K6 pnp_ransac: p3p_solve: {solve_note}; scoring: same winner in "
        f"{int((bk == bp).sum())}/{B} candidates, max score gap {gap:.3g}; end to end: selected "
        f"rotations within {ang:.3g} rad, inlier counts within {100 * dn:.3g}%; p3p_ransac: "
        f"{round_note}; its winner within {ang_r:.3g} rad of the twin's, inlier counts within "
        f"{100 * dn_r:.3g}%; all three repeat bit for bit")
    # Bounds. P3P: ~6 kFLOP a sample (30 Durand-Kerner steps on 4 roots, the
    # poses); scoring: ~25 FLOP per (hypothesis, valid correspondence), the
    # rows past a candidate's valid prefix left out (the function does not
    # score them).
    n_valid = int(valid.sum())
    round_ms = time_ms(torch, rnd)
    round_dev = device_ms(torch, rnd)
    round_plain = time_ms(torch, lambda: p3p_ransac_plain(p3, pn, p2, valid, idx3, K, thr))
    score_ms = time_ms(torch, lambda: pnp_score_select_cuda(*sargs))
    score_dev = device_ms(torch, lambda: pnp_score_select_cuda(*sargs))
    score_plain = time_ms(torch, lambda: pnp_score_select_plain(*sargs))
    log(f"K6 p3p_ransac: {round_ms:.4f} ms, device {fmt_ms(round_dev)}; pnp_score_select "
        f"{score_ms:.4f} ms, device {fmt_ms(score_dev)} ({n_valid} valid rows of {B * N})")
    small = 16 * B   # best and count
    return {
        "pnp_ransac": result(gap, round_ms, round_plain,
                             nbytes(idx3, p3, pn, p2, valid) + nbytes(*rk.values()),
                             6000 * B * iters + 25 * H * n_valid, device_ms=round_dev),
        "pnp_score_select": result(gap, score_ms, score_plain,
                                   nbytes(*hyp, p3, p2, valid) + small, 25 * H * n_valid,
                                   device_ms=score_dev)}


def phase_pnp_dlt(torch, np, dev):
    """K6's DLT branch on ``phase_pnp``'s scene: B = 8 candidates x N =
    2,048 correspondences, 2,048 samples of ``DLT_SAMPLE`` rows (one
    hypothesis each), 30% outliers: ``pnp_dlt_solve`` against its twin per
    hypothesis, then the whole branch (hypotheses, ``pnp_score_select``,
    ``pnp_refine``) kernel against twin."""
    from sfm_tpu_torch.estimators.pnp import (
        pnp_dlt_solve_cuda, pnp_dlt_solve_plain, pnp_refine_cuda, pnp_refine_plain,
        pnp_score_select_cuda, pnp_score_select_plain)
    from sfm_tpu_torch.estimators.ransac import ransac_sample_indices
    from sfm_tpu_torch.geometry.projection import project

    B, N, H, S, thr = 8, 2048, 2048, DLT_SAMPLE, 8.0
    p3, p2, valid, K, _, _, _ = pnp_scene(torch, np, dev, B, N, seed=3)
    g = torch.Generator(device=dev).manual_seed(4)
    idx = ransac_sample_indices(valid, H, S, g, prefix=True).to(torch.int32).contiguous()
    pn = ((torch.cat([p2, torch.ones_like(p2[..., :1])], -1) @ torch.linalg.inv(K).mT)[..., :2]
          .contiguous())
    hargs = (p3, pn, p2, idx, K)
    Rk, tk = pnp_dlt_solve_cuda(*hargs)
    Rp, tp = pnp_dlt_solve_plain(*hargs)
    torch.cuda.synchronize()
    check_repeatable(torch, "K6 pnp_dlt_solve", lambda: pnp_dlt_solve_cuda(*hargs), (Rk, tk))
    # Tolerance, per hypothesis: (R, t) within 1e-2 (t relative to max(1,
    # |t|)) in >= 90% of the hypotheses, as the P3P phase holds its samples.
    # Most samples hold an outlier, and such a junk pose is chaotic under
    # rounding (the GN damping 1e-4 is ~1e-10 of J^T J in f32; the JAX
    # reference and the twin, one algorithm, agree within 1e-2 on ~89-90% of
    # such hypotheses: tests/test_torch_pnp_dlt.py), so a hypothesis that
    # scores no consensus (< DLT_MIN_INLIERS inliers) on both sides, which
    # RANSAC discards either way, counts as agreeing; the hypotheses with a
    # consensus must agree on >= 95%.
    close = (((Rk - Rp).abs().amax((-2, -1)) <= 1e-2)
             & ((tk - tp).abs().amax(-1) <= 1e-2 * tp.abs().amax(-1).clamp(min=1.0)))

    def consensus(R, t):
        pr, dep = project(p3[:, None], R[:, :, None], t[:, :, None], K)
        return (((pr - p2[:, None]).norm(dim=-1) < thr) & (dep > 0) & valid[:, None]).sum(-1)

    junk = (consensus(Rk, tk) < DLT_MIN_INLIERS) & (consensus(Rp, tp) < DLT_MIN_INLIERS)
    agree, raw = float((close | junk).float().mean()), float(close.float().mean())
    held = float(close[~junk].float().mean())
    finite = torch.isfinite(Rk).all(-1).all(-1) & torch.isfinite(tk).all(-1)
    check(bool(finite[~junk].all()), "K6 pnp_dlt_solve: a hypothesis with a consensus is not "
          "finite")
    check(agree >= 0.9 and held >= 0.95 and int((~junk).sum()) > 0,
          f"K6 pnp_dlt_solve: {agree:.4f} of the hypotheses agree within 1e-2 (raw {raw:.4f}),"
          f" {held:.4f} of the {int((~junk).sum())} with a consensus")
    # The branch end to end: the refined winners within 1e-3 rad and 1e-3 of
    # |t|, inlier counts within 1, the same ok.
    ok = torch.ones((B, H), dtype=torch.bool, device=dev)
    mins = torch.full((B,), DLT_MIN_INLIERS, device=dev)
    ar = torch.arange(B, device=dev)

    def branch(solve, score, refine):
        Rs, ts = solve(*hargs)
        best, _ = score(Rs, ts, ok, p3, p2, valid, K, thr)
        return refine(Rs[ar, best].contiguous(), ts[ar, best].contiguous(), ok[ar, best],
                      p3, p2, valid, K, thr, mins, 10)

    ek = branch(pnp_dlt_solve_cuda, pnp_score_select_cuda, pnp_refine_cuda)
    ep = branch(pnp_dlt_solve_plain, pnp_score_select_plain, pnp_refine_plain)
    torch.cuda.synchronize()
    M = ek["R"].double().mT @ ep["R"].double()
    ang = float(torch.arccos(((M.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2).clamp(-1, 1))
                .max())
    t_err = float(((ek["t"] - ep["t"]).norm(dim=-1) / ep["t"].norm(dim=-1).clamp(min=1e-6))
                  .max())
    dn = int((ek["num_inliers"] - ep["num_inliers"]).abs().max())
    check(ang <= 1e-3 and t_err <= 1e-3 and dn <= 1 and torch.equal(ek["ok"], ep["ok"])
          and bool(ek["ok"].all()),
          f"K6 DLT branch: winners {ang} rad, t {t_err} rel, inliers {dn}, ok "
          f"{ek['ok'].tolist()} / {ep['ok'].tolist()}")
    nf_p = int((~(torch.isfinite(Rp).all(-1).all(-1) & torch.isfinite(tp).all(-1))).sum())
    log(f"K6 pnp_dlt_solve: {B} x {H} hypotheses of {S} rows ({int((~finite).sum())} not "
        f"finite, twin {nf_p}); {agree:.2%} agree within 1e-2 "
        f"(raw {raw:.2%}; {held:.2%} of the {int((~junk).sum())} with a consensus); branch end "
        f"to end: refined winners within {ang:.3g} rad and {t_err:.3g} of |t|, inlier counts "
        f"within {dn}, ok {ek['ok'].tolist()}")
    ms = time_ms(torch, lambda: pnp_dlt_solve_cuda(*hargs))
    plain_ms = time_ms(torch, lambda: pnp_dlt_solve_plain(*hargs), reps=3, warmup=1)
    # Per hypothesis: 2S rows of ~12 + 156 FLOP into the normal matrix, the
    # 12 x 12 Cholesky (~700), 8 inverse-iteration steps (~2 x 144 + 36
    # each), two decompositions (12 Newton-Schulz steps of ~110, the 3x3
    # eigenvector ~150, S depths of 7), two GN steps (rodrigues and its
    # derivatives ~350, S rows of ~230, the 6x6 solve ~150), the output
    # rodrigues ~60.
    ops = B * H * (2 * S * 168 + 700 + 8 * 324 + 2 * (12 * 110 + 150 + 7 * S)
                   + 2 * (350 + 230 * S + 150) + 60)
    return result(float(torch.where(close, (Rk - Rp).abs().amax((-2, -1)), 0.0).max()), ms,
                  plain_ms, nbytes(p3, pn, p2, idx, Rk, tk), ops)


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
    check_repeatable(torch, "K1-r retrieval_score", lambda: score_chunk_cuda(*args), got)
    log(f"K1-r retrieval_score: counts equal on {frac:.2%} of {pairs.shape[0]} pairs, max "
        f"difference {int(diff.max())}; counts {int(ref.min())}..{int(ref.max())}; a second "
        f"launch bit-identical")
    # Tie-heavy: +-1/16 descriptors (every dot product exact, so the counts are
    # the twin's exactly) with rows repeated across the kernels' tile edges.
    t_desc, t_valid = tie_heavy_table(torch, dev, N, S)
    t_args = (pairs, t_desc, t_valid, 0.75)
    t_got, t_ref = score_chunk_cuda(*t_args), score_chunk_plain(*t_args)
    torch.cuda.synchronize()
    check(torch.equal(t_got, t_ref), f"K1-r tie-heavy: counts differ on "
          f"{int((t_got != t_ref).sum())} of {pairs.shape[0]} pairs")
    check_repeatable(torch, "K1-r retrieval_score (tie-heavy)",
                     lambda: score_chunk_cuda(*t_args), t_got)
    log(f"K1-r retrieval_score, tie-heavy: counts identical on all {pairs.shape[0]} pairs; "
        f"counts {int(t_ref.min())}..{int(t_ref.max())}")
    kernel = lambda: score_chunk_cuda(*args)
    ms = time_ms(torch, kernel)
    plain_ms = time_ms(torch, lambda: score_chunk_plain(*args))
    # 2 S^2 D FMA-FLOP per pair; the descriptor table read once.
    return result(float(diff.max()), ms, plain_ms, nbytes(pairs, desc, valid, got),
                  2 * pairs.shape[0] * S * S * desc.shape[-1],
                  device_ms=device_ms(torch, kernel, name="retrieval_"))


def tie_heavy_table(torch, dev, N: int, S: int, D: int = 128, step: int = 40, seed: int = 7):
    """(N, S, D) +-1/16 descriptors along a strip, as :func:`corridor_descriptors`
    (image k draws rows step*k .. step*k + S - 1 of one table in a shuffled
    order), with rows repeated across the tile edges of both K1-r designs
    (63 / 64, 127 / 128, 191 / 192, and 255 / 0); 10% invalid. Every dot
    product is a multiple of 1/256, exact in float32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.where(torch.rand(step * N + S, D, generator=g, device=dev) < 0.5, -1.0,
                       1.0) / 16.0
    ids = torch.arange(S, device=dev)[None] + step * torch.arange(N, device=dev)[:, None]
    ids = torch.gather(ids, 1, torch.argsort(torch.rand(N, S, generator=g, device=dev), dim=1))
    for a, b in ((63, 64), (127, 128), (191, 192), (0, 255)):
        if b < S:
            ids[::2, b] = ids[::2, a]
    return base[ids].contiguous(), torch.rand(N, S, generator=g, device=dev) > 0.1


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
    from sfm_tpu_torch.features.pyramid import build_pyramid_cuda, build_pyramid_plain

    fc = cfg.features
    kw = dict(num_octaves=fc.num_octaves, scales_per_octave=fc.scales_per_octave,
              sigma0=fc.sigma0, assumed_blur=fc.assumed_blur, upsample=fc.upsample_first_octave)
    call = lambda: build_pyramid_cuda(images, **kw)
    gk, dk = call()
    gp, dp = build_pyramid_plain(images, **kw)
    torch.cuda.synchronize()
    check(tuple(dk[0].shape[-2:]) == (1536, 2048), f"octave -1 is {tuple(dk[0].shape)}")
    # Tolerance: bit-identical on every octave's Gaussian and DoG layers (the
    # kernel rounds every product and sum as the twin does), and the same
    # bits on a second launch.
    for o, (a, b, c, d) in enumerate(zip(gk, gp, dk, dp)):
        check(torch.equal(a, b) and torch.equal(c, d),
              f"K3 pyramid octave {o - 1}: not bit-identical to the twin (max |dG| "
              f"{float((a - b).abs().max()):.3g}, |dDoG| {float((c - d).abs().max()):.3g})")
    check_repeatable(torch, "K3 pyramid", call, (gk, dk))
    log(f"K3 pyramid: bit-identical on {images.shape[0]} images x {len(dk)} octaves, repeatable")
    ms = median_ms(torch, call)
    dms = device_ms(torch, call)
    plain_ms = time_ms(torch, lambda: build_pyramid_plain(images, **kw), reps=3, warmup=1)
    lib_ms = median_ms(torch, lambda: pyramid_conv2d(torch, images, **kw))
    log(f"  K3 pyramid: wrapper {ms:.4f} ms, device {fmt_ms(dms)} (plain torch {plain_ms:.4f} ms, "
        f"the same layers as F.conv2d calls {lib_ms:.4f} ms)")
    # The images in, every Gaussian and DoG layer out; ~76 FLOP per Gaussian
    # pixel (two separable passes of ~19 taps, a multiply and an add each).
    return result(0.0, ms, plain_ms, nbytes(images, *gk, *dk),
                  76 * sum(g.numel() for g in gk), library_ms=lib_ms, device_ms=dms)


def pyramid_conv2d(torch, image, num_octaves, scales_per_octave, sigma0, assumed_blur, upsample):
    """K3's pyramid with every Gaussian layer as library convolutions: each
    separable blur as two float32 ``F.conv2d`` calls (a row and a column of
    taps, zero padding), the octaves' decimation and the DoG differences as
    the twin takes them. Timed as K3's library call; its sums run in
    cuDNN's order, so it is not the twin's bits."""
    import torch.nn.functional as F

    from sfm_tpu_torch.features.pyramid import (_blur_radius, _blur_sigmas, _gaussian_taps,
                                                upsample2x)

    def blur(x, sigma):
        r = _blur_radius(sigma)
        k = torch.as_tensor(_gaussian_taps(sigma, r), device=x.device)
        B, H, Wd = x.shape
        x = F.conv2d(x.reshape(B, 1, H, Wd), k.reshape(1, 1, 1, -1), padding=(0, r))
        return F.conv2d(x, k.reshape(1, 1, -1, 1), padding=(r, 0)).reshape(B, H, Wd)

    S = scales_per_octave
    blurs = _blur_sigmas(S, sigma0, assumed_blur, upsample)
    img = image.to(torch.float32)
    if upsample:
        img = upsample2x(img)
    base = blur(img, blurs[0])
    gaussians, dogs = [], []
    for _ in range(num_octaves):
        layers = [base]
        for i in range(1, S + 3):
            layers.append(blur(layers[-1], blurs[i]))
        g = torch.stack(layers, dim=1)
        gaussians.append(g)
        dogs.append(g[:, 1:] - g[:, :-1])
        base = layers[S][..., ::2, ::2].contiguous()
    return gaussians, dogs


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

    worst, ms, plain_ms, moved, ops, dms = 0.0, 0.0, 0.0, 0, 0, []
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
        check_repeatable(torch, f"K6 pnp_refine B={B}",
                         lambda: list(pnp_refine_cuda(*args).values()), list(k.values()))
        ms += time_ms(torch, lambda: pnp_refine_cuda(*args))
        dms.append(device_ms(torch, lambda: pnp_refine_cuda(*args), name="pnp_refine"))
        log(f"  pnp_refine B={B} N={N}: device {fmt_ms(dms[-1])}")
        plain_ms += time_ms(torch, lambda: pnp_refine_plain(*args))
        # 20 steps of ~250 FLOP per weighted row (6 tangents, 27 sums), three
        # passes of ~30 FLOP per row for the weights and the final errors.
        moved += nbytes(*args[:6]) + sum(nbytes(v) for v in k.values())
        ops += 20 * 250 * int(k["num_inliers"].sum()) + 3 * 30 * B * N
    return result(worst, ms, plain_ms, moved, ops,
                  device_ms=None if None in dms else sum(dms))


# Path d's largest reduced camera system: 150 cameras of 6 parameters and the
# 4 shared intrinsics.
DENSE_SOLVE_N = 6 * 150 + 4
# The largest S the dense route can see: ba.use_dense_schur_below (256)
# cameras at B = 6 and B = 10.
DENSE_CAP_N = (6 * 256 + 4, 10 * 256 + 4)
# Two n past the default cap (a larger ba.use_dense_schur_below): past 24
# rows a block on 132 SMs (3,167), where a block runs several row groups,
# and past the kernel's shared-memory z (5,376).
DENSE_PAST_N = (10 * 400 + 4, 6 * 900 + 4)
# The H100 SXM's float64 peak on the tensor cores (DMMA, full IEEE double;
# NVIDIA's data sheet): a Cholesky's n^3 / 3 is rank-k products, which run
# there (as cuSOLVER's dpotrf does), so the f64 solve's bound takes this rate.
PEAK_F64_TC_PER_S = 67e12


def synthetic_spd(torch, np, dev, n, dt, seed):
    """An exactly symmetric positive definite S (DENSE_SOLVE_N's generator:
    a a^T / n + I, eigenvalues in [1, 5]) and a right-hand side as (C, B)
    and (4,)."""
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(rng.standard_normal((n, n)), dtype=dt, device=dev) / n ** 0.5
    M = a @ a.T
    S = ((M + M.T) / 2 + torch.eye(n, dtype=dt, device=dev)).contiguous()
    rhs = torch.as_tensor(rng.standard_normal(n), dtype=dt, device=dev)
    return S, rhs[:-4].reshape(-1, 2 if (n - 4) % 6 else 6), rhs[-4:]


# The kernel against its twin: eps of the type (section above).
TWIN_ULPS = 4


def dense_solve_case(torch, np, dev, tag, S, rhs_c, rhs_k):
    """K10's ``schur_cholesky_solve`` on one S (a copy a call: the float64
    route factors in place) against its twin, cuSOLVER and a float64 solve;
    bitwise repeats; the wrapper's, the kernel's device, the twin's and
    cuSOLVER's times.
    Tolerances: the kernel's error against the float64 solve of S's lower
    triangle (the part both factorizations read) at most twice cuSOLVER's,
    plus 1e-6 in float32 and 1e-12 in float64: S's condition number
    multiplies both solves' rounding, so an absolute bound would not hold
    (on an H100 a 5e-6 change in phase_ba's S moved its step by 1.1e-3).
    And the kernel against its twin: in float32 both round a float64
    solution once, so they differ only where the two straddle a rounding
    boundary, at most ``TWIN_ULPS`` float32 eps of the largest entry (a
    float32 factor would be off by cuSOLVER's error, 7e-7 to 5e-5 here); in
    float64 their sums' orders differ, which the condition number
    magnifies as it does any float64 solve: at most twice cuSOLVER's error
    against the float64 solve plus ``TWIN_ULPS`` float64 eps."""
    from sfm_tpu_torch.ba.schur import _EPS, dense_solve_cuda, dense_solve_plain

    n, dt = S.shape[0], S.dtype
    f64 = dt == torch.float64
    cat = lambda xc, xk: torch.cat([xc.reshape(-1), xk])
    rhs = cat(rhs_c, rhs_k)
    kernel = lambda: dense_solve_cuda(S.clone(), rhs_c, rhs_k)
    eye = torch.eye(n, dtype=dt, device=dev)

    def cusolver():
        L, info = torch.linalg.cholesky_ex(S + _EPS * eye)
        return torch.cholesky_solve(rhs[:, None], L)[:, 0], info

    xk_ = kernel()
    x_k = cat(*xk_)
    x_t = cat(*dense_solve_plain(S, rhs_c, rhs_k))
    x_l, info = cusolver()
    torch.cuda.synchronize()
    check_repeatable(torch, f"K10 schur_cholesky_solve {tag}", kernel, xk_)
    low = torch.tril(S).double()
    Se = low + torch.tril(low, -1).mT + float(torch.tensor(_EPS, dtype=dt)) * eye.double()
    ref = torch.linalg.solve(Se, rhs.double())
    err = lambda x: float((x.double() - ref).abs().max() / ref.abs().max())
    e_k, e_t, e_l = err(x_k), err(x_t), err(x_l)
    e_kt = _rel(x_k, x_t)
    check(int(info) == 0 and bool(torch.isfinite(x_k).all())
          and e_k <= 2 * e_l + (1e-12 if f64 else 1e-6),
          f"K10 schur_cholesky_solve {tag}: error {e_k:.3g} against the float64 solve, "
          f"cuSOLVER's {e_l:.3g} (info {int(info)}), the twin's {e_t:.3g}")
    kt_bound = TWIN_ULPS * torch.finfo(dt).eps + (2 * e_l if f64 else 0.0)
    check(e_kt <= kt_bound,
          f"K10 schur_cholesky_solve {tag}: the kernel is {e_kt:.3g} off its twin "
          f"(bound {kt_bound:.3g})")
    ms = median_ms(torch, kernel)
    clone_ms = median_ms(torch, lambda: S.clone())
    dms = device_ms(torch, kernel, name="cholesky_kernel")
    plain_ms = time_ms(torch, lambda: dense_solve_plain(S, rhs_c, rhs_k), reps=1, warmup=0)
    lib_ms = median_ms(torch, cusolver)
    r = result(e_k, ms, plain_ms, nbytes(S, rhs_c, rhs_k, x_k), n ** 3 // 3 + 2 * n * n,
               library_ms=lib_ms, peak=PEAK_F64_TC_PER_S if f64 else PEAK_F32_PER_S,
               device_ms=dms)
    r.update(n=n, dtype=str(dt)[6:], err_cusolver=e_l, err_twin=e_t, kernel_vs_twin=e_kt,
             clone_ms=clone_ms)
    b_ms, b_by = bound(r)
    log(f"K10 schur_cholesky_solve {tag} (n = {n}, {str(dt)[6:]}): error against the float64 "
        f"solve {e_k:.3g} (cuSOLVER {e_l:.3g}, twin {e_t:.3g}; kernel to twin {e_kt:.3g}); "
        f"wrapper {ms:.4f} ms (the copy of S it factors included: {clone_ms:.4f} ms), device "
        f"{fmt_ms(dms)}, twin {plain_ms:.4f} ms, cuSOLVER (cholesky_ex + cholesky_solve) "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}")
    return r


def dense_solve_nan(torch, np, dev, dt):
    """A non-positive-definite S (a negative pivot in the last panel) gives
    an all-NaN step from the kernel and from the twin."""
    from sfm_tpu_torch.ba.schur import dense_solve_cuda, dense_solve_plain

    S, rhs_c, rhs_k = synthetic_spd(torch, np, dev, DENSE_SOLVE_N, dt, 17)
    S[DENSE_SOLVE_N - 3, DENSE_SOLVE_N - 3] = -5.0
    for name, fn in (("kernel", lambda: dense_solve_cuda(S.clone(), rhs_c, rhs_k)),
                     ("twin", lambda: dense_solve_plain(S, rhs_c, rhs_k))):
        xc, xk = fn()
        check(bool(xc.isnan().all()) and bool(xk.isnan().all()),
              f"K10 schur_cholesky_solve, {str(dt)[6:]}: the {name} gave a step for an S "
              f"that is not positive definite")


def phase_dense_solve(torch, np, dev, systems: dict):
    """K10's dense solve (``ba/schur.py::dense_solve``: the kernel
    ``schur_cholesky_solve`` / ``_f64``) on four kinds of S: the synthetic S
    at path d's largest size (``DENSE_SOLVE_N``), the real S that
    ``phase_ba`` assembles (n = 604), the real S of ``phase_island`` on each
    route (``systems``), and synthetic S at the dense route's cap sizes
    (``DENSE_CAP_N``) and past them (``DENSE_PAST_N``) in both types; then
    the NaN rule in both. Returns the
    two rows' results (the float row at ``DENSE_SOLVE_N``, the double row on
    the f64 route's real S), each with every case."""
    cases = {"synthetic": synthetic_spd(torch, np, dev, DENSE_SOLVE_N, torch.float32, 16)}
    cases.update(systems)
    for n in DENSE_CAP_N + DENSE_PAST_N:
        for dt in (torch.float32, torch.float64):
            tag = f"{'cap' if n in DENSE_CAP_N else 'past'}_{n}_{str(dt)[6:]}"
            cases[tag] = synthetic_spd(torch, np, dev, n, dt, n)
    out = {tag: dense_solve_case(torch, np, dev, tag, *sys_) for tag, sys_ in cases.items()}
    for dt in (torch.float32, torch.float64):
        dense_solve_nan(torch, np, dev, dt)
    log("K10 schur_cholesky_solve: a non-positive-definite S gives an all-NaN step from the "
        "kernel and the twin, float and double")
    torch.cuda.empty_cache()
    f32, f64 = dict(out["synthetic"]), dict(out["f64"])
    f32["cases"] = {k: v for k, v in out.items() if v["dtype"] == "float32"}
    f64["cases"] = {k: v for k, v in out.items() if v["dtype"] == "float64"}
    return f32, f64


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

    worst, ms, plain_ms, lib_ms, moved, ops, dev_ms = 0.0, 0.0, 0.0, 0.0, 0, 0, 0.0
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
        check_repeatable(torch, f"K10 schur_damp C={C}",
                         lambda: schur_damp_cuda(lin, lam, perm, pvm), (opk, rck, rkk))
        # Tolerance: rhs_c / rhs_k within 1e-3 relative (the kernel's camera
        # sums are fixed-point, the twin's float); Vinv within 1e-4 of each block's largest
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
        from sfm_tpu_torch.ba import schur as S

        dk, dd = time_damp(torch, S, lin, lam, perm, pvm, opk, xc, xk)
        dpl = time_ms(torch, lambda: schur_damp_plain(lin, lam))
        bpl = time_ms(torch, lambda: schur_back_substitute_plain(lin, opk, xc, xk))
        inv_ms = median_ms(torch, lambda: torch.linalg.inv(Vd))
        # Damping: ~60 FLOP a point (scaling, adjugate), ~60 an observation
        # (h_p, y_o, Jc^T y, Jk^T y). Back-substitution: ~64 an observation, 18 a point.
        moved_c = damp_bytes(lin, opk, perm, pvm, rck, rkk, xc, xk, dpk)
        ops_c = 60 * P + 60 * O + 64 * O + 18 * P
        b_ms, b_by = bound({"bytes": moved_c, "ops": ops_c})
        log(f"  C={C}: schur_damp + schur_back_substitute wrapper {dk:.4f} ms, device "
            f"{fmt_ms(dd)} (plain torch {dpl + bpl:.4f} ms; torch.linalg.inv of the damped "
            f"point blocks alone {inv_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by})")
        ms, plain_ms, lib_ms = ms + dk, plain_ms + dpl + bpl, lib_ms + inv_ms
        dev_ms = None if dd is None or dev_ms is None else dev_ms + dd
        moved, ops = moved + moved_c, ops + ops_c

    # One LM run on the card against the twins on the host: the final costs
    # within 1e-3 relative (the sums round differently, which may flip an
    # accept at convergence, so the iteration counts are not compared); a
    # second run on the card must repeat the first bit for bit.
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
    out_k, st_k = run_ba(prob, cfg)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    out_k2, st_k2 = run_ba(prob, cfg)
    check(st_k2 == st_k and all(torch.equal(a, b) for a, b in zip(out_k, out_k2)
                                if a is not None),
          "K10 run_ba: a second run on the card gave another result")
    t0 = time.perf_counter()
    _, st_p = run_ba(BAProblem(*(None if x is None else x.cpu() for x in prob)), cfg)
    t_host = time.perf_counter() - t0
    cost_err = abs(st_k["final_cost"] - st_p["final_cost"]) / st_p["final_cost"]
    check(cost_err <= 1e-3 and st_k["final_cost"] < 0.5 * st_k["initial_cost"],
          f"K10 run_ba: final cost {st_k['final_cost']} vs twin {st_p['final_cost']}")
    log(f"K10 run_ba C={C} O={O}: final cost {st_k['final_cost']:.6g} (card, {t_card:.2f} s) vs "
        f"{st_p['final_cost']:.6g} (twins on the host, {t_host:.2f} s), rel {cost_err:.2g}; "
        f"{st_k['iterations']} / {st_p['iterations']} iterations")
    return result(worst, ms, plain_ms, moved, ops, library_ms=lib_ms, device_ms=dev_ms)


# K11 with K10's block-Jacobi inverses: the PCG path of BA past
# use_dense_schur_below cameras.
K11_CAMS, K11_POINTS, K11_OBS_PER_CAM = 300, 60000, 2000
K11_PINNED = tuple(range(7, 300, 15))      # 20 unregistered cameras


def pcg_system(torch, np, dev, n_cams, n_pts, obs_per_cam, seed, pinned):
    """``ba_scene``'s problem with the ``pinned`` cameras unregistered (their
    observations excluded, their entries pinned by the damping) and camera 0
    fixed, linearized on the card as ``run_ba`` does (intrinsics optimized,
    with their regularization): (Linearization, perm, perm_valid)."""
    from sfm_tpu_torch.ba.lm import _intr_reg
    from sfm_tpu_torch.ba.schur import coobs_pairs, linearize_cuda

    rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy = ba_scene(
        torch, np, dev, n_cams=n_cams, n_pts=n_pts, obs_per_cam=obs_per_cam, seed=seed)
    C, P = rvec.shape[0], pts.shape[0]
    cam_valid = torch.ones(C, dtype=torch.bool, device=dev)
    cam_valid[list(pinned)] = False
    cam_free = cam_valid.float()
    cam_free[0] = 0.0
    obs_w = cam_valid[obs_cam.long()].float()
    perm, pvm = coobs_pairs(obs_point.cpu().numpy(), obs_w.cpu().numpy() > 0)
    perm, pvm = torch.as_tensor(perm, device=dev), torch.as_tensor(pvm, device=dev)
    _, Hreg, greg = _intr_reg(intr, intr, 0.1)
    lin = linearize_cuda(rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy, obs_w, cam_free,
                         torch.ones(P, dtype=torch.bool, device=dev), perm, pvm, 2.0, True,
                         Hreg.contiguous(), greg.contiguous())
    return lin, perm, pvm


def time_matvec(torch, S, lin, op, xc, xk, perm, pvm):
    """K11's matvec as the PCG loop calls it (one ``matvec_workspace`` for
    the problem): (wrapper ms, the median of five means of 10; device ms,
    the profiler's)."""
    work = S.matvec_workspace(lin, perm, pvm)
    mv = lambda: S.schur_matvec_cuda(lin, op, xc, xk, perm, pvm, work)
    return median_ms(torch, mv), device_ms(torch, mv)


def time_pcg(torch, S, lin, op, rhs_c, rhs_k, perm, pvm, iters, tol):
    """One PCG solve as ``run_ba`` runs it (the matvec's workspace made once):
    (wrapper ms, device ms) as ``time_matvec``."""
    work = S.matvec_workspace(lin, perm, pvm)
    run = lambda: S.pcg_solve_cuda(lin, op, rhs_c, rhs_k, perm, pvm, iters, tol, work)
    return median_ms(torch, run, batches=3, reps=3), device_ms(torch, run, reps=3)


def point_major(torch, S, lin, perm, pvm):
    """``lin`` with its observations sorted by point, stably (the engine's
    layout: a track's views side by side), and the grouping of the sorted
    observations. A point's observations keep their order, so K11's sums
    see the same terms in the same slot order."""
    valid = torch.zeros(lin.Jc.shape[0], dtype=torch.bool, device=perm.device)
    valid[perm[pvm].long()] = True
    order = torch.argsort(lin.obs_point, stable=True)
    lin2 = lin._replace(**{f: getattr(lin, f)[order].contiguous()
                           for f in ("Jc", "Jk", "Jp", "rw", "obs_cam", "obs_point")})
    p2, v2 = S.coobs_pairs(lin2.obs_point.cpu().numpy(), valid[order].cpu().numpy())
    return lin2, torch.as_tensor(p2, device=perm.device), torch.as_tensor(v2, device=perm.device)


def matvec_point_major(torch, S, lin, op, xc, xk, perm, pvm, first, tag):
    """K11's matvec on ``lin`` in point-major order: the same bits as
    ``first`` (the same terms, slot orders and shifts), and its times as
    ``time_matvec``'s."""
    lin2, p2, v2 = point_major(torch, S, lin, perm, pvm)
    again = S.schur_matvec_cuda(lin2, op, xc, xk, p2, v2)
    torch.cuda.synchronize()
    check(all(torch.equal(_bits(torch, a), _bits(torch, b)) for a, b in zip(again, first)),
          f"K11 schur_matvec {tag}: point-major order gave other bits")
    return time_matvec(torch, S, lin2, op, xc, xk, p2, v2)


def _block_rel(A, B):
    """Per block: max |A - B| over max |B|."""
    return (A - B).flatten(1).abs().amax(1) / B.flatten(1).abs().amax(1).clamp(min=1e-30)


def phase_pcg(torch, np, dev):
    """K10's ``schur_block_jacobi`` and K11's ``schur_matvec`` and
    ``pcg_init`` / ``pcg_step`` on the 300-camera / 60k-point /
    600k-observation scene, 20 cameras pinned, against their twins."""
    from sfm_tpu_torch.ba import schur as S

    lam = 1e-3
    lin, perm, pvm = pcg_system(torch, np, dev, K11_CAMS, K11_POINTS, K11_OBS_PER_CAM, 300,
                                K11_PINNED)
    C, P, O = lin.U.shape[0], lin.V.shape[0], lin.Jc.shape[0]
    op, rhs_c, rhs_k = S.damp_operator(lin, lam, perm, pvm)
    Mc, Mk = S.block_jacobi_cuda(lin.U, op.lam_diag_c, lin.Uk, op.lam_diag_k)
    Mc_p, Mk_p = S.block_jacobi_plain(lin.U, op.lam_diag_c, lin.Uk, op.lam_diag_k)
    torch.cuda.synchronize()
    # Tolerance: both inverses held against the f64 inverse of the same f32
    # blocks; the damped camera blocks' condition numbers reach ~1e5, so an
    # f32 inverse is only good to cond x 6e-8 of it whichever way it
    # eliminates. Each kernel block within max(1e-4, 4x the twin's LU error);
    # the pinned blocks the identity within 1e-6.
    eye6 = torch.eye(6, device=dev, dtype=torch.float64)
    Ud = lin.U.double() + op.lam_diag_c.double()[..., None] * eye6 + 1e-10 * eye6
    truth = torch.linalg.inv(Ud)
    e_k, e_p = _block_rel(Mc.double(), truth), _block_rel(Mc_p.double(), truth)
    Uk_d = (lin.Uk + torch.diag(op.lam_diag_k)).double() + 1e-10 * torch.eye(
        4, device=dev, dtype=torch.float64)
    tk = torch.linalg.inv(Uk_d)[None]
    ek_k, ek_p = _block_rel(Mk.double()[None], tk), _block_rel(Mk_p.double()[None], tk)
    pin_err = float((Mc[list(K11_PINNED) + [0]] - torch.eye(6, device=dev)).abs().max())
    cond = torch.linalg.cond(Ud)
    check(bool((e_k <= torch.clamp(4 * e_p, min=1e-4)).all())
          and float(ek_k[0]) <= max(1e-4, 4 * float(ek_p[0])) and pin_err <= 1e-6,
          f"K10 schur_block_jacobi: Mc error {float(e_k.max())} (twin {float(e_p.max())}), "
          f"Mk {float(ek_k[0])} (twin {float(ek_p[0])}), pinned blocks {pin_err}")
    log(f"K10 schur_block_jacobi C={C}: against the f64 inverse, Mc max rel err "
        f"{float(e_k.max()):.2g} (twin {float(e_p.max()):.2g}; block cond up to "
        f"{float(cond.max()):.3g}), Mk {float(ek_k[0]):.2g} (twin {float(ek_p[0]):.2g}), "
        f"{len(K11_PINNED) + 1} pinned / fixed blocks the identity within {pin_err:.2g}")
    bj_ms = time_ms(torch, lambda: S.block_jacobi_cuda(lin.U, op.lam_diag_c, lin.Uk,
                                                       op.lam_diag_k))
    bj_plain = time_ms(torch, lambda: S.block_jacobi_plain(lin.U, op.lam_diag_c, lin.Uk,
                                                           op.lam_diag_k))
    bj_lib = time_ms(torch, lambda: torch.linalg.inv(Ud.float()))
    bj_dev = device_ms(torch, lambda: S.block_jacobi_cuda(lin.U, op.lam_diag_c, lin.Uk,
                                                          op.lam_diag_k))
    # Gauss-Jordan with partial pivoting: ~2 n^3 FLOP a block.
    bj = result(float(max(e_k.max(), ek_k[0])), bj_ms, bj_plain,
                nbytes(lin.U, op.lam_diag_c, lin.Uk, op.lam_diag_k, Mc, Mk),
                2 * 6 ** 3 * C + 2 * 4 ** 3, library_ms=bj_lib, device_ms=bj_dev)
    log(f"K10 schur_block_jacobi C={C}: wrapper {bj_ms:.4f} ms, device {fmt_ms(bj_dev)}, "
        f"torch.linalg.inv of the damped blocks {bj_lib:.4f} ms, bound "
        f"{bound(bj)[0]:.4f} ms")

    op = op._replace(Mc=Mc, Mk=Mk)
    g = torch.Generator(device=dev).manual_seed(9)
    xc = 1e-2 * torch.randn((C, 6), device=dev, generator=g)
    xk = 1e-1 * torch.randn(4, device=dev, generator=g)
    mk = S.schur_matvec_cuda(lin, op, xc, xk, perm, pvm)
    Sk = torch.cat([t.reshape(-1) for t in mk])
    Sp = torch.cat([t.reshape(-1) for t in S.schur_matvec_plain(lin, op, xc, xk)])
    torch.cuda.synchronize()
    check_repeatable(torch, "K11 schur_matvec",
                     lambda: S.schur_matvec_cuda(lin, op, xc, xk, perm, pvm), mk)
    mv_err = _rel(Sk, Sp)
    # Tolerance: 1e-4 of the largest entry (fixed-point sums against the
    # twin's float sums).
    check(bool(torch.isfinite(Sk).all()) and mv_err <= 1e-4, f"K11 schur_matvec: rel err {mv_err}")
    mv_ms, mv_dev = time_matvec(torch, S, lin, op, xc, xk, perm, pvm)
    pm_ms, pm_dev = matvec_point_major(torch, S, lin, op, xc, xk, perm, pvm, mk, "C=300")
    mv_plain = time_ms(torch, lambda: S.schur_matvec_plain(lin, op, xc, xk))
    # Bytes: the valid observations' Jacobians (12 + 8 + 6 floats), camera
    # id and grouping slot (the pinned cameras' observations are not in the
    # grouping and not read), one valid flag a slot of the grouping, an
    # observed point's id and Vinv, the damping, x and S x.
    n_obs, n_pts = int(pvm.sum()), int(pvm[:, 0].sum())
    mv_bytes = (n_obs * (26 + 2) * 4 + pvm.numel() + n_pts * (1 + 9) * 4
                + nbytes(op.lam_diag_c, op.lam_diag_k, lin.Hreg_k, xc, xk, Sk))
    # ~150 FLOP an observation (B x twice, Jp^T a, Jp v, Jc^T d, Jk^T d),
    # 18 a point (Vinv u), 2 an entry (the damping).
    mv_ops = 150 * n_obs + 18 * n_pts + 2 * (6 * C + 4)
    mv = result(mv_err, mv_ms, mv_plain, mv_bytes, mv_ops, device_ms=mv_dev)
    mv["point_major"] = {"ms": pm_ms, "device_ms": pm_dev}
    log(f"K11 schur_matvec C={C} P={P} O={O} ({n_obs} valid): rel err {mv_err:.2g}; wrapper "
        f"{mv_ms:.4f} ms, device {fmt_ms(mv_dev)}; point-major order (the same bits): wrapper "
        f"{pm_ms:.4f} ms, device {fmt_ms(pm_dev)}; bound {bound(mv)[0]:.4f} ms (plain torch "
        f"{mv_plain:.4f} ms)")

    # PCG: 10 fixed steps (tol 0), then converged, held against the twin and
    # against the dense solve of the same system (K10's S, factorized in f64).
    xk_c, xk_k, st_k = S.pcg_solve_cuda(lin, op, rhs_c, rhs_k, perm, pvm, 10, 0.0)
    xp_c, xp_k, st_p = S.pcg_solve_plain(lin, op, rhs_c, rhs_k, perm, pvm, 10, 0.0)
    torch.cuda.synchronize()
    check_repeatable(torch, "K11 pcg",
                     lambda: S.pcg_solve_cuda(lin, op, rhs_c, rhs_k, perm, pvm, 10, 0.0),
                     (xk_c, xk_k, st_k))
    cat = lambda a, b: torch.cat([a.reshape(-1), b])
    fixed_err = _rel(cat(xk_c, xk_k), cat(xp_c, xp_k))
    # Tolerance: 1e-3 of the largest entry after 10 steps (the matvec's sums
    # round otherwise than the twin's, and the recursion carries it).
    check(int(st_k) == 10 and int(st_p) == 10 and fixed_err <= 1e-3,
          f"K11 pcg, 10 fixed steps: rel err {fixed_err}, steps {int(st_k)} / {int(st_p)}")
    Sd = S.schur_matrix_cuda(lin, op, perm, pvm).double()
    rhs = cat(rhs_c, rhs_k).double()
    x_dense = torch.linalg.solve(Sd, rhs)
    iters, tol = 500, 1e-6
    xc_c, xc_k, steps = S.pcg_solve_cuda(lin, op, rhs_c, rhs_k, perm, pvm, iters, tol)
    xq_c, xq_k, steps_p = S.pcg_solve_plain(lin, op, rhs_c, rhs_k, perm, pvm, iters, tol)
    torch.cuda.synchronize()
    conv_err = _rel(cat(xc_c, xc_k).double(), x_dense)
    conv_err_p = _rel(cat(xq_c, xq_k).double(), x_dense)
    # Tolerance: an f32 CG that stops at |r| <= 1e-6 |rhs| gives the step to
    # about cond x 1e-6 of the exact one; on this system the twin (the
    # reference's loop) read 6e-4 to 1.2e-3 of the f64 dense solve from call
    # to call while the linearization's sums were float atomics. So the kernel must
    # come as close as the twin (within 1.5x its error, or 1e-3), and the
    # twin within 1e-2.
    check(conv_err <= max(1e-3, 1.5 * conv_err_p) and conv_err_p <= 1e-2,
          f"K11 pcg converged: rel err to the dense solve {conv_err} (twin {conv_err_p}), "
          f"{int(steps)} / {int(steps_p)} steps")
    log(f"K11 pcg C={C}: 10 fixed steps rel err {fixed_err:.2g} to the twin; converged "
        f"(tol {tol}) in {int(steps)} steps (twin {int(steps_p)}), rel err to the f64 dense "
        f"solve {conv_err:.2g} (twin {conv_err_p:.2g})")
    # The solve as run_ba runs it: cg_iters = 50, cg_tol = 1e-6.
    from sfm_tpu_torch.config import BAConfig

    cfg = BAConfig()
    pcg_ms, pcg_dev = time_pcg(torch, S, lin, op, rhs_c, rhs_k, perm, pvm, cfg.cg_iters,
                               cfg.cg_tol)
    pcg_plain = time_ms(torch, lambda: S.pcg_solve_plain(lin, op, rhs_c, rhs_k, perm, pvm,
                                                         cfg.cg_iters, cfg.cg_tol),
                        reps=3, warmup=1)
    n_steps = int(S.pcg_solve_cuda(lin, op, rhs_c, rhs_k, perm, pvm, cfg.cg_iters,
                                   cfg.cg_tol)[2])
    n = 6 * C + 4
    # A step: the matvec, then the CG update (reads Ap, p, r, x, Mc, Mk; writes
    # x, r, z, p): ~20 FLOP an entry and 72 a camera (the 6x6 apply).
    step_bytes = mv_bytes + nbytes(Mc, Mk) + 4 * 9 * n
    step_ops = mv_ops + 20 * n + 72 * C
    pcg = result(max(fixed_err, conv_err), pcg_ms, pcg_plain,
                 nbytes(rhs_c, rhs_k, Mc, Mk) + 4 * 5 * n + n_steps * step_bytes,
                 n_steps * step_ops, device_ms=pcg_dev)
    log(f"K11 pcg C={C}, cg_iters {cfg.cg_iters}, cg_tol {cfg.cg_tol}: {n_steps} steps, "
        f"wrapper {pcg_ms:.4f} ms, device {fmt_ms(pcg_dev)}, bound {bound(pcg)[0]:.4f} ms "
        f"(plain torch {pcg_plain:.4f} ms)")
    return bj, mv, pcg


def phase_run_ba_pcg(torch, np, dev):
    """One run_ba at 256 cameras on the card through PCG
    (``use_dense_schur_below`` 0) and through the dense path: final costs
    within 1e-3 relative."""
    from sfm_tpu_torch.ba.lm import run_ba
    from sfm_tpu_torch.ba.problem import BAProblem
    from sfm_tpu_torch.config import BAConfig

    rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy = ba_scene(
        torch, np, dev, n_cams=256, n_pts=50000, obs_per_cam=2000, seed=256)
    C, P, O = rvec.shape[0], pts.shape[0], obs_cam.shape[0]
    ones = lambda k: torch.ones(k, dtype=torch.bool, device=dev)
    fixed = torch.zeros(C, dtype=torch.bool, device=dev)
    fixed[0] = True
    prob = BAProblem(rvec, tvec, ones(C), fixed, intr, pts, ones(P), obs_cam, obs_point, obs_xy,
                     ones(O))
    out = {}
    for name, below in (("pcg", 0), ("dense", 256)):
        t0 = time.perf_counter()
        _, st = run_ba(prob, BAConfig(max_iterations=10, use_dense_schur_below=below))
        torch.cuda.synchronize()
        out[name] = (st, time.perf_counter() - t0)
    (st_p, t_p), (st_d, t_d) = out["pcg"], out["dense"]
    cost_err = abs(st_p["final_cost"] - st_d["final_cost"]) / st_d["final_cost"]
    check(st_p["solver"] == "pcg" and st_d["solver"] == "dense" and cost_err <= 1e-3
          and st_p["final_cost"] < 0.5 * st_p["initial_cost"],
          f"K11 run_ba C={C}: PCG final cost {st_p['final_cost']} vs dense {st_d['final_cost']}")
    log(f"K11 run_ba C={C} O={O}: final cost {st_p['final_cost']:.6g} through PCG ({t_p:.2f} s, "
        f"{st_p['iterations']} iterations, {st_p['cg_iterations']} CG steps) vs "
        f"{st_d['final_cost']:.6g} dense ({t_d:.2f} s, {st_d['iterations']} iterations), rel "
        f"{cost_err:.2g}")


# The BA island's other routes: per-camera intrinsics (B = 10), the f64
# island, and both; each row's kernel entries, by route.
ISLAND_ROUTES = {"b10": (10, "float32"), "f64": (6, "float64"), "b10_f64": (10, "float64")}
ISLAND_REG_W = 5.0   # intrinsics_reg_weight: large enough that U_extra matters
ISLAND_SCENE = (100, 20000, 2000)   # ba_scene's cameras, points, observations a camera
# NVIDIA's H100 SXM float64 peak outside the tensor cores (data sheet).
PEAK_F64_PER_S = 34e12


def island_system(torch, np, dev, B, dt, n_cams, n_pts, obs_per_cam, seed, pinned=()):
    """``ba_scene``'s problem with the ``pinned`` cameras unregistered and
    camera 0 fixed, and the linearize arguments of the route (B, dt) as
    ``run_ba`` passes them: at B = 10 each camera's own K (a few px off
    the shared one) with the per-camera regularization at
    ``ISLAND_REG_W``, at B = 6 the shared K with its regularization.
    Returns (args, kwargs) of ``linearize_cuda`` / ``linearize_plain``."""
    from sfm_tpu_torch.ba.lm import _intr_reg, percam_regularization
    from sfm_tpu_torch.ba.schur import coobs_pairs

    rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy = ba_scene(
        torch, np, dev, n_cams=n_cams, n_pts=n_pts, obs_per_cam=obs_per_cam, seed=seed)
    C, P = rvec.shape[0], pts.shape[0]
    cam_valid = torch.ones(C, dtype=torch.bool, device=dev)
    cam_valid[list(pinned)] = False
    cam_free = cam_valid.float()
    cam_free[0] = 0.0
    obs_w = cam_valid[obs_cam.long()].float()
    perm, pvm = coobs_pairs(obs_point.cpu().numpy(), obs_w.cpu().numpy() > 0)
    perm, pvm = torch.as_tensor(perm, device=dev), torch.as_tensor(pvm, device=dev)
    kw = {"dtype": dt}
    if B == 10:
        rng = np.random.default_rng(seed + 1)
        intr_c = intr[None] + torch.as_tensor(rng.normal(0, [8.0, 8.0, 3.0, 3.0], (C, 4)),
                                              dtype=torch.float32, device=dev)
        _, U_extra, g_c_extra = percam_regularization(intr_c, intr, ISLAND_REG_W,
                                                      cam_valid.float())
        kw.update(U_extra=U_extra.to(dt), g_c_extra=g_c_extra.to(dt))
        Hreg, greg = torch.eye(4, device=dev), torch.zeros(4, device=dev)
        intr = intr_c.contiguous()
    else:
        _, Hreg, greg = _intr_reg(intr, intr, ISLAND_REG_W)
    args = (rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy, obs_w, cam_free,
            torch.ones(P, dtype=torch.bool, device=dev), perm, pvm, 2.0, True,
            Hreg.contiguous(), greg.contiguous())
    return args, kw


def phase_island(torch, np, dev, route, systems: dict):
    """One route of the BA island (``ISLAND_ROUTES``): K8+K9's linearize and
    K10's coupling and damping / back-substitution on ``ba_scene`` (100
    cameras, 200k observations), K10's block-Jacobi inverses and K11's
    matvec and PCG on the 300-camera / 600k-observation scene with 20
    cameras pinned; each against its twin, with a second launch that must
    give the same bits. Returns the six rows' results; the coupling's S and
    right-hand side go to ``systems[route]`` for the dense solve's phase."""
    from sfm_tpu_torch.ba import schur as S

    B, dname = ISLAND_ROUTES[route]
    dt = getattr(torch, dname)
    f64 = dt == torch.float64
    peak = PEAK_F64_PER_S if f64 else PEAK_F32_PER_S
    el = 8 if f64 else 4
    # Tolerances: float32 as the default route's phases; float64 the kernel
    # against the float64 twin at 1e-10 of each tensor's largest entry (the
    # Jacobians themselves are float32 in both, computed analytically by
    # the kernel and by autodiff in the twin: 1e-4 as at float32, and the
    # sums held against the twin's float64 sums of the kernel's own
    # whitened Jacobians).
    tol = (lambda t32: 1e-10) if f64 else (lambda t32: t32)
    out = {}
    tag = f"{route} (B = {B}, {dname})"

    args, kw = island_system(torch, np, dev, B, dt, *ISLAND_SCENE, 0)
    O = args[4].shape[0]
    # The layout and scratch once, as run_ba makes them for its LM loop.
    lw = S.linearize_workspace(args[10], args[11], args[4], args[5], args[7],
                               args[0].shape[0], args[3].shape[0], B, dt)
    lk = S.linearize_cuda(*args, **kw, work=lw)
    lp = S.linearize_plain(*args, **kw)
    torch.cuda.synchronize()
    check_repeatable(torch, f"K8+K9 ba_linearize {tag}",
                     lambda: S.linearize_cuda(*args, **kw, work=lw), lk)
    check_repeatable(torch, f"K8+K9 ba_linearize {tag} (its own layout)",
                     lambda: S.linearize_cuda(*args, **kw), lk)
    for name in lk._fields:
        x = getattr(lk, name)
        if x is not None and x.is_floating_point():
            check(bool(torch.isfinite(x).all()), f"K8 {tag}: {name} not finite")
    errs = {f: _rel(getattr(lk, f), getattr(lp, f)) for f in ("Jc", "Jk", "Jp", "rw")}
    if f64:   # the sums against float64 sums of the kernel's own Jacobians
        ref = S.linearize_system(lk.Jc, lk.Jk, lk.Jp, lk.rw, torch.ones_like(args[7], dtype=dt),
                                 lk.obs_cam, lk.obs_point, (args[7] > 0).to(dt),
                                 torch.ones(lk.U.shape[0], dtype=dt, device=dev),
                                 lk.point_valid, lk.Hreg_k, lk.U.shape[0], lk.V.shape[0],
                                 g_k_extra=args[15].to(dt), U_extra=kw.get("U_extra"),
                                 g_c_extra=kw.get("g_c_extra"))
    else:
        ref = lp
    errs.update({f: _rel(getattr(lk, f), getattr(ref, f))
                 for f in ("V", "g_p", "U", "g_c", "Uk", "g_k")})
    for f, e in errs.items():
        check(e <= (1e-4 if f in ("Jc", "Jk", "Jp", "rw") else tol(1e-3)),
              f"K8/K9 {tag}: {f} rel err {e}")
    if B == 10:   # the fixed camera 0: pose columns zero, intrinsics columns free
        rows = args[4] == 0
        check(float(lk.Jc[rows][..., :6].abs().max()) == 0.0
              and float(lk.Jc[rows][..., 6:].abs().max()) > 0.0,
              f"K8 {tag}: the fixed camera's columns")
    if B == 10 and not f64:
        cargs = (args[0], args[1], args[2], args[3], args[4], args[5], args[6], args[7], 2.0)
        from sfm_tpu_torch.ba.residuals import total_huber_cost_cuda, total_huber_cost_plain

        ck, cp = total_huber_cost_cuda(*cargs), total_huber_cost_plain(*cargs)
        check_repeatable(torch, f"K8 ba_cost_b10", lambda: total_huber_cost_cuda(*cargs), ck)
        cost_err = abs(float(ck) - float(cp)) / float(cp)
        check(cost_err <= 1e-5, f"K8 ba_cost_b10: rel err {cost_err}")
        errs["cost"] = cost_err
        cost = cost_result(torch, "K8 ba_cost_b10", lambda: total_huber_cost_cuda(*cargs),
                           lambda: total_huber_cost_plain(*cargs), cargs, cost_err)
    log(f"K8+K9 ba_linearize {tag}: rel err " + ", ".join(f"{f} {e:.2g}"
                                                         for f, e in errs.items()))
    plain_ms = time_ms(torch, lambda: S.linearize_plain(*args, **kw))
    n_sums = B * (B + 1) // 2 + B
    # ~400 FLOP an observation at B = 6, 4 more for each further camera sum.
    out["ba_linearize"] = linearize_result(
        torch, f"K8+K9 ba_linearize {tag}", lambda: S.linearize_cuda(*args, **kw, work=lw), args,
        lk, max(errs.values()), plain_ms, (400 + 4 * (n_sums - 27)) * O, peak=peak)
    if B == 10 and not f64:
        out["ba_linearize"]["cost"] = cost

    lam = 1e-3
    perm, pvm = args[10], args[11]
    op, rhs_c, rhs_k = S.damp_operator(lk, lam, perm, pvm)
    cw = S.coupling_workspace(lk, perm, pvm)
    coupling = lambda: S.schur_matrix_cuda(lk, op, perm, pvm, cw)
    Sk = coupling()
    Sp = S.schur_matrix_plain(lk, op, perm, pvm)
    torch.cuda.synchronize()
    check_repeatable(torch, f"K10 schur_coupling {tag}", coupling, Sk)
    s_err = _rel(Sk, Sp)
    rhs = torch.cat([rhs_c.reshape(-1), rhs_k])[:, None]
    solve = lambda M: torch.cholesky_solve(rhs.double(), torch.linalg.cholesky(M.double()))[:, 0]
    x_err = _rel(solve(Sk), solve(Sp))
    check(bool(torch.isfinite(Sk).all()) and s_err <= tol(1e-4)
          and x_err <= (1e-8 if f64 else 1e-2), f"K10 {tag}: S rel err {s_err}, step rel err "
          f"{x_err}")
    log(f"K10 schur_coupling {tag}: S ({Sk.shape[0]}^2) rel err {s_err:.2g}, solved step "
        f"rel err {x_err:.2g}")
    ms = median_ms(torch, coupling)
    dev_ms = device_ms(torch, coupling)
    plain_ms = time_ms(torch, lambda: S.schur_matrix_plain(lk, op, perm, pvm), reps=3, warmup=1)
    out["schur_coupling"] = result(
        s_err, ms, plain_ms,
        nbytes(lk.Jc, lk.Jk, lk.Jp, lk.obs_cam, lk.obs_point, op.Vinv, perm, pvm, Sk),
        coupling_ops(B, pvm), peak=peak, device_ms=dev_ms)
    b_ms, b_by = bound(out["schur_coupling"])
    log(f"K10 schur_coupling {tag}: wrapper {ms:.4f} ms, device {fmt_ms(dev_ms)}, bound "
        f"{b_ms:.4f} ms by {b_by}")
    systems[route] = (Sk, rhs_c, rhs_k)

    (opk, rck, rkk), (opp, rcp, rkp) = (S.schur_damp_cuda(lk, lam, perm, pvm),
                                        S.schur_damp_plain(lk, lam))
    xc, xk = S.dense_schur_direct(opk, lk, rck, rkk, perm, pvm)
    dpk = S.schur_back_substitute_cuda(lk, opk, xc, xk, perm, pvm)
    dpp = S.schur_back_substitute_plain(lk, opk, xc, xk)
    torch.cuda.synchronize()
    check_repeatable(torch, f"K10 schur_damp {tag}",
                     lambda: S.schur_damp_cuda(lk, lam, perm, pvm), (opk, rck, rkk))
    check_repeatable(torch, f"K10 schur_back_substitute {tag}",
                     lambda: S.schur_back_substitute_cuda(lk, opk, xc, xk, perm, pvm), dpk)
    diag = torch.diagonal(lk.V, dim1=-2, dim2=-1)
    Vd = lk.V + (lam * diag + 1e-10)[..., None] * torch.eye(3, device=dev, dtype=dt)
    well = lk.point_valid & (torch.linalg.cond(Vd.double()) <= 100)
    v_err = float(_block_rel(opk.Vinv, opp.Vinv)[well].max())
    derrs = {"rhs_c": _rel(rck, rcp), "rhs_k": _rel(rkk, rkp), "dp": _rel(dpk, dpp),
             "Vinv": v_err}
    check(max(derrs.values()) <= (1e-7 if f64 else 1e-3)
          and torch.equal(opk.lam_diag_c, opp.lam_diag_c),
          f"K10 schur_damp {tag}: {derrs}")
    if B == 10:   # the per-entry pin: the fixed camera's pose rows only
        check(bool((opk.lam_diag_c[0, :6] == 1).all())
              and bool((torch.diagonal(lk.U[0])[6:] > 1e-10).all()),
              f"K10 schur_damp {tag}: the fixed camera's pin")
    log(f"K10 schur_damp / back_substitute {tag}: rel err " + ", ".join(
        f"{k} {v:.2g}" for k, v in derrs.items()))
    dk, dd = time_damp(torch, S, lk, lam, perm, pvm, opk, xc, xk)
    dpl = time_ms(torch, lambda: S.schur_damp_plain(lk, lam))
    bpl = time_ms(torch, lambda: S.schur_back_substitute_plain(lk, opk, xc, xk))
    inv_ms = median_ms(torch, lambda: torch.linalg.inv(Vd))
    P = lk.V.shape[0]
    out["schur_damp"] = result(
        max(derrs.values()), dk, dpl + bpl,
        damp_bytes(lk, opk, perm, pvm, rck, rkk, xc, xk, dpk),
        78 * P + (56 + 8 * B) * O, library_ms=inv_ms, peak=peak, device_ms=dd)
    log(f"K10 schur_damp + back_substitute {tag}: wrapper {dk:.4f} ms, device {fmt_ms(dd)}, "
        f"torch.linalg.inv of Vd alone {inv_ms:.4f} ms, bound "
        f"{bound(out['schur_damp'])[0]:.4f} ms (plain torch {dpl + bpl:.4f} ms)")

    # The PCG system: 300 cameras, 20 pinned.
    args, kw = island_system(torch, np, dev, B, dt, K11_CAMS, K11_POINTS, K11_OBS_PER_CAM, 300,
                             K11_PINNED)
    lin = S.linearize_cuda(*args, **kw)
    perm, pvm = args[10], args[11]
    C = lin.U.shape[0]
    op, rhs_c, rhs_k = S.damp_operator(lin, lam, perm, pvm)
    Mc, Mk = S.block_jacobi_cuda(lin.U, op.lam_diag_c, lin.Uk, op.lam_diag_k)
    Mc_p, Mk_p = S.block_jacobi_plain(lin.U, op.lam_diag_c, lin.Uk, op.lam_diag_k)
    torch.cuda.synchronize()
    check_repeatable(torch, f"K10 schur_block_jacobi {tag}", lambda: S.block_jacobi_cuda(
        lin.U, op.lam_diag_c, lin.Uk, op.lam_diag_k), (Mc, Mk))
    eyeB = torch.eye(B, device=dev, dtype=torch.float64)
    Ud = lin.U.double() + op.lam_diag_c.double()[..., None] * eyeB + 1e-10 * eyeB
    truth = torch.linalg.inv(Ud)
    e_k, e_p = _block_rel(Mc.double(), truth), _block_rel(Mc_p.double(), truth)
    cond = torch.linalg.cond(Ud)
    # Tolerance: against the f64 inverse of the same blocks, within
    # max(4x the twin's LU error, 1e-4) in float32, and in float64 within
    # cond x 1e-14 of each block (both eliminate in f64).
    lim = cond * 1e-14 if f64 else torch.clamp(4 * e_p, min=1e-4)
    pin = list(K11_PINNED) + [0]
    pin_err = float((Mc[pin][:, :6, :6] - torch.eye(6, device=dev, dtype=dt)).abs().max())
    check(bool((e_k <= lim).all()) and pin_err <= 1e-6,
          f"K10 schur_block_jacobi {tag}: Mc error {float(e_k.max())} (twin "
          f"{float(e_p.max())}), pinned blocks {pin_err}")
    log(f"K10 schur_block_jacobi {tag}: against the f64 inverse, Mc max rel err "
        f"{float(e_k.max()):.2g} (twin {float(e_p.max()):.2g}; cond up to "
        f"{float(cond.max()):.3g}); pinned / fixed pose blocks the identity within "
        f"{pin_err:.2g}")
    bj_ms = time_ms(torch, lambda: S.block_jacobi_cuda(lin.U, op.lam_diag_c, lin.Uk,
                                                       op.lam_diag_k))
    bj_plain = time_ms(torch, lambda: S.block_jacobi_plain(lin.U, op.lam_diag_c, lin.Uk,
                                                           op.lam_diag_k))
    bj_lib = time_ms(torch, lambda: torch.linalg.inv(Ud.to(dt)))
    bj_dev = device_ms(torch, lambda: S.block_jacobi_cuda(lin.U, op.lam_diag_c, lin.Uk,
                                                          op.lam_diag_k))
    out["schur_block_jacobi"] = result(
        float(e_k.max()), bj_ms, bj_plain,
        nbytes(lin.U, op.lam_diag_c, lin.Uk, op.lam_diag_k, Mc, Mk),
        2 * B ** 3 * C + 2 * 4 ** 3, library_ms=bj_lib, peak=peak, device_ms=bj_dev)
    log(f"K10 schur_block_jacobi {tag}: wrapper {bj_ms:.4f} ms, device {fmt_ms(bj_dev)}, "
        f"torch.linalg.inv of the damped blocks {bj_lib:.4f} ms, bound "
        f"{bound(out['schur_block_jacobi'])[0]:.4f} ms")

    op = op._replace(Mc=Mc, Mk=Mk)
    g = torch.Generator(device=dev).manual_seed(9)
    xc = (1e-2 * torch.randn((C, B), device=dev, generator=g)).to(dt)
    xk = (1e-1 * torch.randn(4, device=dev, generator=g)).to(dt)
    mk = S.schur_matvec_cuda(lin, op, xc, xk, perm, pvm)
    Sx = torch.cat([t.reshape(-1) for t in mk])
    Sx_p = torch.cat([t.reshape(-1) for t in S.schur_matvec_plain(lin, op, xc, xk)])
    torch.cuda.synchronize()
    check_repeatable(torch, f"K11 schur_matvec {tag}",
                     lambda: S.schur_matvec_cuda(lin, op, xc, xk, perm, pvm), mk)
    mv_err = _rel(Sx, Sx_p)
    check(bool(torch.isfinite(Sx).all()) and mv_err <= tol(1e-4),
          f"K11 schur_matvec {tag}: rel err {mv_err}")
    mv_ms, mv_dev = time_matvec(torch, S, lin, op, xc, xk, perm, pvm)
    pm_ms, pm_dev = matvec_point_major(torch, S, lin, op, xc, xk, perm, pvm, mk, tag)
    mv_plain = time_ms(torch, lambda: S.schur_matvec_plain(lin, op, xc, xk))
    n_obs, n_pts = int(pvm.sum()), int(pvm[:, 0].sum())
    mv_bytes = (n_obs * ((2 * B + 8 + 6) * el + 8) + pvm.numel() + n_pts * (4 + 9 * el)
                + nbytes(op.lam_diag_c, op.lam_diag_k, lin.Hreg_k, xc, xk, Sx)
                + (nbytes(lin.U_extra) if lin.U_extra is not None else 0))
    n = B * C + 4
    mv_ops = (12 * B + 72) * n_obs + 18 * n_pts + 2 * n + (2 * B * B * C if B == 10 else 0)
    out["schur_matvec"] = result(mv_err, mv_ms, mv_plain, mv_bytes, mv_ops, peak=peak,
                                 device_ms=mv_dev)
    out["schur_matvec"]["point_major"] = {"ms": pm_ms, "device_ms": pm_dev}
    log(f"K11 schur_matvec {tag}: rel err {mv_err:.2g}; wrapper {mv_ms:.4f} ms, device "
        f"{fmt_ms(mv_dev)}; point-major order (the same bits): wrapper {pm_ms:.4f} ms, device "
        f"{fmt_ms(pm_dev)}; bound {bound(out['schur_matvec'])[0]:.4f} ms (plain torch "
        f"{mv_plain:.4f} ms)")

    xk_c, xk_k, st_k = S.pcg_solve_cuda(lin, op, rhs_c, rhs_k, perm, pvm, 10, 0.0)
    xp_c, xp_k, st_p = S.pcg_solve_plain(lin, op, rhs_c, rhs_k, perm, pvm, 10, 0.0)
    torch.cuda.synchronize()
    check_repeatable(torch, f"K11 pcg {tag}", lambda: S.pcg_solve_cuda(
        lin, op, rhs_c, rhs_k, perm, pvm, 10, 0.0), (xk_c, xk_k, st_k))
    cat = lambda a, b: torch.cat([a.reshape(-1), b])
    fixed_err = _rel(cat(xk_c, xk_k), cat(xp_c, xp_k))
    pinned_zero = float(xk_c[list(K11_PINNED)].abs().max())
    # Tolerance: 10 fixed steps 1e-3 in float32 (the recursion carries the
    # sums' rounding), 1e-8 in float64 (the same, at f64 rounding).
    check(int(st_k) == 10 and fixed_err <= (1e-8 if f64 else 1e-3) and pinned_zero == 0.0,
          f"K11 pcg {tag}, 10 fixed steps: rel err {fixed_err}, steps {int(st_k)}, "
          f"pinned cameras' step {pinned_zero}")
    from sfm_tpu_torch.config import BAConfig

    cfg = BAConfig()
    pcg_ms, pcg_dev = time_pcg(torch, S, lin, op, rhs_c, rhs_k, perm, pvm, cfg.cg_iters,
                               cfg.cg_tol)
    pcg_plain = time_ms(torch, lambda: S.pcg_solve_plain(lin, op, rhs_c, rhs_k, perm, pvm,
                                                         cfg.cg_iters, cfg.cg_tol),
                        reps=3, warmup=1)
    n_steps = int(S.pcg_solve_cuda(lin, op, rhs_c, rhs_k, perm, pvm, cfg.cg_iters,
                                   cfg.cg_tol)[2])
    step_bytes = mv_bytes + nbytes(Mc, Mk) + el * 9 * n
    step_ops = mv_ops + 20 * n + 2 * B * B * C
    out["pcg"] = result(fixed_err, pcg_ms, pcg_plain,
                        nbytes(rhs_c, rhs_k, Mc, Mk) + el * 5 * n + n_steps * step_bytes,
                        n_steps * step_ops, peak=peak, device_ms=pcg_dev)
    log(f"K11 pcg {tag}: 10 fixed steps rel err {fixed_err:.2g} to the twin; cg_iters "
        f"{cfg.cg_iters}, cg_tol {cfg.cg_tol}: {n_steps} steps, wrapper {pcg_ms:.4f} ms, device "
        f"{fmt_ms(pcg_dev)}, bound {bound(out['pcg'])[0]:.4f} ms (plain torch "
        f"{pcg_plain:.4f} ms)")
    return {f"{k}_{route}": v for k, v in out.items()}


# The above-cap BA scene: more cameras than any route's shared-memory camera
# sums held (4,842 at B = 6 in f32; ba/schur.py::max_cameras), 100
# observations a camera, 50k points, every 250th camera unregistered.
BIG_BA_SCENE = (5000, 50000, 100)
BIG_BA_PINNED = tuple(range(7, 5000, 250))


def phase_ba_above_cap(torch, np, dev):
    """K10's damping (its rhs walk) and K11's matvec on every route at
    ``BIG_BA_SCENE``'s 5,000 cameras, where the camera sums go to global
    memory, against their twins with the in-cap phases' tolerances and
    repeating bitwise; then one PCG solve on the default route. Returns
    {row: numbers} for the kernels' JSON line."""
    from sfm_tpu_torch.ba import schur as S
    from sfm_tpu_torch.config import BAConfig

    lam, out = 1e-3, {}
    for route, (B, dname) in {"": (6, "float32"), **ISLAND_ROUTES}.items():
        dt = getattr(torch, dname)
        f64 = dt == torch.float64
        tag = f"{route or 'default'} (B = {B}, {dname}) at C = {BIG_BA_SCENE[0]}"
        args, kw = island_system(torch, np, dev, B, dt, *BIG_BA_SCENE, 500, BIG_BA_PINNED)
        lin = S.linearize_cuda(*args, **kw)
        perm, pvm = args[10], args[11]
        C = lin.U.shape[0]
        check(not S.camera_sums_in_shared(C, B, dt), f"{tag}: within the shared-memory route")
        (opk, rck, rkk), (opp, rcp, rkp) = (S.schur_damp_cuda(lin, lam, perm, pvm),
                                            S.schur_damp_plain(lin, lam))
        torch.cuda.synchronize()
        check_repeatable(torch, f"K10 schur_damp {tag}",
                         lambda: S.schur_damp_cuda(lin, lam, perm, pvm), (opk, rck, rkk))
        derrs = {"rhs_c": _rel(rck, rcp), "rhs_k": _rel(rkk, rkp)}
        check(max(derrs.values()) <= (1e-7 if f64 else 1e-3)
              and torch.equal(opk.lam_diag_c, opp.lam_diag_c), f"K10 schur_damp {tag}: {derrs}")
        g = torch.Generator(device=dev).manual_seed(9)
        xc = (1e-2 * torch.randn((C, B), device=dev, generator=g)).to(dt)
        xk = (1e-1 * torch.randn(4, device=dev, generator=g)).to(dt)
        mk = S.schur_matvec_cuda(lin, opk, xc, xk, perm, pvm)
        Sx = torch.cat([t.reshape(-1) for t in mk])
        Sx_p = torch.cat([t.reshape(-1) for t in S.schur_matvec_plain(lin, opk, xc, xk)])
        torch.cuda.synchronize()
        check_repeatable(torch, f"K11 schur_matvec {tag}",
                         lambda: S.schur_matvec_cuda(lin, opk, xc, xk, perm, pvm), mk)
        mv_err = _rel(Sx, Sx_p)
        check(bool(torch.isfinite(Sx).all()) and mv_err <= (1e-10 if f64 else 1e-4),
              f"K11 schur_matvec {tag}: rel err {mv_err}")
        work = S.damp_workspace(lin)
        dk = median_ms(torch, lambda: S.schur_damp_cuda(lin, lam, perm, pvm, work))
        dd = device_ms(torch, lambda: S.schur_damp_cuda(lin, lam, perm, pvm, work))
        dpl = time_ms(torch, lambda: S.schur_damp_plain(lin, lam), reps=3, warmup=1)
        diag = torch.diagonal(lin.V, dim1=-2, dim2=-1)
        Vd = lin.V + (lam * diag + 1e-10)[..., None] * torch.eye(3, device=dev, dtype=dt)
        inv_ms = median_ms(torch, lambda: torch.linalg.inv(Vd))
        mv_ms, mv_dev = time_matvec(torch, S, lin, opk, xc, xk, perm, pvm)
        mv_plain = time_ms(torch, lambda: S.schur_matvec_plain(lin, opk, xc, xk), reps=3,
                           warmup=1)
        el, peak = (8, PEAK_F64_PER_S) if f64 else (4, PEAK_F32_PER_S)
        P, O = lin.V.shape[0], lin.Jc.shape[0]
        # The damping alone: ~60 FLOP a point, 28 + 4 B an observation (y_o,
        # Jc^T y, Jk^T y); the matvec as phase_island counts it.
        d_cost = result(max(derrs.values()), dk, dpl, nbytes(
            lin.Jc, lin.Jk, lin.Jp, lin.obs_cam, lin.obs_point, lin.g_p, lin.V, lin.point_valid,
            lin.U, lin.Uk, lin.g_c, lin.g_k, opk.Vinv, opk.lam_diag_c, opk.lam_diag_k, rck, rkk),
            60 * P + (28 + 4 * B) * O, library_ms=inv_ms, peak=peak, device_ms=dd)
        n_obs, n_pts, n = int(pvm.sum()), int(pvm[:, 0].sum()), B * C + 4
        mv_bytes = (n_obs * ((2 * B + 8 + 6) * el + 8) + pvm.numel() + n_pts * (4 + 9 * el)
                    + nbytes(opk.lam_diag_c, opk.lam_diag_k, lin.Hreg_k, xc, xk, Sx)
                    + (nbytes(lin.U_extra) if lin.U_extra is not None else 0))
        mv_ops = (12 * B + 72) * n_obs + 18 * n_pts + 2 * n + (2 * B * B * C if B == 10 else 0)
        mv_cost = result(mv_err, mv_ms, mv_plain, mv_bytes, mv_ops, peak=peak,
                         device_ms=mv_dev)
        log(f"{tag}: K10 schur_damp rel err " + ", ".join(f"{k} {v:.2g}"
                                                         for k, v in derrs.items())
            + f", wrapper {dk:.4f} ms, device {fmt_ms(dd)} (plain torch {dpl:.4f} ms, "
            f"torch.linalg.inv of the damped point blocks alone {inv_ms:.4f} ms, bound "
            f"{bound(d_cost)[0]:.4f} ms); K11 schur_matvec rel err {mv_err:.2g}, wrapper "
            f"{mv_ms:.4f} ms, device {fmt_ms(mv_dev)} (plain torch {mv_plain:.4f} ms, bound "
            f"{bound(mv_cost)[0]:.4f} ms); bitwise repeats")
        out[f"schur_damp{'_' + route if route else ''}"] = {"cameras": C, **d_cost}
        out[f"schur_matvec{'_' + route if route else ''}"] = {"cameras": C, **mv_cost}
        if not route:   # one PCG solve: the quadratic model ends finite and below its start
            op, rhs_c, rhs_k = S.damp_operator(lin, lam, perm, pvm, precond=True)
            cfg = BAConfig()
            pc, pk, steps = S.pcg_solve_cuda(lin, op, rhs_c, rhs_k, perm, pvm, cfg.cg_iters,
                                             cfg.cg_tol)
            Sc, Sk_ = S.schur_matvec_cuda(lin, op, pc, pk, perm, pvm)
            q = float(0.5 * ((pc * Sc).sum() + (pk * Sk_).sum()) - (pc * rhs_c).sum()
                      - (pk * rhs_k).sum())
            res = float(torch.sqrt(((Sc - rhs_c) ** 2).sum() + ((Sk_ - rhs_k) ** 2).sum())
                        / torch.sqrt((rhs_c ** 2).sum() + (rhs_k ** 2).sum()))
            check(math.isfinite(q) and q < 0.0 and math.isfinite(res) and res < 1.0,
                  f"K11 pcg {tag}: model {q} (0 at the start), residual {res} of |rhs|")
            pcg_ms, pcg_dev = time_pcg(torch, S, lin, op, rhs_c, rhs_k, perm, pvm,
                                       cfg.cg_iters, cfg.cg_tol)
            n_steps = int(steps)
            step_bytes = mv_bytes + nbytes(op.Mc, op.Mk) + el * 9 * n
            step_ops = mv_ops + 20 * n + 2 * B * B * C
            pcg_cost = result(res, pcg_ms, None,
                              nbytes(rhs_c, rhs_k, op.Mc, op.Mk) + el * 5 * n
                              + n_steps * step_bytes, n_steps * step_ops, peak=peak,
                              device_ms=pcg_dev)
            log(f"K11 pcg {tag}: {n_steps} steps, quadratic model {q:.6g} (0 at the "
                f"start), residual {res:.3g} of |rhs|, wrapper {pcg_ms:.4f} ms, device "
                f"{fmt_ms(pcg_dev)} (bound {bound(pcg_cost)[0]:.4f} ms)")
            out["pcg"] = {"cameras": C, "steps": n_steps, "model": q, "residual": res,
                          **pcg_cost}
        del lin, opk, opp, args, kw
        torch.cuda.empty_cache()
    return out


def focal_scene(torch, np, dev, n_cams, n_pts, seed):
    """``TestPerCameraIntrinsics``' two focal groups at scale: ``n_cams``
    cameras on a circle of radius 6 around a cloud in [-1.5, 1.5]^3, each
    looking at its center, fx = fy = 1,140 for the first half and 1,270 for
    the rest, noiseless projections inside 1024 x 768; every camera starts
    from the shared K (1,200, 1,200, 512, 384), camera 0 fixed. Returns
    (BAProblem, the true fx of each camera)."""
    from sfm_tpu_torch.ba.problem import BAProblem
    from sfm_tpu_torch.ba.residuals import residuals

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (n_pts, 3)).astype(np.float32)
    ang = 2 * np.pi * np.arange(n_cams) / n_cams
    fx = np.where(np.arange(n_cams) < n_cams // 2, 1140.0, 1270.0).astype(np.float32)
    rvec = np.stack([np.zeros(n_cams), np.angle(np.exp(1j * ang)), np.zeros(n_cams)], 1)
    c, s_ = np.cos(ang), np.sin(ang)
    center = np.stack([6 * s_, 0.3 * np.sin(3 * ang), -6 * c], 1)
    R = np.zeros((n_cams, 3, 3))
    R[:, 0, 0], R[:, 0, 2], R[:, 1, 1], R[:, 2, 0], R[:, 2, 2] = c, s_, 1.0, -s_, c
    tvec = -(R @ center[..., None])[..., 0]
    T = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    intr_c = np.stack([fx, fx, np.full(n_cams, 512.0), np.full(n_cams, 384.0)], 1)
    obs_cam = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    obs_point = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    xy = residuals(T(rvec), T(tvec), T(intr_c), T(pts), T(obs_cam, torch.int32),
                   T(obs_point, torch.int32), torch.zeros((len(obs_cam), 2), device=dev))
    keep = ((xy[:, 0] > 0) & (xy[:, 0] < 1024) & (xy[:, 1] > 0) & (xy[:, 1] < 768)).cpu().numpy()
    O = int(keep.sum())
    ones = lambda k: torch.ones(k, dtype=torch.bool, device=dev)
    fixed = torch.zeros(n_cams, dtype=torch.bool, device=dev)
    fixed[0] = True
    prob = BAProblem(T(rvec), T(tvec), ones(n_cams), fixed,
                     T([1200.0, 1200.0, 512.0, 384.0]), T(pts), ones(n_pts),
                     T(obs_cam[keep], torch.int32), T(obs_point[keep], torch.int32),
                     xy[torch.as_tensor(keep, device=dev)].contiguous(), ones(O))
    return prob, fx


def ill_conditioned_problem(torch, np, dev, n_cams=1000, n_pts=6000, obs_per_cam=40):
    """``TestF64NormalEquations._ill_conditioned_problem`` without JAX: an
    uncentered far cloud, a 100k-px focal and noiseless observations (the
    port's own residuals at the true parameters), so the cost floor is the
    arithmetic; then poses and points perturbed, camera 0 fixed."""
    from sfm_tpu_torch.ba.problem import BAProblem
    from sfm_tpu_torch.ba.residuals import residuals

    rng = np.random.default_rng(0)
    offset, depth, f = 20000.0, 8000.0, 100000.0
    pts = (rng.uniform(-1, 1, (n_pts, 3)) * np.array([20.0, 20.0, 5.0])
           + np.array([offset, offset, depth])).astype(np.float32)
    rvec = 0.001 * rng.normal(size=(n_cams, 3)).astype(np.float32)
    tvec = (0.5 * rng.normal(size=(n_cams, 3))).astype(np.float32)
    intr = np.array([f, f, 2000.0, 1500.0], np.float32)
    obs_cam = np.repeat(np.arange(n_cams, dtype=np.int32), obs_per_cam)
    obs_point = rng.integers(0, n_pts, n_cams * obs_per_cam).astype(np.int32)
    T = lambda a: torch.as_tensor(a, device=dev)
    xy = residuals(T(rvec), T(tvec), T(intr), T(pts), T(obs_cam), T(obs_point),
                   torch.zeros((len(obs_cam), 2), device=dev))
    ones = lambda k: torch.ones(k, dtype=torch.bool, device=dev)
    fixed = torch.zeros(n_cams, dtype=torch.bool, device=dev)
    fixed[0] = True
    rvec = rvec + 0.0005 * rng.normal(size=rvec.shape).astype(np.float32)
    tvec = tvec + 0.02 * rng.normal(size=tvec.shape).astype(np.float32)
    pts = pts + 0.05 * rng.normal(size=pts.shape).astype(np.float32)
    return BAProblem(T(rvec), T(tvec), ones(n_cams), fixed, T(intr), T(pts), ones(n_pts),
                     T(obs_cam), T(obs_point), xy.contiguous(), ones(len(obs_cam)))


def phase_run_ba_island(torch, np, dev):
    """``run_ba`` on the card with per-camera intrinsics and with the f64
    island: the ports of ``TestPerCameraIntrinsics`` (two focal groups, 300
    cameras through PCG and 200 through the dense path; PCG against dense
    with the regularization) and of ``TestF64NormalEquations`` at its own
    1,000 cameras (PCG)."""
    from sfm_tpu_torch.ba.lm import run_ba
    from sfm_tpu_torch.config import BAConfig

    # Two focal groups: the loop run out (ftol 0), the fx anchor off, as the
    # reference's test. Each camera's fx and fy within 1% of its truth; the
    # shared K the valid cameras' mean.
    for n_cams, solver in ((300, "pcg"), (200, "dense")):
        prob, fx = focal_scene(torch, np, dev, n_cams, 2000, seed=n_cams)
        cfg = BAConfig(per_camera_intrinsics=True, max_iterations=400,
                       intrinsics_reg_weight=0.0, ftol=0.0)
        t0 = time.perf_counter()
        out, st = run_ba(prob, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        intr_c = out.intr_c.cpu().numpy()
        err = np.abs(intr_c[:, :2] / fx[:, None] - 1).max()
        mean_err = float((out.intr - out.intr_c.mean(0)).abs().max() / out.intr.abs().max())
        check(st["solver"] == solver and st["cam_params"] == 10 and err <= 0.01
              and mean_err <= 1e-5 and math.isfinite(st["final_cost"])
              and st["final_cost"] < st["initial_cost"],
              f"run_ba two focals C={n_cams} ({st['solver']}): fx/fy max rel err {err}, "
              f"shared K vs mean {mean_err}, cost {st['initial_cost']} -> {st['final_cost']}")
        log(f"run_ba two focals C={n_cams} O={prob.obs_cam.shape[0]} ({solver}, B = 10): fx, fy "
            f"within {100 * err:.4f}% of 1,140 / 1,270; cost {st['initial_cost']:.6g} -> "
            f"{st['final_cost']:.6g} in {st['iterations']} iterations "
            f"({st['cg_iterations']} CG steps), {wall:.2f} s")

    # PCG against dense with the per-camera regularization (U_extra in the
    # matvec): final costs within 1e-3.
    rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy = ba_scene(
        torch, np, dev, n_cams=200, n_pts=40000, obs_per_cam=2000, seed=200)
    from sfm_tpu_torch.ba.problem import BAProblem

    C, P, O = rvec.shape[0], pts.shape[0], obs_cam.shape[0]
    ones = lambda k: torch.ones(k, dtype=torch.bool, device=dev)
    fixed = torch.zeros(C, dtype=torch.bool, device=dev)
    fixed[0] = True
    prob = BAProblem(rvec, tvec, ones(C), fixed, intr, pts, ones(P), obs_cam, obs_point, obs_xy,
                     ones(O))
    base = dict(per_camera_intrinsics=True, intrinsics_reg_weight=ISLAND_REG_W,
                max_iterations=8, cg_iters=200, cg_tol=1e-10, ftol=0.0)
    res = {}
    for below in (0, 256):
        t0 = time.perf_counter()
        _, st = run_ba(prob, BAConfig(use_dense_schur_below=below, **base))
        torch.cuda.synchronize()
        res[st["solver"]] = (st, time.perf_counter() - t0)
    (st_p, t_p), (st_d, t_d) = res["pcg"], res["dense"]
    cost_err = abs(st_p["final_cost"] - st_d["final_cost"]) / max(st_p["final_cost"],
                                                                   st_d["final_cost"])
    check(cost_err <= 1e-3 and st_p["final_cost"] < st_p["initial_cost"],
          f"run_ba B = 10 PCG vs dense C={C}: {st_p['final_cost']} vs {st_d['final_cost']}")
    log(f"run_ba B = 10 C={C} O={O}, regularization {ISLAND_REG_W}: final cost "
        f"{st_p['final_cost']:.6g} through PCG ({t_p:.2f} s, {st_p['cg_iterations']} CG steps) "
        f"vs {st_d['final_cost']:.6g} dense ({t_d:.2f} s), rel {cost_err:.2g}")

    # The f64 island past the f32 floor, at the reference's 1,000 cameras.
    prob = ill_conditioned_problem(torch, np, dev)
    base = dict(max_iterations=12, cg_iters=40, cg_tol=1e-10, ftol=0.0, use_dense_schur_below=0)
    res = {}
    for f64 in (False, True):
        t0 = time.perf_counter()
        _, st = run_ba(prob, BAConfig(f64_normal_equations=f64, **base),
                       optimize_intrinsics=False)
        torch.cuda.synchronize()
        res[f64] = (st, time.perf_counter() - t0)
    (s32, t32), (s64, t64) = res[False], res[True]
    c32, c64 = s32["final_cost"], s64["final_cost"]
    log(f"run_ba f64 vs f32, C=1000 O=40000 (PCG): f32 cost {c32:.6g} ({s32['rms_px']:.6g} px, "
        f"{t32:.2f} s), f64 {c64:.6g} ({s64['rms_px']:.6g} px, {t64:.2f} s), ratio "
        f"{c64 / c32:.4f}")
    check(s64["dtype"] == "float64" and s32["dtype"] == "float32"
          and math.isfinite(c32) and math.isfinite(c64) and c64 < 0.75 * c32
          and s64["rms_px"] < s32["rms_px"],
          f"run_ba f64 vs f32 at 1,000 cameras: {c64} vs {c32}")


def phase_dog_select(torch, dev, images, cfg):
    """K4's dog_select and dog_refine on every octave of one detection
    sub-batch of rendered images, timed on octave 0 and the -1 octave; one
    result each."""
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
    sel = dict(ms=0.0, dms=0.0, plain_ms=0.0, moved=0, ops=0)
    ref = dict(sel)
    for o in range(len(dogs) - 1, -1, -1):
        dog = dogs[o].contiguous()
        score = dog_extrema_scores_cuda(dog, ct, et)["score"]
        budget = _octave_budget(fc.max_keypoints, o)
        select = lambda: select_octave_candidates_cuda({"score": score}, budget)
        ck = select()
        cp = select_octave_candidates_plain({"score": score}, budget)
        rargs = lambda c: (dog, c["layer"], c["y"], c["x"], c["score"], ct, et)
        refine = lambda: dog_refine_cuda(*rargs(ck))
        rk, rp = refine(), dog_refine_plain(*rargs(cp))
        torch.cuda.synchronize()
        # Tolerance: the candidates (layer, y, x, score) identical and in the
        # same order; the refined offsets and gated scores bit-identical (every
        # operation rounded as the twin rounds it); both the same bits on a
        # second launch.
        for key in ("layer", "y", "x", "score"):
            check(torch.equal(ck[key], cp[key]), f"K4 dog_select octave {o - 1}: {key} differs")
        check(all(torch.equal(a, b) for a, b in zip(rk, rp)),
              f"K4 dog_refine octave {o - 1}: not bit-identical to the twin (max difference "
              f"{max(float((a - b).abs().max()) for a, b in zip(rk, rp)):.3g})")
        check_repeatable(torch, f"K4 dog_select octave {o - 1}", select, ck)
        check_repeatable(torch, f"K4 dog_refine octave {o - 1}", refine, rk)
        log(f"K4 dog_select octave {o - 1} {tuple(score.shape)}: {budget} candidates "
            f"identical in order ({int((ck['score'] > 0).sum())} nonzero); dog_refine "
            f"bit-identical ({int((rk[3] > 0).sum())} kept); both repeatable")
        if o > 1:
            continue
        times = {}
        for name, fn, plain, acc in (
                ("dog_select", select,
                 lambda: select_octave_candidates_plain({"score": score}, budget), sel),
                ("dog_refine", refine, lambda: dog_refine_plain(*rargs(cp)), ref)):
            times[name] = (median_ms(torch, fn), device_ms(torch, fn),
                           time_ms(torch, plain, reps=3, warmup=1))
            acc["ms"] += times[name][0]
            acc["dms"] = None if None in (acc["dms"], times[name][1]) else (
                acc["dms"] + times[name][1])
            acc["plain_ms"] += times[name][2]
        log(f"  octave {o - 1}: " + "; ".join(
            f"{k} wrapper {w:.4f} ms, device {fmt_ms(d)} (plain torch {p:.4f} ms)"
            for k, (w, d, p) in times.items()))
        # Selection: every score read once, the candidates written; a compare
        # per pixel for the block maxima and up to 6 passes over them.
        # Refinement: 27 values gathered and ~120 FLOP per candidate.
        n1 = score.numel() // 16
        K = ck["score"].numel()
        sel["moved"] += nbytes(score, *ck.values())
        sel["ops"] += score.numel() + 6 * n1
        ref["moved"] += K * (27 * 4 + 28) + nbytes(*rk)
        ref["ops"] += 120 * K
    return tuple(result(0.0, r["ms"], r["plain_ms"], r["moved"], r["ops"], device_ms=r["dms"])
                 for r in (sel, ref))


def phase_topk(torch, dev, cfg, merge_key):
    """K4's topk_rows at the frontend's global keypoint selection (12 images
    x every octave's budget -> max_keypoints, with planted ties and the -1
    rows of invalid candidates), the sweep's match compaction (32 pairs x
    2,048 -> 1,024, -inf padding), the ORB path's merge of the levels (one
    sub-batch's real key, 12 x 3,800 -> all 3,800 rows, and that key with
    more ties and -inf rows planted) and RANSAC's sampling without
    replacement (``ransac_sample_indices(prefix=False)``: 32 x 512 rows of
    noise over 1,024 rows, a fifth of them -inf, -> 8). Each case: values
    and indices identical to the twin; the wrapper's time and
    ``torch.topk``'s (each the median of five means of 10), the kernel's
    device time (profiler) and the bound."""
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
    rows5, n5 = 32 * 512, 1024
    x5 = torch.rand(rows5, n5, generator=g, device=dev)
    dead = torch.argsort(torch.rand(rows5, n5, generator=g, device=dev), dim=1)[:, : n5 // 5]
    x5 = x5.scatter(1, dead, -torch.inf)
    cases = (("keypoint selection", x1, fc.max_keypoints), ("match compaction", x2, 1024),
             ("ORB merge", merge_key, n3), ("ORB merge, ties planted", x3.contiguous(), n3),
             ("RANSAC sampling", x5, 8))
    ms = plain_ms = lib_ms = dev_ms = 0.0
    moved = ops = 0
    rows = []
    for what, x, k in cases:
        vk, ik = top_k_cuda(x, k)
        vp, ip = top_k_plain(x, k)
        torch.cuda.synchronize()
        # Tolerance: values and indices identical (lax.top_k's order).
        check(torch.equal(vk, vp) and torch.equal(ik, ip) and ik.dtype == torch.int64,
              f"K4 topk_rows {what} {tuple(x.shape)} k={k}")
        wrap = median_ms(torch, lambda: top_k_cuda(x, k))
        dk = device_ms(torch, lambda: top_k_cuda(x, k))
        lib = median_ms(torch, lambda: torch.topk(x, k))
        plain = time_ms(torch, lambda: top_k_plain(x, k), reps=3, warmup=1)
        # Bytes: the rows read once, k values and int64 indices a row
        # written; a compare and a few integer steps an element.
        case = result(0.0, wrap, plain, nbytes(x) + x.shape[0] * k * 12, 5 * x.numel(),
                      library_ms=lib, device_ms=dk)
        b_ms, _ = bound(case)
        log(f"K4 topk_rows, {what} {tuple(x.shape)} k={k}: identical to the stable sort; "
            f"wrapper {wrap:.4f} ms, device {fmt_ms(dk)}, torch.topk {lib:.4f} ms "
            f"({'below' if wrap < lib else 'NOT below'} it), bound {b_ms:.4f} ms (plain torch "
            f"{plain:.4f} ms)")
        rows.append({"case": what, "shape": list(x.shape), "k": k, "ms": wrap, "device_ms": dk,
                     "library_ms": lib, "plain_ms": plain, "bound_ms": b_ms})
        ms, plain_ms, lib_ms = ms + wrap, plain_ms + plain, lib_ms + lib
        dev_ms = None if dk is None or dev_ms is None else dev_ms + dk
        moved, ops = moved + case["bytes"], ops + case["ops"]
    ties = int(((merge_key[:, 1:] == merge_key[:, :-1])
                & torch.isfinite(merge_key[:, 1:])).sum())
    log(f"K4 topk_rows: the ORB merge key has {int(torch.isinf(merge_key).sum())} -inf rows and "
        f"{ties} adjacent ties; all five cases {ms:.4f} ms (torch.topk {lib_ms:.4f} ms, plain "
        f"torch {plain_ms:.4f} ms)")
    out = result(0.0, ms, plain_ms, moved, ops, library_ms=lib_ms, device_ms=dev_ms)
    out["cases"] = rows
    return out


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


# Cameras of the above-cap averaging check: the reference's global SfM ran a
# 2,000-image corridor (PROGRESS.md).
AVG_LARGE = 2000


def phase_averaging(torch, np, dev):
    """K13-b and K13-c at N = 36 and 150 cameras on corridor pair graphs
    (window 7 and 8: ~the pair counts of the 36- and 150-view tables), and
    at ``AVG_LARGE`` cameras (window 8), past the 1,024 whose state fits in
    one block's shared memory (the solve's vectors in global memory), seeded
    from the spanning tree as the global path and polish seed them, against
    their dense twins; the large solves also repeat bitwise."""
    from sfm_tpu_torch.config import GlobalInitConfig
    from sfm_tpu_torch.io.calib import umeyama
    from sfm_tpu_torch.reconstruction import global_init as gi

    cfg = GlobalInitConfig()
    out = {}
    for N, window in ((36, 7), (150, 8), (AVG_LARGE, 8)):
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
        check(r_gt <= 2.0 or N == AVG_LARGE,
              f"K13-b at N={N}: median {r_gt} deg from the truth")
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
        if N == AVG_LARGE:
            check_repeatable(torch, f"K13-b at N={N}", lambda: gi.rotation_average_cuda(*rargs),
                             Rk)
            check_repeatable(torch, f"K13-c at N={N}",
                             lambda: gi.translation_average_cuda(*targs), Ck)
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
    # The kernels' rows: N = 150, polish's size on the 150-view corridor;
    # the large solves beside them.
    for row, big in zip(out[150], out[AVG_LARGE]):
        row["n2000"] = big
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


def ba_calls(out: Path, what: str) -> list:
    """The run's ``ba/solve`` records (one a BA call); checks each final cost
    is finite and no higher than its initial cost."""
    calls = [r for r in json.loads((out / "metrics.json").read_text())
             if r["name"] == "ba/solve"]
    check(len(calls) > 0, f"{what}: no BA call")
    for r in calls:
        check(math.isfinite(r["final_cost"]) and r["final_cost"] <= r["initial_cost"],
              f"{what}: BA call {r['call']} cost {r['initial_cost']} -> {r['final_cost']}")
    return calls


def check_path_h(np, torch, huge: Path, out_huge: Path, huge_metrics: dict, huge_wall: float,
                 huge_peak: int, windows: dict, H: int) -> list:
    """Path h's checks (see the module docstring); returns its report lines.
    ``windows``: run name -> (output dir, cli wall, stage seconds)."""
    gt = lambda st: (f"GT rotation median {st.get('gt_rot_err_deg_median', float('nan')):.4f} "
                     f"deg, ATE {100 * st.get('gt_ate_rel', float('nan')):.3f}% of the scene")
    engine = lambda m: ", ".join(f"{k.split('/')[1]} {v:.3f} s" for k, v in sorted(m.items())
                                 if k.startswith("engine/"))
    from sfm_tpu_torch.config import SfMConfig

    hb = pickle.loads((out_huge / "pair_table.pkl").read_bytes())
    ht = hb["table"]
    check(len(hb["image_paths"]) == H, f"path h: {len(hb['image_paths'])} images")
    check(ht.num_pairs < H * (H - 1) // 2, f"path h: retrieval kept all {ht.num_pairs} pairs")
    check((accepted_degree(np, ht, H) > 0).all(), "path h: an image is in no accepted pair")
    huge_med = gt_epipolar_check(np, torch, huge, hb)

    def min_cameras(run: str) -> int:
        share = HUGE_MIN_CAMERA_SHARE[run]
        return H - 1 if share is None else math.floor(share * H)

    fill_calls = [r for r in json.loads((out_huge / "metrics.json").read_text())
                  if r["name"] == "ba/fill"]
    check(len(fill_calls) == len(ba_calls(out_huge, "path h")),
          "path h: a BA call logged no track table fill")
    # The calls that the reference would route by the fill: > 256 registered.
    fills = [r["value"] for r in fill_calls
             if r["registered"] > SfMConfig().ba.use_dense_schur_below]
    hs = json.loads((out_huge / "reconstruction" / "stats.json").read_text())
    h_calls = ba_calls(out_huge, "path h")
    check(all(r["value"] == "pcg" and r["cameras"] == H and r["cg_iterations"] > 0
              for r in h_calls), "path h: a BA call did not run on PCG")
    check(hs["num_cameras"] >= min_cameras("pipeline_huge"),
          f"path h: {hs['num_cameras']}/{H} cameras, gate {min_cameras('pipeline_huge')}")
    gated = [(hs, "path h")]
    win_st = {}
    for name, (win, _, _) in windows.items():
        ws = json.loads((win / "reconstruction" / "stats.json").read_text())
        calls = ba_calls(win, f"path h, {name}")
        local = [r for r in calls if r["local"]]
        check(len(local) > 0, f"path h, {name}: no restricted BA call")
        check(not calls[-1]["local"] and calls[-1]["value"] == "pcg",
              f"path h, {name}: the final BA call is not global on PCG")
        check(all((r["value"] == "pcg") == (r["cameras"] > SfMConfig().ba.use_dense_schur_below)
                  for r in calls), f"path h, {name}: a BA call took the other solver")
        win_st[name] = (ws, calls, local)
        check(ws["num_cameras"] >= 2 and ws["num_points"] > 0
              and math.isfinite(ws["mean_reprojection_error"]),
              f"path h, {name}: {ws['num_cameras']} cameras, {ws['num_points']} points, "
              f"{ws['mean_reprojection_error']} px")
        if name in HUGE_MIN_CAMERA_SHARE:
            gated.append((ws, f"path h, {name}"))
            check(ws["num_cameras"] >= min_cameras(name),
                  f"path h, {name}: {ws['num_cameras']}/{H} cameras, gate {min_cameras(name)}")
    for st_, what in gated:
        check(st_["num_points"] > 1000, f"{what}: {st_['num_points']} points")
        check(st_["mean_reprojection_error"] < 0.6,
              f"{what}: mean reprojection {st_['mean_reprojection_error']}")

    out = []
    h_det, h_ret, h_sweep = (huge_metrics[f"stage/{k}"] for k in ("detect", "retrieval", "sweep"))
    out.append(
        f"path h at {H} views: {ht.num_pairs} of {H * (H - 1) // 2} pairs swept, "
        f"{len(ht.accepted())} accepted; GT check median {np.median(huge_med):.3f} px, worst "
        f"{huge_med.max():.3f} px; detect {h_det:.3f} s, retrieval {h_ret:.3f} s, sweep "
        f"{h_sweep:.3f} s = {ht.num_pairs / h_sweep:.1f} pairs/s")
    out.append(
        f"path h: {hs['num_cameras']}/{H} cameras (gate {min_cameras('pipeline_huge')}), "
        f"{hs['num_points']} points, mean reprojection {hs['mean_reprojection_error']:.4f} px; "
        f"{gt(hs)} (recorded, not gated); {len(h_calls)} BA calls, all PCG, "
        f"{sum(r['cg_iterations'] for r in h_calls)} CG steps, "
        f"{sum(r['iterations'] for r in h_calls)} LM iterations; track table fill "
        f"{min(r['value'] for r in fill_calls):.4f}-{max(r['value'] for r in fill_calls):.4f}"
        f", at the calls with > {SfMConfig().ba.use_dense_schur_below} registered "
        + (f"{min(fills):.4f}-{max(fills):.4f} (last {fills[-1]:.4f})" if fills else "none"))
    out.append(
        f"path h: preprocess stage {huge_metrics['stage/preprocess']:.3f} s, reconstruct stage "
        f"{huge_metrics['stage/reconstruct']:.3f} s | cli wall {huge_wall:.3f} s | peak device "
        f"memory {huge_peak / 2**30:.2f} GiB | engine: {engine(huge_metrics)}")
    for name, (ws, calls, local) in win_st.items():
        _, w_wall, w_metrics = windows[name]
        gate = (f"gate {min_cameras(name)}" if name in HUGE_MIN_CAMERA_SHARE
                else "model printed, not gated")
        out.append(
            f"path h, {name} {json.dumps(WINDOW_CONFIGS[name])}: {ws['num_cameras']}/{H} "
            f"cameras ({gate}), {ws['num_points']} points, mean reprojection "
            f"{ws['mean_reprojection_error']:.4f} px; {gt(ws)}; {len(local)} restricted calls "
            f"(largest {max(r['cameras'] for r in local)} cameras, "
            f"{sum(r['value'] == 'pcg' for r in local)} on PCG), {len(calls) - len(local)} "
            f"global; reconstruct stage {w_metrics['stage/reconstruct']:.3f} s | cli wall "
            f"{w_wall:.3f} s | engine: {engine(w_metrics)}")
    return out


def check_path_i(runs: dict, counts: dict, views: dict, ref_metrics: dict) -> list:
    """Path i's checks (see the module docstring); returns its report lines.
    ``runs``: name -> (output dir, cli wall, stage seconds); ``counts``: the
    launches over all of path i; ``views``: the image count of each source;
    ``ref_metrics``: path d's and path h's stage seconds."""
    for row in ISLAND_ROWS:
        for entry in KERNELS[row][0]:
            check(counts[entry] > 0, f"path i: kernel {entry} was not launched")
    out = []
    engine_ba = lambda m: m.get("engine/ba", float("nan"))
    for name, (run_dir, wall, metrics) in runs.items():
        src, _, (cam_params, dtype), solver = PATH_I[name]
        st = json.loads((run_dir / "reconstruction" / "stats.json").read_text())
        calls = ba_calls(run_dir, f"path i, {name}")
        check(all(r["cam_params"] == cam_params and r["dtype"] == dtype for r in calls),
              f"path i, {name}: a BA call off the route {cam_params} / {dtype}")
        check(all(r["value"] == solver for r in calls if not r["local"]),
              f"path i, {name}: a BA call not on {solver}")
        check(st["num_cameras"] >= 2 and st["num_points"] > 0
              and math.isfinite(st["mean_reprojection_error"]),
              f"path i, {name}: {st['num_cameras']} cameras, {st['num_points']} points, "
              f"{st['mean_reprojection_error']} px")
        n = views[src]
        if name in PATH_I_GATED:
            gate = math.floor(PATH_I_GATED[name] * n)
            check(st["num_cameras"] >= gate, f"path i, {name}: {st['num_cameras']}/{n} cameras, "
                  f"gate {gate}")
            check(st["num_points"] > 1000, f"path i, {name}: {st['num_points']} points")
            check(st["mean_reprojection_error"] < 0.6,
                  f"path i, {name}: mean reprojection {st['mean_reprojection_error']}")
            gated = f"gate {gate} cameras, > 1,000 points, < 0.6 px"
        else:
            gated = "finite and printed, not gated"
        intr = json.loads((run_dir / "reconstruction" / "intrinsics.json").read_text())
        out.append(
            f"path i, {name} {json.dumps(PATH_I[name][1])}: {st['num_cameras']}/{n} cameras, "
            f"{st['num_points']} points, mean reprojection {st['mean_reprojection_error']:.4f} "
            f"px, GT rotation median {st.get('gt_rot_err_deg_median', float('nan')):.4f} deg "
            f"({gated}); intrinsics {json.dumps({k: round(v, 2) for k, v in intr.items()})}; "
            f"{len(calls)} BA calls ({cam_params}, {dtype}), {sum(r['iterations'] for r in calls)} "
            f"LM iterations, {sum(r['cg_iterations'] for r in calls)} CG steps; engine/ba "
            f"{engine_ba(metrics):.3f} s (path d {engine_ba(ref_metrics['path d']):.3f} s, "
            f"path h {engine_ba(ref_metrics['path h']):.3f} s), reconstruct stage "
            f"{metrics['stage/reconstruct']:.3f} s, cli wall {wall:.3f} s")
    out.append("path i launches: " + ", ".join(
        f"{e} {counts[e]}" for row in ISLAND_ROWS for e in KERNELS[row][0]))
    return out


# The kernels of each entry path d's traces (its preprocess and its
# reconstruct, each run once more) are read for, by name.
PATH_D_TRACED = {
    "build_pyramid": ("blur_layer_kernel",),
    "dog_extrema": ("dog_extrema",),
    "dog_select": ("select_pass_kernel", "select_cand_kernel", "select_count_kernel",
                   "select_write_kernel", "rank_sort_kernel", "cell_gather_kernel",
                   "select_final_kernel", "topk_block_kernel<1>"),
    "dog_refine": ("dog_refine_kernel",),
    "sift_describe": ("sift_describe",),
    "retrieval_score": ("retrieval_score_kernel", "retrieval_resident_kernel"),
    "schur_cholesky_solve": ("cholesky_kernel",),
}


def path_d_kernel_totals(by_name) -> dict:
    """{entry: (kernels, device ms)} of PATH_D_TRACED from a trace's
    ``by_name`` rows."""
    return {entry: (sum(c for n, c, _ in by_name if any(k in n for k in keys)),
                    sum(ms for n, _, ms in by_name if any(k in n for k in keys)))
            for entry, keys in PATH_D_TRACED.items()}


def model_of(out: Path) -> tuple:
    """A run's model as ``MODELS_BEFORE`` holds it."""
    st = json.loads((out / "reconstruction" / "stats.json").read_text())
    return (st["num_cameras"], st["num_points"], round(st["mean_reprojection_error"], 4),
            round(st.get("gt_rot_err_deg_median", float("nan")), 4))


def same_model(name: str, out: Path, models: dict = MODELS_BEFORE) -> bool:
    """The run read the model of ``models`` (``MODELS_BEFORE`` by default)."""
    before = models.get(name)
    return before is not None and all(b is None or a == b
                                      for a, b in zip(model_of(out), before))


def log_model(name: str, out: Path):
    """Print a run's model as soon as it is written (path h's readings stay in
    the log whatever a later check finds), beside the models it read with
    cuSOLVER's dense solve (``MODELS_BEFORE``), with the first design of
    K10's Cholesky kernel (``MODELS_FIRST_CHOLESKY``) and with its redesign
    (``MODELS_PINNED``, which every run must read); ``MODEL_DIRS`` keeps the
    run's directory for that check."""
    MODEL_DIRS[name] = out
    st = json.loads((out / "reconstruction" / "stats.json").read_text())
    intr = json.loads((out / "reconstruction" / "intrinsics.json").read_text())
    fmt = lambda x, f: "-" if x is None else format(x, f)
    was = ""
    for what, models in (("cuSOLVER's dense solve", MODELS_BEFORE),
                         ("the first Cholesky kernel", MODELS_FIRST_CHOLESKY),
                         ("the pinned models", MODELS_PINNED)):
        before = models.get(name)
        if before is not None:
            was += (f" | with {what}: {before[0]} cameras, {fmt(before[1], 'd')} points, "
                    f"{fmt(before[2], '.4f')} px, {fmt(before[3], '.4f')} deg: "
                    f"{'the same' if same_model(name, out, models) else 'OTHER'}")
    log(f"{name}: {st['num_cameras']} cameras, {st['num_points']} points, mean reprojection "
        f"{st['mean_reprojection_error']:.4f} px, GT rotation median "
        f"{st.get('gt_rot_err_deg_median', float('nan')):.4f} deg, ATE "
        f"{100 * st.get('gt_ate_rel', float('nan')):.3f}% of the scene; final intrinsics "
        f"{json.dumps(intr)} (rendered: fx = fy = 1228, cx 512, cy 384){was}")


def check_model(st: dict, n_img: int, what: str, min_cameras=None):
    """Cameras (all but at most one, or ``min_cameras``), > 1,000 points,
    < 0.6 px."""
    gate = n_img - 1 if min_cameras is None else min_cameras
    check(st["num_cameras"] >= gate,
          f"{what}: {st['num_cameras']}/{n_img} cameras, gate {gate}")
    check(st["num_points"] > 1000, f"{what}: {st['num_points']} points")
    check(st["mean_reprojection_error"] < 0.6,
          f"{what}: mean reprojection {st['mean_reprojection_error']}")


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=36, help="rendered 1024x768 views")
    ap.add_argument("--large_views", type=int, default=150,
                    help="views of the retrieval-scale pipeline run")
    ap.add_argument("--huge_views", type=int, default=300,
                    help="views of the PCG-scale pipeline run (path h)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    MODEL_DIRS.clear()

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
    huge = work / f"scene_{args.huge_views}"
    work.mkdir(parents=True, exist_ok=True)

    # One view a task in a pool of half the host's cores (this process drives
    # the card meanwhile, and its paths are host-bound).
    render = subprocess.Popen(
        [sys.executable, "-c",
         "import os, sys; from sfm_tpu_torch.render_scene import render_dataset; "
         "w = max(2, (os.cpu_count() or 4) // 2); "
         "[render_dataset(d, int(n), supersample=1, log=print, workers=w) "
         "for d, n in zip(sys.argv[1::2], sys.argv[2::2])]",
         str(scene), str(args.views), str(large), str(args.large_views), str(huge),
         str(args.huge_views)], cwd=REPO, start_new_session=True)

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
        for entry in [e for k in required for e in KERNELS[k][0]
                      if e not in PHASE_ONLY_ENTRIES] + list(entries):
            check(counts[entry] > 0, f"kernel {entry} was not launched by {name}")
        for entry in forbidden:
            check(counts[entry] == 0, f"kernel {entry} was launched by {name}")
        n_chol = sum(counts[e] for e in CHOLESKY_ENTRIES)
        n_coup = sum(counts[e] for e in COUPLING_ENTRIES)
        check(n_chol == n_coup, f"{name}: {n_chol} dense solves for {n_coup} assembled S")
        log(f"{name} (done at {time.perf_counter() - t_start:.1f} s): cli wall {wall:.3f} s, "
            f"peak device memory "
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
                   **phase_pnp(torch, np, dev),
                   "pnp_refine": phase_pnp_refine(torch, np, dev),
                   "pnp_dlt": phase_pnp_dlt(torch, np, dev),
                   "triangulate_tracks": phase_triangulate(torch, np, dev),
                   "retrieval_score": phase_retrieval_score(torch, np, dev),
                   "guided_match": phase_guided_match(torch, dev),
                   "seed_score": phase_seed_score(torch, np, dev)}
        results["fmat_ransac"] = phase_fmat(torch, np, dev)
        systems = {}   # the real S of the BA phases, for the dense solve's phase
        results["ba_linearize"], results["schur_coupling"] = phase_ba(torch, np, dev, systems)
        results["schur_damp"] = phase_schur_damp(torch, np, dev)
        results["schur_block_jacobi"], results["schur_matvec"], results["pcg"] = phase_pcg(
            torch, np, dev)
        phase_run_ba_pcg(torch, np, dev)
        for route in ISLAND_ROUTES:
            results.update(phase_island(torch, np, dev, route, systems))
            torch.cuda.empty_cache()
        results["schur_cholesky"], results["schur_cholesky_f64"] = phase_dense_solve(
            torch, np, dev, systems)
        del systems
        phase_run_ba_island(torch, np, dev)
        torch.cuda.empty_cache()
        for name, big in phase_ba_above_cap(torch, np, dev).items():
            results[name]["c5000"] = big
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
        results["sift_describe"] = phase_describe(torch, dev, images, cfg)
        results["dog_select"], results["dog_refine"] = phase_dog_select(torch, dev, images,
                                                                        cfg)
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
        log_model("reconstruct", out)
        rec_peak = torch.cuda.max_memory_allocated()
        # The same reconstruct again on the same pair table: the model must
        # repeat bit for bit (the BA sums are order-free).
        again = work / f"reconstruct_{args.views}_again"
        again.mkdir(parents=True, exist_ok=True)
        (again / "pair_table.pkl").write_bytes((out / "pair_table.pkl").read_bytes())
        check(cli.main(["--log_level", "WARNING", "--log_dir", str(work / "logs"), "reconstruct",
                        "--data_dir", str(scene), "--output_dir", str(again), "--device", "cuda",
                        "--no_mask"]) == 0, "the repeated reconstruct failed")
        for f in ("reconstruction/poses.json", "reconstruction/points3D.json"):
            check((again / f).read_bytes() == (out / f).read_bytes(),
                  f"reconstruct: a second run on the same pair table wrote another {f}")
        log("reconstruct repeated on the same pair table: poses.json and points3D.json "
            "identical")

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
        log_model("rescue", rescue)

        # ---- path d: python -m sfm_tpu_torch pipeline on the retrieval-scale scene
        wait_for(large)
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
        log_model("pipeline", out_large)
        # Path d's preprocess once more, traced (the CLI's torch.profiler
        # capture): the device time of K3's and K4's kernels in its detect.
        traced = work / f"traced_{args.large_views}"
        check(cli.main(["--log_level", "WARNING", "--log_dir", str(work / "logs"), "preprocess",
                        "--data_dir", str(large), "--output_dir", str(traced), "--device",
                        "cuda", "--no_mask", "--trace_dir", str(traced / "trace")]) == 0,
              "the traced preprocess failed")
        from sfm_tpu_torch.profile_stage import SPANS, trace_summary

        detect_trace = trace_summary(traced / "trace" / "trace.json")
        # And its reconstruct, traced: the dense solve's device time.
        traced_rec = work / f"traced_rec_{args.large_views}"
        traced_rec.mkdir(parents=True, exist_ok=True)
        (traced_rec / "pair_table.pkl").write_bytes((out_large / "pair_table.pkl").read_bytes())
        check(cli.main(["--log_level", "WARNING", "--log_dir", str(work / "logs"), "reconstruct",
                        "--data_dir", str(large), "--output_dir", str(traced_rec), "--device",
                        "cuda", "--no_mask", "--trace_dir", str(traced_rec / "trace")]) == 0,
              "the traced reconstruct failed")
        rec_trace = trace_summary(traced_rec / "trace" / "trace.json", SPANS["reconstruct"])

        # ---- path e: reconstruct --global_init on path a's 36-view artifacts
        glob = work / f"global_{args.views}"
        glob.mkdir(parents=True, exist_ok=True)
        (glob / "pair_table.pkl").write_bytes((out / "pair_table.pkl").read_bytes())
        c, glob_wall = run_path("global", ["reconstruct", "--data_dir", str(scene),
                                           "--output_dir", str(glob), "--global_init"],
                                GLOBAL_KERNELS)
        add(c, "global")
        glob_metrics = stage_seconds(glob)
        log_model("global", glob)

        # ---- path f: reconstruct --polish on path d's 150-view artifacts
        pol = work / f"polish_{args.large_views}"
        pol.mkdir(parents=True, exist_ok=True)
        (pol / "pair_table.pkl").write_bytes((out_large / "pair_table.pkl").read_bytes())
        c, pol_wall = run_path("polish", ["reconstruct", "--data_dir", str(large),
                                          "--output_dir", str(pol), "--polish"],
                               POLISH_KERNELS)
        add(c, "polish")
        pol_metrics = stage_seconds(pol)
        log_model("polish", pol)

        # ---- path g: pipeline --feature_kind orb on the --views scene
        orb = work / f"orb_{args.views}"
        orb.mkdir(parents=True, exist_ok=True)
        SfMConfig(features=FeatureConfig(fast_threshold=ORB_FAST_THRESHOLD)).to_json(
            orb / "config.json")
        c, orb_wall = run_path("orb", ["pipeline", "--data_dir", str(scene), "--output_dir",
                                       str(orb), "--feature_kind", "orb", "--config",
                                       str(orb / "config.json")],
                               ORB_KERNELS, forbidden=SIFT_ONLY_ENTRIES)
        add(c, "orb")
        orb_metrics = stage_seconds(orb)
        log_model("orb", orb)
        orb_peak = torch.cuda.max_memory_allocated()

        # ---- path h: pipeline past use_dense_schur_below images (PCG), then
        # reconstruct with windowed local BA on its artifacts
        wait_for(huge)
        check(render.wait(timeout=900) == 0, "rendering the scenes failed")
        out_huge = work / f"pipeline_{args.huge_views}"
        c, huge_wall = run_path("pipeline_huge", ["pipeline", "--data_dir", str(huge),
                                                  "--output_dir", str(out_huge)],
                                HUGE_KERNELS, forbidden=DENSE_ENTRIES)
        add(c, "pipeline_huge")
        huge_metrics = stage_seconds(out_huge)
        huge_peak = torch.cuda.max_memory_allocated()
        log_model("pipeline_huge", out_huge)
        windows = {}
        for name, wcfg in WINDOW_CONFIGS.items():
            win = work / f"{name}_{args.huge_views}"
            win.mkdir(parents=True, exist_ok=True)
            (win / "pair_table.pkl").write_bytes((out_huge / "pair_table.pkl").read_bytes())
            c, w_wall = run_path(name, ["reconstruct", "--data_dir", str(huge), "--output_dir",
                                        str(win), "--config", json.dumps(wcfg)], WINDOW_KERNELS)
            add(c, name)
            windows[name] = (win, w_wall, stage_seconds(win))
            log_model(name, win)

        # ---- path i: the BA island's other routes on those artifacts
        sources = {"views": (scene, out), "large": (large, out_large), "huge": (huge, out_huge)}
        island_runs, island_counts = {}, {k: 0 for k in _kernels.KERNELS}
        for name, (src, icfg, _, _) in PATH_I.items():
            data, art = sources[src]
            run_dir = work / f"island_{name}"
            run_dir.mkdir(parents=True, exist_ok=True)
            (run_dir / "pair_table.pkl").write_bytes((art / "pair_table.pkl").read_bytes())
            c, i_wall = run_path(name, ["reconstruct", "--data_dir", str(data), "--output_dir",
                                        str(run_dir), "--config", json.dumps(icfg)],
                                 ("pnp_ransac",))
            add(c, name)
            for k, v in c.items():
                island_counts[k] += v
            island_runs[name] = (run_dir, i_wall, stage_seconds(run_dir))
            log_model(name, run_dir)

        # ---- path j: reconstruct with PnP's DLT branch on path a's artifacts
        dlt = work / f"dlt_{args.views}"
        dlt.mkdir(parents=True, exist_ok=True)
        (dlt / "pair_table.pkl").write_bytes((out / "pair_table.pkl").read_bytes())
        c, dlt_wall = run_path("dlt", ["reconstruct", "--data_dir", str(scene), "--output_dir",
                                       str(dlt), "--config", json.dumps(PATH_J_CONFIG)],
                               DLT_KERNELS, forbidden=("p3p_ransac", "p3p_solve"))
        add(c, "dlt")
        dlt_metrics = stage_seconds(dlt)
        log_model("dlt", dlt)
    finally:
        if render.poll() is None:   # the renderer and its pool workers
            os.killpg(render.pid, signal.SIGKILL)
            render.wait()

    # ---- the runs without a dense step read the models they read before
    run_dirs = {"pipeline_huge": out_huge, **{k: v[0] for k, v in island_runs.items()}}
    moved = [r for r in PCG_ONLY_RUNS if not same_model(r, run_dirs[r])]
    check(not moved, f"runs without a dense BA step read another model than MODELS_BEFORE: "
                     f"{', '.join(moved)}")

    # ---- every run reads the pinned model
    moved = [r for r in MODELS_PINNED if r not in MODEL_DIRS
             or not same_model(r, MODEL_DIRS[r], MODELS_PINNED)]
    check(not moved, f"runs that read another model than MODELS_PINNED (or none): "
                     f"{', '.join(moved)}")

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
    check_model(ls, L, "pipeline", PATH_D_MIN_CAMERAS)
    check(ls.get("gt_rot_err_deg_median", float("inf")) < PATH_D_MAX_GT_DEG,
          f"pipeline: GT rotation median {ls.get('gt_rot_err_deg_median')} deg, gate "
          f"{PATH_D_MAX_GT_DEG:.2f}")
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

    # ---- path h's checks: every BA call on PCG, the model; then local BA
    h_report = check_path_h(np, torch, huge, out_huge, huge_metrics, huge_wall, huge_peak,
                            windows, args.huge_views)

    # ---- path i's checks: every BA call on its route, every new entry launched
    i_report = check_path_i(island_runs, island_counts,
                            {"views": n_img, "large": args.large_views, "huge": args.huge_views},
                            {"path d": large_metrics, "path h": huge_metrics})
    # ---- path j's checks: the DLT branch's model
    ds = json.loads((dlt / "reconstruction" / "stats.json").read_text())
    dlt_calls = ba_calls(dlt, "dlt")
    check(ds["num_cameras"] >= PATH_J_MIN_CAMERAS,
          f"dlt: {ds['num_cameras']}/{n_img} cameras, gate {PATH_J_MIN_CAMERAS}")
    check(ds["mean_reprojection_error"] < 0.6,
          f"dlt: mean reprojection {ds['mean_reprojection_error']}")
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
        f"{100 * ls.get('gt_ate_rel', float('nan')):.3f}% of the scene (gates: >= "
        f"{PATH_D_MIN_CAMERAS} cameras, < {PATH_D_MAX_GT_DEG:.2f} deg; read with cuSOLVER's "
        f"dense solve: 150 cameras, "
        f"18,587 points, 0.5564 px, 22.6208 deg); "
        f"{tracks.num_tracks} tracks x {tracks.max_views} view slots = "
        f"{tracks.view_img.size} BA table rows before compaction")
    log(f"pipeline at {L} views: stage/detect {large_metrics['stage/detect']:.3f} s (PR 15's "
        f"warm median: 1.10 s); traced preprocess: detect span "
        f"{detect_trace['detect']['span_s']:.4f} s, device busy "
        f"{detect_trace['detect']['device_busy_s']:.4f} s; device ms by kernel (launches; "
        f"the dense solve's from the traced reconstruct): "
        + "; ".join(f"{name} {ms:.3f} ({c})" for name, (c, ms) in
                    path_d_kernel_totals(detect_trace["by_name"]
                                         + rec_trace["by_name"]).items()))
    log(f"dense solve on path d: {by_path['pipeline']['schur_cholesky_solve']} launches (one a "
        f"dense BA step, as schur_coupling's {by_path['pipeline']['schur_coupling']}); the "
        f"kernel's device {fmt_ms(results['schur_cholesky'].get('device_ms'))} a call at n = "
        f"{DENSE_SOLVE_N}; traced reconstruct: sfm/ba span "
        f"{rec_trace.get('sfm/ba', {}).get('span_s', float('nan')):.4f} s, device busy "
        f"{rec_trace.get('sfm/ba', {}).get('device_busy_s', float('nan')):.4f} s")
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
    for line in h_report + i_report:
        log(line)
    log(f"dlt at {n_img} views ({json.dumps(PATH_J_CONFIG)}): {ds['num_cameras']}/{n_img} "
        f"cameras (gate {PATH_J_MIN_CAMERAS}), {ds['num_points']} points, mean reprojection "
        f"{ds['mean_reprojection_error']:.4f} px; {gt(ds)} (recorded, not gated; path b: "
        f"{gt(st)}); {len(dlt_calls)} BA calls, cost finite and down; cli wall "
        f"{dlt_wall:.3f} s | engine: {engine(dlt_metrics)}")
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
        if "n2000" in r:  # K13 past the cameras whose state fits in shared memory
            b = r["n2000"]
            b_ms, b_by = bound(b)
            row["n2000"] = {"ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b_ms,
                            "bound_by": b_by, "max_abs_err": b["max_abs_err"]}
            log(f"  {name} at N={AVG_LARGE}: {b['ms']:.4f} ms (plain torch {b['plain_ms']:.4f} "
                f"ms, bound {b_ms:.4f} ms by {b_by})")
        if "device_ms" in r:   # the profiler's kernel time beside the wrapper's
            row["device_ms"] = r["device_ms"]
            log(f"  {name}: device {fmt_ms(r['device_ms'])}")
        if "bmm_ms" in r:   # K1: torch.bmm of the product alone (not the same function)
            row["bmm_ms"] = r["bmm_ms"]
        if "cost" in r:   # K8's ba_cost entry beside the linearization
            b = r["cost"]
            b_ms, b_by = bound(b)
            row["cost"] = {"ms": b["ms"], "device_ms": b["device_ms"],
                           "plain_ms": b["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
                           "max_abs_err": b["max_abs_err"]}
            log(f"  {name}'s cost: {b['ms']:.4f} ms, device {fmt_ms(b['device_ms'])} (plain "
                f"torch {b['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by})")
        if "cases" in r:   # one row a caller's shape (topk_rows)
            row["cases"] = r["cases"]
        if "point_major" in r:   # K11's matvec on the same system in point-major order
            row["point_major"] = r["point_major"]
            log(f"  {name} in point-major order: {r['point_major']['ms']:.4f} ms, device "
                f"{fmt_ms(r['point_major']['device_ms'])}")
        if "c5000" in r:  # K10 / K11 with the camera sums in global memory
            b = r["c5000"]
            b_ms, b_by = bound(b)
            row["c5000"] = {k: b[k] for k in ("cameras", "ms", "plain_ms", "max_abs_err",
                                              "library_ms", "device_ms", "steps") if k in b}
            row["c5000"].update(bound_ms=b_ms, bound_by=b_by)
            log(f"  {name} at C={b['cameras']}: {b['ms']:.4f} ms, device "
                f"{fmt_ms(b.get('device_ms'))} (plain torch "
                f"{fmt_ms(b.get('plain_ms'))}, library {fmt_ms(b.get('library_ms'))}, bound "
                f"{b_ms:.4f} ms by {b_by})")
        if "d256" in r:   # the same kernel held on +-1/16 descriptors at D = 256
            b = r["d256"]
            b_ms, b_by = bound(b)
            row["d256"] = {"ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": b_ms,
                           "bound_by": b_by, "max_abs_err": b["max_abs_err"],
                           **{k: b[k] for k in ("device_ms", "bmm_ms") if k in b}}
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
