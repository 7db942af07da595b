#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sfm_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--views 36]

1. Builds the port's CUDA kernels from ``sfm_tpu_torch/csrc`` (nvcc, sm_90a).
2. Holds each kernel against its plain PyTorch twin at the main path's shapes
   and times both with CUDA events.
3. Renders ``--views`` 1024x768 views of the textured corridor
   (``scripts/render_scene.py``, in a subprocess, so that this process never
   imports the JAX package) and runs the port's preprocess stage on them,
   ``python -m sfm_tpu_torch preprocess --device cuda --no_mask`` with the
   default SfMConfig, through ``sfm_tpu_torch.cli`` in this process. Every
   kernel launch counter is reset just before.
4. Checks the run: every kernel of the path launched, >= 500 valid keypoints
   per image, every image in an accepted pair, the artifacts written, and the
   accepted pairs' inliers consistent with the rendered cameras' ground-truth
   epipolar geometry.

Prints the card (nvidia-smi), per-kernel and stage numbers, a JSON line of
the kernels and, last, ``{"ok": true, "device": {...}}``. Any failure raises;
without a card, or outside a checkout of the repository, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import argparse
import json
import math
import pickle
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

KERNELS = {
    # name: (source, the JAX program it replaces)
    "match_top2": ("sfm_tpu_torch/csrc/match_top2.cu", "sfm_tpu/matching/core.py:51"),
    "fmat_score_select": ("sfm_tpu_torch/csrc/fmat_ransac.cu",
                          "sfm_tpu/estimators/fundamental.py:20"),
    "dog_extrema": ("sfm_tpu_torch/csrc/dog_extrema.cu", "sfm_tpu/features/detect.py:23"),
    "sift_describe": ("sfm_tpu_torch/csrc/sift_describe.cu",
                      "sfm_tpu/features/descriptor.py:371"),
}


def log(msg: str):
    print(msg, flush=True)


def check(cond, msg: str):
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


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
    two cameras, 0.5 px noise, 30% outliers, a valid prefix of 300..M rows."""
    rng = np.random.default_rng(seed)
    K = np.array([[1228.0, 0, 512.0], [0, 1228.0, 384.0], [0, 0, 1.0]])
    p1 = np.zeros((B, M, 2), np.float32)
    p2 = np.zeros((B, M, 2), np.float32)
    valid = np.zeros((B, M), bool)
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
        valid[b, : rng.integers(300, M + 1)] = True
    return p1 * valid[..., None], p2 * valid[..., None], valid


# ---------------------------------------------------------------- kernel phases

def phase_match_top2(torch, dev):
    """K1 at 32 pairs x K=2048 x D=128 (one sweep chunk, one direction)."""
    from sfm_tpu_torch.matching.core import match_top2_cuda, match_top2_plain

    g = torch.Generator(device=dev).manual_seed(1)
    B, K, D = 32, 2048, 128
    d1 = _unit(torch, torch.randn(B, K, D, generator=g, device=dev))
    d2 = _unit(torch, torch.randn(B, K, D, generator=g, device=dev))
    perm = torch.randperm(K, generator=g, device=dev)[:1200]
    d2[:, :1200] = _unit(torch, d1[:, perm] + 0.08 * torch.randn(B, 1200, D, generator=g,
                                                                 device=dev))
    v1 = torch.rand(B, K, generator=g, device=dev) > 0.05
    v2 = torch.rand(B, K, generator=g, device=dev) > 0.05
    args = (d1, v1, d2, v2)
    idx_k, best_k, sec_k = match_top2_cuda(*args)
    idx_p, best_p, sec_p = match_top2_plain(*args)
    torch.cuda.synchronize()
    # Tolerance: indices equal; distances within 1e-5 absolute (another
    # summation order).
    fin = torch.isfinite(best_p)
    check(torch.equal(torch.isfinite(best_k), fin), "K1: finite pattern differs")
    fin2 = torch.isfinite(sec_p)
    err = max(float((best_k - best_p)[fin].abs().max()),
              float((sec_k - sec_p)[fin2].abs().max()))
    check(err <= 1e-5, f"K1: distance error {err}")
    check(torch.equal(idx_k, idx_p),
          f"K1: best index differs in {int((idx_k != idx_p).sum())} of {B * K} rows")
    log(f"K1 match_top2: max_abs_err {err:.3g}, indices equal in all {B * K} rows")
    ms = time_ms(torch, lambda: match_top2_cuda(*args))
    plain_ms = time_ms(torch, lambda: match_top2_plain(*args))
    return err, ms, plain_ms


def phase_fmat(torch, np, dev):
    """K2 at 32 pairs x 512 hypotheses x 256 scoring rows (one sweep chunk)."""
    from sfm_tpu_torch.estimators.fundamental import (
        fmat_score_select_cuda, fmat_score_select_plain)
    from sfm_tpu_torch.estimators.ransac import ransac_sample_indices
    from sfm_tpu_torch.geometry.epipolar import eight_point, symmetric_epipolar_distance

    B, M, H, N, thr = 32, 1024, 512, 256, 3.0
    p1, p2, valid = (torch.as_tensor(a, device=dev) for a in two_view_batch(np, B, M))
    g = torch.Generator(device=dev).manual_seed(2)
    idx = ransac_sample_indices(valid, H, 8, g, prefix=True).reshape(B, -1, 1)
    take = lambda p: torch.gather(p, 1, idx.expand(-1, -1, 2)).reshape(B, H, 8, 2)
    Fs = eight_point(take(p1), take(p2), enforce_rank2=False, null_iters=3,
                     null_fallback=False).contiguous()
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
    return gap, ms, plain_ms


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
    return 0.0, ms, plain_ms


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
    return err, ms, plain_ms


# ---------------------------------------------------------------- ground truth

def _load_projection(np, path: Path):
    vals = path.read_text().split()
    check(vals[0] == "CONTOUR", f"{path}: not a CONTOUR file")
    return np.array([float(v) for v in vals[1:13]]).reshape(3, 4)


def _fundamental_from_projections(np, P1, P2):
    C1 = np.linalg.svd(P1)[2][-1]
    e2 = P2 @ C1
    ex = np.array([[0, -e2[2], e2[1]], [e2[2], 0, -e2[0]], [-e2[1], e2[0], 0]])
    return ex @ P2 @ np.linalg.pinv(P1)


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=36, help="rendered 1024x768 views")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a card")
    if not (REPO / "sfm_tpu_torch" / "csrc").is_dir() or not (REPO / "scripts").is_dir():
        raise SystemExit(f"chip_smoke: {REPO} is not a checkout of the repository")
    sys.path.insert(0, str(REPO))
    import numpy as np

    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]} | torch {torch.__version__} | cuda {torch.version.cuda}")
    work = REPO / ".chip_smoke"   # scene and artifacts, inside the checkout
    scene, out = work / f"scene_{args.views}", work / f"preprocess_{args.views}"
    work.mkdir(parents=True, exist_ok=True)

    render = subprocess.Popen(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, 'scripts'); from render_scene import render_dataset; "
         "render_dataset(sys.argv[1], int(sys.argv[2]), supersample=1, log=print)",
         str(scene), str(args.views)], cwd=REPO)
    try:
        from sfm_tpu_torch import _kernels
        from sfm_tpu_torch._shared import SfMConfig, load_image_gray_u8
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
                   "fmat_score_select": phase_fmat(torch, np, dev)}
        check(render.wait(timeout=900) == 0, "rendering the scene failed")
        cfg = SfMConfig()
        img0 = sorted((scene / "images").glob("*.pgm"))[0]
        image = torch.as_tensor(load_image_gray_u8(img0), device=dev)[None].float() / 255.0
        results["dog_extrema"] = phase_dog_extrema(torch, dev, image, cfg)
        results["sift_describe"] = phase_describe(torch, dev, image, cfg)
        del image
        torch.cuda.empty_cache()

        # ---- the main path: python -m sfm_tpu_torch preprocess --device cuda
        from sfm_tpu_torch import cli

        _kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = cli.main(["--log_level", "WARNING", "--log_dir", str(work / "logs"),
                       "preprocess", "--data_dir", str(scene), "--output_dir", str(out),
                       "--device", "cuda", "--no_mask"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _kernels.launch_counts()
        check(rc == 0, f"preprocess returned {rc}")
        for name in KERNELS:
            check(launches[name] > 0, f"kernel {name} was not launched by the main path")
        peak = torch.cuda.max_memory_allocated()
    finally:
        if render.poll() is None:
            render.kill()
            render.wait()

    metrics = {r["name"]: r["value"]
               for r in json.loads((out / "metrics.json").read_text())}
    blob = pickle.loads((out / "pair_table.pkl").read_bytes())
    table, valid = blob["table"], blob["valid"]
    n_img = len(blob["image_paths"])
    check(n_img == args.views, f"{n_img} images")
    check(table.num_pairs == n_img * (n_img - 1) // 2, f"{table.num_pairs} pairs")
    per_img = valid.sum(1)
    check(per_img.min() >= 500, f"an image has {per_img.min()} valid keypoints")
    acc = table.accepted()
    deg = np.bincount(table.pairs[acc].reshape(-1), minlength=n_img)
    check((deg > 0).all(), f"images in no accepted pair: {np.nonzero(deg == 0)[0]}")
    check((out / "matching_results.csv").exists(), "matching_results.csv missing")
    rows = (out / "matching_results.csv").read_text().strip().splitlines()
    check(len(rows) == 1 + len(acc), "CSV rows != accepted pairs")

    # The verified pairs against the rendered cameras' ground truth.
    from sfm_tpu_torch.geometry.epipolar import symmetric_epipolar_distance

    P = [_load_projection(np, scene / "calib" / f"{Path(p).stem}.txt")
         for p in blob["image_paths"]]
    med = []
    for p in acc:
        i, j = table.pairs[p]
        inl = table.inliers[p]
        F = torch.as_tensor(_fundamental_from_projections(np, P[i], P[j]))
        err = symmetric_epipolar_distance(F, *(torch.as_tensor(x[p][inl], dtype=torch.float64)
                                               for x in (table.xy1, table.xy2)))
        med.append(float(err.median()))
    med = np.asarray(med)
    check(np.median(med) <= 1.0 and med.max() <= 3.0,
          f"GT epipolar error of inliers: median {np.median(med)}, worst pair {med.max()}")
    check("jax" not in sys.modules and "sfm_tpu" not in sys.modules, "JAX was imported")

    det_s, sweep_s = metrics["stage/detect"], metrics["stage/sweep"]
    log(f"preprocess: {n_img} images, {table.num_pairs} pairs, {len(acc)} accepted, "
        f"keypoints/image min {per_img.min()} mean {per_img.mean():.0f}")
    log(f"detect {det_s:.3f} s = {n_img / det_s:.2f} imgs/s | sweep {sweep_s:.3f} s = "
        f"{table.num_pairs / sweep_s:.1f} pairs/s | stage {metrics['stage/preprocess']:.3f} s "
        f"| cli wall {wall:.3f} s | peak device memory {peak / 2**30:.2f} GiB")
    log(f"GT check: median inlier epipolar error per pair, median {np.median(med):.3f} px, "
        f"worst {med.max():.3f} px")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        err, ms, plain_ms = results[name]
        log(f"{name}: {ms:.4f} ms (plain torch {plain_ms:.4f} ms), "
            f"{launches[name]} launches in the main path")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
