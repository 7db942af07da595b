"""Kernels of one checkout against another's, bit for bit, on the card: K11's
matvec and PCG, K10's coupling, K7's triangulation, K8+K9's linearization,
K1's top-2, K3's pyramid, K4's candidate selection and extrema grid, K2's
F-RANSAC, K6's P3P round and ``pnp_refine``, K5's descriptors and K1-r's
retrieval counts.

    python tests/bits_report.py dump --scene D [--pipeline P] [--orb G] [--dlt_scene D36]
                                     --out DIR
    python tests/bits_report.py run --repo REPO
                                    [--cases matvec,coupling,triangulate,linearize,match,
                                             pyramid,select,fmat,pnp,p3p,extrema,describe,
                                             retrieval]
                                    [--inputs DIR] [--scene DIR] [--large_scene DIR]
                                    [--vectors 8] --out FILE.pt
    python tests/bits_report.py compare A.pt B.pt

``dump`` first runs path d's ``pipeline`` on ``D`` (the smoke's 150-view
scene) and writes the inputs of every K2 launch of its sweep (``fmat.pt``:
each chunk's points, valid rows, drawn sample indices, threshold, scoring
budget and gates), of every P3P round of its engine (``p3p.pt``: the
correspondences, K, the indices drawn where ``pnp_ransac_batch`` draws them,
the threshold and the gates), of every ``pnp_refine`` launch (``pnp.pt``),
the DoG stacks of every octave of its first detection batch
(``extrema.pt``) and its retrieval's table (``retrieval.pt``: ``desc_s``,
``valid_s``, the candidate pairs, the chunk size and the ratio); with ``--dlt_scene`` (the smoke's 36 views) path j's
``pipeline`` (PnP's DLT branch) runs there and its rounds go to
``dlt.pt``. Then it runs this checkout's ``reconstruct`` on path d's
artifacts (``P``, by default that pipeline's output; the smoke's is the
same) and writes to ``DIR`` the inputs of the largest dense BA call's S (the
linearized system, its damping and grouping), the engine's whole track
table with its final poses (``_triangulate``'s inputs for every row) and
the inputs of its largest ``run_ba`` call (the problem and its config);
then the first 32-pair chunk of ``P``'s sweep (its descriptors as the pair
table stores them, float16) and, with ``--orb`` (path g's ``pipeline``
output), the first chunk of its D = 256 sweep.

``run`` imports ``sfm_tpu_torch`` and ``chip_smoke`` from the checkout
``REPO`` (so each checkout runs its own kernels, built from its own sources)
and saves, for each case, its outputs, a digest of its inputs and its times:

- ``matvec``: ``schur_matvec_cuda`` at ``--vectors`` random x and a 50-step
  PCG solve (``pcg_solve_cuda``, tol 0) on the smoke's 300-camera /
  600k-observation scene on every route (``pcg_system``, ``island_system``),
  the same systems in point-major order (the engine's layout) and the
  5,000-camera scene (``BIG_BA_SCENE``); the matvec's wrapper and device time
  and the solve's time.
- ``coupling``: ``schur_matrix_cuda``'s S on ``phase_ba``'s scene, on
  ``phase_island``'s on each island route and (with ``--inputs``) on the
  dumped system; wrapper, device and the coupling kernels' own device time.
- ``linearize``: ``linearize_cuda``'s ten outputs (Jc, Jk, Jp, rw, V, g_p,
  U, g_c, Uk, g_k) and ``total_huber_cost_cuda``'s cost on ``phase_ba``'s
  scene, on ``phase_island``'s on each island route, on the same scenes
  with rotations of ~0.4 rad (every route) and (with
  ``--inputs``) on the first linearization of the dumped ``run_ba`` call,
  its arguments built as ``run_ba`` builds them; the linearization's and the
  cost's wrapper, device and kernel times (the workspace made once where
  the wrapper takes one, as ``run_ba`` makes it).
- ``match``: ``match_top2_cuda``'s idx, best, second and back (mutual) on
  ``phase_match_top2``'s chunk and tie-heavy input, ``phase_match_binary``'s
  D = 256 chunk, ragged shapes (K1 != K2, neither a multiple of 128; D = 96
  and 384) and (with ``--inputs``) the dumped chunks of paths d and g.
- ``pyramid``: ``build_pyramid_cuda``'s Gaussian and DoG stacks (a digest
  of each octave's) on the smoke's 12 rendered images (the first of
  ``--scene``'s 36 views, rendered there first where it holds none) with the
  default configuration's -1 octave, and on the first three cut to 301 x 517
  (tiles cut by the border) with and without it; wrapper, device and the
  pyramid kernels' own device time, and (printed) each kernel's.
- ``select``: ``select_octave_candidates_cuda``'s layer, y, x and score on
  octaves -1 and 0 of those pyramids' score grids (``dog_extrema_scores_cuda``),
  on an all-zero grid, on a grid with fewer positives than the budget and on
  path g's three FAST planes of the 12 images (``orb_levels``,
  ``fast_nms_cuda`` at ``ORB_FAST_THRESHOLD``); the same times.
- ``triangulate``: ``triangulate_tracks_cuda``'s points and flags on
  ``phase_triangulate``'s two buckets and (with ``--inputs``) on the dumped
  table: its first 2,048 to 16,384 rows, all of it and the table tiled to
  path h's 41,090 rows with seed pairs off, then its first 1,024 failures
  with seed pairs on. Where the checkout's wrapper takes a ``layout``, each
  of these also runs a warp a row and a thread a row, held against the
  other checkout's own choice.
- ``fmat``: K2 from the drawn samples on: every hypothesis F, the winner and
  its count, and the refit's F, inliers, errors and every gate field, on
  ``phase_fmat``'s chunk, on a tie-heavy chunk (samples copied 128 or 256
  hypotheses apart, so that equal scores meet in different tiles of one pair
  of the redesign's 64-hypothesis tiles, and pairs whose hypotheses are all
  one sample), on ragged shapes (a partial last tile, fewer rows than the
  scoring budget, 9 rows) and
  (with ``--inputs``) on every chunk of path d's sweep; the wrapper
  (``estimate_fundamental_ransac`` with the samples given) and the K2
  kernels' device time a chunk.
- ``p3p``: K6's P3P round from the drawn samples on (``p3p_round``: the
  redesign's ``p3p_ransac``, or the first design's torch gathers,
  ``p3p_solve`` and ``pnp_score_select``): every hypothesis's R, t and mask,
  the winner and its count, on ``phase_pnp``'s scene, on samples copied
  across the redesign's tiles (``planted_ties``), a slate of 1, valid
  prefixes of 1, 31, 33 and 2,048 rows, a budget of 777 rows, a candidate
  with no valid row and ones with NaN and infinite points, and (with
  ``--inputs``) every round of path d's engine; then ``pnp_score_select``'s
  winner on the DLT hypotheses of ``phase_pnp_dlt``'s scene and of every
  dumped round of path j.
- ``extrema``: ``dog_extrema_scores_cuda``'s score grid (a digest) on every
  octave of path d's dumped first batch and of the ``pyramid`` case's
  pyramids.
- ``describe``: K5's angle and descriptors (``orientation_and_descriptor_canvas_cuda``)
  on the inputs of every K5 launch of path d's detection (its scene,
  ``--large_scene``, in batches of ``detect_batch`` images, the last one 6;
  rebuilt from the images by the checkout's own ``select_keypoints``, whose
  inputs' digest the case keeps), on the first batch with keypoints moved to
  every octave's borders (the patch clamps), on its canvas cut to an odd width
  and shifted off 16- and 4-byte alignment (the narrower staging copies), and
  on two images cut to 200 x 260 (the last octave padded to 66 rows); a
  digest of each descriptor table, the angles whole; wrapper, device and
  kernel times.
- ``retrieval``: K1-r's counts (``score_chunk_cuda``) on every chunk of path
  d's retrieval (with ``--inputs``), on ``phase_retrieval_score``'s chunk, on
  a tie-heavy chunk (+-1/16 descriptors, rows repeated across the tile edges),
  on path d's first chunk (or the phase's table) cut to S = 100 and 200, and on
  ``phase_retrieval_binary``'s D = 256 chunk; the same times.
- ``pnp``: ``pnp_refine_cuda``'s R, rvec, t, inliers, count, errors and ok on
  ``phase_pnp_refine``'s two scenes, on a degenerate batch (a candidate with
  no valid row, so both refits see all-zero weights; one with a NaN
  rotation; one gated off; one with an infinite point), on ragged shapes
  (257, 300 and 1 rows, 12 candidates) and (with
  ``--inputs``) on every launch of path d's engine; wrapper and kernel
  times.

Wrapper times are the median of five means of 10 calls (the workspaces and
K7's camera tensors made once where the wrapper takes them, as ``run_ba``
and the engine make them), device times one ``torch.profiler`` trace; K2's
and ``pnp_refine``'s cases also time 10 calls on a stream held while the
host enqueues them (``stream_ms``: the device's time a call, the gaps
between a call's kernels included, the host's left out).
``compare`` prints, for each case, whether the two checkouts' inputs and
outputs are identical, and both checkouts' times, then one JSON line. Two
processes, since both checkouts' packages share a name. Needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import inspect
import json
import pickle
import re
import shutil
import sys
from pathlib import Path

CASES = ("matvec", "coupling", "triangulate", "linearize", "match", "pyramid", "select", "fmat",
         "pnp", "p3p", "extrema", "describe", "retrieval")
# K2's outputs, in the order the cases keep them.
FMAT_OUTPUTS = ("Fs", "best", "count", "F", "inliers", "errors", "num_matches", "num_inliers",
                "inlier_ratio", "reprojection_error", "well_distributed", "accept", "ok")
PNP_OUTPUTS = ("R", "rvec", "t", "inliers", "num_inliers", "errors", "ok")
# The BAProblem fields the dump keeps of the largest run_ba call.
BA_FIELDS = ("rvec", "tvec", "cam_valid", "cam_fixed", "intr", "points", "point_valid",
             "obs_cam", "obs_point", "obs_xy", "obs_valid", "intr_c")
# Path d's table sliced to these rows (then all of it, then tiled to path h's
# whole-table launch): K7's two layouts across the engine's launch sizes.
TABLE_ROWS = (2048, 4096, 8192, 12288, 16384)
PATH_H_TABLE_ROWS = 41090


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def dump(args) -> int:
    """The largest dense BA call's system and the final track table of this
    checkout's reconstruct on path d's artifacts."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import numpy as np
    import torch

    from sfm_tpu_torch import cli
    from sfm_tpu_torch.ba import schur as S
    from sfm_tpu_torch.reconstruction import incremental as inc

    out = Path(args.out)
    ransac_inputs(args, out)
    pipeline = Path(args.pipeline) if args.pipeline else out / "pipeline"
    run_dir = out / "reconstruct"
    run_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(pipeline / "pair_table.pkl", run_dir / "pair_table.pkl")
    seen = {"ba": None, "engine": None, "run_ba": None}
    real_s, real_t, real_run = S.schur_matrix_cuda, inc.StructureFromMotion._triangulate, inc.run_ba

    def schur_matrix_cuda(lin, op, perm, perm_valid, *a, **kw):
        if seen["ba"] is None or lin.U.shape[0] >= seen["ba"][0].U.shape[0]:
            cpu = lambda nt: nt._replace(**{f: getattr(nt, f).cpu() for f in nt._fields
                                            if isinstance(getattr(nt, f), torch.Tensor)})
            seen["ba"] = (cpu(lin), cpu(op), perm.cpu(), perm_valid.cpu())
        return real_s(lin, op, perm, perm_valid, *a, **kw)

    def _triangulate(self, *a, **kw):
        seen["engine"] = self
        return real_t(self, *a, **kw)

    def run_ba(problem, config, *a, **kw):
        last = seen["run_ba"]
        if last is None or problem.obs_cam.shape[0] >= last[0]["obs_cam"].shape[0]:
            cpu = lambda f: None if getattr(problem, f) is None else getattr(problem, f).cpu()
            seen["run_ba"] = ({f: cpu(f) for f in BA_FIELDS}, dataclasses.asdict(config), a, kw)
        return real_run(problem, config, *a, **kw)

    S.schur_matrix_cuda, inc.StructureFromMotion._triangulate = schur_matrix_cuda, _triangulate
    inc.run_ba = run_ba
    rc = cli.main(["--log_level", "WARNING", "reconstruct", "--data_dir", str(args.scene),
                   "--output_dir", str(run_dir), "--device", "cuda", "--no_mask"])
    if rc != 0 or seen["ba"] is None or seen["engine"] is None:
        raise SystemExit(f"bits_report dump: reconstruct rc {rc}, no dense BA call or no "
                         "triangulation")
    lin, op, perm, pvm = seen["ba"]
    torch.save({"lin": lin._asdict(), "op": op._asdict(), "perm": perm, "perm_valid": pvm},
               out / "ba.pt")
    eng = seen["engine"]
    cfg = eng.config.triangulation
    img = eng.tracks.view_img
    use = eng.view_valid & eng.registered[np.clip(img, 0, eng.num_images - 1)]
    torch.save({"view_img": img, "view_xy": eng.tracks.view_xy, "use": use, "rvec": eng.rvec,
                "tvec": eng.tvec, "K": eng._camera_matrix(),
                "common": dict(max_err=cfg.max_reproj_error, min_parallax_deg=cfg.min_parallax_deg,
                               robust_rounds=cfg.robust_rounds, n_seed=cfg.seed_pair_views)},
               out / "tracks.pt")
    prob, config, a, kw = seen["run_ba"]
    torch.save({"problem": prob, "config": config, "args": a, "kwargs": kw}, out / "run_ba.pt")
    chunks = [("match_d", pipeline)] + ([("match_g", Path(args.orb))] if args.orb else [])
    for name, where in chunks:
        blob = pickle.loads((where / "pair_table.pkl").read_bytes())
        ij = blob["table"].pairs[:32]
        desc, valid = blob["desc"], blob["valid"]
        f32 = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32))
        torch.save({"d1": f32(desc[ij[:, 0]]), "v1": torch.as_tensor(valid[ij[:, 0]]),
                    "d2": f32(desc[ij[:, 1]]), "v2": torch.as_tensor(valid[ij[:, 1]])},
                   out / f"{name}.pt")
        print(f"dumped: {name}, the first {len(ij)} pairs of {where} ({desc.shape[1]} x "
              f"{desc.shape[2]} descriptors)", flush=True)
    print(f"dumped: S of a {lin.U.shape[0]}-camera BA call ({lin.Jc.shape[0]} observations), "
          f"{img.shape[0]} track rows x {img.shape[1]} slots, {int(eng.registered.sum())} "
          f"registered cameras; the largest run_ba call: {prob['rvec'].shape[0]} cameras, "
          f"{prob['obs_cam'].shape[0]} observations", flush=True)
    return 0


def pnp_rounds_recorder(torch, rounds: list, recorded_size: int):
    """A stand-in for ``pnp_ransac_batch`` that draws the samples as it
    draws them, records each round whose sample size is ``recorded_size``
    (its correspondences, K, the drawn indices, the threshold and the gates)
    and hands the samples on; with the real function to restore."""
    from sfm_tpu_torch.estimators import pnp
    from sfm_tpu_torch.estimators.ransac import ransac_sample_indices

    real = pnp.pnp_ransac_batch
    cpu = lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x

    def batch(pts3d, pts2d, valid, K, min_inliers, iters=1024, threshold=8.0, refine_iters=10,
              sample_size=3, generator=None, indices=None):
        size = sample_size
        if indices is None:
            indices = ransac_sample_indices(valid.to(torch.bool), iters, size, generator,
                                            prefix=True)
        if size == recorded_size:
            rounds.append({"pts3d": cpu(pts3d).float(), "pts2d": cpu(pts2d).float(),
                           "valid": cpu(valid).bool(), "K": cpu(K).float(),
                           "indices": cpu(indices).to(torch.int16), "threshold": float(threshold),
                           "min_inliers": cpu(torch.as_tensor(min_inliers)),
                           "refine_iters": int(refine_iters)})
        return real(pts3d, pts2d, valid, K, min_inliers, iters=iters, threshold=threshold,
                    refine_iters=refine_iters, sample_size=size, generator=generator,
                    indices=indices)

    return batch, real


def ransac_inputs(args, out: Path):
    """Path d's ``pipeline`` once more on ``args.scene``, recording the inputs
    of every K2 launch of its sweep (the samples drawn here, as
    ``estimate_fundamental_ransac`` draws them, then handed to it), of every
    P3P round and ``pnp_refine`` launch of its engine, and the DoG stacks of
    every octave of its first detection batch."""
    import numpy as np
    import torch

    from sfm_tpu_torch import cli
    from sfm_tpu_torch.estimators import pnp
    from sfm_tpu_torch.estimators.ransac import ransac_sample_indices
    from sfm_tpu_torch.features import frontend
    from sfm_tpu_torch.matching import verify
    from sfm_tpu_torch.reconstruction import incremental as inc

    from sfm_tpu_torch.matching import retrieval

    chunks, refits, rounds, stacks, tables = [], [], [], [], []
    real_est, real_refine = verify.estimate_fundamental_ransac, pnp.pnp_refine
    real_extrema = frontend.dog_extrema_scores
    real_scores = retrieval.retrieval_scores
    batch, real_batch = pnp_rounds_recorder(torch, rounds, 3)
    cpu = lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x

    def extrema(dog, contrast_threshold, edge_threshold):
        if len(stacks) < frontend.FeatureConfig().num_octaves:
            stacks.append({"dog": cpu(dog), "contrast_threshold": float(contrast_threshold),
                           "edge_threshold": float(edge_threshold)})
        return real_extrema(dog, contrast_threshold, edge_threshold)

    def estimate(pts1, pts2, valid, iters=2048, threshold=3.0, prefix_valid=False,
                 score_budget=0, generator=None, indices=None, **gates):
        if indices is None:
            indices = ransac_sample_indices(valid.to(torch.bool).contiguous(), iters, 8,
                                            generator, prefix=prefix_valid)
        chunks.append({"pts1": cpu(pts1).float(), "pts2": cpu(pts2).float(),
                       "valid": cpu(valid).bool(), "indices": cpu(indices).to(torch.int16),
                       "threshold": float(threshold), "score_budget": int(score_budget),
                       "gates": {k: float(v) for k, v in gates.items()}})
        return real_est(pts1, pts2, valid, iters=iters, threshold=threshold,
                        prefix_valid=prefix_valid, score_budget=score_budget,
                        generator=generator, indices=indices, **gates)

    def refine(*a, **kw):
        refits.append(([cpu(x) for x in a], {k: cpu(v) for k, v in kw.items()}))
        return real_refine(*a, **kw)

    def scores(desc, valid, pairs, config=retrieval.RetrievalConfig()):
        S = min(config.subsample, desc.shape[1])
        tables.append({"desc_s": cpu(torch.as_tensor(desc)[:, :S]).float().contiguous(),
                       "valid_s": cpu(torch.as_tensor(valid)[:, :S]).bool().contiguous(),
                       "pairs": torch.as_tensor(np.asarray(pairs, np.int32)),
                       "chunk_size": int(config.chunk_size),
                       "ratio": float(config.ratio_threshold)})
        return real_scores(desc, valid, pairs, config)

    verify.estimate_fundamental_ransac, pnp.pnp_refine = estimate, refine
    pnp.pnp_ransac_batch = inc.pnp_ransac_batch = batch
    frontend.dog_extrema_scores = extrema
    retrieval.retrieval_scores = scores
    try:
        rc = cli.main(["--log_level", "WARNING", "pipeline", "--data_dir", str(args.scene),
                       "--output_dir", str(out / "pipeline"), "--device", "cuda", "--no_mask"])
    finally:
        verify.estimate_fundamental_ransac, pnp.pnp_refine = real_est, real_refine
        pnp.pnp_ransac_batch = inc.pnp_ransac_batch = real_batch
        frontend.dog_extrema_scores = real_extrema
        retrieval.retrieval_scores = real_scores
    if rc != 0 or not chunks or not refits or not rounds or not stacks or len(tables) != 1:
        raise SystemExit(f"bits_report dump: pipeline rc {rc}, {len(chunks)} K2 chunks, "
                         f"{len(refits)} pnp_refine launches, {len(rounds)} P3P rounds, "
                         f"{len(stacks)} DoG stacks, {len(tables)} retrieval tables")
    torch.save(chunks, out / "fmat.pt")
    torch.save(refits, out / "pnp.pt")
    torch.save(rounds, out / "p3p.pt")
    torch.save(stacks, out / "extrema.pt")
    torch.save(tables[0], out / "retrieval.pt")
    print(f"dumped: {len(chunks)} K2 chunks of path d's sweep "
          f"({sum(c['valid'].shape[0] for c in chunks)} pairs), {len(refits)} pnp_refine "
          f"launches and {len(rounds)} P3P rounds of its engine (candidates "
          f"{[r['valid'].shape[0] for r in rounds]}, valid rows a round "
          f"{[int(r['valid'].sum()) for r in rounds]}), the DoG stacks of "
          f"{[tuple(st['dog'].shape) for st in stacks]}, the retrieval table "
          f"{tuple(tables[0]['desc_s'].shape)} with {tables[0]['pairs'].shape[0]} pairs",
          flush=True)
    if args.dlt_scene:
        dlt_rounds(args, out)


def dlt_rounds(args, out: Path):
    """Path j's ``pipeline`` on ``args.dlt_scene`` (the smoke's 36 views, PnP's
    DLT branch), recording the inputs of every DLT round of its engine."""
    import json

    import torch

    import chip_smoke as cs
    from sfm_tpu_torch import cli
    from sfm_tpu_torch.estimators import pnp
    from sfm_tpu_torch.reconstruction import incremental as inc

    rounds = []
    batch, real = pnp_rounds_recorder(torch, rounds, cs.DLT_SAMPLE)
    pnp.pnp_ransac_batch = inc.pnp_ransac_batch = batch
    try:
        rc = cli.main(["--log_level", "WARNING", "pipeline", "--data_dir", str(args.dlt_scene),
                       "--output_dir", str(out / "pipeline_dlt"), "--device", "cuda",
                       "--no_mask", "--config", json.dumps(cs.PATH_J_CONFIG)])
    finally:
        pnp.pnp_ransac_batch = inc.pnp_ransac_batch = real
    if rc != 0 or not rounds:
        raise SystemExit(f"bits_report dump: path j's pipeline rc {rc}, {len(rounds)} rounds")
    torch.save(rounds, out / "dlt.pt")
    print(f"dumped: {len(rounds)} DLT rounds of path j's engine", flush=True)


def _here():
    """This checkout's ``chip_smoke`` (the other checkout's may predate what a
    case takes from it: ``point_major``, which takes the package's ``schur``
    module as an argument, and the tie-heavy retrieval table, plain torch)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _point_major():
    return _here().point_major


class Runner:
    """One checkout's kernels (``torch``, its ``chip_smoke`` as ``cs``, its
    ``schur`` and ``incremental`` modules) and the cases they wrote."""

    def __init__(self, torch, cs, S, inc):
        self.torch, self.cs, self.S, self.inc = torch, cs, S, inc
        self.cases = {}
        self.failures = torch.zeros(0, dtype=torch.int64)  # K7's first failures on path d

    def kernel_ms(self, fn, names, reps=10):
        """The device time a call of the kernels whose names hold one of
        ``names`` (one torch.profiler trace; the wrapper's other kernels left
        out)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        self.torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            self.torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.key_averages()
                 if any(k in e.key for k in names))
        return us / 1e3 / reps if us > 0 else None

    def stream_ms(self, fn, reps=10, sleep_ms=10.0):
        """The device time a call, host left out: the stream is held by a
        ``torch.cuda._sleep`` while the host enqueues ``reps`` calls between
        two events, so the device runs them back to back (the gaps between a
        call's own kernels included); the sleep is doubled until it outlasts
        the enqueueing."""
        import time

        torch = self.torch
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(4):
            torch.cuda._sleep(int(sleep_ms * 2e6))   # ~1 ms a 2e6 cycles at ~2 GHz
            t0 = time.perf_counter()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            host_ms = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
            if host_ms < 0.5 * sleep_ms:
                return start.elapsed_time(end) / reps
            sleep_ms *= 2
        return None

    def add(self, name, digest_in, outs, shape, times, ref=None, names=None):
        """Records a case; ``ref`` names the other checkout's case that its
        outputs are held against (by default its own name); ``names``: the
        outputs' names, for the report of which ones differ."""
        self.cases[name] = {"digest_in": digest_in, "out": [o.cpu() for o in outs],
                            "shape": shape, "times": times, "ref": ref or name,
                            "names": names}
        shown = ", ".join(f"{k} {self.cs.fmt_ms(v)}" for k, v in times.items())
        print(f"{name}: {shape}; {shown}", flush=True)

    def breakdown(self, fn, names, reps=10):
        """Prints the device time a call of each kernel whose name holds one of
        ``names`` (one torch.profiler trace)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        self.torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            self.torch.cuda.synchronize()
        rows = sorted(((e.device_time_total / 1e3 / reps, e.count // reps, e.key)
                       for e in prof.key_averages() if any(k in e.key for k in names)),
                      reverse=True)
        for ms, count, key in rows:
            name = re.search(r"::(\w+(?:<[^>]*>)?)\(", key)
            print(f"    {ms:.4f} ms x{count} {name.group(1) if name else key[:60]}", flush=True)

    def timed(self, fn, names):
        cs, torch = self.cs, self.torch
        return {"wrapper_ms": cs.median_ms(torch, fn), "device_ms": cs.device_ms(torch, fn),
                "kernel_ms": self.kernel_ms(fn, names)}


def run_matvec(r: Runner, args):
    torch, cs, S = r.torch, r.cs, r.S
    import numpy as np

    point_major = _point_major()
    dev = torch.device("cuda")
    takes_work = "work" in inspect.signature(S.schur_matvec_cuda).parameters
    routes = {"": (6, torch.float32), **{k: (B, getattr(torch, d))
                                          for k, (B, d) in cs.ISLAND_ROUTES.items()}}
    for scene in ("c300", "c300_point_major", "c5000"):
        for route, (B, dt) in routes.items():
            if scene == "c5000":
                a, kw = cs.island_system(torch, np, dev, B, dt, *cs.BIG_BA_SCENE, 500,
                                         cs.BIG_BA_PINNED)
            elif route:
                a, kw = cs.island_system(torch, np, dev, B, dt, cs.K11_CAMS, cs.K11_POINTS,
                                         cs.K11_OBS_PER_CAM, 300, cs.K11_PINNED)
            else:
                lin0, perm, pvm = cs.pcg_system(torch, np, dev, cs.K11_CAMS, cs.K11_POINTS,
                                                cs.K11_OBS_PER_CAM, 300, cs.K11_PINNED)
            if scene == "c5000" or route:
                lin0 = S.linearize_cuda(*a, **kw)
                perm, pvm = a[10], a[11]
            lin = lin0
            if scene == "c300_point_major":
                lin, perm, pvm = point_major(torch, S, lin0, perm, pvm)
            op, rhs_c, rhs_k = S.damp_operator(lin, 1e-3, perm, pvm, precond=True)
            C = lin.U.shape[0]
            g = torch.Generator(device=dev).manual_seed(9)
            extra = {"work": S.matvec_workspace(lin, perm, pvm)} if takes_work else {}
            sx = []
            for _ in range(args.vectors):
                xc = (1e-2 * torch.randn((C, B), device=dev, generator=g)).to(dt)
                xk = (1e-1 * torch.randn(4, device=dev, generator=g)).to(dt)
                sx.append(torch.cat([t.reshape(-1) for t in S.schur_matvec_cuda(
                    lin, op, xc, xk, perm, pvm, **extra)]))
            pcg = lambda: S.pcg_solve_cuda(lin, op, rhs_c, rhs_k, perm, pvm, 50, 0.0, **extra)
            xc_, xk_, steps = pcg()
            mv = lambda: S.schur_matvec_cuda(lin, op, xc, xk, perm, pvm, **extra)
            r.add(f"matvec/{scene}/{route or 'default'}",
                  _digest(lin.Jc, lin.Jk, lin.Jp, lin.obs_cam, lin.obs_point, op.Vinv,
                          op.lam_diag_c, op.lam_diag_k, perm, pvm),
                  [torch.stack(sx), torch.cat([xc_.reshape(-1), xk_]),
                   torch.tensor([int(steps)])],
                  f"C={C}, {int(pvm.sum())} valid observations, S x at {args.vectors} vectors "
                  "and a 50-step PCG",
                  {"wrapper_ms": cs.median_ms(torch, mv), "device_ms": cs.device_ms(torch, mv),
                   "pcg50_ms": cs.median_ms(torch, pcg, batches=3, reps=3)})
            del lin, lin0, op, extra
            torch.cuda.empty_cache()


def run_coupling(r: Runner, args):
    torch, cs, S = r.torch, r.cs, r.S
    import numpy as np

    dev = torch.device("cuda")
    takes_work = "work" in inspect.signature(S.schur_matrix_cuda).parameters
    lam = 1e-3

    def coupling(name, lin, op, perm, pvm):
        extra = {"work": S.coupling_workspace(lin, perm, pvm)} if takes_work else {}
        fn = lambda: S.schur_matrix_cuda(lin, op, perm, pvm, **extra)
        Sm = fn()
        torch.cuda.synchronize()
        r.add(name, _digest(lin.Jc, lin.Jk, lin.Jp, lin.obs_cam, lin.obs_point, lin.U, lin.Uk,
                            op.Vinv, op.lam_diag_c, op.lam_diag_k, perm, pvm),
              [Sm], f"C={lin.U.shape[0]}, B={lin.U.shape[-1]}, {lin.U.dtype}, "
                    f"{int(pvm.sum())} valid observations",
              r.timed(fn, ("coupling", "schur_finish", "row_scale")))

    # phase_ba's scene (the default route), phase_island's on each island route.
    rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy = cs.ba_scene(torch, np, dev)
    C, P, O = rvec.shape[0], pts.shape[0], obs_cam.shape[0]
    perm, pvm = S.coobs_pairs(obs_point.cpu().numpy(), np.ones(O, bool))
    perm, pvm = torch.as_tensor(perm, device=dev), torch.as_tensor(pvm, device=dev)
    cam_free = torch.ones(C, device=dev)
    cam_free[0] = 0.0
    lin = S.linearize_cuda(rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy,
                           torch.ones(O, device=dev), cam_free,
                           torch.ones(P, dtype=torch.bool, device=dev), perm, pvm, 2.0, True,
                           torch.eye(4, device=dev), torch.zeros(4, device=dev))
    op, _, _ = S.damp_operator(lin, lam, perm, pvm)
    coupling("phase_ba/default", lin, op, perm, pvm)
    for route, (B, dname) in cs.ISLAND_ROUTES.items():
        a, kw = cs.island_system(torch, np, dev, B, getattr(torch, dname), *cs.ISLAND_SCENE, 0)
        lin = S.linearize_cuda(*a, **kw)
        op, _, _ = S.damp_operator(lin, lam, a[10], a[11])
        coupling(f"phase_island/{route}", lin, op, a[10], a[11])
        torch.cuda.empty_cache()
    if args.inputs:
        ba = torch.load(Path(args.inputs) / "ba.pt", weights_only=False)
        to = lambda d: {k: None if v is None else v.to(dev) for k, v in d.items()}
        coupling("path_d/largest_dense_ba", S.Linearization(**to(ba["lin"])),
                 S.Damped(**to(ba["op"])), ba["perm"].to(dev), ba["perm_valid"].to(dev))


def run_triangulate(r: Runner, args):
    torch, cs, inc = r.torch, r.cs, r.inc
    import numpy as np

    dev = torch.device("cuda")
    params = inspect.signature(inc.triangulate_tracks_cuda).parameters
    takes_cams, takes_layout = "cams" in params, "layout" in params

    def triangulate(name, view_img, view_xy, use, rvec, tvec, K, common, seed_on):
        T = view_img.shape[0]
        active = torch.ones(T, dtype=torch.bool, device=dev)
        # The camera tensors once where the wrapper takes them, as the engine
        # makes them for a pass's buckets.
        extra = {"cams": inc.triangulate_cameras(rvec, tvec, K)} if takes_cams else {}
        layouts = {"": {}}
        if takes_layout:
            layouts.update({"/warp_a_row": {"layout": 0}, "/thread_a_row": {"layout": 1}})
        ok = None
        for tag, kw in layouts.items():
            fn = lambda: inc.triangulate_tracks_cuda(
                view_img, view_xy, use, active, rvec, tvec, K, common["max_err"],
                common["min_parallax_deg"], common["robust_rounds"], seed_on, common["n_seed"],
                **extra, **kw)
            pts, ok_t = fn()
            torch.cuda.synchronize()
            ok = ok_t if ok is None else ok
            r.add(name + tag, _digest(view_img, view_xy, use, active, rvec, tvec, K),
                  [pts, ok_t], f"T={T}, V={view_img.shape[1]}, seed pairs {seed_on}, "
                               f"{int(ok_t.sum())} ok",
                  r.timed(fn, ("triangulate",)), ref=name)
        return ok

    smoke = dict(max_err=4.0, min_parallax_deg=0.0, robust_rounds=1, n_seed=8)
    for T, seed_on in ((2048, False), (1024, True)):
        view_img, view_xy, registered, rvec, tvec, K = cs.track_scene(torch, np, dev, T, seed=T)
        use = (view_img >= 0) & registered[view_img.long().clamp(min=0)]
        triangulate(f"phase_triangulate/T{T}_seed_pairs_{seed_on}", view_img, view_xy, use,
                    rvec, tvec, K, smoke, seed_on)
    if not args.inputs:
        return
    tr = torch.load(Path(args.inputs) / "tracks.pt", weights_only=False)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    table = (torch.as_tensor(tr["view_img"], device=dev), f32(tr["view_xy"]),
             torch.as_tensor(tr["use"], device=dev))
    poses = (f32(tr["rvec"]), f32(tr["tvec"]), f32(tr["K"]))
    n = table[0].shape[0]
    for T in TABLE_ROWS:
        if T < n:
            triangulate(f"path_d/first_{T}_rows_seed_pairs_off",
                        *(x[:T].contiguous() for x in table), *poses, tr["common"], False)
    ok = triangulate("path_d/all_rows_seed_pairs_off", *table, *poses, tr["common"], False)
    tiled = [x.repeat((-(-PATH_H_TABLE_ROWS // n),) + (1,) * (x.dim() - 1))[:PATH_H_TABLE_ROWS]
             .contiguous() for x in table]
    triangulate(f"path_d/tiled_to_{PATH_H_TABLE_ROWS}_rows_seed_pairs_off", *tiled, *poses,
                tr["common"], False)
    fail = torch.nonzero(~ok).flatten()[:1024]
    r.failures = fail.cpu()
    triangulate("path_d/first_1024_failures_seed_pairs_on",
                *(x[fail].contiguous() for x in table), *poses, tr["common"], True)


LIN_KERNELS = ("ba_obs", "ba_shift", "ba_sum", "ba_finish", "ba_point", "lin_row", "lin_sum")
LIN_OUTPUTS = ("Jc", "Jk", "Jp", "rw", "V", "g_p", "U", "g_c", "Uk", "g_k")


def run_ba_args(torch, np, S, lm, prob, config, optimize_intrinsics, dev):
    """The arguments of the first linearization of ``run_ba(prob, config)`` on
    the default route (shared intrinsics, float32), as ``run_ba`` builds them."""
    if config["per_camera_intrinsics"] or config["f64_normal_equations"]:
        raise SystemExit("bits_report: the dumped run_ba call is not on the default route")
    p = {k: None if v is None else v.to(dev) for k, v in prob.items()}
    perm, pvm = S.coobs_pairs(p["obs_point"].cpu().numpy(), p["obs_valid"].cpu().numpy())
    perm, pvm = torch.as_tensor(perm, device=dev), torch.as_tensor(pvm, device=dev)
    cam_free = (p["cam_valid"] & ~p["cam_fixed"]).to(torch.float32)
    obs_w = (p["obs_valid"] & p["cam_valid"][p["obs_cam"].long()]
             & p["point_valid"][p["obs_point"].long()]).to(torch.float32)
    if optimize_intrinsics:
        _, Hreg, greg = lm._intr_reg(p["intr"], p["intr"],
                                     float(np.float32(config["intrinsics_reg_weight"])))
    else:
        Hreg = torch.eye(4, dtype=torch.float32, device=dev)
        greg = torch.zeros(4, dtype=torch.float32, device=dev)
    return (p["rvec"], p["tvec"], p["intr"], p["points"], p["obs_cam"], p["obs_point"],
            p["obs_xy"], obs_w, cam_free, p["point_valid"], perm, pvm, config["huber_delta"],
            optimize_intrinsics, Hreg, greg)


def run_linearize(r: Runner, args):
    torch, cs, S = r.torch, r.cs, r.S
    import numpy as np

    from sfm_tpu_torch.ba import lm
    from sfm_tpu_torch.ba.residuals import total_huber_cost_cuda

    dev = torch.device("cuda")
    takes_work = "work" in inspect.signature(S.linearize_cuda).parameters

    def linearize(name, a, kw):
        extra = {}
        if takes_work:
            B = 10 if a[2].dim() == 2 else 6
            extra = {"work": S.linearize_workspace(a[10], a[11], a[4], a[5], a[7], a[0].shape[0],
                                                   a[3].shape[0], B,
                                                   kw.get("dtype", torch.float32))}
        fn = lambda: S.linearize_cuda(*a, **kw, **extra)
        cargs = a[:8] + (a[12],)
        cost = lambda: total_huber_cost_cuda(*cargs)
        lin, c = fn(), cost()
        torch.cuda.synchronize()
        times = r.timed(fn, LIN_KERNELS)
        times.update({f"cost_{k}": v for k, v in r.timed(cost, ("ba_cost",)).items()})
        r.add(name, _digest(*(x for x in (*a, *kw.values()) if isinstance(x, torch.Tensor))),
              [getattr(lin, f) for f in LIN_OUTPUTS] + [c.reshape(1)],
              f"C={lin.U.shape[0]}, B={lin.U.shape[-1]}, {lin.U.dtype}, {a[4].shape[0]} rows, "
              f"{int(a[11].sum())} in the grouping", times, names=LIN_OUTPUTS + ("cost",))

    rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy = cs.ba_scene(torch, np, dev)
    C, P, O = rvec.shape[0], pts.shape[0], obs_cam.shape[0]
    perm, pvm = S.coobs_pairs(obs_point.cpu().numpy(), np.ones(O, bool))
    perm, pvm = torch.as_tensor(perm, device=dev), torch.as_tensor(pvm, device=dev)
    cam_free = torch.ones(C, device=dev)
    cam_free[0] = 0.0
    linearize("linearize/phase_ba/default",
              (rvec, tvec, intr, pts, obs_cam, obs_point, obs_xy, torch.ones(O, device=dev),
               cam_free, torch.ones(P, dtype=torch.bool, device=dev), perm, pvm, 2.0, True,
               torch.eye(4, device=dev), torch.zeros(4, device=dev)), {})
    for route, (B, dname) in cs.ISLAND_ROUTES.items():
        a, kw = cs.island_system(torch, np, dev, B, getattr(torch, dname), *cs.ISLAND_SCENE, 0)
        linearize(f"linearize/phase_island/{route}", a, kw)
        torch.cuda.empty_cache()
    # The same scenes with rotations of ~0.4 rad: there R's last bit reaches
    # the outputs (small rotations round it away next to the identity).
    big = lambda C: torch.as_tensor(
        (0.4 * np.random.default_rng(C).normal(size=(C, 3))).astype(np.float32), device=dev)
    linearize("linearize/large_rotation/default",
              (big(C), tvec, intr, pts, obs_cam, obs_point, obs_xy, torch.ones(O, device=dev),
               cam_free, torch.ones(P, dtype=torch.bool, device=dev), perm, pvm, 2.0, True,
               torch.eye(4, device=dev), torch.zeros(4, device=dev)), {})
    for route, (B, dname) in cs.ISLAND_ROUTES.items():
        a, kw = cs.island_system(torch, np, dev, B, getattr(torch, dname), *cs.ISLAND_SCENE, 0)
        linearize(f"linearize/large_rotation/{route}", (big(a[0].shape[0]),) + tuple(a[1:]), kw)
        torch.cuda.empty_cache()
    if args.inputs:
        ba = torch.load(Path(args.inputs) / "run_ba.pt", weights_only=False)
        opt = ba["kwargs"].get("optimize_intrinsics", True)
        linearize("linearize/path_d/largest_run_ba",
                  run_ba_args(torch, np, S, lm, ba["problem"], ba["config"], opt, dev), {})


def ragged_descriptors(torch, dev, B, K1, K2, D, seed):
    """Unit descriptors at shapes the tiles must mask: K1 != K2, ragged
    tails, every 7th row and 5th column invalid, pair 0's rows all invalid
    and pair 1's columns; exact ties from rows copied twice into the other
    set (columns 3 i + 1 and 3 i + 2 are row i)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    unit = lambda x: x / x.norm(dim=-1, keepdim=True)
    d1 = unit(torch.randn(B, K1, D, generator=g, device=dev))
    d2 = unit(torch.randn(B, K2, D, generator=g, device=dev))
    n = min(len(range(1, K2, 3)), K1)
    d2[:, 1:3 * n:3] = d1[:, :n]
    m = len(range(2, min(3 * n, K2), 3))
    d2[:, 2:3 * n:3] = d1[:, :m]
    v1 = torch.ones(B, K1, dtype=torch.bool, device=dev)
    v2 = torch.ones(B, K2, dtype=torch.bool, device=dev)
    v1[:, ::7] = False
    v2[:, ::5] = False
    v1[0] = False
    v2[1 % B] = False
    return d1.contiguous(), v1, d2.contiguous(), v2


def run_match(r: Runner, args):
    torch, cs = r.torch, r.cs

    from sfm_tpu_torch.matching.core import match_top2_cuda

    dev = torch.device("cuda")

    def match(name, d1, v1, d2, v2):
        fn = lambda: match_top2_cuda(d1, v1, d2, v2, mutual=True)
        outs = fn()
        torch.cuda.synchronize()
        r.add(name, _digest(d1, v1, d2, v2), list(outs),
              f"B={d1.shape[0]}, K1={d1.shape[1]}, K2={d2.shape[1]}, D={d1.shape[2]}",
              r.timed(fn, ("match_top2",)), names=("idx", "best", "second", "back"))

    match("match/phase_match_top2/random", *cs.sweep_descriptors(torch, dev, 32, 2048, 128, 1))
    match("match/phase_match_top2/tie_heavy", *cs.tie_heavy_descriptors(torch, dev, 8, 2048))
    d1, v1, d2, v2 = cs.sweep_descriptors(torch, dev, 32, 3800, 256, 10)
    match("match/phase_match_binary/d256", cs.binary_descriptors(torch, d1), v1,
          cs.binary_descriptors(torch, d2), v2)
    del d1, d2
    for B, K1, K2, D in ((4, 2047, 1501, 96), (3, 3800, 2047, 256), (2, 700, 900, 384)):
        match(f"match/ragged/{B}x{K1}x{K2}x{D}",
              *ragged_descriptors(torch, dev, B, K1, K2, D, seed=K1 + D))
    for name in ("match_d", "match_g"):
        f = Path(args.inputs or "") / f"{name}.pt"
        if args.inputs and f.exists():
            m = torch.load(f, weights_only=False)
            match(f"match/path_{name[-1]}/first_chunk", *(m[k].to(dev) for k in
                                                          ("d1", "v1", "d2", "v2")))
    torch.cuda.empty_cache()


def smoke_images(torch, scene):
    """The smoke's detection sub-batch (its first 12 rendered 1024 x 768
    views, float in [0, 1]) from ``scene``, rendered there first if needed."""
    from sfm_tpu_torch.io.images import load_image_gray_u8
    from sfm_tpu_torch.render_scene import render_dataset

    scene = Path(scene)
    if not (scene / ".render_meta").exists():
        render_dataset(str(scene), 36, supersample=1, log=print, workers=6)
    paths = sorted((scene / "images").glob("*.pgm"))[:12]
    return torch.stack([torch.as_tensor(load_image_gray_u8(p), device="cuda")
                        for p in paths]).float() / 255.0


def _digests(torch, tensors):
    """Each tensor's sha256 as bytes: the outputs too large to keep."""
    return [torch.tensor(list(bytes.fromhex(hashlib.sha256(
        t.contiguous().cpu().numpy().tobytes()).hexdigest())), dtype=torch.uint8)
            for t in tensors]


def pyramid_inputs(torch, images):
    """(name, images, upsample): the smoke's batch with the -1 octave, and its
    first three cut to 301 x 517 with and without it."""
    ragged = images[:3, :301, :517].contiguous()
    return [("smoke_12", images, True), ("ragged_3x301x517_up", ragged, True),
            ("ragged_3x301x517", ragged, False)]


def run_pyramid(r: Runner, args):
    torch = r.torch
    from sfm_tpu_torch.features.pyramid import build_pyramid_cuda

    for name, images, up in pyramid_inputs(torch, smoke_images(torch, args.scene)):
        fn = lambda: build_pyramid_cuda(images, num_octaves=4, upsample=up)
        g, d = fn()
        torch.cuda.synchronize()
        r.add(f"pyramid/{name}", _digest(images), _digests(torch, g + d),
              f"B={images.shape[0]}, {images.shape[1]}x{images.shape[2]}, upsample {up}",
              r.timed(fn, ("blur", "upsample", "subsample")),
              names=tuple(f"{k} octave {o - up}" for k in ("gaussian", "dog")
                          for o in range(len(g))))
        r.breakdown(fn, ("blur", "upsample", "subsample"))
        del g, d
        torch.cuda.empty_cache()


SELECT_KERNELS = ("block_max", "topk_rows_kernel", "cell_gather", "select_", "rank_sort",
                  "topk_block_kernel<1>")


def run_select(r: Runner, args):
    torch, cs = r.torch, r.cs
    from sfm_tpu_torch.config import SfMConfig
    from sfm_tpu_torch.features.binary import fast_nms_cuda
    from sfm_tpu_torch.features.detect import dog_extrema_scores_cuda, select_octave_candidates_cuda
    from sfm_tpu_torch.features.frontend import _octave_budget
    from sfm_tpu_torch.features.pyramid import build_pyramid_cuda

    fc = SfMConfig().features

    def select(name, score, budget):
        fn = lambda: select_octave_candidates_cuda({"score": score}, budget)
        c = fn()
        torch.cuda.synchronize()
        r.add(f"select/{name}", _digest(score), [c[k] for k in ("layer", "y", "x", "score")],
              f"{tuple(score.shape)}, budget {budget}, {int((c['score'] > 0).sum())} nonzero",
              r.timed(fn, SELECT_KERNELS), names=("layer", "y", "x", "score"))
        r.breakdown(fn, SELECT_KERNELS)

    images = smoke_images(torch, args.scene)
    for name, ims, up in pyramid_inputs(torch, images):
        if not up:
            continue
        _, dogs = build_pyramid_cuda(ims, num_octaves=4, upsample=up)
        for o in (0, 1):
            score = dog_extrema_scores_cuda(dogs[o].contiguous(), fc.contrast_threshold,
                                            fc.edge_threshold)["score"]
            select(f"{name}/octave_{o - 1}", score, _octave_budget(fc.max_keypoints, o))
        del dogs
    shape = (12, 3, 1536, 2048)
    select("all_zero", torch.zeros(shape, device="cuda"), 2048)
    import numpy as np

    rng = np.random.default_rng(16)
    n = shape[1] * shape[2] * shape[3]
    flat = np.concatenate([b * n + rng.choice(n, 500, replace=False) for b in range(12)])
    few = torch.zeros(shape, device="cuda")
    few.view(-1)[torch.as_tensor(flat, device="cuda")] = torch.as_tensor(
        rng.uniform(0.01, 1.0, flat.size).astype(np.float32), device="cuda")
    select("few_positives", few, 2048)
    del few
    t = cs.ORB_FAST_THRESHOLD / 255.0
    for lvl, im, budget in cs.orb_levels(torch, images, SfMConfig()):
        select(f"path_g_fast/level_{lvl}", fast_nms_cuda(im, t)[:, None].contiguous(), budget)
    torch.cuda.empty_cache()


def k2_outputs(torch, fm, p1, p2, valid, idx, thr, budget, gates):
    """This checkout's K2 from the samples on: the redesign's one entry, or the
    first design's three (the scoring subset sliced as
    ``estimate_fundamental_ransac`` slices it)."""
    if hasattr(fm, "fmat_ransac_cuda"):
        out = fm.fmat_ransac_cuda(p1, p2, valid, idx, thr, budget, **gates)
        return [out[k] for k in FMAT_OUTPUTS]
    Fs = fm.fmat_hypotheses_cuda(p1, p2, idx)
    n = budget if budget and budget < p1.shape[1] else p1.shape[1]
    best, count = fm.fmat_score_select_cuda(Fs, p1[:, :n].contiguous(), p2[:, :n].contiguous(),
                                            valid[:, :n].contiguous(), thr)
    out = fm.fmat_refit_verify_cuda(Fs, best.contiguous(), p1, p2, valid, thr, **gates)
    return [Fs, best, count] + [out[k] for k in FMAT_OUTPUTS[3:]]


def tie_heavy_samples(torch, idx):
    """``idx`` (B, 512, 8) with equal hypotheses planted in different tiles (of
    64 or 128): pairs 0-7 copy hypotheses 0-127 to 128-255, 256-383 and
    384-511 (each ties with three copies), pairs 8-15 copy 384-511 to 128-255
    (a later tile's best ties with an earlier one), pairs 16-19 hold one
    sample 512 times (the winner is hypothesis 0)."""
    idx = idx.clone()
    for b in range(8):
        idx[b, 128:] = idx[b, :128].repeat(3, 1)
    for b in range(8, 16):
        idx[b, 128:256] = idx[b, 384:512]
    for b in range(16, 20):
        idx[b] = idx[b, 5]
    return idx.contiguous()


def run_fmat(r: Runner, args):
    torch, cs = r.torch, r.cs
    import numpy as np

    from sfm_tpu_torch.estimators import fundamental as fm
    from sfm_tpu_torch.estimators.ransac import ransac_sample_indices

    dev = torch.device("cuda")
    gates_default = dict(min_inliers=15, min_inlier_ratio=0.3, max_reproj_error=2.0,
                         min_spread=20.0)

    def k2(name, p1, p2, valid, idx, thr, budget, gates, full_times=False):
        gates = {k: (int(v) if k == "min_inliers" else float(v)) for k, v in gates.items()}
        outs = k2_outputs(torch, fm, p1, p2, valid, idx, thr, budget, gates)
        torch.cuda.synchronize()
        fn = lambda: fm.estimate_fundamental_ransac(p1, p2, valid, threshold=thr,
                                                    score_budget=budget, indices=idx, **gates)
        times = {"wrapper_ms": cs.median_ms(torch, fn), "stream_ms": r.stream_ms(fn),
                 "kernel_ms": r.kernel_ms(fn, ("fmat",))}
        if full_times:
            times["device_ms"] = cs.device_ms(torch, fn)
        r.add(name, _digest(p1, p2, valid, idx), [o.long() if o.dtype == torch.int32 else o
                                                  for o in outs],
              f"B={p1.shape[0]}, N={p1.shape[1]}, H={idx.shape[1]}, scored on {budget}, "
              f"{int(outs[11].sum())} accepted", times, names=FMAT_OUTPUTS)

    B, M, H = 32, 1024, 512
    p1, p2, valid = (torch.as_tensor(a, device=dev) for a in cs.two_view_batch(np, B, M)[:3])
    g = torch.Generator(device=dev).manual_seed(2)
    idx = ransac_sample_indices(valid, H, 8, g, prefix=True).contiguous()
    k2("fmat/phase_fmat", p1, p2, valid, idx, 3.0, 256, gates_default, full_times=True)
    k2("fmat/tie_heavy", p1, p2, valid, tie_heavy_samples(torch, idx), 3.0, 256, gates_default)
    # Ragged shapes: a partial last tile, fewer rows than the scoring budget,
    # a scoring budget off the walk's chunks, a pair of 9 rows.
    for Bq, Mq, Hq, budget in ((3, 100, 130, 50), (1, 9, 16, 0), (5, 1024, 64, 1000),
                               (2, 777, 512, 256)):
        q1, q2, qv = (torch.as_tensor(a, device=dev) for a in cs.two_view_batch(np, Bq, Mq,
                                                                                 seed=Mq)[:3])
        gq = torch.Generator(device=dev).manual_seed(Mq)
        qi = ransac_sample_indices(qv, Hq, 8, gq, prefix=True).contiguous()
        k2(f"fmat/ragged/{Bq}x{Mq}x{Hq}_scored_{budget}", q1, q2, qv, qi, 3.0, budget,
           gates_default)
    f = Path(args.inputs or "") / "fmat.pt"
    if args.inputs and f.exists():
        for i, c in enumerate(torch.load(f, weights_only=False)):
            to = lambda x: x.to(dev).contiguous()
            k2(f"fmat/path_d/chunk_{i:03d}", to(c["pts1"]), to(c["pts2"]), to(c["valid"]),
               to(c["indices"].long()), c["threshold"], c["score_budget"], c["gates"],
               full_times=i == 0)
    torch.cuda.empty_cache()


def degenerate_candidates(torch, a):
    """``phase_pnp_refine``'s 8-candidate batch made degenerate: candidate 1
    has no valid row (both refits see all-zero weights), 3 a NaN rotation, 5
    is gated off (ok0), 7 has an infinite point among its valid rows."""
    R0, t0, ok0, p3, p2, valid = (x.clone() for x in a[:6])
    valid[1] = False
    R0[3, 0, 0] = float("nan")
    ok0[5] = False
    p3[7, 3] = float("inf")
    return (R0, t0, ok0, p3, p2, valid) + tuple(a[6:])


def run_pnp(r: Runner, args):
    torch, cs = r.torch, r.cs
    import numpy as np

    from sfm_tpu_torch.estimators import pnp
    from sfm_tpu_torch.geometry.rotations import rodrigues

    dev = torch.device("cuda")

    def refine(name, a, kw):
        fn = lambda: pnp.pnp_refine_cuda(*a, **kw)
        out = fn()
        torch.cuda.synchronize()
        r.add(name, _digest(*(x for x in a if isinstance(x, torch.Tensor))),
              [out[k] for k in PNP_OUTPUTS],
              f"B={a[3].shape[0]}, N={a[3].shape[1]}, {int(out['ok'].sum())} ok",
              {"wrapper_ms": cs.median_ms(torch, fn), "stream_ms": r.stream_ms(fn),
               "kernel_ms": r.kernel_ms(fn, ("pnp_refine",))},
              names=PNP_OUTPUTS)

    for B, N in ((8, 2048), (1, 8192)):
        p3, p2, valid, K, R, t, rng = cs.pnp_scene(torch, np, dev, B, N, seed=10 + B)
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        R0 = (rodrigues(f32(rng.normal(0, 0.006, (B, 3)))) @ R).contiguous()
        t0 = (t * f32(1 + rng.normal(0, 0.01, (B, 3)))).contiguous()
        ok0 = torch.ones(B, dtype=torch.bool, device=dev)
        ok0[B // 2] = B == 1
        a = (R0, t0, ok0, p3, p2, valid, K, 8.0, torch.full((B,), 15, device=dev), 10)
        refine(f"pnp/phase_pnp_refine/B{B}_N{N}", a, {})
        if B == 8:
            refine("pnp/degenerate", degenerate_candidates(torch, a), {})
    # Ragged shapes: rows off the 256-row stride, fewer rows than a block's
    # warps, one row; 12 candidates.
    for B, N in ((3, 257), (2, 300), (12, 2048), (1, 1)):
        p3, p2, valid, K, R, t, rng = cs.pnp_scene(torch, np, dev, B, max(N, 300), seed=N)
        p3, p2, valid = (x[:, :N].contiguous() for x in (p3, p2, valid))
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        R0 = (rodrigues(f32(rng.normal(0, 0.006, (B, 3)))) @ R).contiguous()
        t0 = (t * f32(1 + rng.normal(0, 0.01, (B, 3)))).contiguous()
        ok0 = torch.ones(B, dtype=torch.bool, device=dev)
        refine(f"pnp/ragged/B{B}_N{N}", (R0, t0, ok0, p3, p2, valid, K, 8.0,
                                          torch.full((B,), 15, device=dev), 10), {})
    f = Path(args.inputs or "") / "pnp.pt"
    if args.inputs and f.exists():
        for i, (a, kw) in enumerate(torch.load(f, weights_only=False)):
            to = lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x
            refine(f"pnp/path_d/launch_{i:03d}", [to(x) for x in a],
                   {k: to(v) for k, v in kw.items()})
    torch.cuda.empty_cache()


P3P_OUTPUTS = ("Rs", "ts", "ok", "best", "count")
# The K6 round's kernels by name, both designs (the profiler's kernel time).
P3P_KERNELS = ("p3p_", "pnp_score", "pnp_select", "pnp_round")


def normalized(torch, p2, K):
    """``pnp_ransac_batch``'s normalized image coordinates of pixels p2."""
    return ((torch.cat([p2, torch.ones_like(p2[..., :1])], dim=-1) @ torch.linalg.inv(K).mT)
            [..., :2]).contiguous()


def p3p_round(torch, pnp, p3, pn, p2, valid, K, idx, thr):
    """This checkout's P3P round from the drawn samples on, as
    ``pnp_ransac_batch`` runs it on the card: (Rs, ts, ok, best, count) of
    every hypothesis (B, 4 x samples). The redesign's one entry, or the first
    design's torch gathers, ``p3p_solve`` and ``pnp_score_select``."""
    B = p3.shape[0]
    if hasattr(pnp, "p3p_ransac_cuda"):
        out = pnp.p3p_ransac_cuda(p3, pn, p2, valid, idx, K, thr)
        return [out[k] for k in P3P_OUTPUTS]
    flat = idx.reshape(B, -1).long()
    take = lambda x: torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1])).reshape(
        idx.shape + x.shape[-1:])
    Rs, ts, ok = pnp.p3p_solve_cuda(take(p3).contiguous(), take(pn).contiguous())
    H = Rs.shape[1] * 4
    Rs, ts, ok = Rs.reshape(B, H, 3, 3), ts.reshape(B, H, 3), ok.reshape(B, H)
    best, count = pnp.pnp_score_select_cuda(Rs, ts, ok, p3, p2, valid, K, thr)
    return [Rs, ts, ok, best, count]


def planted_ties(torch, idx):
    """``idx`` (B, S, 3) with equal samples planted across the redesign's
    tiles (32 or 64 samples a block): candidate 0 copies samples 0-63 over
    every later 64, candidate 1 copies samples 192-255 into 64-127 (a later
    tile's best ties with an earlier one), candidate 2 holds one sample
    throughout (hypotheses 0-3 tie with all their copies)."""
    idx = idx.clone()
    S = idx.shape[1]
    idx[0] = idx[0, :64].repeat(S // 64, 1)
    idx[1, 64:128] = idx[1, 192:256]
    idx[2] = idx[2, 5]
    return idx.contiguous()


def run_p3p(r: Runner, args):
    """K6's P3P round (and the DLT branch's scoring) on the phase scene, the
    edge cases and the dumped rounds of paths d and j."""
    torch, cs = r.torch, r.cs
    import numpy as np

    from sfm_tpu_torch.estimators import pnp
    from sfm_tpu_torch.estimators.ransac import ransac_sample_indices

    dev = torch.device("cuda")

    def round_(name, p3, p2, valid, K, idx, thr, full_times=False):
        pn = normalized(torch, p2, K)
        fn = lambda: p3p_round(torch, pnp, p3, pn, p2, valid, K, idx, thr)
        outs = fn()
        torch.cuda.synchronize()
        times = {"wrapper_ms": cs.median_ms(torch, fn), "stream_ms": r.stream_ms(fn),
                 "kernel_ms": r.kernel_ms(fn, P3P_KERNELS)}
        if full_times:
            times["device_ms"] = cs.device_ms(torch, fn)
            r.breakdown(fn, P3P_KERNELS + ("gather", "elementwise", "reduce", "copy"))
        r.add(name, _digest(p3, p2, valid, K, idx), [o.long() if o.dtype == torch.int32 else o
                                                      for o in outs],
              f"B={p3.shape[0]}, N={p3.shape[1]}, samples={idx.shape[1]}, valid rows "
              f"{valid.sum(1).tolist()}, {int(outs[2].sum())} poses ok, counts "
              f"{outs[4].tolist()}", times, names=P3P_OUTPUTS)

    def draw(valid, S, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return ransac_sample_indices(valid, S, 3, g, prefix=True).contiguous()

    # phase_pnp's scene (8 candidates x 2,048 samples x 2,048 rows).
    p3, p2, valid, K, _, _, _ = cs.pnp_scene(torch, np, dev, 8, 2048, seed=3)
    idx = draw(valid, 2048, 4)
    round_("p3p/phase_pnp", p3, p2, valid, K, idx, 8.0, full_times=True)
    round_("p3p/planted_ties", p3, p2, valid, K, planted_ties(torch, idx), 8.0)
    # A slate of 1; ragged valid prefixes (1, 31, 33 and 2,048 rows) and a
    # budget off the 32-row step; a candidate with no valid row, one with a
    # NaN and one with an infinite point among its sampled valid rows.
    q3, q2, qv, qK, _, _, _ = cs.pnp_scene(torch, np, dev, 1, 2048, seed=21)
    round_("p3p/slate_of_1", q3, q2, qv, qK, draw(qv, 2048, 22), 8.0)
    q3, q2, qv, qK, _, _, _ = cs.pnp_scene(torch, np, dev, 4, 2048, seed=23)
    qv = torch.arange(2048, device=dev)[None] < torch.tensor([1, 31, 33, 2048], device=dev)[:, None]
    round_("p3p/ragged_prefixes", q3, q2, qv, qK, draw(qv, 2048, 24), 8.0)
    q3, q2, qv, qK, _, _, _ = cs.pnp_scene(torch, np, dev, 3, 777, seed=25)
    round_("p3p/budget_777", q3, q2, qv, qK, draw(qv, 300, 26), 8.0)
    q3, q2, qv, qK, _, _, _ = cs.pnp_scene(torch, np, dev, 4, 2048, seed=27)
    qi = draw(qv, 512, 28)
    qv[1] = False
    q3[2, int(qi[2, 0, 0])] = float("nan")
    q3[3, int(qi[3, 1, 1])] = float("inf")
    q3[3, 7] = float("-inf")
    round_("p3p/degenerate", q3, q2, qv, qK, qi, 8.0)
    # Path j's DLT hypotheses (phase_pnp_dlt's scene and the dumped rounds),
    # scored by pnp_score_select.

    def dlt(name, p3, p2, valid, K, idx, thr):
        pn = normalized(torch, p2, K)
        i32 = idx.to(torch.int32).contiguous()
        Rs, ts = pnp.pnp_dlt_solve_cuda(p3, pn, p2, i32, K)
        ok = torch.ones(Rs.shape[:2], dtype=torch.bool, device=dev)
        fn = lambda: pnp.pnp_score_select_cuda(Rs, ts, ok, p3, p2, valid, K, thr)
        best, count = fn()
        torch.cuda.synchronize()
        r.add(name, _digest(p3, p2, valid, K, idx), [Rs, ts, best.long(), count.long()],
              f"B={p3.shape[0]}, N={p3.shape[1]}, H={Rs.shape[1]}, counts {count.tolist()}",
              {"wrapper_ms": cs.median_ms(torch, fn), "stream_ms": r.stream_ms(fn),
               "kernel_ms": r.kernel_ms(fn, P3P_KERNELS)}, names=("Rs", "ts", "best", "count"))

    p3, p2, valid, K, _, _, _ = cs.pnp_scene(torch, np, dev, 8, 2048, seed=3)
    g = torch.Generator(device=dev).manual_seed(4)
    dlt("p3p/dlt_phase", p3, p2, valid, K,
        ransac_sample_indices(valid, 2048, cs.DLT_SAMPLE, g, prefix=True), 8.0)
    to = lambda x: x.to(dev).contiguous()
    for fname, kind in (("p3p.pt", "path_d"), ("dlt.pt", "path_j_dlt")):
        f = Path(args.inputs or "") / fname
        if not (args.inputs and f.exists()):
            continue
        for i, c in enumerate(torch.load(f, weights_only=False)):
            a = (to(c["pts3d"]), to(c["pts2d"]), to(c["valid"]), to(c["K"]),
                 to(c["indices"].long()), c["threshold"])
            if kind == "path_d":
                round_(f"p3p/{kind}/round_{i:03d}", *a)
            else:
                dlt(f"p3p/{kind}/round_{i:03d}", *a)
    torch.cuda.empty_cache()


def run_extrema(r: Runner, args):
    """K4's ``dog_extrema`` on every octave of path d's dumped first batch and
    of the smoke's pyramids (12 images with the -1 octave; 3 cut to 301 x
    517 with and without it)."""
    torch = r.torch
    from sfm_tpu_torch.config import SfMConfig
    from sfm_tpu_torch.features.detect import dog_extrema_scores_cuda
    from sfm_tpu_torch.features.pyramid import build_pyramid_cuda

    fc = SfMConfig().features

    def extrema(name, dog, ct, et):
        fn = lambda: dog_extrema_scores_cuda(dog, ct, et)["score"]
        score = fn()
        torch.cuda.synchronize()
        r.add(name, _digest(dog), _digests(torch, [score]),
              f"{tuple(dog.shape)}, {int((score > 0).sum())} extrema",
              {"wrapper_ms": r.cs.median_ms(torch, fn), "stream_ms": r.stream_ms(fn),
               "kernel_ms": r.kernel_ms(fn, ("dog_extrema",))}, names=("score",))

    f = Path(args.inputs or "") / "extrema.pt"
    if args.inputs and f.exists():
        for o, st in enumerate(torch.load(f, weights_only=False)):
            extrema(f"extrema/path_d_batch/octave_{o - 1}", st["dog"].cuda().contiguous(),
                    st["contrast_threshold"], st["edge_threshold"])
            torch.cuda.empty_cache()
    for name, ims, up in pyramid_inputs(torch, smoke_images(torch, args.scene)):
        _, dogs = build_pyramid_cuda(ims, num_octaves=4, upsample=up)
        for o, d in enumerate(dogs):
            extrema(f"extrema/{name}/octave_{o - up}", d.contiguous(), fc.contrast_threshold,
                    fc.edge_threshold)
        del dogs
        torch.cuda.empty_cache()


def run_describe(r: Runner, args):
    """K5 on path d's every launch (its scene's images in detection batches,
    through the checkout's select_keypoints), border keypoints, narrow staging
    copies and padded octaves."""
    torch = r.torch
    import numpy as np

    from sfm_tpu_torch.config import SfMConfig
    from sfm_tpu_torch.features.descriptor import orientation_and_descriptor_canvas_cuda
    from sfm_tpu_torch.features.frontend import select_keypoints
    from sfm_tpu_torch.io.images import load_image_gray_u8
    from sfm_tpu_torch.render_scene import render_dataset

    from describe_inputs import describe_border

    fc = SfMConfig().features
    kw = dict(descriptor_scale=fc.descriptor_scale, clip=fc.descriptor_clip)
    here = _here()

    def describe(name, a, note=""):
        fn = lambda: orientation_and_descriptor_canvas_cuda(*a, **kw)
        angle, desc = fn()
        torch.cuda.synchronize()
        # The bound at these inputs, by this checkout's chip_smoke (both
        # checkouts read the same number).
        bound_ms = here.bound(here.result(0.0, 0.0, 0.0, here.k5_moved_bytes(torch, *a),
                                          a[2].numel() * 512 * 80))[0]
        r.add(name, _digest(*a), [angle] + _digests(torch, [desc]),
              f"{tuple(a[0].shape)} canvas, {tuple(a[2].shape)} keypoints{note}",
              {"wrapper_ms": r.cs.median_ms(torch, fn), "stream_ms": r.stream_ms(fn),
               "kernel_ms": r.kernel_ms(fn, ("sift_describe",)), "bound_ms": bound_ms},
              names=("angle", "desc"))

    scene = Path(args.large_scene)
    if not (scene / ".render_meta").exists():
        render_dataset(str(scene), 150, supersample=1, log=print, workers=6)
    imgs = [load_image_gray_u8(p) for p in sorted((scene / "images").glob("*.pgm"))]
    first = None
    for c in range(0, len(imgs), fc.detect_batch):
        ims = torch.as_tensor(np.stack(imgs[c:c + fc.detect_batch]), device="cuda")
        a = select_keypoints(ims, None, fc)["describe"]
        describe(f"describe/path_d/batch_{c // fc.detect_batch:02d}", a,
                 f", images {c}..{c + ims.shape[0] - 1}")
        if first is None:
            first = a
        torch.cuda.empty_cache()
    describe("describe/borders", describe_border(torch, first))
    canvas = first[0]
    odd = canvas[..., :canvas.shape[-1] - 1].contiguous()
    describe("describe/odd_width", (odd,) + tuple(first[1:]))
    for shift in (1, 2):   # halves: off 4-byte, then off 16-byte alignment
        buf = torch.empty(canvas.numel() + 8, dtype=canvas.dtype, device=canvas.device)
        moved = buf[shift:shift + canvas.numel()].view(canvas.shape)
        moved.copy_(canvas)
        describe(f"describe/offset_{2 * shift}_bytes", (moved,) + tuple(first[1:]))
    small = torch.as_tensor(np.stack(imgs[:2]), device="cuda")[:, :200, :260].contiguous()
    a = select_keypoints(small, None, fc)["describe"]
    describe("describe/padded_octave", a, f", octave rows {[int(h) for h in a[7][0].unique()]}")
    del first, canvas, odd
    torch.cuda.empty_cache()


def run_retrieval(r: Runner, args):
    """K1-r on path d's every chunk, the phase's chunk, a tie-heavy chunk, S =
    100 and 200, and D = 256."""
    torch, cs = r.torch, r.cs
    from sfm_tpu_torch.matching.retrieval import score_chunk_cuda

    def score(name, pairs, desc, valid, ratio):
        fn = lambda: score_chunk_cuda(pairs, desc, valid, ratio)
        got = fn()
        torch.cuda.synchronize()
        r.add(name, _digest(pairs, desc, valid), [got],
              f"{pairs.shape[0]} pairs, S {desc.shape[1]}, D {desc.shape[2]}, counts "
              f"{int(got.min())}..{int(got.max())}",
              {"wrapper_ms": cs.median_ms(torch, fn), "stream_ms": r.stream_ms(fn),
               "kernel_ms": r.kernel_ms(fn, ("retrieval_",))}, names=("counts",))

    dev = torch.device("cuda")
    N, S = 150, 256
    desc, valid = cs.corridor_descriptors(torch, dev, N, S)
    pairs = [(k, k + d) for d in range(1, 8) for k in range(N - d)] + [(0, 149), (3, 90)]
    pairs = torch.tensor(pairs, dtype=torch.int32, device=dev)
    score("retrieval/phase", pairs, desc, valid, 0.75)
    t_desc, t_valid = _here().tie_heavy_table(torch, dev, N, S)
    score("retrieval/tie_heavy", pairs, t_desc, t_valid, 0.75)
    cut, cut_valid, cut_pairs, ratio = desc, valid, pairs, 0.75
    f = Path(args.inputs or "") / "retrieval.pt"
    if args.inputs and f.exists():
        blob = torch.load(f, weights_only=False)
        d_s, v_s = blob["desc_s"].to(dev), blob["valid_s"].to(dev)
        all_pairs, n = blob["pairs"].to(dev), blob["chunk_size"]
        for i, c0 in enumerate(range(0, all_pairs.shape[0], n)):
            score(f"retrieval/path_d/chunk_{i:02d}", all_pairs[c0:c0 + n].contiguous(), d_s,
                  v_s, blob["ratio"])
        cut, cut_valid, cut_pairs, ratio = d_s, v_s, all_pairs[:n].contiguous(), blob["ratio"]
    for s_cut in (100, 200):
        score(f"retrieval/s{s_cut}", cut_pairs, cut[:, :s_cut].contiguous(),
              cut_valid[:, :s_cut].contiguous(), ratio)
    b_desc, b_valid = cs.corridor_descriptors(torch, dev, N, S, D=256)
    score("retrieval/d256", pairs, cs.binary_descriptors(torch, b_desc), b_valid, 0.75 ** 0.5)
    torch.cuda.empty_cache()


def run(args) -> int:
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    import torch

    import chip_smoke as cs
    from sfm_tpu_torch.ba import schur as S
    from sfm_tpu_torch.reconstruction import incremental as inc

    if not torch.cuda.is_available():
        raise SystemExit("bits_report: needs a card")
    cases = args.cases.split(",")
    if not set(cases) <= set(CASES):
        raise SystemExit(f"bits_report: --cases takes {', '.join(CASES)}")
    r = Runner(torch, cs, S, inc)
    for case, fn in (("matvec", run_matvec), ("coupling", run_coupling),
                     ("triangulate", run_triangulate), ("linearize", run_linearize),
                     ("match", run_match), ("pyramid", run_pyramid), ("select", run_select),
                     ("fmat", run_fmat), ("pnp", run_pnp), ("p3p", run_p3p),
                     ("extrema", run_extrema), ("describe", run_describe),
                     ("retrieval", run_retrieval)):
        if case in cases:
            fn(r, args)
    torch.save({"repo": str(repo), "card": cs.card_line(), "cases": r.cases,
                "failures": r.failures}, args.out)
    return 0


def compare(args) -> int:
    import torch

    a, b = (torch.load(p, weights_only=False) for p in (args.a, args.b))
    print(f"A: {a['repo']} ({a['card']}); B: {b['repo']} ({b['card']})")
    bits = lambda t: t.view({torch.float64: torch.int64, torch.float32: torch.int32}.get(
        t.dtype, t.dtype))
    fmt = lambda x: "not measured" if x is None else f"{x:.4f}"
    same_failures = torch.equal(a["failures"], b["failures"])
    rows, same = [], same_failures
    matched = set()
    for name, rb in b["cases"].items():
        ra = a["cases"].get(rb["ref"])
        if ra is None:
            print(f"{name} ({rb['shape']}): only in B")
            continue
        matched.add(rb["ref"])
        eq_in = ra["digest_in"] == rb["digest_in"]
        eq_out = all(torch.equal(bits(x), bits(y)) for x, y in zip(ra["out"], rb["out"]))
        per = [int((bits(x) != bits(y)).sum()) for x, y in zip(ra["out"], rb["out"])]
        diff = sum(per)
        names = rb.get("names") or [str(i) for i in range(len(per))]
        which = ", ".join(f"{k} {v}" for k, v in zip(names, per) if v)
        same = same and eq_in and eq_out
        times = "; ".join(f"{k} A {fmt(ra['times'].get(k))} / B {fmt(v)} ms"
                          for k, v in rb["times"].items())
        outs = "identical" if eq_out else f"NOT identical ({diff} entries differ: {which})"
        print(f"{name} ({rb['shape']}; A: {rb['ref']}): inputs {'equal' if eq_in else 'DIFFER'}, "
              f"outputs {outs}; {times}")
        rows.append({"case": name, "against": rb["ref"], "inputs_equal": eq_in,
                     "identical": eq_out, "entries_differing": diff,
                     "times": {k: [ra["times"].get(k), v] for k, v in rb["times"].items()}})
    for name in a["cases"]:
        if name not in matched:
            same = False
            print(f"{name}: only in A")
    # Each group's totals (the cases named group/...): path d's sums over its launches.
    groups = {}
    for r_ in rows:
        g = groups.setdefault(r_["case"].rsplit("/", 1)[0], {"cases": 0, "identical": 0})
        g["cases"] += 1
        g["identical"] += r_["identical"]
        for k, (ta, tb) in r_["times"].items():
            if ta is not None and tb is not None:
                g.setdefault(k, [0.0, 0.0])
                g[k] = [g[k][0] + ta, g[k][1] + tb]
    for gname, g in groups.items():
        if g["cases"] > 1:
            print(f"{gname}: {g['identical']}/{g['cases']} identical; totals "
                  + "; ".join(f"{k} A {v[0]:.4f} / B {v[1]:.4f} ms" for k, v in g.items()
                              if isinstance(v, list)))
    print(json.dumps({"identical": same, "same_failures": same_failures, "groups": groups,
                      "cases": rows}))
    return 0 if same else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("--scene", required=True, help="path d's rendered scene")
    d.add_argument("--pipeline", default=None,
                   help="path d's pipeline output (pair_table.pkl); by default the pipeline "
                        "that dump runs on --scene for K2's and pnp_refine's inputs")
    d.add_argument("--orb", default=None, help="path g's pipeline output (pair_table.pkl)")
    d.add_argument("--dlt_scene", default=None,
                   help="the smoke's 36 rendered views: path j's pipeline runs there and its "
                        "DLT rounds are dumped")
    d.add_argument("--out", required=True)
    r = sub.add_parser("run")
    r.add_argument("--repo", required=True, help="the checkout whose kernels run")
    r.add_argument("--cases", default=",".join(CASES), help="a comma-separated subset of "
                   + ", ".join(CASES))
    r.add_argument("--inputs", default=None,
                   help="what dump wrote (without it, the kernel phases' scenes only)")
    r.add_argument("--vectors", type=int, default=8, help="the matvec's random x")
    r.add_argument("--scene", default=".chip_smoke/scene_36",
                   help="the smoke's 36 rendered views (rendered there if missing)")
    r.add_argument("--large_scene", default=".chip_smoke/scene_150",
                   help="path d's 150 rendered views (rendered there if missing)")
    r.add_argument("--out", required=True)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args(argv)
    return {"dump": dump, "run": run, "compare": compare}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
