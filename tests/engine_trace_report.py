"""The incremental engine step by step, in either package, on one pair table
(not collected by pytest).

    python tests/engine_trace_report.py --package jax|port --data_dir D --table T
                                        --output_dir O [--seed S] [--device cpu|cuda]
                                        [--config JSON] [--dump_ba N ...]

Runs the reconstruct stage of ``--package`` (``jax``: the JAX package on the
CPU; ``port``: ``sfm_tpu_torch`` on ``--device``) on a table that
``tests/local_window_report.py card`` wrote (``pair_table_full.pkl.xz`` or
``pair_table_nodesc.pkl.gz``) with ``SfMConfig.seed`` = ``--seed``, and
writes ``O/trace.jsonl``: one line a registration (the image, its PnP
inliers and pool, its ground-truth rotation error under the similarity that
aligns the cameras registered so far) and one line a BA call (registered
count, initial and final cost, LM iterations, accepted steps, final lambda,
fx fy cx cy after the call, the ground-truth rotation median of the
registered cameras). The engine's methods are wrapped on its class inside
this process; no file of either package changes. Last it prints the
``model`` line of ``local_window_report.py``.

``--dump_ba N ...`` also writes ``O/ba_<N>.npz`` (every call's with
``--dump_ba -1``): the engine's state just before its N-th BA call (poses, intrinsics, points, masks, the registration
order) and that call's BA problem arrays, the input of
``tests/test_torch_engine_parity.py``'s cross-feed.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import local_window_report as lwr  # noqa: E402
from sfm_tpu_torch.io.calib import evaluate_poses, load_gt_poses  # noqa: E402


def rot_matrices(rvec: np.ndarray) -> np.ndarray:
    """Rodrigues, float64, (N, 3) -> (N, 3, 3)."""
    rvec = np.asarray(rvec, np.float64)
    th = np.linalg.norm(rvec, axis=1)
    k = rvec / np.maximum(th, 1e-300)[:, None]
    K = np.zeros((len(rvec), 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(0, 2, 1)
    s, c = np.sin(th)[:, None, None], np.cos(th)[:, None, None]
    return np.eye(3) + s * K + (1 - c) * (K @ K)


def gt_errors(engine, gt) -> dict:
    """Per-camera GT rotation error (deg) of the registered cameras, after the
    Umeyama similarity of their centers; {} below 3 cameras."""
    ids = [i for i in engine.reg_order if i in gt]
    if len(ids) < 3:
        return {}
    R = rot_matrices(engine.rvec[ids])
    t = np.asarray(engine.tvec[ids], np.float64)
    R_gt = np.stack([gt[i][1] for i in ids])
    t_gt = np.stack([gt[i][2] for i in ids])
    ev = evaluate_poses(R, t, R_gt, t_gt)
    # Per-camera angles under the same alignment (evaluate_poses keeps only
    # the median and max): recompute with its rotation.
    from sfm_tpu_torch.io.calib import umeyama

    C_est = -np.einsum("nji,nj->ni", R, t)
    C_gt = -np.einsum("nji,nj->ni", R_gt, t_gt)
    _, Q, _ = umeyama(C_est, C_gt)
    tr = np.einsum("nij,nij->n", R_gt, R @ Q.T)
    ang = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
    return {"median": ev["rot_err_deg_median"], "ate_rel": ev["ate_rel"],
            "per_camera": dict(zip(ids, ang.tolist()))}


class _Registrations(logging.Handler):
    """Collects the engine's "registered image %d (%d/%d PnP inliers)" records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.seen = {}

    def emit(self, record):
        if record.msg.startswith("registered image"):
            img, inl, pool = record.args
            self.seen[int(img)] = (int(inl), int(pool))


def instrument(engine_cls, gt, lines: list, dump_ba: set, out: Path):
    regs = _Registrations()

    def emit(rec):
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    def after_registration(self, before: int, how: str):
        if len(self.reg_order) == before:
            return
        err = gt_errors(self, gt)
        for img in self.reg_order[before:]:
            inl, pool = regs.seen.get(img, (None, None))
            emit({"kind": "register", "how": how, "image": int(img),
                  "registered": len(self.reg_order), "inliers": inl, "pool": pool,
                  "gt_rot_err_deg": err.get("per_camera", {}).get(img),
                  "gt_rot_median_deg": err.get("median")})

    def wrap_register(name):
        orig = getattr(engine_cls, name)

        def wrapped(self, *a, **kw):
            before = len(self.reg_order)
            res = orig(self, *a, **kw)
            after_registration(self, before, name + ("_weak" if kw.get("weak") else ""))
            return res

        setattr(engine_cls, name, wrapped)

    for name in ("register_candidates", "register_image", "guided_register"):
        wrap_register(name)
    orig_ba = engine_cls.bundle_adjust
    orig_init = engine_cls.initialize

    def initialize(self):
        i, j = orig_init(self)
        emit({"kind": "seed", "images": [int(i), int(j)], "points": int(self.point_valid.sum())})
        return i, j

    def bundle_adjust(self, final: bool = False):
        n = self._ba_calls + 1
        if n in dump_ba or -1 in dump_ba:
            obs = self._ba_problem_arrays()
            np.savez_compressed(
                out / f"ba_{n}.npz", rvec=self.rvec, tvec=self.tvec, intr=self.intr,
                points=self.points, point_valid=self.point_valid, registered=self.registered,
                reg_order=np.asarray(self.reg_order, np.int64), view_valid=self.view_valid,
                obs_cam=obs[0], obs_point=obs[1], obs_xy=obs[2], obs_valid=obs[3],
                final=final)
        t0 = time.perf_counter()
        stats = orig_ba(self, final=final)
        wall = time.perf_counter() - t0
        err = gt_errors(self, gt)
        st = {k: (float(v) if k != "iterations" and k != "accepted_steps" else int(v))
              for k, v in (stats or {}).items()
              if k in ("initial_cost", "final_cost", "iterations", "accepted_steps",
                       "final_lambda")}
        emit({"kind": "ba", "call": n, "final": bool(final),
              "registered": int(self.registered.sum()),
              "points": int(self.point_valid.sum()), **st,
              "intr": [round(float(v), 3) for v in self.intr],
              "gt_rot_median_deg": err.get("median"), "ate_rel": err.get("ate_rel"),
              "wall_s": round(wall, 3)})
        return stats

    engine_cls.initialize = initialize
    engine_cls.bundle_adjust = bundle_adjust
    return regs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", required=True, choices=["jax", "port"])
    ap.add_argument("--data_dir", required=True, help="holds calib/")
    ap.add_argument("--table", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--config", default="{}", help="a --config JSON (seed added)")
    ap.add_argument("--dump_ba", type=int, nargs="*", default=[],
                    help="write the state before these BA calls (1-based; -1: all)")
    args = ap.parse_args(argv)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    cfg = {**json.loads(args.config), "seed": args.seed}
    gt = load_gt_poses(Path(args.data_dir) / "calib")
    lines: list = []
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from sfm_tpu.reconstruction import incremental as eng
    else:
        from sfm_tpu_torch.reconstruction import incremental as eng
    regs = instrument(eng.StructureFromMotion, gt, lines, set(args.dump_ba), out)
    log = logging.getLogger(eng.__name__)
    log.addHandler(regs)
    log.setLevel(logging.INFO)
    log.propagate = False
    t0 = time.perf_counter()
    if args.package == "port":
        lwr.port_reconstruct(Path(args.data_dir), Path(args.table), out, cfg, args.device)
    else:
        from sfm_tpu.config import SfMConfig
        from sfm_tpu.pipeline import PipelineArgs, SfMPipeline

        lwr.copy_table(Path(args.table), out)
        pipe = SfMPipeline(PipelineArgs(data_dir=args.data_dir, output_dir=str(out),
                                        use_mask=False, export_colmap=False,
                                        export_meshlab=False), SfMConfig.from_dict(cfg))
        if not pipe.run_reconstruction():
            raise SystemExit("JAX reconstruct failed")
    wall = time.perf_counter() - t0
    (out / "trace.jsonl").write_text("".join(json.dumps(r) + "\n" for r in lines))
    print(lwr.model_line(f"{args.package}-{args.device if args.package == 'port' else 'cpu'}",
                         f"seed{args.seed}", out, wall), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
