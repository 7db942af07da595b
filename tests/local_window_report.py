"""Windowed local BA on the 300-view corridor: the port on the card, both
packages on the CPU, on one pair table (not collected by pytest).

    python tests/local_window_report.py card [--views 300] [--work DIR] [--out DIR]
                                             [--repeats 3]
    python tests/local_window_report.py cpu --data_dir D --table PKL --case NAME
                                            [--package jax|port]

``card`` (a CUDA card, no JAX): renders ``--views`` views of the corridor,
runs the port's ``pipeline`` on them with no ``--config``, writes the pair
table without its descriptors and its rejected pairs
(``pair_table_nodesc.pkl.gz``: the engine reads only accepted pairs, and
without descriptors it runs no guided rescue) and the scene's ``calib/`` to
``--out``, then runs the port's ``reconstruct`` ``--repeats`` times for each
case of ``CASES``: on the full table ("full") or on the reduced one
("nodesc", the input the CPU runs below can take). Each run prints one
``model`` line.

``cpu`` (the CPU, JAX for ``--package jax``): the reconstruct stage of one
package with one case's configuration on a table ``card`` wrote, and the
same ``model`` line.

A ``model`` line: cameras, points, mean reprojection error, ground-truth
rotation median and ATE, the final shared intrinsics (the scene renders
fx = fy = 1228, cx 512, cy 384), and, for the port, its BA calls (restricted,
with the largest's cameras, and global).
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import pickle
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

WINDOW = 16
# name: (the table it reads, the --config it runs)
CASES = {
    "window16": ("full", {"ba": {"local_window": WINDOW}}),
    "window16_nodesc": ("nodesc", {"ba": {"local_window": WINDOW}}),
    "window16_fixed_intrinsics_nodesc": (
        "nodesc", {"ba": {"local_window": WINDOW, "optimize_intrinsics": False}}),
    "global_nodesc": ("nodesc", {}),
}
RENDERED = {"fx": 1228.0, "fy": 1228.0, "cx": 512.0, "cy": 384.0}


def model_line(package: str, case: str, out: Path, wall: float) -> str:
    st = json.loads((out / "reconstruction" / "stats.json").read_text())
    intr = json.loads((out / "reconstruction" / "intrinsics.json").read_text())
    intr = {k: round(float(v), 2) for k, v in intr.items() if k in RENDERED}
    line = (f"model {package} {case}: {st['num_cameras']} cameras, {st['num_points']} points, "
            f"{st['mean_reprojection_error']:.4f} px, GT rotation median "
            f"{st.get('gt_rot_err_deg_median', float('nan')):.4f} deg, ATE "
            f"{100 * st.get('gt_ate_rel', float('nan')):.3f}%, intrinsics {json.dumps(intr)}, "
            f"wall {wall:.1f} s")
    records = json.loads((out / "metrics.json").read_text())
    calls = [r for r in records if r["name"] == "ba/solve"]
    if calls:
        local = [r for r in calls if r["local"]]
        line += (f"; BA calls {len(local)} restricted (largest "
                 f"{max((r['cameras'] for r in local), default=0)} cameras), "
                 f"{len(calls) - len(local)} global")
    return line


def copy_table(table: Path, out: Path):
    out.mkdir(parents=True, exist_ok=True)
    data = table.read_bytes()
    (out / "pair_table.pkl").write_bytes(gzip.decompress(data) if table.suffix == ".gz"
                                         else data)


def port_reconstruct(data_dir: Path, table: Path, out: Path, cfg: dict, device: str) -> float:
    from sfm_tpu_torch import cli

    copy_table(table, out)
    t0 = time.perf_counter()
    rc = cli.main(["--log_level", "WARNING", "--log_dir", str(out / "logs"), "reconstruct",
                   "--data_dir", str(data_dir), "--output_dir", str(out), "--device", device,
                   "--no_mask", "--config", json.dumps(cfg)])
    if rc != 0:
        raise SystemExit(f"reconstruct exited {rc}")
    return time.perf_counter() - t0


def card(args) -> int:
    import torch

    from sfm_tpu_torch import cli
    from sfm_tpu_torch.render_scene import render_dataset

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    work, out = Path(args.work), Path(args.out)
    scene, pipe = work / f"scene_{args.views}", work / f"pipeline_{args.views}"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    render_dataset(scene, args.views, supersample=1, log=lambda *_: None,
                   workers=os.cpu_count() or 4)
    print(f"render {args.views} views: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rc = cli.main(["--log_level", "WARNING", "--log_dir", str(pipe / "logs"), "pipeline",
                   "--data_dir", str(scene), "--output_dir", str(pipe), "--device", "cuda",
                   "--no_mask"])
    if rc != 0:
        raise SystemExit(f"pipeline exited {rc}")
    print(model_line("port-card", "pipeline", pipe, time.perf_counter() - t0), flush=True)
    blob = pickle.loads((pipe / "pair_table.pkl").read_bytes())
    blob.pop("desc", None)
    table = blob["table"]
    acc = table.accepted()
    blob["table"] = dataclasses.replace(table, **{
        f.name: getattr(table, f.name)[acc] for f in dataclasses.fields(table)})
    print(f"pair table: {len(acc)} accepted of {table.num_pairs} pairs kept", flush=True)
    tables = {"full": pipe / "pair_table.pkl", "nodesc": work / "pair_table_nodesc.pkl"}
    tables["nodesc"].write_bytes(pickle.dumps(blob))
    (out / "pair_table_nodesc.pkl.gz").write_bytes(gzip.compress(tables["nodesc"].read_bytes()))
    shutil.copytree(scene / "calib", out / "calib", dirs_exist_ok=True)
    for case, (which, cfg) in CASES.items():
        for i in range(args.repeats):
            run = work / f"{case}_{i}"
            wall = port_reconstruct(scene, tables[which], run, cfg, "cuda")
            print(model_line("port-card", case, run, wall), flush=True)
    print(torch.cuda.get_device_name(0))
    return 0


def cpu(args) -> int:
    which, cfg = CASES[args.case]
    if which != "nodesc":
        raise SystemExit(f"{args.case} reads the full table, which stays on the card")
    out = Path(args.output_dir)
    data_dir = Path(args.data_dir)
    if args.package == "port":
        wall = port_reconstruct(data_dir, Path(args.table), out, cfg, "cpu")
        print(model_line("port-cpu", args.case, out, wall), flush=True)
        return 0
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(REPO))
    from sfm_tpu.config import SfMConfig
    from sfm_tpu.pipeline import PipelineArgs, SfMPipeline

    copy_table(Path(args.table), out)
    config = SfMConfig.from_dict(cfg) if cfg else SfMConfig()
    t0 = time.perf_counter()
    pipe = SfMPipeline(PipelineArgs(data_dir=str(data_dir), output_dir=str(out),
                                    use_mask=False, export_colmap=False,
                                    export_meshlab=False), config)
    if not pipe.run_reconstruction():
        raise SystemExit("JAX reconstruct failed")
    print(model_line("jax-cpu", args.case, out, time.perf_counter() - t0), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("card")
    c.add_argument("--views", type=int, default=300)
    c.add_argument("--work", default=str(REPO / ".chip_smoke" / "local_window"))
    c.add_argument("--out", default=str(REPO / "chiprun_out" / "local_window"))
    c.add_argument("--repeats", type=int, default=3)
    p = sub.add_parser("cpu")
    p.add_argument("--data_dir", required=True, help="holds calib/")
    p.add_argument("--table", required=True, help="pair_table_nodesc.pkl.gz")
    p.add_argument("--case", required=True, choices=list(CASES))
    p.add_argument("--package", default="jax", choices=["jax", "port"])
    p.add_argument("--output_dir", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    return card(args) if args.cmd == "card" else cpu(args)


if __name__ == "__main__":
    sys.exit(main())
