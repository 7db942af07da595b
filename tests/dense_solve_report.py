"""K10's dense solve on the card: its times beside cuSOLVER's at each size,
the reconstructs that take a dense step through each solver, each dense
step's residual against cuSOLVER's on paths d and f, and paths d and f over
engine seeds through each solver.

    python tests/dense_solve_report.py [--cases sizes,pathb,residuals,sweep]
        [--seeds 0,1,...] [--solvers A,B,...] [--work DIR] [--out F.json]
    python tests/dense_solve_report.py --compare [LABEL=]F.json [[LABEL=]G.json ...]
        [--extra NAME:PATH=v,v,... ...]

Runs on a card, from the root of a checkout (it imports the checkout's
``sfm_tpu_torch`` and ``chip_smoke``, never JAX), rendering what it needs
into ``--work`` (default ``.chip_smoke``, the smoke's own scenes if present):

- ``sizes``: ``chip_smoke.dense_solve_case`` on synthetic S of n = 604, 904,
  1,004, 1,540, 2,564, 4,004 and 5,404 in float32 and float64 (error
  against a float64 solve beside cuSOLVER's and the twin's, and the
  kernel's against its twin; wrapper, device, twin and cuSOLVER times;
  bitwise repeats), then the all-NaN rule;
- ``pathb``: path b's ``reconstruct`` (36 rendered views, default config)
  with the dense solve through the kernel, its plain twin and cuSOLVER
  (``cholesky_ex`` + ``cholesky_solve``), each model printed;
- ``residuals``: path d's ``pipeline`` (150 views) and path f's ``reconstruct
  --polish`` on its table with every dense solve checked: the kernel's step
  is taken, cuSOLVER solves a copy of the same S beside it, and both
  residuals |(S + eps I) x - b|_inf / |b|_inf are kept in float64, with the
  steps that fail (not positive definite) to either;
- ``sweep``: path d's ``pipeline`` (150 views, the kernel) once for its
  table, then on that table, for each engine seed (``SfMConfig.seed``,
  ``--seeds``, default 0-7), path d's ``reconstruct`` and path f's
  ``reconstruct --polish`` with the dense solve through cuSOLVER, through
  :func:`f32_factor` (a float32-rounded factor) and through the kernel (a
  float64 factor; ``--solvers`` also takes :func:`f64_factor`'s two
  variants); each model printed, then each path's and solver's cameras and
  GT rotation medians over the seeds.

``--compare`` (no card) reads the sweeps' ``--out`` files (``LABEL=F.json``
names that file's solvers ``LABEL:solver``, e.g. two checkouts' kernels), and ``--extra``
samples (e.g. another package's GT medians on path d), and prints for each
path every pair of solvers' Mann-Whitney U on the GT medians with its exact
two-sided p (no ties assumed).
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def render(scene: Path, views: int):
    if (scene / ".render_meta").exists():
        return
    subprocess.run([sys.executable, "-c", "import os, sys; from sfm_tpu_torch.render_scene "
                    "import render_dataset; render_dataset(sys.argv[1], int(sys.argv[2]), "
                    "supersample=1, log=lambda *a: None, workers=max(2, os.cpu_count() - 2))",
                    str(scene), str(views)], cwd=REPO, check=True)


def cusolver(torch, eps):
    def solve(S, rc, rk, scratch=None):
        n, (C, B) = S.shape[0], rc.shape
        L, info = torch.linalg.cholesky_ex(S + eps * torch.eye(n, dtype=S.dtype, device=S.device))
        x = torch.cholesky_solve(torch.cat([rc.reshape(-1), rk])[:, None], L)[:, 0]
        x = torch.where(info == 0, x, torch.nan)
        return x[: B * C].reshape(C, B), x[B * C:]
    return solve


def f32_factor(torch, eps):
    """A dense solve with a float32-rounded factor: the precision rule of a
    factor stored in float32 with float64 sums (not any kernel's bits). A
    right-looking Cholesky over panels of 32 columns in float64: each
    panel's 32 x 32 tile factored, its entries and the rows below it
    rounded to float32 once finished, the trailing matrix updated in
    float64 from the rounded entries; both triangular solves in float64 on
    the rounded factor, x rounded to S's dtype; all-NaN x when a pivot
    fails."""
    def solve(S, rc, rk, scratch=None):
        n, (C, B), T = S.shape[0], rc.shape, S.dtype
        Se = S.clone()
        Se.diagonal().add_(eps)
        A = torch.tril(Se).double()
        A = A + torch.tril(A, -1).mT
        L = torch.zeros_like(A)
        ok = torch.ones((), dtype=torch.bool, device=S.device)
        for j0 in range(0, n, 32):
            j1 = min(j0 + 32, n)
            Lkk, info = torch.linalg.cholesky_ex(A[j0:j1, j0:j1])
            ok &= info == 0
            Lkk = Lkk.float().double()
            L[j0:j1, j0:j1] = Lkk
            if j1 < n:
                L21 = torch.linalg.solve_triangular(Lkk, A[j1:, j0:j1].mT, upper=False).mT
                L21 = L21.float().double()
                L[j1:, j0:j1] = L21
                A[j1:, j1:] -= L21 @ L21.mT
        b = torch.cat([rc.reshape(-1), rk]).double()[:, None]
        y = torch.linalg.solve_triangular(L, b, upper=False)
        x = torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]
        x = torch.where(ok, x, torch.nan).to(T)
        return x[: B * C].reshape(C, B), x[B * C:]
    return solve


def f64_factor(torch, eps, guard: bool):
    """A dense solve with a float64 factor (cuSOLVER's, of S + eps I in
    float64) and x rounded to S's dtype: the kernel's precision rule, not its
    bits. ``guard``: a pivot counts as positive only above n eps(T) times
    its diagonal entry (a float32 factorization's rounding bound), else
    all-NaN x."""
    def solve(S, rc, rk, scratch=None):
        n, (C, B), T = S.shape[0], rc.shape, S.dtype
        Se = S.clone()
        Se.diagonal().add_(eps)
        A = torch.tril(Se).double()
        A = A + torch.tril(A, -1).mT
        L, info = torch.linalg.cholesky_ex(A)
        ok = info == 0
        if guard:
            ok &= (L.diagonal() ** 2 > n * torch.finfo(T).eps * A.diagonal()).all()
        b = torch.cat([rc.reshape(-1), rk]).double()[:, None]
        x = torch.cholesky_solve(b, L)[:, 0]
        x = torch.where(ok, x, torch.nan).to(T)
        return x[: B * C].reshape(C, B), x[B * C:]
    return solve


def run_cli(cli, work: Path, *argv) -> dict:
    rc = cli.main(["--log_level", "WARNING", "--log_dir", str(work / "logs"), *argv,
                   "--device", "cuda", "--no_mask"])
    if rc != 0:
        raise RuntimeError(f"{argv[0]} returned {rc}")
    return json.loads((Path(argv[argv.index("--output_dir") + 1]) / "reconstruction" /
                       "stats.json").read_text()) if argv[0] != "preprocess" else {}


def model(st: dict) -> str:
    return (f"{st['num_cameras']} cameras, {st['num_points']} points, "
            f"{st['mean_reprojection_error']:.4f} px, GT rotation median "
            f"{st.get('gt_rot_err_deg_median', float('nan')):.4f} deg")


def case_sizes(torch, np, dev, out):
    import chip_smoke as cs

    rows = {}
    for dt in (torch.float32, torch.float64):
        for n in (604, 904, 1004, 1540, 2564, 4004, 5404):
            tag = f"{str(dt)[6:]}_{n}"
            rows[tag] = cs.dense_solve_case(torch, np, dev, tag,
                                            *cs.synthetic_spd(torch, np, dev, n, dt, n))
        cs.dense_solve_nan(torch, np, dev, dt)
    print("sizes: a non-positive-definite S gives an all-NaN step, float and double", flush=True)
    out["sizes"] = rows


def case_pathb(torch, work, out):
    from sfm_tpu_torch import cli
    from sfm_tpu_torch.ba import schur

    scene, pre = work / "scene_36", work / "preprocess_36"
    render(scene, 36)
    if not (pre / "pair_table.pkl").exists():
        run_cli(cli, work, "preprocess", "--data_dir", str(scene), "--output_dir", str(pre))
    kernel = schur.dense_solve
    res = {}
    try:
        for name, fn in (("kernel", kernel), ("twin", schur.dense_solve_plain),
                         ("cusolver", cusolver(torch, schur._EPS))):
            d = work / f"dense_report_b_{name}"
            d.mkdir(parents=True, exist_ok=True)
            (d / "pair_table.pkl").write_bytes((pre / "pair_table.pkl").read_bytes())
            schur.dense_solve = fn
            t0 = time.perf_counter()
            st = run_cli(cli, work, "reconstruct", "--data_dir", str(scene), "--output_dir", str(d))
            print(f"path b, dense solve through {name}: {model(st)} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            res[name] = st
    finally:
        schur.dense_solve = kernel
    out["pathb"] = res


def case_residuals(torch, work, out):
    from sfm_tpu_torch import cli
    from sfm_tpu_torch.ba import schur

    scene = work / "scene_150"
    render(scene, 150)
    kernel, solve_l = schur.dense_solve, cusolver(torch, schur._EPS)
    rec = []

    def checked(S, rc, rk, scratch=None):
        S0 = S.clone()
        xc, xk = kernel(S, rc, rk, scratch)
        n = S0.shape[0]
        Se = (S0 + schur._EPS * torch.eye(n, dtype=S0.dtype, device=S0.device)).double()
        b = torch.cat([rc.reshape(-1), rk]).double()
        lc, lk = solve_l(S0, rc, rk)
        xs = [torch.cat([xc.reshape(-1), xk]).double(), torch.cat([lc.reshape(-1), lk]).double()]
        res = [float((Se @ x - b).abs().max() / b.abs().max()) for x in xs]
        step = float((xs[0] - xs[1]).abs().max() / xs[1].abs().max().clamp(min=1e-300))
        rec.append((n, *res, step))
        return xc, xk

    pipe, pol = work / "dense_report_d", work / "dense_report_f"
    res = {}
    schur.dense_solve = checked
    try:
        for name, argv in (("pipeline", ("pipeline", "--data_dir", str(scene), "--output_dir",
                                         str(pipe))),
                           ("polish", ("reconstruct", "--data_dir", str(scene), "--output_dir",
                                       str(pol), "--polish"))):
            if name == "polish":
                pol.mkdir(parents=True, exist_ok=True)
                (pol / "pair_table.pkl").write_bytes((pipe / "pair_table.pkl").read_bytes())
            rec.clear()
            st = run_cli(cli, work, *argv)
            nan_k = sum(math.isnan(r[1]) for r in rec)
            nan_l = sum(math.isnan(r[2]) for r in rec)
            both = [r for r in rec if not (math.isnan(r[1]) or math.isnan(r[2]))]
            ratio = sorted(r[1] / max(r[2], 1e-300) for r in both)
            worse = sum(r[1] > 2 * r[2] + 1e-6 for r in both)
            steps = sorted(r[3] for r in both)
            res[name] = {"model": st, "solves": len(rec), "kernel_failed": nan_k,
                         "cusolver_failed": nan_l, "ratio_median": ratio[len(ratio) // 2],
                         "ratio_max": ratio[-1], "over_twice": worse,
                         "step_median": steps[len(steps) // 2], "step_max": steps[-1]}
            print(f"{name}: {model(st)}; {len(rec)} dense solves (n {min(r[0] for r in rec)}-"
                  f"{max(r[0] for r in rec)}): not positive definite to the kernel {nan_k}, to "
                  f"cuSOLVER {nan_l}; residual kernel / cuSOLVER median {ratio[len(ratio) // 2]:.3g}, "
                  f"max {ratio[-1]:.3g}; over twice cuSOLVER's + 1e-6: {worse}; step kernel vs "
                  f"cuSOLVER median {steps[len(steps) // 2]:.3g}, max {steps[-1]:.3g}", flush=True)
    finally:
        schur.dense_solve = kernel
    out["residuals"] = res


def case_sweep(torch, work, out, seeds, names):
    from sfm_tpu_torch import cli
    from sfm_tpu_torch.ba import schur

    scene, pipe = work / "scene_150", work / "dense_report_sweep"
    render(scene, 150)
    st = run_cli(cli, work, "pipeline", "--data_dir", str(scene), "--output_dir", str(pipe))
    print(f"sweep: path d's pipeline (the kernel, seed 0): {model(st)}", flush=True)
    kernel = schur.dense_solve
    solvers = {"cusolver": cusolver(torch, schur._EPS), "f32_factor": f32_factor(torch, schur._EPS),
               "kernel": kernel, "f64_factor": f64_factor(torch, schur._EPS, False),
               "f64_guarded": f64_factor(torch, schur._EPS, True)}
    solvers = {k: solvers[k] for k in names}
    runs = []
    try:
        for seed in seeds:
            for name, fn in solvers.items():
                schur.dense_solve = fn
                for path, extra in (("d", ()), ("f", ("--polish",))):
                    d = work / f"dense_report_sweep_{path}_{name}_{seed}"
                    d.mkdir(parents=True, exist_ok=True)
                    (d / "pair_table.pkl").write_bytes((pipe / "pair_table.pkl").read_bytes())
                    t0 = time.perf_counter()
                    st = run_cli(cli, work, "reconstruct", "--data_dir", str(scene),
                                 "--output_dir", str(d), *extra, "--config",
                                 json.dumps({"seed": seed}))
                    runs.append({"path": path, "solver": name, "seed": seed,
                                 "cameras": st["num_cameras"],
                                 "gt_deg": st.get("gt_rot_err_deg_median", float("nan")),
                                 "model": st})
                    print(f"sweep: path {path}, seed {seed}, {name}: {model(st)} "
                          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    finally:
        schur.dense_solve = kernel
    summary = {}
    for path in ("d", "f"):
        for name in solvers:
            rs = [r for r in runs if r["path"] == path and r["solver"] == name]
            gt = sorted(r["gt_deg"] for r in rs)
            cams = sorted(r["cameras"] for r in rs)
            summary[f"{path}_{name}"] = {"gt_deg": gt, "cameras": cams}
            print(f"sweep: path {path}, {name}, seeds {seeds[0]}-{seeds[-1]}: cameras "
                  f"{cams[0]}-{cams[-1]} (median {cams[len(cams) // 2]}), GT rotation median "
                  f"{gt[0]:.2f}-{gt[-1]:.2f} deg (median {gt[len(gt) // 2]:.2f}), by seed "
                  f"{[round(r['gt_deg'], 2) for r in rs]}", flush=True)
    out["sweep"] = {"runs": runs, "summary": summary}


def rank_sum_p(a, b) -> tuple:
    """Mann-Whitney U of sample a against b and its exact two-sided p: the
    share of the C(N, len(a)) ways to draw a's ranks whose rank sum lies as
    far from the mean as a's does (ranks 1..N, no ties)."""
    pooled = sorted(a + b)
    ra = sum(pooled.index(v) + 1 for v in a)
    n1, N = len(a), len(a) + len(b)
    ways = [[0] * (N * (N + 1) // 2 + 1) for _ in range(n1 + 1)]
    ways[0][0] = 1
    for r in range(1, N + 1):
        for k in range(min(r, n1), 0, -1):
            for t in range(r, len(ways[k])):
                ways[k][t] += ways[k - 1][t - r]
    total, mean = sum(ways[n1]), n1 * (N + 1) / 2
    p = sum(c for t, c in enumerate(ways[n1]) if abs(t - mean) >= abs(ra - mean)) / total
    return ra - n1 * (n1 + 1) / 2, p


def compare(files, extra) -> int:
    gt = {}
    for f in files:
        label, _, f = f.rpartition("=")   # LABEL=F.json names its solvers LABEL:solver
        for r in json.loads(Path(f).read_text())["sweep"]["runs"]:
            name = f"{label}:{r['solver']}" if label else r["solver"]
            gt.setdefault(r["path"], {}).setdefault(name, []).append(r["gt_deg"])
    for item in extra:
        name, vals = item.split("=")
        name, path = name.split(":")
        gt.setdefault(path, {})[name] = [float(v) for v in vals.split(",")]
    for path, by in gt.items():
        names = list(by)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                u, p = rank_sum_p(by[a], by[b])
                print(f"path {path}: {a} (median {sorted(by[a])[len(by[a]) // 2]:.2f}, "
                      f"n {len(by[a])}) against {b} (median {sorted(by[b])[len(by[b]) // 2]:.2f}, "
                      f"n {len(by[b])}): U {u:.0f} of {len(by[a]) * len(by[b])}, p {p:.3f}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default="sizes,pathb,residuals")
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7", help="the sweep's engine seeds")
    ap.add_argument("--solvers", default="cusolver,f32_factor,kernel",
                    help="the sweep's solvers: cusolver, f32_factor, kernel, f64_factor, "
                         "f64_guarded")
    ap.add_argument("--work", default=str(REPO / ".chip_smoke"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--compare", nargs="*", default=None, help="sweep --out files (no card)")
    ap.add_argument("--extra", nargs="*", default=[], help="NAME:PATH=v,v,... samples")
    args = ap.parse_args(argv)
    if args.compare is not None:
        return compare(args.compare, args.extra)
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("dense_solve_report: this needs a card")
    import chip_smoke as cs

    print(cs.card_line(), flush=True)
    work = Path(args.work)
    work.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    out = {"card": cs.card_line()}
    for case in args.cases.split(","):
        if case == "sizes":
            case_sizes(torch, np, dev, out)
        elif case == "pathb":
            case_pathb(torch, work, out)
        elif case == "residuals":
            case_residuals(torch, work, out)
        elif case == "sweep":
            case_sweep(torch, work, out, [int(x) for x in args.seeds.split(",")],
                       args.solvers.split(","))
        else:
            raise SystemExit(f"unknown case {case}")
    if args.out:
        Path(args.out).write_text(json.dumps(out, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
