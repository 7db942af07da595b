"""Time one stage of the port warm, then trace one run on the card.

    python -m sfm_tpu_torch.profile_stage --data_dir D --output_dir O [--runs 5]
        [--stage preprocess|reconstruct] [--config C]

Runs ``python -m sfm_tpu_torch <stage> --device cuda --no_mask`` on ``D``
once cold and ``--runs`` times warm in this process, printing each run's
stage seconds from ``metrics.json`` (reconstruct reads ``O/pair_table.pkl``,
so run preprocess into ``O`` first; ``--config`` is passed through). Then it
runs once more with ``--trace_dir`` (the CLI's own ``torch.profiler``
capture) and reads the Chrome trace:

- device busy time: the union of the kernel, memcpy and memset intervals;
- for the traced window and for the stage's spans (``detect``, ``retrieval``
  when it runs, and ``sweep``;
  the engine's ``sfm/<name>`` spans, summed over their calls), the share of
  the span in which the device was idle;
- the kernel count and the device time by kernel name;
- the kernels by the outermost PyTorch operator that launched them
  (``aten::...``; the port's own kernels, launched through ctypes, count
  under "(no operator)"), so that a launch count can be traced to its call.

The profiler slows the host, so the traced window is longer than a warm run
and overstates the idle share; the script also prints the idle share of the
warm median stage time, given the traced busy time. The last line is a JSON
object of these numbers.
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import time
from collections import defaultdict
from pathlib import Path

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = {
    "preprocess": ("detect", "retrieval", "sweep"),
    "reconstruct": ("sfm/init", "sfm/select", "sfm/pnp", "sfm/guided", "sfm/triangulate",
                    "sfm/assemble", "sfm/ba", "sfm/prune", "sfm/stats", "sfm/global_init",
                    "sfm/polish"),
}


def _union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def trace_summary(trace_path: Path, span_names=SPANS["preprocess"]) -> dict:
    """Device busy time, idle shares per span (summed over a span's
    occurrences), kernel count and device time by kernel name, from a
    torch.profiler Chrome trace."""
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    iv = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    spans = defaultdict(list)
    spans["window"].append((min(e["ts"] for e in events),
                            max(e["ts"] + e["dur"] for e in events)))
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in span_names:
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    out = {"kernels": sum(e["cat"] == "kernel" for e in dev)}
    for name, occ in spans.items():
        span = sum(hi - lo for lo, hi in occ)
        busy = sum(_union_us(iv, lo, hi) for lo, hi in occ)
        out[name] = {"span_s": span / 1e6, "device_busy_s": busy / 1e6,
                     "idle_share": 1.0 - busy / span, "calls": len(occ)}
    by_name = defaultdict(lambda: [0, 0.0])
    for e in dev:
        key = e["name"] if e["cat"] == "kernel" else e["cat"]
        by_name[key][0] += 1
        by_name[key][1] += e["dur"]
    out["by_name"] = sorted(([n, c, us / 1e3] for n, (c, us) in by_name.items()),
                            key=lambda r: -r[2])
    out["by_op"] = kernels_by_operator(events)
    return out


def kernels_by_operator(events) -> list:
    """[operator, kernels, device ms] per outermost ``cpu_op`` whose interval
    holds the kernel's launch (matched by the trace's correlation id), most
    kernels first."""
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    tops = defaultdict(list)   # (pid, tid) -> outermost cpu_ops, by start
    for e in sorted((e for e in events if e.get("cat") == "cpu_op"), key=lambda e: e["ts"]):
        lst = tops[(e.get("pid"), e.get("tid"))]
        if not lst or e["ts"] >= lst[-1]["ts"] + lst[-1]["dur"]:
            lst.append(e)
    starts = {k: [e["ts"] for e in v] for k, v in tops.items()}
    by_op = defaultdict(lambda: [0, 0.0])
    for k in (e for e in events if e.get("cat") == "kernel"):
        op = "(no operator)"
        r = launch.get(k.get("args", {}).get("correlation"))
        if r is not None:
            key = (r.get("pid"), r.get("tid"))
            i = bisect.bisect_right(starts.get(key, []), r["ts"]) - 1
            if i >= 0 and r["ts"] <= tops[key][i]["ts"] + tops[key][i]["dur"]:
                op = tops[key][i]["name"]
        by_op[op][0] += 1
        by_op[op][1] += k["dur"]
    return sorted(([n, c, us / 1e3] for n, (c, us) in by_op.items()), key=lambda r: -r[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_dir", required=True, help="dataset root (images/)")
    ap.add_argument("--output_dir", required=True, help="artifacts and the trace")
    ap.add_argument("--runs", type=int, default=5, help="warm runs after the cold one")
    ap.add_argument("--stage", default="preprocess", choices=sorted(SPANS))
    ap.add_argument("--config", default=None, help="SfMConfig JSON passed to the CLI")
    args = ap.parse_args(argv)

    import torch

    from sfm_tpu_torch import cli

    out = Path(args.output_dir)
    extra_cfg = ["--config", args.config] if args.config else []

    def run(*extra) -> dict:
        rc = cli.main(["--log_level", "WARNING", "--log_dir", str(out / "logs"), args.stage,
                       "--data_dir", args.data_dir, "--output_dir", str(out),
                       "--device", "cuda", "--no_mask", *extra_cfg, *extra])
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"{args.stage} returned {rc}")
        totals = defaultdict(float)
        for r in json.loads((out / "metrics.json").read_text()):
            if r["name"].split("/")[0] in ("stage", "engine"):
                totals[r["name"].split("/")[1]] += r["value"]
        return dict(totals)

    rows = []
    for i in range(1 + args.runs):
        t0 = time.perf_counter()
        m = run()
        print(f"run {i} ({'cold' if i == 0 else 'warm'}): wall {time.perf_counter() - t0:.4f} s "
              + " ".join(f"{k} {v:.4f}" for k, v in m.items()), flush=True)
        rows.append(m)
    # A span that ran in only some runs (engine/guided) counts 0 s in the others.
    keys = dict.fromkeys(k for r in rows for k in r)
    warm = {k: statistics.median(r.get(k, 0.0) for r in rows[1:]) for k in keys}
    print("warm median: " + ", ".join(f"{k} {v:.4f} s" for k, v in warm.items()))

    run("--trace_dir", str(out / "trace"))
    s = trace_summary(out / "trace" / "trace.json", SPANS[args.stage])
    for name in ("window", *SPANS[args.stage]):
        if name in s:
            r = s[name]
            print(f"traced {name}: span {r['span_s']:.4f} s ({r['calls']} calls), device busy "
                  f"{r['device_busy_s']:.4f} s, idle {r['idle_share']:.1%}")
    busy = s["window"]["device_busy_s"]
    s["warm_median_s"] = warm
    s["idle_share_of_warm_stage"] = 1.0 - busy / warm[args.stage]
    print(f"device busy {busy:.4f} s against the warm median stage "
          f"{warm[args.stage]:.4f} s: idle {s['idle_share_of_warm_stage']:.1%}")
    print(f"{s['kernels']} kernels; device time by name (count, ms):")
    for n, c, ms in s["by_name"][:20]:
        print(f"  {ms:10.3f} ms  {c:6d}  {n[:90]}")
    print("kernels by the outermost operator that launched them (count, ms):")
    for n, c, ms in s["by_op"][:12]:
        print(f"  {c:8d}  {ms:10.3f} ms  {n[:90]}")
    s["by_name"] = s["by_name"][:20]
    s["by_op"] = s["by_op"][:12]
    print(json.dumps(s))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
