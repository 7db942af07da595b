"""Where K5's ``sift_describe`` and K1-r's ``retrieval_score`` spend their
time: ``clock64`` stamps of each phase of their kernels, and ``ptxas``'s
registers and spills, on a card.

    python tests/describe_stamps.py [--repo CHECKOUT] [--scene DIR] [--inputs DIR]
                                    [--out F.json]

Builds the checkout's ``csrc/sift_describe.cu`` and ``csrc/retrieval_score.cu``
once more, each into a library of its own (under the checkout's
``sfm_tpu_torch/_build/stamps``), with the probes of
``tests/ransac_stamps.py``: a probe adds the cycles since the last one to a
slot of its unit (the first designs: a block, thread 0's clock; K5's
redesign: a warp, lane 0's; K1-r's redesign: a block), and the unit's end
writes its cycles beside its ``%globaltimer`` nanoseconds, which give the
clock. The first designs get their probes at known lines of their text (the
script stops if one is missing); the redesigns carry them (``SFM_ST``
macros, empty unless this script defines them). The checkout's wrappers then
run through those libraries at path d's launch shapes: K5 on the smoke's
12-image detection batch (the first 12 of ``--scene``'s 36 rendered views,
rendered there first where it holds none), K1-r on
``phase_retrieval_score``'s 1,024-pair chunk and, with ``--inputs`` (what
``bits_report.py dump`` wrote), on path d's first real chunk. Printed for
each: the device time a call through the real library (the stream held while
the host enqueues), each kernel's (one ``torch.profiler`` trace), the clock,
and each slot in microseconds, the mean over the units that stamped it and
the largest.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import ransac_stamps as rs  # noqa: E402

NS = rs.NS
# The first designs' probes: (anchor, text before it, text after it).
FIRST = {
    "sift_describe.cu": [
        ("  const int t = threadIdx.x;\n", "", "  SFM_ST_INIT(blockIdx.x, threadIdx.x == 0)\n"),
        ("  if (t < 128) fx_desc[t] = 0ull;\n  __syncthreads();\n", "", "  SFM_ST(0)\n"),
        ("    gy[e] = half_grad(patch[(r + 2) * GP + c + 1], patch[r * GP + c + 1]);\n  }\n"
         "  __syncthreads();\n", "", "  SFM_ST(1)\n"),
        ("    sh = sfm_fx_shift((double)block_sum(wgt, red));\n", "    SFM_ST(7)\n",
         "    SFM_ST(8)\n"),
        ("  if (t < ORI_BINS) hist_a[t] = (float)sfm_fx_value(fx_ori[t], sh);\n", "  SFM_ST(2)\n",
         ""),
        ("  if (t == 0) {\n    int p = 0;\n", "  SFM_ST(3)\n", ""),
        ("  const float angle = s_angle;\n", "  SFM_ST(4)\n", ""),
        ("    sh = sfm_fx_shift(16.0 * (double)block_sum(contrib, red));\n", "    SFM_ST(9)\n",
         "    SFM_ST(10)\n"),
        ("  float v = t < 128 ? (float)sfm_fx_value(fx_desc[t], sh) : 0.f;\n", "  SFM_ST(5)\n",
         ""),
    ],
    "retrieval_score.cu": [
        ("  const int p = blockIdx.x;\n", "", "  SFM_ST_INIT(blockIdx.x, threadIdx.x == 0)\n"),
        ("  if (threadIdx.x == 0) total = 0;\n  __syncthreads();\n", "", "  SFM_ST(0)\n"),
        ("      dots(stage, A, S, r0, B, S, c0, D, acc);\n", "", "      SFM_ST(1)\n"),
        ("      __syncthreads();\n      if (threadIdx.x < TC && c0 + threadIdx.x < S) {\n",
         "      SFM_ST(2)\n", ""),
        ("      // The next tile's dots() synchronizes before red_* is written again.\n",
         "      SFM_ST(3)\n", ""),
        ("        row_second[row] = top[i].second;\n      }\n    }\n", "", "    SFM_ST(4)\n"),
    ],
}
FIRST_REPLACE = {
    "sift_describe.cu": [("  if (t == 0) angle_out[kp] = angle;\n}\n",
                          "  if (t == 0) angle_out[kp] = angle;\n  SFM_ST(6)\n  SFM_ST_END\n}\n")],
    "retrieval_score.cu": [("  if (threadIdx.x == 0) counts[p] = total;\n}\n",
                            "  if (threadIdx.x == 0) counts[p] = total;\n  SFM_ST(5)\n"
                            "  SFM_ST_END\n}\n")],
}
SLOTS = {
    "sift_describe.cu": {
        0: "staging", 1: "gradient planes", 7: "pass 1: samples", 8: "pass 1: weight sum",
        2: "pass 1: atomics", 3: "smoothing", 4: "peak", 9: "pass 2: samples",
        10: "pass 2: weight sum", 5: "pass 2: atomics", 6: "normalisation"},
    "retrieval_score.cu": {
        0: "init", 1: "dots (staging, FMAs)", 2: "tile epilogue (distances, top-2, keys)",
        3: "column fold", 4: "rows' top-2 merge", 5: "count", 6: "ring wait + barrier"},
}
# Units a case may stamp: K5's keypoints (a 12-image batch of 2,048 each),
# K1-r's pairs.
MAX_UNITS = 32768


def build(repo: Path, work: Path, name: str):
    sys.path.insert(0, str(repo))
    from sfm_tpu_torch import _kernels

    csrc = repo / "sfm_tpu_torch" / "csrc"
    work.mkdir(parents=True, exist_ok=True)
    for h in csrc.glob("*.cuh"):
        (work / h.name).write_text(h.read_text())
    src = (csrc / name).read_text()
    redesign = "SFM_ST(" in src
    text = rs.PRELUDE + (src if redesign else rs.insert(src, FIRST[name], FIRST_REPLACE[name],
                                                        name)) + rs.SETTER
    stem = name.rsplit(".", 1)[0]
    cu, so = work / f"stamped_{name}", work / f"libstamped_{stem}.so"
    cu.write_text(text)
    flags = list(_kernels.NVCC_FLAGS)
    res = subprocess.run([_kernels._nvcc(), *flags, "-shared", "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"describe_stamps: nvcc {name} failed:\n{res.stdout}\n{res.stderr}")
    return so, rs.ptxas_report(_kernels._nvcc(), flags, csrc, [name], work), redesign


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--scene", default=".chip_smoke/scene_36",
                    help="the smoke's 36 rendered views (rendered there if missing)")
    ap.add_argument("--inputs", default=None, help="what bits_report.py dump wrote")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    repo = Path(args.repo).resolve()
    work = repo / "sfm_tpu_torch" / "_build" / "stamps"
    libs = {name: build(repo, work, name) for name in ("sift_describe.cu", "retrieval_score.cu")}

    import ctypes

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("describe_stamps: no card")
    import bits_report as br
    import chip_smoke as cs
    from sfm_tpu_torch import _kernels
    from sfm_tpu_torch.config import SfMConfig
    from sfm_tpu_torch.features.descriptor import orientation_and_descriptor_canvas_cuda
    from sfm_tpu_torch.features.frontend import select_keypoints
    from sfm_tpu_torch.matching.retrieval import score_chunk_cuda

    smi = cs.card_line()
    print(f"card: {smi}; checkout {repo}", flush=True)
    for _, report, _ in libs.values():
        for line in report:
            print("ptxas " + line, flush=True)
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream
    loaded = {}
    for name, (so, _, _) in libs.items():
        lib = ctypes.CDLL(str(so))
        lib.sfm_st_set.argtypes, lib.sfm_st_set.restype = [ctypes.c_void_p], ctypes.c_int
        for setup in _kernels.SETUP:
            fn = getattr(lib, setup, None)
            if fn is not None:
                fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
                assert fn(stream()) == 0, setup
        loaded[name] = lib

    fc = SfMConfig().features
    images = br.smoke_images(torch, args.scene)
    kp = select_keypoints(images, None, fc)
    kw = dict(descriptor_scale=fc.descriptor_scale, clip=fc.descriptor_clip)
    cases = {f"K5 sift_describe, 12 images x {kp['valid'].shape[1]} keypoints": (
        "sift_describe.cu", lambda: orientation_and_descriptor_canvas_cuda(*kp["describe"], **kw))}
    desc, valid = cs.corridor_descriptors(torch, dev, 150, 256)
    pairs = [(k, k + d) for d in range(1, 8) for k in range(150 - d)] + [(0, 149), (3, 90)]
    pairs = torch.tensor(pairs, dtype=torch.int32, device=dev)
    cases["K1-r retrieval_score, phase chunk (1,024 pairs, S 256, D 128)"] = (
        "retrieval_score.cu", lambda: score_chunk_cuda(pairs, desc, valid, 0.75))
    f = Path(args.inputs or "") / "retrieval.pt"
    if args.inputs and f.exists():
        blob = torch.load(f, weights_only=False)
        d_s, v_s = blob["desc_s"].to(dev), blob["valid_s"].to(dev)
        p0 = blob["pairs"][:blob["chunk_size"]].to(dev).contiguous()
        cases[f"K1-r retrieval_score, path d's first chunk ({p0.shape[0]} pairs)"] = (
            "retrieval_score.cu", lambda: score_chunk_cuda(p0, d_s, v_s, blob["ratio"]))

    runner = br.Runner(torch, cs, None, None)
    rows = {}
    for title, (name, fn) in cases.items():
        lib = loaded[name]
        stream_ms = runner.stream_ms(fn)
        kernels = {}
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_time_total > 0:
                kernels[e.key[:70]] = (e.device_time_total / 1e3 / 10, e.count // 10)

        def stamped_launch(kernel, device, *a):
            entry = getattr(lib, f"sfm_{kernel}")
            entry.argtypes, entry.restype = _kernels.SIGNATURES[f"sfm_{kernel}"], ctypes.c_int
            rc = entry(*[x.data_ptr() if isinstance(x, torch.Tensor) else x for x in a],
                       stream())
            if rc != 0:
                raise RuntimeError(f"{kernel}: CUDA error {rc}")

        buf = torch.zeros(MAX_UNITS * NS, dtype=torch.int64, device=dev)
        assert lib.sfm_st_set(buf.data_ptr()) == 0
        real = _kernels.launch
        _kernels.launch = stamped_launch
        try:
            fn()
            torch.cuda.synchronize()
            stamped_ms = runner.stream_ms(fn)
            buf.zero_()
            fn()
            torch.cuda.synchronize()
        finally:
            _kernels.launch = real
        st = buf.cpu().numpy().reshape(-1, NS).astype(np.float64)
        used = st[:, 19] > 0
        st = st[used]
        ghz = float(st[:, 19].sum() / max(st[:, 18].sum(), 1.0))
        us = lambda c: float(c) / ghz / 1e3
        slots = SLOTS[name]
        mean = {s: us(st[:, i][st[:, i] > 0].mean()) if (st[:, i] > 0).any() else 0.0
                for i, s in slots.items()}
        most = {s: us(st[:, i].max()) for i, s in slots.items()}
        total = us(st[:, 19].mean())
        rows[title] = dict(stream_ms=stream_ms, stamped_stream_ms=stamped_ms, ghz=ghz,
                           units=int(used.sum()), unit_us=total, redesign=libs[name][2],
                           kernels={k: v[0] for k, v in kernels.items()},
                           mean_us=mean, max_us=most)
        print(f"{title}: device time a call {cs.fmt_ms(stream_ms)} (stamped "
              f"{cs.fmt_ms(stamped_ms)}); {int(used.sum())} stamped units at {ghz:.3f} GHz, "
              f"{total:.2f} us a unit", flush=True)
        for k, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
            print(f"    {ms:.4f} ms x{n} {k}", flush=True)
        print("  us a unit, mean / largest: " + "; ".join(
            f"{s} {mean[s]:.2f} / {most[s]:.2f}" for s in slots.values() if most[s] > 0),
              flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi, "rows": rows,
                                              "ptxas": [ln for _, r, _ in libs.values()
                                                        for ln in r]}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
