"""Where K6's P3P round spends its time: ``clock64`` stamps of each phase of
its kernels, and ``ptxas``'s registers and spills, on a card.

    python tests/p3p_stamps.py [--repo CHECKOUT] [--inputs DIR] [--out F.json]

Builds the checkout's ``csrc/pnp_ransac.cu`` once more into a library of its
own (under the checkout's ``sfm_tpu_torch/_build/stamps``) with the probes of
``tests/ransac_stamps.py``: a probe adds the cycles since the last one to a
slot of its thread (the first design's ``p3p_kernel``: every thread, one a
sample) or of its block (thread 0's clock), and the kernel's end writes its
cycles beside its ``%globaltimer`` nanoseconds, which give the clock. The
first design gets its probes at known lines of its text (the script stops if
one is missing); the redesign carries them (``SFM_ST`` macros, empty unless
this script defines them). The checkout's round (``tests/bits_report.py``'s
``p3p_round``) then runs through that library at ``phase_pnp``'s shape (8
candidates x 2,048 samples x 2,048 rows) and, with ``--inputs`` (what
``bits_report.py dump`` wrote), on path d's round with the most work. Printed
for each: the round's device time through the real library (the stream held
while the host enqueues), each kernel's (one ``torch.profiler`` trace), the
clock, and each slot in microseconds, the mean over the threads or blocks
that stamped it and the largest.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import ransac_stamps as rs  # noqa: E402

NS = rs.NS
# Stamp units of the first design's scoring blocks start past its threads'.
SCORE_BASE = 1 << 17
FIRST = [
    ("  if (i >= n) return;\n", "", "  SFM_ST_INIT(i, true)\n"),
    ("    normalize3(f[r]);\n  }\n", "", "  SFM_ST(0)\n"),
    ("  // Durand-Kerner on the monic quartic.\n", "  SFM_ST(1)\n", ""),
    ("  float Tw[3][3];\n  const bool w_ok = triad(P, Tw);\n", "  SFM_ST(2)\n", ""),
    ("  extern __shared__ float sm[];  // 6 floats a row: X, Y, Z, u, v, valid\n", "",
     f"  SFM_ST_INIT({SCORE_BASE} + blockIdx.y * gridDim.x + blockIdx.x, threadIdx.x == 0)\n"),
    ("  __syncthreads();\n  float k4[4];\n", "", "  SFM_ST(4)\n"),
    ("    best = SfmCand{sfm_ransac_score(count, err_sum, thr), h, count};\n", "  SFM_ST(5)\n",
     ""),
    ("    p[2] = __int_as_float(best.count);\n  }\n", "", "  SFM_ST(6)\n  SFM_ST_END\n"),
]
FIRST_REPLACE = [
    ("    ok_out[(size_t)i * 4 + k] = ok;\n  }\n}\n",
     "    ok_out[(size_t)i * 4 + k] = ok;\n  }\n  SFM_ST(3)\n  SFM_ST_END\n}\n"),
]
FIRST_SLOTS = ("solve: load the sample, normalize", "solve: quartic coefficients",
               "solve: 30 Durand-Kerner steps (4 roots)", "solve: 4 poses and stores",
               "score: staging (6 floats a row)", "score: thread 0's walk (one hypothesis)",
               "score: the block's best")
REDESIGN_SLOTS = ("staging (the valid prefix, SoA)", "(unused)", "(unused)",
                  "solve (a root a lane: the sample, 30 Durand-Kerner steps, the pose, stores)",
                  "walk (warp 0's 32 hypotheses)", "the tile's best, ticket",
                  "last tile: the candidate's winner")


def build(repo: Path, work: Path):
    sys.path.insert(0, str(repo))
    from sfm_tpu_torch import _kernels

    csrc = repo / "sfm_tpu_torch" / "csrc"
    work.mkdir(parents=True, exist_ok=True)
    for h in csrc.glob("*.cuh"):
        (work / h.name).write_text(h.read_text())
    src = (csrc / "pnp_ransac.cu").read_text()
    redesign = "SFM_ST(" in src
    text = rs.PRELUDE + (src if redesign else rs.insert(src, FIRST, FIRST_REPLACE,
                                                        "pnp_ransac.cu")) + rs.SETTER
    cu, so = work / "stamped_pnp_ransac.cu", work / "libstamped_pnp_ransac.so"
    cu.write_text(text)
    flags = list(_kernels.NVCC_FLAGS)
    res = subprocess.run([_kernels._nvcc(), *flags, "-shared", "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"p3p_stamps: nvcc failed:\n{res.stdout}\n{res.stderr}")
    report = rs.ptxas_report(_kernels._nvcc(), flags, csrc, ["pnp_ransac.cu"], work)
    return so, report, redesign


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--inputs", default=None, help="what bits_report.py dump wrote")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    repo = Path(args.repo).resolve()
    so, report, redesign = build(repo, repo / "sfm_tpu_torch" / "_build" / "stamps")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("p3p_stamps: no card")
    import bits_report as br
    import chip_smoke as cs
    from sfm_tpu_torch import _kernels
    from sfm_tpu_torch.estimators import pnp
    from sfm_tpu_torch.estimators.ransac import ransac_sample_indices

    smi = cs.card_line()
    print(f"card: {smi}; checkout {repo}", flush=True)
    for line in report:
        print("ptxas " + line, flush=True)
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream
    lib = ctypes.CDLL(str(so))
    lib.sfm_st_set.argtypes, lib.sfm_st_set.restype = [ctypes.c_void_p], ctypes.c_int
    for name in _kernels.SETUP:
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
            assert fn(stream()) == 0, name
    slots = REDESIGN_SLOTS if redesign else FIRST_SLOTS

    def stamped_launch(kernel, device, *a):
        fn = getattr(lib, f"sfm_{kernel}")
        fn.argtypes, fn.restype = _kernels.SIGNATURES[f"sfm_{kernel}"], ctypes.c_int
        rc = fn(*[x.data_ptr() if isinstance(x, torch.Tensor) else x for x in a], stream())
        if rc != 0:
            raise RuntimeError(f"{kernel}: CUDA error {rc}")

    cases = {}
    p3, p2, valid, K, _, _, _ = cs.pnp_scene(torch, np, dev, 8, 2048, seed=3)
    g = torch.Generator(device=dev).manual_seed(4)
    idx = ransac_sample_indices(valid, 2048, 3, g, prefix=True).contiguous()
    cases["phase_pnp (8 x 2,048 samples x 2,048 rows)"] = (p3, p2, valid, K, idx, 8.0)
    f = Path(args.inputs or "") / "p3p.pt"
    if args.inputs and f.exists():
        rounds = torch.load(f, weights_only=False)
        work = [r["indices"].shape[1] * int(r["valid"].sum()) for r in rounds]
        i = int(np.argmax(work))
        c = rounds[i]
        to = lambda x: x.to(dev).contiguous()
        cases[f"path d round {i} (B={c['valid'].shape[0]}, valid rows "
              f"{c['valid'].sum(1).tolist()})"] = (
            to(c["pts3d"]), to(c["pts2d"]), to(c["valid"]), to(c["K"]),
            to(c["indices"].long()), c["threshold"])
    rows = {}
    runner = br.Runner(torch, cs, None, None)
    for name, a in cases.items():
        pn = br.normalized(torch, a[1], a[3])
        fn = lambda: br.p3p_round(torch, pnp, a[0], pn, *a[1:])
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
        buf = torch.zeros((SCORE_BASE + 8192) * NS, dtype=torch.int64, device=dev)
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
        mean = {s: us(st[:, i][st[:, i] > 0].mean()) if (st[:, i] > 0).any() else 0.0
                for i, s in enumerate(slots)}
        most = {s: us(st[:, i].max()) for i, s in enumerate(slots)}
        rows[name] = dict(stream_ms=stream_ms, stamped_stream_ms=stamped_ms, ghz=ghz,
                          kernels={k: v[0] for k, v in kernels.items()},
                          mean_us=mean, max_us=most)
        print(f"{name}: the round's device time {cs.fmt_ms(stream_ms)} (stamped "
              f"{cs.fmt_ms(stamped_ms)}); {int(used.sum())} stamped units at {ghz:.3f} GHz",
              flush=True)
        for k, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
            print(f"    {ms:.4f} ms x{n} {k}", flush=True)
        print("  us, mean / largest: " + "; ".join(f"{s} {mean[s]:.2f} / {most[s]:.2f}"
                                                  for s in slots), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi, "ptxas": report, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
