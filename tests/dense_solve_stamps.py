"""Where K10's dense solve spends its time: ``clock64`` stamps of each panel's
phases in every block, on a card.

    python tests/dense_solve_stamps.py [--repo CHECKOUT] [--sizes 904,1540,...]
        [--dtypes float32,float64] [--out F.json]

Builds the checkout's ``sfm_tpu_torch/csrc/schur_cholesky.cu`` once more with
stamps (into the checkout's ``sfm_tpu_torch/_build/stamps``) and runs the
checkout's ``dense_solve_cuda`` on ``chip_smoke.synthetic_spd`` systems through
that library, after one warm-up. A source that carries its own stamps
(``SFM_CHOL_STAMPS``) is built with that macro defined; an older source (the
first design, whose text is fixed) is stamped by inserting the same probes
at known lines, and the script stops if a line is missing.

Every block writes, for each panel k, eight cycle counts (``SLOTS``) to a
device buffer: the wait at the panel's grid barrier or flags, loading the
tile's sums and panel k - 1's terms, the pivot chain, the rows' 32-step
substitution, the next panel's products with their staging (the bulk
warps, which run beside the chain), the step's total, the wait for the bulk
warps at the step's end, and (new design, where warps 2-7 sum the own rows
beside the tile's sums and pivots) the own rows' sums. Block 0
also writes the back-substitution's barrier wait and its own time, and the
kernel's cycles beside its ``%globaltimer`` nanoseconds, which give the
clock (the new design: every block, for its panels of the back-substitution).
The build also carries a probe: whether the card takes a launch that is
cooperative and clustered at once (``cudaLaunchKernelEx`` with
``cudaLaunchAttributeCooperative`` and a cluster dimension of 2). Printed for each case: the device time with and without stamps, the
clock, and each slot summed over the panels (the mean over blocks, and the
largest block), in microseconds.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

SLOTS = ("barrier", "tile_and_terms", "pivot_chain", "row_substitution", "next_products",
         "step", "bulk_wait", "own_rows_sums")
EXTRA = ("backsub_wait", "backsub", "kernel_cycles", "kernel_ns")

PRELUDE = """
__device__ unsigned long long* g_stamps;  // [G][K][8] cycles, then the back-substitution's
"""
SETTER = """
SFM_API int sfm_chol_set_stamps(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)));
}
"""
# Whether one launch may be cooperative and clustered at once (an empty
# kernel, 132 blocks in clusters of 2): 0, or the CUDA error.
PROBE = """
__global__ void sfm_probe_kernel() {}
SFM_API int sfm_chol_probe_cluster_coop(void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(132);
  cfg.blockDim = dim3(32);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeCooperative;
  at[0].val.cooperative = 1;
  at[1].id = cudaLaunchAttributeClusterDimension;
  at[1].val.clusterDim.x = 2;
  at[1].val.clusterDim.y = 1;
  at[1].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  cudaError_t e = cudaLaunchKernelEx(&cfg, sfm_probe_kernel);
  if (e == cudaSuccess) e = cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}
"""
# The first design's probes: (anchor, text inserted after it).
FIRST_DESIGN = [
    ("  if (tid == 0) *bad_flag = 0;\n  int cur = 0;\n",
     "  const long long _c_start = clock64();\n"
     "  unsigned long long _g_start;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(_g_start));\n"),
    ("    if (k > 0) grid.sync();\n",
     "    const long long _t1 = clock64();\n"
     "    long long _tl = _t1, _a1 = 0, _a2 = 0, _a3 = 0, _a4 = 0, _a6 = 0;\n"),
    ("        if (first) factor_tile(D, LT, R, w, lane, bad_flag);\n",
     "        { const long long _n = clock64(); _a2 += _n - _tl; _tl = _n; }\n"),
    ("          if (lane < w) lrow(L, y, n, g + rr * Gv)[j0 + lane] = LO[rr * W + lane];\n",
     "        { const long long _n = clock64(); _a3 += _n - _tl; _tl = _n; }\n"),
    ("      } else if (bulk) {\n", "        const long long _b0 = clock64();\n"),
    ("            Anxt[r * W + p] = v;\n          }\n        }\n",
     "        _a4 += clock64() - _b0;\n"),
]


def stamp_first_design(src: str) -> str:
    def sub(old, new):
        nonlocal src
        if src.count(old) != 1:
            raise SystemExit(f"dense_solve_stamps: the anchor {old!r} is not in the source once")
        src = src.replace(old, new)

    sub('#include "sfm_common.cuh"\n', '#include "sfm_common.cuh"\n' + PRELUDE)
    sub("    if (k > 0) grid.sync();\n",
        "    const long long _t0 = clock64();\n    if (k > 0) grid.sync();\n")
    for anchor, text in FIRST_DESIGN:
        sub(anchor, anchor + text)
    sub("      __syncthreads();\n\n      // 2. Warp 0 factors the tile",
        "      __syncthreads();\n"
        "      { const long long _n = clock64(); _a1 += _n - _tl; _tl = _n; }\n\n"
        "      // 2. Warp 0 factors the tile")
    sub("      __syncthreads();\n      if (spill) {  // the next panel's sums",
        "      __syncthreads();\n"
        "      { const long long _n = clock64(); _a6 += _n - _tl; _tl = _n; }\n"
        "      if (spill) {  // the next panel's sums")
    sub("    cur ^= 1;\n",
        "    {\n"
        "      unsigned long long* s = g_stamps + ((size_t)b * K + k) * 8;\n"
        "      if (tid == 0) {\n"
        "        s[0] = _t1 - _t0; s[1] = _a1; s[2] = _a2; s[3] = _a3;\n"
        "        s[5] = clock64() - _t0; s[6] = _a6; s[7] = 0;\n"
        "      }\n"
        "      if (tid == 32) s[4] = _a4;\n"
        "    }\n"
        "    cur ^= 1;\n")
    sub("  grid.sync();\n  if (b != 0) return;\n",
        "  const long long _bs0 = clock64();\n  grid.sync();\n"
        "  const long long _bs1 = clock64();\n  if (b != 0) return;\n")
    sub("    __syncthreads();\n  }\n}\n\nint schur_cholesky_solve(",
        "    __syncthreads();\n  }\n"
        "  if (tid == 0) {\n"
        "    unsigned long long _g_end;\n"
        "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(_g_end));\n"
        "    unsigned long long* e = g_stamps + (size_t)G * K * 8;\n"
        "    e[0] = _bs1 - _bs0; e[1] = clock64() - _bs1; e[2] = clock64() - _c_start;\n"
        "    e[3] = _g_end - _g_start;\n"
        "  }\n"
        "}\n\nint schur_cholesky_solve(")
    return src + SETTER


def build(repo: Path) -> Path:
    sys.path.insert(0, str(repo))
    from sfm_tpu_torch import _kernels

    src_path = repo / "sfm_tpu_torch" / "csrc" / "schur_cholesky.cu"
    src = src_path.read_text()
    flags = list(_kernels.NVCC_FLAGS)
    if "SFM_CHOL_STAMPS" in src:
        flags.append("-DSFM_CHOL_STAMPS")
    else:
        src = stamp_first_design(src)
    src += PROBE
    out = repo / "sfm_tpu_torch" / "_build" / "stamps"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "schur_cholesky_stamped.cu", out / "libsfm_chol_stamped.so"
    cu.write_text(src)
    res = subprocess.run([_kernels._nvcc(), *flags, "-I", str(src_path.parent), "-shared",
                          "-o", str(so), str(cu)], capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"dense_solve_stamps: nvcc failed:\n{res.stdout}\n{res.stderr}")
    print("ptxas (stamped): " + " | ".join(
        line.strip() for line in (res.stdout + res.stderr).splitlines()
        if "cholesky" in line or "registers" in line), flush=True)
    return so


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--sizes", default="904,1540,2564,5404")
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    repo = Path(args.repo).resolve()
    so = build(repo)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("dense_solve_stamps: no card")
    import chip_smoke as cs
    from sfm_tpu_torch import _kernels
    from sfm_tpu_torch.ba import schur

    lib = ctypes.CDLL(str(so))
    names = [k for k in _kernels.SIGNATURES if "cholesky" in k]
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _kernels.SIGNATURES[name], ctypes.c_int
    lib.sfm_chol_set_stamps.argtypes, lib.sfm_chol_set_stamps.restype = [ctypes.c_void_p], \
        ctypes.c_int
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream
    for name in names:
        if name.endswith("_setup"):
            rc = getattr(lib, name)(stream())
            assert rc == 0, (name, rc)

    def launch(kernel, device, *a):
        c_args = [x.data_ptr() if isinstance(x, torch.Tensor) else x for x in a]
        rc = getattr(lib, f"sfm_{kernel}")(*c_args, stream())
        if rc != 0:
            raise RuntimeError(f"{kernel}: CUDA error {rc}")

    lib.sfm_chol_probe_cluster_coop.argtypes = [ctypes.c_void_p]
    lib.sfm_chol_probe_cluster_coop.restype = ctypes.c_int
    rc = lib.sfm_chol_probe_cluster_coop(stream())
    print(f"cooperative + cluster (2) launch: {'taken' if rc == 0 else f'refused, CUDA error {rc}'}",
          flush=True)
    torch.cuda.synchronize()
    real_launch = _kernels.launch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; checkout {repo}", flush=True)
    rows = {}
    for dname in args.dtypes.split(","):
        dt = getattr(torch, dname)
        for n in (int(s) for s in args.sizes.split(",")):
            S, rc_, rk_ = cs.synthetic_spd(torch, np, dev, n, dt, n)
            K = -(-n // 32)
            G = min(sms, n + 1)
            buf = torch.zeros(G * K * 8 + 4 * G, dtype=torch.int64, device=dev)
            assert lib.sfm_chol_set_stamps(buf.data_ptr()) == 0
            plain_dev = cs.device_ms(torch, lambda: schur.dense_solve_cuda(S.clone(), rc_, rk_),
                                     name="cholesky")
            _kernels.launch = launch
            try:
                x_ref = schur.dense_solve_cuda(S.clone(), rc_, rk_)
                stamped_dev = cs.device_ms(torch, lambda: schur.dense_solve_cuda(S.clone(), rc_,
                                                                                 rk_),
                                           name="cholesky")
                buf.zero_()
                x_st = schur.dense_solve_cuda(S.clone(), rc_, rk_)
                torch.cuda.synchronize()
            finally:
                _kernels.launch = real_launch
            same = all(torch.equal(a, b) for a, b in zip(x_ref, x_st))
            st = buf.cpu().numpy()
            per = st[:G * K * 8].reshape(G, K, 8).astype(np.float64)
            extra = dict(zip(EXTRA, st[G * K * 8:].reshape(G, 4).max(axis=0).astype(np.float64)))
            ghz = extra["kernel_cycles"] / max(extra["kernel_ns"], 1.0)
            us = lambda cyc: float(cyc) / ghz / 1e3
            mean = {s: us(per[:, :, i].sum(axis=1).mean()) for i, s in enumerate(SLOTS)}
            most = {s: us(per[:, :, i].sum(axis=1).max()) for i, s in enumerate(SLOTS)}
            row = dict(n=n, dtype=dname, panels=K, blocks=G, ghz=ghz,
                       device_ms=plain_dev, stamped_device_ms=stamped_dev,
                       stamped_same_bits=same, kernel_us=us(extra["kernel_cycles"]),
                       backsub_wait_us=us(extra["backsub_wait"]),
                       backsub_us=us(extra["backsub"]), mean_us=mean, max_us=most)
            rows[f"{dname}_{n}"] = row
            print(f"{dname} n = {n} ({K} panels, {G} blocks, {ghz:.3f} GHz): device "
                  f"{plain_dev:.4f} ms ({stamped_dev:.4f} stamped, same bits {same}); stamped "
                  f"kernel {row['kernel_us']:.1f} us; back-substitution {row['backsub_us']:.1f} "
                  f"us (its barrier {row['backsub_wait_us']:.1f})", flush=True)
            print("  us over the panels, mean over blocks / largest block: " + ", ".join(
                f"{s} {mean[s]:.1f} / {most[s]:.1f}" for s in SLOTS), flush=True)
            del S, buf
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
