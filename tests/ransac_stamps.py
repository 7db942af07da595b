"""Where K2's F-RANSAC and K6's ``pnp_refine`` spend their time: ``clock64``
stamps of each kernel's phases, and ``ptxas``'s registers and spills, on a
card.

    python tests/ransac_stamps.py [--repo CHECKOUT] [--out F.json]

Builds the checkout's ``csrc/fmat_ransac.cu``, ``csrc/fmat_solve.cu`` and
``csrc/pnp_refine.cu`` once more, each into a library of its own (under the
checkout's ``sfm_tpu_torch/_build/stamps``), with probes inserted at known
lines of its text (the script stops if a line is missing): a probe adds the
cycles since the last one to a slot of the block (thread 0's clock; the
hypothesis kernels: every thread's own), and the kernel's end writes its
cycles beside its ``%globaltimer`` nanoseconds, which give the clock. The
checkout's wrappers then run through those libraries (``_kernels.launch``
redirected) at path d's shapes: a 32-pair sweep chunk of 1,024 rows, 512
hypotheses scored on the first 256 rows (``chip_smoke.two_view_batch``), and
``pnp_refine`` at 8 candidates x 2,048 rows (``chip_smoke.pnp_scene``, as
``phase_pnp_refine`` starts it). Each entry is also timed through the real
library: the wrapper (``chip_smoke.median_ms``) and the device (one
``torch.profiler`` trace). Printed for each entry: the times, the clock, and
each slot in microseconds, the mean over the blocks (or threads) and the
largest. The unstamped sources are compiled once more with ``-Xptxas -v`` for
each entry's registers, stack, spills and shared memory.

Two designs are known: the first (three K2 entries, one block a candidate in
``pnp_refine``) and the redesign (one fused K2 entry, ``fmat_ransac``, and
``pnp_refine`` over a cluster a candidate); the script picks the anchors by
the source's text.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

NS = 20            # slots a block (or thread); the last two: globaltimer ns, cycles
PRELUDE = r"""
#ifndef SFM_ST_PRELUDE
#define SFM_ST_PRELUDE
__device__ unsigned long long* g_stamps;
#define SFM_ST_NS 20
#define SFM_ST_INIT(idx, on)                                                        \
  const bool _st_on = (on);                                                         \
  const size_t _st_i = (size_t)(idx) * SFM_ST_NS;                                   \
  long long _st_t = clock64();                                                      \
  const long long _st_t0 = _st_t;                                                   \
  unsigned long long _st_g0;                                                        \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(_st_g0));
#define SFM_ST(slot)                                                                \
  {                                                                                 \
    const long long _st_n = clock64();                                              \
    if (_st_on) g_stamps[_st_i + (slot)] += (unsigned long long)(_st_n - _st_t);    \
    _st_t = clock64();                                                              \
  }
#define SFM_ST_SKIP _st_t = clock64();
#define SFM_ST_END                                                                  \
  if (_st_on) {                                                                     \
    unsigned long long _st_g1;                                                      \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(_st_g1));                      \
    g_stamps[_st_i + 18] += _st_g1 - _st_g0;                                        \
    g_stamps[_st_i + 19] += (unsigned long long)(clock64() - _st_t0);               \
  }
#endif
"""
SETTER = r"""
SFM_API int sfm_st_set(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)));
}
"""

# ---- the first design's probes: (anchor, text before it, text after it) a file.
FIRST = {
    "fmat_ransac.cu": [
        ("  extern __shared__ float sm[];\n", "", "  SFM_ST_INIT(blockIdx.x, threadIdx.x == 0)\n"),
        ("    sv[n] = valid[o] != 0;\n  }\n  __syncthreads();\n", "", "  SFM_ST(0)\n"),
        ("  best = sfm_block_best<NT>(best);\n", "  SFM_ST(1)\n", "  SFM_ST(2)\n"),
        ("    count_out[b] = best.count;\n  }\n", "", "  SFM_ST_END\n"),
    ],
    "fmat_solve.cu": [
        ("  if (g >= BH) return;\n", "", "  SFM_ST_INIT(g, true)\n"),
        ("    p[3][k] = pts2[(base + j) * 2 + 1];\n  }\n", "", "  SFM_ST(0)\n"),
        ("  float A[45];\n#pragma unroll\n  for (int e = 0; e < 45; ++e) A[e] = 0.f;\n",
         "  SFM_ST(1)\n", ""),
        ("  float tr = 0.f;\n#pragma unroll\n  for (int i = 0; i < 9; ++i) tr += A[sfm_pk(i, i)];\n"
         "  sfm_cholesky_clamped<9>(A, 1e-6f * (tr / 9.f) + 1e-20f, A);\n",
         "  SFM_ST(2)\n", "  SFM_ST(3)\n"),
        ("  sfm_inverse_iterate<9>(A, 3, f);\n", "", "  SFM_ST(4)\n"),
        ("  for (int k = 0; k < 9; ++k) Fs[(size_t)g * 9 + k] = F[k];\n}\n",
         "", ""),   # replaced below: the store's probe goes before the closing brace
        ("  const int b = blockIdx.x;\n  const size_t row0 = (size_t)b * N;\n", "",
         "  SFM_ST_INIT(blockIdx.x, threadIdx.x == 0)\n"),
        ("  sfm_block_sum<NT, 1>(&n_valid, reinterpret_cast<float(*)[1]>(&red[0][0]));\n",
         "  SFM_ST(0)\n", "  SFM_ST(1)\n"),
        ("  sfm_eight_point_block<NT>(sp[0], sp[1], sp[2], sp[3], sw, N, red, sF);\n", "",
         "  SFM_ST_SKIP\n"),
        ("  sfm_block_sum<NT, 6>(acc2, reinterpret_cast<float(*)[6]>(&red[0][0]));\n",
         "  SFM_ST(10)\n", "  SFM_ST(11)\n"),
        ("  sfm_block_sum<NT, 4>(var, reinterpret_cast<float(*)[4]>(&red[0][0]));\n",
         "  SFM_ST(12)\n", "  SFM_ST(13)\n"),
        ("    out.accept[b] = ok && n_inl >= min_inliers && ratio >= min_ratio && mean_err <= "
         "max_err &&\n                    spread;\n  }\n", "", "  SFM_ST(14)\n  SFM_ST_END\n"),
    ],
    "sfm_geom.cuh": [
        ("  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // sum w, w x1, w y1, w x2, w y2\n",
         "  SFM_ST_INIT(blockIdx.x, threadIdx.x == 0)\n", ""),
        ("  sfm_block_sum<NT, 5>(acc, reinterpret_cast<float(*)[5]>(&red[0][0]));\n",
         "  SFM_ST(2)\n", "  SFM_ST(3)\n"),
        ("  sfm_block_sum<NT, 2>(md, reinterpret_cast<float(*)[2]>(&red[0][0]));\n",
         "  SFM_ST(4)\n", "  SFM_ST(5)\n"),
        ("  sfm_block_sum<NT, 45>(A, red);\n", "  SFM_ST(6)\n", "  SFM_ST(7)\n"),
        ("    sfm_denormalize(f, t1, t2, F);\n  }\n  __syncthreads();\n}\n",
         "", ""),   # replaced below
    ],
    "pnp_refine.cu": [
        ("  for (int it = 0; it < iters; ++it) {\n    float R[9], dR[3][9];\n",
         "  SFM_ST_INIT(blockIdx.x, threadIdx.x == 0)\n", ""),
        ("    sfm_rodrigues_d(params, R, dR);\n", "", "    SFM_ST(1)\n"),
        ("    sfm_block_sum<NT, 27>(acc, red);\n", "    SFM_ST(2)\n", "    SFM_ST(3)\n"),
        ("      for (int k = 0; k < 6; ++k) params[k] -= delta[k];\n    }\n    __syncthreads();\n",
         "", ""),   # replaced below
        ("  __shared__ int s_count;\n  const int b = blockIdx.x;\n", "",
         "  SFM_ST_INIT(blockIdx.x, threadIdx.x == 0)\n"),
        ("    ok_out[b] = s_count >= min_inliers[b] && finite;\n  }\n", "",
         "  SFM_ST(7)\n  SFM_ST_END\n"),
    ],
}
# Anchors whose probe goes inside them.
FIRST_REPLACE = {
    "fmat_solve.cu": [("  for (int k = 0; k < 9; ++k) Fs[(size_t)g * 9 + k] = F[k];\n}\n",
                       "  for (int k = 0; k < 9; ++k) Fs[(size_t)g * 9 + k] = F[k];\n"
                       "  SFM_ST(5)\n  SFM_ST_END\n}\n")],
    "sfm_geom.cuh": [("    sfm_denormalize(f, t1, t2, F);\n  }\n  __syncthreads();\n}\n",
                      "    sfm_denormalize(f, t1, t2, F);\n  }\n  SFM_ST(8)\n  __syncthreads();\n"
                      "  SFM_ST(9)\n}\n")],
    "pnp_refine.cu": [("      for (int k = 0; k < 6; ++k) params[k] -= delta[k];\n    }\n"
                       "    __syncthreads();\n",
                       "      for (int k = 0; k < 6; ++k) params[k] -= delta[k];\n    }\n"
                       "    SFM_ST(4)\n    __syncthreads();\n    SFM_ST(5)\n"),
                      ("  set_weights(rows, R, t, k4, thr, ok0[b] != 0, w);  // ends in a barrier\n"
                       "  refine(rows, w, k4, iters, params, red);\n",
                       "  set_weights(rows, R, t, k4, thr, ok0[b] != 0, w);  // ends in a barrier\n"
                       "  SFM_ST(0)\n  refine(rows, w, k4, iters, params, red);\n  SFM_ST_SKIP\n"),
                      ("  set_weights(rows, R, t, k4, thr, true, w);\n"
                       "  refine(rows, w, k4, iters, params, red);\n",
                       "  set_weights(rows, R, t, k4, thr, true, w);\n"
                       "  SFM_ST(6)\n  refine(rows, w, k4, iters, params, red);\n  SFM_ST_SKIP\n")],
}
# Slot names of each stamped kernel (the first design).
FIRST_SLOTS = {
    "fmat_score_select": ("staging", "walk (thread 0's hypotheses)",
                          "selection (the block's best, with the wait for the walk)"),
    "fmat_hypotheses": ("gather", "normalize", "A^T A", "factor", "3 inverse iterations",
                        "denormalize and store"),
    "fmat_refit_verify": ("rows: load, consensus", "sum of 1", "rows of 5", "sum of 5",
                          "rows of 2 (sqrt)", "sum of 2", "design rows (45)", "xor trees of 45",
                          "thread 0: factor, 8 iterations, rank 2, denormalize",
                          "barrier after thread 0", "final rows (errors, inliers)", "sum of 6",
                          "variance rows", "sum of 4", "gates and stores"),
    "pnp_refine": ("first weights (rvec, rows, barrier)", "a step: rodrigues",
                   "a step: the rows' terms (thread 0's rows)",
                   "a step: the block sum of 27 (with its two barriers)",
                   "a step: thread 0's 6x6 solve", "a step: the closing barrier",
                   "second weights", "final errors, count, outputs"),
}
# The profiler's name of each entry's kernel (its device time without the
# wrapper's other launches).
KERNEL_NAMES = {"fmat_ransac": "fmat_ransac_kernel"}
FILES = {"fmat_score_select": "fmat_ransac.cu", "fmat_hypotheses": "fmat_solve.cu",
         "fmat_refit_verify": "fmat_solve.cu", "pnp_refine": "pnp_refine.cu"}


def insert(text: str, probes, replace, name: str) -> str:
    for anchor, before, after in probes:
        if text.count(anchor) != 1:
            raise SystemExit(f"ransac_stamps: {name}: anchor found {text.count(anchor)} times:\n"
                             f"{anchor}")
        if before or after:
            text = text.replace(anchor, before + anchor + after)
    for anchor, new in replace:
        if text.count(anchor) != 1:
            raise SystemExit(f"ransac_stamps: {name}: anchor found {text.count(anchor)} times:\n"
                             f"{anchor}")
        text = text.replace(anchor, new)
    return text


def ptxas_report(nvcc, flags, csrc: Path, files, work: Path) -> list:
    """Registers, stack, spills and shared memory of each entry of ``files``
    (the unstamped sources)."""
    lines = []
    for f in files:
        res = subprocess.run([nvcc, *flags, "-cubin", "-o", str(work / (f + ".cubin")),
                              str(csrc / f)], capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f"ransac_stamps: nvcc {f} failed:\n{res.stdout}\n{res.stderr}")
        entry = None
        for line in (res.stdout + res.stderr).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = re.sub(r"^_ZN\w*?_GLOBAL__N__\w+?_\d+_\w+?_cu_\w+?\d+", "", m.group(1))
                continue
            if entry and ("registers" in line or "stack frame" in line):
                lines.append(f"{f} {entry[:60]}: {line.split('ptxas info    : ')[-1].strip()}")
    return lines


def build(repo: Path, work: Path):
    sys.path.insert(0, str(repo))
    from sfm_tpu_torch import _kernels

    csrc = repo / "sfm_tpu_torch" / "csrc"
    work.mkdir(parents=True, exist_ok=True)
    for h in csrc.glob("*.cuh"):
        shutil.copy(h, work / h.name)
    redesign = "fmat_ransac_kernel" in (csrc / "fmat_ransac.cu").read_text()
    probes, replace = (REDESIGN, REDESIGN_REPLACE) if redesign else (FIRST, FIRST_REPLACE)
    geom = work / "sfm_geom.cuh"
    geom.write_text(insert(geom.read_text(), probes.get("sfm_geom.cuh", []),
                           replace.get("sfm_geom.cuh", []), "sfm_geom.cuh"))
    flags = [f for f in _kernels.NVCC_FLAGS]
    libs = {}
    for f in ("fmat_ransac.cu", "fmat_solve.cu", "pnp_refine.cu"):
        if not (csrc / f).exists():   # the redesign has no fmat_solve.cu
            continue
        text = PRELUDE + insert((csrc / f).read_text(), probes.get(f, []), replace.get(f, []),
                                f) + SETTER
        cu, so = work / f"stamped_{f}", work / f"libstamped_{Path(f).stem}.so"
        cu.write_text(text)
        res = subprocess.run([_kernels._nvcc(), *flags, "-shared", "-o", str(so), str(cu)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f"ransac_stamps: nvcc {f} failed:\n{res.stdout}\n{res.stderr}")
        libs[f] = so
    files = [f for f in ("fmat_ransac.cu", "fmat_solve.cu", "pnp_refine.cu")
             if (csrc / f).exists()]
    report = ptxas_report(_kernels._nvcc(), flags, csrc, files, work)
    return libs, report, redesign


# ---- the redesign's probes: fmat_ransac's block (blockIdx.y * tiles +
# blockIdx.x; the refit's slots in the pair's last tile only) and
# pnp_refine's blocks, thread 0 each.
_BLK = "blockIdx.y * gridDim.x + blockIdx.x"
REDESIGN = {
    "fmat_ransac.cu": [
        ("  const int tile = blockIdx.x, T = gridDim.x, b = blockIdx.y;\n", "",
         f"  SFM_ST_INIT({_BLK}, threadIdx.x == 0)\n"),
        ("  __syncthreads();\n  ns = s_ns;\n", "", "  SFM_ST(0)\n"),
        ("    hypothesis(sp, idx + g_h * 8, N, F);\n", "", "    SFM_ST(1)\n"),
        ("  const size_t row0 = (size_t)b * N;\n  float n_valid = 0.f;\n", "",
         f"  SFM_ST_INIT({_BLK}, threadIdx.x == 0)\n"),
        ("  sfm_block_sum<NT, 1>(&n_valid, reinterpret_cast<float(*)[1]>(&red[0][0]));\n", "",
         "  SFM_ST(7)\n"),
        ("  eight_point(sp, sw, N, red, sA, sF);\n", "", "  SFM_ST_SKIP\n"),
        ("  sfm_block_sum<NT, 6>(acc2, reinterpret_cast<float(*)[6]>(&red[0][0]));\n", "",
         "  SFM_ST(16)\n"),
        ("  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // sum w, w x1, w y1, w x2, w y2\n",
         f"  SFM_ST_INIT({_BLK}, threadIdx.x == 0)\n", ""),
        ("  sfm_block_sum<NT, 5>(acc, reinterpret_cast<float(*)[5]>(&red[0][0]));\n",
         "  SFM_ST(8)\n", "  SFM_ST(9)\n"),
        ("  sfm_block_sum<NT, 2>(md, reinterpret_cast<float(*)[2]>(&red[0][0]));\n",
         "  SFM_ST(10)\n", "  SFM_ST(11)\n"),
        ("  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;\n#pragma unroll\n"
         "  for (int m = 0; m < 45; ++m)\n", "  SFM_ST(12)\n", ""),
    ],
    "pnp_refine.cu": [
        ("  const int K = (rows.n + 31) / 32;   // rows a virtual thread\n", "",
         "  SFM_ST_INIT(blockIdx.x, threadIdx.x == 0)\n"),
        ("    const float t[3] = {params[3], params[4], params[5]};\n    float acc[27];\n", "",
         "    SFM_ST(1)\n"),
        ("    if (warp == 0) tree<0, MH>(cluster, acc, lane, s.all[parity]);\n", "    SFM_ST(4)\n",
         ""),
        ("      __syncwarp();\n      float delta[6];\n", "      SFM_ST(9)\n", ""),
        ("  cg::cluster_group cluster = cg::this_cluster();\n", "",
         "  SFM_ST_INIT(blockIdx.x, threadIdx.x == 0)\n"),
    ],
}
REDESIGN_REPLACE = {
    "fmat_ransac.cu": [
        ("  __syncthreads();\n\n  // The walk: thread (j, q)",
         "  __syncthreads();\n  SFM_ST(2)\n\n  // The walk: thread (j, q)"),
        ("    __syncthreads();\n    if (q == 0 && h < H) {\n      for (int u = 0; u < CH",
         "    SFM_ST(3)\n    __syncthreads();\n    if (q == 0 && h < H) {\n      for (int u = 0; u < CH"),
        ("          err_sum += err;\n        }\n      }\n    }\n  }\n  SfmCand best",
         "          err_sum += err;\n        }\n      }\n    }\n    SFM_ST(4)\n  }\n  SfmCand best"),
        ("  __syncthreads();\n  if (!s_last) return;\n",
         "  __syncthreads();\n  SFM_ST(5)\n  if (!s_last) {\n    SFM_ST_END\n    return;\n  }\n"),
        ("  refit_verify(b, N, Fb, sp, sw, sv, red, sA, sF, g, out);\n}\n",
         "  SFM_ST(6)\n  refit_verify(b, N, Fb, sp, sw, sv, red, sA, sF, g, out);\n  SFM_ST_SKIP\n"
         "  SFM_ST_END\n}\n"),
        ("                    mean_err <= g.max_err && spread;\n  }\n}\n",
         "                    mean_err <= g.max_err && spread;\n  }\n  SFM_ST(17)\n}\n"),
        ("  __syncthreads();\n  if (warp == 0) {\n    for (int m = lane; m < 45; m += 32) {",
         "  __syncthreads();\n  SFM_ST(13)\n  if (warp == 0) {\n    for (int m = lane; m < 45; m += 32) {"),
        ("      for (int k = 0; k < 9; ++k) F[k] = Fw[k];\n  }\n  __syncthreads();\n}\n",
         "      for (int k = 0; k < 9; ++k) F[k] = Fw[k];\n  }\n  SFM_ST(14)\n  __syncthreads();\n"
         "  SFM_ST(15)\n}\n"),
    ],
    "pnp_refine.cu": [
        ("      if (c == 0) s.has[kk][l] = has;\n      __syncthreads();\n",
         "      if (c == 0) s.has[kk][l] = has;\n      SFM_ST(2)\n      __syncthreads();\n"
         "      SFM_ST(3)\n"),
        ("    cluster.sync();\n    if (warp == 0) {\n      if (lane < 27) {",
         "    SFM_ST(5)\n    cluster.sync();\n    SFM_ST(6)\n    if (warp == 0) {\n      if (lane < 27) {"),
        ("      __syncwarp();\n      rotation_warp(params, lane, s);   // the next step's (the last "
         "step's unused)\n    }\n    parity ^= 1;\n    __syncthreads();\n",
         "      SFM_ST(7)\n      __syncwarp();\n      rotation_warp(params, lane, s);\n    }\n"
         "    SFM_ST(12)\n    parity ^= 1;\n    __syncthreads();\n    SFM_ST(8)\n"),
        ("  set_weights(rows, R, t, k4, thr, ok0[b] != 0, w);  // ends in a barrier\n"
         "  refine(cluster, rows, w, k4, iters, parity, params, st);\n",
         "  set_weights(rows, R, t, k4, thr, ok0[b] != 0, w);  // ends in a barrier\n"
         "  SFM_ST(0)\n  refine(cluster, rows, w, k4, iters, parity, params, st);\n  SFM_ST_SKIP\n"),
        ("  set_weights(rows, R, t, k4, thr, true, w);\n"
         "  refine(cluster, rows, w, k4, iters, parity, params, st);\n",
         "  set_weights(rows, R, t, k4, thr, true, w);\n"
         "  SFM_ST(10)\n  refine(cluster, rows, w, k4, iters, parity, params, st);\n  SFM_ST_SKIP\n"),
        ("  cluster.sync();   // no block leaves while block 0 reads its count\n}\n",
         "  SFM_ST(11)\n  cluster.sync();   // no block leaves while block 0 reads its count\n"
         "  SFM_ST_END\n}\n"),
    ],
}
REDESIGN_SLOTS = {
    "fmat_ransac": ("staging", "hypothesis solve (thread 0's)", "store F, fence, barrier",
                    "walk: thread 0's errors (8 a chunk)", "walk: barrier, thread 0's ordered adds",
                    "tile's best and ticket", "last tile: the winner and its F",
                    "refit: consensus rows, sum of 1", "rows of 5", "sum of 5", "rows of 2 (sqrt)",
                    "sum of 2", "design rows (45)", "xor trees of 45",
                    "warp 0: sums of 45, factor, 8 iterations, rank 2, denormalize",
                    "barrier after warp 0",
                    "final rows, sum of 6", "variance rows, sum of 4, gates"),
    "pnp_refine": ("first weights (staging, rvec, rows, barrier)", "a step: R and dR from shared",
                   "a step: thread 0's half row (its lane pair's row)",
                   "a step: barrier after the terms",
                   "a step: warp 0's ordered adds (terms 0-13), barrier",
                   "a step: xor tree, stores to the 8 blocks", "a step: cluster barrier",
                   "a step: warp 0's 6x6 solve",
                   "a step: closing barrier", "a step: the 8 blocks' sums in order",
                   "second weights", "final errors, count, outputs",
                   "a step: warp 0's rodrigues for the next step"),
}
REDESIGN_FILES = {"fmat_ransac": "fmat_ransac.cu", "pnp_refine": "pnp_refine.cu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    repo = Path(args.repo).resolve()
    libs, report, redesign = build(repo, repo / "sfm_tpu_torch" / "_build" / "stamps")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ransac_stamps: no card")
    import chip_smoke as cs
    from sfm_tpu_torch import _kernels
    from sfm_tpu_torch.estimators import fundamental as fm
    from sfm_tpu_torch.estimators import pnp
    from sfm_tpu_torch.estimators.ransac import ransac_sample_indices
    from sfm_tpu_torch.geometry.rotations import rodrigues

    smi = cs.card_line()
    print(f"card: {smi}; checkout {repo}", flush=True)
    for line in report:
        print("ptxas " + line, flush=True)
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream
    loaded = {f: ctypes.CDLL(str(so)) for f, so in libs.items()}
    for lib in loaded.values():
        lib.sfm_st_set.argtypes, lib.sfm_st_set.restype = [ctypes.c_void_p], ctypes.c_int
        for name in _kernels.SETUP:   # the stamped kernels' own opt-in shared memory
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
                assert fn(stream()) == 0, name
    slots = REDESIGN_SLOTS if redesign else FIRST_SLOTS
    files = REDESIGN_FILES if redesign else FILES

    def stamped_launch(kernel, device, *a):
        lib = loaded[files[kernel]]
        fn = getattr(lib, f"sfm_{kernel}")
        fn.argtypes, fn.restype = _kernels.SIGNATURES[f"sfm_{kernel}"], ctypes.c_int
        rc = fn(*[x.data_ptr() if isinstance(x, torch.Tensor) else x for x in a], stream())
        if rc != 0:
            raise RuntimeError(f"{kernel}: CUDA error {rc}")

    # Path d's shapes.
    B, M, H, NS_, thr = 32, 1024, 512, 256, 3.0
    p1, p2, valid = (torch.as_tensor(x, device=dev) for x in cs.two_view_batch(np, B, M)[:3])
    g = torch.Generator(device=dev).manual_seed(2)
    idx = ransac_sample_indices(valid, H, 8, g, prefix=True).contiguous()
    k2 = {}
    if redesign:
        k2["fmat_ransac"] = lambda: fm.estimate_fundamental_ransac(
            p1, p2, valid, threshold=thr, score_budget=NS_, indices=idx)
    else:
        Fs = fm.fmat_hypotheses_cuda(p1, p2, idx)
        sc = (p1[:, :NS_].contiguous(), p2[:, :NS_].contiguous(), valid[:, :NS_].contiguous())
        best = fm.fmat_score_select_cuda(Fs, *sc, thr)[0].contiguous()
        k2["fmat_hypotheses"] = lambda: fm.fmat_hypotheses_cuda(p1, p2, idx)
        k2["fmat_score_select"] = lambda: fm.fmat_score_select_cuda(Fs, *sc, thr)
        k2["fmat_refit_verify"] = lambda: fm.fmat_refit_verify_cuda(Fs, best, p1, p2, valid, thr)
    Bp, Np = 8, 2048
    p3, q2, pv, K, R, t, rng = cs.pnp_scene(torch, np, dev, Bp, Np, seed=10 + Bp)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    R0 = (rodrigues(f32(rng.normal(0, 0.006, (Bp, 3)))) @ R).contiguous()
    t0 = (t * f32(1 + rng.normal(0, 0.01, (Bp, 3)))).contiguous()
    ok0 = torch.ones(Bp, dtype=torch.bool, device=dev)
    k6 = {"pnp_refine": lambda: pnp.pnp_refine_cuda(R0, t0, ok0, p3, q2, pv, K, 8.0,
                                                    torch.full((Bp,), 15, device=dev), 10)}
    rows = {}
    for name, fn in {**k2, **k6}.items():
        wrapper = cs.median_ms(torch, fn)
        device = cs.device_ms(torch, fn)
        kernel = cs.device_ms(torch, fn, name=KERNEL_NAMES.get(name, name))
        real = _kernels.launch
        n_idx = B * H if name == "fmat_hypotheses" else max(B, 4 * B)
        buf = torch.zeros(n_idx * NS, dtype=torch.int64, device=dev)
        for lib in loaded.values():
            assert lib.sfm_st_set(buf.data_ptr()) == 0
        _kernels.launch = stamped_launch
        try:
            stamped_dev = cs.device_ms(torch, fn)
            buf.zero_()
            fn()
            torch.cuda.synchronize()
        finally:
            _kernels.launch = real
        st = buf.cpu().numpy().reshape(n_idx, NS).astype(np.float64)
        used = st[:, 19] > 0
        st = st[used]
        ghz = float(st[:, 19].sum() / max(st[:, 18].sum(), 1.0))
        us = lambda c: float(c) / ghz / 1e3
        names = slots[name]
        mean = {s: us(st[:, i][st[:, i] > 0].mean()) if (st[:, i] > 0).any() else 0.0
                for i, s in enumerate(names)}
        most = {s: us(st[:, i].max()) for i, s in enumerate(names)}
        rows[name] = dict(wrapper_ms=wrapper, device_ms=device, kernel_ms=kernel,
                          stamped_device_ms=stamped_dev,
                          ghz=ghz, stamped_units=int(used.sum()),
                          kernel_us_mean=us(st[:, 19].mean()), kernel_us_max=us(st[:, 19].max()),
                          mean_us=mean, max_us=most)
        print(f"{name}: wrapper {wrapper:.4f} ms, device {cs.fmt_ms(device)}, the kernel alone "
              f"{cs.fmt_ms(kernel)} (stamped "
              f"{cs.fmt_ms(stamped_dev)}); {int(used.sum())} stamped blocks/threads at "
              f"{ghz:.3f} GHz, their kernel time {us(st[:, 19].mean()):.1f} us mean, "
              f"{us(st[:, 19].max()):.1f} largest", flush=True)
        print("  us, mean / largest: " + "; ".join(f"{s} {mean[s]:.2f} / {most[s]:.2f}"
                                                  for s in names), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi, "ptxas": report, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
