"""Variants of K5's ``sift_describe`` and K1-r's ``retrieval_score`` timed
against the checkout's kernels on a card, in one process, with their outputs
held to the checkout's bit for bit.

    python tests/describe_variants.py [--repo CHECKOUT] [--scene DIR] [--rounds 2]

Each variant is the checkout's ``csrc/sift_describe.cu`` or
``csrc/retrieval_score.cu`` with one exact text substitution (the script
stops if a substitution's text is missing), built by ``nvcc`` into a library
of its own under the checkout's ``sfm_tpu_torch/_build/variants``:

- ``sift_describe_warps_{1,3,4}``: that many keypoints (warps) a block, in
  place of two;
- ``sift_describe_float_taps``: each tap's half difference on its own,
  through float (the first design's ``half_grad``), in place of two at a
  time in ``half2``;
- ``retrieval_score_col_bitmask``: a pair's column validity read once into a
  thread's bitmask, in place of a byte load a column tile.

The checkout's wrappers then run through each library (``_kernels.launch``
swapped) at path d's launch shapes: K5 on the smoke's 12-image detection
batch (the first 12 of ``--scene``'s 36 rendered views, rendered there first
where it holds none), K1-r on ``phase_retrieval_score``'s chunk (1,024
pairs, S = 256, D = 128), its tie-heavy table and S = 100. Printed for each
round (the order reversed every other round): each candidate's device time a
call (``bits_report``'s ``stream_ms``) and whether its outputs equal the
checkout's.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

TAPS_HALF2 = """\
  // (low, high) = the taps at rows r and r + 1, columns c, then c + 1.
  const __half2 gx0 = half_grad2(__halves2half2(b2, c2), __halves2half2(b0, c0));
  const __half2 gx1 = half_grad2(__halves2half2(b3, c3), __halves2half2(b1, c1));
  const __half2 gy0 = half_grad2(__halves2half2(c1, d1), __halves2half2(a1, b1));
  const __half2 gy1 = half_grad2(__halves2half2(c2, d2), __halves2half2(a2, b2));
  vx = sfm_lerp_rn(sfm_lerp_rn(__low2float(gx0), __high2float(gx0), fy),
                   sfm_lerp_rn(__low2float(gx1), __high2float(gx1), fy), fx);
  vy = sfm_lerp_rn(sfm_lerp_rn(__low2float(gy0), __high2float(gy0), fy),
                   sfm_lerp_rn(__low2float(gy1), __high2float(gy1), fy), fx);
"""
TAPS_FLOAT = """\
  const auto g = [](__half hi, __half lo) {
    const __half d = __float2half(__half2float(hi) - __half2float(lo));
    return __half2float(__float2half(0.5f * __half2float(d)));
  };
  vx = sfm_lerp_rn(sfm_lerp_rn(g(b2, b0), g(c2, c0), fy), sfm_lerp_rn(g(b3, b1), g(c3, c1), fy),
                   fx);
  vy = sfm_lerp_rn(sfm_lerp_rn(g(c1, a1), g(d1, b1), fy), sfm_lerp_rn(g(c2, a2), g(d2, b2), fy),
                   fx);
"""
MASK_DECL = ("  Top2 top[8];\n  bool row_ok[8];\n  float acc[8][8];\n",
             "  Top2 top[8];\n  bool row_ok[8];\n  float acc[8][8];\n  unsigned int colmask = 0;\n")
MASK_FILL = ("    if (st == 0) {\n#pragma unroll\n      for (int i = 0; i < 8; ++i) {\n",
             "    if (st == 0) {\n"
             "      const uint8_t* vbu = valid + (size_t)__ldg(pairs + 2 * p + 1) * S;\n"
             "      colmask = 0;\n"
             "      for (int ct = 0; ct * RC < S; ++ct)\n"
             "#pragma unroll\n"
             "        for (int j = 0; j < 8; ++j) {\n"
             "          const int gc = ct * RC + tx + 16 * j;\n"
             "          colmask |= (gc < S && vbu[gc] != 0 ? 1u : 0u) << (ct * 8 + j);\n"
             "        }\n"
             "#pragma unroll\n      for (int i = 0; i < 8; ++i) {\n")
MASK_USE = ("      const bool col_ok = gc < S && vb[gc] != 0;\n",
            "      const bool col_ok = (colmask >> ((st / nks) * 8 + j)) & 1u;\n")
MASK_DROP = ("    const uint8_t* vb = valid + (size_t)__ldg(pairs + 2 * p + 1) * S;\n", "")
WARPS = "constexpr int WARPS = 2;"

VARIANTS = {
    **{f"sift_describe_warps_{w}": ("sift_describe.cu", [(WARPS, f"constexpr int WARPS = {w};")])
       for w in (1, 3, 4)},
    "sift_describe_float_taps": ("sift_describe.cu", [(TAPS_HALF2, TAPS_FLOAT)]),
    "retrieval_score_col_bitmask": ("retrieval_score.cu",
                                    [MASK_DECL, MASK_FILL, MASK_USE, MASK_DROP]),
}


def variant_source(src: str, subs) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"describe_variants: substitution text found {src.count(old)} "
                             f"times, not once:\n{old}")
        src = src.replace(old, new)
    return src


def build(repo: Path, work: Path):
    """{variant: library} for every variant that builds (the others printed)."""
    from sfm_tpu_torch import _kernels

    csrc = repo / "sfm_tpu_torch" / "csrc"
    work.mkdir(parents=True, exist_ok=True)
    for h in csrc.glob("*.cuh"):
        (work / h.name).write_text(h.read_text())
    procs = {}
    for name, (file, subs) in VARIANTS.items():
        cu, so = work / f"{name}.cu", work / f"lib{name}.so"
        cu.write_text(variant_source((csrc / file).read_text(), subs))
        procs[name] = (so, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out = proc.communicate()[0]
        regs = [ln.split("ptxas info    : ")[-1] for ln in out.splitlines() if "registers" in ln]
        print(f"{name}: nvcc rc {proc.returncode}; {regs}", flush=True)
        if proc.returncode != 0:
            print(out[-3000:], flush=True)
            continue
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--scene", default=".chip_smoke/scene_36",
                    help="the smoke's 36 rendered views (rendered there if missing)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("describe_variants: needs a card")
    import bits_report as br
    import chip_smoke as cs
    from sfm_tpu_torch import _kernels
    from sfm_tpu_torch.config import SfMConfig
    from sfm_tpu_torch.features.descriptor import orientation_and_descriptor_canvas_cuda
    from sfm_tpu_torch.features.frontend import select_keypoints
    from sfm_tpu_torch.matching.retrieval import score_chunk_cuda

    stream = lambda: torch.cuda.current_stream().cuda_stream
    libs = build(repo, repo / "sfm_tpu_torch" / "_build" / "variants")
    for lib in libs.values():
        for setup in ("sfm_sift_describe_setup", "sfm_retrieval_setup"):
            f = getattr(lib, setup, None)
            if f is not None:
                f.argtypes, f.restype = [ctypes.c_void_p], ctypes.c_int
                if f(stream()) != 0:
                    raise SystemExit(f"describe_variants: {setup} failed")

    fc = SfMConfig().features
    kw = dict(descriptor_scale=fc.descriptor_scale, clip=fc.descriptor_clip)
    images = br.smoke_images(torch, args.scene)
    k5_args = select_keypoints(images, None, fc)["describe"]
    dev = torch.device("cuda")
    desc, valid = cs.corridor_descriptors(torch, dev, 150, 256)
    pairs = [(k, k + d) for d in range(1, 8) for k in range(150 - d)] + [(0, 149), (3, 90)]
    pairs = torch.tensor(pairs, dtype=torch.int32, device=dev)
    t_desc, t_valid = cs.tie_heavy_table(torch, dev, 150, 256)
    s100 = (desc[:, :100].contiguous(), valid[:, :100].contiguous())
    families = {
        "sift_describe": [lambda: orientation_and_descriptor_canvas_cuda(*k5_args, **kw)],
        "retrieval_score": [lambda: score_chunk_cuda(pairs, desc, valid, 0.75),
                            lambda: score_chunk_cuda(pairs, t_desc, t_valid, 0.75),
                            lambda: score_chunk_cuda(pairs, *s100, 0.75)],
    }
    runner = br.Runner(torch, cs, None, None)
    real = _kernels.launch

    def through(lib):
        def launch(kernel, device, *a):
            fn = getattr(lib, f"sfm_{kernel}")
            fn.argtypes, fn.restype = _kernels.SIGNATURES[f"sfm_{kernel}"], ctypes.c_int
            rc = fn(*[x.data_ptr() if isinstance(x, torch.Tensor) else x for x in a], stream())
            if rc != 0:
                raise RuntimeError(f"sfm_{kernel} returned {rc}")
        return launch

    as_tuple = lambda o: o if isinstance(o, tuple) else (o,)
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    refs = {fam: [as_tuple(fn()) for fn in fns] for fam, fns in families.items()}
    torch.cuda.synchronize()
    print(f"{cs.card_line()}; K5 {tuple(k5_args[2].shape)} keypoints, K1-r "
          f"{pairs.shape[0]} pairs", flush=True)
    for rnd in range(args.rounds):
        for fam, fns in families.items():
            cands = [("checkout", None)] + [(k, v) for k, v in libs.items() if k.startswith(fam)]
            for name, lib in (cands if rnd % 2 == 0 else cands[::-1]):
                _kernels.launch = real if lib is None else through(lib)
                try:
                    outs = [as_tuple(fn()) for fn in fns]
                    torch.cuda.synchronize()
                    same = all(torch.equal(bits(a), bits(b)) for o, r in zip(outs, refs[fam])
                               for a, b in zip(o, r))
                    ms = [runner.stream_ms(fn) for fn in fns]
                finally:
                    _kernels.launch = real
                print(f"round {rnd} {fam} {name}: device " + " / ".join(f"{m:.4f}" for m in ms)
                      + f" ms a call; outputs {'identical' if same else 'DIFFER'}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
