"""Build, load and launch the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled at first use by ``nvcc`` for
``sm_90a`` -- one ``nvcc -c`` per source, all started together -- and the
objects are linked into one shared library with a plain C interface, which
is loaded with ``ctypes``. The library is keyed by a hash of the sources
and flags, so an edited kernel is rebuilt and a stale one never loads. The
build directory (``sfm_tpu_torch/_build``) is listed in ``.gitignore``.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0 and only
then adds one to the kernel's launch count. Tensors are checked by the
callers (:func:`check_tensor`) before any pointer is taken.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
# C signature of each kernel entry point (all return int = cudaError_t);
# the last argument is always the cudaStream_t.
SIGNATURES = {
    "sfm_match_top2": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "sfm_match_epilogue": [_P] * 5 + [_I] * 3 + [_F, _P] + [_P],
    "sfm_match_compact": [_P] * 3 + [_I] * 4 + [_P] * 4 + [_P],
    "sfm_fmat_score_select": [_P, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P],
    "sfm_dog_extrema": [_P, _I, _I, _I, _I, _F, _P, _P],
    "sfm_sift_describe": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                          _I, _P, _F, _F, _P, _P, _P],
    "sfm_ba_linearize": [_P] * 17 + [_I] * 7 + [_F, _I] + [_P] * 13 + [_P],
    "sfm_ba_cost": [_P] * 8 + [_I, _F, _P, _P] + [_P],
    "sfm_schur_coupling": [_P] * 15 + [_I] * 5 + [_P] * 5 + [_P],
    "sfm_triangulate_tracks": [_P] * 9 + [_I] * 3 + [_F, _F] + [_I] * 4 + [_P, _P] + [_P],
    "sfm_reproj_stats": [_P] * 9 + [_I] * 3 + [_P, _P] + [_P],
    "sfm_p3p_solve": [_P, _P, _I, _P, _P, _P] + [_P],
    "sfm_pnp_score_select": [_P] * 7 + [_I] * 3 + [_F] + [_P] * 3 + [_P],
    "sfm_retrieval_score": [_P] * 3 + [_I] * 4 + [_F, _P] + [_P],
    "sfm_guided_match": [_P] * 5 + [_I] * 3 + [_F] + [_P] * 3 + [_P],
    "sfm_build_pyramid": [_P] + [_I] * 6 + [_P] * 5 + [_P],
    "sfm_seed_score": [_P] * 5 + [_I] * 2 + [_P] * 5 + [_P],
    "sfm_pnp_refine": [_P] * 7 + [_I, _I, _F, _P, _I] + [_P] * 7 + [_P],
    "sfm_schur_damp": [_P] * 12 + [_I] * 6 + [_F] + [_P] * 9 + [_P],
    "sfm_schur_back_substitute": [_P] * 11 + [_I] * 3 + [_P] + [_P],
    "sfm_fmat_hypotheses": [_P] * 3 + [_I] * 3 + [_P] + [_P],
    "sfm_fmat_refit_verify": [_P] * 5 + [_I] * 3 + [_F, _I, _F, _F, _F] + [_P] * 10 + [_P],
    "sfm_dog_select": [_P] + [_I] * 5 + [_P] * 10 + [_P],
    "sfm_dog_refine": [_P] + [_I] * 4 + [_P] * 4 + [_I] + [_F] * 3 + [_P] * 4 + [_P],
    "sfm_topk_rows": [_P] + [_I] * 3 + [_P] * 2 + [_P],
    "sfm_relpose": [_P] * 3 + [_I] * 3 + [_P] * 3 + [_P],
    "sfm_rotation_average": [_P] * 4 + [_I] * 4 + [_P] * 5 + [_P],
    "sfm_translation_average": [_P] * 4 + [_I] * 5 + [_P] * 5 + [_P],
    "sfm_orb_fast_nms": [_P, _P] + [_I] * 3 + [_F, _P] + [_P],
    "sfm_orb_blur": [_P] + [_I] * 3 + [_P, _I, _P, _P] + [_P],
    "sfm_orb_describe": [_P] + [_I] * 3 + [_P] * 3 + [_I, _P, _F, _P, _P] + [_P],
    "sfm_schur_block_jacobi": [_P] * 4 + [_I] + [_P] * 2 + [_P],
    "sfm_schur_matvec": [_P] * 14 + [_I] * 5 + [_P] * 6 + [_P],
    "sfm_pcg_init": [_P] * 3 + [_I] * 2 + [_F] + [_P] * 5 + [_P],
    "sfm_pcg_step": [_P] * 3 + [_I] * 2 + [_F] + [_P] * 5 + [_P],
    "sfm_pnp_dlt_solve": [_P] * 5 + [_I] * 4 + [_P] * 2 + [_P],
}
KERNELS = ("match_top2", "fmat_score_select", "dog_extrema", "sift_describe",
           "ba_linearize", "ba_cost", "schur_coupling", "triangulate_tracks",
           "reproj_stats", "p3p_solve", "pnp_score_select", "retrieval_score",
           "guided_match", "build_pyramid", "seed_score", "pnp_refine", "schur_damp",
           "schur_back_substitute", "fmat_hypotheses", "fmat_refit_verify", "dog_select",
           "dog_refine", "topk_rows", "match_epilogue", "match_compact", "relpose",
           "rotation_average", "translation_average", "orb_fast_nms", "orb_blur",
           "orb_describe", "schur_block_jacobi", "schur_matvec", "pcg_init", "pcg_step",
           "pnp_dlt_solve")
# The BA island's other routes (ba/schur.py::variant): per-camera intrinsics
# (B = 10), the f64 island, and both. Each entry of K8-K11 has one C entry
# point a route, the same arguments as the default one's but for the ones
# noted in SIGNATURES.
ROUTES = ("b10", "f64", "b10_f64")
_ROUTE_SIGNATURES = {
    "ba_linearize": SIGNATURES["sfm_ba_linearize"][:-1] + [_P, _P, _P],  # + U_extra, g_c_extra
    "schur_coupling": SIGNATURES["sfm_schur_coupling"],
    "schur_damp": [_P] * 12 + [_I] * 6 + [_D] + [_P] * 9 + [_P],         # lam a double
    "schur_back_substitute": SIGNATURES["sfm_schur_back_substitute"],
    "schur_block_jacobi": SIGNATURES["sfm_schur_block_jacobi"],
    "schur_matvec": SIGNATURES["sfm_schur_matvec"][:-1] + [_P, _P],       # + U_extra
    "pcg_init": [_P] * 3 + [_I] * 2 + [_D] + [_P] * 5 + [_P],             # tol a double
    "pcg_step": [_P] * 3 + [_I] * 2 + [_D] + [_P] * 5 + [_P],
}
for _route in ROUTES:
    for _name, _sig in _ROUTE_SIGNATURES.items():
        SIGNATURES[f"sfm_{_name}_{_route}"] = _sig
    KERNELS += tuple(f"{_name}_{_route}" for _name in _ROUTE_SIGNATURES)
# The cost at each camera's own intrinsics (the B = 10 routes).
SIGNATURES["sfm_ba_cost_b10"] = SIGNATURES["sfm_ba_cost"]
KERNELS += ("ba_cost_b10",)

# Called once, on the first launch, on that device's stream: per-function
# attributes (the opt-in shared memory of K10's staged walk, K4's topk_rows
# and K1's resident rows).
SETUP = ("sfm_schur_damp_setup", "sfm_topk_setup", "sfm_match_setup")
SIGNATURES.update({name: [_P] for name in SETUP})

_launches = {k: 0 for k in KERNELS}
_lib = None
_setup_done = False
_entries: dict = {}   # kernel -> its ctypes entry point
build_info: dict = {}


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_counts():
    for k in _launches:
        _launches[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def load_library():
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    so = BUILD_DIR / f"libsfm_kernels_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(src.name, p.returncode, log)
                  for src, p, log in zip(sources, procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{log}" for name, rc, log in failed))
        (BUILD_DIR / "ptxas.log").write_text("".join(logs))
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        res = subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                              "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n"
                               f"{res.stderr}")
        for obj in objs:
            obj.unlink()
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.sfm_error_string.argtypes = [ctypes.c_int]
    lib.sfm_error_string.restype = ctypes.c_char_p
    build_info["seconds"] = time.perf_counter() - t0
    build_info["library"] = str(so)
    _lib = lib
    return lib


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if (isinstance(t, torch.Tensor) and t.dtype == dtype and t.shape == tuple(shape)
            and t.device == device and t.is_contiguous()):
        return
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index``, as its raw handle."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(index) if raw is not None else torch.cuda.current_stream(index).cuda_stream


def launch(kernel: str, device: torch.device, *args):
    """Call ``sfm_<kernel>`` on ``device``'s current stream; raise on a CUDA error.

    Tensor arguments are passed as their data pointers and must stay alive
    for the call (they are referenced by ``args``). The device is made
    current only when it is not already (the host work of a launch is most
    of a small kernel's time).
    """
    global _setup_done
    lib = load_library()
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    index = torch.cuda.current_device() if device.index is None else device.index
    switch = torch.cuda.current_device() != index
    with torch.cuda.device(index) if switch else contextlib.nullcontext():
        stream = _raw_stream(index)
        if not _setup_done:
            for name in SETUP:
                rc = getattr(lib, name)(stream)
                if rc != 0:
                    raise RuntimeError(
                        f"{name}: CUDA error {rc} ({lib.sfm_error_string(rc).decode()})")
            _setup_done = True
        fn = _entries.get(kernel)
        if fn is None:
            fn = _entries[kernel] = getattr(lib, f"sfm_{kernel}")
        rc = fn(*c_args, stream)
    if rc != 0:
        raise RuntimeError(
            f"{kernel}: CUDA error {rc} ({lib.sfm_error_string(rc).decode()})")
    _launches[kernel] += 1
