"""The port's package boundary: no JAX, one config schema, explicit device."""
import json
import subprocess
import sys

import pytest
import torch

from torch_parity import REPO

from sfm_tpu.config import FeatureConfig, MatchConfig, SfMConfig, VerifyConfig

SLICE_MODULES = [
    "sfm_tpu_torch",
    "sfm_tpu_torch.config",
    "sfm_tpu_torch.io.images",
    "sfm_tpu_torch.io.calib",
    "sfm_tpu_torch.reconstruction.tracks",
    "sfm_tpu_torch.render_scene",
    "sfm_tpu_torch._kernels",
    "sfm_tpu_torch.device",
    "sfm_tpu_torch.utils.linalg",
    "sfm_tpu_torch.utils.observability",
    "sfm_tpu_torch.geometry.epipolar",
    "sfm_tpu_torch.estimators.ransac",
    "sfm_tpu_torch.estimators.fundamental",
    "sfm_tpu_torch.matching.core",
    "sfm_tpu_torch.matching.verify",
    "sfm_tpu_torch.matching.pair_table",
    "sfm_tpu_torch.matching.sweep",
    "sfm_tpu_torch.matching.retrieval",
    "sfm_tpu_torch.matching.api",
    "sfm_tpu_torch.features.pyramid",
    "sfm_tpu_torch.features.detect",
    "sfm_tpu_torch.features.descriptor",
    "sfm_tpu_torch.features.frontend",
    "sfm_tpu_torch.geometry.rotations",
    "sfm_tpu_torch.geometry.projection",
    "sfm_tpu_torch.geometry.triangulation",
    "sfm_tpu_torch.estimators.pnp",
    "sfm_tpu_torch.ba.problem",
    "sfm_tpu_torch.ba.residuals",
    "sfm_tpu_torch.ba.schur",
    "sfm_tpu_torch.ba.lm",
    "sfm_tpu_torch.graph.view_selection",
    "sfm_tpu_torch.reconstruction.seed",
    "sfm_tpu_torch.reconstruction.global_init",
    "sfm_tpu_torch.reconstruction.incremental",
    "sfm_tpu_torch.io.export",
    "sfm_tpu_torch.pipeline",
    "sfm_tpu_torch.cli",
    "sfm_tpu_torch.profile_stage",
]


def test_port_imports_neither_jax_nor_sfm_tpu():
    # By name, and by file: a module run from a file of the JAX package or of
    # scripts/ under another name (a loader by path) counts as well.
    code = (
        "import importlib, json, sys\n"
        "from pathlib import Path\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "repo = Path.cwd().resolve()\n"
        "ref = [repo / 'sfm_tpu', repo / 'scripts']\n"
        "names = sorted(k for k in sys.modules\n"
        "    if k.split('.')[0] in ('jax', 'jaxlib', 'sfm_tpu'))\n"
        "files = sorted(k for k, m in list(sys.modules.items())\n"
        "    if getattr(m, '__file__', None)\n"
        "    and any(d in Path(m.__file__).resolve().parents for d in ref))\n"
        "print(json.dumps([names, files]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == [[], []]


def test_port_renderer_runs_without_jax_sfm_tpu_or_torch(tmp_path):
    # chip_smoke renders through the port's renderer in a subprocess; it
    # needs numpy and the port's config, nothing of JAX, sfm_tpu or torch.
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('torch', 'jax', 'sfm_tpu'):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "from sfm_tpu_torch.render_scene import render_dataset\n"
        "out = render_dataset(sys.argv[1], 2, supersample=1, log=print)\n"
        "print(sorted(p.name for p in (out / 'images').iterdir()))\n"
    )
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path / "scene")], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "['0000.pgm', '0001.pgm']"
    assert len(list((tmp_path / "scene" / "calib").glob("*.txt"))) == 2


def test_config_json_round_trips_between_packages(tmp_path):
    from sfm_tpu_torch.config import SfMConfig as PortConfig
    from sfm_tpu_torch.config import effective_match_config

    cfg = SfMConfig(features=FeatureConfig(max_keypoints=1024, kind="orb"),
                    matching=MatchConfig(max_matches=512),
                    verify=VerifyConfig(ransac_iters=256), seed=7)
    path = tmp_path / "cfg.json"
    cfg.to_json(path)
    port = PortConfig.from_json(path)
    assert port.to_dict() == cfg.to_dict()
    assert SfMConfig.from_json(port.to_json()) == cfg
    assert effective_match_config(port).ratio_threshold == pytest.approx(0.75 ** 0.5)


def test_retrieval_switch_matches_jax():
    from sfm_tpu.config import RetrievalConfig
    from sfm_tpu.matching.retrieval import retrieval_enabled as j_enabled
    from sfm_tpu_torch.matching.retrieval import retrieval_enabled as t_enabled

    for mode in ("off", "on", "auto", "sequential"):
        for n in (10, 149, 150, 400):
            rc = RetrievalConfig(mode=mode)
            assert t_enabled(rc, n) == j_enabled(rc, n)


def test_cuda_device_is_explicit(tmp_path):
    from sfm_tpu_torch import cli
    from sfm_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    (tmp_path / "images").mkdir()
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--log_dir", str(tmp_path / "logs"), "preprocess",
                  "--data_dir", str(tmp_path), "--device", "cuda"])


def test_library_entry_points_name_their_device(tmp_path):
    # Only the CLI holds a default (cuda); a library caller that leaves the
    # device out gets an error, not a silent run of the plain twins on the CPU.
    from sfm_tpu_torch.features.frontend import detect_and_describe, detect_and_describe_batch
    from sfm_tpu_torch.matching.api import ImageMatcher
    from sfm_tpu_torch.pipeline import PipelineArgs

    img = torch.zeros((64, 64), dtype=torch.uint8).numpy()
    for call in (lambda: PipelineArgs(data_dir=str(tmp_path)),
                 lambda: ImageMatcher(tmp_path),
                 lambda: detect_and_describe(img),
                 lambda: detect_and_describe_batch(img[None])):
        with pytest.raises(TypeError, match="device"):
            call()


def test_tf32_is_off():
    import sfm_tpu_torch.device  # noqa: F401

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_wrappers_refuse_other_devices():
    # A wrapper runs its plain twin only on a CPU tensor; anything that is
    # neither CPU nor CUDA is refused, never silently computed elsewhere.
    from sfm_tpu_torch.features.detect import dog_extrema_scores
    from sfm_tpu_torch.matching.core import match_top2

    meta = torch.empty((1, 5, 16, 16), device="meta")
    with pytest.raises(ValueError, match="device"):
        dog_extrema_scores(meta, 0.006, 10.0)
    d = torch.empty((1, 8, 32), device="meta")
    v = torch.empty((1, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="device"):
        match_top2(d, v, d, v)


def test_trace_summary_counts_overlapping_device_work_once(tmp_path):
    from sfm_tpu_torch.profile_stage import trace_summary

    ev = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    trace = {"traceEvents": [
        ev("Trace", "profiler", 0, 100),
        ev("user_annotation", "detect", 0, 60),
        ev("user_annotation", "sweep", 60, 40),
        ev("kernel", "k_a", 10, 20), ev("kernel", "k_b", 20, 20),   # overlap: 10..40
        ev("gpu_memcpy", "Memcpy DtoH", 70, 10),
        ev("cpu_op", "aten::add", 5, 50),
        {"ph": "i", "name": "marker", "ts": 3},
    ]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    s = trace_summary(path)
    assert s["kernels"] == 2
    assert s["window"]["device_busy_s"] == pytest.approx(40e-6)
    assert s["window"]["idle_share"] == pytest.approx(0.6)
    assert s["detect"]["idle_share"] == pytest.approx(0.5)
    assert s["sweep"]["idle_share"] == pytest.approx(0.75)
    assert [r[0] for r in s["by_name"]] == ["k_a", "k_b", "gpu_memcpy"]


def test_trace_summary_sums_repeated_spans(tmp_path):
    from sfm_tpu_torch.profile_stage import SPANS, trace_summary

    ev = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    trace = {"traceEvents": [
        ev("user_annotation", "sfm/ba", 0, 40), ev("user_annotation", "sfm/pnp", 40, 20),
        ev("user_annotation", "sfm/ba", 60, 40),
        ev("kernel", "ba_obs_kernel", 10, 10), ev("kernel", "ba_obs_kernel", 70, 30),
    ]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    s = trace_summary(path, SPANS["reconstruct"])
    assert s["sfm/ba"]["calls"] == 2
    assert s["sfm/ba"]["span_s"] == pytest.approx(80e-6)
    assert s["sfm/ba"]["idle_share"] == pytest.approx(0.5)
    assert s["sfm/pnp"]["idle_share"] == pytest.approx(1.0)
    assert s["by_name"][0][:2] == ["ba_obs_kernel", 2]


def test_trace_summary_attributes_kernels_to_the_outermost_operator(tmp_path):
    from sfm_tpu_torch.profile_stage import trace_summary

    def ev(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0,
                "tid": tid, "args": args}

    trace = {"traceEvents": [
        ev("cpu_op", "aten::block_diag", 0, 50), ev("cpu_op", "aten::copy_", 5, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 6, 1, correlation=1),
        ev("cpu_op", "aten::copy_", 20, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 21, 1, correlation=2),
        ev("cpu_op", "aten::mm", 60, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 61, 1, correlation=3),
        ev("cuda_runtime", "cudaLaunchKernel", 80, 1, correlation=4),   # no operator
        ev("kernel", "elementwise", 100, 4, tid=7, correlation=1),
        ev("kernel", "elementwise", 110, 4, tid=7, correlation=2),
        ev("kernel", "gemm", 120, 8, tid=7, correlation=3),
        ev("kernel", "sfm_kernel", 130, 2, tid=7, correlation=4),
    ]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    by_op = {r[0]: r[1:] for r in trace_summary(path)["by_op"]}
    assert by_op["aten::block_diag"] == [2, pytest.approx(0.008)]
    assert by_op["aten::mm"][0] == 1 and by_op["(no operator)"][0] == 1
