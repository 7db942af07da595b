"""The port's stages end to end, held against the JAX package.

Renders the 8-view textured corridor of ``tests/test_pixel_pipeline.py``, runs
``python -m sfm_tpu_torch preprocess`` on the CPU (plain twins), compares the
accepted pairs with ``sfm_tpu``'s ImageMatcher on the same pixels, and then
runs ``sfm_tpu``'s reconstruct stage and the port's own on the port's
``pair_table.pkl`` (also with ``{"pnp": {"sample_size": 6}}``, the DLT
branch of PnP), and the port's whole ``pipeline`` under the default config
with retrieval on, under the pixel pipeline's quality gates (8/8
cameras, > 200 points, < 0.6 px, GT rotation median < 1 deg, ATE < 5%).
"""
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

from torch_parity import REPO, render_scene

from sfm_tpu.config import BAConfig, FeatureConfig, SfMConfig, TriangulationConfig

N_IMAGES = 8
# Same frontend and sweep settings as the reference run; a smaller detection
# batch only bounds the CPU working set.
PORT_CONFIG = SfMConfig(features=FeatureConfig(detect_batch=2))
# tests/test_pixel_pipeline.py's reconstruct settings.
RECON_CONFIG = SfMConfig(
    ba=BAConfig(max_iterations=12, cg_iters=30, optimize_intrinsics=False, prune_multiplier=3.0),
    triangulation=TriangulationConfig(cadence=2),
)
PORT_RECON_CONFIG = RECON_CONFIG.replace(features=FeatureConfig(detect_batch=2))


def assert_pixel_gates(s):
    assert s["num_cameras"] == N_IMAGES, s["num_cameras"]
    assert s["num_points"] > 200, s["num_points"]
    assert s["mean_reprojection_error"] < 0.6, s["mean_reprojection_error"]
    assert s["gt_rot_err_deg_median"] < 1.0, s["gt_rot_err_deg_median"]
    assert s["gt_ate_rel"] < 0.05, s["gt_ate_rel"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return render_scene(tmp_path_factory.mktemp("slice") / "scene", N_IMAGES)


@pytest.fixture(scope="module")
def port_out(scene, tmp_path_factory):
    from sfm_tpu_torch import cli

    out = tmp_path_factory.mktemp("port_preprocess")
    cfg = out / "port_config.json"
    PORT_CONFIG.to_json(cfg)
    rc = cli.main(["--log_dir", str(out / "logs"), "preprocess", "--data_dir", str(scene),
                   "--output_dir", str(out), "--device", "cpu", "--no_mask",
                   "--config", str(cfg)])
    assert rc == 0
    return out


def _borderline(table, p, gate_inliers=15, gate_ratio=0.3):
    """JAX's inlier count lies within 2 of the count or ratio gate."""
    n_inl, n_m = int(table.num_inliers[p]), int(table.num_matches[p])
    return abs(n_inl - gate_inliers) <= 2 or abs(n_inl - gate_ratio * n_m) <= 2


def test_port_accepts_the_pairs_jax_accepts(scene, port_out, tmp_path):
    from sfm_tpu.matching.api import ImageMatcher

    ref = ImageMatcher(scene, SfMConfig(), output_dir=tmp_path).process_image_range(
        use_mask=False)
    blob = pickle.loads((port_out / "pair_table.pkl").read_bytes())
    got = blob["table"]
    np.testing.assert_array_equal(got.pairs, ref.pairs)
    differ = np.nonzero(got.accept != ref.accept)[0]
    unexplained = [tuple(ref.pairs[p]) for p in differ if not _borderline(ref, p)]
    assert not unexplained, f"accept differs away from the gates: {unexplained}"
    assert len(differ) <= 2, [tuple(ref.pairs[p]) for p in differ]
    assert ref.accept.sum() >= N_IMAGES - 1
    # The artifacts: numpy only, descriptors f16, one CSV row per accepted pair.
    assert blob["desc"].dtype == np.float16 and blob["desc"].shape[:2] == blob["valid"].shape
    assert all(isinstance(blob[k], np.ndarray) for k in ("xy", "valid", "desc"))
    assert (blob["valid"].sum(1) >= 500).all()
    rows = (port_out / "matching_results.csv").read_text().strip().splitlines()
    assert len(rows) == 1 + int(got.accept.sum())
    i, j = got.pairs[got.accepted()[0]]
    assert (port_out / "correspondences" / f"pair_{i}_{j}_pts1.npy").exists()
    assert (port_out / "fundamental" / f"pair_{i}_{j}_F.npz").exists()


def test_port_pair_table_unpickles_without_torch(port_out):
    # The reconstruct stage may run where torch is absent: the pickle must
    # need numpy and the port's source only. Block torch and read it back.
    code = (
        "import importlib.abc, pickle, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('torch', 'jax', 'sfm_tpu'):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "blob = pickle.loads(open(sys.argv[1], 'rb').read())\n"
        "t = blob['table']\n"
        "print(t.num_pairs, len(t.accepted()), len(t.to_records()))\n"
    )
    res = subprocess.run([sys.executable, "-c", code, str(port_out / "pair_table.pkl")],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    blob = pickle.loads((port_out / "pair_table.pkl").read_bytes())
    n_acc = len(blob["table"].accepted())
    assert res.stdout.split() == [str(blob["table"].num_pairs), str(n_acc), str(n_acc)]


@pytest.fixture(scope="module")
def jax_result(scene, port_out):
    """``sfm_tpu``'s reconstruct stage on the port's ``pair_table.pkl``."""
    from sfm_tpu.pipeline import PipelineArgs, SfMPipeline

    args = PipelineArgs(data_dir=str(scene), output_dir=str(port_out), use_mask=False,
                        num_images=N_IMAGES, export_colmap=False, export_meshlab=False)
    pipe = SfMPipeline(args, RECON_CONFIG)
    assert pipe.run_reconstruction()
    return pipe.result


def test_jax_reconstruct_consumes_port_artifacts(jax_result):
    assert_pixel_gates(jax_result.stats)


def test_port_reconstruct_on_port_artifacts(scene, port_out, jax_result, tmp_path):
    import json

    from sfm_tpu_torch import cli

    shutil.copy(port_out / "pair_table.pkl", tmp_path / "pair_table.pkl")
    PORT_RECON_CONFIG.to_json(tmp_path / "cfg.json")
    rc = cli.main(["--log_dir", str(tmp_path / "logs"), "reconstruct", "--data_dir", str(scene),
                   "--output_dir", str(tmp_path), "--device", "cpu", "--no_mask",
                   "--num_images", str(N_IMAGES), "--config", str(tmp_path / "cfg.json")])
    assert rc == 0
    s = json.loads((tmp_path / "reconstruction" / "stats.json").read_text())
    assert_pixel_gates(s)
    # The same seed pair (the first two registered images) and camera count.
    poses = json.loads((tmp_path / "reconstruction" / "poses.json").read_text())
    seed = [int(name.split(".")[0]) for name in list(poses)[:2]]
    assert seed == [int(i) for i in jax_result.image_ids[:2]]
    assert s["num_cameras"] == jax_result.stats["num_cameras"]
    for f in ("cameras.txt", "images.txt", "points3D.txt"):
        assert (tmp_path / "exports" / "colmap" / f).exists()


def test_dlt_pnp_reconstruct_through_both_packages(scene, port_out, tmp_path):
    # reconstruct with {"pnp": {"sample_size": 6}}, the DLT branch of PnP,
    # on the port's pair table through both packages (default config
    # otherwise): the same seed pair and camera count, and a model each.
    import json

    from sfm_tpu.pipeline import PipelineArgs, SfMPipeline
    from sfm_tpu_torch import cli

    cfg = {"pnp": {"sample_size": 6}}
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    for d in (jdir, pdir):
        d.mkdir()
        shutil.copy(port_out / "pair_table.pkl", d / "pair_table.pkl")
    pipe = SfMPipeline(PipelineArgs(data_dir=str(scene), output_dir=str(jdir), use_mask=False,
                                    num_images=N_IMAGES, export_colmap=False,
                                    export_meshlab=False), SfMConfig.from_dict(cfg))
    assert pipe.run_reconstruction()
    rc = cli.main(["--log_dir", str(pdir / "logs"), "reconstruct", "--data_dir", str(scene),
                   "--output_dir", str(pdir), "--device", "cpu", "--no_mask",
                   "--num_images", str(N_IMAGES), "--config", json.dumps(cfg)])
    assert rc == 0
    s = json.loads((pdir / "reconstruction" / "stats.json").read_text())
    poses = json.loads((pdir / "reconstruction" / "poses.json").read_text())
    seed = [int(name.split(".")[0]) for name in list(poses)[:2]]
    assert seed == [int(i) for i in pipe.result.image_ids[:2]]
    assert s["num_cameras"] == pipe.result.stats["num_cameras"] >= N_IMAGES - 1
    assert s["num_points"] > 200 and s["mean_reprojection_error"] < 0.6


def test_port_pipeline_end_to_end(scene, tmp_path):
    # `python -m sfm_tpu_torch pipeline` with no --config and retrieval on.
    import json

    from sfm_tpu.config import RetrievalConfig, effective_retrieval_config
    from sfm_tpu.matching.retrieval import retrieval_scores, select_candidate_pairs
    from sfm_tpu_torch import cli
    from sfm_tpu_torch.matching import retrieval as tret

    out = tmp_path / "out"
    rc = cli.main(["--log_dir", str(tmp_path / "logs"), "pipeline", "--data_dir", str(scene),
                   "--output_dir", str(out), "--device", "cpu", "--no_mask",
                   "--num_images", str(N_IMAGES), "--match_mode", "on"])
    assert rc == 0
    assert_pixel_gates(json.loads((out / "reconstruction" / "stats.json").read_text()))
    assert (out / "exports" / "colmap" / "images.txt").exists()
    metrics = {r["name"] for r in json.loads((out / "metrics.json").read_text())}
    assert {"stage/detect", "stage/retrieval", "stage/sweep"} <= metrics
    # The swept pairs are the ones JAX's retrieval keeps on the port's
    # descriptors, and both packages score them alike (the pickle holds the
    # descriptors in f16; both score its f32 cast).
    blob = pickle.loads((out / "pair_table.pkl").read_bytes())
    desc = blob["desc"].astype(np.float32)
    cfg = effective_retrieval_config(SfMConfig(retrieval=RetrievalConfig(mode="on")))
    kept, _ = select_candidate_pairs(desc, blob["valid"], N_IMAGES, cfg)
    np.testing.assert_array_equal(blob["table"].pairs, np.asarray(kept))
    pairs = blob["table"].pairs
    scores = tret.retrieval_scores(desc, blob["valid"], pairs, cfg)
    np.testing.assert_array_equal(scores, retrieval_scores(desc, blob["valid"], pairs, cfg))
    assert scores.max() >= 20
