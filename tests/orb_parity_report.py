"""Measurements behind the binary frontend's stated settings and tolerances.

    python tests/orb_parity_report.py [--skip_pipelines]

On the CPU, against the JAX package (not collected by pytest). Renders the
8-view corridor of ``tests/test_torch_slice.py`` into a temporary directory
and prints:

1. the FAST corners the port keeps at level 0 of view 0 at
   ``fast_threshold`` 20 (the default) and 5;
2. how many of the u8 (u16) values the compiled reference's ``/ 255.0``
   (``/ 65535.0``) puts off the float32 quotient, and on how many the
   port's ``_normalize_image(..., reciprocal=True)`` equals it;
3. the share of the compiled JAX detector's keypoints on view 0 that the
   port finds, normalizing u8 by the quotient and by the reciprocal;
4. ``jax.image.resize`` against the port's ``resize_linear`` and against
   ``F.interpolate(antialias=True)`` at the main path's level shapes;
5. unless ``--skip_pipelines``: both packages' ``pipeline`` with
   ``--feature_kind orb`` at ``fast_threshold`` 5 on the 8 views (cameras,
   points, px, GT rotation median, ATE).
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_parity import render_scene  # noqa: E402

from sfm_tpu.config import FeatureConfig as JFeatureConfig  # noqa: E402
from sfm_tpu.features import detect_and_describe as jdetect  # noqa: E402
from sfm_tpu_torch.config import FeatureConfig, SfMConfig  # noqa: E402
from sfm_tpu_torch.features import binary as tbin  # noqa: E402
from sfm_tpu_torch.features.frontend import _normalize_image  # noqa: E402
from sfm_tpu_torch.io.images import load_image_gray_u8  # noqa: E402

THRESHOLD = 5.0
VIEWS = 8


def keypoint_set(xy, sigma, valid):
    return {(round(float(x), 2), round(float(y), 2), round(float(s), 3))
            for (x, y), s, v in zip(np.asarray(xy), np.asarray(sigma), np.asarray(valid)) if v}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip_pipelines", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    work = Path(tempfile.mkdtemp(prefix="orb_report_"))
    scene = work / "scene"
    render_scene(scene, VIEWS)
    u8 = load_image_gray_u8(scene / "images" / "0000.pgm")

    # 1. level-0 corners of view 0
    img = torch.as_tensor(u8)[None].to(torch.float32) / 255.0
    for thr in (20.0, THRESHOLD):
        kept = int((tbin.fast_nms(img, thr / 255.0) > 0).sum())
        print(f"view 0 level 0: {kept} FAST corners kept at fast_threshold {thr:g}")

    # 2. the compiled reference's normalization
    for dtype, scale in ((np.uint8, 255.0), (np.uint16, 65535.0)):
        u = np.arange(int(np.iinfo(dtype).max) + 1, dtype=dtype)
        compiled = np.asarray(jax.jit(lambda x: x.astype(jnp.float32) / scale)(u))
        off = int((compiled != u.astype(np.float32) / np.float32(scale)).sum())
        port = _normalize_image(torch.as_tensor(u.astype(np.int32)).to(
            getattr(torch, np.dtype(dtype).name)), reciprocal=True).numpy()
        print(f"{np.dtype(dtype).name} / {scale:g} compiled: {off} of {len(u)} values off "
              f"the f32 quotient; the port's normalization equals it on "
              f"{int((port == compiled).sum())}")

    # 3. the compiled detector's keypoints found by the port
    ref = jdetect(u8, config=JFeatureConfig(kind="orb", fast_threshold=THRESHOLD))
    want = keypoint_set(ref.xy, ref.sigma, ref.valid)
    cfg = FeatureConfig(kind="orb", fast_threshold=THRESHOLD)
    u8_t = torch.as_tensor(u8)[None]
    for what, image in (("quotient", _normalize_image(u8_t)),
                        ("reciprocal", _normalize_image(u8_t, reciprocal=True))):
        f = tbin.detect_orb(image, None, cfg)
        got = keypoint_set(f["xy"][0], f["sigma"][0], f["valid"][0])
        print(f"view 0 at fast_threshold {THRESHOLD:g}, u8 normalized by the {what}: "
              f"{len(want & got)} of {len(want)} of the compiled reference's keypoints "
              f"({len(want & got) / len(want):.4f})")

    # 4. the level resize
    rnd = np.random.default_rng(2).random((768, 1024), dtype=np.float32)
    for lvl in (1, 2):
        hl, wl = tbin.level_shape(768, 1024, lvl, 1.35)
        ref_l = np.asarray(jax.image.resize(jnp.asarray(rnd), (hl, wl), "linear"))
        port = tbin.resize_linear(torch.as_tensor(rnd)[None], hl, wl)[0].numpy()
        interp = F.interpolate(torch.as_tensor(rnd)[None, None], (hl, wl), mode="bilinear",
                               antialias=True)[0, 0].numpy()
        print(f"resize 768x1024 -> {hl}x{wl}: port max |diff| {np.abs(port - ref_l).max():.3g}, "
              f"F.interpolate(antialias) {np.abs(interp - ref_l).max():.3g}")

    if args.skip_pipelines:
        return 0
    # 5. both packages' ORB pipeline on the rendered views
    from sfm_tpu.config import SfMConfig as JSfMConfig
    from sfm_tpu.pipeline import PipelineArgs, SfMPipeline
    from sfm_tpu_torch import cli

    jpipe = SfMPipeline(PipelineArgs(data_dir=str(scene), output_dir=str(work / "jax"),
                                     use_mask=False, num_images=VIEWS, export_colmap=False,
                                     export_meshlab=False),
                        JSfMConfig(features=JFeatureConfig(kind="orb",
                                                           fast_threshold=THRESHOLD)))
    assert jpipe.run_preprocessing() and jpipe.run_reconstruction()
    SfMConfig(features=FeatureConfig(detect_batch=2, fast_threshold=THRESHOLD)).to_json(
        work / "cfg.json")
    assert cli.main(["--log_dir", str(work / "logs"), "--log_level", "WARNING", "pipeline",
                     "--data_dir", str(scene), "--output_dir", str(work / "port"), "--device",
                     "cpu", "--no_mask", "--num_images", str(VIEWS), "--feature_kind", "orb",
                     "--config", str(work / "cfg.json")]) == 0
    port = json.loads((work / "port" / "reconstruction" / "stats.json").read_text())
    for name, st in (("JAX", jpipe.result.stats), ("port", port)):
        print(f"{name} pipeline --feature_kind orb, {VIEWS} views, fast_threshold "
              f"{THRESHOLD:g}: {st['num_cameras']} cameras, {st['num_points']} points, "
              f"{st['mean_reprojection_error']:.4f} px, GT rotation median "
              f"{st['gt_rot_err_deg_median']:.4f} deg, ATE {100 * st['gt_ate_rel']:.3f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
