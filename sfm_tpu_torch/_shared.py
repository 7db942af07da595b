"""Host code shared with the JAX package, loaded by file path.

``sfm_tpu/__init__.py`` imports ``jax`` (compilation-cache setup), so
``import sfm_tpu.config`` would pull JAX into the port's process. The
numpy-only modules the port shares -- the config schema, the image/mask
decoders, the track builder and the ground-truth evaluator -- are
therefore executed straight from their files and registered under private
names. One ``--config`` JSON then means the same thing to both packages,
and one track builder and one GT evaluator serve both.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_JAX_PKG = Path(__file__).resolve().parents[1] / "sfm_tpu"


def _load(relpath: str, name: str):
    if name in sys.modules:
        return sys.modules[name]
    path = _JAX_PKG / relpath
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load shared module {path}")
    module = importlib.util.module_from_spec(spec)
    # Registered before exec: dataclasses resolves annotations through
    # sys.modules[cls.__module__].
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[name]
        raise
    return module


config = _load("config.py", "_sfm_shared_config")
images = _load("io/images.py", "_sfm_shared_images")
tracks = _load("reconstruction/tracks.py", "_sfm_shared_tracks")
calib = _load("io/calib.py", "_sfm_shared_calib")

SfMConfig = config.SfMConfig
FeatureConfig = config.FeatureConfig
MatchConfig = config.MatchConfig
VerifyConfig = config.VerifyConfig
RetrievalConfig = config.RetrievalConfig
CameraConfig = config.CameraConfig
PnPConfig = config.PnPConfig
BAConfig = config.BAConfig
SelectConfig = config.SelectConfig
effective_match_config = config.effective_match_config
effective_retrieval_config = config.effective_retrieval_config
effective_guided_ratio = config.effective_guided_ratio

load_image_gray_u8 = images.load_image_gray_u8
load_mask = images.load_mask

TrackTable = tracks.TrackTable
build_tracks = tracks.build_tracks

evaluate_result_against_gt = calib.evaluate_result_against_gt
