"""The port's copies of the numpy-only host modules, held against the originals.

``sfm_tpu_torch`` keeps its own ``config.py``, ``io/images.py``,
``io/calib.py``, ``reconstruction/tracks.py`` and ``render_scene.py``, and
``features/binary.py`` its own BRIEF pattern and tables (the JAX package's
``import sfm_tpu`` imports ``jax``). These tests hold each copy
against the file it was copied from, on inputs made here from a numpy seed:
the same schema, the same arrays, the same bytes on disk.
"""
import dataclasses
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from torch_parity import SCRIPTS

import sfm_tpu.config as jcfg
import sfm_tpu.features.binary as jbinary
import sfm_tpu.io.calib as jcalib
import sfm_tpu.io.images as jimages
import sfm_tpu.reconstruction.tracks as jtracks
import sfm_tpu_torch.config as tcfg
import sfm_tpu_torch.features.binary as tbinary
import sfm_tpu_torch.io.calib as tcalib
import sfm_tpu_torch.io.images as timages
import sfm_tpu_torch.reconstruction.tracks as ttracks

CONFIG_CLASSES = sorted(name for name, obj in vars(jcfg).items()
                        if dataclasses.is_dataclass(obj) and obj.__module__ == jcfg.__name__)


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        default = f.default
        if f.default_factory is not dataclasses.MISSING:
            default = f.default_factory()
        out.append((f.name, str(f.type), default if not dataclasses.is_dataclass(default)
                    else dataclasses.asdict(default)))
    return out


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_dataclasses_match(name):
    assert hasattr(tcfg, name), name
    assert _fields(getattr(tcfg, name)) == _fields(getattr(jcfg, name))


def test_config_has_the_same_dataclasses():
    port = sorted(name for name, obj in vars(tcfg).items()
                  if dataclasses.is_dataclass(obj) and obj.__module__ == tcfg.__name__)
    assert port == CONFIG_CLASSES and len(port) >= 10


BINARY_CONSTANTS = ["_RING", "_STEER1", "_STEER2", "_IC_WX", "_IC_WY", "PATCH", "HALF",
                    "N_BITS", "N_ANGLE_BINS", "BORDER"]


@pytest.mark.parametrize("name", BINARY_CONSTANTS)
def test_binary_constants_match(name):
    # The binary frontend's copy of the reference's BRIEF pattern, steering
    # tables, FAST ring and moment weights: bit-identical.
    a, b = getattr(tbinary, name), getattr(jbinary, name)
    assert np.asarray(a).dtype == np.asarray(b).dtype
    np.testing.assert_array_equal(a, b)


def test_binary_pattern_matches():
    for a, b in zip(tbinary._make_pattern(), jbinary._make_pattern()):
        np.testing.assert_array_equal(a, b)


CONFIG_VARIANTS = [
    {},
    {"features": {"kind": "orb"}},
    {"features": {"kind": "orb"}, "matching": {"ratio_threshold": 0.8},
     "retrieval": {"ratio_threshold": 0.7}},
    {"pnp": {"guided_ratio": 0.85}, "retrieval": {"mode": "on", "top_k": 12}},
    {"matching": {"max_matches": 512}, "verify": {"ransac_iters": 256}, "seed": 3},
]


@pytest.mark.parametrize("variant", range(len(CONFIG_VARIANTS)))
def test_effective_configs_agree(variant):
    d = CONFIG_VARIANTS[variant]
    j, t = jcfg.SfMConfig.from_dict(d), tcfg.SfMConfig.from_dict(d)
    assert t.to_dict() == j.to_dict()
    assert (dataclasses.asdict(tcfg.effective_match_config(t))
            == dataclasses.asdict(jcfg.effective_match_config(j)))
    assert (dataclasses.asdict(tcfg.effective_retrieval_config(t))
            == dataclasses.asdict(jcfg.effective_retrieval_config(j)))
    assert tcfg.effective_guided_ratio(t) == jcfg.effective_guided_ratio(j)


def _random_pair_table(rng, N=7, K=40, M=24):
    """A pair table over N images of K keypoints: random inlier matches of
    the accepted pairs, some of them chaining into multi-view tracks and
    some inconsistent (two keypoints of one image in a track)."""
    pairs = np.array([(i, j) for i in range(N) for j in range(i + 1, N)], np.int32)
    P = len(pairs)
    idx1 = rng.integers(0, K, (P, M)).astype(np.int32)
    idx2 = rng.integers(0, K, (P, M)).astype(np.int32)
    # Shared ids along chains: keypoint k of image i matches k of image j.
    chain = rng.random((P, M)) < 0.5
    idx2[chain] = idx1[chain]
    match_valid = np.arange(M)[None] < rng.integers(M // 2, M + 1, (P, 1))
    inliers = match_valid & (rng.random((P, M)) < 0.8)
    return _Table(pairs, idx1, idx2, match_valid, inliers, rng.random(P) < 0.7)


class _Table:
    def __init__(self, pairs, idx1, idx2, match_valid, inliers, accept):
        self.pairs, self.idx1, self.idx2 = pairs, idx1, idx2
        self.match_valid, self.inliers, self.accept = match_valid, inliers, accept

    def accepted(self):
        return np.nonzero(self.accept)[0]


@pytest.mark.parametrize("seed,max_views", [(0, None), (1, 3), (2, None)])
def test_build_tracks_identical(seed, max_views):
    rng = np.random.default_rng(seed)
    table = _random_pair_table(rng)
    xy = rng.uniform(0, 1000, (7, 40, 2)).astype(np.float32)
    j = jtracks.build_tracks(table, xy, 7, max_views=max_views)
    t = ttracks.build_tracks(table, xy, 7, max_views=max_views)
    assert j.num_tracks > 5
    for f in dataclasses.fields(j):
        np.testing.assert_array_equal(getattr(t, f.name), getattr(j, f.name), err_msg=f.name)


def _write_calib(path, P):
    path.write_text("CONTOUR\n" + "".join(" ".join(f"{v:.10g}" for v in row) + "\n"
                                          for row in P))


def test_evaluate_result_against_gt_identical(tmp_path):
    rng = np.random.default_rng(4)
    K = np.array([[1200.0, 0, 512], [0, 1200.0, 384], [0, 0, 1]])
    Rs, ts = [], []
    for k in range(6):
        w = rng.normal(0, 0.4, 3)
        th = np.linalg.norm(w)
        Kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
        R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
        t = rng.normal(0, 2, 3)
        Rs.append(R)
        ts.append(t)
        _write_calib(tmp_path / f"{k:04d}.txt", K @ np.hstack([R, t[:, None]]))
    # An estimate: a similarity of the truth plus noise, cameras 1..5 only.
    ids = [1, 2, 3, 4, 5]
    result = SimpleNamespace(
        image_ids=np.array(ids),
        rotations=np.stack([Rs[i] for i in ids]) + rng.normal(0, 1e-3, (5, 3, 3)),
        translations=0.5 * np.stack([ts[i] for i in ids]) + rng.normal(0, 1e-2, (5, 3)))
    names = [f"{k:04d}.ppm" for k in range(6)]
    for kw in ({}, {"image_names": names}):
        j = jcalib.evaluate_result_against_gt(tmp_path, result, **kw)
        t = tcalib.evaluate_result_against_gt(tmp_path, result, **kw)
        assert j is not None and t == j


def _write_images(tmp_path, rng):
    from PIL import Image

    gray = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    paths = {}
    paths["pgm"] = tmp_path / "a.pgm"
    paths["pgm"].write_bytes(b"P5\n# a comment\n53 37\n255\n" + gray.tobytes())
    paths["ppm"] = tmp_path / "b.ppm"
    paths["ppm"].write_bytes(b"P6\n53 37\n255\n" + rgb.tobytes())
    paths["pgm_ascii"] = tmp_path / "c.pgm"
    paths["pgm_ascii"].write_text("P2\n53 37\n255\n" + " ".join(map(str, gray.ravel())) + "\n")
    paths["pgm16"] = tmp_path / "d.pgm"
    g16 = rng.integers(0, 4096, (37, 53)).astype(">u2")
    paths["pgm16"].write_bytes(b"P5\n53 37\n4095\n" + g16.tobytes())
    paths["png"] = tmp_path / "e.png"
    Image.fromarray(rgb).save(paths["png"])
    return paths


@pytest.mark.parametrize("kind", ["pgm", "ppm", "pgm_ascii", "pgm16", "png"])
def test_image_and_mask_loaders_identical(tmp_path, kind):
    path = _write_images(tmp_path, np.random.default_rng(5))[kind]
    for name in ("load_image_gray_u8", "load_image", "load_image_gray"):
        j, t = getattr(jimages, name)(path), getattr(timages, name)(path)
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)
    for invert in (True, False):
        np.testing.assert_array_equal(timages.load_mask(path, invert=invert),
                                      jimages.load_mask(path, invert=invert))


def test_renderers_write_identical_files(tmp_path):
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    from render_scene import render_dataset as j_render

    from sfm_tpu_torch.render_scene import render_dataset as t_render

    quiet = lambda *_: None
    a = j_render(tmp_path / "ref", 3, supersample=1, log=quiet)
    b = t_render(tmp_path / "port", 3, supersample=1, log=quiet)
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert len(files) == 7   # 3 images, 3 calib files, the marker
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
