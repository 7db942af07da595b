"""The incremental SfM engine on one named device.

Counterpart of ``sfm_tpu/reconstruction/incremental.py``: seed pair, batched
P3P registration, triangulation of every active track, periodic and final LM
BA on the flat observation table (dense Schur up to
``ba.use_dense_schur_below`` cameras, PCG above; windowed local BA with
``ba.local_window``), and pruning; the one-shot global path
(``global_init.enabled``) and the pose-graph polish of the incremental model
(``global_init.polish``), with the reference's routing, fallback, adoption
gates and rollback. State is host numpy (poses, points, the track table), as
in the reference; every device program reads it as tensors on ``device``:

* :func:`triangulate_tracks` -- kernel K7 (``csrc/triangulate_tracks.cu``,
  entry ``triangulate_tracks``), plain twin :func:`triangulate_tracks_plain`;
* :func:`reproj_stats` -- K7's entry ``reproj_stats``, twin
  :func:`reproj_stats_plain`;
* :func:`guided_match` -- kernel K1-g (``csrc/guided_match.cu``), the 2D-3D
  matcher of the guided rescue, twin :func:`guided_match_plain`;
* PnP (K6, :mod:`sfm_tpu_torch.estimators.pnp`: P3P at ``pnp.sample_size``
  3, the DLT with its per-hypothesis polish at any other), BA (K8-K11,
  :mod:`sfm_tpu_torch.ba`), seed scoring (K14,
  :mod:`sfm_tpu_torch.reconstruction.seed`), relative poses and rotation
  and translation averaging (K13,
  :mod:`sfm_tpu_torch.reconstruction.global_init`).

Not ported (``NotImplementedError`` naming its ROADMAP item): checkpoints.
Per-camera intrinsics and the f64 island run through ``run_ba``. The reference's
blocked (P, V) BA layout is not ported either: past
``ba.use_dense_schur_below`` cameras the port always takes the flat PCG path
(ROADMAP, divergences).
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sfm_tpu_torch import _kernels
from sfm_tpu_torch.config import SfMConfig, effective_guided_ratio
from sfm_tpu_torch.reconstruction import global_init as gi
from sfm_tpu_torch.reconstruction.tracks import TrackTable, build_tracks
from sfm_tpu_torch.ba.lm import run_ba
from sfm_tpu_torch.ba.problem import build_problem
from sfm_tpu_torch.estimators.pnp import pnp_ransac, pnp_ransac_batch
from sfm_tpu_torch.geometry.projection import intrinsics_vector, project
from sfm_tpu_torch.geometry.rotations import rodrigues, rotation_to_rvec
from sfm_tpu_torch.geometry.triangulation import triangulate_multiview, triangulate_two_view
from sfm_tpu_torch.graph.view_selection import SfMGraphSelector
from sfm_tpu_torch.matching.pair_table import rescue_disconnected
from sfm_tpu_torch.reconstruction.seed import find_best_initial_pair
from sfm_tpu_torch.utils.observability import Metrics

logger = logging.getLogger(__name__)

# Kernel K7 keeps a track row's usable-view set in 8 words of bits and the
# seed-pair views' slots in a 32-entry register array.
_K7_MAX_VIEWS = 256
_K7_MAX_SEED_VIEWS = 32
# K7 runs a warp a row, or a thread a row (its layout 1) on launches with seed
# pairs off and at least this many rows: there the warp's lanes all run each
# 4x4 solve, and a thread a row already fills the H100. On the 150-view
# corridor's table the two cross between 8,192 and 12,288 rows (PERF.md
# section 6, K7's two layouts).
_K7_THREAD_ROWS_FROM = 10240
# Kernel K1-g stages descriptors through shared memory in chunks of 32 floats.
_K1G_D_MULTIPLE = 32


# ------------------------------------------------------------- K7: triangulation

def _seed_pairs(n_seed: int):
    return [(a, b) for a in range(n_seed) for b in range(a + 1, n_seed)]


def triangulate_tracks_plain(view_img, view_xy, use, active, rvec, tvec, K, max_err,
                             min_parallax_deg, robust_rounds, seed_pairs_on, n_seed):
    """Triangulate every active track row from its usable views (twin of K7).

    view_img (T, V) int32 (-1 = none); view_xy (T, V, 2); use (T, V) bool
    (valid slot of a registered camera); active (T,); rvec/tvec (C, 3);
    K (3, 3). Returns (points (T, 3), ok (T,)). A row is ok when >= 2 views
    are used, all of them see the point in front of the camera, and the
    max reprojection error over them is <= max_err (and the widest ray
    angle reaches min_parallax_deg, when that is > 0).
    """
    C = rvec.shape[0]
    T, V = view_img.shape
    Rs = rodrigues(rvec)
    P_all = K @ torch.cat([Rs, tvec[..., None]], dim=-1)
    img = view_img.long().clamp(0, C - 1)
    Ps, R_v, t_v = P_all[img], Rs[img], tvec[img]

    def score_of(X, use_rows):
        """X (T, *, 3) -> inliers / errors / depths (T, *, V) over use_rows."""
        proj, depth = project(X[..., None, :], R_v.reshape((T,) + (1,) * (X.dim() - 2) +
                                                           (V, 3, 3)),
                              t_v.reshape((T,) + (1,) * (X.dim() - 2) + (V, 3)), K)
        xy = view_xy.reshape((T,) + (1,) * (X.dim() - 2) + (V, 2))
        err = torch.linalg.vector_norm(proj - xy, dim=-1)
        u = use_rows.reshape((T,) + (1,) * (X.dim() - 2) + (V,))
        return u & (depth > 0) & (err <= max_err), err, depth

    X = triangulate_multiview(Ps, view_xy, use)
    inl_all, err, depth = score_of(X, use)
    n_seed = min(n_seed, V)
    if robust_rounds > 0 and seed_pairs_on and n_seed >= 2:
        ord_valid = torch.sort((~use).to(torch.int8), dim=-1, stable=True).indices
        n_use0 = use.sum(-1)
        k = torch.arange(n_seed, device=use.device)
        sidx = torch.clamp((k[None] * torch.clamp(n_use0, min=1)[:, None]) // n_seed, 0, V - 1)
        stride = torch.gather(ord_valid, 1, sidx)                  # (T, n_seed)
        pairs = torch.tensor(_seed_pairs(n_seed), device=use.device)
        a, b = stride[:, pairs[:, 0]], stride[:, pairs[:, 1]]       # (T, H)
        g = lambda x, i: torch.gather(x, 1, i.reshape(i.shape + (1,) * (x.dim() - 2)).expand(
            i.shape + x.shape[2:]))
        Xp = triangulate_two_view(g(Ps, a), g(Ps, b), g(view_xy, a)[:, :, None],
                                  g(view_xy, b)[:, :, None])[:, :, 0]   # (T, H, 3)
        inls, _, _ = score_of(Xp, use)                               # (T, H, V)
        scores = inls.sum(-1)
        best = torch.argmax(scores, dim=-1)
        top = torch.gather(scores, 1, best[:, None])[:, 0]
        use_best = (top > inl_all.sum(-1)) & (top >= 3)
        best_inl = torch.gather(inls, 1, best[:, None, None].expand(-1, 1, V))[:, 0]
        use = torch.where(use_best[:, None], best_inl, use)
        X = triangulate_multiview(Ps, view_xy, use)
        _, err, depth = score_of(X, use)
    for _ in range(max(robust_rounds, 0)):
        keep = use & (depth > 0) & (err <= max_err)
        use = torch.where((keep.sum(-1) >= 2)[:, None], keep, use)
        X = triangulate_multiview(Ps, view_xy, use)
        _, err, depth = score_of(X, use)
    ok = ((use.sum(-1) >= 2) & torch.where(use, depth > 0, True).all(-1)
          & (torch.where(use, err, 0.0).amax(-1) <= max_err))
    if min_parallax_deg > 0.0:
        centers = -(Rs.mT @ tvec[..., None])[..., 0]
        rays = X[:, None, :] - centers[img]
        rays = rays / torch.clamp(torch.linalg.vector_norm(rays, dim=-1, keepdim=True),
                                  min=1e-12)
        cosang = rays @ rays.mT
        pair_ok = use[:, :, None] & use[:, None, :]
        min_cos = torch.where(pair_ok, cosang, 1.0).amin(-1).amin(-1)
        max_ang = torch.arccos(torch.clamp(min_cos, -1.0, 1.0)) * (180.0 / math.pi)
        ok = ok & (max_ang >= min_parallax_deg)
    return X, ok & active


def triangulate_cameras(rvec, tvec, K):
    """K7's camera tensors of the poses rvec / tvec (C, 3) under K (3, 3):
    (P = K [R | t] (C, 3, 4), R (C, 3, 3), t (C, 3), the camera centers
    (C, 3), (fx, fy, cx, cy)), contiguous. The engine makes them once a
    triangulation pass and hands them to every bucket's launch."""
    Rs = rodrigues(rvec)
    P_all = K @ torch.cat([Rs, tvec[..., None]], dim=-1)
    centers = -(Rs.mT @ tvec[..., None])[..., 0]
    return (P_all.contiguous(), Rs.contiguous(), tvec.contiguous(), centers.contiguous(),
            intrinsics_vector(K))


def triangulate_layout(T, seed_pairs_on):
    """K7's layout for a launch of T rows: 1 (a thread a row) with seed pairs
    off from ``_K7_THREAD_ROWS_FROM`` rows on, else 0 (a warp a row)."""
    return int(not seed_pairs_on and T >= _K7_THREAD_ROWS_FROM)


def triangulate_tracks_cuda(view_img, view_xy, use, active, rvec, tvec, K, max_err,
                            min_parallax_deg, robust_rounds, seed_pairs_on, n_seed, cams=None,
                            layout=None):
    """``layout`` 0 runs K7 a warp a row, 1 a thread a row (the same bits);
    None picks by the launch's shape."""
    T, V = view_img.shape
    C = rvec.shape[0]
    dev = view_img.device
    if V > _K7_MAX_VIEWS:
        raise ValueError(f"triangulate_tracks: V={V} exceeds {_K7_MAX_VIEWS}")
    n_seed = min(n_seed, V)
    if seed_pairs_on and n_seed > _K7_MAX_SEED_VIEWS:
        raise ValueError(f"triangulate_tracks: {n_seed} seed-pair views exceed "
                         f"{_K7_MAX_SEED_VIEWS} (triangulation.seed_pair_views)")
    _kernels.check_tensor(view_img, "view_img", torch.int32, (T, V), dev)
    _kernels.check_tensor(view_xy, "view_xy", torch.float32, (T, V, 2), dev)
    _kernels.check_tensor(use, "use", torch.bool, (T, V), dev)
    _kernels.check_tensor(active, "active", torch.bool, (T,), dev)
    if cams is None:
        cams = triangulate_cameras(rvec, tvec, K)
    for name, x, shape in zip(("P", "R", "t", "centers", "intrinsics"), cams,
                              ((C, 3, 4), (C, 3, 3), (C, 3), (C, 3), (4,))):
        _kernels.check_tensor(x, name, torch.float32, shape, dev)
    if layout is None:
        layout = triangulate_layout(T, seed_pairs_on)
    if layout not in (0, 1):
        raise ValueError(f"triangulate_tracks: layout {layout} is not 0 or 1")
    pts = torch.empty((T, 3), dtype=torch.float32, device=dev)
    ok = torch.empty((T,), dtype=torch.bool, device=dev)
    _kernels.launch("triangulate_tracks", dev, view_img, view_xy, use, active, *cams, T, V, C,
                    float(max_err), float(min_parallax_deg), int(robust_rounds),
                    int(bool(seed_pairs_on)), int(n_seed), layout, pts, ok)
    return pts, ok


def triangulate_tracks(view_img, view_xy, use, active, rvec, tvec, K, *, max_err=4.0,
                       min_parallax_deg=0.0, robust_rounds=1, seed_pairs_on=True, n_seed=8,
                       cams=None):
    """Kernel K7 on CUDA tensors (with ``cams``, the poses'
    :func:`triangulate_cameras` when the caller has them),
    :func:`triangulate_tracks_plain` on CPU."""
    args = (view_img, view_xy, use, active, rvec, tvec, K, max_err, min_parallax_deg,
            robust_rounds, seed_pairs_on, n_seed)
    if view_img.is_cuda:
        return triangulate_tracks_cuda(*args, cams=cams)
    if view_img.device.type == "cpu":
        return triangulate_tracks_plain(*args)
    raise ValueError(f"triangulate_tracks: unsupported device {view_img.device}")


def reproj_stats_plain(view_img, view_xy, view_valid, rvec, tvec, registered, K, points,
                       point_valid):
    """Per-slot reprojection error over the whole reconstruction; returns
    (err (T, V), use (T, V)) with err 0 where not used."""
    C = rvec.shape[0]
    img = view_img.long().clamp(0, C - 1)
    use = view_valid & registered[img] & point_valid[:, None]
    Rs = rodrigues(rvec)
    proj, _ = project(points[:, None, :], Rs[img], tvec[img], K)
    err = torch.linalg.vector_norm(proj - view_xy, dim=-1)
    return torch.where(use, err, 0.0), use


def reproj_stats_cuda(view_img, view_xy, view_valid, rvec, tvec, registered, K, points,
                      point_valid):
    T, V = view_img.shape
    C = rvec.shape[0]
    dev = view_img.device
    _kernels.check_tensor(view_img, "view_img", torch.int32, (T, V), dev)
    _kernels.check_tensor(view_xy, "view_xy", torch.float32, (T, V, 2), dev)
    _kernels.check_tensor(view_valid, "view_valid", torch.bool, (T, V), dev)
    _kernels.check_tensor(registered, "registered", torch.bool, (C,), dev)
    _kernels.check_tensor(points, "points", torch.float32, (T, 3), dev)
    _kernels.check_tensor(point_valid, "point_valid", torch.bool, (T,), dev)
    err = torch.empty((T, V), dtype=torch.float32, device=dev)
    use = torch.empty((T, V), dtype=torch.bool, device=dev)
    _kernels.launch("reproj_stats", dev, view_img, view_xy, view_valid, registered,
                    rodrigues(rvec).contiguous(), tvec.contiguous(), intrinsics_vector(K), points,
                    point_valid, T, V, C, err, use)
    return err, use


def reproj_stats(*args):
    """Kernel K7's ``reproj_stats`` entry on CUDA tensors, its twin on CPU."""
    if args[0].is_cuda:
        return reproj_stats_cuda(*args)
    if args[0].device.type == "cpu":
        return reproj_stats_plain(*args)
    raise ValueError(f"reproj_stats: unsupported device {args[0].device}")


# --------------------------------------------------------- K1-g: guided matching

def guided_match_plain(desc_img, valid_img, pool_desc, pool_valid, pool_track,
                       ratio: float):
    """Match one image's descriptors against the model's observation pool.

    desc_img (K, D) unit-norm; valid_img (K,); pool_desc (M, D); pool_valid
    (M,); pool_track (M,) int32 track id per entry. The Lowe ratio is taken
    against the best entry of a DIFFERENT track (entries of one track are
    near-duplicates). Returns (track (K,), dist (K,), ok (K,)).
    """
    sim = desc_img @ pool_desc.mT
    dist = torch.clamp(2.0 - 2.0 * sim, min=0.0)
    dist = torch.where(pool_valid[None, :], dist, torch.inf)
    dist = torch.where(valid_img[:, None], dist, torch.inf)
    d_best, j_best = torch.min(dist, dim=1)
    t_best = pool_track[j_best]
    other = pool_track[None, :] != t_best[:, None]
    d_second = torch.where(other, dist, torch.inf).amin(1)
    ok = (d_best < ratio ** 2 * d_second) & valid_img & torch.isfinite(d_best)
    return t_best, d_best, ok


def guided_match_cuda(desc_img, valid_img, pool_desc, pool_valid, pool_track, ratio: float):
    K, D = desc_img.shape
    M = pool_desc.shape[0]
    dev = desc_img.device
    if D % _K1G_D_MULTIPLE or M < 1:
        raise ValueError(f"guided_match: D={D} must be a multiple of {_K1G_D_MULTIPLE} "
                         f"and the pool non-empty (M={M})")
    _kernels.check_tensor(desc_img, "desc_img", torch.float32, (K, D), dev)
    _kernels.check_tensor(valid_img, "valid_img", torch.bool, (K,), dev)
    _kernels.check_tensor(pool_desc, "pool_desc", torch.float32, (M, D), dev)
    _kernels.check_tensor(pool_valid, "pool_valid", torch.bool, (M,), dev)
    _kernels.check_tensor(pool_track, "pool_track", torch.int32, (M,), dev)
    t_best = torch.empty((K,), dtype=torch.int32, device=dev)
    d_best = torch.empty((K,), dtype=torch.float32, device=dev)
    ok = torch.empty((K,), dtype=torch.bool, device=dev)
    _kernels.launch("guided_match", dev, desc_img, valid_img, pool_desc, pool_valid,
                    pool_track, K, M, D, float(ratio ** 2), t_best, d_best, ok)
    return t_best, d_best, ok


def guided_match(desc_img, valid_img, pool_desc, pool_valid, pool_track, ratio: float):
    """Kernel K1-g on CUDA tensors, :func:`guided_match_plain` on CPU."""
    args = (desc_img, valid_img, pool_desc, pool_valid, pool_track, ratio)
    if desc_img.is_cuda:
        return guided_match_cuda(*args)
    if desc_img.device.type == "cpu":
        return guided_match_plain(*args)
    raise ValueError(f"guided_match: unsupported device {desc_img.device}")


# ------------------------------------------------------------------- host helpers

def _stratified_order(xy, quality, width, height, grid: int = 8):
    """Round-robin-over-grid-cells order: any prefix covers the image before
    it deepens any one cell; best quality first within a cell."""
    n = len(quality)
    cx = np.clip((xy[:, 0] / max(width, 1) * grid).astype(np.int64), 0, grid - 1)
    cy = np.clip((xy[:, 1] / max(height, 1) * grid).astype(np.int64), 0, grid - 1)
    cell = cy * grid + cx
    ord0 = np.lexsort((-quality, cell))
    cell_s = cell[ord0]
    new_run = np.r_[True, cell_s[1:] != cell_s[:-1]]
    run_start = np.maximum.accumulate(np.where(new_run, np.arange(n), 0))
    rank = np.arange(n) - run_start
    return ord0[np.lexsort((cell_s, rank))]


def _pick_diverse_two(d, ok):
    """Pick <= 2 observations per track for camera angular spread.

    d: (T, V, 3) unit directions point -> camera centre; ok: (T, V). v1 is
    the direction least aligned with the track's mean direction, v2 the one
    least aligned with v1. Returns a (T, V) pick mask (a subset of ok).
    """
    T, V = ok.shape
    dm = np.where(ok[..., None], d, 0.0)
    cnt = ok.sum(1)
    mean = dm.sum(1) / np.maximum(cnt, 1)[:, None]
    dot1 = np.where(ok, np.einsum("tvk,tk->tv", dm, mean), np.inf)
    v1 = np.argmin(dot1, axis=1)
    d1 = dm[np.arange(T), v1]
    dot2 = np.where(ok, np.einsum("tvk,tk->tv", dm, d1), np.inf)
    dot2[np.arange(T), v1] = np.inf
    v2 = np.argmin(dot2, axis=1)
    pick = np.zeros_like(ok)
    pick[np.arange(T), v1] = True
    # |=, not =: with one observation v2 collapses onto v1 (an all-inf row),
    # and assigning False there would erase the track's only pick.
    pick[np.arange(T), v2] |= cnt >= 2
    return pick & ok


def _first_occurrence(ids):
    """Mask of the first occurrence of each value of ``ids``."""
    keep = np.zeros(len(ids), bool)
    keep[np.unique(ids, return_index=True)[1]] = True
    return keep


def _cap_observations(sel, V: int, max_obs: int):
    """Subsample the sorted valid flat slots ``sel`` (t * V + v) to
    ``max_obs``: the first two valid observations of every track are kept,
    the rest at an even stride."""
    t = sel // V
    first = np.r_[True, t[1:] != t[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(len(sel)), 0))
    protected = np.arange(len(sel)) - start < 2
    base, rest = sel[protected], sel[~protected]
    need = max_obs - len(base)
    if need <= 0:
        rest = rest[:0]
    elif len(rest) > need:
        rest = rest[np.linspace(0, len(rest) - 1, need).astype(np.int64)]
    return np.sort(np.concatenate([base, rest]))


@dataclasses.dataclass
class ReconstructionResult:
    """Final scene: poses, cloud, per-track observations, stats (the
    reference's fields and dtypes)."""

    image_ids: np.ndarray          # (R,) int64 registered image ids, in order
    rotations: np.ndarray          # (R, 3, 3) float32 world->cam
    translations: np.ndarray       # (R, 3) float32
    intrinsics: np.ndarray         # (4,) float32 fx fy cx cy
    points3d: np.ndarray           # (M, 3) float32
    track_ids: np.ndarray          # (M,) int64 track id of each point
    obs_img: np.ndarray            # (M, V) int32 image ids per point (-1 = none)
    obs_xy: np.ndarray             # (M, V, 2) float32
    stats: dict


class StructureFromMotion:
    """Incremental reconstruction driver on ``device``.

    table: the verified-pair table (``PairTable``); xy: (N, K, 2) keypoint
    coords of all images.
    """

    def __init__(self, table, xy, config: SfMConfig = SfMConfig(), *, device,
                 metrics: Optional[Metrics] = None, desc=None, feat_valid=None):
        self.device = torch.device(device)
        self.metrics = metrics if metrics is not None else Metrics()
        self.table = table
        self.xy = np.asarray(xy, np.float32)
        self.desc = None if desc is None else np.asarray(desc)
        self.feat_valid = None if feat_valid is None else np.asarray(feat_valid, bool)
        self.config = config
        self.num_images = self.xy.shape[0]
        self.K = config.camera.K()
        if config.verify.rescue_disconnected:
            n_rescued = rescue_disconnected(
                table, self.num_images, min_inliers=config.verify.rescue_min_inliers,
                min_ratio=config.verify.rescue_min_ratio)
            if n_rescued:
                logger.info("rescued %d sub-gate pairs for pairless images", n_rescued)
        self.selector = SfMGraphSelector.from_pair_table(table, select=config.select)
        self._reset_state()
        logger.info("tracks: %d (max length %d)", self.tracks.num_tracks,
                    int(self.tracks.length.max(initial=0)))
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)

    # ------------------------------------------------------------------ utils

    def _reset_state(self):
        """Fresh run state (tracks, poses, points) on the pair table; the
        router also calls it to discard a failed one-shot global model (whose
        guided sweep may have extended the tracks) before the incremental
        engine runs."""
        self.tracks: TrackTable = build_tracks(self.table, self.xy, self.num_images)
        C = self.num_images
        T = max(self.tracks.num_tracks, 1)
        self.rvec = np.zeros((C, 3), np.float32)
        self.tvec = np.zeros((C, 3), np.float32)
        self.registered = np.zeros(C, bool)
        self.reg_order: list[int] = []
        self.points = np.zeros((T, 3), np.float32)
        self.point_valid = np.zeros(T, bool)
        self.view_valid = self.tracks.view_img >= 0
        self.intr = np.array([self.config.camera.fx, self.config.camera.fy,
                              self.config.camera.cx, self.config.camera.cy], np.float32)
        self._ba_calls = 0

    @contextlib.contextmanager
    def _stage(self, name: str):
        """Engine stage wall-clock into ``self.metrics`` (``engine/<name>``,
        the reference's names) and a profiler annotation ``sfm/<name>``."""
        t0 = time.time()
        with torch.profiler.record_function(f"sfm/{name}"):
            yield
        self.metrics.log(f"engine/{name}", time.time() - t0, unit="s")

    @property
    def stage_s(self) -> Dict[str, float]:
        return {k.split("/", 1)[1]: v for k, v in self.metrics.totals().items()
                if k.startswith("engine/")}

    def _t(self, a, dtype=None):
        a = np.ascontiguousarray(a)
        if dtype is None and a.dtype == np.float64:
            a = a.astype(np.float32)
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _camera_matrix(self):
        fx, fy, cx, cy = self.intr
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)

    # ----------------------------------------------------------------- stages

    def initialize(self) -> Tuple[int, int]:
        """Seed-pair two-view initialization."""
        with self._stage("init"):
            row, R, t, score = find_best_initial_pair(self.table, self._camera_matrix(),
                                                      device=self.device)
        i, j = (int(v) for v in self.table.pairs[row])
        logger.info("seed pair (%d, %d) score %.1f", i, j, score)
        self.rvec[i] = 0.0
        self.tvec[i] = 0.0
        self.rvec[j] = rotation_to_rvec(torch.as_tensor(R)).numpy()
        self.tvec[j] = t
        self.registered[[i, j]] = True
        self.reg_order += [i, j]
        self._triangulate()
        return i, j

    def _triangulate_rows(self, rows, pose_args, seed_pairs_on, common):
        """K7 over the track rows ``rows`` (all of them when None)."""
        sel = slice(None) if rows is None else rows
        view_img = self._t(self.tracks.view_img[sel])
        registered, rvec, tvec, K, cams = pose_args
        use = self._t(self.view_valid[sel]) & registered[
            view_img.long().clamp(0, self.num_images - 1)]
        return triangulate_tracks(view_img, self._t(self.tracks.view_xy[sel]), use,
                                  common.pop("active"), rvec, tvec, K,
                                  seed_pairs_on=seed_pairs_on, cams=cams, **common)

    def _triangulate(self, max_err_mult: float = 1.0):
        """(Re)triangulate all tracks that lack a point but are now viewable.

        Row buckets as in the reference: the active rows in buckets of 2048
        when they are few, the full table otherwise; with seed_pair_scope
        "failed", a second pass over the failures in buckets of 1024 with
        seed-pair consensus on.
        """
        cfg_t = self.config.triangulation
        scope = cfg_t.seed_pair_scope
        if max_err_mult > 1.0 or cfg_t.seed_pair_views < 2 or cfg_t.robust_rounds < 1:
            scope = "off"
        with self._stage("triangulate"):
            active = ~self.point_valid & (self.tracks.length >= cfg_t.min_views)
            if not active.any():
                return 0
            common = dict(max_err=cfg_t.max_reproj_error * max_err_mult,
                          min_parallax_deg=cfg_t.min_parallax_deg,
                          robust_rounds=cfg_t.robust_rounds, n_seed=cfg_t.seed_pair_views)
            rvec, tvec, K = self._t(self.rvec), self._t(self.tvec), self._t(self._camera_matrix())
            # K7's camera tensors once for every bucket of this pass.
            cams = triangulate_cameras(rvec, tvec, K) if rvec.is_cuda else None
            pose_args = (self._t(self.registered), rvec, tvec, K, cams)
            T = self.tracks.view_img.shape[0]
            n_active = int(active.sum())

            def buckets(idx, B, seed_pairs_on):
                for c0 in range(0, len(idx), B):
                    sub = idx[c0:c0 + B]
                    rows = np.concatenate([sub, np.zeros(B - len(sub), np.int64)])
                    sub_active = np.zeros(B, bool)
                    sub_active[: len(sub)] = True
                    p, o = self._triangulate_rows(
                        rows, pose_args, seed_pairs_on,
                        dict(common, active=self._t(sub_active)))
                    yield sub, p.cpu().numpy()[: len(sub)], o.cpu().numpy()[: len(sub)]

            B = 2048
            if n_active + B <= T // 2:
                pts = np.zeros((T, 3), np.float32)
                ok = np.zeros(T, bool)
                for sub, p, o in buckets(np.nonzero(active)[0], B, scope == "all"):
                    pts[sub], ok[sub] = p, o
            else:
                p, o = self._triangulate_rows(None, pose_args, scope == "all",
                                              dict(common, active=self._t(active)))
                pts, ok = p.cpu().numpy(), o.cpu().numpy()
            if scope == "failed":
                idx = np.nonzero(active & ~ok)[0]
                for sub, p, o in buckets(idx, 1024, True):
                    pts[sub[o]] = p[o]
                    ok[sub[o]] = True
            self.points[ok] = pts[ok]
            self.point_valid |= ok
        return int(ok.sum())

    def _pnp_correspondences(self, img: int):
        """2D-3D pairs for an unregistered image, from the track table, in
        stratified-quality order (callers truncate at pnp.budget)."""
        t_ids, v_ids = np.nonzero((self.tracks.view_img == img) & self.view_valid)
        has_pt = self.point_valid[t_ids]
        t_ids, v_ids = t_ids[has_pt], v_ids[has_pt]
        pts3d = self.points[t_ids]
        xy = self.tracks.view_xy[t_ids, v_ids]
        if len(t_ids) > 1:
            order = _stratified_order(xy, self.tracks.length[t_ids].astype(np.float32),
                                      self.config.camera.width, self.config.camera.height)
            t_ids, pts3d, xy = t_ids[order], pts3d[order], xy[order]
        return t_ids, pts3d, xy

    def _pnp_kwargs(self):
        c = self.config.pnp
        return dict(iters=c.ransac_iters, threshold=c.reproj_threshold,
                    refine_iters=c.refine_iters, sample_size=c.sample_size,
                    generator=self.generator)

    def register_image(self, img: int, weak: bool = False) -> bool:
        """PnP-register one image; ``weak`` lowers the gate (bounded below)
        for an image whose whole pool cannot reach it (last resort)."""
        with self._stage("pnp"):
            t_ids, pts3d, xy = self._pnp_correspondences(img)
            n = len(t_ids)
            gate = self.config.pnp.min_inliers
            pool_floor = max(gate, self.config.pnp.min_matches)
            if weak and n < pool_floor:
                gate = max(self.config.pnp.min_inliers_floor, int(0.8 * n))
                pool_floor = gate
            if n < pool_floor:
                return False
            budget = self.config.pnp.budget
            p3 = np.zeros((budget, 3), np.float32)
            p2 = np.zeros((budget, 2), np.float32)
            valid = np.zeros(budget, bool)
            m = min(n, budget)
            p3[:m], p2[:m], valid[:m] = pts3d[:m], xy[:m], True
            out = pnp_ransac(self._t(p3), self._t(p2), self._t(valid),
                             self._t(self._camera_matrix()), min_inliers=gate,
                             **self._pnp_kwargs())
            n_inl = int(out["num_inliers"])
            ratio_ok = n_inl >= self.config.pnp.min_inlier_ratio * min(n, budget)
            if not (bool(out["ok"]) and (ratio_ok or weak)):
                return False
        self.rvec[img] = out["rvec"].cpu().numpy()
        self.tvec[img] = out["t"].cpu().numpy()
        self.registered[img] = True
        self.reg_order.append(img)
        logger.info("registered image %d (%d/%d PnP inliers)", img, n_inl, n)
        return True

    def register_candidates(self, candidates, max_accept: int) -> int:
        """PnP the candidate slate in one batched call; register the passers
        in candidate-score order, at most ``max_accept``."""
        with self._stage("pnp"):
            B = self.config.pnp.candidate_batch
            pool_floor = max(self.config.pnp.min_inliers, self.config.pnp.min_matches)
            slate = []
            for img, _score in candidates:
                if len(slate) >= B:
                    break
                t_ids, pts3d, xy = self._pnp_correspondences(int(img))
                if len(t_ids) >= pool_floor:
                    slate.append((int(img), len(t_ids), pts3d, xy))
            if not slate:
                return 0
            budget = self.config.pnp.budget
            # One lane per slate entry (the reference pads to candidate_batch
            # lanes so that its jitted program keeps one shape).
            B = len(slate)
            p3 = np.zeros((B, budget, 3), np.float32)
            p2 = np.zeros((B, budget, 2), np.float32)
            valid = np.zeros((B, budget), bool)
            gates = np.full(B, self.config.pnp.min_inliers, np.int32)
            for a, (_img, n, pts3d, xy) in enumerate(slate):
                m = min(n, budget)
                p3[a, :m], p2[a, :m], valid[a, :m] = pts3d[:m], xy[:m], True
            out = pnp_ransac_batch(self._t(p3), self._t(p2), self._t(valid),
                                   self._t(self._camera_matrix()), self._t(gates),
                                   **self._pnp_kwargs())
            rvecs, ts, nums, oks = (out[k].cpu().numpy()
                                    for k in ("rvec", "t", "num_inliers", "ok"))
        n_registered = 0
        for a, (img, n, _p3, _xy) in enumerate(slate):
            if n_registered >= max_accept:
                break
            n_inl = int(nums[a])
            if not bool(oks[a]) or n_inl < self.config.pnp.min_inlier_ratio * min(n, budget):
                continue
            self.rvec[img] = rvecs[a]
            self.tvec[img] = ts[a]
            self.registered[img] = True
            self.reg_order.append(img)
            n_registered += 1
            logger.info("registered image %d (%d/%d PnP inliers)", img, n_inl, n)
        return n_registered

    # ------------------------------------------------------- guided rescue

    def _model_pool(self):
        """Observation descriptors of the triangulated model: up to 2 per
        track, picked for viewpoint diversity (:func:`_pick_diverse_two`),
        capped at ``pnp.guided_pool`` by an even stride over the tracks
        (sorted longest-first). Returns (pool_desc (M, D) f32, track (M,))."""
        from scipy.spatial.transform import Rotation

        tr = self.tracks
        img = tr.view_img
        imgc = np.clip(img, 0, self.num_images - 1)
        ok = (img >= 0) & self.view_valid & self.point_valid[:, None] & self.registered[imgc]
        R = Rotation.from_rotvec(self.rvec).as_matrix()
        centers = -np.einsum("cji,cj->ci", R, self.tvec)
        d = centers[imgc] - self.points[:, None, :]
        d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
        t_ids, v_ids = np.nonzero(_pick_diverse_two(d, ok))
        cap = self.config.pnp.guided_pool
        if len(t_ids) > cap:
            sel = np.linspace(0, len(t_ids) - 1, cap).astype(np.int64)
            t_ids, v_ids = t_ids[sel], v_ids[sel]
        j = img[t_ids, v_ids]
        kp = tr.view_kp[t_ids, v_ids]
        return self.desc[j, kp].astype(np.float32), t_ids.astype(np.int32)

    def guided_register(self, img: int) -> bool:
        """Register an image the pair graph failed: match its descriptors
        against the model's observation pool (K1-g), then PnP (K6) at
        ``pnp.guided_iters`` draws. Accepted when PnP passes and its inliers
        reach max(guided_min_inliers, guided_min_inlier_ratio x matches);
        the inlier matches then extend the track table."""
        cfg = self.config.pnp
        if self.desc is None or not cfg.guided or self.registered[img]:
            return False
        with self._stage("guided"):
            pool_desc, pool_track = self._model_pool()
            M = len(pool_track)
            if M < cfg.min_inliers:
                return False
            cap = cfg.guided_pool
            pd = np.zeros((cap, pool_desc.shape[1]), np.float32)
            pv = np.zeros(cap, bool)
            pt = np.full(cap, -1, np.int32)
            m = min(M, cap)
            pd[:m], pv[:m], pt[:m] = pool_desc[:m], True, pool_track[:m]
            desc_img = self.desc[img].astype(np.float32)
            valid_img = (self.feat_valid[img] if self.feat_valid is not None
                         else np.ones(desc_img.shape[0], bool))
            t_best, d_best, ok = (x.cpu().numpy() for x in guided_match(
                self._t(desc_img), self._t(valid_img), self._t(pd), self._t(pv), self._t(pt),
                effective_guided_ratio(self.config)))
            kp_ids = np.nonzero(ok)[0]
            if len(kp_ids) < cfg.min_inliers:
                return False
            # One correspondence per track: the best-distance keypoint.
            kp_ids = kp_ids[np.argsort(d_best[kp_ids], kind="stable")]
            _, first = np.unique(t_best[kp_ids], return_index=True)
            kp_ids = kp_ids[np.sort(first)]
            tr_ids = t_best[kp_ids]
            n = len(kp_ids)
            if n < cfg.min_inliers:
                return False
            budget = cfg.budget
            mm = min(n, budget)
            p3 = np.zeros((budget, 3), np.float32)
            p2 = np.zeros((budget, 2), np.float32)
            valid = np.zeros(budget, bool)
            p3[:mm] = self.points[tr_ids[:mm]]
            p2[:mm] = self.xy[img, kp_ids[:mm]]
            valid[:mm] = True
            out = pnp_ransac(self._t(p3), self._t(p2), self._t(valid),
                             self._t(self._camera_matrix()), iters=cfg.guided_iters,
                             threshold=cfg.reproj_threshold, min_inliers=cfg.min_inliers,
                             refine_iters=cfg.refine_iters, sample_size=cfg.sample_size,
                             generator=self.generator)
            n_inl = int(out["num_inliers"])
            # Two legs: an absolute count and a consensus fraction of the matches.
            need = max(cfg.guided_min_inliers, cfg.guided_min_inlier_ratio * mm)
            if not (bool(out["ok"]) and n_inl >= need):
                return False
            inl = out["inliers"].cpu().numpy()[:mm]
        self.rvec[img] = out["rvec"].cpu().numpy()
        self.tvec[img] = out["t"].cpu().numpy()
        self.registered[img] = True
        self.reg_order.append(img)
        n_ext = self._extend_tracks(img, kp_ids[:mm][inl], tr_ids[:mm][inl])
        logger.info("guided-registered image %d (%d/%d PnP inliers, %d track obs added)",
                    img, n_inl, mm, n_ext)
        return True

    def _extend_tracks(self, img: int, kp_ids, t_ids) -> int:
        """Append (img, kp) observations to existing tracks, capacity
        permitting, so that BA sees the new camera. Repeated track or
        keypoint ids keep their first occurrence (callers pass best-distance
        first). Mutates the shared track table and ``view_valid``; the
        tensors of later device calls are built from them anew."""
        kp_ids = np.asarray(kp_ids, np.int64)
        t_ids = np.asarray(t_ids, np.int64)
        if len(kp_ids) == 0:
            return 0
        tr = self.tracks
        L = tr.length[t_ids]
        eligible = (_first_occurrence(t_ids) & _first_occurrence(kp_ids)
                    & (L < tr.max_views)                           # capacity
                    & ~(tr.view_img[t_ids] == img).any(axis=1)     # img not in the track
                    & (tr.kp_track[img, kp_ids] < 0))              # keypoint unclaimed
        t_sel, kp_sel, L_sel = t_ids[eligible], kp_ids[eligible], L[eligible]
        tr.view_img[t_sel, L_sel] = img
        tr.view_kp[t_sel, L_sel] = kp_sel
        tr.view_xy[t_sel, L_sel] = self.xy[img, kp_sel]
        tr.length[t_sel] = L_sel + 1
        tr.kp_track[img, kp_sel] = t_sel
        self.view_valid[t_sel, L_sel] = True
        return int(eligible.sum())

    def _guided_sweep(self, limit: int) -> int:
        """Guided registration of every remaining image, repeated while it
        makes progress (each success strengthens the model for the next)."""
        if self.desc is None or not self.config.pnp.guided:
            return 0
        total = 0
        progressed = True
        while progressed and len(self.reg_order) < limit:
            progressed = False
            for img in range(self.num_images):
                if len(self.reg_order) >= limit:
                    break
                if self.registered[img]:
                    continue
                if self.guided_register(img):
                    self._triangulate()
                    total += 1
                    progressed = True
            if progressed:
                self.bundle_adjust()
                self._triangulate()
        return total

    # -------------------------------------------------------------------- BA

    def _ba_problem_arrays(self):
        """Every (track, view) slot as one BA observation row (point-major:
        obs_point = repeat(arange(T), V)), with the reference's two memory
        controls. Past 1.25M rows of which <= 60% are valid, or whenever
        ``ba.max_obs`` must cut, the table is compacted to its valid rows
        (kept in observation order; eager torch needs no bucket padding).
        Above ``max_obs`` it is subsampled at an even stride, keeping the
        first two valid observations of every track (:func:`_cap_observations`)."""
        T, V = self.tracks.view_img.shape
        obs_cam = np.clip(self.tracks.view_img.reshape(-1), 0,
                          self.num_images - 1).astype(np.int32)
        obs_point = np.repeat(np.arange(T, dtype=np.int32), V)
        obs_xy = self.tracks.view_xy.reshape(-1, 2)
        obs_valid = (self.view_valid.reshape(-1) & self.registered[obs_cam]
                     & self.point_valid[obs_point])
        max_obs = self.config.ba.max_obs
        n_valid = int(obs_valid.sum())
        total = obs_valid.shape[0]
        needs_cap = max_obs > 0 and n_valid > max_obs
        if not needs_cap and (total <= 1_250_000 or n_valid > 0.6 * total):
            return obs_cam, obs_point, obs_xy, obs_valid
        sel = np.nonzero(obs_valid)[0]
        if needs_cap:
            sel = _cap_observations(sel, V, max_obs)
            logger.info("BA observation cap: %d valid -> %d (max_obs=%d; the first two "
                        "valid views per track kept)", n_valid, len(sel), max_obs)
        return obs_cam[sel], obs_point[sel], obs_xy[sel], np.ones(len(sel), bool)

    def bundle_adjust(self, final: bool = False):
        """LM on the flat observation table (the reference's ``bundle_adjust``).

        ``run_ba`` routes on the problem's camera count, the image count: the
        exact dense Schur solve up to ``ba.use_dense_schur_below``, PCG
        (kernel K11) above. With ``ba.local_window`` > 0 a periodic call
        moves only the last ``local_window`` registrations and runs on the
        restricted problem of :meth:`_bundle_adjust_local`; the final call is
        always global. The reference sends a problem with more than 256
        registered cameras whose track table is at least
        ``ba.blocked_min_fill`` full to its blocked (P, V) layout; the port
        has no blocked layout and logs the fill of every > 256-camera call."""
        cfg = self.config.ba
        cam_fixed = np.zeros(self.num_images, bool)
        if self.reg_order:
            cam_fixed[self.reg_order[0]] = True
        if cfg.local_window > 0 and not final:
            fixed = self.reg_order[:-cfg.local_window]
            cam_fixed[fixed] = True
            if len(fixed) > 0:
                return self._bundle_adjust_local(cam_fixed)
        if self.num_images > cfg.use_dense_schur_below:
            ok = (self.view_valid & self.registered[np.clip(self.tracks.view_img, 0,
                                                            self.num_images - 1)]
                  & self.point_valid[:, None])
            fill = float(ok.mean()) if ok.size else 0.0
            n_reg = int(self.registered.sum())
            logger.info("BA #%d: %d of %d cameras registered, track table fill %.4f (the "
                        "reference runs its blocked layout past %d registered at a fill >= "
                        "%.2f; the port runs the flat table)", self._ba_calls + 1, n_reg,
                        self.num_images, fill, cfg.use_dense_schur_below,
                        cfg.blocked_min_fill)
            self.metrics.log("ba/fill", fill, call=self._ba_calls + 1, registered=n_reg)
        with self._stage("assemble"):
            obs_cam, obs_point, obs_xy, obs_valid = self._ba_problem_arrays()
        prob = build_problem(
            rvec=self.rvec, tvec=self.tvec, cam_valid=self.registered, intr=self.intr,
            points=self.points, point_valid=self.point_valid, obs_cam=obs_cam,
            obs_point=obs_point, obs_xy=obs_xy, obs_valid=obs_valid, cam_fixed=cam_fixed,
            device=self.device)
        with self._stage("ba"):
            out, stats = run_ba(prob, cfg, optimize_intrinsics=cfg.optimize_intrinsics)
            self._unpack_ba(out, stats)
        self._log_ba(stats, self.num_images, int(self.point_valid.sum()), local=False)
        if cfg.prune_multiplier > 0:
            self.prune_observations(cfg.prune_multiplier
                                    * self.config.triangulation.max_reproj_error)
        return stats

    def _bundle_adjust_local(self, cam_fixed: np.ndarray):
        """Windowed local BA on a restricted problem (the reference's
        ``_bundle_adjust_local``): the tracks that a moving (registered, not
        fixed) camera observes, and every registered camera observing them;
        the fixed ones anchor the gauge, and when none made it in, the
        oldest involved registration is fixed. Cameras and points are
        remapped to the restricted set and written back after the solve.

        The reference pads the restricted cameras to a multiple of 64 and the
        points to one of 2,048 so that its jitted program is reused; eager
        PyTorch does not pad. ``run_ba`` routes on the raw camera count, which
        agrees with the reference's padded one because 256 is a multiple of
        64: a restricted problem of more than 256 cameras takes PCG in both."""
        cfg = self.config.ba
        T, V = self.tracks.view_img.shape
        cam_of = np.clip(self.tracks.view_img, 0, self.num_images - 1)
        obs_ok_2d = self.view_valid & self.registered[cam_of] & self.point_valid[:, None]
        moving = self.registered & ~cam_fixed
        idx_t = np.nonzero((obs_ok_2d & moving[cam_of]).any(axis=1))[0]
        if len(idx_t) == 0:
            return None
        cam_involved = np.zeros(self.num_images, bool)
        cam_involved[cam_of[idx_t][obs_ok_2d[idx_t]]] = True
        cam_ids = np.nonzero(cam_involved)[0]
        if not cam_fixed[cam_ids].any():
            first = next(r for r in self.reg_order if cam_involved[r])
            cam_fixed = cam_fixed.copy()
            cam_fixed[first] = True
        remap = np.zeros(self.num_images, np.int32)
        remap[cam_ids] = np.arange(len(cam_ids), dtype=np.int32)
        with self._stage("assemble"):
            prob = build_problem(
                rvec=self.rvec[cam_ids], tvec=self.tvec[cam_ids],
                cam_valid=np.ones(len(cam_ids), bool), intr=self.intr,
                points=self.points[idx_t], point_valid=np.ones(len(idx_t), bool),
                obs_cam=remap[cam_of[idx_t]].reshape(-1),
                obs_point=np.repeat(np.arange(len(idx_t), dtype=np.int32), V),
                obs_xy=self.tracks.view_xy[idx_t].reshape(-1, 2),
                obs_valid=obs_ok_2d[idx_t].reshape(-1), cam_fixed=cam_fixed[cam_ids],
                device=self.device)
        with self._stage("ba"):
            out, stats = run_ba(prob, cfg, optimize_intrinsics=cfg.optimize_intrinsics)
            self._ba_calls += 1
            logger.info("local BA #%d (%d cams, %d pts): cost %.1f -> %.1f (%d its, rms %.3f "
                        "px)", self._ba_calls, len(cam_ids), len(idx_t),
                        stats["initial_cost"], stats["final_cost"], stats["iterations"],
                        stats["rms_px"])
            self.rvec[cam_ids] = out.rvec.cpu().numpy()
            self.tvec[cam_ids] = out.tvec.cpu().numpy()
            self.intr = out.intr.cpu().numpy()
            self.points[idx_t] = out.points.cpu().numpy()
        self._log_ba(stats, len(cam_ids), len(idx_t), local=True)
        if cfg.prune_multiplier > 0:
            self.prune_observations(cfg.prune_multiplier
                                    * self.config.triangulation.max_reproj_error)
        return stats

    def _log_ba(self, stats, cameras: int, points: int, local: bool):
        """One ``ba/rms_px`` record per call, the reference's, and one
        ``ba/solve`` record: its route (solver, camera block, dtype of the
        normal equations), costs, iterations and problem size."""
        self.metrics.log("ba/rms_px", float(stats["rms_px"]), call=self._ba_calls)
        self.metrics.log("ba/solve", stats["solver"], call=self._ba_calls, local=local,
                         cam_params=stats["cam_params"], dtype=stats["dtype"],
                         cameras=cameras, points=points,
                         initial_cost=stats["initial_cost"], final_cost=stats["final_cost"],
                         iterations=stats["iterations"],
                         cg_iterations=stats["cg_iterations"])

    def _unpack_ba(self, out, stats):
        self._ba_calls += 1
        logger.info("BA #%d: cost %.1f -> %.1f (%d its, rms %.3f px)", self._ba_calls,
                    stats["initial_cost"], stats["final_cost"], stats["iterations"],
                    stats["rms_px"])
        self.rvec = out.rvec.cpu().numpy()[: self.num_images]
        self.tvec = out.tvec.cpu().numpy()[: self.num_images]
        self.intr = out.intr.cpu().numpy()
        self.points = out.points.cpu().numpy()[: self.points.shape[0]]

    def _reproj_stats(self):
        return reproj_stats(self._t(self.tracks.view_img), self._t(self.tracks.view_xy),
                            self._t(self.view_valid), self._t(self.rvec), self._t(self.tvec),
                            self._t(self.registered), self._t(self._camera_matrix()),
                            self._t(self.points), self._t(self.point_valid))

    def prune_observations(self, threshold: float = None):
        """Mask observations whose reprojection error exceeds the gate;
        points left with < 2 live views are invalidated."""
        if threshold is None:
            threshold = self.config.triangulation.max_reproj_error * 2.0
        with self._stage("prune"):
            err, use = (x.cpu().numpy() for x in self._reproj_stats())
            bad = use & (err > threshold)
        if not bad.any():
            return 0
        self.view_valid &= ~bad
        live = (self.view_valid & self.registered[
            np.clip(self.tracks.view_img, 0, self.num_images - 1)]).sum(axis=1)
        dead = self.point_valid & (live < 2)
        self.point_valid &= ~dead
        logger.info("pruned %d observations, dropped %d points", int(bad.sum()),
                    int(dead.sum()))
        return int(bad.sum())

    # ------------------------------------------------------------------- run

    def global_initialize(self) -> int:
        """Place every pair-connected camera at once by rotation and
        translation averaging over the verified-pair graph (K13)."""
        with self._stage("global_init"):
            rvec, tvec, placed, rel = gi.global_poses(
                self.table, self._camera_matrix(), self.num_images, self.config.global_init,
                return_rel=True, device=self.device)
        self._global_rel = rel   # for the post-BA consistency diagnostic
        self.rvec[placed] = rvec[placed]
        self.tvec[placed] = tvec[placed]
        self.registered |= placed
        self.reg_order = [int(i) for i in np.nonzero(placed)[0]]
        return int(placed.sum())

    def _refine_rounds(self):
        """Triangulate under the relaxed gate, then BA + prune + retriangulate
        (strict gate) + prune, ``global_init.refine_rounds`` times."""
        self._triangulate(max_err_mult=self.config.global_init.tri_relax)
        for _ in range(max(1, self.config.global_init.refine_rounds)):
            self.bundle_adjust()
            self.prune_observations()
            self._triangulate()
            self.prune_observations()

    def pose_graph_polish(self) -> bool:
        """Drift correction of the incremental model (``global_init.polish``).

        Re-averages every registered camera's pose seeded from the model
        (:func:`global_init.polish_poses`) and rebuilds the point cloud in
        the polished frame. Adopted when the median pair-rotation residual
        drops by ``polish_min_gain``, or when the result is self-consistent
        (``polish_max_residual_deg``, ``polish_max_outlier_frac``); rolled
        back when the rebuild keeps fewer than ``polish_rollback_min_points``
        of the model's points. Returns whether the polished model stands.
        """
        if len(self.reg_order) < 3:
            return False
        gcfg = self.config.global_init
        with self._stage("polish"):
            try:
                rvec, tvec, placed, rel = gi.polish_poses(
                    self.table, self._camera_matrix(), self.num_images, self.rvec, self.tvec,
                    self.registered, config=gcfg, device=self.device)
            except ValueError as e:
                # e.g. no accepted pair joins two registered cameras.
                logger.warning("polish skipped: %s", e)
                return False
            if int(placed.sum()) < 3:
                logger.info("polish: averaging subgraph too small; skipping")
                return False
            before = float(np.median(gi.pair_rotation_residuals(self.rvec, rel["pairs"],
                                                                rel["R"])))
            res_after = gi.pair_rotation_residuals(rvec, rel["pairs"], rel["R"])
            after = float(np.median(res_after))
            outlier_frac = float(np.mean(res_after > gcfg.consistency_warn_deg))
            stats = {"polish_applied": False, "polish_pair_residual_deg_before": before,
                     "polish_pair_residual_deg_after": after,
                     "polish_pair_outlier_frac": outlier_frac}
            if "seed_choice" in rel:
                # Each seed's (outlier share, median residual): a near tie
                # makes the choice noise (ROADMAP queue 3).
                stats["polish_seed_choice"] = rel["seed_choice"]
                stats["polish_seed_scores"] = {k: list(v) for k, v in rel["seed_scores"].items()}
            # Adoption: (a) a material fractional gain, or (b) absolute
            # self-consistency (pairwise residuals are nearly blind to smooth
            # drift, so (a) alone would never fire on a long corridor).
            gain = (before - after) / max(before, 1e-9)
            trustworthy = (after <= gcfg.polish_max_residual_deg
                           and outlier_frac <= gcfg.polish_max_outlier_frac)
            if gain < gcfg.polish_min_gain and not trustworthy:
                logger.warning(
                    "polish refused (%.2f -> %.2f deg median, gain %.0f%% < %.0f%%; outlier "
                    "edges %.0f%%): averaging-hostile graph, keeping the incremental poses",
                    before, after, 100 * gain, 100 * gcfg.polish_min_gain, 100 * outlier_frac)
                self._polish_stats = stats
                return False
            # Snapshot: the rebuild may be rolled back without re-registering.
            snapshot = dict(rvec=self.rvec.copy(), tvec=self.tvec.copy(), intr=self.intr.copy(),
                            registered=self.registered.copy(), reg_order=list(self.reg_order),
                            points=self.points.copy(), point_valid=self.point_valid.copy(),
                            view_valid=self.view_valid.copy())
            points_before = int(self.point_valid.sum())
            cams_before = len(self.reg_order)
            self.rvec[placed] = rvec[placed]
            self.tvec[placed] = tvec[placed]
            dropped = self.registered & ~placed
            if dropped.any():
                # Outside the averaging subgraph: the old gauge; the guided
                # sweep re-localizes them against the polished model.
                self.registered &= placed
                self.reg_order = [i for i in self.reg_order if placed[i]]
            # Every point lives in the drifted frame: rebuild and un-prune.
            self.point_valid[:] = False
            self.view_valid = self.tracks.view_img >= 0
            stats.update(polish_applied=True, polish_cameras_dropped=int(dropped.sum()))
            self._polish_stats = stats
            logger.info("polish adopted: pair residual %.2f -> %.2f deg median, %d camera(s) "
                        "deferred to guided re-localization", before, after, int(dropped.sum()))
        self._refine_rounds()
        points_after = int(self.point_valid.sum())
        min_keep = gcfg.polish_rollback_min_points
        if points_after < min_keep * points_before:
            logger.warning("polish rolled back: rebuild kept %d of %d points (< %.0f%%) -- "
                           "restoring the incremental model", points_after, points_before,
                           100 * min_keep)
            for k, v in snapshot.items():
                setattr(self, k, v)
            self._polish_stats = {
                "polish_applied": False, "polish_rolled_back": True,
                "polish_pair_residual_deg_before": before,
                "polish_pair_residual_deg_after": after,
                "polish_pair_outlier_frac": outlier_frac,
                "polish_points_before": points_before,
                "polish_points_after_rebuild": points_after,
            }
            return False
        self._polish_stats.update(polish_cameras_before=cams_before,
                                  polish_points_before=points_before,
                                  polish_points_after_rebuild=points_after)
        return True

    def run_global_reconstruction(self) -> ReconstructionResult:
        """Global path: averaging init -> triangulate everything -> BA/prune
        rounds -> guided rescue of unplaced cameras -> final BA, with the
        pair-rotation self-diagnostic in the stats."""
        t_start = time.time()
        n = self.global_initialize()
        logger.info("global init placed %d/%d cameras", n, self.num_images)
        if n < 2:
            raise ValueError("global init needs at least 2 connected cameras")
        self._refine_rounds()
        if 2 <= len(self.reg_order) < self.num_images:
            n_guided = self._guided_sweep(self.num_images)
            if n_guided:
                logger.info("guided sweep registered %d extra image(s)", n_guided)
                self._triangulate()
        self.bundle_adjust(final=True)
        stats = self.compute_stats()
        stats["wall_clock_s"] = time.time() - t_start
        stats["stage_s"] = {k: round(v, 2) for k, v in self.stage_s.items()}
        # Reprojection error cannot see metric warps; the share of pair
        # measurements the final model grossly disagrees with can.
        rel = self._global_rel
        res_deg = gi.pair_rotation_residuals(self.rvec, rel["pairs"], rel["R"])
        thr = self.config.global_init.consistency_warn_deg
        frac = float(np.mean(res_deg > thr)) if len(res_deg) else 0.0
        stats["global_pair_residual_deg"] = float(np.median(res_deg))
        stats["global_pair_outlier_frac"] = frac
        if frac > 0.1:
            logger.warning(
                "%.0f%% of the pair-rotation measurements disagree with the final model by "
                ">%.0f deg: the pair graph is averaging-hostile and the global result may be "
                "metrically warped; prefer the incremental mode on this scene", 100 * frac, thr)
        logger.info("global reconstruction: %s", stats)
        return self._result(stats)

    def run_reconstruction(self, num_images: Optional[int] = None) -> ReconstructionResult:
        """The reference's run_reconstruction: the global path when
        ``global_init.enabled`` (unless the pair graph has fewer than
        ``min_edges_per_camera`` edges a camera, or an image limit below the
        scene size is asked for; a global model that disagrees with more than
        ``fallback_outlier_frac`` of its pair measurements is discarded),
        else the incremental loop, with ``global_init.polish`` before the
        final guided sweep."""
        if self.config.global_init.enabled and not self.reg_order:
            gcfg = self.config.global_init
            n_edges = len(self.table.accepted())
            min_edges = gcfg.min_edges_per_camera * self.num_images
            if n_edges < min_edges:
                logger.warning(
                    "global_init: pair graph has %d edges for %d cameras (< %.0f): too sparse "
                    "for one-shot averaging -- using the incremental path", n_edges,
                    self.num_images, min_edges)
            elif num_images is None or num_images >= self.num_images:
                result = self.run_global_reconstruction()
                frac = result.stats.get("global_pair_outlier_frac", 0.0)
                if frac <= gcfg.fallback_outlier_frac:
                    return result
                logger.error(
                    "global model inconsistent with %.0f%% of its pair measurements (> %.0f%% "
                    "fallback threshold): discarding it and rerunning incrementally",
                    100 * frac, 100 * gcfg.fallback_outlier_frac)
                self._reset_state()
            else:
                logger.warning("global_init.enabled but num_images < the scene: the one-shot "
                               "global path does not take a limit; using the incremental path")
        t_start = time.time()
        limit = num_images or self.num_images
        if not self.reg_order:
            self.initialize()
        retried_after_ba = False
        freq = max(1, self.config.ba.frequency)
        while len(self.reg_order) < limit:
            with self._stage("select"):
                candidates = self.selector.find_next_best_images(
                    list(self.reg_order), top_k=self.num_images)
            if not candidates:
                logger.info("no more connected candidates")
                break
            to_boundary = freq - (len(self.reg_order) % freq)
            max_accept = min(limit - len(self.reg_order), to_boundary)
            n_new = self.register_candidates(candidates, max_accept)
            progressed = n_new > 0
            if progressed and (self.config.triangulation.cadence == 1
                               or len(self.reg_order) % self.config.triangulation.cadence == 0):
                self._triangulate()
            if not progressed:
                if retried_after_ba:
                    for img, _score in candidates:
                        if self.guided_register(int(img)):
                            self._triangulate()
                            progressed = True
                            break
                    if not progressed:
                        for img, _score in candidates:
                            if self.register_image(int(img), weak=True):
                                self._triangulate()
                                progressed = True
                                break
                    if not progressed:
                        logger.info("no candidate registered; stopping")
                        break
                    retried_after_ba = False
                    continue
                logger.info("all candidates failed; running BA and retrying")
                self.bundle_adjust()
                self._triangulate()
                retried_after_ba = True
                continue
            retried_after_ba = False
            if len(self.reg_order) % self.config.ba.frequency == 0:
                self.bundle_adjust()
                self._triangulate()

        # Drift correction before the guided rescue, so that images the loop
        # failed to place retry against the unbent model.
        if self.config.global_init.polish:
            self.pose_graph_polish()
        if 2 <= len(self.reg_order) < limit:
            n_guided = self._guided_sweep(limit)
            if n_guided:
                logger.info("guided sweep registered %d extra image(s)", n_guided)
        if len(self.reg_order) >= 2:
            self.bundle_adjust(final=True)
        stats = self.compute_stats()
        stats.update(getattr(self, "_polish_stats", {}))
        stats["wall_clock_s"] = time.time() - t_start
        stats["stage_s"] = {k: round(v, 2) for k, v in self.stage_s.items()}
        logger.info("reconstruction: %s", stats)
        return self._result(stats)

    # ----------------------------------------------------------------- output

    def compute_stats(self) -> dict:
        """Mean/max reprojection error, track lengths, counts."""
        with self._stage("stats"):
            err, use = (x.cpu().numpy() for x in self._reproj_stats())
            n_obs = int(use.sum())
            lengths = use.sum(axis=1)[self.point_valid]
        return {
            "num_cameras": int(self.registered.sum()),
            "num_points": int(self.point_valid.sum()),
            "num_observations": n_obs,
            "mean_reprojection_error": float(err[use].mean()) if n_obs else 0.0,
            "max_reprojection_error": float(err[use].max()) if n_obs else 0.0,
            "mean_track_length": float(lengths.mean()) if len(lengths) else 0.0,
            "max_track_length": int(lengths.max()) if len(lengths) else 0,
        }

    def _result(self, stats) -> ReconstructionResult:
        reg = np.array(self.reg_order, np.int64)
        Rs = rodrigues(torch.as_tensor(self.rvec[reg])).numpy()
        sel = self.point_valid
        return ReconstructionResult(
            image_ids=reg, rotations=Rs, translations=self.tvec[reg].copy(),
            intrinsics=self.intr.copy(), points3d=self.points[sel].copy(),
            track_ids=np.nonzero(sel)[0], obs_img=self.tracks.view_img[sel].copy(),
            obs_xy=self.tracks.view_xy[sel].copy(), stats=stats)
