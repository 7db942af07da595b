"""ImageMatcher: detect features over a dataset and sweep every pair.

Counterpart of ``sfm_tpu/matching/api.py::ImageMatcher`` (stage 1 of the
pipeline), with the same on-disk contract: images in ``<data_dir>/images``,
masks in ``<data_dir>/silhouettes``, per-pair artifacts in
``<output_dir>/{matches,fundamental,correspondences}`` and
``matching_results.csv``. The compute runs on an explicit ``device``.
When the config turns retrieval on (by default at >= 150 images), the sweep
runs only on the candidate pairs that :func:`select_candidate_pairs` keeps.
"""
from __future__ import annotations

import csv
import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from sfm_tpu_torch.config import SfMConfig, effective_retrieval_config
from sfm_tpu_torch.io.images import load_image_gray_u8, load_mask
from sfm_tpu_torch.features.frontend import detect_and_describe, detect_and_describe_batch
from sfm_tpu_torch.matching.retrieval import retrieval_enabled, select_candidate_pairs
from sfm_tpu_torch.matching.pair_table import PairTable
from sfm_tpu_torch.matching.sweep import all_pairs_sweep
from sfm_tpu_torch.utils.observability import Metrics, stage

logger = logging.getLogger(__name__)

_IMG_EXTS = (".ppm", ".pgm", ".png", ".jpg", ".jpeg", ".pnm")


class ImageMatcher:
    """Feature detection + pair matching for a dataset directory."""

    def __init__(self, data_dir, config: SfMConfig = SfMConfig(), output_dir=None, *,
                 device, metrics: Optional[Metrics] = None):
        self.data_dir = Path(data_dir)
        self.config = config
        self.device = torch.device(device)
        self.metrics = metrics if metrics is not None else Metrics()
        self.output_dir = Path(output_dir) if output_dir else self.data_dir
        for sub in ("matches", "fundamental", "correspondences"):
            (self.output_dir / sub).mkdir(parents=True, exist_ok=True)
        self.image_dir = self.data_dir / "images"
        self.mask_dir = self.data_dir / "silhouettes"
        self.table: Optional[PairTable] = None
        self.features = None
        self.image_paths: list[Path] = []

    # ---------------------------------------------------------------- images

    def list_images(self, start_idx: int = 0, end_idx: Optional[int] = None):
        paths = sorted(
            p for p in self.image_dir.iterdir() if p.suffix.lower() in _IMG_EXTS
        )
        if end_idx is not None:
            paths = [p for p in paths if start_idx <= self._idx(p) <= end_idx]
        else:
            paths = paths[start_idx:]
        return paths

    @staticmethod
    def _idx(path: Path) -> int:
        digits = "".join(c for c in path.stem if c.isdigit())
        return int(digits) if digits else 0

    def _mask_for(self, img_path: Path) -> Optional[np.ndarray]:
        if not self.mask_dir.exists():
            return None
        for ext in (".pgm", ".png"):
            cand = self.mask_dir / (img_path.stem + ext)
            if cand.exists():
                return load_mask(cand)
        return None

    # ----------------------------------------------------------------- stages

    def detect_all(self, start_idx: int = 0, end_idx: Optional[int] = None,
                   use_mask: bool = True):
        """Run the frontend over the image range.

        Returns {"xy": (N, K, 2) numpy, "desc": (N, K, D) tensor on the
        device, "valid": (N, K) numpy}.
        """
        self.image_paths = self.list_images(start_idx, end_idx)
        if not self.image_paths:
            raise FileNotFoundError(f"no images in {self.image_dir}")
        t0 = time.time()
        imgs = [load_image_gray_u8(p) for p in self.image_paths]
        masks = [self._mask_for(p) if use_mask else None for p in self.image_paths]
        fc = self.config.features
        same_shape = len({im.shape for im in imgs}) == 1
        all_masked = all(m is not None for m in masks)
        if same_shape and (all_masked or not any(m is not None for m in masks)):
            f = detect_and_describe_batch(
                np.stack(imgs), np.stack(masks) if all_masked else None,
                config=fc, batch_size=fc.detect_batch, device=self.device)
            desc, xy, valid = f.desc, f.xy, f.valid
        else:
            feats = [detect_and_describe(im, mk, config=fc, device=self.device)
                     for im, mk in zip(imgs, masks)]
            desc = torch.stack([f.desc for f in feats])
            xy = torch.stack([f.xy for f in feats])
            valid = torch.stack([f.valid for f in feats])
        self.features = {"xy": xy.cpu().numpy(), "desc": desc,
                         "valid": valid.cpu().numpy()}
        logger.info(
            "detected features for %d images in %.1fs (mean %d kps)",
            len(self.image_paths), time.time() - t0,
            int(self.features["valid"].sum(1).mean()),
        )
        return self.features

    def process_image_range(self, start_idx: int = 0, end_idx: Optional[int] = None,
                            use_mask: bool = True) -> PairTable:
        """Full stage 1: detect + candidate retrieval (when on) + sweep +
        per-pair artifacts.

        Every timed stage ends in a copy to the host, so its wall-clock
        includes the device work (``stage/detect``, ``stage/retrieval``,
        ``stage/sweep``).
        """
        with stage("detect", self.metrics):
            feats = self.detect_all(start_idx, end_idx, use_mask)
        pairs = None
        n = len(self.image_paths)
        if retrieval_enabled(self.config.retrieval, n):
            with stage("retrieval", self.metrics):
                pairs, rstats = select_candidate_pairs(
                    feats["desc"], feats["valid"], n, effective_retrieval_config(self.config))
            logger.info("retrieval: kept %d of %d candidate pairs (%.1f%%) in %.1fs",
                        rstats["kept"], rstats["candidates"], 100.0 * rstats["keep_frac"],
                        rstats["seconds"])
        xy = torch.as_tensor(feats["xy"], device=self.device)
        valid = torch.as_tensor(feats["valid"], device=self.device)
        with stage("sweep", self.metrics):
            self.table = all_pairs_sweep(xy, feats["desc"], valid, self.config, pairs=pairs)
        self._save_pair_artifacts()
        return self.table

    # -------------------------------------------------------------- artifacts

    def _save_pair_artifacts(self):
        """Per accepted pair: pts1/pts2 .npy, F .npz, matches .npz."""
        t = self.table
        ids = [self._idx(p) for p in self.image_paths]
        for p in t.accepted():
            i, j = (ids[k] for k in t.pairs[p])
            stem = f"pair_{i}_{j}"
            inl = t.inliers[p]
            np.save(self.output_dir / "correspondences" / f"{stem}_pts1.npy", t.xy1[p][inl])
            np.save(self.output_dir / "correspondences" / f"{stem}_pts2.npy", t.xy2[p][inl])
            np.savez(
                self.output_dir / "fundamental" / f"{stem}_F.npz",
                F=t.F[p],
                num_inliers=t.num_inliers[p],
                reprojection_error=t.reprojection_error[p],
            )
            np.savez(
                self.output_dir / "matches" / f"{stem}_matches.npz",
                idx1=t.idx1[p][t.match_valid[p]],
                idx2=t.idx2[p][t.match_valid[p]],
                inliers=inl[t.match_valid[p]],
            )

    def save_results(self, csv_path=None) -> Path:
        """Write matching_results.csv (one row per accepted pair)."""
        if csv_path is None:
            csv_path = self.output_dir / "matching_results.csv"
        csv_path = Path(csv_path)
        ids = [self._idx(p) for p in self.image_paths]
        rows = self.table.to_records()
        with csv_path.open("w", newline="") as f:
            w = csv.writer(f)
            w.writerow(
                ["image1", "image2", "num_matches", "num_inliers",
                 "inlier_ratio", "reprojection_error", "well_distributed"]
            )
            for r in rows:
                w.writerow(
                    [
                        f"{ids[r['image1']]:04d}.ppm",
                        f"{ids[r['image2']]:04d}.ppm",
                        r["num_matches"],
                        r["num_inliers"],
                        f"{r['inlier_ratio']:.4f}",
                        f"{r['reprojection_error']:.4f}",
                        r["well_distributed"],
                    ]
                )
        if rows:
            logger.info(
                "matching stats: %d pairs, mean matches %.1f, mean inliers %.1f, "
                "mean ratio %.3f",
                len(rows),
                np.mean([r["num_matches"] for r in rows]),
                np.mean([r["num_inliers"] for r in rows]),
                np.mean([r["inlier_ratio"] for r in rows]),
            )
        return csv_path
