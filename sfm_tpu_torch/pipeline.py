"""Pipeline orchestrator: preprocess -> reconstruct -> export.

Counterpart of ``sfm_tpu/pipeline.py``. The preprocess stage writes the
same restart point for reconstruct as the reference: ``pair_table.pkl``
(numpy arrays only, descriptors as float16), ``matching_results.csv``, the
per-pair files, ``metrics.json`` and ``config.json``; ``sfm_tpu``'s
reconstruct stage reads them unchanged, and so does this one. Unpickling
the table needs numpy and this package's source, not torch: ``PairTable``
lives in the numpy-only :mod:`sfm_tpu_torch.matching.pair_table`. The
reconstruct stage writes ``reconstruction/`` (poses, points, PLY, stats),
the COLMAP text export + database and the MeshLab PLY, and evaluates the
poses against ``data_dir/calib`` when it exists.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import pickle
import time
from pathlib import Path
from typing import Optional

from sfm_tpu_torch.config import SfMConfig
from sfm_tpu_torch.device import resolve_device
from sfm_tpu_torch.utils.observability import Metrics, stage, trace_to

logger = logging.getLogger(__name__)

# The reference's size guard on the persisted descriptors (f16 bytes).
_DESC_BYTES_MAX = 512 * 1024 * 1024


@dataclasses.dataclass
class PipelineArgs:
    """CLI-facing knobs (the reference's fields). ``device`` has no default:
    the caller names it (the CLI's ``--device`` defaults to ``cuda``).
    ``visualize`` and the checkpoint fields are not ported and raise."""

    data_dir: str = "."
    output_dir: Optional[str] = None
    start_idx: int = 0
    end_idx: int = 999
    num_images: int = 1000
    min_matches: int = 20
    use_mask: bool = True
    export_colmap: bool = True
    export_meshlab: bool = True
    export_bundler: bool = False
    export_nvm: bool = False
    visualize: bool = False
    trace_dir: Optional[str] = None   # torch.profiler Chrome trace output
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    resume_checkpoint: Optional[str] = None
    device: str = dataclasses.field(kw_only=True)

    def __post_init__(self):
        if self.visualize:
            raise NotImplementedError(
                "--visualize (per-pair match overlays) is not ported yet "
                "(ROADMAP queue 1, item 3)")
        if self.checkpoint_dir or self.checkpoint_every or self.resume_checkpoint:
            raise NotImplementedError(
                "--checkpoint_dir / --resume_checkpoint are not ported yet "
                "(ROADMAP queue 1, item 2)")


class SfMPipeline:
    def __init__(self, args: PipelineArgs, config: SfMConfig = SfMConfig()):
        self.args = args
        self.config = config
        self.device = resolve_device(args.device)
        self.data_dir = Path(args.data_dir)
        self.output_dir = Path(args.output_dir or args.data_dir)
        self._validate_inputs()
        self._setup_directories()
        self.matcher = None
        self.result = None
        self._image_paths = None
        self.metrics = Metrics()

    def _maybe_trace(self):
        if self.args.trace_dir:
            return trace_to(self.args.trace_dir)
        return contextlib.nullcontext()

    def save_metrics(self):
        self.metrics.save(self.output_dir / "metrics.json")
        self.config.to_json(self.output_dir / "config.json")

    def _validate_inputs(self):
        a = self.args
        if not (0 <= a.start_idx <= 999):
            raise ValueError(f"start_idx {a.start_idx} outside [0, 999]")
        if not (0 <= a.end_idx <= 999):
            raise ValueError(f"end_idx {a.end_idx} outside [0, 999]")
        if a.start_idx > a.end_idx:
            raise ValueError("start_idx > end_idx")
        if not (2 <= a.num_images <= 1000):
            raise ValueError(f"num_images {a.num_images} outside [2, 1000]")
        if not (20 <= a.min_matches <= 1000):
            raise ValueError(f"min_matches {a.min_matches} outside [20, 1000]")
        if not self.data_dir.exists():
            raise FileNotFoundError(f"data_dir {self.data_dir} does not exist")

    def _setup_directories(self):
        for sub in ("reconstruction", "exports"):
            d = self.output_dir / sub
            d.mkdir(parents=True, exist_ok=True)
            probe = d / ".write_probe"
            probe.write_text("ok")
            probe.unlink()

    def run_preprocessing(self) -> bool:
        """Stage 1: detect, sweep, write the artifacts. False on any failure."""
        from sfm_tpu_torch.matching.api import ImageMatcher

        t0 = time.time()
        try:
            with stage("preprocess", self.metrics), self._maybe_trace():
                self.matcher = ImageMatcher(self.data_dir, self.config,
                                            output_dir=self.output_dir, device=self.device,
                                            metrics=self.metrics)
                self.matcher.process_image_range(
                    self.args.start_idx, self.args.end_idx, use_mask=self.args.use_mask)
                self.matcher.save_results()
            table = self.matcher.table
            self.metrics.log("pairs/accepted", int(len(table.accepted())))
            feats = self.matcher.features
            blob = {
                "table": table,
                "xy": feats["xy"],
                "valid": feats["valid"],
                "image_paths": [str(p) for p in self.matcher.image_paths],
            }
            desc = feats["desc"]
            if 2 * desc.numel() <= _DESC_BYTES_MAX:
                blob["desc"] = desc.half().cpu().numpy()
            with (self.output_dir / "pair_table.pkl").open("wb") as f:
                pickle.dump(blob, f)
            self.save_metrics()
            logger.info("preprocessing done in %.1fs", time.time() - t0)
            return True
        except Exception:
            logger.exception("preprocessing failed")
            return False

    def run_reconstruction(self) -> bool:
        """Stage 2 + export: the incremental engine on ``device``, from the
        in-memory preprocess results or from ``pair_table.pkl``."""
        from sfm_tpu_torch.io.export import SfMExporter, save_reconstruction
        from sfm_tpu_torch.reconstruction.incremental import StructureFromMotion

        t0 = time.time()
        try:
            if self.matcher is not None and self.matcher.table is not None:
                feats = self.matcher.features
                table, xy, feat_valid = self.matcher.table, feats["xy"], feats["valid"]
                desc = (feats["desc"].half().cpu().numpy()
                        if 2 * feats["desc"].numel() <= _DESC_BYTES_MAX else None)
                self._image_paths = [str(p) for p in self.matcher.image_paths]
            else:
                blob = pickle.loads((self.output_dir / "pair_table.pkl").read_bytes())
                table, xy = blob["table"], blob["xy"]
                desc, feat_valid = blob.get("desc"), blob.get("valid")
                self._image_paths = blob.get("image_paths")
            with stage("reconstruct", self.metrics), self._maybe_trace():
                sfm = StructureFromMotion(table, xy, self.config, device=self.device,
                                          metrics=self.metrics, desc=desc,
                                          feat_valid=feat_valid)
                self.result = sfm.run_reconstruction(self.args.num_images)
            for k in ("num_cameras", "num_points", "mean_reprojection_error"):
                self.metrics.log(f"reconstruction/{k}", self.result.stats[k])
            self._evaluate_against_gt()
            save_reconstruction(self.result, self.output_dir / "reconstruction")
            exporter = SfMExporter(
                result=self.result,
                image_size=(self.config.camera.width, self.config.camera.height))
            exports = self.output_dir / "exports"
            if self.args.export_colmap:
                exporter.export_colmap(exports / "colmap")
                exporter.create_colmap_database(exports / "colmap" / "database.db")
            if self.args.export_meshlab:
                exporter.export_meshlab(exports / "meshlab.ply")
            if self.args.export_bundler:
                (exports / "bundler").mkdir(parents=True, exist_ok=True)
                exporter.export_bundler(exports / "bundler" / "bundle.out",
                                        exports / "bundler" / "list.txt")
            if self.args.export_nvm:
                exporter.export_nvm(exports / "model.nvm")
            self.save_metrics()
            logger.info("reconstruction done in %.1fs", time.time() - t0)
            return True
        except NotImplementedError:
            raise   # a route this port does not run yet: never a silent failure
        except Exception:
            logger.exception("reconstruction failed")
            return False

    def _evaluate_against_gt(self):
        """Pose accuracy against ``data_dir/calib``, when shipped: adds
        gt_rot_err_deg_median / gt_ate / gt_ate_rel to the result stats."""
        from sfm_tpu_torch.io.calib import evaluate_result_against_gt

        calib = self.data_dir / "calib"
        if self.result is None or not calib.is_dir():
            return
        if self._image_paths is None and self.args.start_idx != 0:
            logger.info("skipping GT eval: no image-path map and start_idx=%d",
                        self.args.start_idx)
            return
        try:
            ev = evaluate_result_against_gt(calib, self.result, image_names=self._image_paths)
            if ev is None:
                return
            self.result.stats.update({f"gt_{k}": v for k, v in ev.items()})
            for k in ("rot_err_deg_median", "ate", "ate_rel"):
                self.metrics.log(f"reconstruction/gt_{k}", ev[k])
            logger.info("GT pose accuracy (%d cams): rot med %.3f deg, ATE %.4f (%.2f%% of "
                        "scene)", ev["n_eval"], ev["rot_err_deg_median"], ev["ate"],
                        100 * ev["ate_rel"])
        except Exception:
            logger.warning("ground-truth evaluation failed", exc_info=True)

    def run_full_pipeline(self) -> bool:
        """Stage 1 + 2 in one process."""
        return self.run_preprocessing() and self.run_reconstruction()
