"""Pipeline orchestrator: the preprocess stage.

Counterpart of ``sfm_tpu/pipeline.py`` (``PipelineArgs`` and
``SfMPipeline.run_preprocessing``). The stage writes the same restart point
for reconstruct as the reference: ``pair_table.pkl`` (numpy arrays only,
descriptors as float16), ``matching_results.csv``, the per-pair files,
``metrics.json`` and ``config.json``. ``sfm_tpu``'s reconstruct stage reads
them unchanged. Unpickling the table needs numpy and this package's
source, not torch: ``PairTable`` lives in the numpy-only
:mod:`sfm_tpu_torch.matching.pair_table`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import pickle
import time
from pathlib import Path
from typing import Optional

from sfm_tpu_torch._shared import SfMConfig
from sfm_tpu_torch.device import resolve_device
from sfm_tpu_torch.utils.observability import Metrics, stage, trace_to

logger = logging.getLogger(__name__)

# The reference's size guard on the persisted descriptors (f16 bytes).
_DESC_BYTES_MAX = 512 * 1024 * 1024


@dataclasses.dataclass
class PipelineArgs:
    """CLI-facing knobs of the preprocess stage. ``device`` has no default:
    the caller names it (the CLI's ``--device`` defaults to ``cuda``)."""

    data_dir: str = "."
    output_dir: Optional[str] = None
    start_idx: int = 0
    end_idx: int = 999
    use_mask: bool = True
    trace_dir: Optional[str] = None   # torch.profiler Chrome trace output
    device: str = dataclasses.field(kw_only=True)


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
