"""Metrics, stage timing and device traces.

Counterpart of ``sfm_tpu/utils/observability.py``: ``Metrics`` (the same
append-only JSON sink), ``stage`` (wall-clock + a ``torch.profiler``
annotation so a trace lines up with the pipeline stages) and ``trace_to``
(a ``torch.profiler`` capture written as a Chrome trace).
"""
from __future__ import annotations

import contextlib
import json
import logging
import time
from pathlib import Path
from typing import Dict, List

import torch

logger = logging.getLogger(__name__)


class Metrics:
    """Append-only metrics sink; one JSON file per run."""

    def __init__(self):
        self.records: List[Dict] = []
        self._t0 = time.time()

    def log(self, name: str, value, **tags):
        self.records.append(
            {"t": round(time.time() - self._t0, 4), "name": name, "value": value, **tags}
        )

    def save(self, path):
        Path(path).write_text(json.dumps(self.records, indent=1))

    def totals(self) -> Dict[str, float]:
        """Sum of the numeric values logged under each name."""
        out: Dict[str, float] = {}
        for r in self.records:
            if isinstance(r["value"], (int, float)):
                out[r["name"]] = out.get(r["name"], 0.0) + r["value"]
        return out


@contextlib.contextmanager
def stage(name: str, metrics: Metrics):
    """Time a pipeline stage into ``metrics``; annotate profiler traces with
    the same name."""
    t0 = time.time()
    with torch.profiler.record_function(name):
        yield
    dt = time.time() - t0
    metrics.log(f"stage/{name}", dt, unit="s")
    logger.info("%s: %.2fs", name, dt)


@contextlib.contextmanager
def trace_to(log_dir):
    """Capture a CPU + CUDA profiler trace into ``log_dir/trace.json``."""
    d = Path(log_dir)
    d.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(d / "trace.json"))
