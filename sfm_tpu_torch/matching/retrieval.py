"""Candidate-pair retrieval switch.

Only ``retrieval_enabled`` is ported (``sfm_tpu/matching/retrieval.py:233-238``):
the scorer itself is not, so callers raise when it is on rather than sweep
exhaustively in its place.
"""
from __future__ import annotations

from sfm_tpu_torch._shared import RetrievalConfig


def retrieval_enabled(config: RetrievalConfig, num_images: int) -> bool:
    if config.mode in ("on", "sequential"):
        return True
    if config.mode == "auto":
        return num_images >= config.auto_min_images
    return False
