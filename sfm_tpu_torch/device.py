"""Explicit device selection and the float32 policy.

The device is always named by the caller. Asking for CUDA where no card is
present raises: nothing silently falls back to the CPU.

TF32 is switched off for matmuls and cuDNN at import. TF32 keeps ~10
mantissa bits, the same class of leak as bf16 blur on the TPU, which
creates ~40% spurious DoG extrema at contrast 0.006
(``sfm_tpu/features/pyramid.py:32-35``), and it perturbs the 9x9 normal
equations of the eight-point solver.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(name) -> torch.device:
    """``torch.device(name)``; raises when CUDA is asked for without a card."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is False")
    return dev
