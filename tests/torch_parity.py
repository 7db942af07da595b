"""Helpers for the JAX <-> PyTorch parity tests (not collected by pytest).

Inputs are made from a seed with numpy and handed to both packages as numpy
arrays; JAX stays on the CPU (``tests/conftest.py``), and torch runs its
plain twins on the CPU with two threads, since tier-1 runs several workers.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"


def t(a, dtype=None):
    """numpy -> CPU tensor (float64 arrays become float32)."""
    a = np.array(a)
    if dtype is None and a.dtype == np.float64:
        dtype = torch.float32
    out = torch.from_numpy(a)
    return out if dtype is None else out.to(dtype)


def n(x):
    """JAX array or tensor -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def unit_rows(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def textured_image(rng, h, w, blobs=60):
    """A smooth random image in [0, 1]: Gaussian blobs on a gradient."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 0.3 + 0.2 * xx / w
    for _ in range(blobs):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        s = rng.uniform(1.5, 6.0)
        a = rng.uniform(-0.4, 0.4)
        img += a * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def render_scene(out_dir, n_images):
    """The textured corridor of ``scripts/render_scene.py`` (1024x768 views)."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    from render_scene import render_dataset

    return render_dataset(out_dir, n_images, supersample=1, log=lambda *_: None)
