"""sfm_tpu_torch — the PyTorch/CUDA port of ``sfm_tpu``.

A second package beside the JAX reference. It imports ``torch`` and never
``jax`` (nor ``sfm_tpu``, whose package import pulls in ``jax``): the
numpy-only host modules it shares with the reference are loaded by file
path in :mod:`sfm_tpu_torch._shared`.

Ported so far: the main path under the default configuration, ``python -m
sfm_tpu_torch pipeline --data_dir D --device cuda`` (SIFT frontend,
retrieval, match/verify sweep, the incremental engine with the guided
rescue, dense-Schur bundle adjustment, export). The device is always explicit
(:func:`sfm_tpu_torch.device.resolve_device`); on a CUDA tensor every kernel
wrapper launches its hand-written kernel from ``csrc/`` or raises, and its
plain PyTorch twin runs only on CPU tensors.
"""

__version__ = "0.1.0"
