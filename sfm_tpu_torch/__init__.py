"""sfm_tpu_torch — the PyTorch/CUDA port of ``sfm_tpu``.

A second package beside the JAX reference. It imports ``torch`` and never
``jax``, nor any file of ``sfm_tpu`` or ``scripts`` (``import sfm_tpu``
pulls in ``jax``): it keeps its own copies of the numpy-only host modules --
the config schema (:mod:`sfm_tpu_torch.config`), the image and mask
decoders (:mod:`sfm_tpu_torch.io.images`), the track builder
(:mod:`sfm_tpu_torch.reconstruction.tracks`), the ground-truth evaluator
(:mod:`sfm_tpu_torch.io.calib`) and the scene renderer
(:mod:`sfm_tpu_torch.render_scene`) -- which the tests hold against the
originals.

Ported so far: the main path under the default configuration, ``python -m
sfm_tpu_torch pipeline --data_dir D --device cuda`` (SIFT frontend,
retrieval, match/verify sweep, the incremental engine with the guided
rescue, dense-Schur bundle adjustment, export), and the global SfM and
pose-graph polish routes (``--global_init``, ``--polish``). The device is always explicit
(:func:`sfm_tpu_torch.device.resolve_device`); on a CUDA tensor every kernel
wrapper launches its hand-written kernel from ``csrc/`` or raises, and its
plain PyTorch twin runs only on CPU tensors.
"""

__version__ = "0.1.0"
