"""Port of ``sfm_tpu/geometry`` (the parts the preprocess stage runs)."""
