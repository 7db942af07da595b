"""Port of ``sfm_tpu/matching`` (the parts the preprocess stage runs)."""
