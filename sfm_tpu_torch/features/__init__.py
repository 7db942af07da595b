"""Port of ``sfm_tpu/features`` (the parts the preprocess stage runs)."""
