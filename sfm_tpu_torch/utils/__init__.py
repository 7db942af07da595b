"""Port of ``sfm_tpu/utils`` (the parts the preprocess stage runs)."""
