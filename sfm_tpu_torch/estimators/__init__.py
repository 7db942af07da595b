"""Port of ``sfm_tpu/estimators`` (the parts the preprocess stage runs)."""
