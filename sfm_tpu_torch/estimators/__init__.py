"""Port of ``sfm_tpu/estimators`` (the parts the main path runs)."""
