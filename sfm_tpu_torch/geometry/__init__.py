"""Port of ``sfm_tpu/geometry`` (the parts the main path runs)."""
