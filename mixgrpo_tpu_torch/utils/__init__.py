"""Training utilities (mirrors mixgrpo_tpu/utils/)."""
