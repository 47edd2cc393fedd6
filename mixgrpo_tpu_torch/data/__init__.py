"""Data layer (mirrors mixgrpo_tpu/data/)."""
