"""Model ports (mirrors mixgrpo_tpu/models/)."""
