"""Attention and the port's hand-written kernels (mirrors mixgrpo_tpu/ops/)."""
