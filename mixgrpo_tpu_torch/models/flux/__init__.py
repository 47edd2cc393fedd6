"""FLUX.1 MMDiT, latents, RoPE and VAE decoder (mirrors mixgrpo_tpu/models/flux/)."""
