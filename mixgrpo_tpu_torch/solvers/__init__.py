"""Flow-matching step functions and the rollout driver (mirrors mixgrpo_tpu/solvers/)."""
