"""PyTorch/CUDA port of mixgrpo_tpu for NVIDIA Hopper (H100).

The package mirrors ``mixgrpo_tpu/`` file for file; each module's docstring
names its JAX counterpart, which stays the reference.  It imports ``torch``
and never ``jax`` or ``mixgrpo_tpu``.  Entry points take an explicit
``device`` (default ``"cuda"``); nothing moves to the CPU unless asked.

Ported so far: the FLUX.1-dev serving path (``serve.py`` -> ``sample.py`` ->
``sampler.py`` -> ``solvers/rollout.py`` -> ``models/flux/model.py`` ->
``ops/attention.py`` -> the CUDA flash-attention forward -> VAE decode), and
one GRPO iteration on one card (``train.py`` -> ``sampler.chunked_rollout``,
VAE decode, ``rl/``, ``trainer.py`` -> the CUDA forward with logsumexp and
backward kernels under ``torch.autograd``).
"""
