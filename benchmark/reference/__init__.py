"""Plain PyTorch references that decide ``correct``.

Written from the published descriptions (FLUX.1's MMDiT, the FLUX
AutoencoderKL, OpenCLIP's ViT-H/14, CLIP's byte-level BPE, MixGRPO's
Flow-GRPO SDE step and DPM-Solver++ tail, GRPO's group advantages, PPO's
clipped loss, AdamW).  They import only torch, numpy and the standard
library: nothing of the program under test and nothing of JAX.  They read
the weights the benchmark made (the program's parameter layout, by name)
and work out again whatever the program derived from them.
"""
