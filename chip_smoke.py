#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mixgrpo_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``
(``--only PHASES`` runs a comma-separated subset and then exits 4 with no
result).  Every phase prints JSON records; a failing phase ends the run with
a non-zero exit code.  Phases:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions
   (``utils.env.collect_env``);
2. build: every hand-written kernel library compiled from
   ``mixgrpo_tpu_torch/csrc`` (one ``nvcc`` per source, all started
   together), with ptxas's register and spill report;
3. kernels: ptxas's report of the D = 128 forward, dkv, fused and dq
   kernels (no spill, no wgmma serialisation); each kernel against its plain
   PyTorch version on the card, at small ragged shapes, at the tile edges of
   the forward and of the three backward kernels, and at the shapes of the
   main paths (the forward without lse at the serving shape, the forward
   with lse and the fused backward at the 720px update, dkv and dq at the
   1024px update, the forward with HunyuanVideo's key mask at B = 1, H = 24,
   S = 8,576, at Mochi's final block, S = 11,130 over Sk = 11,386, and at
   Mochi's 163 frames, S = Sk = 44,776 (the plain version one head at a
   time); at
   both updates the fused kernel and the split pair are timed side by
   side), with its time, the plain version's time, the card's
   bound for the same work and one PyTorch library call's time as a
   yardstick (never used by the port), and the card's SM clock sampled right
   after each timing; dkv, dq and fused launched twice must give identical
   dk, dv and dq (fused's dq, summed in an order that changes from run to
   run, within ``close_bf16``); the profiler's device time of each kernel of
   the split pair at 1024px (pre-passes included); then autograd through
   the kernels; then the QK-norm + RoPE kernels (``csrc/qk_rope.cu``,
   forward and backward) against their plain version at D 32, 64, 128,
   both layouts, bf16 and f32, and timed (CUDA graphs of 10 launches)
   beside their byte bound and the plain version at the FLUX 720px and
   HunyuanVideo blocks;
4. serve: the first slice's path at full FLUX.1-dev width and depth with
   random bf16 weights (``DualFluxPipeline`` at 1024x1024, 4 steps, behind
   ``RequestBatcher`` and ``InferenceServer``; then one 720px call), the
   model path through the kernel against eager attention, and the profile of
   one forward; on the same weights, continuous batching
   (``ContinuousBatcher``, 2 slots, one step per engine call, behind the
   server: a staggered burst of 4 requests and a lone one, each image
   against RequestBatcher's for its (prompt, seed)), and int8 serving
   (``ops/quant.py``: the base tree quantised, the forward in int8 against
   bf16 with the matmuls' bf16, ``_int_mm`` and ``qlinear`` times,
   ``_int_mm`` on the card against the CPU, one request through an int8
   ``DualFluxPipeline``);
5. train: two recipe GRPO iterations through ``GRPOTrainer.train_one_step``
   at full width, depth cut to 2 double + 4 single blocks (fp32 master
   weights, grads and AdamW moments), the full random VAE decoder and a
   synthetic brightness reward; then a third with ``rollout_quant="int8"``;
6. update_full_depth: one ``update_step`` at ``virtual_depth=(19, 38)`` over a
   1 + 2 block stack, at 720px (12 pairs, fused backward) and 1024px (2
   pairs, split backward).
7. train_flash_lora: MixGRPO-Flash with LoRA at full FLUX.1-dev width,
   ``FLASH_LORA_DEPTH`` = 10 + 19 blocks (of 19 + 38, cut to keep the script
   inside its time limit): a frozen random bf16 base, a rank-16 adapter,
   DPM-Solver++ on the compressed tail after the SDE window; two iterations
   through ``GRPOTrainer.train`` with the second one traced by the trainer's
   profiler, and that trace's device breakdown.
8. checkpoints (run right after serve): a synthetic FLUX.1-dev directory in
   the released layout at full width, written by the port's own writers
   (transformer cut to 2 + 4 blocks, T5-XXL cut to 2 of 24 layers, the whole
   CLIP-L text tower, the full VAE, an F32 tuned export, the tokenizers),
   loaded onto the card in bf16 with a dozen leaves held bit for bit, the
   prompt encoders in bf16 against f32, then ``sample.main`` (also with
   ``--quant int8``) and ``serve.build_server`` (also with ``--quant int8``
   and with ``--continuous``) on it at 1024px and ``vae_encode`` of two
   decoded images; the directory is removed afterwards.
9. rewards (right after checkpoints): the reward zoo at its published
   geometries (HPSv2.1, PickScore_v1 and DFN5B CLIP-score ViT-H-14s,
   ImageReward's BLIP ViT-L + BERT-base), written in their released layouts
   with random weights, loaded in bf16 and in f32, 12 images at 720px scored
   by each (bf16 within ``REWARD_BF16_BOUND`` of f32, no kernel launch),
   UnifiedReward against a stub server on 127.0.0.1, ``eval_rewards.main``
   and ``verify_weights.main`` on the files (``rewards_phase``);
10. train_main (right after rewards, on its files): ``preprocess.main``, the
   cache's rows through the native reader and the numpy memmap (bit for
   bit, rows/s), ``train.main --reward_model multi_reward`` for 2 recipe
   steps at full width (2 + 4 blocks), reading through the native reader,
   with a checkpoint and the loader's share of each iteration, then
   ``tsne_probe.main``, then ``train.main --rollout_quant int8`` for one
   step with HPS (``train_main_phase``); both phases' files are removed
   afterwards.
11. hunyuan_video: HunyuanVideo text-to-video at full width and depth with
   random bf16 weights (the DiT's 20 + 40 blocks, the llava-llama-3-8b text
   tower, CLIP-L, the causal 3D VAE): ``HunyuanVideoSampler.predict`` at the
   JAX sampler's 192x336, 129 frames, 4 steps (cut from 50), two prompts
   and seeds (B = 1 per call), a synthetic Llama-3 byte-level BPE
   ``tokenizer.json``, the tiled decode; its seconds per video split into
   text encoding, denoising and decode, its peak and launches; one DiT
   forward with the kernel against eager attention at that size (216 of
   256 text tokens masked); two forwards at 544x960, 129 frames, the first
   cold and the second timed warm; then
   the released layouts written at full width (the transformer ``.pt`` cut
   to 2 + 4 blocks, the Llama-3 tower to 4 of 32 layers, the whole VAE,
   CLIP-L, the tokenizer), loaded with leaves held bit for bit, one
   ``predict`` on them and ``verify_weights.main`` record-then-check for
   ``hunyuan_llm``, ``hunyuan_vae`` and ``hunyuan_dit`` (the files are
   removed afterwards);
12. mochi_video: Mochi-1 text-to-video at full width and depth with random
   bf16 weights (the asymmetric DiT's 48 blocks, 10.03 B parameters, and
   the causal VAE decoder): ``MochiPipeline`` at the published 480x848, 37
   frames (7 x 60 x 106 latents, S = 11,130 + 40 text tokens: the 216
   padded of 256 cut before the blocks), 2 steps (cut from 64) of real CFG
   4.5, two prompts of random T5 features with 40 of 256 tokens valid
   (B = 1 per video), the tiled decode; its seconds per
   video split into denoising and decode, DiT calls, tiles, peak and
   launches (48 forwards per DiT call, the final block's at Sq != Sk); the
   profile of one DiT call and one decode tile; one DiT forward at that
   size with each of its 48 kernel calls held against eager attention on
   the same inputs, and its output against eager attention's, no further
   from it than ``MOCHI_FLOOR_SLACK`` times the floor read in the run (eager
   attention against itself on q times D^-1/2 rounded to bf16, as the
   kernel takes it: no two bf16 attentions meet ``close_bf16`` at 48
   blocks), and against the model's in f32, while a planted fault stands
   further; its distance to the plain version's is recorded;
   two forwards at 163 frames (S = 44,560), cold then warm, the first and
   the final block's kernel calls of the cold one (S = Sk = 44,560; 44,520
   queries over 44,560 keys) held against the kernel's plain version on the
   same inputs (``close_bf16``); a gradient through
   ``mochi_forward`` at 2 + the final block, full width, against eager (the
   forward with lse, dkv and dq at Sq != Sk); then a transformer directory
   in the diffusers layout (2 + final block) and the VAE decoder written,
   loaded in bf16 with a dozen leaves held bit for bit, the convert CLI's
   round trip and ``verify_weights.main`` for ``mochi`` and ``mochi_vae``
   (the files are removed afterwards);
13. parallel_attention: several ranks, spawned as ``python3 chip_smoke.py
   --rank ...`` (``parallel_layout``: on a one-card machine two ranks share
   the card over ``gloo``, since NCCL refuses two ranks of one communicator
   on one device; with 2-4 cards one rank per card over NCCL): Ulysses and
   ring attention (sp = ranks) through ``attention(impl=...)`` at
   FLUX.1-dev width (B = 2, H = 24, S = 4608, D = 128, bf16), forward and
   backward, with and without a key mask, each held against one-rank
   ``attention(impl="flash")`` with ``close_bf16``; each rank's flash
   launches, the collectives' transport (direct, or staged through the host
   with its count) and one all-to-all, all-gather and send/recv timed;
14. parallel_train: one recipe iteration (full width, ``PAR_DEPTH`` = 1 + 2
   blocks, 2 generations per prompt) on mesh (dp 1, fsdp = ranks), one prompt per
   rank, against one rank (this process, run first) on every prompt with
   the same injected noise: the parameters' update and the gradient norm,
   each rank's peak (under 80 GB per card) and launches; then the sharded
   checkpoint, its resume into a new trainer and the export;
15. parallel_cli (needs checkpoints and rewards): ``sample.main`` over the
   ranks on the checkpoints phase's directory and ``eval_rewards.main``
   (HPSv2.1) over them on its images: JAX's file names and seeds, and rank
   0's summary over every image.
16. parallel_tp: one recipe iteration (full width, 1 + 2 blocks, 2
   generations per prompt, drawn biases) on mesh (dp 1, fsdp = ranks / 2,
   tp 2: the Megatron split of the blocks, 12 of the 24 heads per rank), one
   prompt per batch rank, against one rank (this process, run first) on
   every prompt with the same injected noise: the final latents, the
   rewards, the update and the gradient norm within ``PAR_TP_*``, each
   rank's launches and tp all-reduces (6 per DiT call) and their bytes, and
   its peak; then the (fsdp, tp) checkpoint, its resume on the same mesh,
   its restore on one rank (in this process: every leaf and AdamW moment,
   cut back to each rank's slice, bit for bit against the ranks' own) and
   the export against the restored tree, bit for bit.
17. video_sp: the HunyuanVideo gradient in this process (full width, 2 + 4
   blocks, 192x336, 129 frames, remat, the text and pad keys masked:
   output, d latents and a block's d qkv with the kernels against eager
   attention, ``close_bf16``; 12 forwards with lse, 6 dkv, 6 dq); then the
   ranks run HunyuanVideo (2 + 4 blocks) with ``attn_impl`` "ulysses" and
   "ring" and Mochi (2 + final block, 480x848, 37 frames) with "ulysses",
   sp = ranks, each against the rank's own one-rank "auto" forward
   (``close_bf16``), with each call's ms, gloo bytes, launches and the heads
   of each local attention call (12 of 24 at sp = 2);
18. parallel_lora: one LoRA iteration (rank 16, the frozen bf16 base
   sharded, full width, 2 + 4 blocks) on mesh (dp 1, fsdp = ranks) and on
   (dp 1, tp = ranks), against one rank on the same prompts and noise: the
   factors' update and grad norm (``PAR_UPDATE_REL_L2``,
   ``PAR_GRAD_NORM_REL``), the rewards, the export byte for byte, each
   rank's 1/n of every sharded leaf; the fsdp run's checkpoint and resume,
   and each rank's resident share of the full-depth bf16 base (19 + 38
   blocks; only allocated).
A rank that fails or outlives its phase's timeout fails the run (every rank
is killed, each failed rank's log printed).  Times of ranks sharing one card
say nothing of separate cards.
Each path's kernel launches are counted from 0 just before it runs and read
just after, and must equal the prediction exactly (every FLUX or HunyuanVideo
block also one QK-norm + RoPE forward a DiT call).  Each phase ends with a
``phase_time`` record of its wall seconds.  Last come the
``kernels`` line, the ``nvidia-smi`` line, and the final status line.

``--only`` with ``train_main`` needs ``rewards`` too, ``parallel_cli`` needs
``checkpoints`` and ``rewards``.  Exits 2 without a CUDA
card; without the package beside it the import fails.
"""

from __future__ import annotations

import ctypes
import io
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet, 700 W)
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
SERVE_STEPS, SERVE_MIX = 4, 2


def emit(rec):
    print(json.dumps(rec), flush=True)


def smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, n, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def graph_ms(torch, fn, n=10, replays=5):
    """Device ms of one ``fn()`` call: ``n`` calls captured in one CUDA
    graph, replayed, so the wrapper's host time does not hide the kernel's."""
    fn()
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return time_ms(torch, graph.replay, replays, warmup=1) / n


def sm_clock_mhz():
    """The card's SM clock now, in MHz (``nvidia-smi``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.split()[0])


def attention_bound_ms(B, H, S, Sk, kv_len, D, bias):
    """Least time for one forward: the larger of 4*B*H*S*kv_len*D FLOP at
    the bf16 peak and (q, k, v, bias read once, o written once) bytes at the
    HBM rate.  Keys past kv_len are never visited, so they count no work."""
    flop = 4 * B * H * S * kv_len * D
    nbytes = 2 * B * H * D * (2 * S + 2 * Sk) + (4 * B * Sk if bias else 0)
    by_ops, by_bytes = flop / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(by_ops, by_bytes) * 1e3, ("operations" if by_ops >= by_bytes else "bytes")


# ptxas report lines kept in the build record: registers, spills, the
# function being compiled, and any wgmma serialisation or performance warning
PTXAS_KEEP = ("registers", "spill", "Compiling", "wgmma", "Performance Loss", "serializ")


def check_ptxas(report, kernel):
    """Raise unless ptxas compiled ``kernel`` (a substring of its mangled
    name) with no spill and no wgmma serialisation or performance-loss
    warning.  Warnings that name a function are charged to it, others to the
    function being compiled when they appear."""
    lines, cur = {}, None
    for ln in report.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            cur = m.group(1)
            continue
        named = re.search(r"(?:for|function) '?(_Z\w+)", ln)
        key = named.group(1) if named else cur
        if key is not None and any(w in ln for w in PTXAS_KEEP):
            lines.setdefault(key, []).append(ln.strip())
    mine = {n: ls for n, ls in lines.items() if kernel in n}
    bad = [ln for ls in mine.values() for ln in ls
           if "Performance Loss" in ln or "serializ" in ln
           or re.search(r"[1-9]\d* bytes spill", ln)]
    emit({"phase": "ptxas_check", "kernel": kernel, "functions": len(mine),
          "findings": bad, "ok": bool(mine) and not bad})
    if not mine or bad:
        raise AssertionError(f"ptxas: {kernel} missing from the report, or it spills or "
                             f"serialises wgmma: {bad}")


def check_attention(torch, FA, F, dev, B, H, S, Sk, D, *, layout="bhsd", mask=False,
                    kv_valid=None, timed=False, seed=0, plain_heads=None):
    """Kernel vs plain version on one shape, bf16; raises on disagreement.
    ``mask``: True draws a random (B, Sk) key mask; a tensor is that mask.
    ``plain_heads``: run the plain version that many heads at a time
    (``by_heads``; no mask, bhsd), where its f32 scores would not fit whole.

    With unit-normal q, k, v an output entry averages about n = kv_len keys
    and has a standard deviation near sqrt(e/n) (0.024 at n = 4608).  The
    tolerance sits a few bf16 ulps above what rounding p to bf16 in another
    order gives (both versions round p before P.V):
    |kernel - plain| <= 0.15/sqrt(n) + 1e-2*|plain| elementwise (2.2e-3 at
    n = 4608), and ||kernel - plain|| / ||plain|| <= 5e-3 (an emulation of
    the kernel's tile order in f32 gives 2.3e-3 at n = 2537)."""
    g = torch.Generator(dev).manual_seed(seed)
    shp = (lambda s: (B, s, H, D)) if layout == "bshd" else (lambda s: (B, H, s, D))
    q, k, v = (torch.randn(shp(s), generator=g, device=dev).bfloat16() for s in (S, Sk, Sk))
    m = None if mask is False else mask
    if mask is True:
        m = torch.rand((B, Sk), generator=g, device=dev) > 0.3
        m[:, 0] = True
    got = FA.flash_attention(q, k, v, mask=m, layout=layout, kv_valid=kv_valid)
    torch.cuda.synchronize()
    plain = FA.flash_attention_reference if plain_heads is None else by_heads(
        torch, FA.flash_attention_reference, plain_heads)
    want = plain(q, k, v, mask=m, layout=layout, kv_valid=kv_valid)
    kv_len = kv_valid or Sk
    diff = got.float() - want.float()
    err = diff.abs().max().item()
    rel = (diff.norm() / want.float().norm()).item()
    atol = 0.15 / kv_len ** 0.5
    ok = bool(torch.isfinite(got).all()) and rel <= 5e-3 and bool(
        (diff.abs() <= atol + 1e-2 * want.float().abs()).all())
    rec = {"phase": "kernel_check", "kernel": FA.KERNEL, "B": B, "H": H, "S": S,
           "Sk": Sk, "D": D, "layout": layout, "mask": m is not None,
           "masked_keys": None if m is None else int((~m).sum()), "kv_valid": kv_valid,
           "dtype": "bfloat16", "max_abs_err": err, "atol": atol, "rel_l2": rel,
           "plain_heads": plain_heads, "ok": ok}
    if timed:
        qs = FA._scaled_q(q)
        kbias = None if m is None else FA._key_bias(m, B, Sk)
        rec["ms"] = time_ms(torch, lambda: FA.flash_attn_fwd(
            qs, k, v, kbias=kbias, kv_len=kv_len, layout=layout), 20)
        rec["plain_ms"] = time_ms(torch, lambda: plain(
            q, k, v, mask=m, layout=layout, kv_valid=kv_valid), 1 if plain_heads else 3,
            warmup=1)
        # the keys the data leaves valid are the least work (the most of any row)
        kv_need = kv_len if m is None else int(m.sum(dim=1).max())
        rec["bound_ms"], rec["bound_by"] = attention_bound_ms(
            B, H, S, Sk, kv_need, D, m is not None)
        qt, kt, vt = ((t.transpose(1, 2) if layout == "bshd" else t) for t in (q, k, v))
        amask = None
        if kv_valid is not None:
            amask = (torch.arange(Sk, device=dev) < kv_valid)[None, None, None, :]
        elif m is not None:
            amask = m[:, None, None, :]
        rec["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=amask), 20)
        rec["library"] = "torch.nn.functional.scaled_dot_product_attention"
    emit(rec)
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {rec}")
    return rec


def close_bf16(got, want, rel_lim=1e-2, frac=5e-2, zero_atol=1e-4):
    """(ok, max_abs_err, rel_l2) of a kernel's bf16 output against its plain
    version: relative L2 <= ``rel_lim`` and |got - want| <= ``frac`` *
    max|want| everywhere.  Both versions round p and ds to bf16 before their
    products, and the outputs to bf16; the residue is p rounding to another
    bf16 neighbour after exp and sums in another order (a few ulps on some
    terms), so the expected relative L2 is a few 1e-3, as in the forward.

    Where the plain version is itself no larger than ``zero_atol`` (dk with
    a single key: a softmax over one key has no gradient, and ds = p (dp -
    delta) is the difference of two equal sums of D products), both are
    f32 rounding noise (about D * 2^-24 * |q|, some 1e-7) with no relative
    error, so |got - want| <= ``zero_atol``."""
    diff = got.float() - want.float()
    err = diff.abs().max().item()
    scale = want.float().abs().max().item()
    if scale <= zero_atol:
        return bool(got.isfinite().all()) and err <= zero_atol, err, 0.0
    rel = (diff.norm() / want.float().norm()).item()
    ok = bool(got.isfinite().all()) and rel <= rel_lim and err <= frac * scale
    return ok, err, rel


def batch_chunks(torch, fn, B, cb, *tensors):
    """``fn`` over batch slices of at most ``cb`` rows (each plain score
    tensor is B x H x S x Sk f32: 7.5 GB at B = 12, S = 2560), outputs
    concatenated along the batch axis."""
    parts = [fn(*[None if t is None else t[b0:b0 + cb] for t in tensors])
             for b0 in range(0, B, cb)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat([p[i] for p in parts]) for i in range(len(parts[0])))
    return torch.cat(parts)


def train_bound_ms(kind, B, H, S, Sk, kv_len, D, bias):
    """Least time for one call of a training kernel: the larger of its
    products (2*B*H*S*kv_len*D FLOP each: 2 for the forward, 5 fused, 4 dkv,
    3 dq) at the bf16 peak and its bytes (each input read once, each output
    written once) at the HBM rate."""
    prods = {"flash_attn_fwd_lse": 2, "flash_attn_bwd_fused": 5,
             "flash_attn_bwd_dkv": 4, "flash_attn_bwd_dq": 3}[kind]
    flop = prods * 2 * B * H * S * kv_len * D
    row_q, row_k = 2 * B * H * S * D, 2 * B * H * Sk * D  # one bf16 tensor
    lse, kb = 4 * B * H * S, (4 * B * Sk if bias else 0)
    nbytes = {"flash_attn_fwd_lse": row_q + 2 * row_k + kb + row_q + lse,
              "flash_attn_bwd_fused": 3 * row_q + 2 * row_k + lse + kb + row_q + 2 * row_k,
              "flash_attn_bwd_dkv": 3 * row_q + 2 * row_k + lse + kb + 2 * row_k,
              "flash_attn_bwd_dq": 3 * row_q + 2 * row_k + lse + kb + row_q}[kind]
    by_ops, by_bytes = flop / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(by_ops, by_bytes) * 1e3, ("operations" if by_ops >= by_bytes else "bytes")


BWD_KERNELS = ("flash_attn_bwd_fused", "flash_attn_bwd_dkv", "flash_attn_bwd_dq")


def check_training_kernels(torch, FA, F, dev, B, H, S, Sk, D, *, layout="bhsd",
                           mask=False, kv_valid=None, timed=(), seed=0, cb=None,
                           backward=BWD_KERNELS):
    """The forward with lse and the backward kernels named in ``backward``
    (default: the fused one and the split pair, dkv and dq) against their
    plain versions on one bf16 shape; raises on disagreement.  Each backward
    kernel gets the kernel forward's o and lse, as does its plain version,
    so each comparison isolates one kernel.  Tolerances: o as in
    ``check_attention``; lse within 1e-3 (f32, exp approximated by
    ex2.approx); dq, dk, dv by ``close_bf16``.  The backward kernels write
    with no atomics, so a second launch on the same inputs must give
    identical outputs (``repeat_identical``), except fused's dq, whose key
    blocks add in another order: it must be within ``close_bf16`` of its
    first.  ``timed`` names the kernels to time at this shape, each with the
    SM clock sampled right after; ``backward=()`` checks the forward with
    lse alone."""
    g = torch.Generator(dev).manual_seed(seed)
    shp = (lambda s: (B, s, H, D)) if layout == "bshd" else (lambda s: (B, H, s, D))
    q, k, v = (torch.randn(shp(s), generator=g, device=dev).bfloat16() for s in (S, Sk, Sk))
    do = torch.randn(shp(S), generator=g, device=dev).bfloat16()
    kbias = None
    if mask:
        m = torch.rand((B, Sk), generator=g, device=dev) > 0.3
        m[:, 0] = True
        kbias = FA._key_bias(m, B, Sk)
    kv_len = kv_valid or Sk
    cb = cb or B
    qs = FA._scaled_q(q)
    base = {"phase": "kernel_check", "B": B, "H": H, "S": S, "Sk": Sk, "D": D,
            "layout": layout, "mask": mask, "kv_valid": kv_valid, "dtype": "bfloat16"}
    recs = {}

    fwd_ref = lambda q_, k_, v_, b_: FA.flash_attention_fwd_lse_reference(
        q_, k_, v_, kbias=b_, kv_len=kv_len, layout=layout)
    o, lse = FA.flash_attn_fwd_lse(qs, k, v, kbias=kbias, kv_len=kv_len, layout=layout)
    torch.cuda.synchronize()
    o_ref, lse_ref = batch_chunks(torch, fwd_ref, B, cb, qs, k, v, kbias)
    diff = o.float() - o_ref.float()
    rel = (diff.norm() / o_ref.float().norm()).item()
    lse_err = (lse - lse_ref).abs().max().item()
    ok = (bool(o.isfinite().all()) and rel <= 5e-3 and lse_err <= 1e-3 and bool(
        (diff.abs() <= 0.15 / kv_len ** 0.5 + 1e-2 * o_ref.float().abs()).all()))
    recs["flash_attn_fwd_lse"] = dict(base, kernel="flash_attn_fwd_lse", ok=ok,
                                      max_abs_err=diff.abs().max().item(), rel_l2=rel,
                                      lse_max_abs_err=lse_err)
    del o_ref, lse_ref, diff
    if not backward:
        emit(recs["flash_attn_fwd_lse"])
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version: {recs}")
        return recs

    args = (qs, k, v, o, lse, do)
    kw = dict(kbias=kbias, kv_len=kv_len, layout=layout)
    bwd_ref = lambda q_, k_, v_, o_, l_, d_, b_: FA.flash_attention_bwd_reference(
        q_, k_, v_, o_, l_, d_, kbias=b_, kv_len=kv_len, layout=layout)
    want = batch_chunks(torch, bwd_ref, B, cb, *args, kbias)
    launch = {"flash_attn_bwd_fused": lambda: FA.flash_attn_bwd_fused(*args, **kw),
              "flash_attn_bwd_dkv": lambda: (None, *FA.flash_attn_bwd_dkv(*args, **kw)),
              "flash_attn_bwd_dq": lambda: (FA.flash_attn_bwd_dq(*args, **kw), None, None)}
    got = {name: launch[name]() for name in backward}
    repeats = {name: launch[name]() for name in backward}
    torch.cuda.synchronize()
    for name, outs in got.items():
        rec = dict(base, kernel=name, ok=True, max_abs_err=0.0, rel_l2=0.0)
        for label, x, w in zip(("dq", "dk", "dv"), outs, want):
            if x is None:
                continue
            ok, err, rel = close_bf16(x, w)
            rec["ok"] &= ok
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["rel_l2"] = max(rec["rel_l2"], rel)
            rec[f"{label}_rel_l2"] = rel
        recs[name] = rec
    for name, again in repeats.items():
        rec = recs[name]
        fused = name == "flash_attn_bwd_fused"
        rec["repeat_identical"] = all(torch.equal(x, y) for i, (x, y) in
                                      enumerate(zip(got[name], again))
                                      if x is not None and not (fused and i == 0))
        rec["ok"] &= rec["repeat_identical"]
        if fused:
            dq_ok, rec["repeat_dq_max_abs_diff"], _ = close_bf16(again[0], got[name][0])
            rec["ok"] &= dq_ok
    del got, want, repeats

    if timed:
        bias = kbias is not None
        qt, kt, vt = ((t.transpose(1, 2) if layout == "bshd" else t).detach()
                      for t in (q, k, v))
        amask = None
        if kv_valid is not None:
            amask = (torch.arange(Sk, device=dev) < kv_valid)[None, None, None, :]
        elif bias:
            amask = (kbias == 0)[:, None, None, :]
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=amask), 10)
        qg, kg, vg = (t.clone().requires_grad_() for t in (qt, kt, vt))
        dot = do.transpose(1, 2) if layout == "bshd" else do

        def lib_fwd_bwd():
            out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=amask)
            torch.autograd.grad(out, (qg, kg, vg), dot)

        def lib_fwd_graph():
            F.scaled_dot_product_attention(qg, kg, vg, attn_mask=amask)

        lib_bwd = time_ms(torch, lib_fwd_bwd, 5) - time_ms(torch, lib_fwd_graph, 5)
        plain_fwd = time_ms(torch, lambda: batch_chunks(torch, fwd_ref, B, cb, qs, k, v, kbias),
                            1, warmup=1)
        plain_bwd = time_ms(torch, lambda: batch_chunks(torch, bwd_ref, B, cb, *args, kbias),
                            1, warmup=1)
        calls = {
            "flash_attn_fwd_lse": (lambda: FA.flash_attn_fwd_lse(qs, k, v, **kw), plain_fwd,
                                   lib_fwd),
            "flash_attn_bwd_fused": (lambda: FA.flash_attn_bwd_fused(*args, **kw), plain_bwd,
                                     lib_bwd),
            "flash_attn_bwd_dkv": (lambda: FA.flash_attn_bwd_dkv(*args, **kw), plain_bwd,
                                   lib_bwd),
            "flash_attn_bwd_dq": (lambda: FA.flash_attn_bwd_dq(*args, **kw), plain_bwd,
                                  lib_bwd),
        }
        for name in timed:
            fn, plain_ms, lib_ms = calls[name]
            rec = recs[name]
            rec["ms"] = time_ms(torch, fn, 10)
            rec["sm_clock_mhz"] = sm_clock_mhz()
            rec["plain_ms"] = plain_ms
            rec["plain"] = ("flash_attention_fwd_lse_reference" if name.endswith("lse")
                            else "flash_attention_bwd_reference (dq, dk and dv)")
            rec["bound_ms"], rec["bound_by"] = train_bound_ms(name, B, H, S, Sk, kv_len, D,
                                                              bias)
            rec["library_ms"] = lib_ms
            rec["library"] = ("scaled_dot_product_attention forward" if name.endswith("lse")
                              else "scaled_dot_product_attention backward (dq, dk and dv; "
                                   "forward+backward minus forward)")
            rec["tflops"] = ({"flash_attn_fwd_lse": 2, "flash_attn_bwd_fused": 5,
                              "flash_attn_bwd_dkv": 4, "flash_attn_bwd_dq": 3}[name]
                             * 2 * B * H * S * kv_len * D / rec["ms"] / 1e9)
    for rec in recs.values():
        emit(rec)
    bad = [r for r in recs.values() if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    return recs


def check_autograd(torch, FA, dev, bwd, layout="bhsd"):
    """``flash_attention`` under autograd on the card (lse forward, then the
    ``bwd`` kernels, then the multiply of the softmax scale) against the
    plain forward and backward on the same inputs, dq scaled the same way;
    tolerance of ``close_bf16``."""
    B, H, S, D, kv_valid = 2, 4, 300, 128, 290
    g = torch.Generator(dev).manual_seed(21)
    shp = (B, S, H, D) if layout == "bshd" else (B, H, S, D)
    q, k, v, do = (torch.randn(shp, generator=g, device=dev).bfloat16() for _ in range(4))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    before = {n: f.launches for n, f in FA.KERNEL_WRAPPERS.items()}
    out = FA.flash_attention(qg, kg, vg, layout=layout, kv_valid=kv_valid, bwd=bwd)
    out.backward(do)
    torch.cuda.synchronize()
    used = {n: f.launches - before[n] for n, f in FA.KERNEL_WRAPPERS.items()}
    qs = FA._scaled_q(q)
    o, lse = FA.flash_attention_fwd_lse_reference(qs, k, v, kv_len=kv_valid, layout=layout)
    dqs, dk, dv = FA.flash_attention_bwd_reference(qs, k, v, o, lse, do, kv_len=kv_valid,
                                                   layout=layout)
    dq = dqs * torch.tensor(1.0 / D ** 0.5, dtype=q.dtype).item()
    checks = [close_bf16(x, w) for x, w in ((qg.grad, dq), (kg.grad, dk), (vg.grad, dv))]
    want_used = ({"flash_attn_fwd_lse": 1, "flash_attn_bwd_fused": 1} if bwd == "fused"
                 else {"flash_attn_fwd_lse": 1, "flash_attn_bwd_dkv": 1, "flash_attn_bwd_dq": 1})
    ok = all(c[0] for c in checks) and {n: c for n, c in used.items() if c} == want_used
    rec = {"phase": "autograd_check", "bwd": bwd, "layout": layout, "B": B, "H": H, "S": S,
           "D": D, "kv_valid": kv_valid, "launches": used,
           "rel_l2": [c[2] for c in checks], "max_abs_err": [c[1] for c in checks], "ok": ok}
    emit(rec)
    if not ok:
        raise AssertionError(f"autograd through the kernels disagrees: {rec}")


def qk_rope_inputs(torch, dev, kind, B, Lt, Li, npad, H, D, dtype, seed=11):
    """A FLUX block's projection outputs (the double block's txt and img qkv,
    or the single block's ``linear1`` view, row stride 7HD), scales near 1 and
    RoPE tables over [text | image | pad]: zero text ids, identity pad rows."""
    import numpy as np

    from mixgrpo_tpu_torch.models.flux.rope import rope_tables

    g = torch.Generator(dev).manual_seed(seed)
    S = Lt + Li
    ids = np.zeros((S, 3), np.float32)
    ids[Lt:S - npad, 1:] = np.random.default_rng(seed).integers(0, 64, (Li - npad, 2))
    third = D // 8 * 2
    cos, sin = rope_tables(ids, (D - 2 * third, third, third), device=dev)
    cos[S - npad:], sin[S - npad:] = 1.0, 0.0
    rand = lambda *s: (2 * torch.randn(s, generator=g, device=dev)).to(dtype)
    if kind == "double":
        sources = [rand(B, Lt, 3 * H * D), rand(B, Li, 3 * H * D)]
    else:
        sources = [rand(B, S, 7 * H * D)[..., : 3 * H * D]]
    scale = lambda: (1 + 0.2 * torch.randn(D, generator=g, device=dev)).to(dtype)
    return sources, [scale() for _ in sources], [scale() for _ in sources], cos, sin


def qk_pair_error(got, want):
    """max |got - want| over eps x the larger |entry| of each rotated pair of
    ``want``, eps the dtype's: the QK-norm + RoPE forward keeps the plain
    version's roundings, and only the row's sum of squares runs in another
    order, which can move a normalised entry to its neighbour; the rotation
    spreads that over both entries of a pair (at most one eps of each and
    of the rounded result)."""
    import torch

    w = want.float().unflatten(-1, (-1, 2))
    pair = w.abs().amax(dim=-1, keepdim=True).expand_as(w).flatten(-2)
    ratio = (got.float() - want.float()).abs() / pair.clamp_min(1e-30)
    return ratio.max().item() / torch.finfo(want.dtype).eps


def check_qk_rope(torch, dev, card, kind, B, Lt, Li, npad, *, H=24, D=128, layout="bhsd",
                  dtype=None, timed=False):
    """The QK-norm + RoPE kernels against their plain version on the same
    card tensors: the forward's q and k within 4 eps x the larger |entry| of
    each rotated pair (only the rsqrt's sum runs in another order), v bit for
    bit; the backward (every scale trainable) against autograd through the
    plain version (``close_bf16``; d(scale) relative L2 <= 2e-2).  Timed:
    each kernel, the plain version (the backward: autograd's backward alone)
    and the bound, its bytes at the HBM peak (forward: q, k, v read and
    written once and the f32 tables; backward: dq, dk, dv, x_q and x_k read,
    d(qkv) written, the tables and the stored rsqrt)."""
    from mixgrpo_tpu_torch.ops import qk_rope as QR

    dtype = dtype or torch.bfloat16
    sources, qs, ks, cos, sin = qk_rope_inputs(torch, dev, kind, B, Lt, Li, npad, H, D, dtype)
    if layout == "bshd":
        cos, sin = cos[:, None, :], sin[:, None, :]
    S = Lt + Li
    args = (cos, sin, 1e-6, H, layout)
    with torch.no_grad():
        got = QR.qk_rope(sources, qs, ks, *args)
        want = QR.qk_rope_reference(sources, qs, ks, *args)
    torch.cuda.synchronize()
    fwd_err = max(qk_pair_error(a, b) for a, b in zip(got[:2], want[:2]))
    ok = (torch.equal(got[2], want[2]) and fwd_err <= 4
          and all(bool(torch.isfinite(a).all()) for a in got[:2]))
    leaves = [t.detach().requires_grad_() for t in (*sources, *qs, *ks)]
    n = len(sources)
    gen = torch.Generator(dev).manual_seed(12)
    douts = [torch.randn(t.shape, generator=gen, device=dev).to(dtype) for t in got]
    outs = QR.qk_rope(leaves[:n], leaves[n:2 * n], leaves[2 * n:], *args)
    dgot = torch.autograd.grad(outs, leaves, douts)
    plain_outs = QR.qk_rope_reference(leaves[:n], leaves[n:2 * n], leaves[2 * n:], *args)
    dwant = torch.autograd.grad(plain_outs, leaves, douts, retain_graph=timed)
    checks = [close_bf16(a, b) for a, b in zip(dgot[:n], dwant[:n])]
    scale_rel = max(((a.float() - b.float()).norm() / b.float().norm()).item()
                    for a, b in zip(dgot[n:], dwant[n:]))
    ok = ok and all(c[0] for c in checks) and scale_rel <= 2e-2
    rec = {"phase": "qk_rope_check", "kind": kind, "B": B, "H": H, "S": S, "L_txt": Lt,
           "pad_rows": npad, "D": D, "layout": layout, "dtype": str(dtype).split(".")[-1],
           "fwd_max_err_eps_of_pair": fwd_err, "bwd_rel_l2": [c[2] for c in checks],
           "bwd_max_abs_err": [c[1] for c in checks], "dscale_rel_l2": scale_rel, "ok": ok}
    if timed:
        item, rows = torch.finfo(dtype).bits // 8, B * S * H * D
        tables = 2 * S * D * 4
        with torch.no_grad():
            rec["fwd_ms"] = graph_ms(torch, lambda: QR.qk_rope(sources, qs, ks, *args))
            rec["fwd_plain_ms"] = time_ms(torch, lambda: QR.qk_rope_reference(
                sources, qs, ks, *args), 5)
            _, _, _, rq, rk = QR.qk_rope_fwd(sources, qs, ks, cos, sin, 1e-6, H, layout,
                                             with_rstd=True)
            rec["bwd_ms"] = graph_ms(torch, lambda: QR.qk_rope_bwd(
                sources, qs, ks, cos, sin, rq, rk, *douts, H, layout))
            rec["bwd_scale_ms"] = graph_ms(torch, lambda: QR.qk_rope_bwd(
                sources, qs, ks, cos, sin, rq, rk, *douts, H, layout, want_scale=True))
        rec["bwd_plain_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            plain_outs, leaves, douts, retain_graph=True), 5)
        rec["fwd_bound_ms"] = (6 * rows * item + tables) / PEAK_HBM_BYTES * 1e3
        rec["bwd_bound_ms"] = (8 * rows * item + tables + 2 * B * H * S * 4) \
            / PEAK_HBM_BYTES * 1e3
        rec["bound_by"] = "bytes"
        rec["sm_clock_mhz"] = sm_clock_mhz()
        rec["device"] = card
    emit(rec)
    if not ok:
        raise AssertionError(f"QK-norm + RoPE kernels disagree with their plain version: {rec}")
    return rec


def reset_launches(FA):
    """Count every hand-written kernel's launches from 0: the flash kernels'
    and the QK-norm + RoPE kernels'."""
    from mixgrpo_tpu_torch.ops import qk_rope as QR

    FA.reset_launches()
    QR.reset_launches()


def check_launches(FA, path, launches, per_call, dit_calls, flux_blocks=True):
    """One path's kernel launches, counted from 0 just before it ran, must be
    one forward without lse per DiT block per DiT call, and nothing else: the
    sampling paths take no gradient.  Where the blocks are the FLUX blocks
    (FLUX and HunyuanVideo; not Mochi), each one also takes its q, k and v
    from one QK-norm + RoPE forward launch."""
    from mixgrpo_tpu_torch.ops import qk_rope as QR

    others = {n: f.launches for n, f in FA.KERNEL_WRAPPERS.items() if n != "flash_attn_fwd"}
    qk = {n: f.launches for n, f in QR.KERNEL_WRAPPERS.items()}
    qk_want = {"qk_rope_fwd": per_call * dit_calls if flux_blocks else 0, "qk_rope_bwd": 0}
    emit({"phase": "launch_count", "path": path, "kernel": FA.KERNEL,
          "launches": launches, "dit_calls": dit_calls, "expected": per_call * dit_calls,
          "other_kernels": others, "qk_rope": qk, "qk_rope_expected": qk_want})
    if launches != per_call * dit_calls or any(others.values()) or qk != qk_want:
        raise AssertionError(f"{path}: {launches} launches != {per_call} x {dit_calls} "
                             f"DiT calls, or other kernels launched: {others}, or QK-norm + "
                             f"RoPE launches {qk} != {qk_want}")


def encode_fn_for(cfg, text_len):
    """Stand-in for the T5/CLIP encoders until they are ported: a stable
    crc32 seed per prompt draws (text_len, context_dim) text embeddings and
    a (pooled_dim,) pooled embedding."""
    import numpy as np

    def encode(prompts):
        rngs = [np.random.default_rng(zlib.crc32(p.encode())) for p in prompts]
        txt = np.stack([r.standard_normal((text_len, cfg.context_dim), np.float32)
                        for r in rngs])
        pooled = np.stack([r.standard_normal((cfg.pooled_dim,), np.float32) for r in rngs])
        return txt, pooled

    return encode


def post(port, payload, timeout=900):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = r.read()
        status, ctype = r.status, r.headers.get("Content-Type")
    return status, ctype, body, time.perf_counter() - t0


def device_kernels(prof):
    """(name, device ms, count) of every CUDA kernel a ``torch.profiler``
    run recorded."""
    kernels = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and str(e.device_type).endswith("CUDA"):
            kernels.append((e.key, us / 1e3, e.count))
    return kernels


def profile_split(torch, FA, dev, card, B=2, H=24, S=4608, D=128, calls=3):
    """Device time per call of each kernel the split backward launches at the
    1024px update's shape (torch.profiler): the stats pre-pass, which dkv and
    dq each run, dq's key-term pre-pass, and the two main kernels."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(dev).manual_seed(41)
    q, k, v, do = (torch.randn((B, H, S, D), generator=g, device=dev).bfloat16()
                   for _ in range(4))
    qs = FA._scaled_q(q)
    o, lse = FA.flash_attn_fwd_lse(qs, k, v)
    args = (qs, k, v, o, lse, do)
    FA.flash_attn_bwd_dkv(*args)  # warm-up
    FA.flash_attn_bwd_dq(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            FA.flash_attn_bwd_dkv(*args)
            FA.flash_attn_bwd_dq(*args)
        torch.cuda.synchronize()
    ms = {}
    for name, t, _ in device_kernels(prof):
        for short in ("bwd_stats_kernel", "key_term_kernel", "flash_bwd_dq_kernel",
                      "flash_bwd_kernel"):
            if short in name:
                ms[short] = ms.get(short, 0.0) + t / calls
                break
    total = sum(ms.values())
    emit({"phase": "split_profile", "B": B, "H": H, "S": S, "D": D,
          "ms_per_call": ms or None, "split_ms": total or None,
          "prepass_share": (ms.get("bwd_stats_kernel", 0) + ms.get("key_term_kernel", 0))
          / total if total else None, "device": card})


def profile_forward(torch, M, params, cfg, dev, card):
    """Where one DiT forward's device time goes at the serving shape (B=2,
    1024px: S = 512 + 4096): torch.profiler kernel times summed by class,
    and the device's idle share of the profiled wall time.  Runs after the
    launch count is read, so its launches are not counted."""
    import numpy as np

    from mixgrpo_tpu_torch.models.flux.rope import make_image_ids, make_text_ids, rope_tables

    B, lt, lat = 2, 512, 1024 // 8
    ids = np.concatenate([make_text_ids(lt), make_image_ids(lat, lat)])
    cos, sin = rope_tables(ids, cfg.axes_dims, cfg.theta, device=dev)
    g = torch.Generator(dev).manual_seed(9)
    img = torch.randn((B, (lat // 2) ** 2, cfg.in_channels), generator=g, device=dev)
    txt = torch.randn((B, lt, cfg.context_dim), generator=g, device=dev).bfloat16()
    pooled = torch.randn((B, cfg.pooled_dim), generator=g, device=dev).bfloat16()
    t = torch.full((B,), 0.5, device=dev)
    gs = torch.full((B,), 3.5, device=dev)

    def fwd():
        with torch.no_grad():
            M.flux_forward(params, cfg, img, txt, pooled, t, gs, cos, sin)

    profile_device(torch, "one flux_dev forward, B=2, 1024px, bf16", fwd, card, kernel_class)


def profile_device(torch, what, fn, card, classify):
    """One call of ``fn`` after a warm-up: its wall ms unprofiled, then under
    ``torch.profiler`` its profiled wall ms, the device's busy ms summed by
    ``classify(kernel name)``, its idle share of the profiled wall, and the
    ten longest kernels."""
    from torch.profiler import ProfilerActivity, profile

    def call():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    call()
    wall_ms = call()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_wall_ms = call()
    kernels = device_kernels(prof)
    classes = {}
    for name, ms, _ in kernels:
        cls = classify(name)
        classes[cls] = classes.get(cls, 0.0) + ms
    busy = sum(classes.values())
    kernels.sort(key=lambda k: -k[1])
    emit({"phase": "profile", "what": what, "wall_ms": wall_ms,
          "profiled_wall_ms": prof_wall_ms, "device_busy_ms": busy or None,
          "idle_share": (1 - busy / prof_wall_ms) if busy else None,
          "class_ms": classes or None,
          "top_kernels": [{"name": n[:90], "ms": ms, "count": c} for n, ms, c in kernels[:10]],
          "device": card})


def kernel_phase(torch, FA, F, dev, card, rows):
    """Every kernel against its plain version: small ragged shapes (D 32, 64,
    128; both layouts; a key mask; kv_valid; S != Sk) and the tile edges of
    the forward (with and without lse) and of the three backward kernels,
    then the shapes of the main paths, timed: the forward without lse at the
    serving shape (B=2, S=4608), the forward with lse and the fused backward
    at the 720px update (B=12, S=2560, kv_valid 2537), dkv and dq at the
    1024px update (B=2, S=4608), and at both updates the fused kernel beside
    the split pair (dkv, dq); the device time of each kernel of the split
    pair at 1024px (``profile_split``); then autograd through the kernels on
    the card."""
    for D in (32, 64, 128):
        for kw in (dict(B=1, H=2, S=100, Sk=77), dict(B=2, H=3, S=130, Sk=201, layout="bshd"),
                   dict(B=1, H=2, S=130, Sk=200, mask=True),
                   dict(B=1, H=2, S=129, Sk=150, kv_valid=101),
                   dict(B=2, H=2, S=97, Sk=97, layout="bshd", kv_valid=64)):
            kw = dict(kw)
            B, H, S, Sk = (kw.pop(n) for n in ("B", "H", "S", "Sk"))
            check_attention(torch, FA, F, dev, B, H, S, Sk, D, **kw)
            check_training_kernels(torch, FA, F, dev, B, H, S, Sk, D, **kw)
        # the tile edges of the forward (128-row q tiles, 128-key tiles), of
        # dkv and fused (128-key blocks, 64-row q tiles) and of dq (128-row
        # q blocks of two 64-row warpgroups, 64-key tiles): one query row,
        # one key, fewer keys than a tile, kv_valid one key into a tile (129,
        # 65), S not a multiple of the q tile (65: dq's second warpgroup has
        # one row; fused: dq rows past S never written), dq's second
        # warpgroup wholly past S (64), key blocks wholly past kv_valid
        # (zeros out)
        for kw in (dict(B=1, H=2, S=1, Sk=77), dict(B=1, H=1, S=1, Sk=1),
                   dict(B=2, H=2, S=65, Sk=40, layout="bshd"),
                   dict(B=2, H=2, S=65, Sk=40, mask=True),
                   dict(B=1, H=2, S=70, Sk=200, kv_valid=129),
                   dict(B=2, H=3, S=191, Sk=130, layout="bshd", kv_valid=65),
                   dict(B=1, H=2, S=100, Sk=300, mask=True),
                   dict(B=2, H=2, S=129, Sk=300, kv_valid=100),
                   dict(B=2, H=2, S=64, Sk=193, mask=True)):
            kw = dict(kw)
            B, H, S, Sk = (kw.pop(n) for n in ("B", "H", "S", "Sk"))
            check_attention(torch, FA, F, dev, B, H, S, Sk, D, **kw)
            check_training_kernels(torch, FA, F, dev, B, H, S, Sk, D, **kw)
    full = []
    for B in (1, 2):
        for S, kv_valid in ((1536, None), (2560, 2537), (4608, None)):
            full.append(check_attention(torch, FA, F, dev, B, 24, S, S, 128,
                                        kv_valid=kv_valid, timed=True))
    full.append(check_attention(torch, FA, F, dev, 2, 24, 4608, 4608, 128,
                                layout="bshd", timed=True))
    # HunyuanVideo at 192x336, 129 frames: S = 256 + 8316 = 8572 run as 8576,
    # the joint key mask of its text (40 of 256 tokens kept: key tile 1 wholly
    # masked) and of the 4 pad keys
    hv = torch.ones((1, 8576), dtype=torch.bool, device=dev)
    hv[:, 40:256] = False
    hv[:, 8572:] = False
    full.append(check_attention(torch, FA, F, dev, 1, 24, 8576, 8576, 128, mask=hv,
                                timed=True))
    # Mochi's final block at 480x848, 37 frames: 11,130 visual queries over
    # 11,386 visual + text keys, no mask
    full.append(check_attention(torch, FA, F, dev, 1, 24, 11130, 11386, 128, timed=True))
    # Mochi's first block at 163 frames: S = Sk = 44,776, no mask; the plain
    # version one head at a time (8.0 GB of f32 scores a head)
    full.append(check_attention(torch, FA, F, dev, 1, 24, 44776, 44776, 128, timed=True,
                                plain_heads=1))
    main_shape = next(r for r in full if r["B"] == 2 and r["S"] == 4608
                      and r["layout"] == "bhsd")
    rows["flash_attn_fwd"] = dict(main_shape, max_abs_err=max(r["max_abs_err"] for r in full))
    t720 = check_training_kernels(torch, FA, F, dev, 12, 24, 2560, 2560, 128, kv_valid=2537,
                                  timed=("flash_attn_fwd_lse", *BWD_KERNELS), cb=2)
    t1024 = check_training_kernels(torch, FA, F, dev, 2, 24, 4608, 4608, 128,
                                   timed=BWD_KERNELS, cb=1)
    # measurement only: default_bwd takes JAX's choice whatever these say
    for recs, B, S, kv_valid in ((t720, 12, 2560, 2537), (t1024, 2, 4608, None)):
        ms = {name: recs[name]["ms"] for name in BWD_KERNELS}
        emit({"phase": "fused_vs_split", "B": B, "H": 24, "S": S, "kv_valid": kv_valid,
              "D": 128, "fused_ms": ms["flash_attn_bwd_fused"],
              "dkv_ms": ms["flash_attn_bwd_dkv"], "dq_ms": ms["flash_attn_bwd_dq"],
              "split_ms": ms["flash_attn_bwd_dkv"] + ms["flash_attn_bwd_dq"],
              "default_bwd": FA.default_bwd(S, S)})
    # each kernel's row is at its main path's shape: the lse forward and
    # fused at 720px, dkv and dq at 1024px
    for name, recs in (("flash_attn_fwd_lse", t720), ("flash_attn_bwd_fused", t720),
                       ("flash_attn_bwd_dkv", t1024), ("flash_attn_bwd_dq", t1024)):
        rows[name] = dict(recs[name])
    del t720, t1024
    # parallel_tp's shape: the 720px update's batch of one prompt on 12 of the
    # 24 heads (tp = 2)
    tp_shape = dict(kv_valid=2537, seed=7)
    tp_recs = check_training_kernels(torch, FA, F, dev, 2, 12, 2560, 2560, 128, **tp_shape)
    tp_recs["flash_attn_fwd"] = check_attention(torch, FA, F, dev, 2, 12, 2560, 2560, 128,
                                                **tp_shape)
    for name, rec in tp_recs.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], rec["max_abs_err"])
    profile_split(torch, FA, dev, card)
    for bwd in ("fused", "split"):
        for layout in ("bhsd", "bshd"):
            check_autograd(torch, FA, dev, bwd, layout)
    # QK-norm + RoPE: small shapes at every head dim, both layouts and dtypes,
    # then the main paths' blocks, timed: FLUX at 720px (B = 2, 512 text +
    # 2025 image tokens padded to 2560) and HunyuanVideo at 192x336, 129
    # frames (B = 1, 256 text + 8316 video tokens padded to 8576)
    for D, layout, dtype in ((32, "bshd", torch.bfloat16), (64, "bhsd", torch.bfloat16),
                             (64, "bhsd", torch.float32), (32, "bshd", torch.float32)):
        for kind in ("double", "single"):
            check_qk_rope(torch, dev, card, kind, 2, 7, 130, 3, H=3, D=D, layout=layout,
                          dtype=dtype)
    qk = [check_qk_rope(torch, dev, card, kind, B, Lt, Li, npad, layout=layout, timed=True)
          for kind in ("double", "single")
          for B, Lt, Li, npad, layout in ((2, 512, 2048, 23, "bhsd"), (1, 256, 8320, 4, "bhsd"),
                                          (2, 512, 2048, 23, "bshd"))]
    for name, key in (("qk_rope_fwd", "fwd"), ("qk_rope_bwd", "bwd")):
        main = qk[0]  # the FLUX double block at 720px
        rows[name] = {"ms": main[f"{key}_ms"], "plain_ms": main[f"{key}_plain_ms"],
                      "bound_ms": main[f"{key}_bound_ms"], "bound_by": "bytes",
                      "library_ms": None,
                      "max_abs_err": max(max(r["bwd_max_abs_err"]) for r in qk)
                      if key == "bwd" else max(r["fwd_max_err_eps_of_pair"] for r in qk),
                      "shapes": [{k: r[k] for k in ("kind", "B", "S", "layout", f"{key}_ms",
                                                    f"{key}_plain_ms", f"{key}_bound_ms")}
                                 for r in qk]}


def serve_phase(torch, FA, F, M, dev, card, rows):
    """The serving path of the first slice at full FLUX.1-dev width and
    depth (see the module docstring), its launch counts (only the forward
    without lse may run there), and the profile of one forward."""
    import numpy as np
    from PIL import Image

    from mixgrpo_tpu_torch.models.flux.rope import make_image_ids, make_text_ids, rope_tables
    from mixgrpo_tpu_torch.models.flux.vae import VAEConfig, init_vae_decoder
    from mixgrpo_tpu_torch.sample import DualFluxPipeline
    from mixgrpo_tpu_torch.serve import InferenceServer, RequestBatcher, make_generate_fn

    # -- the model path through the kernel vs the plain attention path ---------
    tiny = M.FluxConfig.tiny()
    tw = [M.init_flux(tiny, generator=torch.Generator(dev).manual_seed(s), device=dev,
                      dtype=torch.bfloat16) for s in (10, 11)]
    z0 = torch.randn((2, 16, tiny.in_channels), generator=torch.Generator(dev).manual_seed(3),
                     device=dev)
    txt = torch.randn((2, 24, tiny.context_dim), device=dev).bfloat16()
    pooled = torch.randn((2, tiny.pooled_dim), device=dev).bfloat16()
    outs = {}
    for impl in ("flash", "eager"):
        pipe = DualFluxPipeline(tiny, tw[0], tw[1], height=64, width=64, num_steps=4,
                                mix_sampling_steps=2, text_len=24, attn_impl=impl,
                                device=dev)
        outs[impl] = pipe(txt, pooled, z0=z0).float()
    rel = ((outs["flash"] - outs["eager"]).norm() / outs["eager"].norm()).item()
    emit({"phase": "reference", "what": "tiny DualFluxPipeline latents, bf16, "
          "kernel vs eager attention", "rel_l2": rel, "limit": 2e-2})
    if not (rel < 2e-2 and bool(torch.isfinite(outs["flash"]).all())):
        raise AssertionError(f"tiny pipeline: kernel path vs plain path rel_l2={rel}")
    del tw, outs, pipe

    # -- full-width weights ------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    cfg, vcfg = M.FluxConfig.flux_dev(), VAEConfig.flux_dev()
    t0 = time.perf_counter()
    base = M.init_flux(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev,
                       dtype=torch.bfloat16)
    tuned = M.init_flux(cfg, generator=torch.Generator(dev).manual_seed(1), device=dev,
                        dtype=torch.bfloat16)
    vae = init_vae_decoder(vcfg, generator=torch.Generator(dev).manual_seed(2),
                           device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    emit({"phase": "weights", "flux_params_each": M.param_count(base),
          "vae_params": M.param_count(vae), "dtype": "bfloat16",
          "seconds": time.perf_counter() - t0,
          "allocated_gb": torch.cuda.memory_allocated() / 1e9, "device": card})

    # full width and depth at 256px (S = 512 + 256): kernel vs eager attention
    lt, lat = 512, 256 // 8
    ids = np.concatenate([make_text_ids(lt), make_image_ids(lat, lat)])
    cos, sin = rope_tables(ids, cfg.axes_dims, cfg.theta, device=dev)
    g = torch.Generator(dev).manual_seed(5)
    img = torch.randn((1, (lat // 2) ** 2, cfg.in_channels), generator=g, device=dev)
    txt = torch.randn((1, lt, cfg.context_dim), generator=g, device=dev).bfloat16()
    pooled = torch.randn((1, cfg.pooled_dim), generator=g, device=dev).bfloat16()
    t = torch.full((1,), 0.5, device=dev)
    gs = torch.full((1,), 3.5, device=dev)
    with torch.no_grad():
        v_flash = M.flux_forward(base, cfg, img, txt, pooled, t, gs, cos, sin,
                                 attn_impl="flash")
        v_eager = M.flux_forward(base, cfg, img, txt, pooled, t, gs, cos, sin,
                                 attn_impl="eager")
    rel = ((v_flash - v_eager).norm() / v_eager.norm()).item()
    emit({"phase": "reference", "what": "flux_dev forward at 256px, bf16, kernel vs "
          "eager attention", "rel_l2": rel, "limit": 5e-2,
          "finite": bool(torch.isfinite(v_flash).all())})
    if not (rel < 5e-2 and bool(torch.isfinite(v_flash).all())):
        raise AssertionError(f"full-width forward: kernel path vs plain path rel_l2={rel}")

    # -- serve ---------------------------------------------------------------------
    pipe = DualFluxPipeline(cfg, base, tuned, vae_cfg=vcfg, vae_params=vae,
                            height=1024, width=1024, num_steps=SERVE_STEPS,
                            mix_sampling_steps=SERVE_MIX, dtype=torch.bfloat16,
                            device=dev)
    encode = encode_fn_for(cfg, 512)
    gen = make_generate_fn(pipe, encode)
    finite = []

    def generate(prompts, seeds):
        images = gen(prompts, seeds)
        finite.append(bool(np.isfinite(images).all()))
        return images

    t0 = time.perf_counter()
    warm = generate(["warm-up prompt", "warm-up prompt 2"], [100, 101])
    torch.cuda.synchronize()
    emit({"phase": "warmup", "batch": 2, "seconds": time.perf_counter() - t0,
          "shape": list(warm.shape), "device": card})

    reset_launches(FA)
    torch.cuda.reset_peak_memory_stats()
    batcher = RequestBatcher(generate, batch_size=2, max_wait_ms=500.0,
                             generate_fn_single=generate)
    results = {}
    srv = InferenceServer(batcher, host="127.0.0.1", port=0).start()
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, post(srv.port, {"prompt": f"a photo of a red fox, take {i}", "seed": i})))
            for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        pair_wall = time.perf_counter() - t0
        results[2] = post(srv.port, {"prompt": "a lighthouse at dusk", "seed": 7})
        stats = dict(batcher.stats)
    finally:
        srv.stop()
    serve_launches = FA.flash_attn_fwd.launches
    serve_peak = torch.cuda.max_memory_allocated()
    per_call = cfg.depth_double + cfg.depth_single
    check_launches(FA, "serve", serve_launches, per_call, stats["batches"] * SERVE_STEPS)
    for i in range(3):
        status, ctype, body, _ = results[i]
        shape = np.asarray(Image.open(io.BytesIO(body))).shape
        if status != 200 or ctype != "image/png" or shape != (1024, 1024, 3):
            raise AssertionError(f"request {i}: {status} {ctype} {shape}")
    if not all(finite) or stats["batches"] != 2 or stats["single_dispatches"] != 1:
        raise AssertionError(f"serving: finite={finite} stats={stats}")
    emit({"phase": "serve", "resolution": 1024, "steps": SERVE_STEPS,
          "mix_sampling_steps": SERVE_MIX, "stats": stats,
          "pair_wall_s": pair_wall, "s_per_image_batched": pair_wall / 2,
          "latency_s": [results[i][3] for i in range(3)],
          "s_per_image_alone": results[2][3],
          "max_memory_allocated_gb": serve_peak / 1e9, "device": card})

    # the same (prompt, seed)s through RequestBatcher's path, as 8-bit images
    u8 = lambda img: (np.clip(img, 0, 1) * 255).astype(np.uint8)
    refs = {("warm-up prompt", 100): u8(warm[0]), ("warm-up prompt 2", 101): u8(warm[1]),
            ("a photo of a red fox, take 0", 0): png_pixels(results[0][2]),
            ("a photo of a red fox, take 1", 1): png_pixels(results[1][2]),
            ("a lighthouse at dusk", 7): png_pixels(results[2][2])}
    continuous_serve(torch, FA, dev, card, cfg, base, tuned, vae, vcfg, encode, refs,
                     [results[i][3] for i in range(3)])

    # 720px: S = 512 + 45*45 = 2537, padded to 2560 with kv_valid = 2537
    pipe720 = DualFluxPipeline(cfg, base, tuned, height=720, width=720, num_steps=2,
                               mix_sampling_steps=1, dtype=torch.bfloat16, device=dev)
    txt, pooled = encode(["a mountain lake"])
    reset_launches(FA)
    t0 = time.perf_counter()
    lat720 = pipe720(torch.as_tensor(txt, device=dev).bfloat16(),
                     torch.as_tensor(pooled, device=dev).bfloat16(),
                     generator=torch.Generator(dev).manual_seed(3))
    torch.cuda.synchronize()
    check_launches(FA, "direct_720", FA.flash_attn_fwd.launches, per_call, 2)
    ok720 = tuple(lat720.shape) == (1, 2025, 64) and bool(torch.isfinite(lat720).all())
    emit({"phase": "direct_720", "latents": list(lat720.shape), "finite": ok720,
          "seconds": time.perf_counter() - t0, "device": card})
    if not ok720:
        raise AssertionError("720px call: latents not finite or misshapen")

    profile_forward(torch, M, base, cfg, dev, card)
    rows.setdefault("flash_attn_fwd", {})["launches"] = serve_launches
    del pipe, pipe720, gen
    torch.cuda.empty_cache()
    int8_serve(torch, FA, M, dev, card, cfg, base, tuned, vae, vcfg, encode, refs)
    del base, tuned, vae, v_flash, v_eager
    torch.cuda.empty_cache()


def png_pixels(body):
    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)))


def images_close(torch, got_u8, want_u8):
    """``close_bf16`` of two 8-bit images, scaled to [0, 1]."""
    f = lambda a: torch.from_numpy(a.astype("float32") / 255.0)
    ok, err, rel = close_bf16(f(got_u8), f(want_u8))
    return {"ok": ok, "max_abs_err": err, "rel_l2": rel}


def staggered_posts(port, requests, waits):
    """POST each (prompt, seed) on its own thread once ``waits[i]()`` returns;
    {i: (status, content type, body, latency s)}, each request's start (s
    after the first thread started) and the wall."""
    results, starts = {}, {}
    t0 = time.perf_counter()

    def one(i):
        waits[i]()
        starts[i] = time.perf_counter() - t0
        prompt, seed = requests[i]
        results[i] = post(port, {"prompt": prompt, "seed": seed})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(requests))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    return results, [starts.get(i) for i in range(len(requests))], time.perf_counter() - t0


def after(seconds):
    return lambda: time.sleep(seconds)


def continuous_serve(torch, FA, dev, card, cfg, base, tuned, vae, vcfg, encode, refs,
                     request_batcher_s, res=1024):
    """Continuous batching on the serve phase's weights: ``ContinuousBatcher``
    (2 slots, one step per engine call, the latency tier) behind
    ``InferenceServer``; a burst of 4 requests (a pair 0.05 s apart, then one
    after each of the engine's first two rounds), then a lone request.  Each image must match the same (prompt, seed) through
    ``RequestBatcher`` (``refs``) within ``close_bf16``; the burst must admit
    mid-flight, move all 4 rows from the tuned pool to the base pool and
    fail none.  ``request_batcher_s`` (RequestBatcher's pair and lone
    latencies in this run) is recorded beside the burst's.  Launches,
    counted from 0 before the burst and again before
    the lone request: one forward per DiT block per DiT call, where the
    engine makes ``chunk`` DiT calls per batch and the tier ``SERVE_STEPS``
    per dispatch.  The engine's row-steps are counted: a frozen row (past
    its pool's ``t_end``, or an empty slot) is computed and discarded."""
    import numpy as np

    from mixgrpo_tpu_torch.sample import DualFluxPipeline
    from mixgrpo_tpu_torch.serve import ContinuousBatcher, InferenceServer, make_generate_fn

    pipe = DualFluxPipeline(cfg, base, tuned, vae_cfg=vcfg, vae_params=vae, height=res,
                            width=res, num_steps=SERVE_STEPS, mix_sampling_steps=SERVE_MIX,
                            dtype=torch.bfloat16, max_steps_per_call=1, device=dev)
    per_call = cfg.depth_double + cfg.depth_single
    burst = [k for k in refs if k[0] != "a lighthouse at dusk"]
    row_steps = []
    torch.cuda.reset_peak_memory_stats()
    cb = ContinuousBatcher(pipe, encode, batch_size=2, single_fn=make_generate_fn(pipe, encode))
    run, chunk = cb.engine.run, cb.engine.chunk

    def counted_run(params, z, txt, pooled, offsets, t_end):
        off = np.asarray(offsets)
        row_steps.append((len(off) * chunk, int(np.clip(t_end - off, 0, chunk).sum())))
        return run(params, z, txt, pooled, offsets, t_end)

    cb.engine.run = counted_run
    def after_round(n):  # the burst's first pair is then n steps into its trajectory
        def wait():
            while cb.stats["rounds"] < n:
                time.sleep(0.005)
        return wait

    srv = InferenceServer(cb, host="127.0.0.1", port=0).start()
    try:
        reset_launches(FA)
        results, starts, wall = staggered_posts(
            srv.port, burst, (after(0.0), after(0.05), after_round(1), after_round(2)))
        torch.cuda.synchronize()
        burst_stats, burst_launches = dict(cb.stats), FA.flash_attn_fwd.launches
        check_launches(FA, "continuous_burst", burst_launches, per_call,
                       chunk * burst_stats["batches"]
                       + SERVE_STEPS * burst_stats["single_dispatches"])
        reset_launches(FA)
        lone = post(srv.port, {"prompt": "a lighthouse at dusk", "seed": 7})
        torch.cuda.synchronize()
        stats = dict(cb.stats)
        check_launches(FA, "continuous_lone", FA.flash_attn_fwd.launches, per_call,
                       SERVE_STEPS * (stats["single_dispatches"] - burst_stats["single_dispatches"]))
    finally:
        srv.stop()
    checks = []
    for (prompt, seed), (status, ctype, body, _) in zip(burst + [("a lighthouse at dusk", 7)],
                                                        [results[i] for i in range(4)] + [lone]):
        got = png_pixels(body) if status == 200 and ctype == "image/png" else None
        checks.append({"prompt": prompt, "seed": seed, "status": status,
                       **(images_close(torch, got, refs[(prompt, seed)]) if got is not None
                          else {"ok": False})})
    computed, live = (sum(x) for x in zip(*row_steps))
    rec = {"phase": "serve_continuous", "resolution": res, "steps": SERVE_STEPS,
           "mix_sampling_steps": SERVE_MIX, "batch_size": 2, "max_steps_per_call": chunk,
           "posted_at_s": starts, "burst_wall_s": wall,
           "latency_s": [results[i][3] for i in range(4)], "lone_latency_s": lone[3],
           "burst_stats": burst_stats, "stats": stats, "burst_launches": burst_launches,
           "launch_formula": "(depth_double + depth_single) x (chunk x batches + SERVE_STEPS"
                             " x single_dispatches)",
           "engine_calls": len(row_steps), "row_steps_computed": computed,
           "row_steps_live": live, "frozen_row_share": 1 - live / computed,
           "images_vs_request_batcher": checks,
           "request_batcher_latency_s": request_batcher_s,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9, "device": card}
    emit(rec)
    if not (burst_stats["mid_flight_admissions"] >= 1 and burst_stats["migrations"] == 4
            and burst_stats["errors"] == 0 and burst_stats["requests"] == 4
            and stats["single_dispatches"] == burst_stats["single_dispatches"] + 1
            and stats["errors"] == 0 and all(c["ok"] for c in checks)):
        raise AssertionError(f"continuous batching failed its checks: {rec}")


def serve_forward_inputs(torch, cfg, dev, B=2, res=1024, seed=9):
    """One serving DiT call's inputs at ``res`` (text length 512), bf16."""
    import numpy as np

    from mixgrpo_tpu_torch.models.flux.rope import make_image_ids, make_text_ids, rope_tables

    lt, lat = 512, res // 8
    ids = np.concatenate([make_text_ids(lt), make_image_ids(lat, lat)])
    cos, sin = rope_tables(ids, cfg.axes_dims, cfg.theta, device=dev)
    g = torch.Generator(dev).manual_seed(seed)
    img = torch.randn((B, (lat // 2) ** 2, cfg.in_channels), generator=g, device=dev)
    txt = torch.randn((B, lt, cfg.context_dim), generator=g, device=dev).bfloat16()
    pooled = torch.randn((B, cfg.pooled_dim), generator=g, device=dev).bfloat16()
    t = torch.full((B,), 0.5, device=dev)
    gs = torch.full((B,), 3.5, device=dev)
    return img, txt, pooled, t, gs, cos, sin


def qlinear_shapes(cfg, B=2, res=1024, text_len=512):
    """(rows, in, out, calls per forward) of every quantised matmul of one
    serving DiT call."""
    img, txt = B * (res // 16) ** 2, B * text_len
    h, mlp = cfg.hidden_size, int(cfg.hidden_size * cfg.mlp_ratio)
    nd, ns = cfg.depth_double, cfg.depth_single
    return [(img, h, 3 * h, nd), (txt, h, 3 * h, nd), (img, h, h, nd), (txt, h, h, nd),
            (img, h, mlp, nd), (img, mlp, h, nd), (txt, h, mlp, nd), (txt, mlp, h, nd),
            (img + txt, h, 3 * h + mlp, ns), (img + txt, h + mlp, h, ns)]


def int8_serve(torch, FA, M, dev, card, cfg, base, tuned, vae, vcfg, encode, refs, res=1024):
    """Int8 serving on the serve phase's weights (``ops/quant.py``): the base
    tree quantised (time, GB added); the B = 2, 1024px forward in int8
    against bf16 in turns (bf16, int8, int8, bf16), with the relative L2 and
    cosine of the int8 output against the bf16 one (JAX's bounds, 0.05 and
    0.995); each quantised matmul shape timed as a bf16 product, as
    ``_int_mm`` alone and as ``qlinear`` (whose excess over ``_int_mm`` is
    the per-token quantisation and dequantisation), summed over a forward;
    ``_int_mm`` on the card against the CPU on the same int8 inputs (int32
    sums equal); then one request through an int8 ``DualFluxPipeline``,
    whose quantised base and tuned trees live beside the bf16 ones."""
    import numpy as np

    from mixgrpo_tpu_torch.ops import quant as Q
    from mixgrpo_tpu_torch.sample import DualFluxPipeline
    from mixgrpo_tpu_torch.serve import make_generate_fn

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    qbase = Q.quantize_flux_params(base)
    torch.cuda.synchronize()
    quant_s, added_gb = time.perf_counter() - t0, (torch.cuda.memory_allocated() - before) / 1e9
    quant_peak_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
    w_q = qbase["single"]["linear1"]["w_q"]
    layout = {"shape": list(w_q.shape), "stride": list(w_q.stride())}

    args = serve_forward_inputs(torch, cfg, dev, res=res)
    outs, times = {}, {"bf16": [], "int8": []}
    for name in ("bf16", "int8", "int8", "bf16"):
        params = base if name == "bf16" else qbase

        def fwd(params=params, name=name):
            with torch.no_grad():
                outs[name] = M.flux_forward(params, cfg, *args)

        times[name].append(time_ms(torch, fwd, 2, warmup=1))
    y, yq = outs["bf16"].double(), outs["int8"].double()
    rel = ((yq - y).norm() / y.norm()).item()
    cos = ((y * yq).sum() / (y.norm() * yq.norm())).item()

    shapes, per_shape = qlinear_shapes(cfg, res=res), []
    g = torch.Generator(dev).manual_seed(4)
    for rows, k, n, calls in shapes:
        x = torch.randn((rows, k), generator=g, device=dev).bfloat16()
        p = Q.quantize_linear_params({"w": (torch.randn((k, n), generator=g, device=dev)
                                            * k ** -0.5).bfloat16()})
        w = p["w_q"].float().mul(p["w_s"]).bfloat16()
        xq = torch.randint(-127, 128, (rows, k), generator=g, device=dev, dtype=torch.int8)
        ms = {"bf16_matmul": time_ms(torch, lambda: x @ w, 5),
              "int_mm": time_ms(torch, lambda: torch._int_mm(xq, p["w_q"]), 5),
              "qlinear": time_ms(torch, lambda: Q.qlinear(p, x, torch.bfloat16), 5)}
        per_shape.append({"rows": rows, "in": k, "out": n, "calls": calls, **ms,
                          "int8_tops": 2 * rows * k * n / ms["int_mm"] / 1e9})
        del x, w, p, xq
    total = {key: sum(r[key] * r["calls"] for r in per_shape)
             for key in ("bf16_matmul", "int_mm", "qlinear")}
    int8_ms = min(times["int8"])

    # _int_mm on the card against the CPU, same int8 inputs: 64 quantised
    # activation rows of the int8 forward's first single block
    x = torch.randn((64, cfg.hidden_size), generator=g, device=dev)
    amax = x.abs().amax(dim=-1, keepdim=True)
    xq = torch.round(x / (amax / 127.0)).to(torch.int8)
    w_q0 = qbase["single"]["linear1"]["w_q"][0]
    got = torch._int_mm(xq, w_q0).cpu()
    want = torch._int_mm(xq.cpu(), w_q0.cpu())
    int_mm_equal = bool(torch.equal(got, want))
    del qbase, outs, y, yq, x, xq, w_q0
    torch.cuda.empty_cache()

    # one request through an int8 DualFluxPipeline
    t0 = time.perf_counter()
    pipe = DualFluxPipeline(cfg, base, tuned, vae_cfg=vcfg, vae_params=vae, height=res,
                            width=res, num_steps=SERVE_STEPS, mix_sampling_steps=SERVE_MIX,
                            dtype=torch.bfloat16, quant="int8", device=dev)
    torch.cuda.synchronize()
    pipe_quant_s = time.perf_counter() - t0
    gen = make_generate_fn(pipe, encode)
    reset_launches(FA)
    t0 = time.perf_counter()
    image = gen(["a lighthouse at dusk"], [7])
    torch.cuda.synchronize()
    request_s = time.perf_counter() - t0
    check_launches(FA, "int8_pipeline", FA.flash_attn_fwd.launches,
                   cfg.depth_double + cfg.depth_single, SERVE_STEPS)
    vs_bf16 = images_close(torch, (np.clip(image[0], 0, 1) * 255).astype(np.uint8),
                           refs[("a lighthouse at dusk", 7)])
    rec = {"phase": "serve_int8", "resolution": res, "batch": 2,
           "quantize_base_s": quant_s, "quantized_gb_added": added_gb,
           "quantize_peak_temporary_gb": quant_peak_gb - added_gb, "w_q_layout": layout,
           "forward_ms": times,
           "rel_l2_int8_vs_bf16": rel, "cosine_int8_vs_bf16": cos,
           "jax_bounds": {"rel_l2": 0.05, "cosine": 0.995},
           "matmuls_per_forward": per_shape, "matmul_ms_per_forward": total,
           "quant_dequant_ms_per_forward": total["qlinear"] - total["int_mm"],
           "quant_dequant_share_of_int8_forward": (total["qlinear"] - total["int_mm"]) / int8_ms,
           "int_mm_card_equals_cpu": int_mm_equal,
           "pipeline_quantize_both_s": pipe_quant_s, "pipeline_request_s": request_s,
           "pipeline_image_finite": bool(np.isfinite(image).all()),
           "pipeline_image_shape": list(image.shape),
           "pipeline_image_vs_bf16_request_batcher": vs_bf16,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9, "device": card}
    emit(rec)
    if not (int_mm_equal and rel < 0.05 and cos > 0.995 and rec["pipeline_image_finite"]
            and tuple(image.shape) == (1, res, res, 3)
            and tuple(layout["stride"][1:]) == (1, cfg.hidden_size)):
        raise AssertionError(f"int8 serving failed its checks: {rec}")
    del pipe, gen
    torch.cuda.empty_cache()


CKPT_PROMPTS = (
    "a photo of a red fox in the snow at golden hour",
    " ".join(["a futuristic city skyline at night with neon reflections on the wet street"]
             * 60),  # far over 512 T5 tokens
    "東京タワー の 夜景, café crème brûlée, naïve art 😀",
)
CLIP_MERGES = ("#version: 0.2", "t h", "th e</w>", "a</w>", "o f</w>", "i n</w>", "o n</w>",
               "c a", "ca t</w>", "d o", "do g</w>")


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def host_rss_gb():
    """This process's resident set now (``VmRSS``), GB."""
    with open("/proc/self/status") as f:
        kb = next(int(ln.split()[1]) for ln in f if ln.startswith("VmRSS:"))
    return kb * 1024 / 1e9


class RssPeak:
    """The peak of this process's RSS while the ``with`` block runs, sampled
    every 2 ms by a thread (``ru_maxrss`` is the peak since the process
    started, and the card's machine refuses ``/proc/self/clear_refs``, which
    would reset it)."""

    def __enter__(self):
        self.before = self.peak = host_rss_gb()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, host_rss_gb())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, host_rss_gb())


def hf_t5_state(torch, cfg, dev, seed):
    """HF ``T5EncoderModel`` names with HF's initialisation statistics (q
    holds the 1/sqrt(d_kv) T5 never applies), bf16 on the card."""
    g = torch.Generator(dev).manual_seed(seed)
    inner, d = cfg.num_heads * cfg.head_dim, cfg.d_model
    n = lambda shape, std: torch.randn(shape, generator=g, device=dev,
                                       dtype=torch.bfloat16) * std
    ones = lambda k: torch.ones((k,), device=dev, dtype=torch.bfloat16)
    st = {"shared.weight": n((cfg.vocab, d), 1.0),
          "encoder.final_layer_norm.weight": ones(d),
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
              n((cfg.rel_buckets, cfg.num_heads), d ** -0.5)}
    for i in range(cfg.num_layers):
        b = f"encoder.block.{i}.layer"
        st.update({
            f"{b}.0.layer_norm.weight": ones(d),
            f"{b}.0.SelfAttention.q.weight": n((inner, d), (d * cfg.head_dim) ** -0.5),
            f"{b}.0.SelfAttention.k.weight": n((inner, d), d ** -0.5),
            f"{b}.0.SelfAttention.v.weight": n((inner, d), d ** -0.5),
            f"{b}.0.SelfAttention.o.weight": n((d, inner), inner ** -0.5),
            f"{b}.1.layer_norm.weight": ones(d),
            f"{b}.1.DenseReluDense.wi_0.weight": n((cfg.d_ff, d), d ** -0.5),
            f"{b}.1.DenseReluDense.wi_1.weight": n((cfg.d_ff, d), d ** -0.5),
            f"{b}.1.DenseReluDense.wo.weight": n((d, cfg.d_ff), cfg.d_ff ** -0.5),
        })
    return st


def hf_clip_text_state(torch, cfg, dev, seed):
    """HF ``CLIPTextModel`` names with HF's initialisation statistics, f16 on
    the card (FLUX's ``text_encoder``: no projection)."""
    g = torch.Generator(dev).manual_seed(seed)
    t = cfg.text
    W, Lr = t.width, t.layers
    n = lambda shape, std: torch.randn(shape, generator=g, device=dev,
                                       dtype=torch.float16) * std
    z = lambda k: torch.zeros((k,), device=dev, dtype=torch.float16)
    ln = lambda name: {f"{name}.weight": z(W) + 1, f"{name}.bias": z(W)}
    tp = "text_model"
    st = {f"{tp}.embeddings.token_embedding.weight": n((t.vocab, W), 0.02),
          f"{tp}.embeddings.position_embedding.weight": n((t.context, W), 0.02),
          **ln(f"{tp}.final_layer_norm")}
    in_std = W ** -0.5 * (2 * Lr) ** -0.5
    for i in range(Lr):
        b = f"{tp}.encoder.layers.{i}"
        for x in "qkv":
            st[f"{b}.self_attn.{x}_proj.weight"] = n((W, W), in_std)
            st[f"{b}.self_attn.{x}_proj.bias"] = n((W,), 0.02)
        st.update({f"{b}.self_attn.out_proj.weight": n((W, W), W ** -0.5),
                   f"{b}.self_attn.out_proj.bias": z(W),
                   f"{b}.mlp.fc1.weight": n((4 * W, W), (2 * W) ** -0.5),
                   f"{b}.mlp.fc1.bias": z(4 * W),
                   f"{b}.mlp.fc2.weight": n((W, 4 * W), in_std), f"{b}.mlp.fc2.bias": z(W),
                   **ln(f"{b}.layer_norm1"), **ln(f"{b}.layer_norm2")})
    return st


def diffusers_vae_state(params, prefix):
    """The port's VAE encoder or decoder dict under diffusers
    ``AutoencoderKL`` names (HWIO -> OIHW, (in, out) -> (out, in))."""
    st = {}

    def conv(name, p):
        st[f"{name}.weight"], st[f"{name}.bias"] = p["w"].permute(3, 2, 0, 1), p["b"]

    def gn(name, p):
        st[f"{name}.weight"], st[f"{name}.bias"] = p["scale"], p["bias"]

    def resnet(name, p):
        gn(f"{name}.norm1", p["norm1"])
        conv(f"{name}.conv1", p["conv1"])
        gn(f"{name}.norm2", p["norm2"])
        conv(f"{name}.conv2", p["conv2"])
        if "shortcut" in p:
            conv(f"{name}.conv_shortcut", p["shortcut"])

    conv(f"{prefix}.conv_in", params["conv_in"])
    resnet(f"{prefix}.mid_block.resnets.0", params["mid_res1"])
    resnet(f"{prefix}.mid_block.resnets.1", params["mid_res2"])
    a, att = f"{prefix}.mid_block.attentions.0", params["mid_attn"]
    gn(f"{a}.group_norm", att["norm"])
    for ours, theirs in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("out", "to_out.0")):
        st[f"{a}.{theirs}.weight"], st[f"{a}.{theirs}.bias"] = att[ours]["w"].t(), att[ours]["b"]
    gn(f"{prefix}.conv_norm_out", params["norm_out"])
    conv(f"{prefix}.conv_out", params["conv_out"])
    kind, up = ("up", "upsample") if prefix == "decoder" else ("down", "downsample")
    for bi, blk in enumerate(params[f"{kind}_blocks"]):
        for li, rp in enumerate(blk["resnets"]):
            resnet(f"{prefix}.{kind}_blocks.{bi}.resnets.{li}", rp)
        if up in blk:
            conv(f"{prefix}.{kind}_blocks.{bi}.{kind}samplers.0.conv", blk[up])
    return st


def unigram_tokenizer_json(vocab_size, seed):
    """A T5-like ``tokenizer.json``: NFKC, Metaspace, a ``Unigram`` model of
    ``vocab_size`` scored pieces (<pad>=0, </s>=1, <unk>=2) over the
    prompts' characters, and ``TemplateProcessing`` appending </s>."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alphabet = sorted(set("".join(CKPT_PROMPTS)) - {" "})
    pieces = set()
    while len(pieces) < vocab_size - 4:
        w = "".join(rng.choice(alphabet, int(rng.integers(1, 7))))
        pieces.add(("▁" + w) if rng.random() < 0.4 else w)
    vocab = [["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0], ["▁", -2.0]] + \
        [[p, float(-rng.uniform(3, 14))] for p in sorted(pieces)]
    special = lambda i, c: {"id": i, "content": c, "single_word": False, "lstrip": False,
                            "rstrip": False, "normalized": False, "special": True}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [special(0, "<pad>"), special(1, "</s>"), special(2, "<unk>")],
        "normalizer": {"type": "NFKC"},
        "pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
                          "split": True},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"</s>": {"id": "</s>", "ids": [1], "tokens": ["</s>"]}}},
        "decoder": None,
        "model": {"type": "Unigram", "unk_id": 2, "vocab": vocab, "byte_fallback": False},
    }


def smoke_family(M):
    """The full-width FLUX.1-dev family of the checkpoint phases: the
    transformer cut to ``TRAIN_DEPTH`` blocks, T5-XXL to 2 of 24 layers."""
    import dataclasses

    from mixgrpo_tpu_torch.models.flux.vae import VAEConfig
    from mixgrpo_tpu_torch.models.text.clip import CLIPConfig
    from mixgrpo_tpu_torch.models.text.t5 import T5Config

    return {"flux": M.FluxConfig(depth_double=TRAIN_DEPTH[0], depth_single=TRAIN_DEPTH[1]),
            "vae": VAEConfig.flux_dev(), "t5": dataclasses.replace(T5Config.xxl(), num_layers=2),
            "clip": CLIPConfig.vit_l_14()}


def write_flux_dir(torch, M, dev, fam, d):
    """A FLUX.1-dev directory in the released layout at ``d``, written by the
    port's writers: the bf16 transformer in two shards (seed 20), the F32 VAE
    decoder and encoder (24, 25), T5 in bf16 (22) and the CLIP-L text tower
    in F16 (23) with HF's initialisation statistics, a CLIP merges table and
    a ``Unigram`` tokenizer.json (26).  Returns what was written: (the
    transformer's tree, T5's and CLIP's state dicts, the VAE trees)."""
    import json as _json

    from mixgrpo_tpu_torch.models.flux.vae import init_vae_decoder, init_vae_encoder
    from mixgrpo_tpu_torch.utils.checkpoint import diffusers_state
    from mixgrpo_tpu_torch.utils.safetensors_io import save_file

    base = M.init_flux(fam["flux"], generator=torch.Generator(dev).manual_seed(20), device=dev,
                       dtype=torch.bfloat16)
    st = diffusers_state(base, fam["flux"])
    names = sorted(st)
    for k, part in enumerate((names[:len(names) // 2], names[len(names) // 2:])):
        save_file({n: st[n] for n in part}, os.path.join(
            d, "transformer", f"diffusion_pytorch_model-{k + 1:05d}-of-00002.safetensors"))
    t5_st = hf_t5_state(torch, fam["t5"], dev, 22)
    save_file(t5_st, os.path.join(d, "text_encoder_2", "model.safetensors"))
    clip_st = hf_clip_text_state(torch, fam["clip"], dev, 23)
    save_file(clip_st, os.path.join(d, "text_encoder", "model.safetensors"))
    vae_dec = init_vae_decoder(fam["vae"], generator=torch.Generator(dev).manual_seed(24),
                               device=dev)
    vae_enc = init_vae_encoder(fam["vae"], generator=torch.Generator(dev).manual_seed(25),
                               device=dev)
    save_file({**diffusers_vae_state(vae_dec, "decoder"),
               **diffusers_vae_state(vae_enc, "encoder")},
              os.path.join(d, "vae", "diffusion_pytorch_model.safetensors"))
    os.makedirs(os.path.join(d, "tokenizer"))
    with open(os.path.join(d, "tokenizer", "merges.txt"), "w") as f:
        f.write("\n".join(CLIP_MERGES) + "\n")
    os.makedirs(os.path.join(d, "tokenizer_2"))
    with open(os.path.join(d, "tokenizer_2", "tokenizer.json"), "w") as f:
        _json.dump(unigram_tokenizer_json(fam["t5"].vocab, 26), f)
    with open(os.path.join(d, "tokenizer_2", "tokenizer_config.json"), "w") as f:
        _json.dump({"tokenizer_class": "T5Tokenizer", "model_max_length": 512,
                    "pad_token": "<pad>", "eos_token": "</s>", "unk_token": "<unk>"}, f)
    return base, t5_st, clip_st, vae_dec, vae_enc


def checkpoints_phase(torch, FA, M, dev, card, root, fam=None, res=1024, keep=False):
    """Released checkpoints in, at full FLUX.1-dev width: (1) a synthetic
    FLUX.1-dev directory written by the port's writers in the released
    layout (a bf16 transformer cut to 2 + 4 blocks in two shards, an F32
    tuned export, a bf16 T5-XXL cut to 2 of 24 layers, the whole CLIP-L text
    tower in F16, the full F32 VAE, a CLIP merges table and a 32,128-piece
    ``Unigram`` tokenizer.json); (2) each component loaded onto the card in
    bf16 through the port's loaders, timed, with the host's peak RSS, and a
    dozen leaves held bit for bit against what was written; the encoders'
    bf16 outputs against their f32 outputs; (3) ``sample.main`` on the
    directory (1024px, 4 steps, 2 tuned, batches of 2, three prompts); (4)
    ``serve.build_server`` answering a co-batched pair and a lone request;
    (5) ``vae_encode`` of two decoded images.  Launches: exactly 24 forwards
    per pipeline call, nothing from the encoders or the VAE.  ``fam`` and
    ``res`` (default: the full-width cut family, 1024px) are arguments so
    that the phase can be rehearsed at a tiny size.  With ``keep`` the
    directory stays for ``parallel_cli`` (the caller removes it)."""
    import json as _json
    import shutil
    import tempfile

    import numpy as np
    from PIL import Image

    from mixgrpo_tpu_torch import sample as Sa
    from mixgrpo_tpu_torch import serve as Se
    from mixgrpo_tpu_torch.models.flux.load import (
        load_flux_params, load_vae_decoder_params, load_vae_encoder_params,
    )
    from mixgrpo_tpu_torch.models.flux.vae import vae_encode
    from mixgrpo_tpu_torch.models.text.clip_load import load_clip_hf_text_only
    from mixgrpo_tpu_torch.models.text.t5 import load_t5_hf
    from mixgrpo_tpu_torch.preprocess import build_prompt_encoder_from_dir
    from mixgrpo_tpu_torch.utils.checkpoint import export_flux_safetensors
    from mixgrpo_tpu_torch.utils.safetensors_io import SafetensorsDir

    fam = fam or smoke_family(M)
    cfg, bf16 = fam["flux"], torch.bfloat16
    per_call = cfg.depth_double + cfg.depth_single
    tmp = tempfile.mkdtemp(dir=root, prefix=".smoke_ckpt_")
    try:
        d = os.path.join(tmp, "FLUX.1-dev")
        # -- 1. write ------------------------------------------------------------
        t0 = time.perf_counter()
        base, t5_st, clip_st, vae_dec, vae_enc = write_flux_dir(torch, M, dev, fam, d)
        g = torch.Generator(dev).manual_seed(21)
        tuned = tree_map(lambda t: t + 1e-3 * torch.randn(t.shape, generator=g, device=dev,
                                                          dtype=bf16), base)
        tuned_path = os.path.join(tmp, "tuned.safetensors")
        export_flux_safetensors(tuned, cfg, tuned_path)
        torch.cuda.synchronize()
        write_s = time.perf_counter() - t0
        sizes = {}
        for sub in ("transformer", "text_encoder_2", "text_encoder", "vae", "tokenizer_2"):
            sizes[sub] = sum(os.path.getsize(os.path.join(d, sub, n))
                             for n in os.listdir(os.path.join(d, sub)))
        sizes["tuned.safetensors"] = os.path.getsize(tuned_path)
        emit({"phase": "checkpoints_write", "seconds": write_s,
              "gb_written": sum(sizes.values()) / 1e9,
              "gb_per_component": {k: v / 1e9 for k, v in sizes.items()},
              "flux_params": M.param_count(base),
              "t5_params": sum(t.numel() for t in t5_st.values()),
              "clip_text_params": sum(t.numel() for t in clip_st.values()), "device": card})

        # -- 2. load each component onto the card in bf16, leaves bit for bit --------
        log = LoadLog(torch)
        load = lambda name, fn, path: log.load(name, fn, SafetensorsDir(path).nbytes())
        same = log.same

        tdir = os.path.join(d, "transformer")
        lb = load("transformer", lambda: load_flux_params(tdir, cfg, dtype=bf16, device=dev),
                  tdir)
        same("double.img_qkv.w[1] (fused q, k, v)", lb["double"]["img_qkv"]["w"][1],
             base["double"]["img_qkv"]["w"][1])
        same("single.linear1.w[3] (fused q, k, v, mlp)", lb["single"]["linear1"]["w"][3],
             base["single"]["linear1"]["w"][3])
        same("x_embedder.w (transposed linear)", lb["x_embedder"]["w"], base["x_embedder"]["w"])
        same("double.txt_knorm[0]", lb["double"]["txt_knorm"][0], base["double"]["txt_knorm"][0])
        del lb
        lt = load("tuned (F32 export)", lambda: load_flux_params(tuned_path, cfg, dtype=bf16,
                                                                 device=dev), tuned_path)
        same("tuned single.linear2.w[2] (F32 -> bf16)", lt["single"]["linear2"]["w"][2],
             tuned["single"]["linear2"]["w"][2])
        same("tuned double.txt_qkv.b[0]", lt["double"]["txt_qkv"]["b"][0],
             tuned["double"]["txt_qkv"]["b"][0])
        del lt, tuned
        vdir = os.path.join(d, "vae")
        lv, le = load("vae (decoder and encoder)", lambda: (
            load_vae_decoder_params(vdir, fam["vae"], dtype=bf16, device=dev),
            load_vae_encoder_params(vdir, fam["vae"], dtype=bf16, device=dev)), vdir)
        same("vae decoder.conv_in.w (conv kernel)", lv["conv_in"]["w"],
             vae_dec["conv_in"]["w"].to(bf16))
        same("vae decoder.up_blocks[1].upsample.w", lv["up_blocks"][1]["upsample"]["w"],
             vae_dec["up_blocks"][1]["upsample"]["w"].to(bf16))
        same("vae encoder.down_blocks[0].downsample.w", le["down_blocks"][0]["downsample"]["w"],
             vae_enc["down_blocks"][0]["downsample"]["w"].to(bf16))
        same("vae encoder.mid_attn.q.w", le["mid_attn"]["q"]["w"],
             vae_enc["mid_attn"]["q"]["w"].to(bf16))
        del lv, le, vae_dec, vae_enc
        t5dir = os.path.join(d, "text_encoder_2")
        l5 = load("t5", lambda: load_t5_hf(SafetensorsDir(t5dir), fam["t5"], dtype=bf16,
                                           device=dev), t5dir)
        same("t5 rel_bias", l5["rel_bias"],
             t5_st["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"])
        same("t5 blocks.q[1] (transposed)", l5["blocks"]["q"][1],
             t5_st["encoder.block.1.layer.0.SelfAttention.q.weight"].t())
        same("t5 token_emb", l5["token_emb"], t5_st["shared.weight"])
        del l5, t5_st
        cdir = os.path.join(d, "text_encoder")
        lc = load("clip-l text", lambda: load_clip_hf_text_only(
            SafetensorsDir(cdir), fam["clip"], dtype=bf16, device=dev), cdir)
        li = fam["clip"].text.layers // 2
        pre = f"text_model.encoder.layers.{li}.self_attn"
        same(f"clip text.blocks.qkv.w[{li}] (fused, F16 -> bf16)",
             lc["text"]["blocks"]["qkv"]["w"][li],
             torch.cat([clip_st[f"{pre}.{x}_proj.weight"] for x in "qkv"]).t().to(bf16))
        same("clip token_emb, F16 read as F16",
             SafetensorsDir(cdir).get("text_model.embeddings.token_embedding.weight", device=dev),
             clip_st["text_model.embeddings.token_embedding.weight"])
        del lc, clip_st
        for rec in log.loads:
            emit(dict(phase="checkpoints_load", **rec, device=card))
        emit({"phase": "checkpoints_leaves", "checks": log.checks, "device": card})
        if not all(c["bit_for_bit"] for c in log.checks):
            raise AssertionError(f"checkpoints: leaves differ from what was written: {log.checks}")

        # the prompt encoders: bf16 against f32 on the card, and their launches
        encs = {dt: build_prompt_encoder_from_dir(d, family=fam, device=dev, dtype=dt)
                for dt in (torch.float32, bf16)}
        ids = encs[bf16].t5_tok(list(CKPT_PROMPTS), padding="max_length", truncation=True,
                                max_length=512, return_tensors="np")["input_ids"]
        reset_launches(FA)
        out = {dt: e(list(CKPT_PROMPTS)) for dt, e in encs.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encs[bf16](list(CKPT_PROMPTS))
        torch.cuda.synchronize()
        encode_ms = (time.perf_counter() - t0) * 1e3
        enc_launches = {n: f.launches for n, f in FA.KERNEL_WRAPPERS.items()}
        t5_ok, t5_err, t5_rel = close_bf16(torch.from_numpy(out[bf16][0]),
                                           torch.from_numpy(out[torch.float32][0]))
        # CLIP-L's bf16 residual stream is rounded 24 times (12 layers x 2 adds):
        # sqrt(24) * 2^-8 / sqrt(3) = 1.1e-2 relative L2 is expected from that alone
        clip_ok, clip_err, clip_rel = close_bf16(torch.from_numpy(out[bf16][1]),
                                                 torch.from_numpy(out[torch.float32][1]),
                                                 rel_lim=3e-2)
        rec = {"phase": "checkpoints_encode", "prompts": len(CKPT_PROMPTS),
               "t5_ids_nonpad": [int((r != 0).sum()) for r in ids],
               "t5_last_id_of_long_prompt": int(ids[1, -1]),
               "shapes": [list(out[bf16][0].shape), list(out[bf16][1].shape)],
               "t5_bf16_vs_f32": {"ok": t5_ok, "max_abs_err": t5_err, "rel_l2": t5_rel},
               "clip_bf16_vs_f32": {"ok": clip_ok, "max_abs_err": clip_err, "rel_l2": clip_rel,
                                    "rel_lim": 3e-2},
               "encode_ms_per_batch_bf16": encode_ms, "launches": enc_launches, "device": card}
        emit(rec)
        del encs, out
        torch.cuda.empty_cache()
        if not (t5_ok and clip_ok and ids[1, -1] == 1 and (ids[1] != 0).all()
                and not any(enc_launches.values())):
            raise AssertionError(f"checkpoints: prompt encoders failed their checks: {rec}")

        # -- 3. sample.main --------------------------------------------------------
        prompts = os.path.join(tmp, "prompts.txt")
        with open(prompts, "w") as f:
            f.write("\n".join(CKPT_PROMPTS) + "\n")
        outdir = os.path.join(tmp, "samples")
        reset_launches(FA)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        Sa.main(["--model_path", d, "--new_model_ckpt", tuned_path, "--prompt_path", prompts,
                 "--output_dir", outdir, "--h", str(res), "--w", str(res), "--sampling_steps",
                 str(SERVE_STEPS), "--mix_sampling_steps", str(SERVE_MIX), "--batch_size", "2",
                 "--seed", "5", "--device", str(dev)], family=fam)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        main_peak = torch.cuda.max_memory_allocated() / 1e9
        calls = -(-len(CKPT_PROMPTS) // 2)
        check_launches(FA, "sample_main", FA.flash_attn_fwd.launches, per_call,
                       calls * SERVE_STEPS)
        with open(os.path.join(outdir, "metadata_0.json")) as f:
            meta = _json.load(f)
        shapes = [np.asarray(Image.open(os.path.join(outdir, m["image"]))).shape for m in meta]
        rec = {"phase": "checkpoints_sample_main", "images": len(meta), "shapes": shapes,
               "pipeline_calls": calls, "seconds": main_s,
               "max_memory_allocated_gb": main_peak, "device": card}
        emit(rec)
        if [m["prompt"] for m in meta] != list(CKPT_PROMPTS) or \
                any(s != (res, res, 3) for s in shapes):
            raise AssertionError(f"sample.main: {rec}")
        torch.cuda.empty_cache()

        # -- 3b. sample.main --quant int8 ----------------------------------------------
        outq = os.path.join(tmp, "samples_int8")
        reset_launches(FA)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        Sa.main(["--model_path", d, "--new_model_ckpt", tuned_path, "--prompt_path", prompts,
                 "--output_dir", outq, "--h", str(res), "--w", str(res), "--sampling_steps",
                 str(SERVE_STEPS), "--mix_sampling_steps", str(SERVE_MIX), "--batch_size", "2",
                 "--seed", "5", "--quant", "int8", "--device", str(dev)], family=fam)
        torch.cuda.synchronize()
        q_s = time.perf_counter() - t0
        check_launches(FA, "sample_main_int8", FA.flash_attn_fwd.launches, per_call,
                       calls * SERVE_STEPS)
        with open(os.path.join(outq, "metadata_0.json")) as f:
            meta_q = _json.load(f)
        vs_bf16 = [images_close(torch, png_pixels(open(os.path.join(outq, mq["image"]), "rb")
                                                  .read()),
                                png_pixels(open(os.path.join(outdir, m["image"]), "rb").read()))
                   for mq, m in zip(meta_q, meta)]
        rec = {"phase": "checkpoints_sample_main_int8", "images": len(meta_q), "seconds": q_s,
               "seconds_bf16": main_s, "images_vs_bf16": vs_bf16,
               "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
               "device": card}
        emit(rec)
        if [m["prompt"] for m in meta_q] != list(CKPT_PROMPTS):
            raise AssertionError(f"sample.main --quant int8: {rec}")
        torch.cuda.empty_cache()

        # -- 4. serve.build_server -------------------------------------------------
        args = Se.arg_parser().parse_args(
            ["--model_path", d, "--tuned_path", tuned_path, "--host", "127.0.0.1", "--port",
             "0", "--batch_size", "2", "--max_wait_ms", "500", "--num_steps", str(SERVE_STEPS),
             "--mix_sampling_steps", str(SERVE_MIX), "--height", str(res), "--width", str(res),
             "--device", str(dev)])
        t0 = time.perf_counter()
        srv = Se.build_server(args, family=fam)
        build_s = time.perf_counter() - t0
        results = {}
        reset_launches(FA)
        torch.cuda.reset_peak_memory_stats()
        srv.start()
        try:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=lambda i=i: results.__setitem__(
                i, post(srv.port, {"prompt": CKPT_PROMPTS[i], "seed": i}))) for i in range(2)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=900)
            pair_wall = time.perf_counter() - t0
            results[2] = post(srv.port, {"prompt": CKPT_PROMPTS[2], "seed": 7})
            stats = dict(srv.batcher.stats)
        finally:
            srv.stop()
        check_launches(FA, "serve_main", FA.flash_attn_fwd.launches, per_call,
                       stats["batches"] * SERVE_STEPS)
        pngs = []
        for i in range(3):
            status, ctype, body, _ = results[i]
            pngs.append(np.asarray(Image.open(io.BytesIO(body))))
            if status != 200 or ctype != "image/png" or pngs[-1].shape != (res, res, 3):
                raise AssertionError(f"served request {i}: {status} {ctype} {pngs[-1].shape}")
        rec = {"phase": "checkpoints_serve", "build_server_s": build_s, "stats": stats,
               "pair_wall_s": pair_wall, "s_per_image_batched": pair_wall / 2,
               "latency_s": [results[i][3] for i in range(3)],
               "s_per_image_alone": results[2][3],
               "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
               "device": card}
        emit(rec)
        if stats["batches"] != 2 or stats["single_dispatches"] != 1 or stats["errors"]:
            raise AssertionError(f"serve.build_server: {rec}")
        del srv
        torch.cuda.empty_cache()

        # -- 4b. serve.build_server --quant int8: the lone request again ---------------
        args = Se.arg_parser().parse_args(
            ["--model_path", d, "--tuned_path", tuned_path, "--host", "127.0.0.1", "--port",
             "0", "--batch_size", "2", "--max_wait_ms", "500", "--num_steps", str(SERVE_STEPS),
             "--mix_sampling_steps", str(SERVE_MIX), "--height", str(res), "--width", str(res),
             "--quant", "int8", "--device", str(dev)])
        t0 = time.perf_counter()
        srv = Se.build_server(args, family=fam)
        build_q_s = time.perf_counter() - t0
        reset_launches(FA)
        srv.start()
        try:
            res_q = post(srv.port, {"prompt": CKPT_PROMPTS[2], "seed": 7})
            stats_q = dict(srv.batcher.stats)
        finally:
            srv.stop()
        check_launches(FA, "serve_main_int8", FA.flash_attn_fwd.launches, per_call,
                       SERVE_STEPS)
        # the int8 path rounds otherwise than bf16: close to the bf16 image, not equal
        vs_bf16 = images_close(torch, png_pixels(res_q[2]), pngs[2])
        rec = {"phase": "checkpoints_serve_int8", "build_server_s": build_q_s, "stats": stats_q,
               "latency_s": res_q[3], "bf16_latency_s": results[2][3],
               "image_vs_bf16": vs_bf16, "device": card}
        emit(rec)
        if not (res_q[0] == 200 and stats_q["single_dispatches"] == 1 and not stats_q["errors"]
                and vs_bf16["ok"] and vs_bf16["rel_l2"] > 0):
            raise AssertionError(f"serve.build_server --quant int8: {rec}")
        del srv
        torch.cuda.empty_cache()

        # -- 4c. serve.build_server --continuous: the same pair, one step per call ------
        args = Se.arg_parser().parse_args(
            ["--model_path", d, "--tuned_path", tuned_path, "--host", "127.0.0.1", "--port",
             "0", "--batch_size", "2", "--num_steps", str(SERVE_STEPS), "--mix_sampling_steps",
             str(SERVE_MIX), "--height", str(res), "--width", str(res), "--continuous",
             "--max_steps_per_call", "1", "--device", str(dev)])
        t0 = time.perf_counter()
        srv = Se.build_server(args, family=fam)
        build_c_s = time.perf_counter() - t0
        reset_launches(FA)
        srv.start()
        try:
            res_c, _, wall_c = staggered_posts(
                srv.port, [(CKPT_PROMPTS[0], 0), (CKPT_PROMPTS[1], 1)], (after(0.0), after(0.05)))
            stats_c = dict(srv.batcher.stats)
        finally:
            srv.stop()
        check_launches(FA, "serve_main_continuous", FA.flash_attn_fwd.launches, per_call,
                       stats_c["batches"] + SERVE_STEPS * stats_c["single_dispatches"])
        checks_c = [images_close(torch, png_pixels(res_c[i][2]), pngs[i]) for i in range(2)]
        rec = {"phase": "checkpoints_serve_continuous", "build_server_s": build_c_s,
               "stats": stats_c, "pair_wall_s": wall_c,
               "latency_s": [res_c[i][3] for i in range(2)],
               "images_vs_request_batcher": checks_c, "device": card}
        emit(rec)
        if not (stats_c["requests"] == 2 and stats_c["migrations"] == 2 and not stats_c["errors"]
                and all(c["ok"] for c in checks_c)):
            raise AssertionError(f"serve.build_server --continuous: {rec}")
        del srv
        torch.cuda.empty_cache()

        # -- 5. vae_encode of two decoded images -------------------------------------
        enc_p = load_vae_encoder_params(vdir, fam["vae"], dtype=bf16, device=dev)
        imgs = torch.from_numpy(np.stack(pngs[:2]).astype(np.float32) / 127.5 - 1.0).to(dev)
        reset_launches(FA)
        t0 = time.perf_counter()
        lat = vae_encode(enc_p, fam["vae"], imgs, dtype=bf16, sample=False)
        torch.cuda.synchronize()
        rec = {"phase": "checkpoints_vae_encode", "latents": list(lat.shape),
               "finite": bool(torch.isfinite(lat).all()),
               "seconds": time.perf_counter() - t0,
               "launches": {n: f.launches for n, f in FA.KERNEL_WRAPPERS.items()},
               "device": card}
        emit(rec)
        want_shape = (2, res // 8, res // 8, fam["vae"].latent_channels)
        if tuple(lat.shape) != want_shape or not rec["finite"] or \
                any(rec["launches"].values()):
            raise AssertionError(f"vae_encode: {rec}")
        del enc_p, imgs, lat, base
    finally:
        if not keep:
            shutil.rmtree(tmp, ignore_errors=True)  # cleanup only; failures propagate
    torch.cuda.empty_cache()
    return {"write_s": write_s, "sample_main_s": main_s, "root": tmp, "dir": d,
            "tuned": tuned_path, "prompts": prompts}


# ---------------------------------------------------------------------------
# the reward zoo (phases rewards and train_main)
# ---------------------------------------------------------------------------

REWARD_PROMPTS = tuple(f"{p} #{i}" for i, p in enumerate(
    [CKPT_PROMPTS[0], CKPT_PROMPTS[2], "a cat on the roof of the house", CKPT_PROMPTS[1],
     "a dog in a field of flowers, oil painting", "Ünïcödé façade, 北京 at dawn!"] * 2))
UR_FAIL_ONCE, UR_NO_SCORE = 3, 7  # prompt indices: HTTP 500 once; a reply with no score
# max |bf16 - f32| of each model's scores at its published geometry, derived on
# the CPU by reward_bf16_bound.py (this phase's files and loads with the towers
# cut to depths 2, 4 and 8: 3x the largest error seen, times sqrt(full depth / 8),
# rounded up); written down before the first run held to them
REWARD_BF16_BOUND = {"hpsv2": 0.00431, "pick_score": 0.00651, "clip_score": 0.00446,
                     "image_reward": 0.123}


def reward_geometry():
    """The published geometries: HPSv2.1 and PickScore_v1 are ViT-H-14 at
    224 (GELU), DFN5B CLIP-score ViT-H-14 at 384 with quick-GELU, ImageReward
    BLIP ViT-L/16 at 224 with BERT-base (vocab 30524, cross-attention width
    1024)."""
    import dataclasses

    from mixgrpo_tpu_torch.models.text.blip import BlipTextConfig, BlipVisionConfig
    from mixgrpo_tpu_torch.models.text.clip import CLIPConfig

    return {"hps": CLIPConfig.vit_h_14(224), "pick_score": CLIPConfig.vit_h_14(224),
            "clip_score": dataclasses.replace(CLIPConfig.vit_h_14(384), quick_gelu=True),
            "blip_vision": BlipVisionConfig.vit_large(), "blip_text": BlipTextConfig.base()}


def _blocks(blocks, i):
    return {k: {n: t[i] for n, t in v.items()} for k, v in blocks.items()}


def openclip_state(params):
    """The port's CLIP tree under OpenCLIP names (``load_clip_openclip``'s
    inverse)."""
    v, t = params["vision"], params["text"]
    ln = lambda name, p: {f"{name}.weight": p["scale"], f"{name}.bias": p["bias"]}
    st = {"visual.conv1.weight": v["patch_embed"]["w"].permute(3, 2, 0, 1),
          "visual.class_embedding": v["class_emb"], "visual.positional_embedding": v["pos_emb"],
          **ln("visual.ln_pre", v["ln_pre"]), **ln("visual.ln_post", v["ln_post"]),
          "visual.proj": v["proj"], "token_embedding.weight": t["token_emb"],
          "positional_embedding": t["pos_emb"], **ln("ln_final", t["ln_final"]),
          "text_projection": t["proj"], "logit_scale": params["logit_scale"]}
    for prefix, blocks in (("visual.transformer", v["blocks"]), ("transformer", t["blocks"])):
        for i in range(blocks["qkv"]["w"].shape[0]):
            b, p = _blocks(blocks, i), f"{prefix}.resblocks.{i}"
            st.update({f"{p}.attn.in_proj_weight": b["qkv"]["w"].t(),
                       f"{p}.attn.in_proj_bias": b["qkv"]["b"],
                       f"{p}.attn.out_proj.weight": b["out"]["w"].t(),
                       f"{p}.attn.out_proj.bias": b["out"]["b"],
                       **ln(f"{p}.ln_1", b["ln1"]), **ln(f"{p}.ln_2", b["ln2"]),
                       f"{p}.mlp.c_fc.weight": b["fc1"]["w"].t(),
                       f"{p}.mlp.c_fc.bias": b["fc1"]["b"],
                       f"{p}.mlp.c_proj.weight": b["fc2"]["w"].t(),
                       f"{p}.mlp.c_proj.bias": b["fc2"]["b"]})
    return st


def hf_clip_state(params):
    """The port's CLIP tree under HF ``CLIPModel`` names (``load_clip_hf``'s
    inverse)."""
    v, t = params["vision"], params["text"]
    ln = lambda name, p: {f"{name}.weight": p["scale"], f"{name}.bias": p["bias"]}
    lin = lambda name, w, b: {f"{name}.weight": w.t(), f"{name}.bias": b}
    vp, tp = "vision_model", "text_model"
    st = {f"{vp}.embeddings.patch_embedding.weight": v["patch_embed"]["w"].permute(3, 2, 0, 1),
          f"{vp}.embeddings.class_embedding": v["class_emb"],
          f"{vp}.embeddings.position_embedding.weight": v["pos_emb"],
          **ln(f"{vp}.pre_layrnorm", v["ln_pre"]), **ln(f"{vp}.post_layernorm", v["ln_post"]),
          "visual_projection.weight": v["proj"].t(),
          f"{tp}.embeddings.token_embedding.weight": t["token_emb"],
          f"{tp}.embeddings.position_embedding.weight": t["pos_emb"],
          **ln(f"{tp}.final_layer_norm", t["ln_final"]), "text_projection.weight": t["proj"].t(),
          "logit_scale": params["logit_scale"]}
    for prefix, blocks in ((vp, v["blocks"]), (tp, t["blocks"])):
        for i in range(blocks["qkv"]["w"].shape[0]):
            b, p = _blocks(blocks, i), f"{prefix}.encoder.layers.{i}"
            w, bias = b["qkv"]["w"].chunk(3, dim=1), b["qkv"]["b"].chunk(3)
            for x, wx, bx in zip("qkv", w, bias):
                st.update(lin(f"{p}.self_attn.{x}_proj", wx, bx))
            st.update({**lin(f"{p}.self_attn.out_proj", b["out"]["w"], b["out"]["b"]),
                       **ln(f"{p}.layer_norm1", b["ln1"]), **ln(f"{p}.layer_norm2", b["ln2"]),
                       **lin(f"{p}.mlp.fc1", b["fc1"]["w"], b["fc1"]["b"]),
                       **lin(f"{p}.mlp.fc2", b["fc2"]["w"], b["fc2"]["b"])})
    return st


def openclip_config_json(cfg):
    v, t = cfg.vision, cfg.text
    return {"model_cfg": {
        "embed_dim": cfg.embed_dim, "quick_gelu": cfg.quick_gelu,
        "vision_cfg": {"image_size": v.image_size, "layers": v.layers, "width": v.width,
                       "head_width": v.width // v.heads, "patch_size": v.patch},
        "text_cfg": {"context_length": t.context, "vocab_size": t.vocab, "width": t.width,
                     "heads": t.heads, "layers": t.layers}}}


def hf_clip_config_json(cfg):
    v, t = cfg.vision, cfg.text
    act = "quick_gelu" if cfg.quick_gelu else "gelu"
    return {"architectures": ["CLIPModel"], "model_type": "clip",
            "projection_dim": cfg.embed_dim,
            "vision_config": {"hidden_size": v.width, "num_hidden_layers": v.layers,
                              "num_attention_heads": v.heads, "image_size": v.image_size,
                              "patch_size": v.patch, "intermediate_size": 4 * v.width,
                              "hidden_act": act},
            "text_config": {"hidden_size": t.width, "num_hidden_layers": t.layers,
                            "num_attention_heads": t.heads, "vocab_size": t.vocab,
                            "max_position_embeddings": t.context,
                            "intermediate_size": 4 * t.width, "hidden_act": act}}


def blip_state(vp, tp, mlp, vcfg):
    """The port's BLIP trees and MLP head under ImageReward.pt names
    (``load_blip_vision``/``load_blip_text``'s inverse)."""
    ln = lambda name, p: {f"{name}.weight": p["scale"], f"{name}.bias": p["bias"]}
    lin = lambda name, p: {f"{name}.weight": p["w"].t(), f"{name}.bias": p["b"]}
    pv, pt, p = "blip.visual_encoder.", "blip.text_encoder.", vcfg.patch
    st = {f"{pv}patch_embed.proj.weight":
              vp["patch_embed"]["w"].reshape(p, p, 3, vcfg.width).permute(3, 2, 0, 1),
          f"{pv}patch_embed.proj.bias": vp["patch_embed"]["b"],
          f"{pv}cls_token": vp["cls_token"].reshape(1, 1, -1),
          f"{pv}pos_embed": vp["pos_embed"][None], **ln(f"{pv}norm", vp["norm"]),
          f"{pt}embeddings.word_embeddings.weight": tp["word_emb"],
          f"{pt}embeddings.position_embeddings.weight": tp["pos_emb"],
          **ln(f"{pt}embeddings.LayerNorm", tp["emb_ln"])}
    for i in range(vp["blocks"]["qkv"]["w"].shape[0]):
        b, q = _blocks(vp["blocks"], i), f"{pv}blocks.{i}"
        st.update({**ln(f"{q}.norm1", b["norm1"]), **lin(f"{q}.attn.qkv", b["qkv"]),
                   **lin(f"{q}.attn.proj", b["proj"]), **ln(f"{q}.norm2", b["norm2"]),
                   **lin(f"{q}.mlp.fc1", b["fc1"]), **lin(f"{q}.mlp.fc2", b["fc2"])})
    for i in range(tp["blocks"]["sa_q"]["w"].shape[0]):
        b, q = _blocks(tp["blocks"], i), f"{pt}encoder.layer.{i}"
        st.update({**lin(f"{q}.attention.self.query", b["sa_q"]),
                   **lin(f"{q}.attention.self.key", b["sa_k"]),
                   **lin(f"{q}.attention.self.value", b["sa_v"]),
                   **lin(f"{q}.attention.output.dense", b["sa_out"]),
                   **ln(f"{q}.attention.output.LayerNorm", b["sa_ln"]),
                   **lin(f"{q}.crossattention.self.query", b["ca_q"]),
                   **lin(f"{q}.crossattention.self.key", b["ca_k"]),
                   **lin(f"{q}.crossattention.self.value", b["ca_v"]),
                   **lin(f"{q}.crossattention.output.dense", b["ca_out"]),
                   **ln(f"{q}.crossattention.output.LayerNorm", b["ca_ln"]),
                   **lin(f"{q}.intermediate.dense", b["ff_in"]),
                   **lin(f"{q}.output.dense", b["ff_out"]),
                   **ln(f"{q}.output.LayerNorm", b["ff_ln"])})
    for i, layer in zip((0, 2, 4, 6, 7), mlp["layers"]):
        st.update(lin(f"mlp.layers.{i}", layer))
    return st


def med_config_json(tcfg):
    """BLIP's ``med_config.json`` (HF BERT keys) for ``tcfg``."""
    return {"architectures": ["BertModel"], "model_type": "bert", "hidden_act": "gelu",
            "hidden_size": tcfg.hidden, "num_hidden_layers": tcfg.layers,
            "num_attention_heads": tcfg.heads, "intermediate_size": tcfg.intermediate,
            "max_position_embeddings": tcfg.max_position, "vocab_size": tcfg.vocab,
            "encoder_width": tcfg.encoder_width, "layer_norm_eps": tcfg.eps,
            "add_cross_attention": True, "pad_token_id": 0, "type_vocab_size": 2}


def bert_vocab(n, seed):
    """A ``bert-base-uncased``-shaped vocabulary of ``n`` lines: [PAD],
    [unused0-98], [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103, every
    printable ASCII character and its ``##`` form, the lower-cased words of
    the smoke prompts, then random pieces (a quarter of them ``##``)."""
    import string

    import numpy as np

    rng = np.random.default_rng(seed)
    head = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]",
                                                              "[MASK]"]
    chars = [c for c in string.printable if not c.isspace() and not c.isupper()]
    words = sorted({w for p in REWARD_PROMPTS for w in re.findall(r"[a-z]+", p.lower())})
    vocab = head + chars + ["##" + c for c in chars] + words
    seen, letters = set(vocab), list(string.ascii_lowercase)
    while len(vocab) < n:
        w = "".join(rng.choice(letters, int(rng.integers(2, 9))))
        w = "##" + w if rng.random() < 0.25 else w
        if w not in seen:
            seen.add(w)
            vocab.append(w)
    return vocab[:n]


def write_reward_ckpts(torch, dev, geo, d):
    """The four reward checkpoints in their released layouts under ``d``,
    random weights from seeds 30-33 at ``geo``'s geometries (the port's
    initialisers, written through the inverse name maps): HPSv2.1 as an
    F16 OpenCLIP ``.pt`` nested under ``state_dict`` (bare, as released, when
    the geometry is the published one), PickScore_v1 as an HF ``CLIPModel``
    directory (``config.json`` + F32 ``model.safetensors`` by the port's
    ``save_file``), DFN5B as an F16 OpenCLIP ``.bin`` beside its
    ``open_clip_config.json``, ImageReward as an F32 ``ImageReward.pt`` with
    ``med_config.json`` and a 30,522-line ``vocab.txt``; and a CLIP merges
    table.  Returns the paths and each model's parameter count."""
    from mixgrpo_tpu_torch.models.text.blip import init_blip_text, init_blip_vision
    from mixgrpo_tpu_torch.models.text.clip import CLIPConfig, init_clip
    from mixgrpo_tpu_torch.utils.safetensors_io import save_file

    host = lambda st, dt: {k: v.to("cpu", dt).contiguous() for k, v in st.items()}
    gen = lambda seed: torch.Generator(dev).manual_seed(seed)
    count = lambda st: sum(v.numel() for v in st.values())
    paths, params = {"root": d}, {}
    os.makedirs(d, exist_ok=True)
    paths["merges"] = os.path.join(d, "merges.txt")
    with open(paths["merges"], "w") as f:
        f.write("\n".join(CLIP_MERGES) + "\n")

    os.makedirs(os.path.join(d, "hps"))
    paths["hps"] = os.path.join(d, "hps", "HPS_v2.1_compressed.pt")
    st = openclip_state(init_clip(geo["hps"], generator=gen(30), device=dev,
                                  dtype=torch.bfloat16))
    params["hps"] = count(st)
    torch.save({"state_dict": host(st, torch.float16)}, paths["hps"])
    if geo["hps"] != CLIPConfig.vit_h_14(224):
        with open(os.path.join(d, "hps", "open_clip_config.json"), "w") as f:
            json.dump(openclip_config_json(geo["hps"]), f)

    paths["pick_score"] = os.path.join(d, "PickScore_v1")
    st = hf_clip_state(init_clip(geo["pick_score"], generator=gen(31), device=dev,
                                 dtype=torch.bfloat16))
    params["pick_score"] = count(st)
    save_file(st, os.path.join(paths["pick_score"], "model.safetensors"), dtype=torch.float32)
    with open(os.path.join(paths["pick_score"], "config.json"), "w") as f:
        json.dump(hf_clip_config_json(geo["pick_score"]), f)

    os.makedirs(os.path.join(d, "DFN5B-CLIP-ViT-H-14-384"))
    paths["clip_score"] = os.path.join(d, "DFN5B-CLIP-ViT-H-14-384",
                                       "open_clip_pytorch_model.bin")
    st = openclip_state(init_clip(geo["clip_score"], generator=gen(32), device=dev,
                                  dtype=torch.bfloat16))
    params["clip_score"] = count(st)
    torch.save(host(st, torch.float16), paths["clip_score"])
    with open(os.path.join(os.path.dirname(paths["clip_score"]), "open_clip_config.json"),
              "w") as f:
        json.dump(openclip_config_json(geo["clip_score"]), f)
    del st

    ird = os.path.join(d, "ImageReward")
    os.makedirs(ird)
    vcfg, tcfg = geo["blip_vision"], geo["blip_text"]
    vp = init_blip_vision(vcfg, generator=gen(33), device=dev)
    tp = init_blip_text(tcfg, generator=gen(34), device=dev)
    g = gen(35)
    dims = [(tcfg.hidden, 1024), (1024, 128), (128, 64), (64, 16), (16, 1)]
    mlp = {"layers": [{"w": torch.randn(dd, generator=g, device=dev) * dd[0] ** -0.5,
                       "b": torch.zeros(dd[1], device=dev)} for dd in dims]}
    st = blip_state(vp, tp, mlp, vcfg)
    params["image_reward"] = count(st)
    paths["image_reward"] = os.path.join(ird, "ImageReward.pt")
    torch.save(host(st, torch.float32), paths["image_reward"])
    paths["med_config"] = os.path.join(ird, "med_config.json")
    with open(paths["med_config"], "w") as f:
        json.dump(med_config_json(tcfg), f)
    with open(os.path.join(ird, "vocab.txt"), "w") as f:
        f.write("\n".join(bert_vocab(30522, 36)) + "\n")
    del vp, tp, st
    return paths, params


def dir_bytes(path):
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(r, n)) for r, _, ns in os.walk(path) for n in ns)


def smoke_images(torch, dev, n, res, seed):
    """``n`` smooth random RGB images in [0, 1] at ``res``, f32 on ``dev``:
    12x12 noise upsampled bilinearly, plus a little fine noise."""
    g = torch.Generator(dev).manual_seed(seed)
    low = torch.rand((n, 3, 12, 12), generator=g, device=dev)
    x = torch.nn.functional.interpolate(low, size=(res, res), mode="bilinear",
                                        align_corners=False)
    x = x + 0.05 * torch.randn(x.shape, generator=g, device=dev)
    return x.clamp(0, 1).permute(0, 2, 3, 1).contiguous()


class StubVLM:
    """An OpenAI-style chat server on 127.0.0.1 in a thread: it answers
    ``Final Score: s`` with s = 1.0 + 0.5 * (i % 8) for the prompt tagged
    ``#i``; the prompt ``#UR_FAIL_ONCE`` first gets HTTP 500, and
    ``#UR_NO_SCORE`` a reply with no score."""

    def __init__(self):
        import http.server

        stub = self
        self.lock, self.failed, self.requests = threading.Lock(), set(), 0

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                text = body["messages"][0]["content"][0]["text"]
                i = int(re.findall(r"#(\d+)\]$", text)[-1])
                with stub.lock:
                    stub.requests += 1
                    fail = i == UR_FAIL_ONCE and i not in stub.failed
                    stub.failed.add(i)
                if fail:
                    self.send_response(500)
                    self.end_headers()
                    return
                content = ("I cannot rate this." if i == UR_NO_SCORE
                           else f"element (object): 1\nFinal Score: {StubVLM.score(i)}")
                out = json.dumps({"choices": [{"message": {"content": content}}]}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def log_message(self, *a):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    @staticmethod
    def score(i):
        return None if i == UR_NO_SCORE else 1.0 + 0.5 * (i % 8)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()


def rewards_phase(torch, FA, dev, card, root, geo=None, res=720):
    """The reward zoo at the published geometries (``reward_geometry``):
    (1) the four checkpoints written in their released layouts
    (``write_reward_ckpts``); (2) each loaded with ``from_checkpoint`` in
    bf16 onto the card, timed, with the host's peak RSS; (3) 12 images at
    720x720 scored by each model in bf16 and again by the model loaded in
    f32 (ms per batch, max |bf16 - f32| against ``REWARD_BF16_BOUND``, peak
    GB, 0 launches of every hand-written kernel), PickScore against its
    formula recomputed from the two feature sets; (4) UnifiedReward against
    ``StubVLM``; (5) ``eval_rewards.main`` over PNGs of the images and a
    metadata file, every model and the stub; (6) ``verify_weights.main``
    recording goldens for the four models, checking them, and catching a
    copy of the HPS file with one tensor changed.  Returns the paths for
    ``train_main_phase``; the files stay on disk for it (the caller removes
    them)."""
    import numpy as np
    from PIL import Image

    from mixgrpo_tpu_torch import eval_rewards as ER
    from mixgrpo_tpu_torch import verify_weights as VW
    from mixgrpo_tpu_torch.rewards import (
        CLIPScoreReward, HPSReward, PickScoreReward, UnifiedReward,
    )
    from mixgrpo_tpu_torch.rewards.image_reward import ImageRewardModel
    from mixgrpo_tpu_torch.train import find_bert_vocab_dir

    geo = geo or reward_geometry()
    d = os.path.join(root, ".smoke_rewards")
    t0 = time.perf_counter()
    paths, n_params = write_reward_ckpts(torch, dev, geo, d)
    torch.cuda.synchronize()
    sizes = {k: dir_bytes(paths[k]) for k in ("hps", "pick_score", "clip_score",
                                              "image_reward")}
    emit({"phase": "rewards_write", "seconds": time.perf_counter() - t0,
          "gb_written": dir_bytes(d) / 1e9, "gb_per_model": {k: v / 1e9 for k, v in sizes.items()},
          "params": n_params, "device": card})
    torch.cuda.empty_cache()

    vocab = find_bert_vocab_dir(paths["med_config"], paths["image_reward"])
    build = {
        "hpsv2": lambda dt: HPSReward.from_checkpoint(paths["hps"], paths["merges"], device=dev,
                                                      dtype=dt),
        "pick_score": lambda dt: PickScoreReward.from_checkpoint(
            paths["pick_score"], paths["merges"], device=dev, dtype=dt),
        "clip_score": lambda dt: CLIPScoreReward.from_checkpoint(
            paths["clip_score"], paths["merges"], device=dev, dtype=dt),
        "image_reward": lambda dt: ImageRewardModel.from_checkpoint(
            paths["image_reward"], paths["med_config"], vocab, device=dev, dtype=dt),
    }
    file_of = {"hpsv2": "hps", "pick_score": "pick_score", "clip_score": "clip_score",
               "image_reward": "image_reward"}
    images = smoke_images(torch, dev, len(REWARD_PROMPTS), res, 40)
    prompts = list(REWARD_PROMPTS)
    recs, ok = [], True
    for name, make in build.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with RssPeak() as rss:
            t0 = time.perf_counter()
            model = make(torch.bfloat16)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        weights_gb = torch.cuda.memory_allocated() / 1e9
        reset_launches(FA)
        model(images, prompts)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s16, ok16 = model(images, prompts)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {n: f.launches for n, f in FA.KERNEL_WRAPPERS.items()}
        peak = torch.cuda.max_memory_allocated() / 1e9
        formula_err = None
        if name == "pick_score":
            ids = model.tokenizer(prompts)
            img, txt = model.features(images, ids)
            cos = (img.double() * txt.double()).sum(-1)
            want = (torch.exp(model.params["logit_scale"].double()) * cos - 18.0) / 8.0
            got = model.score(images, ids).double()
            formula_err = float((got - want).abs().max())
        on_card = model.device.type == torch.device(dev).type
        del model
        torch.cuda.empty_cache()
        model = make(torch.float32)
        s32, _ = model(images, prompts)
        del model
        torch.cuda.empty_cache()
        err = float(np.abs(np.asarray(s16) - np.asarray(s32)).max())
        bound = REWARD_BF16_BOUND[name]
        rec = {"phase": "rewards_model", "model": name, "file_gb": sizes[file_of[name]] / 1e9,
               "load_s": load_s, "load_gb_per_s": sizes[file_of[name]] / 1e9 / load_s,
               "host_rss_before_gb": rss.before, "host_rss_peak_gb": rss.peak,
               "host_rss_rise_gb": rss.peak - rss.before, "weights_gb_on_card": weights_gb,
               "images": list(images.shape), "ms_per_batch_bf16": ms,
               "scores_bf16": s16, "max_abs_bf16_vs_f32": err, "bound": bound,
               "launches": launches, "peak_gb": peak, "on_card": on_card,
               "formula_max_abs_err": formula_err, "device": card}
        emit(rec)
        recs.append(rec)
        ok &= (err <= bound and not any(launches.values()) and on_card and all(ok16)
               and np.isfinite(s16).all() and (formula_err is None or formula_err <= 1e-4))
    if not ok:
        raise AssertionError("rewards: a model failed its checks (records above)")

    # -- UnifiedReward against the stub server ---------------------------------------
    want = [StubVLM.score(i) for i in range(len(prompts))]
    with StubVLM() as stub:
        t0 = time.perf_counter()
        scores, succ = UnifiedReward(stub.url, num_workers=4)(images, prompts)
        ur_s = time.perf_counter() - t0
        rec = {"phase": "rewards_unified", "url": stub.url, "scores": scores,
               "successes": succ, "requests": stub.requests, "seconds": ur_s, "device": card}
        emit(rec)
        if scores != want or succ != [w is not None for w in want] or \
                stub.requests != len(prompts) + 1:
            raise AssertionError(f"UnifiedReward: {rec}")

        # -- eval_rewards.main over PNGs and a metadata file --------------------------
        img_dir = os.path.join(d, "eval_images")
        os.makedirs(img_dir)
        arr = (images.cpu().numpy() * 255).round().astype(np.uint8)
        meta = []
        for i, p in enumerate(prompts):
            Image.fromarray(arr[i]).save(os.path.join(img_dir, f"img_{i:05d}.png"))
            meta.append({"image": f"img_{i:05d}.png", "prompt": p, "seed": i})
        with open(os.path.join(d, "metadata_0.json"), "w") as f:
            json.dump(meta, f)
        out = os.path.join(d, "eval_out")
        t0 = time.perf_counter()
        summary = ER.main(["--metadata", os.path.join(d, "metadata_0.json"), "--image_dir",
                           img_dir, "--output_dir", out, "--reward_model", "all",
                           "--batch_size", "6", "--hps_path", paths["hps"],
                           "--clip_score_path", paths["clip_score"], "--pick_score_path",
                           paths["pick_score"], "--image_reward_path", paths["image_reward"],
                           "--image_reward_med_config", paths["med_config"],
                           "--unified_reward_url", stub.url, "--clip_bpe_path",
                           paths["merges"], "--device", str(dev)])
        eval_s = time.perf_counter() - t0
    means_path = os.path.join(out, "reward_means.txt")
    ur_ok = [w for w in want if w is not None]
    rec = {"phase": "rewards_eval", "summary": summary, "seconds": eval_s,
           "reward_means_txt": os.path.exists(means_path), "device": card}
    emit(rec)
    names = ("hpsv2", "clip_score", "pick_score", "image_reward", "unified_reward")
    if not (rec["reward_means_txt"] and all(f"{n}_mean" in summary for n in names)
            and summary["unified_reward_count"] == len(ur_ok)
            and abs(summary["unified_reward_mean"] - float(np.mean(ur_ok))) < 1e-9
            and all(summary[f"{n}_count"] == len(prompts) for n in names[:4])):
        raise AssertionError(f"eval_rewards: {rec}")

    # -- verify_weights: record, check, catch a changed tensor -------------------------
    goldens = os.path.join(d, "goldens.npz")
    args = ["--hps", paths["hps"], "--pick-score", paths["pick_score"], "--clip-score",
            paths["clip_score"], "--image-reward", paths["image_reward"],
            "--image-reward-med-config", paths["med_config"], "--device", str(dev)]
    t0 = time.perf_counter()
    recorded = VW.main(["--goldens", goldens, "--record", *args])
    checked = VW.main(["--goldens", goldens, *args])
    st = torch.load(paths["hps"], map_location="cpu", weights_only=True, mmap=True)["state_dict"]
    st = dict(st)
    st["visual.proj"] = st["visual.proj"].clone()
    st["visual.proj"][:, : st["visual.proj"].shape[1] // 2] *= -1
    bad = os.path.join(d, "hps", "HPS_changed.pt")
    torch.save({"state_dict": st}, bad)
    del st
    corrupt = VW.run_checks({"hps": {"path": bad, "device": dev}}, goldens, record=False)
    rec = {"phase": "rewards_verify_weights", "recorded": recorded, "checked": checked,
           "changed_tensor": corrupt, "seconds": time.perf_counter() - t0, "device": card}
    emit(rec)
    if not (all(v == "recorded" for v in recorded.values()) and len(recorded) == 4
            and all(v == "ok" for v in checked.values())
            and corrupt["hps"].startswith("MISMATCH")):
        raise AssertionError(f"verify_weights: {rec}")
    torch.cuda.empty_cache()
    return paths


def train_main_phase(torch, FA, M, dev, card, root, paths, fam=None, res=720):
    """``preprocess.main`` then ``train.main`` on the recipe (``config.py``
    defaults: 720px, 25 steps, eta 0.7, 12 generations, window 4, fp32
    masters, AdamW) with ``--reward_model multi_reward`` on the ``rewards``
    phase's files, 2 steps, a checkpoint at the last one; then
    ``tsne_probe.main`` (1 prompt, 2 generations, SDE steps 0-3); then one
    ``train.main --rollout_quant int8`` step with HPS.  The FLUX
    directory is ``write_flux_dir``'s at full width, cut to ``TRAIN_DEPTH``
    blocks.  Each iteration's launches are counted from 0 just before it and
    read just after (a wrapper around ``train_one_step``), and the reward
    call's launches alone (around ``_compute_rewards``)."""
    import numpy as np

    from mixgrpo_tpu_torch import preprocess as Pre
    from mixgrpo_tpu_torch import train as T
    from mixgrpo_tpu_torch import tsne_probe as TP
    from mixgrpo_tpu_torch.data import native_loader as NL

    fam = fam or smoke_family(M)
    blocks = fam["flux"].depth_double + fam["flux"].depth_single
    tmp = os.path.join(root, ".smoke_train_main")
    d = os.path.join(tmp, "FLUX.1-dev")
    t0 = time.perf_counter()
    write_flux_dir(torch, M, dev, fam, d)
    torch.cuda.synchronize()
    with open(os.path.join(tmp, "prompts.txt"), "w") as f:
        f.write("\n".join(REWARD_PROMPTS[:4]) + "\n")
    cache = os.path.join(tmp, "cache")
    Pre.main(["--prompt_dir", os.path.join(tmp, "prompts.txt"), "--output_dir", cache,
              "--model_path", d, "--device", str(dev)], family=fam)
    setup_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    readers = compare_readers(cache, card)

    iters, reward_launches, advs, load_s = [], [], [], []
    step, rewards, mix_adv = T.GRPOTrainer.train_one_step, T.GRPOTrainer._compute_rewards, \
        T.masked_mix_advantages

    def counted_step(self, *a, **k):
        reset_launches(FA)
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(self, *a, **k)
        torch.cuda.synchronize()
        iters.append({"seconds": time.perf_counter() - t,
                      "launches": {n: f.launches for n, f in FA.KERNEL_WRAPPERS.items()},
                      **{k: m[k] for k in ("rollout_time", "decode_time", "reward_time",
                                           "update_time", "loss", "reward", "clip_frac")},
                      **{k: v for k, v in m.items() if k.startswith("reward/")}})
        return m

    def counted_rewards(self, *a, **k):
        before = {n: f.launches for n, f in FA.KERNEL_WRAPPERS.items()}
        out = rewards(self, *a, **k)
        reward_launches.append({n: f.launches - before[n] for n, f in FA.KERNEL_WRAPPERS.items()})
        return out

    def recorded_adv(*a, **k):
        adv = mix_adv(*a, **k)
        advs.append(adv.detach().float().cpu().numpy())
        return adv

    loader_iter, gather = T.PromptLoader.__iter__, NL.NativeShardReader.gather_rows
    native_gathers = []

    def counted_gather(self, *a, **k):
        native_gathers.append(1)
        return gather(self, *a, **k)

    def timed_iter(self):  # the time the trainer waits for each batch
        it = loader_iter(self)
        while True:
            t = time.perf_counter()
            batch = next(it)
            load_s.append(time.perf_counter() - t)
            yield batch

    out = os.path.join(tmp, "out")
    argv = ["--pretrained_model_name_or_path", d, "--data_json_path", cache,
            "--output_dir", out, "--experiment_name", "smoke", "--h", str(res), "--w", str(res),
            "--reward_model", "multi_reward", "--hps_path", paths["hps"],
            "--pick_score_path", paths["pick_score"], "--clip_score_path", paths["clip_score"],
            "--image_reward_path", paths["image_reward"],
            "--image_reward_med_config", paths["med_config"], "--max_train_steps", "2",
            "--checkpointing_steps", "2", "--export_safetensors", "off", "--device", str(dev)]
    T.GRPOTrainer.train_one_step, T.GRPOTrainer._compute_rewards = counted_step, counted_rewards
    T.masked_mix_advantages, T.PromptLoader.__iter__ = recorded_adv, timed_iter
    NL.NativeShardReader.gather_rows = counted_gather
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        trainer = T.main(argv, family=fam)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
    finally:
        T.GRPOTrainer.train_one_step, T.GRPOTrainer._compute_rewards = step, rewards
        T.masked_mix_advantages, T.PromptLoader.__iter__ = mix_adv, loader_iter
        NL.NativeShardReader.gather_rows = gather
    peak = torch.cuda.max_memory_allocated() / 1e9
    cfg = trainer.cfg
    g = cfg.grpo
    n_groups = g.num_generations // cfg.optim.gradient_accumulation_steps
    want = {"flash_attn_fwd": g.num_generations // g.rollout_chunk * g.sampling_steps * blocks,
            "flash_attn_fwd_lse": n_groups * 2 * blocks, "flash_attn_bwd_fused": n_groups * blocks,
            "flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0}
    names = ("hpsv2", "clip_score", "image_reward", "pick_score")
    with open(os.path.join(trainer.run_dir, "rewards.txt")) as f:
        txt = f.read()
    means = {n: [float(v) for v in re.findall(rf"^{n}: (\S+)$", txt, re.M)] for n in names}
    with open(os.path.join(trainer.run_dir, "rewards_samples_rank0.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    ckpt = trainer.ckpt.latest_step()
    disk = {"reward_files_gb": dir_bytes(paths["root"]) / 1e9,
            "flux_dir_gb": dir_bytes(d) / 1e9,
            "checkpoint_gb": dir_bytes(os.path.join(trainer.run_dir, "checkpoints")) / 1e9}
    rec = {"phase": "train_main", "setup_s": setup_s, "main_s": main_s, "iterations": iters,
           "expected_launches": want, "reward_launches": reward_launches,
           "advantages_finite": bool(advs) and all(np.isfinite(a).all() for a in advs),
           "advantage_shapes": [list(a.shape) for a in advs],
           "reward_means": means, "sample_rows": len(rows), "checkpoint_step": ckpt,
           "disk_gb": disk, "max_memory_allocated_gb": peak, "device": card,
           "native_reader_gathers": len(native_gathers),
           "loader_s": load_s, "loader_share_of_iteration": [
               ls / (ls + it["seconds"]) for ls, it in zip(load_s, iters)]}
    emit(rec)
    if not (len(iters) == 2 and all(it["launches"] == want for it in iters)
            and native_gathers and len(load_s) == 2
            and all(not any(r.values()) for r in reward_launches) and rec["advantages_finite"]
            and all(len(v) == 2 and np.isfinite(v).all() for v in means.values())
            and len(rows) == 2 * g.num_generations
            and all(n in rows[0] and np.isfinite(rows[0][n]) for n in names)
            and ckpt == 2 and peak < 80):
        raise AssertionError(f"train.main failed its checks: {rec}")
    del trainer
    torch.cuda.empty_cache()

    # -- tsne_probe.main on the same directory ------------------------------------------
    probe = os.path.join(tmp, "probe")
    reset_launches(FA)
    t0 = time.perf_counter()
    TP.main(["--model_path", d, "--data_json_path", cache, "--output_dir", probe,
             "--num_prompts", "1", "--num_generations", "2", "--SDE_sampling_start_step", "0",
             "--SDE_sampling_end_step", "4", "--device", str(dev)], family=fam)
    torch.cuda.synchronize()
    lat = np.load(os.path.join(probe, "latents_all_steps.npy"))
    T_steps, L = 25, (512 // 16) ** 2
    rec = {"phase": "tsne_probe", "seconds": time.perf_counter() - t0,
           "latents_all_steps": list(lat.shape), "finite": bool(np.isfinite(lat).all()),
           "launches": {n: f.launches for n, f in FA.KERNEL_WRAPPERS.items()},
           "expected_forward": blocks * T_steps, "device": card}
    emit(rec)
    if lat.shape != (2, T_steps + 1, L, fam["flux"].in_channels) or not rec["finite"] or \
            rec["launches"]["flash_attn_fwd"] != blocks * T_steps or \
            sum(rec["launches"].values()) != blocks * T_steps:
        raise AssertionError(f"tsne_probe: {rec}")

    # -- train.main --rollout_quant int8: one step with HPS, on the same files ---------
    import shutil

    shutil.rmtree(out)  # the bf16 run's 16 GB checkpoint
    iters.clear()
    argv_q = ["--pretrained_model_name_or_path", d, "--data_json_path", cache,
              "--output_dir", os.path.join(tmp, "out_int8"), "--experiment_name", "smoke",
              "--h", str(res), "--w", str(res), "--reward_model", "hpsv2", "--hps_path",
              paths["hps"], "--rollout_quant", "int8", "--max_train_steps", "1",
              "--export_safetensors", "off", "--device", str(dev)]
    T.GRPOTrainer.train_one_step = counted_step
    try:
        t0 = time.perf_counter()
        trainer = T.main(argv_q, family=fam)
        torch.cuda.synchronize()
        q_s = time.perf_counter() - t0
    finally:
        T.GRPOTrainer.train_one_step = step
    rec = {"phase": "train_main_int8", "main_s": q_s, "bf16_main_s": main_s,
           "rollout_quant": trainer.cfg.grpo.rollout_quant, "iterations": iters,
           "expected_launches": want, "device": card}
    emit(rec)
    if not (trainer.cfg.grpo.rollout_quant == "int8" and len(iters) == 1
            and iters[0]["launches"] == want
            and all(np.isfinite(iters[0][k]) for k in ("loss", "reward", "clip_frac"))):
        raise AssertionError(f"train.main --rollout_quant int8 failed its checks: {rec}")
    del trainer
    torch.cuda.empty_cache()
    return {"main_s": main_s, "peak_gb": peak}


def compare_readers(cache, card, reps=16):
    """The embedding cache's rows through the native reader and the numpy
    memmap: equal bit for bit, and each reader's rows/s with every row
    gathered ``reps`` times (after one pass that opens the shards)."""
    import numpy as np

    from mixgrpo_tpu_torch.data.dataset import LatentDataset

    out, rows = {}, {}
    for name, native in (("native", True), ("memmap", False)):
        ds = LatentDataset(cache, use_native=native)
        rows[name] = [ds.get(i) for i in range(len(ds))]
        t0 = time.perf_counter()
        for _ in range(reps):
            for i in range(len(ds)):
                ds.get(i)
        sec = time.perf_counter() - t0
        nbytes = sum(r["prompt_embed"].nbytes + r["pooled"].nbytes for r in rows[name])
        out[name] = {"rows_per_s": reps * len(ds) / sec, "f32_gb_per_s": reps * nbytes / sec / 1e9,
                     "seconds": sec}
    same = all(np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32))
               for a, b in zip(rows["native"], rows["memmap"]) for k in ("prompt_embed", "pooled"))
    first = rows["native"][0]
    rec = {"phase": "train_main_readers", "rows": len(rows["native"]), "gathers_per_row": reps,
           "row_shape": list(first["prompt_embed"].shape), "bit_for_bit": same, **out,
           "device": card}
    emit(rec)
    if not same:
        raise AssertionError(f"the native reader and the memmap differ: {rec}")
    return rec


def brightness_reward(images01, captions):
    """Synthetic reward: mean pixel brightness of each image (the JAX
    package's tests use the same one; no reward model is in the repository)."""
    r = images01.float().mean(dim=(1, 2, 3)).cpu().numpy().astype("float64")
    return {"brightness": r}, {"brightness": r * 0 + 1}


def train_phase(torch, FA, M, dev, card, root):
    """Two recipe GRPO iterations through ``GRPOTrainer.train_one_step`` at
    full FLUX.1-dev width with the depth cut to 2 double + 4 single blocks
    (fp32 master weights, AdamW state and grads of 1.30 B parameters do not
    fit 80 GB at full depth), the full random bf16 VAE decoder, random text
    embeddings through the embedding cache and the brightness reward; the
    window advances between the iterations as ``_train_loop`` does.  Launches
    are counted per iteration and must match the prediction exactly."""
    import tempfile

    import numpy as np

    from mixgrpo_tpu_torch.config import RunConfig, TrainConfig
    from mixgrpo_tpu_torch.data.dataset import (
        EmbeddingCacheWriter, LatentDataset, PromptLoader,
    )
    from mixgrpo_tpu_torch.models.flux.vae import VAEConfig, init_vae_decoder
    from mixgrpo_tpu_torch.train import GRPOTrainer

    flux_cfg = M.FluxConfig(depth_double=TRAIN_DEPTH[0], depth_single=TRAIN_DEPTH[1])
    vcfg = VAEConfig.flux_dev()
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        cfg = TrainConfig(run=RunConfig(output_dir=tmp, experiment_name="smoke"))
        g = cfg.grpo
        w = EmbeddingCacheWriter(os.path.join(tmp, "cache"))
        rng = np.random.default_rng(0)
        for i in range(4):
            w.add(rng.standard_normal((512, flux_cfg.context_dim), np.float32),
                  rng.standard_normal((flux_cfg.pooled_dim,), np.float32), f"prompt {i}")
        w.finish()
        loader = iter(PromptLoader(LatentDataset(os.path.join(tmp, "cache")),
                                   cfg.data.train_batch_size, seed=g.seed))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        vae = init_vae_decoder(vcfg, generator=torch.Generator(dev).manual_seed(2),
                               device=dev, dtype=torch.bfloat16)
        trainer = GRPOTrainer(cfg, flux_cfg=flux_cfg, vae_cfg=vcfg, vae_params=vae,
                              reward_fn=brightness_reward, device=dev)
        torch.cuda.synchronize()
        emit({"phase": "train_setup", "flux_params": M.param_count(trainer.params),
              "depth": TRAIN_DEPTH, "resolution": g.h, "sampling_steps": g.sampling_steps,
              "num_generations": g.num_generations, "rollout_chunk": g.rollout_chunk,
              "gradient_accumulation_steps": cfg.optim.gradient_accumulation_steps,
              "window": trainer.window.get_current_timesteps(),
              "seconds": time.perf_counter() - t0,
              "allocated_gb": torch.cuda.memory_allocated() / 1e9, "device": card})
        leaf = trainer.params["double"]["img_qkv"]["w"]
        before = leaf[0, :64, :64].detach().clone()
        blocks = sum(TRAIN_DEPTH)
        n_groups = g.num_generations // cfg.optim.gradient_accumulation_steps
        iters, launches = [], {}
        for it in range(2):
            timesteps = trainer.window.get_current_timesteps()
            trainer.window.update_iteration(rng=g.seed + trainer.global_step)
            batch = next(loader)
            reset_launches(FA)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m = trainer.train_one_step(batch, timesteps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            trainer.global_step += 1
            used = {n: f.launches for n, f in FA.KERNEL_WRAPPERS.items()}
            for n, c in used.items():
                launches[n] = launches.get(n, 0) + c
            want = {"flash_attn_fwd": g.num_generations // g.rollout_chunk * g.sampling_steps
                    * blocks,
                    "flash_attn_fwd_lse": n_groups * 2 * blocks,
                    "flash_attn_bwd_fused": n_groups * blocks,
                    "flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0}
            rec = {"phase": "train_iteration", "iteration": it, "window": timesteps,
                   "seconds": wall, "rollout_s": m["rollout_time"], "decode_s": m["decode_time"],
                   "update_s": m["update_time"],
                   "loss": m["loss"], "clip_frac": m["clip_frac"], "grad_norm": m["grad_norm"],
                   "reward": m["reward"], "launches": used, "expected_launches": want,
                   "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "device": card}
            emit(rec)
            iters.append(rec)
            if used != want:
                raise AssertionError(f"train iteration {it}: launches {used} != {want}")
            if not all(np.isfinite(m[k]) for k in ("loss", "grad_norm", "reward")):
                raise AssertionError(f"train iteration {it}: non-finite metrics {m}")
        changed = not torch.equal(before, leaf[0, :64, :64].detach())
        emit({"phase": "train", "iterations": 2, "params_changed": changed,
              "s_per_iteration": [r["seconds"] for r in iters], "launches": launches,
              "device": card})
        if not changed:
            raise AssertionError("train: the update left the parameters unchanged")

        # a third iteration with an int8 rollout: the same attention calls
        cfg.grpo.rollout_quant = "int8"
        timesteps = trainer.window.get_current_timesteps()
        trainer.window.update_iteration(rng=g.seed + trainer.global_step)
        batch = next(loader)
        reset_launches(FA)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = trainer.train_one_step(batch, timesteps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trainer.global_step += 1
        used = {n: f.launches for n, f in FA.KERNEL_WRAPPERS.items()}
        rec = {"phase": "train_iteration_int8", "rollout_quant": "int8", "window": timesteps,
               "seconds": wall, "rollout_s": m["rollout_time"], "decode_s": m["decode_time"],
               "update_s": m["update_time"], "rollout_s_bf16": [r["rollout_s"] for r in iters],
               "loss": m["loss"], "clip_frac": m["clip_frac"], "ratio_mean": m["ratio_mean"],
               "grad_norm": m["grad_norm"], "reward": m["reward"], "launches": used,
               "expected_launches": want,
               "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
               "device": card}
        emit(rec)
        if used != want or not all(np.isfinite(m[k]) for k in ("loss", "grad_norm", "reward",
                                                                 "clip_frac")):
            raise AssertionError(f"int8 train iteration failed its checks: {rec}")
        trainer.close()
        del trainer, vae
    return launches


def update_full_depth_phase(torch, FA, M, dev, card):
    """One ``update_step`` of ``make_update_fns(..., virtual_depth=(19, 38))``
    over a 1-double/2-single stack at full width: the full-depth update's
    compute (57 block applications forward, recompute and backward) on one
    card.  720px with 12 pairs (fused backward) and 1024px with 2 pairs
    (split backward)."""
    import numpy as np

    from mixgrpo_tpu_torch.models.flux.rope import make_image_ids, make_text_ids, rope_tables
    from mixgrpo_tpu_torch.rl.ppo import PPOConfig
    from mixgrpo_tpu_torch.solvers.rollout import SamplerConfig
    from mixgrpo_tpu_torch.solvers.schedule import sigma_schedule
    from mixgrpo_tpu_torch.trainer import UpdateBatch, make_optimizer, make_update_fns

    cfg = M.FluxConfig(depth_double=1, depth_single=2)
    params = M.init_flux(cfg, generator=torch.Generator(dev).manual_seed(30), device=dev)
    opt = make_optimizer(learning_rate=1e-5)
    opt_state = opt.init(params)
    sig = torch.as_tensor(sigma_schedule(25, 3.0), device=dev)
    out = {}
    for res, N in ((720, 12), (1024, 2)):
        lat = res // 8
        ids = np.concatenate([make_text_ids(512), make_image_ids(lat, lat)])
        cos, sin = rope_tables(ids, cfg.axes_dims, cfg.theta, device=dev)
        update_step, _, _ = make_update_fns(
            cfg, SamplerConfig(num_steps_max=25), PPOConfig(), opt, cos, sin,
            remat=True, virtual_depth=FULL_DEPTH)
        g = torch.Generator(dev).manual_seed(31)
        L = (lat // 2) ** 2
        x = torch.randn((N, L, cfg.in_channels), generator=g, device=dev)
        batch = UpdateBatch(
            latents=x, next_latents=x + 0.01 * torch.randn(x.shape, generator=g, device=dev),
            t_index=torch.arange(N, device=dev) % 4,
            old_log_probs=torch.zeros(N, device=dev),
            advantages=torch.randn((N,), generator=g, device=dev),
            txt=torch.randn((N, 512, cfg.context_dim), generator=g, device=dev).bfloat16(),
            pooled=torch.randn((N, cfg.pooled_dim), generator=g, device=dev).bfloat16())
        reset_launches(FA)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, opt_state, m = update_step(params, opt_state, batch, sig)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        used = {n: f.launches for n, f in FA.KERNEL_WRAPPERS.items()}
        apps = sum(FULL_DEPTH)
        Sp = 512 + L + (-(512 + L)) % 128  # flux_forward's padded joint sequence
        bwd = FA.default_bwd(Sp, Sp)
        want = {"flash_attn_fwd": 0, "flash_attn_fwd_lse": 2 * apps,
                "flash_attn_bwd_fused": apps if bwd == "fused" else 0,
                "flash_attn_bwd_dkv": apps if bwd == "split" else 0,
                "flash_attn_bwd_dq": apps if bwd == "split" else 0}
        # a finite global grad norm means every grad is finite
        params_finite = all(bool(t.isfinite().all()) for t in M.param_leaves(params))
        rec = {"phase": "update_full_depth", "resolution": res, "pairs": N,
               "virtual_depth": FULL_DEPTH, "stack": [1, 2], "backward": bwd,
               "seconds": sec, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "params_finite": params_finite, "launches": used, "expected_launches": want,
               "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
               "device": card}
        emit(rec)
        if used != want:
            raise AssertionError(f"update_full_depth {res}px: launches {used} != {want}")
        if not (np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"]) and params_finite):
            raise AssertionError(f"update_full_depth {res}px: non-finite loss, grads or params")
        out[res] = rec
    return out


def trace_events(path, chunk=1 << 24):
    """The ``traceEvents`` of a Chrome trace, one event at a time, decoded
    from a rolling buffer: a full-depth iteration's trace is too big to load
    whole."""
    dec = json.JSONDecoder()
    with open(path) as f:
        buf = f.read(chunk)
        while '"traceEvents"' not in buf:
            more = f.read(chunk)
            if not more:
                return
            buf += more
        i = buf.index("[", buf.index('"traceEvents"')) + 1
        while True:
            while i < len(buf) and buf[i] in " \t\r\n,":
                i += 1
            if i < len(buf) and buf[i] == "]":
                return
            try:
                if i >= len(buf):
                    raise ValueError("need more")
                ev, i = dec.raw_decode(buf, i)
            except ValueError:
                more = f.read(chunk)
                if not more:
                    raise
                buf, i = buf[i:] + more, 0
                continue
            yield ev


def kernel_class(name):
    low = name.lower()
    if any(s in low for s in ("flash_fwd_kernel", "flash_bwd", "bwd_stats_kernel",
                              "key_term_kernel")):
        return "flash_attn"
    if any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "cublas")):
        return "gemm"
    if "copy_kernel" in low or "catarray" in low:
        return "copy"  # dtype casts, contiguous copies, concatenations
    if any(s in low for s in ("elementwise", "reduce_kernel", "vectorized", "softmax", "norm",
                              "index")):
        return "elementwise"
    return "other"


def trace_summary(path, spans=("rollout", "decode", "update")):
    """Device breakdown of a ``utils.profiling.trace`` file: device-busy ms
    by kernel class (memcpy and memset under "other"), overall and inside
    each named span, the top ten kernels, and the idle share of the traced
    window (first to last event of any kind) from the union of device
    intervals."""
    def zero():
        return {"gemm": 0.0, "flash_attn": 0.0, "copy": 0.0, "elementwise": 0.0, "other": 0.0}

    classes, per_kernel, kernels, span_at = zero(), {}, [], {}
    lo, hi, n_events = float("inf"), 0.0, 0
    for ev in trace_events(path):
        n_events += 1
        if ev.get("ph") != "X":
            continue
        ts, dur = float(ev.get("ts", 0)), float(ev.get("dur", 0))
        lo, hi = min(lo, ts), max(hi, ts + dur)
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            cls = kernel_class(name) if cat == "kernel" else "other"
            classes[cls] += dur / 1e3
            k = per_kernel.setdefault(name, [0.0, 0])
            k[0] += dur / 1e3
            k[1] += 1
            kernels.append((ts, ts + dur, cls))
        elif name in spans and cat in ("user_annotation", "cpu_op"):
            span_at.setdefault(name, (ts, ts + dur))
    kernels.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e, _ in kernels:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span_ms = {}
    for name, (s, e) in span_at.items():
        by = zero()
        for a, b, cls in kernels:
            if b > s and a < e:
                by[cls] += (min(b, e) - max(a, s)) / 1e3
        span_ms[name] = {"wall_ms": (e - s) / 1e3, "device_busy_ms": sum(by.values()),
                         "class_ms": by}
    window_ms = (hi - lo) / 1e3 if hi > lo else 0.0
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    return {"events": n_events, "device_kernels": len(kernels),
            "traced_window_ms": window_ms, "device_busy_ms": busy / 1e3,
            "idle_share": 1 - busy / 1e3 / window_ms if window_ms else None,
            "class_ms": classes, "spans": span_ms,
            "top_kernels": [{"name": n[:240], "ms": ms, "count": c} for n, (ms, c) in top]}


def train_flash_lora_phase(torch, FA, M, dev, card, root):
    """MixGRPO-Flash with LoRA at full FLUX.1-dev width: a frozen random bf16
    base of ``FLASH_LORA_DEPTH`` blocks (10 + 19 of 19 + 38), a rank-16 adapter on
    ``lora.DEFAULT_TARGETS``, the recipe's rollout and update (720px, 25
    steps, eta 0.7, 12 generations in chunks of 2, window 4, accumulation 3,
    gradient checkpointing) with DPM-Solver++ order 2 (midpoint) on the tail
    after the window compressed by 0.4, the full random bf16 VAE decoder,
    random text embeddings through the embedding cache and the brightness
    reward.  ``GRPOTrainer.train`` runs two iterations with
    ``profile_steps=1``, so the second one is traced by the trainer's own
    profiler.  Launches are counted per iteration (reset just before it,
    read just after) and must match the prediction exactly; the base must be
    left bit for bit, some ``b`` factor must move, metrics must be finite and
    the peak below 80 GB."""
    import dataclasses
    import tempfile

    import numpy as np

    from mixgrpo_tpu_torch.config import DPMConfig, RunConfig, TrainConfig
    from mixgrpo_tpu_torch.data.dataset import (
        EmbeddingCacheWriter, LatentDataset, PromptLoader,
    )
    from mixgrpo_tpu_torch.models.flux.vae import VAEConfig, init_vae_decoder
    from mixgrpo_tpu_torch.ops import qk_rope as QR
    from mixgrpo_tpu_torch.train import GRPOTrainer

    flux_cfg = dataclasses.replace(M.FluxConfig.flux_dev(), depth_double=FLASH_LORA_DEPTH[0],
                                   depth_single=FLASH_LORA_DEPTH[1])
    vcfg = VAEConfig.flux_dev()
    blocks = flux_cfg.depth_double + flux_cfg.depth_single
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        cfg = TrainConfig(
            dpm=DPMConfig(dpm_algorithm_type="dpmsolver++", dpm_apply_strategy="post",
                          dpm_post_compress_ratio=0.4, dpm_solver_order=2,
                          dpm_solver_type="midpoint"),
            run=RunConfig(output_dir=tmp, experiment_name="flash_lora", profile_steps=1,
                          export_safetensors="off"))
        cfg.optim.max_train_steps = 2
        g = cfg.grpo
        w = EmbeddingCacheWriter(os.path.join(tmp, "cache"))
        rng = np.random.default_rng(0)
        for i in range(4):
            w.add(rng.standard_normal((512, flux_cfg.context_dim), np.float32),
                  rng.standard_normal((flux_cfg.pooled_dim,), np.float32), f"prompt {i}")
        w.finish()
        loader = PromptLoader(LatentDataset(os.path.join(tmp, "cache")),
                              cfg.data.train_batch_size, seed=g.seed)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        base = M.init_flux(flux_cfg, generator=torch.Generator(dev).manual_seed(g.seed),
                           device=dev, dtype=torch.bfloat16)
        vae = init_vae_decoder(vcfg, generator=torch.Generator(dev).manual_seed(2),
                               device=dev, dtype=torch.bfloat16)
        trainer = GRPOTrainer(cfg, flux_cfg=flux_cfg, params=base, vae_cfg=vcfg,
                              vae_params=vae, reward_fn=brightness_reward, device=dev,
                              use_lora=True, lora_rank=16, lora_alpha=16.0)
        torch.cuda.synchronize()
        factors = trainer.lora_factors
        emit({"phase": "train_flash_lora_setup", "flux_params": M.param_count(base),
              "lora_params": M.param_count(factors), "lora_targets": len(factors),
              "depth": [flux_cfg.depth_double, flux_cfg.depth_single], "resolution": g.h,
              "sampling_steps": g.sampling_steps, "num_generations": g.num_generations,
              "rollout_chunk": g.rollout_chunk,
              "gradient_accumulation_steps": cfg.optim.gradient_accumulation_steps,
              "dpm": dataclasses.asdict(cfg.dpm), "seconds": time.perf_counter() - t0,
              "allocated_gb": torch.cuda.memory_allocated() / 1e9, "device": card})
        # a corner of targeted and untargeted base leaves, at several depths
        probes = [base["double"]["img_qkv"]["w"][0], base["double"]["txt_mlp_in"]["w"][-1],
                  base["single"]["linear1"]["w"][-1], base["single"]["linear2"]["w"][0],
                  base["single"]["mod"]["lin"]["w"][1], base["x_embedder"]["w"]]
        before = [t[:64, :64].clone() for t in probes]
        inner, iters, launches = trainer.train_one_step, [], {}

        def counted(batch, timesteps):
            _, _, n = trainer._schedule_for_window(timesteps)
            reset_launches(FA)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m = inner(batch, timesteps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            used = {k: f.launches for k, f in FA.KERNEL_WRAPPERS.items()}
            used.update({k: f.launches for k, f in QR.KERNEL_WRAPPERS.items()})
            for k, c in used.items():
                launches[k] = launches.get(k, 0) + c
            n_groups = -(-g.num_generations // cfg.optim.gradient_accumulation_steps)
            L = (g.h // 16) * (g.w // 16)
            Sp = 512 + L + (-(512 + L)) % 128  # flux_forward's padded joint sequence
            bwd = FA.default_bwd(Sp, Sp)
            want = {"flash_attn_fwd": g.num_generations // g.rollout_chunk * n * blocks,
                    "flash_attn_fwd_lse": n_groups * 2 * blocks,
                    "flash_attn_bwd_fused": n_groups * blocks if bwd == "fused" else 0,
                    "flash_attn_bwd_dkv": n_groups * blocks if bwd == "split" else 0,
                    "flash_attn_bwd_dq": n_groups * blocks if bwd == "split" else 0}
            # one QK-norm + RoPE forward a block wherever attention runs (the
            # update's forward and its recompute included), one backward a block
            want["qk_rope_fwd"] = want["flash_attn_fwd"] + want["flash_attn_fwd_lse"]
            want["qk_rope_bwd"] = n_groups * blocks
            rec = {"phase": "train_flash_lora_iteration", "iteration": len(iters),
                   "window": list(timesteps), "num_steps": m["num_steps"],
                   "predicted_num_steps": n, "seconds": wall, "rollout_s": m["rollout_time"],
                   "decode_s": m["decode_time"], "update_s": m["update_time"],
                   "loss": m["loss"], "clip_frac": m["clip_frac"],
                   "grad_norm": m["grad_norm"], "reward": m["reward"], "launches": used,
                   "expected_launches": want, "backward": bwd,
                   "traced": trainer.profile_trace is not None,
                   "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "device": card}
            emit(rec)
            iters.append(rec)
            if used != want or m["num_steps"] != n:
                raise AssertionError(f"train_flash_lora iteration {rec['iteration']}: "
                                     f"launches {used} != {want} or num_steps "
                                     f"{m['num_steps']} != {n}")
            if not all(np.isfinite(m[k]) for k in ("loss", "grad_norm", "reward")):
                raise AssertionError(f"train_flash_lora: non-finite metrics {m}")
            if rec["max_memory_allocated_gb"] >= 80:
                raise AssertionError(f"train_flash_lora: peak {rec['max_memory_allocated_gb']} GB")
            return m

        trainer.train_one_step = counted
        t0 = time.perf_counter()
        trainer.train(loader)
        train_s = time.perf_counter() - t0
        base_same = all(torch.equal(t[:64, :64], b) for t, b in zip(probes, before))
        b_moved = any(bool(f["b"].abs().sum() > 0) for f in trainer.lora_factors.values())
        tr = trainer.profile_trace
        trace_ok = tr is not None and tr.path is not None and os.path.exists(tr.path)
        rec = {"phase": "train_flash_lora", "iterations": len(iters), "blocks": blocks,
               "train_s": train_s, "s_per_iteration": [r["seconds"] for r in iters],
               "launches": launches, "base_unchanged": base_same, "b_factor_moved": b_moved,
               "trace_written": trace_ok,
               "max_memory_allocated_gb": max(r["max_memory_allocated_gb"] for r in iters),
               "device": card}
        if trace_ok:
            t0 = time.perf_counter()
            summary = trace_summary(tr.path)
            emit({"phase": "train_flash_lora_profile", "what": "the second iteration, "
                  "traced by GRPOTrainer.train (profile_steps=1)",
                  "trace_mb": os.path.getsize(tr.path) / 1e6,
                  "export_s": tr.export_seconds, "summary_s": time.perf_counter() - t0,
                  **summary, "device": card})
        emit(rec)
        if not (len(iters) == 2 and base_same and b_moved and trace_ok):
            raise AssertionError(f"train_flash_lora failed its checks: {rec}")
        del trainer, base, vae, factors, probes, before
    return launches


# ----------------------------------------------------------------------------
# several ranks (parallel/)
# ----------------------------------------------------------------------------

PAR_ATTN = dict(B=2, H=24, S=4608, D=128)  # FLUX.1-dev heads at 1024px
PAR_TRAIN_G = 2  # generations per prompt; one prompt per rank
# parallel_train's limits on the ranks' update against one rank's: the rel L2
# of the sampled parameter change, and the grad norm's rel difference.  On an
# H100 80GB HBM3 (700 W) sound runs read 0.0065 and 1.8e-5; planted faults in
# parallel/sharding.py::reduce_grads read 0.149 and 0.049 (fsdp-sharded
# gradients summed, not averaged) and 0.79 and 0.29 (replicated leaves not
# all-reduced, so each rank steps them on half the batch)
PAR_UPDATE_REL_L2 = 0.05
PAR_GRAD_NORM_REL = 1e-3
# parallel_tp: the seed of its weights, whose biases are drawn with this
# standard deviation (``tp_params``), and its limits on the tp ranks against
# one rank: the final latents' rel L2, each row's reward, the update's rel
# L2 and the grad norm's rel difference.  On an H100 80GB HBM3 (700 W) a
# sound run read 4.2e-4, 4.5e-6, 0.0106 and 2.0e-5; planted faults read
# 4.2e-4, 4.5e-6, 0.128 and 5.9e-5 (tp_enter's backward skips its
# all-reduce, so the replicated leaves also drift apart between the tp
# ranks) and 3.3e-3, 4.4e-5, 0.078 and 1.8e-4 (the row-parallel bias added
# on both ranks)
PAR_TP_SEED = 13
PAR_TP_BIAS_STD = 0.02
PAR_TP_FINAL_REL_L2 = 1.5e-3
PAR_TP_REWARD_ABS = 2e-5
PAR_TP_UPDATE_REL_L2 = 0.04
PAR_TP_GRAD_NORM_REL = 1e-4


def parallel_layout(torch):
    """The number of ranks of the multi-rank phases: one per card where the
    machine has two cards or more (up to 4), else two sharing the one card.
    Rank r runs on ``cuda:<r mod cards>``; ``parallel.mesh.backend_for``
    picks the backend (NCCL for a card each, gloo for ranks sharing one:
    NCCL refuses two ranks of one communicator on one device)."""
    n = torch.cuda.device_count()
    return min(n, 4) if n >= 2 else 2


def layout_note(world, backend):
    if backend == "gloo":
        return f"{world} ranks sharing one card: times say nothing of {world} cards"
    return f"{world} ranks, one card each"


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(case, d, timeout, world, extra=()):
    """``case`` on ``world`` ranks (``python3 chip_smoke.py --rank ...``, one
    process each, placed by ``parallel_layout``, rendezvous at ``localhost``); each
    rank's output goes to ``d/rank<r>.log`` and its record to
    ``d/rank<r>.json``.  Raises, after printing every failed rank's log tail
    (its traceback), when a rank fails or any rank is still running after
    ``timeout`` seconds (then every rank is killed)."""
    port = free_port()
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        log = open(os.path.join(d, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", case, str(r), str(world),
             str(port), d, *extra], stdout=log, stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + timeout
    hung = False
    try:
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                hung = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r in bad:
        with open(os.path.join(d, f"rank{r}.log")) as f:
            tail = f.read()[-5000:]
        print(f"chip_smoke: {case} rank {r} exit {procs[r].returncode}"
              f"{' (killed: a rank outlived the timeout)' if hung else ''}:\n{tail}",
              file=sys.stderr, flush=True)
    if hung or bad:
        raise AssertionError(f"{case}: ranks {bad} failed" +
                             (f" or hung past {timeout} s" if hung else ""))
    out = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def rank_main(argv):
    """One rank of a multi-rank phase (``--rank CASE RANK WORLD PORT DIR
    [ARGS]``)."""
    case, rank, world, port, d = argv[:5]
    rank, world = int(rank), int(world)
    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    from mixgrpo_tpu_torch.ops import flash_attention as FA
    from mixgrpo_tpu_torch.parallel import collectives as C
    from mixgrpo_tpu_torch.parallel.mesh import init_distributed

    # the CLIs start torch.distributed themselves
    if case in ("attention", "train", "tp", "video_sp", "lora"):
        init_distributed(f"localhost:{port}", world, rank, device=dev)
    rec = {"rank": rank, "case": case}
    fn = {"attention": rank_attention, "train": rank_train, "tp": rank_train,
          "sample": rank_sample, "eval": rank_eval, "video_sp": rank_video_sp,
          "lora": rank_lora}[case]
    fn(torch, FA, C, dev, rank, world, d, rec, argv[5:])
    rec["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    import torch.distributed as dist

    rec["backend"] = dist.get_backend() if dist.is_initialized() else None
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0


def rank_attention(torch, FA, C, dev, rank, world, d, rec, extra):
    """Ulysses and ring (sp = ranks) through ``attention(impl=...)`` on whole
    bf16 tensors at FLUX.1-dev width, forward and backward, with and without
    a key mask; each run held against one-rank ``attention(impl="flash")``
    on the rank's card (``close_bf16``)."""
    from mixgrpo_tpu_torch.ops.attention import attention
    from mixgrpo_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from mixgrpo_tpu_torch.parallel.ulysses import set_sp_context

    mesh = make_mesh(MeshConfig(dp=1, sp=world), device=dev)
    set_sp_context(mesh, "sp")
    B, H, S, D = (PAR_ATTN[k] for k in "BHSD")
    g = torch.Generator(dev).manual_seed(61)  # the same tensors on every rank
    q, k, v, do = (torch.randn((B, H, S, D), generator=g, device=dev).bfloat16()
                   for _ in range(4))
    keep = torch.rand((B, S), generator=g, device=dev) > 0.1
    keep[:, :64] = True
    runs = []
    for impl in ("ulysses", "ring"):
        for masked in (False, True):
            mask = keep[:, None, None, :] if masked else None

            def run(impl=impl, mask=mask):
                qf, kf, vf = (t.clone().requires_grad_(True) for t in (q, k, v))
                o = attention(qf, kf, vf, mask=mask, impl=impl)
                o.backward(do)
                return o.detach(), qf.grad, kf.grad, vf.grad

            run()  # warm-up: allocations and first calls
            torch.cuda.synchronize()
            reset_launches(FA)
            C.reset_transport()
            t0 = time.perf_counter()
            got = run()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {n: f.launches for n, f in FA.KERNEL_WRAPPERS.items()}
            transport = C.transport_record()
            want = run("flash")  # one rank, no sequence split: the comparison
            checks = {}
            for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
                ok, err, rel = close_bf16(a, b)
                checks[name] = {"ok": ok, "max_abs_err": err, "rel_l2": rel}
            bwd = FA.default_bwd(S, S)
            expect = {n: 0 for n in launches}
            if impl == "ulysses":  # one forward with lse and one backward per run
                expect["flash_attn_fwd_lse"] = 1
                for n in (("flash_attn_bwd_fused",) if bwd == "fused"
                          else ("flash_attn_bwd_dkv", "flash_attn_bwd_dq")):
                    expect[n] = 1
            runs.append({"impl": impl, "masked": masked, "ms_fwd_bwd": ms,
                         "launches": launches, "expected_launches": expect,
                         "transport": transport, "checks": checks,
                         "local_shape": [B, H // world if impl == "ulysses" else H,
                                         S if impl == "ulysses" else S // world, D]})
    rec["runs"] = runs
    # one collective at a time on a rank's (B, H, S/2, D) bf16 slice, 5 calls each
    ql = q.chunk(world, dim=2)[rank].contiguous()
    ops = {"all_to_all": lambda: C.all_to_all_along(ql, mesh, "sp", 1, 2),
           "all_gather": lambda: C.gather_along(ql, mesh, "sp", 2),
           "send_recv": lambda: C.shift_along(ql, mesh, "sp", 1)}
    rec["collective_ms"] = {"bytes_per_rank": ql.numel() * ql.element_size()}
    for name, fn in ops.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        rec["collective_ms"][name] = (time.perf_counter() - t0) * 1e3 / 5


def _train_setup(torch, dev, d, mesh_cfg, accum, export, depth):
    """The multi-rank phases' trainer: full FLUX.1-dev width, ``depth``
    (double, single) blocks, the recipe's 720px, 25 steps and window,
    PAR_TRAIN_G generations per prompt in chunks of 2, the random bf16 VAE
    and the brightness reward."""
    import dataclasses

    from mixgrpo_tpu_torch.config import RunConfig, TrainConfig
    from mixgrpo_tpu_torch.models.flux import model as M
    from mixgrpo_tpu_torch.models.flux.vae import VAEConfig, init_vae_decoder
    from mixgrpo_tpu_torch.train import GRPOTrainer

    cfg = TrainConfig(run=RunConfig(output_dir=d, experiment_name="smoke_parallel",
                                    export_safetensors=export))
    cfg = dataclasses.replace(
        cfg, mesh=mesh_cfg,
        grpo=dataclasses.replace(cfg.grpo, num_generations=PAR_TRAIN_G, rollout_chunk=2),
        optim=dataclasses.replace(cfg.optim, gradient_accumulation_steps=accum))
    flux_cfg = M.FluxConfig(depth_double=depth[0], depth_single=depth[1])
    vcfg = VAEConfig.flux_dev()
    vae = init_vae_decoder(vcfg, generator=torch.Generator(dev).manual_seed(2), device=dev,
                           dtype=torch.bfloat16)
    return cfg, flux_cfg, vcfg, vae, GRPOTrainer


def sampled_leaves(leaves, n=65536):
    """Every ``len // n``-th entry of each (whole) leaf, concatenated, as
    float32 numpy."""
    import numpy as np

    out = []
    for t in leaves:
        flat = t.detach().reshape(-1)
        out.append(flat[::max(1, flat.numel() // n)].float().cpu().numpy())
    return np.concatenate(out)


def tp_params(torch, flux_cfg, dev):
    """``init_flux`` from parallel_tp's seed with every bias drawn (``init_flux``'s
    are zero, which would hide a bias that the tp ranks add more than once)."""
    from mixgrpo_tpu_torch.models.flux import model as M

    g = torch.Generator(dev).manual_seed(PAR_TP_SEED)
    params = M.init_flux(flux_cfg, generator=g, device=dev)

    def draw(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                draw(v)
            elif k == "b":
                v.normal_(0.0, PAR_TP_BIAS_STD, generator=g)

    draw(params)
    return params


def leaf_hash(torch, t, chunk=1 << 24):
    """An exact, position-sensitive checksum of a tensor's bits: the sum of
    each 32-bit word times (its index mod 65521) + 1, in int64 (wrapping)."""
    words = t.detach().contiguous().view(torch.int32).reshape(-1)
    total = 0
    for off in range(0, words.numel(), chunk):
        w = words[off:off + chunk].long()
        i = torch.arange(off, off + w.numel(), device=w.device) % 65521 + 1
        total += int((w * i).sum())
    return total % (1 << 64)


def state_hashes(torch, leaves, opt):
    """``leaf_hash`` of each parameter leaf and of its AdamW moments."""
    group = opt.param_groups[0]["params"]
    return {"params": [leaf_hash(torch, t) for t in leaves],
            "exp_avg": [leaf_hash(torch, opt.state[p]["exp_avg"]) for p in group],
            "exp_avg_sq": [leaf_hash(torch, opt.state[p]["exp_avg_sq"]) for p in group]}


def rank_train(torch, FA, C, dev, rank, world, d, rec, extra):
    """``train_ref``: one iteration on one rank over every prompt
    (accumulation PAR_TRAIN_G per prompt: one update group); ``train``: one
    iteration of the same global batch on mesh (dp 1, fsdp = ranks), one
    prompt per rank (accumulation PAR_TRAIN_G), then a sharded checkpoint
    with the export and a resume into a new trainer.  ``tp_ref`` and ``tp``
    are the same on parallel_tp's mesh (dp 1, fsdp = ranks / 2, tp 2: one
    prompt per batch rank) with drawn biases (``tp_params``); ``tp`` also
    writes each rank's ``state_hashes`` for ``tp_restore``.  Every run takes
    the same injected noise: the one-rank run's chunk j is batch rank j's
    rows."""
    import numpy as np

    from mixgrpo_tpu_torch.models.flux.model import param_leaves
    from mixgrpo_tpu_torch.parallel.mesh import MeshConfig
    from mixgrpo_tpu_torch.parallel.sharding import flatten_specs, gather_leaf

    case = rec["case"]
    multi, tp = case in ("train", "tp"), case in ("tp", "tp_ref")
    n_p = int(extra[0])  # prompts: one per batch rank of the multi-rank run
    mesh_cfg = (MeshConfig(dp=1, fsdp=world) if case == "train" else
                MeshConfig(dp=1, fsdp=world // 2, tp=2) if case == "tp" else
                MeshConfig(1, 1, 1, 1))
    accum = PAR_TRAIN_G if multi else PAR_TRAIN_G * n_p
    cfg, flux_cfg, vcfg, vae, GRPOTrainer = _train_setup(
        torch, dev, os.path.join(d, f"run_{case}"), mesh_cfg, accum,
        "required" if multi else "off", PAR_DEPTH)
    scores = []

    def reward_fn(images01, captions):
        r = brightness_reward(images01, captions)
        scores.append(r[0]["brightness"])
        return r

    t0 = time.perf_counter()
    trainer = GRPOTrainer(cfg, flux_cfg=flux_cfg, vae_cfg=vcfg, vae_params=vae,
                          params=tp_params(torch, flux_cfg, dev) if tp else None,
                          reward_fn=reward_fn, device=dev)
    torch.cuda.synchronize()
    rec["setup_s"] = time.perf_counter() - t0
    finals = []
    rollout = trainer.sampler.chunked_rollout

    def kept_rollout(*a, **k):
        out = rollout(*a, **k)
        finals.append(out.final_latents.float().cpu().numpy())
        return out

    trainer.sampler.chunked_rollout = kept_rollout
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((n_p, 512, flux_cfg.context_dim), np.float32)
    pooled = rng.standard_normal((n_p, flux_cfg.pooled_dim), np.float32)
    b = trainer.mesh.batch_index
    rows = slice(b, b + 1) if multi else slice(0, n_p)
    batch = {"prompt_embed": emb[rows], "pooled": pooled[rows],
             "captions": [f"prompt {i}" for i in range(n_p)][rows]}
    L = trainer.sampler.num_image_tokens
    g = torch.Generator(dev).manual_seed(41)
    z0 = torch.randn((n_p * PAR_TRAIN_G, L, flux_cfg.in_channels), generator=g, device=dev)
    z0 = z0[b * PAR_TRAIN_G:(b + 1) * PAR_TRAIN_G] if multi else z0

    def noise_fn(j, i, shape):
        chunk = b if j is None else j  # the one-rank run's chunk of these rows
        gen = torch.Generator(dev).manual_seed(1000 * (chunk + 1) + i)
        return torch.randn(shape, generator=gen, device=dev)

    if not multi:
        np.save(os.path.join(d, f"before_{case}.npy"),
                sampled_leaves(param_leaves(trainer.params)))
    timesteps = [int(t) for t in trainer.window.get_current_timesteps()]
    reset_launches(FA)
    C.reset_transport()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = trainer.train_one_step(batch, timesteps, z0=z0, noise_fn=noise_fn)
    torch.cuda.synchronize()
    rec["iteration_s"] = time.perf_counter() - t0
    rec["iteration_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["launches"] = {n: f.launches for n, f in FA.KERNEL_WRAPPERS.items()}
    rec["transport"] = C.transport_record()
    rec["window"] = timesteps
    rec["metrics"] = {k: float(v) for k, v in m.items() if np.isscalar(v)}
    rec["rewards"] = [float(v) for v in np.concatenate(scores)]
    rec["num_steps"] = int(m["num_steps"])
    if tp and trainer.mesh.coords["tp"] == 0:  # this batch rank's rows
        np.save(os.path.join(d, f"final_{case}_{b}.npy"), np.concatenate(finals))
    leaves = param_leaves(trainer.params)
    if multi:
        specs = flatten_specs(trainer.param_specs)
        # one leaf gathered at a time
        after = sampled_leaves(gather_leaf(t.detach(), trainer.mesh, s)
                               for t, s in zip(leaves, specs))
        rec["shard_numel"] = sum(t.numel() for t in leaves)
    else:
        after = sampled_leaves(leaves)
    if rank == 0:
        np.save(os.path.join(d, f"after_{case}.npy"), after)
    if not multi:
        trainer.close()
        return
    # -- sharded checkpoint and export, then a resume on the same mesh -----------
    trainer.global_step = 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.save_checkpoint()
    rec["checkpoint_s"] = time.perf_counter() - t0
    trainer.close()
    if tp:
        with open(os.path.join(d, f"hashes_{rank}.json"), "w") as f:
            json.dump(state_hashes(torch, leaves, trainer.opt_state), f)
    own = [t.detach().cpu() for t in leaves]
    moments = [float(s["exp_avg"].double().sum()) for s in trainer.opt_state.state.values()]
    del trainer, leaves
    torch.cuda.empty_cache()
    cfg.run.resume_from_checkpoint = True
    t0 = time.perf_counter()
    tr2 = GRPOTrainer(cfg, flux_cfg=flux_cfg, vae_cfg=vcfg, vae_params=vae,
                      reward_fn=brightness_reward, device=dev)
    rec["resume_s"] = time.perf_counter() - t0
    rec["resumed_step"] = tr2.global_step
    rec["resumed_params_equal"] = all(torch.equal(a, b.detach().cpu())
                                      for a, b in zip(own, param_leaves(tr2.params)))
    rec["resumed_moments_equal"] = moments == [
        float(s["exp_avg"].double().sum()) for s in tr2.opt_state.state.values()]
    run_dir = tr2.run_dir
    tr2.close()
    ck = os.path.join(run_dir, "checkpoints", "1")
    rec["checkpoint_files"] = sorted(os.listdir(ck))
    rec["checkpoint_gb"] = sum(os.path.getsize(os.path.join(ck, f)) for f in os.listdir(ck)) / 1e9
    exp = os.path.join(run_dir, "export_1", "diffusion_pytorch_model.safetensors")
    rec["export_gb"] = os.path.getsize(exp) / 1e9 if os.path.exists(exp) else None


def rank_tp_restore(torch, FA, C, dev, rank, world, d, rec, extra):
    """parallel_tp's checkpoint restored on one rank (``GRPOTrainer``'s resume
    on mesh 1 x 1 x 1 x 1): each leaf and AdamW moment, cut back to every tp
    rank's slice, against that rank's ``state_hashes`` bit for bit, and the
    export loaded back against the restored leaves, bit for bit.  Also
    ``replicas_equal``: each leaf whole on every tp rank (no ``tp`` in its
    spec) has the same bits on the tp ranks of one fsdp index."""
    from mixgrpo_tpu_torch.models.flux.load import load_flux_params
    from mixgrpo_tpu_torch.models.flux.model import param_leaves
    from mixgrpo_tpu_torch.parallel.mesh import AXES, MeshConfig, _coords_of
    from mixgrpo_tpu_torch.parallel.sharding import cut_leaf, flatten_specs, flux_param_specs

    n_ranks = int(extra[0])
    saved = MeshConfig(dp=1, fsdp=n_ranks // 2, tp=2)
    cfg, flux_cfg, vcfg, vae, GRPOTrainer = _train_setup(
        torch, dev, os.path.join(d, "run_tp"), MeshConfig(1, 1, 1, 1), PAR_TRAIN_G, "off",
        PAR_DEPTH)
    cfg.run.resume_from_checkpoint = True
    t0 = time.perf_counter()
    trainer = GRPOTrainer(cfg, flux_cfg=flux_cfg, vae_cfg=vcfg, vae_params=vae,
                          reward_fn=brightness_reward, device=dev)
    torch.cuda.synchronize()
    rec["restore_s"] = time.perf_counter() - t0
    rec["restored_step"] = trainer.global_step
    leaves = param_leaves(trainer.params)
    opt = trainer.opt_state
    group = opt.param_groups[0]["params"]
    specs = flatten_specs(flux_param_specs(trainer.params, saved))
    whole = {"params": leaves, "exp_avg": [opt.state[p]["exp_avg"] for p in group],
             "exp_avg_sq": [opt.state[p]["exp_avg_sq"] for p in group]}
    equal = {k: True for k in whole}
    hashes = []
    for r in range(n_ranks):
        with open(os.path.join(d, f"hashes_{r}.json")) as f:
            hashes.append(json.load(f))
    rec["replicas_equal"] = all(
        hashes[r]["params"][i] == hashes[r + 1]["params"][i]
        for r in range(0, n_ranks, 2) for i, s in enumerate(specs) if "tp" not in s)
    for r, want in enumerate(hashes):
        c = _coords_of(saved, r)
        index = {a: (c[a], getattr(saved, a)) for a in AXES}
        for k, ts in whole.items():
            got = [leaf_hash(torch, cut_leaf(t, s, index)) for t, s in zip(ts, specs)]
            equal[k] &= got == want[k]
    rec["restored_equal"] = equal
    t0 = time.perf_counter()
    exp = load_flux_params(os.path.join(trainer.run_dir, "export_1"), flux_cfg,
                           dtype=torch.float32, device=dev)
    rec["export_load_s"] = time.perf_counter() - t0
    rec["export_equal"] = all(torch.equal(a, b.detach())
                              for a, b in zip(param_leaves(exp), leaves))
    trainer.close()


def rank_sample(torch, FA, C, dev, rank, world, d, rec, extra):
    """``sample.main`` under torchrun's environment on the checkpoints
    phase's directory (``extra``: the model dir, tuned export, prompts,
    output)."""
    from mixgrpo_tpu_torch import sample as Sa
    from mixgrpo_tpu_torch.models.flux import model as M

    model, tuned, prompts, out = extra
    reset_launches(FA)
    t0 = time.perf_counter()
    Sa.main(["--model_path", model, "--new_model_ckpt", tuned, "--prompt_path", prompts,
             "--output_dir", out, "--h", "1024", "--w", "1024", "--sampling_steps",
             str(SERVE_STEPS), "--mix_sampling_steps", str(SERVE_MIX), "--batch_size", "2",
             "--seed", "5", "--device", "cuda"],
            family=smoke_family(M))
    torch.cuda.synchronize()
    rec["seconds"] = time.perf_counter() - t0
    rec["launches"] = {n: f.launches for n, f in FA.KERNEL_WRAPPERS.items()}


def rank_eval(torch, FA, C, dev, rank, world, d, rec, extra):
    """``eval_rewards.main`` (HPSv2.1 at its published geometry) over the
    multi-rank samples."""
    samples, out, hps, merges = extra
    from mixgrpo_tpu_torch import eval_rewards as ER

    t0 = time.perf_counter()
    rec["summary"] = ER.main(["--metadata", samples, "--image_dir", samples, "--output_dir",
                              out, "--reward_model", "hpsv2", "--hps_path", hps,
                              "--clip_bpe_path", merges, "--batch_size", "2", "--device",
                              "cuda"])
    rec["seconds"] = time.perf_counter() - t0


def parallel_attention_phase(torch, FA, dev, card, root):
    """Ulysses and ring attention over the ranks of ``parallel_layout`` (record
    ``parallel_attention``): each rank's runs, launches and transport."""
    import shutil
    import tempfile

    from mixgrpo_tpu_torch.parallel.mesh import backend_for

    world = parallel_layout(torch)
    backend = backend_for(dev, world)
    d = tempfile.mkdtemp(dir=root, prefix=".smoke_parallel_")
    try:
        t0 = time.perf_counter()
        ranks = spawn_ranks("attention", d, timeout=300, world=world)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    ok = True
    for r in ranks:
        for run in r["runs"]:
            ok &= all(c["ok"] for c in run["checks"].values())
            ok &= run["launches"] == run["expected_launches"]
            ok &= not run["transport"]["staged"].get("all_to_all", 0)
        ok &= r["backend"] == backend
    emit({"phase": "parallel_attention", "ranks": ranks, "shape": PAR_ATTN, "sp": world,
          "collective_ms_per_rank": [r["collective_ms"] for r in ranks],
          "backend": backend, "seconds": wall, "note": layout_note(world, backend),
          "peak_gb_per_rank": [r["max_memory_allocated_gb"] for r in ranks], "device": card})
    if not ok:
        raise AssertionError("parallel_attention: a run disagreed with one-rank flash, "
                             "launched other kernels than predicted, or staged an all-to-all")
    return ranks


def run_here(torch, FA, dev, fn, case, d, extra=()):
    """``fn`` (a rank function) as the only rank, in this process: the record
    ``rank_main`` would write, with no process to start."""
    import gc

    from mixgrpo_tpu_torch.parallel import collectives as C

    rec = {"rank": 0, "case": case}
    torch.cuda.reset_peak_memory_stats()
    fn(torch, FA, C, dev, 0, 1, d, rec, list(extra))
    rec["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["backend"] = None
    gc.collect()  # the trainer's weights sit in reference cycles
    torch.cuda.empty_cache()
    return rec


def parallel_train_phase(torch, FA, dev, card, root):
    """One recipe iteration on mesh (dp 1, fsdp = ranks of ``parallel_layout``),
    one prompt per rank, against one rank on the same global batch and noise;
    then the sharded checkpoint, the export and a resume (record
    ``parallel_train``)."""
    import shutil
    import tempfile

    import numpy as np

    from mixgrpo_tpu_torch.parallel.mesh import backend_for

    world = parallel_layout(torch)
    backend = backend_for(dev, world)
    d = tempfile.mkdtemp(dir=root, prefix=".smoke_parallel_")
    try:
        t0 = time.perf_counter()
        ref = run_here(torch, FA, dev, rank_train, "train_ref", d, (str(world),))
        ref_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = spawn_ranks("train", d, timeout=600, world=world, extra=(str(world),))
        wall = time.perf_counter() - t0
        before = np.load(os.path.join(d, "before_train_ref.npy"))
        d1 = np.load(os.path.join(d, "after_train_ref.npy")) - before
        d2 = np.load(os.path.join(d, "after_train.npy")) - before
    finally:
        shutil.rmtree(d, ignore_errors=True)
    gn1, gn2 = ref["metrics"]["grad_norm"], ranks[0]["metrics"]["grad_norm"]
    peaks = [r["max_memory_allocated_gb"] for r in ranks]
    m1, m2 = ref["metrics"], ranks[0]["metrics"]
    rec = {"phase": "parallel_train", "mesh": {"dp": 1, "fsdp": world}, "backend": backend,
           "depth": PAR_DEPTH, "num_generations": PAR_TRAIN_G, "prompts": world,
           "window": ref["window"],
           "update_max_abs_diff": float(np.abs(d2 - d1).max()),
           "update_rel_l2": float(np.linalg.norm(d2 - d1) / np.linalg.norm(d1)),
           "update_max_abs": float(np.abs(d1).max()), "sampled_entries": int(d1.size),
           "grad_norm": [gn1, gn2], "grad_norm_rel": abs(gn2 - gn1) / gn1,
           "loss": [m1["loss"], m2["loss"]], "reward": [m1["reward"], m2["reward"]],
           "iteration_s_one_rank": ref["iteration_s"],
           "iteration_s_per_rank": [r["iteration_s"] for r in ranks],
           "peak_gb_one_rank": ref["max_memory_allocated_gb"],
           "peak_gb_per_rank": peaks, "peak_gb_sum": sum(peaks),
           "launches_one_rank": ref["launches"], "launches_per_rank": [r["launches"] for r in ranks],
           "transport_per_rank": [r["transport"] for r in ranks],
           "checkpoint_s": [r["checkpoint_s"] for r in ranks],
           "resume_s": [r["resume_s"] for r in ranks],
           "checkpoint_files": ranks[0]["checkpoint_files"],
           "checkpoint_gb": ranks[0]["checkpoint_gb"], "export_gb": ranks[0]["export_gb"],
           "resumed": [(r["resumed_step"], r["resumed_params_equal"], r["resumed_moments_equal"])
                       for r in ranks],
           "wall_s": {"one_rank": ref_wall, "ranks": wall},
           "note": layout_note(world, backend), "device": card}
    emit(rec)
    blocks = sum(PAR_DEPTH)
    steps = 25
    # per rank: its rows' rollout chunks, and one update group's forward (lse)
    # and recompute (lse) and backward per block
    bwd = FA.default_bwd(2560, 2560)
    want = {"flash_attn_fwd": steps * blocks, "flash_attn_fwd_lse": 2 * blocks,
            "flash_attn_bwd_fused": blocks if bwd == "fused" else 0,
            "flash_attn_bwd_dkv": blocks if bwd == "split" else 0,
            "flash_attn_bwd_dq": blocks if bwd == "split" else 0}
    ok = (all(r["launches"] == want for r in ranks)
          and all(r["backend"] == backend for r in ranks)
          and rec["update_rel_l2"] < PAR_UPDATE_REL_L2
          and rec["grad_norm_rel"] < PAR_GRAD_NORM_REL
          and abs(m2["reward"] - m1["reward"]) < 1e-6
          and (sum(peaks) if backend == "gloo" else max(peaks)) < 80  # per card
          and all(r["resumed_step"] == 1 and r["resumed_params_equal"]
                  and r["resumed_moments_equal"] for r in ranks)
          and rec["checkpoint_files"] == ["manifest.json"] + [f"shard{i}of{world}.pt"
                                                              for i in range(world)]
          and rec["export_gb"] and np.isfinite([gn1, gn2, m2["loss"]]).all())
    if not ok:
        raise AssertionError(f"parallel_train failed its checks (want launches {want}): {rec}")
    return rec


def parallel_tp_phase(torch, FA, dev, card, root):
    """One recipe iteration on mesh (dp 1, fsdp = ranks of ``parallel_layout``
    / 2, tp 2), one prompt per batch rank, against one rank on the same
    prompts and noise; then the (fsdp, tp) checkpoint, its resume on the same
    mesh, its restore on one rank and the export (record ``parallel_tp``)."""
    import shutil
    import tempfile

    import numpy as np

    from mixgrpo_tpu_torch.parallel.mesh import backend_for

    world = parallel_layout(torch)
    backend = backend_for(dev, world)
    n_p = world // 2  # batch ranks: one prompt each
    d = tempfile.mkdtemp(dir=root, prefix=".smoke_parallel_")
    try:
        t0 = time.perf_counter()
        ref = run_here(torch, FA, dev, rank_train, "tp_ref", d, (str(n_p),))
        ref_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = spawn_ranks("tp", d, timeout=900, world=world, extra=(str(n_p),))
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = run_here(torch, FA, dev, rank_tp_restore, "tp_restore", d, (str(world),))
        restore_wall = time.perf_counter() - t0
        before = np.load(os.path.join(d, "before_tp_ref.npy"))
        d1 = np.load(os.path.join(d, "after_tp_ref.npy")) - before
        d2 = np.load(os.path.join(d, "after_tp.npy")) - before
        f1 = np.load(os.path.join(d, "final_tp_ref_0.npy"))
        f2 = np.concatenate([np.load(os.path.join(d, f"final_tp_{b}.npy"))
                             for b in range(n_p)])
    finally:
        shutil.rmtree(d, ignore_errors=True)
    m1, m2 = ref["metrics"], ranks[0]["metrics"]
    gn1, gn2 = m1["grad_norm"], m2["grad_norm"]
    # the tp ranks' rewards, batch rank by batch rank (tp index 0 of each)
    rewards = [v for r in ranks[::2] for v in r["rewards"]]
    peaks = [r["max_memory_allocated_gb"] for r in ranks]
    tp = [r["transport"]["tp"] for r in ranks]
    # DiT calls per rank: the rollout's steps (one chunk of PAR_TRAIN_G rows)
    # and the update group's forward and its recompute (remat)
    dit_calls = ref["num_steps"] + 2
    blocks = PAR_DEPTH
    rec = {"phase": "parallel_tp", "mesh": {"dp": 1, "fsdp": n_p, "tp": 2},
           "backend": backend, "depth": blocks, "num_generations": PAR_TRAIN_G,
           "prompts": n_p, "heads_per_rank": 24 // 2, "bias_std": PAR_TP_BIAS_STD,
           "window": ref["window"],
           "final_rel_l2": float(np.linalg.norm(f2 - f1) / np.linalg.norm(f1)),
           "reward_max_abs_diff": float(np.abs(np.array(rewards) - ref["rewards"]).max()),
           "update_max_abs_diff": float(np.abs(d2 - d1).max()),
           "update_rel_l2": float(np.linalg.norm(d2 - d1) / np.linalg.norm(d1)),
           "update_max_abs": float(np.abs(d1).max()), "sampled_entries": int(d1.size),
           "grad_norm": [gn1, gn2], "grad_norm_rel": abs(gn2 - gn1) / gn1,
           "loss": [m1["loss"], m2["loss"]], "reward": [m1["reward"], m2["reward"]],
           "dit_calls_per_rank": dit_calls,
           "tp_all_reduces_per_dit_call": [t.get("reduce", 0) / dit_calls for t in tp],
           "tp_per_rank": tp,
           "iteration_s_one_rank": ref["iteration_s"],
           "iteration_s_per_rank": [r["iteration_s"] for r in ranks],
           "peak_gb_one_rank": ref["max_memory_allocated_gb"],
           "peak_gb_per_rank": peaks, "peak_gb_sum": sum(peaks),
           "shard_numel_per_rank": [r["shard_numel"] for r in ranks],
           "launches_one_rank": ref["launches"],
           "launches_per_rank": [r["launches"] for r in ranks],
           "checkpoint_s": [r["checkpoint_s"] for r in ranks],
           "resume_s": [r["resume_s"] for r in ranks],
           "checkpoint_files": ranks[0]["checkpoint_files"],
           "checkpoint_gb": ranks[0]["checkpoint_gb"], "export_gb": ranks[0]["export_gb"],
           "resumed": [(r["resumed_step"], r["resumed_params_equal"], r["resumed_moments_equal"])
                       for r in ranks],
           "restore_one_rank": {k: restored[k] for k in (
               "restored_step", "restored_equal", "replicas_equal", "export_equal", "restore_s",
               "export_load_s", "max_memory_allocated_gb")},
           "wall_s": {"one_rank": ref_wall, "ranks": wall, "restore": restore_wall},
           "limits": {"final_rel_l2": PAR_TP_FINAL_REL_L2, "reward_abs": PAR_TP_REWARD_ABS,
                      "update_rel_l2": PAR_TP_UPDATE_REL_L2,
                      "grad_norm_rel": PAR_TP_GRAD_NORM_REL},
           "note": layout_note(world, backend), "device": card}
    emit(rec)
    n_blocks = sum(blocks)
    bwd = FA.default_bwd(2560, 2560)
    want = {"flash_attn_fwd": ref["num_steps"] * n_blocks, "flash_attn_fwd_lse": 2 * n_blocks,
            "flash_attn_bwd_fused": n_blocks if bwd == "fused" else 0,
            "flash_attn_bwd_dkv": n_blocks if bwd == "split" else 0,
            "flash_attn_bwd_dq": n_blocks if bwd == "split" else 0}
    # one rank rolls out every batch rank's chunk
    want_ref = dict(want, flash_attn_fwd=n_p * want["flash_attn_fwd"])
    # 4 row-parallel all-reduces per double block and 1 per single block
    per_call = 4 * blocks[0] + blocks[1]
    files = sorted(["manifest.json"] + [f"shard{f}of{n_p}_tp{t}of2.pt" for f in range(n_p)
                                        for t in range(2)])
    ok = (all(r["launches"] == want for r in ranks) and ref["launches"] == want_ref
          and all(r["backend"] == backend for r in ranks)
          and all(t.get("reduce") == per_call * dit_calls for t in tp)
          and rec["final_rel_l2"] < PAR_TP_FINAL_REL_L2
          and rec["reward_max_abs_diff"] < PAR_TP_REWARD_ABS
          and rec["update_rel_l2"] < PAR_TP_UPDATE_REL_L2
          and rec["grad_norm_rel"] < PAR_TP_GRAD_NORM_REL
          and (sum(peaks) if backend == "gloo" else max(peaks)) < 80  # per card
          and all(r["resumed_step"] == 1 and r["resumed_params_equal"]
                  and r["resumed_moments_equal"] for r in ranks)
          and restored["restored_step"] == 1 and all(restored["restored_equal"].values())
          and restored["replicas_equal"]
          and restored["export_equal"] and rec["checkpoint_files"] == files
          and rec["export_gb"] and np.isfinite([gn1, gn2, m2["loss"]]).all())
    if not ok:
        raise AssertionError(f"parallel_tp failed its checks (want launches {want} per "
                             f"rank and {want_ref} for one rank, {per_call} tp all-reduces "
                             f"per DiT call): {rec}")
    return rec


def parallel_cli_phase(torch, FA, dev, card, root, ckpt, paths):
    """``sample.main`` over the ranks of ``parallel_layout`` on the checkpoints
    phase's directory, then ``eval_rewards.main`` (HPSv2.1) over them on
    those images (record ``parallel_cli``)."""
    import shutil
    import tempfile

    from mixgrpo_tpu_torch.parallel.mesh import backend_for

    world = parallel_layout(torch)
    backend = backend_for(dev, world)
    mine = [list(CKPT_PROMPTS[r::world]) for r in range(world)]
    d = tempfile.mkdtemp(dir=root, prefix=".smoke_parallel_")
    try:
        samples, ev = os.path.join(d, "samples"), os.path.join(d, "eval")
        t0 = time.perf_counter()
        srec = spawn_ranks("sample", d, timeout=400, world=world,
                           extra=(ckpt["dir"], ckpt["tuned"], ckpt["prompts"], samples))
        sample_wall = time.perf_counter() - t0
        files = sorted(os.listdir(samples))
        metas = {}
        for r in range(world):
            if mine[r]:  # a rank with no prompt writes no metadata
                with open(os.path.join(samples, f"metadata_{r}.json")) as f:
                    metas[r] = json.load(f)
        t0 = time.perf_counter()
        erec = spawn_ranks("eval", d, timeout=400, world=world,
                           extra=(samples, ev, paths["hps"], paths["merges"]))
        eval_wall = time.perf_counter() - t0
        eval_files = sorted(os.listdir(ev))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    want_files = sorted([f"img_p{r}_{i:05d}.png" for r in range(world)
                         for i in range(len(mine[r]))]
                        + [f"metadata_{r}.json" for r in range(world) if mine[r]])
    per_call = sum(TRAIN_DEPTH)
    want_launches = [-(-len(m) // 2) * SERVE_STEPS * per_call for m in mine]
    summary = erec[0]["summary"]
    rec = {"phase": "parallel_cli", "ranks": world, "backend": backend, "files": files,
           "eval_files": eval_files, "prompts_per_rank": [len(m) for m in mine],
           "sample_launches_per_rank": [r["launches"] for r in srec],
           "sample_s_per_rank": [r["seconds"] for r in srec],
           "eval_s_per_rank": [r["seconds"] for r in erec],
           "summary": summary, "wall_s": {"sample": sample_wall, "eval": eval_wall},
           "peak_gb_per_rank": {"sample": [r["max_memory_allocated_gb"] for r in srec],
                                "eval": [r["max_memory_allocated_gb"] for r in erec]},
           "note": layout_note(world, backend), "device": card}
    emit(rec)
    ok = (files == want_files
          and all([m["prompt"] for m in metas[r]] == mine[r]
                  and [m["seed"] for m in metas[r]] == [5 + r * 100000 + j
                                                        for j in range(len(mine[r]))]
                  for r in metas)
          and all(s["launches"]["flash_attn_fwd"] == w and
                  not any(v for k, v in s["launches"].items() if k != "flash_attn_fwd")
                  for s, w in zip(srec, want_launches))
          and eval_files == ["reward_means.txt"] + [f"rewards_{r}.json" for r in range(world)]
          and summary is not None and summary.get("hpsv2_count") == len(CKPT_PROMPTS)
          and all(r["summary"] is None for r in erec[1:]))
    if not ok:
        raise AssertionError(f"parallel_cli failed its checks: {rec}")
    return rec

# ---------------------------------------------------------------------------
# HunyuanVideo text-to-video (phase hunyuan_video)
# ---------------------------------------------------------------------------

HV_PROMPTS = (
    "A red fox trots through fresh snow at golden hour; the camera tracks beside it.",
    "東京の夜, rain on a crossing, umbrellas and neon — 2½ seconds, x² zoom 😀",
)
HV_SEEDS = (1234, 5678)
HV_STEPS = 4  # cut from 50
HV_SIZE = (192, 336, 129)  # the JAX sampler's defaults: 33 x 24 x 42 latents
HV_540P = (544, 960, 129)  # HunyuanVideo's published 540p setting
HV_FILE_DEPTH = (2, 4)  # the transformer file's double + single blocks
HV_FILE_LLAMA_LAYERS = 4  # of 32: skip 2 leaves two layers running
LLAMA3_SPECIAL = {"<|begin_of_text|>": 128000, "<|end_of_text|>": 128001,
                  "<|start_header_id|>": 128006, "<|end_header_id|>": 128007,
                  "<|eot_id|>": 128009}


def llama3_tokenizer_json(corpus, n_merges):
    """A Llama-3-structured byte-level BPE ``tokenizer.json``: the Split
    pre-tokenizer with Llama-3's pattern and ByteLevel, a BPE model with
    ``ignore_merges`` whose ``n_merges`` merges are learned here from
    ``corpus`` (the most frequent pair each time, the first of equals in
    sorted order), the special tokens at Llama-3's ids, and the
    ``<|begin_of_text|> $A`` template after ByteLevel."""
    from mixgrpo_tpu_torch.models.text import tokenizer_json as TJ

    enc = TJ._bytes_to_unicode()
    words = {}
    for text in corpus:
        for piece in TJ._llama3_split(text):
            w = tuple(enc[b] for b in piece.encode("utf-8"))
            words[w] = words.get(w, 0) + 1
    vocab = {enc[b]: i for i, b in enumerate(sorted(enc))}
    merges = []
    for _ in range(n_merges):
        pairs = {}
        for w, n in words.items():
            for p in zip(w, w[1:]):
                pairs[p] = pairs.get(p, 0) + n
        if not pairs:
            break
        a, b = max(sorted(pairs), key=lambda p: pairs[p])
        merges.append([a, b])
        vocab.setdefault(a + b, len(vocab))
        merged = {}
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] = merged.get(tuple(out), 0) + n
        words = merged
    # filler entries up to Llama-3's 128,000 regular tokens, so that the
    # special tokens get their ids (``tokenizers`` numbers them after the
    # vocabulary); "\u3000" is no byte-level character, so no piece matches one
    for i in range(len(vocab), min(LLAMA3_SPECIAL.values())):
        vocab[f"\u3000{i}"] = i
    special = lambda c, i: {"id": i, "content": c, "single_word": False, "lstrip": False,
                            "rstrip": False, "normalized": False, "special": True}
    # the ids between Llama-3's specials are its reserved tokens
    specials = {i: f"<|reserved_special_token_{i - 128000}|>"
                for i in range(min(LLAMA3_SPECIAL.values()), max(LLAMA3_SPECIAL.values()) + 1)}
    specials.update({i: c for c, i in LLAMA3_SPECIAL.items()})
    bos = "<|begin_of_text|>"
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [special(c, i) for i, c in sorted(specials.items())],
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": TJ.LLAMA3_SPLIT}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
             "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                      {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": bos, "type_id": 1}},
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {bos: {"id": bos, "ids": [LLAMA3_SPECIAL[bos]],
                                      "tokens": [bos]}}}]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": merges},
    }


def write_llama3_tokenizer(d, n_merges=600):
    """``tokenizer.json`` (learned from the official templates and
    ``HV_PROMPTS``) and ``tokenizer_config.json`` (``<|end_of_text|>`` pads)
    in ``d``."""
    import json as _json

    from mixgrpo_tpu_torch.models.hunyuan.text_encoder import HUNYUAN_PROMPT_TEMPLATES

    corpus = [t["template"].format(p) for t in HUNYUAN_PROMPT_TEMPLATES.values()
              for p in HV_PROMPTS]
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        _json.dump(llama3_tokenizer_json(corpus, n_merges), f)
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        _json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                    "bos_token": "<|begin_of_text|>", "eos_token": "<|end_of_text|>",
                    "pad_token": "<|end_of_text|>", "model_max_length": 131072}, f)


def llama_hf_state(torch, cfg, dev, seed, dtype=None):
    """HF ``LlamaForCausalLM`` names (``model.``-prefixed, no head) with HF's
    initialisation (normal, std 0.02; norms 1), bf16 on the card."""
    dtype = dtype or torch.bfloat16
    g = torch.Generator(dev).manual_seed(seed)
    n = lambda *shape: torch.randn(shape, generator=g, device=dev, dtype=dtype) * 0.02
    ones = lambda: torch.ones((cfg.d_model,), device=dev, dtype=dtype)
    d, hd = cfg.d_model, cfg.head_dim
    st = {"model.embed_tokens.weight": n(cfg.vocab, d), "model.norm.weight": ones()}
    for i in range(cfg.n_layers):
        b = f"model.layers.{i}"
        st.update({f"{b}.input_layernorm.weight": ones(),
                   f"{b}.post_attention_layernorm.weight": ones(),
                   f"{b}.self_attn.q_proj.weight": n(cfg.n_heads * hd, d),
                   f"{b}.self_attn.k_proj.weight": n(cfg.n_kv_heads * hd, d),
                   f"{b}.self_attn.v_proj.weight": n(cfg.n_kv_heads * hd, d),
                   f"{b}.self_attn.o_proj.weight": n(d, cfg.n_heads * hd),
                   f"{b}.mlp.gate_proj.weight": n(cfg.d_ff, d),
                   f"{b}.mlp.up_proj.weight": n(cfg.d_ff, d),
                   f"{b}.mlp.down_proj.weight": n(d, cfg.d_ff)})
    return st


def causal_vae_state(dec, enc=None):
    """The port's causal-VAE decoder (and encoder) dicts under the released
    ``AutoencoderKLCausal3D`` names: a CausalConv3d's kernel at
    ``<name>.conv.weight`` as (out, in, kt, kh, kw), ``quant_conv`` and
    ``post_quant_conv`` plain, (in, out) linears as (out, in)."""
    st = {}

    def conv(name, p, plain=False):
        key = name if plain else f"{name}.conv"
        st[f"{key}.weight"], st[f"{key}.bias"] = p["w"].permute(4, 3, 0, 1, 2), p["b"]

    def gn(name, p):
        st[f"{name}.weight"], st[f"{name}.bias"] = p["scale"], p["bias"]

    def resnet(name, p):
        gn(f"{name}.norm1", p["norm1"])
        conv(f"{name}.conv1", p["conv1"])
        gn(f"{name}.norm2", p["norm2"])
        conv(f"{name}.conv2", p["conv2"])
        if "shortcut" in p:
            conv(f"{name}.conv_shortcut", p["shortcut"])

    for prefix, params in (("decoder", dec), ("encoder", enc)):
        if params is None:
            continue
        conv(f"{prefix}.conv_in", params["conv_in"])
        resnet(f"{prefix}.mid_block.resnets.0", params["mid_res1"])
        resnet(f"{prefix}.mid_block.resnets.1", params["mid_res2"])
        a, att = f"{prefix}.mid_block.attentions.0", params["mid_attn"]
        gn(f"{a}.group_norm", att["norm"])
        for ours, theirs in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("out", "to_out.0")):
            st[f"{a}.{theirs}.weight"], st[f"{a}.{theirs}.bias"] = att[ours]["w"].t(), \
                att[ours]["b"]
        gn(f"{prefix}.conv_norm_out", params["norm_out"])
        conv(f"{prefix}.conv_out", params["conv_out"])
        kind, up = ("up", "upsample") if prefix == "decoder" else ("down", "downsample")
        for bi, blk in enumerate(params[f"{kind}_blocks"]):
            for li, rp in enumerate(blk["resnets"]):
                resnet(f"{prefix}.{kind}_blocks.{bi}.resnets.{li}", rp)
            if up in blk:
                conv(f"{prefix}.{kind}_blocks.{bi}.{kind}samplers.0.conv", blk[up])
    for name in ("post_quant_conv",):
        if dec is not None and name in dec:
            conv(name, dec[name], plain=True)
    if enc is not None:
        conv("quant_conv", enc["quant_conv"], plain=True)
    return st


def mochi_vae_state(dec):
    """The port's Mochi VAE decoder dict under diffusers'
    ``AutoencoderKLMochi`` decoder names: a 3x3x3 conv's kernel at
    ``<name>.conv.weight`` as (out, in, kt, kh, kw), ``conv_in`` and
    ``proj_out`` (1x1x1) and each up block's ``proj`` as (out, in) Linears,
    GroupNorms under ``norm_layer``."""
    st = {}

    def conv(name, p):
        st[f"{name}.weight"], st[f"{name}.bias"] = p["w"].permute(4, 3, 0, 1, 2), p["b"]

    def lin(name, p):  # (in, out) or a 1x1x1 kernel -> an (out, in) Linear
        st[f"{name}.weight"] = p["w"].reshape(-1, p["w"].shape[-1]).t()
        st[f"{name}.bias"] = p["b"]

    def resnet(name, p):
        for i in (1, 2):
            n = p[f"norm{i}"]
            st[f"{name}.norm{i}.norm_layer.weight"] = n["scale"]
            st[f"{name}.norm{i}.norm_layer.bias"] = n["bias"]
            conv(f"{name}.conv{i}.conv", p[f"conv{i}"])

    lin("decoder.conv_in", dec["conv_in"])
    lin("decoder.proj_out", dec["proj_out"])
    for stage in ("block_in", "block_out"):
        for i, rp in enumerate(dec[stage]):
            resnet(f"decoder.{stage}.resnets.{i}", rp)
    for bi, blk in enumerate(dec["up_blocks"]):
        for li, rp in enumerate(blk["resnets"]):
            resnet(f"decoder.up_blocks.{bi}.resnets.{li}", rp)
        lin(f"decoder.up_blocks.{bi}.proj", blk["proj"])
    return st


class LoadLog:
    """Timed loads (seconds, GB/s, the host's RSS rise) and leaves held bit
    for bit against what was written."""

    def __init__(self, torch):
        self.torch, self.loads, self.checks = torch, [], []

    def load(self, name, fn, nbytes):
        import resource

        self.torch.cuda.synchronize()
        with RssPeak() as rss:
            t0 = time.perf_counter()
            out = fn()
            self.torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        self.loads.append({"component": name, "seconds": sec, "gb": nbytes / 1e9,
                           "gb_per_s": nbytes / 1e9 / sec, "host_rss_before_gb": rss.before,
                           "host_rss_peak_gb": rss.peak, "host_rss_rise_gb": rss.peak - rss.before,
                           "host_ru_maxrss_gb": resource.getrusage(
                               resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9})
        return out

    def same(self, what, got, want):
        ok = got.dtype == want.dtype and got.shape == want.shape and self.torch.equal(got, want)
        self.checks.append({"leaf": what, "dtype": str(got.dtype).replace("torch.", ""),
                            "shape": list(got.shape), "bit_for_bit": bool(ok)})


def hunyuan_geometry():
    """The released geometries: the HunyuanVideo DiT, llava-llama-3-8b's
    text tower, CLIP-L and the causal VAE; the sizes of the phase's videos,
    and the depth cuts of its files.  A CPU rehearsal passes tiny ones."""
    import dataclasses

    from mixgrpo_tpu_torch.models.hunyuan.model import HunyuanVideoConfig
    from mixgrpo_tpu_torch.models.hunyuan.vae3d import CausalVAEConfig
    from mixgrpo_tpu_torch.models.text.clip import CLIPConfig
    from mixgrpo_tpu_torch.models.text.llama import LlamaConfig

    dit, llama = HunyuanVideoConfig.hunyuan_video(), LlamaConfig.llava_llama3_8b()
    return {"dit": dit, "llama": llama, "clip": CLIPConfig.vit_l_14(),
            "vae": CausalVAEConfig.hunyuan_video(), "size": HV_SIZE, "size_540p": HV_540P,
            "text_len": 256, "text_kept": 40,
            "dit_file": dataclasses.replace(dit, depth_double=HV_FILE_DEPTH[0],
                                            depth_single=HV_FILE_DEPTH[1]),
            "llama_file": dataclasses.replace(llama, n_layers=HV_FILE_LLAMA_LAYERS)}


def hunyuan_models(torch, dev, geo, dit=None, llama=None, seed=30):
    """Random bf16 HunyuanVideo components on ``dev`` at ``geo``'s widths:
    the DiT (``dit``, default ``geo["dit"]``), the Llama-3 tower
    (``llama``, default ``geo["llama"]``), CLIP-L's text tower (read from
    HF-named weights) and the causal VAE decoder."""
    from mixgrpo_tpu_torch.models.hunyuan.model import init_hunyuan_video
    from mixgrpo_tpu_torch.models.hunyuan.vae3d import init_causal_vae_decoder
    from mixgrpo_tpu_torch.models.text.clip_load import load_clip_hf_text_only
    from mixgrpo_tpu_torch.models.text.llama import init_llama

    bf16, gen = torch.bfloat16, lambda s: torch.Generator(dev).manual_seed(s)
    cfg, lcfg = dit or geo["dit"], llama or geo["llama"]
    ccfg, vcfg = geo["clip"], geo["vae"]
    dit = init_hunyuan_video(cfg, generator=gen(seed), device=dev, dtype=bf16)
    for bp in dit["txt_in"]["blocks"]:  # init's zero gates would bypass the refiner
        bp["mod"]["lin"]["w"].normal_(0.0, 0.02, generator=gen(seed + 4))
    return {"cfg": cfg, "dit": dit,
            "llama_cfg": lcfg,
            "llama": init_llama(lcfg, generator=gen(seed + 1), device=dev, dtype=bf16),
            "clip_cfg": ccfg,
            "clip": load_clip_hf_text_only(hf_clip_text_state(torch, ccfg, dev, seed + 2), ccfg,
                                           device=dev, dtype=bf16),
            "vae_cfg": vcfg,
            "vae": init_causal_vae_decoder(vcfg, generator=gen(seed + 3), device=dev, dtype=bf16)}


def hunyuan_pipeline(torch, dev, m, tok_dir, merges):
    """``HunyuanVideoPipeline`` + text encoders over ``hunyuan_models``'
    dict, ``HV_STEPS`` steps, with each of its three stages timed (the card
    synchronised around each) into ``pipe.stage_s``."""
    from mixgrpo_tpu_torch.models.hunyuan.pipeline import HunyuanVideoPipeline
    from mixgrpo_tpu_torch.models.hunyuan.text_encoder import (
        HUNYUAN_PROMPT_TEMPLATES, CLIPTextPooler, LLMTextEncoder, clip_tokenize_fn,
        json_tokenize_fn,
    )

    enc = LLMTextEncoder(m["llama"], m["llama_cfg"], json_tokenize_fn(tok_dir),
                         prompt_template=HUNYUAN_PROMPT_TEMPLATES["dit-llm-encode"],
                         prompt_template_video=HUNYUAN_PROMPT_TEMPLATES["dit-llm-encode-video"])
    pooler = CLIPTextPooler(m["clip"], m["clip_cfg"], clip_tokenize_fn(merges))
    pipe = HunyuanVideoPipeline(m["cfg"], m["dit"], vae_cfg=m["vae_cfg"], vae_params=m["vae"],
                                num_steps=HV_STEPS, text_encoder=enc, clip_pooler=pooler,
                                device=dev)
    pipe.stage_s = {"encode": [], "denoise": [], "decode": []}

    def timed(stage, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            pipe.stage_s[stage].append(time.perf_counter() - t0)
            return out
        return run

    for stage, name in (("encode", "encode_prompt"), ("denoise", "_sample"),
                        ("decode", "_decode")):
        setattr(pipe, name, timed(stage, getattr(pipe, name)))
    return pipe


def video_kernel_class(name):
    """``kernel_class`` with the causal VAE's own kernels split out:
    GroupNorm's statistics and affine, replicate padding, nearest
    upsampling, and the convolutions beside the GEMMs."""
    low = name.lower()
    for cls, keys in (("group_norm", ("rowwisemoments", "computefusedparams", "groupnorm",
                                      "group_norm")),
                      ("replicate_pad", ("replication_pad",)),
                      ("upsample", ("upsample_nearest",)),
                      ("conv", ("conv", "fprop", "dgrad", "cudnn"))):
        if any(k in low for k in keys):
            return cls
    return kernel_class(name)


def check_videos(samples, shape):
    import numpy as np

    bad = [i for i, s in enumerate(samples)
           if s.shape != shape or not np.isfinite(s).all() or s.min() < 0 or s.max() > 1]
    if bad:
        raise AssertionError(f"videos {bad} are misshapen, not finite or outside [0, 1]")


def hunyuan_video_phase(torch, FA, dev, card, root, rows, geo=None):
    """HunyuanVideo at full width and depth with random bf16 weights (see the
    module docstring): ``HunyuanVideoSampler.predict`` at 192x336, 129
    frames, 4 steps, two prompts and seeds (B = 1 per call), its seconds per
    video split into text encoding, denoising and decode, its peak and its
    launches (60 forwards per DiT call, nothing else); one DiT forward with
    the kernel against eager attention at that size, most of the text
    masked; two forwards at 544x960, 129 frames (cold, then warm); then the released
    layouts written at full width (the transformer ``.pt`` cut to 2 + 4
    blocks, the Llama-3 tower to 4 of 32 layers, the whole VAE, CLIP-L, the
    tokenizer), loaded through ``HunyuanVideoPipeline.from_checkpoint`` and
    ``LLMTextEncoder.from_checkpoint`` with leaves held bit for bit, one
    ``predict`` on them, and ``verify_weights.main`` record-then-check for
    ``hunyuan_llm``, ``hunyuan_vae`` and ``hunyuan_dit``.  ``geo`` (default
    ``hunyuan_geometry()``) lets the phase be rehearsed at a tiny size."""
    import shutil
    import tempfile

    from mixgrpo_tpu_torch.models.flux.model import param_count
    from mixgrpo_tpu_torch.models.hunyuan.model import hunyuan_video_forward
    from mixgrpo_tpu_torch.models.hunyuan.sampler import HunyuanVideoSampler

    geo = geo or hunyuan_geometry()
    tmp = tempfile.mkdtemp(dir=root, prefix=".smoke_hunyuan_")
    try:
        tok_dir, merges = os.path.join(tmp, "tokenizer"), os.path.join(tmp, "merges.txt")
        write_llama3_tokenizer(tok_dir)
        with open(merges, "w") as f:
            f.write("\n".join(CLIP_MERGES) + "\n")

        # -- 1. predict at full width and depth ----------------------------------
        torch.cuda.reset_peak_memory_stats()
        before_gb = torch.cuda.memory_allocated() / 1e9  # what earlier phases left
        t0 = time.perf_counter()
        m = hunyuan_models(torch, dev, geo)
        cfg, per_call = m["cfg"], m["cfg"].depth_double + m["cfg"].depth_single
        torch.cuda.synchronize()
        emit({"phase": "hunyuan_weights", "dit_params": param_count(m["dit"]),
              "llama_params": param_count(m["llama"]), "clip_text_params": param_count(m["clip"]),
              "vae_decoder_params": param_count(m["vae"]), "dtype": "bfloat16",
              "seconds": time.perf_counter() - t0, "allocated_before_gb": before_gb,
              "allocated_gb": torch.cuda.memory_allocated() / 1e9, "device": card})
        pipe = hunyuan_pipeline(torch, dev, m, tok_dir, merges)
        pipe.text_encoder.max_length = L_txt = geo["text_len"]
        h, w, frames = geo["size"]
        lat_shape = (1, (frames - 1) // 4 + 1, h // 8, w // 8, cfg.in_channels)
        reset_launches(FA)
        t0 = time.perf_counter()
        out = HunyuanVideoSampler(pipe).predict(list(HV_PROMPTS), height=h, width=w,
                                                video_length=frames, seed=list(HV_SEEDS))
        wall = time.perf_counter() - t0
        launches = FA.flash_attn_fwd.launches
        peak = torch.cuda.max_memory_allocated()
        n = len(HV_PROMPTS)
        check_launches(FA, "hunyuan_video_predict", launches, per_call, n * HV_STEPS)
        check_videos(out["samples"], (frames, h, w, 3))
        st = pipe.stage_s
        rec = {"phase": "hunyuan_video_predict", "height": h, "width": w, "frames": frames,
               "latents": list(lat_shape[1:]), "steps": HV_STEPS, "videos": n,
               "seeds": out["seeds"], "tiled_decode": pipe.tiles(lat_shape),
               "text_tokens": L_txt, "seq": L_txt + lat_shape[1] * (h // 16) * (w // 16),
               "wall_s": wall, "s_per_video": wall / n,
               "encode_s": st["encode"], "denoise_s_per_video": st["denoise"],
               "decode_s_per_video": st["decode"], "flash_launches": launches,
               "max_memory_allocated_gb": peak / 1e9,
               "frame_mean": [float(s.mean()) for s in out["samples"]], "device": card}
        emit(rec)
        if peak >= 80e9 or not pipe.tiles(lat_shape):
            raise AssertionError(f"hunyuan predict: peak {peak / 1e9} GB, or no tiled decode")
        del out, pipe

        # where a video's time goes: one DiT call and one decode tile, profiled
        from mixgrpo_tpu_torch.models.hunyuan.vae3d import causal_vae_decode

        g = torch.Generator(dev).manual_seed(35)
        z = torch.randn(lat_shape, generator=g, device=dev).bfloat16()
        txt = torch.randn((1, L_txt, cfg.text_states_dim), generator=g, device=dev).bfloat16()
        pooled = torch.randn((1, cfg.text_states_dim_2), generator=g, device=dev).bfloat16()
        mask = torch.zeros((1, L_txt), dtype=torch.int32, device=dev)
        mask[:, :geo["text_kept"]] = 1  # 216 of 256 text tokens masked
        t, gs = torch.full((1,), 0.6, device=dev), torch.full((1,), 6.0, device=dev)
        fwd = lambda impl, zz=z: hunyuan_video_forward(m["dit"], cfg, zz, txt, pooled, t, gs,
                                                       mask, attn_impl=impl)
        with torch.no_grad():
            profile_device(torch, f"one hunyuan_video DiT call at {h}x{w}x{frames}, bf16",
                           lambda: fwd("flash"), card, video_kernel_class)
            tile = z[:, :17, :, :32].float()  # one tile of the tiled decode
            profile_device(torch, f"one causal VAE decode tile {list(tile.shape[1:4])}, bf16",
                           lambda: causal_vae_decode(m["vae"], m["vae_cfg"], tile), card,
                           video_kernel_class)
        del tile
        for k in ("llama", "clip", "vae"):
            m.pop(k)
        torch.cuda.empty_cache()

        # -- 2. the model path through the kernel against eager attention --------
        reset_launches(FA)
        with torch.no_grad():
            v_flash = fwd("flash")
            torch.cuda.synchronize()
            check_launches(FA, "hunyuan_flash_vs_eager", FA.flash_attn_fwd.launches, per_call, 1)
            v_eager = fwd("eager")
        ok, err, rel = close_bf16(v_flash, v_eager)
        emit({"phase": "reference", "what": f"hunyuan_video forward at {h}x{w}x{frames}, "
              f"{L_txt - geo['text_kept']} of {L_txt} text tokens masked, bf16, kernel vs "
              "eager attention",
              "rel_l2": rel, "max_abs_err": err, "max_abs_eager": v_eager.abs().max().item(),
              "limit": "close_bf16", "ok": ok, "device": card})
        if not ok:
            raise AssertionError(f"hunyuan forward: kernel path vs eager rel_l2={rel}, err={err}")
        del v_flash, v_eager

        # -- 3. two forwards at 544x960, 129 frames: cold, then warm ---------------
        h5, w5, f5 = geo["size_540p"]
        z5 = torch.randn((1, (f5 - 1) // 4 + 1, h5 // 8, w5 // 8, cfg.in_channels),
                         generator=g, device=dev).bfloat16()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(FA)
        call_ms = []
        for _ in range(2):  # the first call at this shape is cold: new blocks, GEMM set-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                v5 = fwd("flash", z5)
            torch.cuda.synchronize()
            call_ms.append((time.perf_counter() - t0) * 1e3)
        check_launches(FA, "hunyuan_540p_forward", FA.flash_attn_fwd.launches, per_call, 2)
        n_img = z5.shape[1] * (h5 // 16) * (w5 // 16)
        emit({"phase": "hunyuan_540p_forward", "height": h5, "width": w5, "frames": f5,
              "image_tokens": n_img, "seq": L_txt + n_img,
              "seq_padded": -(-(L_txt + n_img) // 128) * 128, "ms": call_ms[1],
              "cold_ms": call_ms[0],
              "finite": bool(torch.isfinite(v5).all()),
              "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
              "device": card})
        if not bool(torch.isfinite(v5).all()):
            raise AssertionError("hunyuan 540p forward: not finite")
        del v5, z5, m
        torch.cuda.empty_cache()

        # -- 4. from files in the released layouts ---------------------------------
        hunyuan_files_phase(torch, FA, dev, card, tmp, tok_dir, merges, geo)
    finally:  # cleanup only; failures propagate
        shutil.rmtree(tmp, ignore_errors=True)


def hunyuan_files_phase(torch, FA, dev, card, tmp, tok_dir, merges, geo):
    """Step 4 of ``hunyuan_video_phase``: write, load, hold, predict, verify."""
    from mixgrpo_tpu_torch import verify_weights as VW
    from mixgrpo_tpu_torch.models.hunyuan.load import export_hunyuan_state_dict
    from mixgrpo_tpu_torch.models.hunyuan.pipeline import HunyuanVideoPipeline
    from mixgrpo_tpu_torch.models.hunyuan.sampler import HunyuanVideoSampler
    from mixgrpo_tpu_torch.models.hunyuan.text_encoder import (
        CLIPTextPooler, LLMTextEncoder, clip_tokenize_fn,
    )
    from mixgrpo_tpu_torch.models.hunyuan.vae3d import init_causal_vae_encoder
    from mixgrpo_tpu_torch.models.text.clip_load import load_clip_hf_text_only
    from mixgrpo_tpu_torch.utils.safetensors_io import SafetensorsDir, save_file

    bf16 = torch.bfloat16
    cut = geo["dit_file"]
    dd, ds = cut.depth_double, cut.depth_single
    t0 = time.perf_counter()
    m = hunyuan_models(torch, dev, geo, dit=cut, llama=geo["llama_file"], seed=40)
    paths = {"dit": os.path.join(tmp, "transformer", "pytorch_model_module.pt"),
             "llm": os.path.join(tmp, "text_encoder"), "vae": os.path.join(tmp, "vae"),
             "clip": os.path.join(tmp, "text_encoder_2")}
    sd = export_hunyuan_state_dict(m["dit"], cut, device="cpu")
    os.makedirs(os.path.dirname(paths["dit"]))
    torch.save({"module": sd}, paths["dit"])
    del sd
    llama_st = llama_hf_state(torch, m["llama_cfg"], dev, 44)
    save_file(llama_st, os.path.join(paths["llm"], "model.safetensors"))
    vae_enc = init_causal_vae_encoder(m["vae_cfg"], generator=torch.Generator(dev).manual_seed(45),
                                      device=dev)
    vae_dec = m["vae"]
    save_file(causal_vae_state(vae_dec, vae_enc),
              os.path.join(paths["vae"], "diffusion_pytorch_model.safetensors"),
              dtype=torch.float32)
    clip_st = hf_clip_text_state(torch, m["clip_cfg"], dev, 46)
    save_file(clip_st, os.path.join(paths["clip"], "model.safetensors"))
    torch.cuda.synchronize()
    size = lambda p: sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(p)
                         for f in fs) if os.path.isdir(p) else os.path.getsize(p)
    emit({"phase": "hunyuan_files_write", "seconds": time.perf_counter() - t0,
          "gb": {k: size(p) / 1e9 for k, p in paths.items()},
          "dit_depth": [dd, ds], "llama_layers": m["llama_cfg"].n_layers, "device": card})

    log = LoadLog(torch)
    enc = log.load("llava-llama-3 text tower", lambda: LLMTextEncoder.from_checkpoint(
        paths["llm"], tok_dir, cfg=m["llama_cfg"], device=dev), size(paths["llm"]))
    pre = f"model.layers.{m['llama_cfg'].n_layers - 1}"
    log.same("llama blocks.q[-1] (transposed)", enc.params["blocks"]["q"][-1],
             llama_st[f"{pre}.self_attn.q_proj.weight"].t())
    log.same("llama blocks.down[-1]", enc.params["blocks"]["down"][-1],
             llama_st[f"{pre}.mlp.down_proj.weight"].t())
    log.same("llama token_emb", enc.params["token_emb"], llama_st["model.embed_tokens.weight"])
    del llama_st
    ccfg = m["clip_cfg"]
    clip = log.load("clip-l text", lambda: load_clip_hf_text_only(
        SafetensorsDir(paths["clip"]), ccfg, device=dev, dtype=bf16), size(paths["clip"]))
    log.same("clip token_emb (F16 -> bf16)", clip["text"]["token_emb"],
             clip_st["text_model.embeddings.token_embedding.weight"].to(bf16))
    del clip_st
    pooler = CLIPTextPooler(clip, ccfg, clip_tokenize_fn(merges))
    pipe = log.load("transformer .pt + vae", lambda: HunyuanVideoPipeline.from_checkpoint(
        paths["dit"], paths["vae"], device=dev, num_steps=HV_STEPS, text_encoder=enc,
        clip_pooler=pooler), size(paths["dit"]) + size(paths["vae"]))
    lp, want = pipe.params, m["dit"]
    for what, path in (("img_in.w (Conv3d (1, 2, 2), (ph, pw, C) order)", ("img_in", "w")),
                       ("double.img_qkv.w[-1]", ("double", "img_qkv", "w", -1)),
                       ("double.txt_knorm[0]", ("double", "txt_knorm", 0)),
                       ("single.linear1.w[-1]", ("single", "linear1", "w", -1)),
                       ("txt_in.blocks[-1].qkv.w (refiner)", ("txt_in", "blocks", -1, "qkv",
                                                               "w")),
                       ("final_proj.w", ("final_proj", "w"))):
        a, b = lp, want
        for k in path:
            a, b = a[k], b[k]
        log.same(what, a, b)
    log.same("vae decoder.conv_in.w (f32 -> bf16)", pipe.vae_params["conv_in"]["w"],
             vae_dec["conv_in"]["w"])
    log.same("vae decoder.up_blocks[1].upsample.w", pipe.vae_params["up_blocks"][1]["upsample"]["w"],
             vae_dec["up_blocks"][1]["upsample"]["w"])
    log.same("vae decoder.mid_attn.q.w", pipe.vae_params["mid_attn"]["q"]["w"],
             vae_dec["mid_attn"]["q"]["w"])
    for rec in log.loads:
        emit(dict(phase="hunyuan_files_load", **rec, device=card))
    emit({"phase": "hunyuan_files_leaves", "checks": log.checks, "device": card})
    if pipe.cfg != cut or not all(c["bit_for_bit"] for c in log.checks):
        raise AssertionError(f"hunyuan files: config {pipe.cfg} or leaves differ: {log.checks}")
    del m, vae_dec, vae_enc

    h, w, frames = geo["size"]
    enc.max_length = geo["text_len"]
    reset_launches(FA)
    t0 = time.perf_counter()
    out = HunyuanVideoSampler(pipe).predict(HV_PROMPTS[0], height=h, width=w,
                                            video_length=frames, seed=7)
    sec = time.perf_counter() - t0
    check_launches(FA, "hunyuan_files_predict", FA.flash_attn_fwd.launches, dd + ds, HV_STEPS)
    check_videos(out["samples"], (frames, h, w, 3))
    emit({"phase": "hunyuan_files_predict", "seconds": sec, "seeds": out["seeds"],
          "device": card})
    del pipe, enc, pooler, out
    torch.cuda.empty_cache()

    goldens = os.path.join(tmp, "goldens.npz")
    args = ["--goldens", goldens, "--hunyuan-llm", paths["llm"], "--hunyuan-vae", paths["vae"],
            "--hunyuan-dit", paths["dit"], "--device", str(dev)]
    t0 = time.perf_counter()
    recorded = VW.main(args + ["--record"])
    checked = VW.main(args)
    names = ("hunyuan_llm", "hunyuan_vae", "hunyuan_dit")
    emit({"phase": "hunyuan_verify_weights", "recorded": recorded, "checked": checked,
          "seconds": time.perf_counter() - t0, "device": card})
    if recorded != {n: "recorded" for n in names} or checked != {n: "ok" for n in names}:
        raise AssertionError(f"verify_weights on the HunyuanVideo files: {checked}")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Mochi-1
# ---------------------------------------------------------------------------

MOCHI_SEEDS = (2024, 2025)
MOCHI_STEPS = 2  # cut from 64
MOCHI_SIZE = (480, 848, 37)  # the published 480x848; 37 frames: 7 x 60 x 106 latents
MOCHI_LONG = (480, 848, 163)  # the published 163 frames: 28 x 60 x 106 latents
MOCHI_CUT_DEPTH = 3  # the gradient's and the files' blocks: 2 + the final block
MOCHI_EAGER_HEADS = 8  # heads per chunk of the eager reference (4.1 GB of f32 scores)
MOCHI_LONG_HEADS = 1  # per chunk of the plain version at 163 frames (8.0 GB of f32 scores)
# The full-depth output of the kernel path may stand this much further from
# eager attention's than eager attention stands from itself on q rounded
# once otherwise.  On the H100 the sound pairs read 0.990-1.000 of that
# floor, a planted 0.8% error in the softmax scale 1.17 and 1.6% 1.39.
MOCHI_FLOOR_SLACK = 1.1


def mochi_geometry():
    """The released geometries (the DiT, 10.03 B parameters, and the VAE
    decoder), the phase's sizes and its depth cut.  A CPU rehearsal passes
    tiny ones."""
    from mixgrpo_tpu_torch.models.mochi.model import MochiConfig
    from mixgrpo_tpu_torch.models.mochi.vae import MochiVAEConfig

    return {"dit": MochiConfig.mochi_preview(), "vae": MochiVAEConfig.mochi_preview(),
            "size": MOCHI_SIZE, "size_long": MOCHI_LONG, "text_len": 256, "text_kept": 40,
            "cut_depth": MOCHI_CUT_DEPTH, "eager_heads": MOCHI_EAGER_HEADS,
            "long_heads": MOCHI_LONG_HEADS}


def mochi_kernel_class(name):
    """``video_kernel_class`` with SiLU (the SwiGLU gates and the
    modulations) split out of the elementwise class."""
    return "silu" if "silu" in name.lower() else video_kernel_class(name)


def by_heads(torch, fn, heads):
    """``fn(q, k, v)`` (bhsd, no mask) run ``heads`` heads at a time through
    ``batch_chunks``: one Mochi layer's f32 scores at 480x848, 37 frames are
    12.4 GB whole.  ``fn`` is the eager attention (``ops/attention.py``'s
    f32 path) or the kernel's plain version."""
    def attend(q, k, v, **_):
        hb = lambda t: t.transpose(0, 1)  # heads first, so batch_chunks slices heads
        f = lambda a, b, c: hb(fn(hb(a), hb(b), hb(c)))
        return hb(batch_chunks(torch, f, q.shape[1], heads, hb(q), hb(k), hb(v)))
    return attend


def mochi_inputs(torch, dev, geo, seed, frames=None):
    """The inputs of one Mochi DiT call, drawn from ``seed``: latents (1, lt,
    h/8, w/8, C) and T5 features (1, L, 4096) in bf16, a mask keeping
    ``text_kept`` of ``text_len`` tokens, and t = 0.6."""
    cfg, (h, w, f) = geo["dit"], geo["size"]
    f = frames or f
    g = torch.Generator(dev).manual_seed(seed)
    z = torch.randn((1, (f - 1) // 6 + 1, h // 8, w // 8, cfg.in_channels), generator=g,
                    device=dev).bfloat16()
    txt = torch.randn((1, geo["text_len"], cfg.text_embed_dim), generator=g,
                      device=dev).bfloat16()
    mask = torch.zeros((1, geo["text_len"]), dtype=torch.int32, device=dev)
    mask[:, :geo["text_kept"]] = 1
    return z, txt, mask, torch.full((1,), 0.6, device=dev)


def mochi_video_phase(torch, FA, dev, card, root, rows, geo=None):
    """Mochi-1 at full width and depth with random bf16 weights (see the
    module docstring): ``MochiPipeline`` at 480x848, 37 frames, 2 steps of
    CFG 4.5 (two DiT calls a step), two prompts of random T5 features with
    40 of 256 tokens valid (B = 1 per video), the tiled decode; its seconds
    per video split into denoise and decode, its DiT calls, tiles, peak and
    launches (48 forwards per DiT call, nothing else); the profile of one DiT
    call and of one decode tile; one DiT forward at that size with each
    block's kernel call held against eager attention on its inputs, and the
    output against eager attention's, the floor of eager attention against
    itself on the rounded q, the model's in f32 and a planted fault's, all
    8 heads at a time (``by_heads``); two forwards at
    163 frames (cold, then warm), the first and the final block's kernel
    calls of the cold one held against the plain version one head at a time;
    a gradient through ``mochi_forward`` at 2 +
    the final block against eager (the forward with lse, dkv and dq at Sq !=
    Sk); then the files (``mochi_files_phase``).  Returns the Mochi launches
    of each kernel.  ``geo`` (default ``mochi_geometry()``) lets the phase
    be rehearsed at a tiny size."""
    import dataclasses
    import shutil
    import tempfile

    from mixgrpo_tpu_torch.models.flux.model import param_count
    from mixgrpo_tpu_torch.models.mochi import model as MM
    from mixgrpo_tpu_torch.models.mochi import vae as MV
    from mixgrpo_tpu_torch.models.mochi.pipeline import MochiPipeline

    geo = geo or mochi_geometry()
    cfg, vcfg, bf16 = geo["dit"], geo["vae"], torch.bfloat16
    gen = lambda s: torch.Generator(dev).manual_seed(s)
    per_call, launches = cfg.num_layers, {}

    # -- 1. the pipeline at full width and depth -----------------------------------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dit = MM.init_mochi(cfg, generator=gen(50), device=dev, dtype=bf16)
    vae = MV.init_mochi_vae_decoder(vcfg, generator=gen(51), device=dev, dtype=bf16)
    torch.cuda.synchronize()
    emit({"phase": "mochi_weights", "dit_params": param_count(dit),
          "vae_decoder_params": param_count(vae), "dtype": "bfloat16",
          "seconds": time.perf_counter() - t0,
          "allocated_gb": torch.cuda.memory_allocated() / 1e9, "device": card})
    pipe = MochiPipeline(cfg, dit, num_steps=MOCHI_STEPS, guidance_scale=4.5, vae_cfg=vcfg,
                         vae_params=vae, device=dev)
    stage_s = {"denoise": [], "decode": []}
    for stage, name in (("denoise", "_sample"), ("decode", "_decode")):
        def timed(*a, _fn=getattr(pipe, name), _stage=stage, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            stage_s[_stage].append(time.perf_counter() - t)
            return out
        setattr(pipe, name, timed)
    h, w, frames = geo["size"]
    prompts = [mochi_inputs(torch, dev, geo, seed) for seed in MOCHI_SEEDS]
    lat_shape = tuple(prompts[0][0].shape)
    decode, tiles = MV.mochi_vae_decode, []  # the tiled decode calls it once per tile

    def count_tiles(*a, **k):
        tiles.append(1)
        return decode(*a, **k)

    reset_launches(FA)
    t0 = time.perf_counter()
    MV.mochi_vae_decode = count_tiles
    try:
        videos = [pipe(txt, text_mask=mask, num_frames=frames, height=h, width=w,
                       generator=gen(seed))[0].cpu().numpy()
                  for (_, txt, mask, _), seed in zip(prompts, MOCHI_SEEDS)]
    finally:
        MV.mochi_vae_decode = decode
    wall = time.perf_counter() - t0
    n, calls = len(videos), len(videos) * MOCHI_STEPS * 2
    launches["flash_attn_fwd"] = FA.flash_attn_fwd.launches
    peak = torch.cuda.max_memory_allocated()
    check_launches(FA, "mochi_video_pipeline", launches["flash_attn_fwd"], per_call, calls,
                   flux_blocks=False)
    check_videos(videos, (1 + (lat_shape[1] - 1) * 6, h, w, 3))
    S_vis = lat_shape[1] * (h // 16) * (w // 16)
    emit({"phase": "mochi_video_pipeline", "height": h, "width": w, "frames": frames,
          "frames_out": videos[0].shape[0], "latents": list(lat_shape[1:4]),
          "steps": MOCHI_STEPS, "guidance": 4.5, "videos": n, "dit_calls": calls,
          "seq": S_vis + geo["text_kept"], "seq_final_block_q": S_vis,
          "tiled_decode": pipe.tiles(lat_shape), "tiles_per_video": len(tiles) / n,
          "wall_s": wall, "s_per_video": wall / n, "denoise_s_per_video": stage_s["denoise"],
          "decode_s_per_video": stage_s["decode"], "flash_launches": launches["flash_attn_fwd"],
          "max_memory_allocated_gb": peak / 1e9,
          "frame_mean": [float(v.mean()) for v in videos], "device": card})
    if peak >= 80e9:
        raise AssertionError(f"mochi pipeline: peak {peak / 1e9} GB")
    del videos, pipe

    # where a video's time goes: one DiT call and one decode tile, profiled
    z, txt, mask, t = prompts[0]
    fwd = lambda zz=z, **kw: MM.mochi_forward(dit, cfg, zz, txt, t, mask, **kw)
    with torch.no_grad():
        profile_device(torch, f"one mochi DiT call at {h}x{w}x{frames}, bf16",
                       lambda: fwd(), card, mochi_kernel_class)
        tile = z[:, :, :32, :32].float()  # one tile of the tiled decode
        profile_device(torch, f"one mochi VAE decode tile {list(tile.shape[1:4])}, bf16",
                       lambda: MV.mochi_vae_decode(vae, vcfg, tile), card, mochi_kernel_class)
    del tile, vae
    torch.cuda.empty_cache()

    # -- 2. the model path through the kernel against eager attention ---------------
    # Each of the 48 kernel calls of the full-depth forward is held against
    # eager attention on its own q, k, v (close_bf16).  End to end no two
    # bf16 attentions meet close_bf16 at 48 blocks: each rounds its output
    # to bf16, and the roundings add up over the depth.  So the floor is read
    # in the run, from eager attention against itself on q rounded once
    # otherwise (q times D^-1/2 in bf16, as the kernel and JAX's kernel take
    # it); the kernel path must stand no further from eager's output than
    # MOCHI_FLOOR_SLACK times that floor, and from the model's output in f32
    # (f32 activations, eager attention) than that times eager's bf16 path's
    # distance; a planted fault (the kernel on q scaled by 1 + 2^-7) must
    # stand further than the limit.
    from mixgrpo_tpu_torch.ops.attention import _eager_attention

    eager = by_heads(torch, _eager_attention, geo["eager_heads"])
    eager_qs = by_heads(torch, lambda q, k, v: _eager_attention(FA._scaled_q(q), k, v,
                                                                scale=1.0), geo["eager_heads"])
    plain = by_heads(torch, FA.flash_attention_reference, geo["eager_heads"])
    attention, per_block = MM.attention, []

    def checked(q, k, v, **kw):
        out = attention(q, k, v, **kw)
        per_block.append(close_bf16(out, eager(q, k, v)))
        return out

    def planted(q, k, v, **kw):
        return attention((q.float() * (1 + 2.0 ** -7)).to(q.dtype), k, v, **kw)

    variants = {"plain": (plain, bf16), "eager_rounded_q": (eager_qs, bf16),
                "eager": (eager, bf16), "f32": (eager, torch.float32),
                "planted_fault": (planted, bf16)}
    reset_launches(FA)
    with torch.no_grad():
        try:
            MM.attention = checked
            outs = {"kernel": fwd()}
            torch.cuda.synchronize()
            check_launches(FA, "mochi_flash_vs_eager", FA.flash_attn_fwd.launches, per_call, 1,
                           flux_blocks=False)
            for name, (attend, dt) in variants.items():
                MM.attention = attend
                outs[name] = fwd(dtype=dt)
        finally:
            MM.attention = attention
    pairs = {f"{a}_vs_{b}": close_bf16(outs[a], outs[b])
             for a, b in (("kernel", "eager"), ("kernel", "plain"), ("kernel", "f32"),
                          ("eager", "eager_rounded_q"), ("eager", "f32"),
                          ("planted_fault", "eager"))}
    rel = {k: c[2] for k, c in pairs.items()}
    floor = rel["eager_vs_eager_rounded_q"]
    ok = (len(per_block) == per_call and all(c[0] for c in per_block)
          and rel["kernel_vs_eager"] <= MOCHI_FLOOR_SLACK * floor
          and rel["kernel_vs_f32"] <= MOCHI_FLOOR_SLACK * rel["eager_vs_f32"]
          and rel["planted_fault_vs_eager"] > MOCHI_FLOOR_SLACK * floor)
    emit({"phase": "reference", "what": f"mochi forward at {h}x{w}x{frames}, full depth, "
          f"{geo['text_len'] - geo['text_kept']} of {geo['text_len']} text tokens masked (cut "
          "before the blocks), bf16, kernel vs eager attention: each block's attention on its own "
          "inputs; the output against eager's, the plain version's and the f32 model's",
          "blocks_checked": len(per_block), "blocks_ok": sum(c[0] for c in per_block),
          "block_rel_l2_max": max(c[2] for c in per_block),
          "block_max_abs_err_max": max(c[1] for c in per_block),
          "max_abs_f32": outs["f32"].abs().max().item(),
          "pairs": {k: {"rel_l2": c[2], "max_abs_err": c[1], "close_bf16": c[0]}
                    for k, c in pairs.items()},
          "floor_rel_l2": floor, "slack": MOCHI_FLOOR_SLACK,
          "kernel_over_floor": rel["kernel_vs_eager"] / floor,
          "planted_fault_over_floor": rel["planted_fault_vs_eager"] / floor,
          "limit": "close_bf16 per block; kernel_vs_eager <= slack x floor; kernel_vs_f32 <= "
                   "slack x eager_vs_f32; planted_fault_vs_eager > slack x floor",
          "ok": ok, "device": card})
    if not ok:
        raise AssertionError(f"mochi forward: kernel path {pairs}, blocks {per_block}")
    del outs

    # -- 3. two forwards at 163 frames: cold, then warm -------------------------------
    # the cold call keeps the first and the final block's attention inputs
    # and kernel outputs, held afterwards against the plain version
    zl = mochi_inputs(torch, dev, geo, 52, frames=geo["size_long"][2])[0]
    torch.cuda.reset_peak_memory_stats()
    reset_launches(FA)
    call_ms, kept, seen = [], [], []

    def keep(q, k, v, **kw):
        out = attention(q, k, v, **kw)
        seen.append(1)
        if len(seen) in (1, per_call):
            kept.append((len(seen) - 1, *(x.clone() for x in (q, k, v, out))))
        return out

    for cold in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        MM.attention = keep if cold else attention
        try:
            with torch.no_grad():
                vl = fwd(zl)
        finally:
            MM.attention = attention
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3)
    check_launches(FA, "mochi_163_forward", FA.flash_attn_fwd.launches, per_call, 2,
                   flux_blocks=False)
    peak, finite = torch.cuda.max_memory_allocated(), bool(torch.isfinite(vl).all())
    del vl
    plain_long, blocks = by_heads(torch, FA.flash_attention_reference, geo["long_heads"]), []
    with torch.no_grad():
        for i, q, k, v, out in kept:
            c = close_bf16(out, plain_long(q, k, v))
            blocks.append({"block": i, "S": q.shape[2], "Sk": k.shape[2], "ok": c[0],
                           "max_abs_err": c[1], "rel_l2": c[2]})
    n_vis = zl.shape[1] * (h // 16) * (w // 16)
    ok = finite and len(blocks) == 2 and all(b["ok"] for b in blocks)
    emit({"phase": "mochi_long_forward", "height": h, "width": w,
          "frames": geo["size_long"][2], "latents": list(zl.shape[1:4]), "seq": n_vis +
          geo["text_len"], "seq_final_block_q": n_vis, "ms": call_ms[1], "cold_ms": call_ms[0],
          "finite": finite, "max_memory_allocated_gb": peak / 1e9, "kernel_vs_plain": blocks,
          "limit": "close_bf16", "ok": ok, "device": card})
    if not ok:
        raise AssertionError(f"mochi 163-frame forward: finite {finite}, kernel vs plain "
                             f"{blocks}")
    del kept, zl

    # -- 4. a gradient at 2 + the final block: kernel path against eager --------------
    d = geo["cut_depth"]
    ccfg = dataclasses.replace(cfg, num_layers=d)
    cut = dict(dit, blocks=tree_map(lambda x: x[:d - 1].clone(), dit["blocks"]),
               final_block=tree_map(lambda x: x.clone(), dit["final_block"]))
    del dit
    torch.cuda.empty_cache()
    w_out = torch.randn(z.shape, generator=gen(53), device=dev)
    wq = cut["final_block"]["qkv"]["w"]

    def grads(attend):
        zz = z.float().requires_grad_(True)
        cut["final_block"]["qkv"]["w"] = wq.detach().clone().requires_grad_(True)
        attention, MM.attention = MM.attention, attend or MM.attention
        try:
            out = MM.mochi_forward(cut, ccfg, zz, txt, t, mask)
            (out * w_out).sum().backward()
        finally:
            MM.attention = attention
        return out.detach(), zz.grad, cut["final_block"]["qkv"]["w"].grad

    torch.cuda.reset_peak_memory_stats()
    reset_launches(FA)
    got = grads(None)
    torch.cuda.synchronize()
    grad_launches = {k: f.launches for k, f in FA.KERNEL_WRAPPERS.items()}
    want = grads(eager)
    checks = [close_bf16(g, e) for g, e in zip(got, want)]
    # the forward with lse runs twice per block (remat's recompute), dkv and dq once
    expected = {"flash_attn_fwd": 0, "flash_attn_fwd_lse": 2 * d, "flash_attn_bwd_fused": 0,
                "flash_attn_bwd_dkv": d, "flash_attn_bwd_dq": d}
    ok = all(c[0] for c in checks) and grad_launches == expected
    emit({"phase": "mochi_gradient", "what": f"d(sum(out * w))/d(latents, final qkv) through "
          f"mochi_forward at {h}x{w}x{frames}, {d - 1} + final block, full width, remat, bf16, "
          "kernel vs eager attention", "outputs": ["forward", "d_latents", "d_final_qkv"],
          "rel_l2": [c[2] for c in checks], "max_abs_err": [c[1] for c in checks],
          "limit": "close_bf16", "launches": grad_launches, "expected_launches": expected,
          "default_bwd": [FA.default_bwd(S_vis + geo["text_len"], S_vis + geo["text_len"]),
                          FA.default_bwd(S_vis, S_vis + geo["text_len"])],
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9, "ok": ok,
          "device": card})
    if not ok:
        raise AssertionError(f"mochi gradient: {checks}, launches {grad_launches}")
    launches.update({k: v for k, v in grad_launches.items() if k != "flash_attn_fwd"})
    del cut, got, want, prompts
    torch.cuda.empty_cache()

    # -- 5. from files in the diffusers layouts -----------------------------------------
    tmp = tempfile.mkdtemp(dir=root, prefix=".smoke_mochi_")
    try:
        mochi_files_phase(torch, FA, dev, card, tmp, geo)
    finally:  # cleanup only; failures propagate
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def mochi_files_phase(torch, FA, dev, card, tmp, geo):
    """Step 5 of ``mochi_video_phase``: a transformer directory written by
    ``save_mochi_diffusers`` at full width, cut to 2 + the final block, and
    the full VAE decoder under diffusers' names, loaded onto the card in
    bf16 with a dozen leaves held bit for bit; the convert CLI's round trip
    (byte for byte); ``verify_weights.main`` record-then-check for ``mochi``
    and ``mochi_vae``."""
    import dataclasses
    import filecmp

    from mixgrpo_tpu_torch import verify_weights as VW
    from mixgrpo_tpu_torch.models.mochi import convert as MC
    from mixgrpo_tpu_torch.models.mochi.model import init_mochi
    from mixgrpo_tpu_torch.models.mochi.pipeline import MochiPipeline
    from mixgrpo_tpu_torch.models.mochi.vae import init_mochi_vae_decoder
    from mixgrpo_tpu_torch.utils.safetensors_io import save_file

    bf16 = torch.bfloat16
    cut = dataclasses.replace(geo["dit"], num_layers=geo["cut_depth"])
    t0 = time.perf_counter()
    dit = init_mochi(cut, generator=torch.Generator(dev).manual_seed(54), device=dev, dtype=bf16)
    vae = init_mochi_vae_decoder(geo["vae"], generator=torch.Generator(dev).manual_seed(55),
                                 device=dev, dtype=bf16)
    paths = {"dit": os.path.join(tmp, "transformer"), "vae": os.path.join(tmp, "vae")}
    MC.save_mochi_diffusers(dit, cut, paths["dit"])
    save_file(mochi_vae_state(vae), os.path.join(paths["vae"],
                                                 "diffusion_pytorch_model.safetensors"),
              dtype=torch.float32)
    torch.cuda.synchronize()
    emit({"phase": "mochi_files_write", "seconds": time.perf_counter() - t0,
          "gb": {k: dir_bytes(p) / 1e9 for k, p in paths.items()}, "dit_depth": cut.num_layers,
          "dtype_on_disk": "F32", "device": card})

    log = LoadLog(torch)
    pipe = log.load("transformer + vae", lambda: MochiPipeline.from_checkpoint(
        paths["dit"], paths["vae"], vae_cfg=geo["vae"], device=dev, dtype=bf16,
        num_steps=MOCHI_STEPS),
        dir_bytes(paths["dit"]) + dir_bytes(paths["vae"]))
    for what, path in (("patch_embed.w (conv (out, C, 2, 2) flattened)", ("patch_embed", "w")),
                       ("blocks.qkv.w[-1] (to_q|to_k|to_v)", ("blocks", "qkv", "w", -1)),
                       ("blocks.add_kv.w[0]", ("blocks", "add_kv", "w", 0)),
                       ("blocks.add_qnorm[1]", ("blocks", "add_qnorm", 1)),
                       ("final_block.mod_c.lin.w (norm1_context.linear_1)",
                        ("final_block", "mod_c", "lin", "w")),
                       ("final_block.ff_in.w", ("final_block", "ff_in", "w")),
                       ("pooler.to_kv.w", ("pooler", "to_kv", "w")),
                       ("pos_frequencies", ("pos_frequencies",)),
                       ("proj_out.w", ("proj_out", "w"))):
        a, b = pipe.params, dit
        for k in path:
            a, b = a[k], b[k]
        log.same(what, a, b)
    log.same("vae conv_in.w (1x1x1 from a Linear)", pipe.vae_params["conv_in"]["w"],
             vae["conv_in"]["w"])
    log.same("vae up_blocks[1].proj.w", pipe.vae_params["up_blocks"][1]["proj"]["w"],
             vae["up_blocks"][1]["proj"]["w"])
    log.same("vae block_out[-1].conv2.w", pipe.vae_params["block_out"][-1]["conv2"]["w"],
             vae["block_out"][-1]["conv2"]["w"])
    for rec in log.loads:
        emit(dict(phase="mochi_files_load", **rec, device=card))
    emit({"phase": "mochi_files_leaves", "checks": log.checks, "device": card})
    if pipe.cfg != dataclasses.replace(cut, max_text_len=256) or not all(
            c["bit_for_bit"] for c in log.checks):
        raise AssertionError(f"mochi files: config {pipe.cfg} or leaves differ: {log.checks}")
    del pipe, dit, vae
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    out = os.path.join(tmp, "round_trip")
    MC.main(["--in", paths["dit"], "--out", out, "--device", str(dev)])
    same = all(filecmp.cmp(os.path.join(paths["dit"], f), os.path.join(out, f), shallow=False)
               for f in ("diffusion_pytorch_model.safetensors", "config.json"))
    emit({"phase": "mochi_convert_cli", "seconds": time.perf_counter() - t0,
          "byte_for_byte": same, "device": card})
    if not same:
        raise AssertionError("mochi convert CLI: the round trip changed the files")
    torch.cuda.empty_cache()

    goldens = os.path.join(tmp, "goldens.npz")
    args = ["--goldens", goldens, "--mochi", paths["dit"], "--mochi-vae", paths["vae"],
            "--device", str(dev)]
    t0 = time.perf_counter()
    recorded = VW.main(args + ["--record"])
    checked = VW.main(args)
    names = ("mochi", "mochi_vae")
    emit({"phase": "mochi_verify_weights", "recorded": recorded, "checked": checked,
          "seconds": time.perf_counter() - t0, "device": card})
    if recorded != {n: "recorded" for n in names} or checked != {n: "ok" for n in names}:
        raise AssertionError(f"verify_weights on the Mochi files: {checked}")
    torch.cuda.empty_cache()


# -- sequence-parallel video DiTs, the HunyuanVideo gradient, LoRA on a mesh ----------

SP_HV_DEPTH = (2, 4)  # video_sp's and the gradient's HunyuanVideo blocks (of 20 + 40)
SP_MOCHI_DEPTH = 3  # video_sp's Mochi blocks: 2 + the final block (of 48)
SP_CALLS = 2  # timed calls per attention implementation, after one warm-up call
LORA_RANK = 16
PAR_LORA_PROMPTS = 2  # one per batch rank at fsdp = 2


def sp_inputs(torch, dev, kind, seed):
    """One DiT call's inputs at the full sizes: HunyuanVideo at 192x336, 129
    frames (33 x 24 x 42 latents, S = 256 + 8316, run as 8576) with 40 of
    256 text tokens kept; Mochi at 480x848, 37 frames (7 x 60 x 106 latents,
    11,130 visual tokens and 256 text tokens, 40 valid: under sequence
    parallelism nothing is cut, and the 216 padded enter as a key mask)."""
    from mixgrpo_tpu_torch.models.hunyuan.model import HunyuanVideoConfig
    from mixgrpo_tpu_torch.models.mochi.model import MochiConfig

    g = torch.Generator(dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()
    mask = torch.zeros((1, 256), dtype=torch.int32, device=dev)
    mask[:, :40] = 1
    if kind == "hunyuan":
        cfg = HunyuanVideoConfig.hunyuan_video()
        h, w, f = HV_SIZE
        z = rnd(1, (f - 1) // 4 + 1, h // 8, w // 8, cfg.in_channels)
        return dict(video_latents=z, txt=rnd(1, 256, cfg.text_states_dim),
                    pooled=rnd(1, cfg.text_states_dim_2),
                    timestep=torch.full((1,), 0.6, device=dev),
                    guidance=torch.full((1,), 6.0, device=dev), text_mask=mask)
    cfg = MochiConfig.mochi_preview()
    h, w, f = MOCHI_SIZE
    return dict(video_latents=rnd(1, (f - 1) // 6 + 1, h // 8, w // 8, cfg.in_channels),
                txt=rnd(1, 256, cfg.text_embed_dim),
                timestep=torch.full((1,), 0.6, device=dev), text_mask=mask)


def sp_model(torch, dev, kind):
    """(config, random bf16 weights, forward) of a DiT at full width:
    HunyuanVideo at ``SP_HV_DEPTH`` (the refiner's gates drawn, as
    ``hunyuan_models`` does) or Mochi at ``SP_MOCHI_DEPTH``."""
    import dataclasses

    from mixgrpo_tpu_torch.models.hunyuan import model as HM
    from mixgrpo_tpu_torch.models.mochi import model as MM

    gen = lambda s: torch.Generator(dev).manual_seed(s)
    if kind == "mochi":
        cfg = dataclasses.replace(MM.MochiConfig.mochi_preview(), num_layers=SP_MOCHI_DEPTH)
        return cfg, MM.init_mochi(cfg, generator=gen(72), device=dev,
                                  dtype=torch.bfloat16), MM.mochi_forward
    cfg = dataclasses.replace(HM.HunyuanVideoConfig.hunyuan_video(),
                              depth_double=SP_HV_DEPTH[0], depth_single=SP_HV_DEPTH[1])
    params = HM.init_hunyuan_video(cfg, generator=gen(70), device=dev, dtype=torch.bfloat16)
    for bp in params["txt_in"]["blocks"]:  # init's zero gates would bypass the refiner
        bp["mod"]["lin"]["w"].normal_(0.0, 0.02, generator=gen(71))
    return cfg, params, HM.hunyuan_video_forward


def hunyuan_gradient(torch, FA, dev, card):
    """d(sum(out * w)) / d(latents, double block 0's img_qkv) through
    ``hunyuan_video_forward(remat=True)`` at full width, ``SP_HV_DEPTH``
    blocks, 192x336x129 with 216 of 256 text tokens masked, with the kernels
    against the same with eager attention (record ``hunyuan_gradient``):
    the forward with lse, dkv and dq carry the text mask's key-bias row."""
    from mixgrpo_tpu_torch.models.flux.model import param_count

    cfg, params, fwd = sp_model(torch, dev, "hunyuan")
    x = sp_inputs(torch, dev, "hunyuan", 73)
    w_out = torch.randn(x["video_latents"].shape, generator=torch.Generator(dev).manual_seed(74),
                        device=dev)
    wq = params["double"]["img_qkv"]["w"]

    def grads(impl):
        zz = x["video_latents"].float().requires_grad_(True)
        leaf = wq.detach().clone().requires_grad_(True)
        params["double"]["img_qkv"]["w"] = leaf
        out = fwd(params, cfg, **dict(x, video_latents=zz), attn_impl=impl, remat=True)
        (out * w_out).sum().backward()
        return out.detach(), zz.grad, leaf.grad[0]

    torch.cuda.reset_peak_memory_stats()
    reset_launches(FA)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = grads("auto")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: f.launches for n, f in FA.KERNEL_WRAPPERS.items()}
    peak = torch.cuda.max_memory_allocated()
    want = grads("eager")
    checks = [close_bf16(g, e) for g, e in zip(got, want)]
    blocks = sum(SP_HV_DEPTH)
    S = 256 + x["video_latents"].shape[1] * (HV_SIZE[0] // 16) * (HV_SIZE[1] // 16)
    S_pad = -(-S // 128) * 128
    split = FA.default_bwd(S_pad, S_pad) == "split"
    # the forward with lse twice per block (remat's recompute), one backward each
    expected = {"flash_attn_fwd": 0, "flash_attn_fwd_lse": 2 * blocks,
                "flash_attn_bwd_fused": 0 if split else blocks,
                "flash_attn_bwd_dkv": blocks if split else 0,
                "flash_attn_bwd_dq": blocks if split else 0}
    ok = all(c[0] for c in checks) and launches == expected
    emit({"phase": "hunyuan_gradient", "what": "d(sum(out * w))/d(latents, double block 0's "
          f"img_qkv) through hunyuan_video_forward at {HV_SIZE}, {SP_HV_DEPTH[0]} + "
          f"{SP_HV_DEPTH[1]} blocks, full width, remat, bf16, 216 of 256 text tokens and "
          f"{S_pad - S} pad keys masked, kernels vs eager attention",
          "dit_params": param_count(params), "seq": S, "seq_padded": S_pad,
          "outputs": ["forward", "d_latents", "d_img_qkv_block0"],
          "rel_l2": [c[2] for c in checks], "max_abs_err": [c[1] for c in checks],
          "limit": "close_bf16", "launches": launches, "expected_launches": expected,
          "default_bwd": FA.default_bwd(S_pad, S_pad), "seconds_kernels": seconds,
          "max_memory_allocated_gb": peak / 1e9, "ok": ok, "device": card})
    if not ok:
        raise AssertionError(f"hunyuan gradient: {checks}, launches {launches} != {expected}")
    return launches


def rank_video_sp(torch, FA, C, dev, rank, world, d, rec, extra):
    """HunyuanVideo (``SP_HV_DEPTH`` blocks) and Mochi (``SP_MOCHI_DEPTH``)
    at full width and the phase's sizes, each call with ``attn_impl``
    ``"auto"`` (this rank alone: the reference), then ``"ulysses"`` and, for
    HunyuanVideo, ``"ring"`` over sp = ranks; per implementation: ms per call
    (``SP_CALLS`` after a warm-up), gloo's bytes per call, the kernel's
    launches and the heads of each local attention call, and the output
    against the reference (``close_bf16``)."""
    import mixgrpo_tpu_torch.ops.attention as OA
    from mixgrpo_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from mixgrpo_tpu_torch.parallel.ulysses import set_sp_context

    mesh = make_mesh(MeshConfig(dp=1, sp=world), device=dev)
    set_sp_context(mesh, "sp")
    local_heads = []
    attention = OA.attention

    def counted(q, *a, **k):  # ulysses' local attention: (B, H/sp, S, D)
        local_heads.append(q.shape[1])
        return attention(q, *a, **k)

    runs = []
    for kind, impls in (("hunyuan", ("auto", "ulysses", "ring")), ("mochi", ("auto", "ulysses"))):
        cfg, params, fwd = sp_model(torch, dev, kind)
        x = sp_inputs(torch, dev, kind, 75)
        ref = None
        for impl in impls:
            call = lambda: fwd(params, cfg, **x, attn_impl=impl)
            OA.attention = counted
            try:
                with torch.no_grad():
                    call()  # warm-up: allocations and first calls
                    torch.cuda.synchronize()
                    reset_launches(FA)
                    C.reset_transport()
                    local_heads.clear()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    for _ in range(SP_CALLS):
                        out = call()
                    torch.cuda.synchronize()
            finally:
                OA.attention = attention
            ms = (time.perf_counter() - t0) * 1e3 / SP_CALLS
            run = {"model": kind, "impl": impl, "ms_per_call": ms,
                   "launches_per_call": {n: f.launches / SP_CALLS
                                         for n, f in FA.KERNEL_WRAPPERS.items()},
                   "local_heads": sorted(set(local_heads)),
                   "bytes_per_call": {op: n / SP_CALLS for op, n in
                                      C.transport_record()["bytes"].items()},
                   "transport": C.transport_record(),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "finite": bool(torch.isfinite(out).all())}
            if ref is None:
                ref = out
            else:
                ok, err, rel = close_bf16(out, ref)
                run.update(ok=ok, max_abs_err=err, rel_l2=rel)
            runs.append(run)
        del ref, out, params
    rec["runs"] = runs
    set_sp_context(None)


def video_sp_phase(torch, FA, dev, card, root):
    """The HunyuanVideo gradient on this process's card (``hunyuan_gradient``),
    then HunyuanVideo and Mochi under sequence parallelism over the ranks of
    ``parallel_layout`` (``rank_video_sp``; record ``video_sp``).  Returns
    the gradient's launches."""
    import shutil
    import tempfile

    from mixgrpo_tpu_torch.parallel.mesh import backend_for

    grad_launches = hunyuan_gradient(torch, FA, dev, card)
    torch.cuda.empty_cache()
    world = parallel_layout(torch)
    backend = backend_for(dev, world)
    d = tempfile.mkdtemp(dir=root, prefix=".smoke_parallel_")
    try:
        t0 = time.perf_counter()
        ranks = spawn_ranks("video_sp", d, timeout=400, world=world)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    blocks = {"hunyuan": sum(SP_HV_DEPTH), "mochi": SP_MOCHI_DEPTH}
    heads = {"auto": 24, "ulysses": 24 // world, "ring": None}
    ok = all(r["backend"] == backend for r in ranks)
    for r in ranks:
        for run in r["runs"]:
            n = blocks[run["model"]]
            want = {name: 0.0 for name in run["launches_per_call"]}
            if run["impl"] != "ring":  # ring attends with einsums
                want["flash_attn_fwd"] = float(n)
            run["expected_launches_per_call"] = want
            run["expected_local_heads"] = [] if run["impl"] != "ulysses" else [heads["ulysses"]]
            ok &= run["finite"] and run["launches_per_call"] == want
            ok &= run["local_heads"] == run["expected_local_heads"]
            ok &= run.get("ok", True)
            if run["impl"] == "ulysses":
                ok &= not run["transport"]["staged"].get("all_to_all", 0)
    emit({"phase": "video_sp", "sp": world, "backend": backend,
          "depth": {"hunyuan": SP_HV_DEPTH, "mochi": SP_MOCHI_DEPTH},
          "sizes": {"hunyuan": HV_SIZE, "mochi": MOCHI_SIZE}, "limit": "close_bf16",
          "ranks": ranks, "seconds": wall,
          "peak_gb_per_rank": [r["max_memory_allocated_gb"] for r in ranks],
          "note": layout_note(world, backend), "device": card})
    if not ok:
        raise AssertionError("video_sp: an SP forward disagreed with one rank's, launched other "
                             "kernels or heads than predicted, or staged an all-to-all")
    return grad_launches


def lora_base(torch, flux_cfg, dev):
    """The frozen bf16 base of parallel_lora, from parallel_tp's seed with
    every bias drawn (``tp_params``, cast)."""
    return tree_map(lambda t: t.to(torch.bfloat16), tp_params(torch, flux_cfg, dev))


def full_depth_shards(torch, mesh, dev):
    """Allocate this rank's shards of the full-depth FLUX.1-dev base in bf16,
    cut as ``GRPOTrainer`` cuts it (``flux_param_specs``, ``shard_params`` on
    a meta tree: nothing whole is allocated); returns the byte counts."""
    from mixgrpo_tpu_torch.models.flux import model as M
    from mixgrpo_tpu_torch.parallel.sharding import flux_param_specs, shard_params

    meta = M.init_flux(M.FluxConfig(), device="meta", dtype=torch.bfloat16)
    shards = shard_params(meta, mesh, flux_param_specs(meta, mesh))
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in M.param_leaves(tree))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    resident = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev), shards)
    torch.cuda.synchronize()
    out = {"params": M.param_count(meta), "whole_gb": nbytes(meta) / 1e9,
           "shard_gb": nbytes(shards) / 1e9,
           "resident_gb": (torch.cuda.memory_allocated() - before) / 1e9}
    del resident
    torch.cuda.empty_cache()
    return out


def base_share(torch, trainer, flux_cfg):
    """(GB of the trainer's base on this rank, whether every leaf holds 1/n
    of the whole leaf, n the product of the sizes of the axes its spec
    names)."""
    import numpy as np

    from mixgrpo_tpu_torch.models.flux import model as M
    from mixgrpo_tpu_torch.parallel.sharding import flatten_specs, flux_param_specs

    meta = M.init_flux(flux_cfg, device="meta", dtype=torch.bfloat16)
    mine, mesh = M.param_leaves(trainer.params), trainer.mesh
    whole, specs = M.param_leaves(meta), flatten_specs(flux_param_specs(meta, mesh))
    cut_ok = all(m.numel() * int(np.prod([mesh.size(a) for a in s if a])) == w.numel()
                 for m, w, s in zip(mine, whole, specs))
    return sum(t.numel() * t.element_size() for t in mine) / 1e9, cut_ok


def file_crc32(path, chunk=1 << 26):
    """zlib's crc32 of a file's bytes, read in chunks."""
    import zlib

    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def lora_run(torch, FA, C, dev, rank, d, tag, mesh_cfg, per_rank, resume):
    """One LoRA iteration of parallel_lora (rank ``LORA_RANK``, the frozen
    bf16 base of ``lora_base``, parallel_train's recipe) on ``mesh_cfg``:
    one prompt per batch rank (``per_rank``) or every prompt, the same
    injected noise in every run; then a checkpoint with the export, and with
    ``resume`` a resume from it and the full-depth base's shards allocated
    (``full_depth_shards``).  Returns the run's record."""
    import gc

    import numpy as np

    from mixgrpo_tpu_torch.models.flux.model import param_leaves

    rec = {}
    n_p = PAR_LORA_PROMPTS
    cfg, flux_cfg, vcfg, vae, GRPOTrainer = _train_setup(
        torch, dev, os.path.join(d, f"run_{tag}"), mesh_cfg,
        PAR_TRAIN_G if per_rank else PAR_TRAIN_G * n_p, "required", TRAIN_DEPTH)
    make = lambda: GRPOTrainer(cfg, flux_cfg=flux_cfg, vae_cfg=vcfg, vae_params=vae,
                               params=lora_base(torch, flux_cfg, dev),
                               reward_fn=brightness_reward, device=dev, use_lora=True,
                               lora_rank=LORA_RANK, lora_alpha=float(LORA_RANK))
    t0 = time.perf_counter()
    trainer = make()
    torch.cuda.synchronize()
    rec["setup_s"] = time.perf_counter() - t0
    rec["base_gb"], rec["base_cut_ok"] = base_share(torch, trainer, flux_cfg)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((n_p, 512, flux_cfg.context_dim), np.float32)
    pooled = rng.standard_normal((n_p, flux_cfg.pooled_dim), np.float32)
    b = trainer.mesh.batch_index
    rows = slice(b, b + 1) if per_rank else slice(0, n_p)
    batch = {"prompt_embed": emb[rows], "pooled": pooled[rows],
             "captions": [f"prompt {i}" for i in range(n_p)][rows]}
    L = trainer.sampler.num_image_tokens
    z0 = torch.randn((n_p * PAR_TRAIN_G, L, flux_cfg.in_channels),
                     generator=torch.Generator(dev).manual_seed(41), device=dev)
    z0 = z0[b * PAR_TRAIN_G:(b + 1) * PAR_TRAIN_G] if per_rank else z0

    def noise_fn(j, i, shape):
        chunk = b if j is None else j  # the one-rank run's chunk of these rows
        gen = torch.Generator(dev).manual_seed(1000 * (chunk + 1) + i)
        return torch.randn(shape, generator=gen, device=dev)

    factors = param_leaves(trainer.lora_factors)
    if trainer.mesh.world == 1:
        np.save(os.path.join(d, "before_lora.npy"), sampled_leaves(factors))
    timesteps = [int(t) for t in trainer.window.get_current_timesteps()]
    reset_launches(FA)
    C.reset_transport()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = trainer.train_one_step(batch, timesteps, z0=z0, noise_fn=noise_fn)
    torch.cuda.synchronize()
    rec["iteration_s"] = time.perf_counter() - t0
    rec["iteration_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["launches"] = {n: f.launches for n, f in FA.KERNEL_WRAPPERS.items()}
    rec["transport"] = C.transport_record()
    rec["metrics"] = {k: float(v) for k, v in m.items() if np.isscalar(v)}
    rec["num_steps"] = int(m["num_steps"])
    if rank == 0:
        np.save(os.path.join(d, f"after_{tag}.npy"), sampled_leaves(factors))
    trainer.global_step = 1
    t0 = time.perf_counter()
    trainer.save_checkpoint()
    rec["checkpoint_s"] = time.perf_counter() - t0
    trainer.close()
    exp = os.path.join(trainer.run_dir, "export_1", "diffusion_pytorch_model.safetensors")
    if rank == 0:
        rec["export_crc32"], rec["export_gb"] = file_crc32(exp), os.path.getsize(exp) / 1e9
    mesh = trainer.mesh
    if resume:
        own = [t.detach().cpu() for t in factors]
        del trainer, factors
        torch.cuda.empty_cache()
        cfg.run.resume_from_checkpoint = True
        tr2 = make()
        rec["resumed_step"] = tr2.global_step
        rec["resumed_factors_equal"] = all(torch.equal(a, b.detach().cpu()) for a, b in
                                           zip(own, param_leaves(tr2.lora_factors)))
        rec["checkpoint_files"] = sorted(os.listdir(os.path.join(tr2.run_dir, "checkpoints",
                                                                 "1")))
        tr2.close()
        del tr2
        torch.cuda.empty_cache()
        rec["full_depth"] = full_depth_shards(torch, mesh, dev)
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()  # the trainers' weights sit in reference cycles
    torch.cuda.empty_cache()
    return rec


def rank_lora(torch, FA, C, dev, rank, world, d, rec, extra):
    """parallel_lora's ranks: ``lora_run`` on mesh (dp 1, fsdp = ranks), one
    prompt per rank, with the resume and the full-depth shards (record
    ``fsdp``), then on (dp 1, tp = ranks), every prompt on every rank
    (record ``tp``)."""
    from mixgrpo_tpu_torch.parallel.mesh import MeshConfig

    rec["fsdp"] = lora_run(torch, FA, C, dev, rank, d, "lora", MeshConfig(dp=1, fsdp=world),
                           per_rank=True, resume=True)
    rec["tp"] = lora_run(torch, FA, C, dev, rank, d, "lora_tp", MeshConfig(dp=1, tp=world),
                         per_rank=False, resume=False)


def parallel_lora_phase(torch, FA, dev, card, root):
    """One LoRA iteration over a sharded frozen base on mesh (dp 1, fsdp =
    ranks of ``parallel_layout``) and on (dp 1, tp = ranks), against one rank
    (this process) on the same global batch and noise: the factors' update,
    grad norm, rewards and the export, byte for byte; each rank's 1/n of
    every sharded leaf; the fsdp run's checkpoint and resume, and each
    rank's resident share of the full-depth base (record ``parallel_lora``)."""
    import gc
    import shutil
    import tempfile

    import numpy as np

    from mixgrpo_tpu_torch.parallel import collectives as C
    from mixgrpo_tpu_torch.parallel.mesh import MeshConfig, backend_for

    world = parallel_layout(torch)
    backend = backend_for(dev, world)
    d = tempfile.mkdtemp(dir=root, prefix=".smoke_parallel_")
    try:
        t0 = time.perf_counter()
        ref = lora_run(torch, FA, C, dev, 0, d, "lora_ref", MeshConfig(1, 1, 1, 1),
                       per_rank=False, resume=False)
        wall = {"one_rank": time.perf_counter() - t0}
        gc.collect()  # the trainer's weights sit in reference cycles
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn_ranks("lora", d, timeout=800, world=world)
        wall["ranks"] = time.perf_counter() - t0
        before = np.load(os.path.join(d, "before_lora.npy"))
        d1 = np.load(os.path.join(d, "after_lora_ref.npy")) - before
        deltas = {c: np.load(os.path.join(d, f"after_{c}.npy")) - before
                  for c in ("lora", "lora_tp")}
    finally:
        shutil.rmtree(d, ignore_errors=True)
    m1 = ref["metrics"]
    blocks = sum(TRAIN_DEPTH)
    bwd = FA.default_bwd(2560, 2560)
    rec = {"phase": "parallel_lora", "backend": backend, "depth": TRAIN_DEPTH,
           "lora_rank": LORA_RANK, "num_generations": PAR_TRAIN_G,
           "prompts": PAR_LORA_PROMPTS, "one_rank": {k: ref[k] for k in (
               "iteration_s", "iteration_peak_gb", "launches", "base_gb", "export_gb")},
           "grad_norm_one_rank": m1["grad_norm"], "update_max_abs": float(np.abs(d1).max()),
           "sampled_entries": int(d1.size), "wall_s": wall,
           "limits": {"update_rel_l2": PAR_UPDATE_REL_L2, "grad_norm_rel": PAR_GRAD_NORM_REL},
           "note": layout_note(world, backend), "device": card}
    ok = bool(np.isfinite(d1).all()) and np.abs(d1).max() > 0
    ok &= all(r["backend"] == backend for r in ranks)
    for case, key, mesh in (("lora", "fsdp", {"dp": 1, "fsdp": world}),
                            ("lora_tp", "tp", {"dp": 1, "tp": world})):
        runs = [r[key] for r in ranks]
        m2 = runs[0]["metrics"]
        d2 = deltas[case]
        # per rank: its rows' rollout chunks, the update group's forward and recompute
        n_chunks = 1 if key == "fsdp" else PAR_LORA_PROMPTS
        want = {"flash_attn_fwd": ref["num_steps"] * blocks * n_chunks,
                "flash_attn_fwd_lse": 2 * blocks,
                "flash_attn_bwd_fused": blocks if bwd == "fused" else 0,
                "flash_attn_bwd_dkv": blocks if bwd == "split" else 0,
                "flash_attn_bwd_dq": blocks if bwd == "split" else 0}
        r = {"mesh": mesh, "update_rel_l2": float(np.linalg.norm(d2 - d1) / np.linalg.norm(d1)),
             "update_max_abs_diff": float(np.abs(d2 - d1).max()),
             "grad_norm": m2["grad_norm"],
             "grad_norm_rel": abs(m2["grad_norm"] - m1["grad_norm"]) / m1["grad_norm"],
             "loss": [m1["loss"], m2["loss"]], "reward": [m1["reward"], m2["reward"]],
             "export_equal": runs[0]["export_crc32"] == ref["export_crc32"],
             "base_gb_per_rank": [x["base_gb"] for x in runs],
             "iteration_s_per_rank": [x["iteration_s"] for x in runs],
             "peak_gb_per_rank": [x["peak_gb"] for x in runs],
             "launches_per_rank": [x["launches"] for x in runs], "expected_launches": want,
             "transport_per_rank": [x["transport"] for x in runs]}
        ok &= (all(x["launches"] == want for x in runs)
               and r["update_rel_l2"] < PAR_UPDATE_REL_L2
               and r["grad_norm_rel"] < PAR_GRAD_NORM_REL
               and abs(m2["reward"] - m1["reward"]) < 1e-6 and r["export_equal"]
               and all(x["base_cut_ok"] for x in runs)
               and (sum(r["peak_gb_per_rank"]) if backend == "gloo"
                    else max(r["peak_gb_per_rank"])) < 80)
        if key == "fsdp":
            r["resumed"] = [(x["resumed_step"], x["resumed_factors_equal"]) for x in runs]
            r["checkpoint_files"] = runs[0]["checkpoint_files"]
            r["full_depth_per_rank"] = [x["full_depth"] for x in runs]
            ok &= all(x["resumed_step"] == 1 and x["resumed_factors_equal"] for x in runs)
            ok &= r["checkpoint_files"] == ["manifest.json"] + [
                f"shard{i}of{world}.pt" for i in range(world)]
            for fd in r["full_depth_per_rank"]:
                ok &= fd["params"] == 11901408320 and fd["resident_gb"] < 0.55 * fd["whole_gb"]
        rec[case] = r
    emit(rec)
    if not ok:
        raise AssertionError(f"parallel_lora failed its checks: {rec}")
    return rec


PHASES = ("build", "kernels", "serve", "checkpoints", "rewards", "train_main", "train",
          "update_full_depth", "train_flash_lora", "hunyuan_video", "mochi_video",
          "parallel_attention", "parallel_train", "parallel_cli", "parallel_tp", "video_sp",
          "parallel_lora")
TRAIN_DEPTH = (2, 4)
# parallel_train's and parallel_tp's blocks: cut from TRAIN_DEPTH to keep the
# whole script inside its time limit once video_sp and parallel_lora came in
PAR_DEPTH = (1, 2)
FULL_DEPTH = (19, 38)
# train_flash_lora's blocks: cut from FULL_DEPTH (as PAR_DEPTH is cut) to keep
# the whole script inside its time limit once video_sp and parallel_lora came in
FLASH_LORA_DEPTH = (10, 19)


def main() -> int:
    import argparse

    if sys.argv[1:2] == ["--rank"]:
        return rank_main(sys.argv[2:])

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES} (default: all; the final "
                         "kernels and status lines need all)")
    only = set(ap.parse_args().only.split(","))
    if not only <= set(PHASES):
        ap.error(f"unknown phase in {sorted(only)}")
    if "train_main" in only and "rewards" not in only:
        ap.error("train_main runs on the rewards phase's files: add rewards to --only")
    if "parallel_cli" in only and not {"checkpoints", "rewards"} <= only:
        ap.error("parallel_cli runs on the checkpoints and rewards phases' files: add them")
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this runs on a CUDA card",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import torch.nn.functional as F

    from mixgrpo_tpu_torch.models.flux import model as M
    from mixgrpo_tpu_torch.ops import build
    from mixgrpo_tpu_torch.ops import flash_attention as FA
    from mixgrpo_tpu_torch.ops import qk_rope as QR

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi()
    kind = torch.cuda.get_device_name(0)
    from mixgrpo_tpu_torch.utils.env import collect_env

    emit({"phase": "device", "nvidia_smi": card, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "env": collect_env()})

    # -- build: one nvcc per source, all started together ------------------------
    t0 = time.perf_counter()
    names = (FA.KERNEL, FA.BWD_KERNEL, QR.KERNEL)
    with ThreadPoolExecutor(len(names)) as ex:
        list(ex.map(build.load, names))
    for name in names:
        report = build.reports.get(name, "")
        emit({"phase": "build", "library": name, "source": f"mixgrpo_tpu_torch/csrc/{name}.cu",
              "seconds_all": time.perf_counter() - t0,
              "ptxas": [ln.strip() for ln in report.splitlines()
                        if any(w in ln for w in PTXAS_KEEP)]})
    for kernel, lib in (("flash_attn_fwd", FA.KERNEL), ("flash_attn_bwd_fused", FA.BWD_KERNEL),
                        ("flash_attn_bwd_dkv", FA.BWD_KERNEL),
                        ("flash_attn_bwd_dq", FA.BWD_KERNEL)):
        smem = getattr(build.load(lib), f"{kernel}_smem_bytes")
        smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
        emit({"phase": "kernel_resources", "kernel": kernel,
              "smem_bytes_per_block": {D: smem(D) for D in (32, 64, 128)}})
    rows = {}

    if "kernels" in only:
        check_ptxas(build.reports.get(FA.KERNEL, ""), "flash_fwd_kernelILi128E")
        # flash_bwd_kernel<128, false> is dkv, <128, true> fused
        for kernel in ("flash_bwd_kernelILi128ELb0E", "flash_bwd_kernelILi128ELb1E",
                       "flash_bwd_dq_kernelILi128E"):
            check_ptxas(build.reports.get(FA.BWD_KERNEL, ""), kernel)
        timed_phase("kernels", kernel_phase, torch, FA, F, dev, card, rows)
    if "serve" in only:
        timed_phase("serve", serve_phase, torch, FA, F, M, dev, card, rows)
    import shutil

    kept = []  # the directories parallel_cli reads, removed at the end
    try:
        ckpt = paths = None
        if "checkpoints" in only:
            ckpt = timed_phase("checkpoints", lambda: checkpoints_phase(
                torch, FA, M, dev, card, root, keep="parallel_cli" in only))
            kept.append(ckpt["root"])
        if "rewards" in only:
            try:
                paths = timed_phase("rewards", rewards_phase, torch, FA, dev, card, root)
                if "train_main" in only:
                    timed_phase("train_main", train_main_phase, torch, FA, M, dev, card, root,
                                paths)
            finally:  # cleanup only; failures propagate
                shutil.rmtree(os.path.join(root, ".smoke_train_main"), ignore_errors=True)
                kept.append(os.path.join(root, ".smoke_rewards"))
            torch.cuda.empty_cache()
        run_later_phases(torch, FA, M, dev, card, root, only, rows, ckpt, paths)
    finally:  # cleanup only; failures propagate
        for d in kept:
            shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    if only != set(PHASES):
        print(f"chip_smoke: ran only {sorted(only)}; no result", file=sys.stderr)
        return 4
    return final_lines(torch, FA, rows, card, kind)


def timed_phase(name, fn, *args):
    """``fn(*args)``, followed by a ``phase_time`` record of its wall seconds
    (also when it raises); then the phase's garbage is collected, so that
    objects it left in reference cycles (a trainer and its weights) do not
    hold device memory into the next phase."""
    import gc

    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        emit({"phase": "phase_time", "name": name, "seconds": time.perf_counter() - t0})
        gc.collect()


def run_later_phases(torch, FA, M, dev, card, root, only, rows, ckpt, paths):
    """The phases after the reward zoo, in order; the multi-rank phases last."""
    if "train" in only:
        launches = timed_phase("train", train_phase, torch, FA, M, dev, card, root)
        for n in ("flash_attn_fwd_lse", "flash_attn_bwd_fused"):
            rows.setdefault(n, {})["launches"] = launches[n]
        torch.cuda.empty_cache()
    if "update_full_depth" in only:
        full = timed_phase("update_full_depth", update_full_depth_phase, torch, FA, M, dev,
                           card)
        for n in ("flash_attn_bwd_dkv", "flash_attn_bwd_dq"):
            rows.setdefault(n, {})["launches"] = full[1024]["launches"][n]
        torch.cuda.empty_cache()
    if "train_flash_lora" in only:
        lora = timed_phase("train_flash_lora", train_flash_lora_phase, torch, FA, M, dev, card,
                           root)
        for n in ("qk_rope_fwd", "qk_rope_bwd"):
            rows.setdefault(n, {})["launches"] = lora[n]
        torch.cuda.empty_cache()
    if "hunyuan_video" in only:
        timed_phase("hunyuan_video", hunyuan_video_phase, torch, FA, dev, card, root, rows)
        torch.cuda.empty_cache()
    if "mochi_video" in only:
        mochi = timed_phase("mochi_video", mochi_video_phase, torch, FA, dev, card, root, rows)
        for name, n in mochi.items():
            rows.setdefault(name, {})["mochi_launches"] = n
        torch.cuda.empty_cache()
    if "parallel_attention" in only:
        timed_phase("parallel_attention", parallel_attention_phase, torch, FA, dev, card, root)
    if "parallel_train" in only:
        timed_phase("parallel_train", parallel_train_phase, torch, FA, dev, card, root)
    if "parallel_cli" in only:
        timed_phase("parallel_cli", parallel_cli_phase, torch, FA, dev, card, root, ckpt,
                    paths)
    if "parallel_tp" in only:
        timed_phase("parallel_tp", parallel_tp_phase, torch, FA, dev, card, root)
    if "video_sp" in only:
        grad = timed_phase("video_sp", video_sp_phase, torch, FA, dev, card, root)
        for name, n in grad.items():
            rows.setdefault(name, {})["hunyuan_gradient_launches"] = n
        torch.cuda.empty_cache()
    if "parallel_lora" in only:
        timed_phase("parallel_lora", parallel_lora_phase, torch, FA, dev, card, root)


def final_lines(torch, FA, rows, card, kind):
    """The kernels line, the ``nvidia-smi`` line and the status line."""
    sources = {FA.KERNEL: "mixgrpo_tpu_torch/csrc/flash_attn_fwd.cu",
               FA.BWD_KERNEL: "mixgrpo_tpu_torch/csrc/flash_attn_bwd.cu"}
    replaces = {"flash_attn_fwd": "mixgrpo_tpu/ops/flash_attention.py:61",
                "flash_attn_fwd_lse": "mixgrpo_tpu/ops/flash_attention.py:61",
                "flash_attn_bwd_fused": "mixgrpo_tpu/ops/flash_attention.py:186",
                "flash_attn_bwd_dkv": "mixgrpo_tpu/ops/flash_attention.py:123",
                "flash_attn_bwd_dq": "mixgrpo_tpu/ops/flash_attention.py:257"}
    from mixgrpo_tpu_torch.ops import qk_rope as QR

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name in FA.KERNEL_WRAPPERS:
        row = rows[name]
        if not row.get("launches"):
            raise AssertionError(f"{name} was not launched on its path")
        kernels.append({"name": name, "route": "cuda",
                        "source": sources[FA.KERNEL if name.startswith("flash_attn_fwd")
                                          else FA.BWD_KERNEL],
                        "replaces": replaces[name], **{k: row[k] for k in keys},
                        "mochi_launches": row.get("mochi_launches"),
                        "hunyuan_gradient_launches": row.get("hunyuan_gradient_launches")})
    for name in QR.KERNEL_WRAPPERS:  # per train_flash_lora iteration pair
        row = rows[name]
        if not row.get("launches"):
            raise AssertionError(f"{name} was not launched on its path")
        kernels.append({"name": name, "route": "cuda",
                        "source": "mixgrpo_tpu_torch/csrc/qk_rope.cu",
                        "replaces": "none: XLA fused the QK-norm, RoPE and joint concatenation",
                        **{k: row[k] for k in keys}, "shapes": row["shapes"]})
    emit({"kernels": kernels})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
