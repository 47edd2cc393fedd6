#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mixgrpo_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``
(``--only PHASES`` runs a comma-separated subset and then exits 4 with no
result).  Every phase prints JSON records; a failing phase ends the run with
a non-zero exit code.  Phases:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every hand-written kernel library compiled from
   ``mixgrpo_tpu_torch/csrc`` (one ``nvcc`` per source, all started
   together), with ptxas's register and spill report;
3. kernels: ptxas's report of the D = 128 forward, dkv and fused kernels
   (no spill, no wgmma serialisation); each kernel against its plain PyTorch
   version on the card, at small ragged shapes, at the tile edges of the
   forward, dkv and fused, and at the shapes of the main paths (the forward
   without lse at the serving shape, the forward with lse and the fused
   backward at the 720px update, where the split pair is timed too, dkv
   and dq at the 1024px update), with its time, the plain version's time,
   the card's bound for the same work and one PyTorch library call's time
   as a yardstick (never used by the port); dkv and fused launched twice
   must give identical dk and dv (fused's dq, summed in an order that
   changes from run to run, within ``close_bf16``); then autograd through
   the kernels;
4. serve: the first slice's path at full FLUX.1-dev width and depth with
   random bf16 weights (``DualFluxPipeline`` at 1024x1024, 4 steps, behind
   ``RequestBatcher`` and ``InferenceServer``; then one 720px call), the
   model path through the kernel against eager attention, and the profile of
   one forward;
5. train: two recipe GRPO iterations through ``GRPOTrainer.train_one_step``
   at full width, depth cut to 2 double + 4 single blocks (fp32 master
   weights, grads and AdamW moments), the full random VAE decoder and a
   synthetic brightness reward;
6. update_full_depth: one ``update_step`` at ``virtual_depth=(19, 38)`` over a
   1 + 2 block stack, at 720px (12 pairs, fused backward) and 1024px (2
   pairs, split backward).
Each path's kernel launches are counted from 0 just before it runs and read
just after, and must equal the prediction exactly.  Last come the
``kernels`` line, the ``nvidia-smi`` line, and the final status line.

Exits 2 without a CUDA card; without the package beside it the import fails.
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
                    kv_valid=None, timed=False, seed=0):
    """Kernel vs plain version on one shape, bf16; raises on disagreement.

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
    m = None
    if mask:
        m = torch.rand((B, Sk), generator=g, device=dev) > 0.3
        m[:, 0] = True
    got = FA.flash_attention(q, k, v, mask=m, layout=layout, kv_valid=kv_valid)
    torch.cuda.synchronize()
    want = FA.flash_attention_reference(q, k, v, mask=m, layout=layout, kv_valid=kv_valid)
    kv_len = kv_valid or Sk
    diff = got.float() - want.float()
    err = diff.abs().max().item()
    rel = (diff.norm() / want.float().norm()).item()
    atol = 0.15 / kv_len ** 0.5
    ok = bool(torch.isfinite(got).all()) and rel <= 5e-3 and bool(
        (diff.abs() <= atol + 1e-2 * want.float().abs()).all())
    rec = {"phase": "kernel_check", "kernel": FA.KERNEL, "B": B, "H": H, "S": S,
           "Sk": Sk, "D": D, "layout": layout, "mask": mask, "kv_valid": kv_valid,
           "dtype": "bfloat16", "max_abs_err": err, "atol": atol, "rel_l2": rel,
           "ok": ok}
    if timed:
        qs = FA._scaled_q(q)
        kbias = None if m is None else FA._key_bias(m, B, Sk)
        rec["ms"] = time_ms(torch, lambda: FA.flash_attn_fwd(
            qs, k, v, kbias=kbias, kv_len=kv_len, layout=layout), 20)
        rec["plain_ms"] = time_ms(torch, lambda: FA.flash_attention_reference(
            q, k, v, mask=m, layout=layout, kv_valid=kv_valid), 3, warmup=1)
        rec["bound_ms"], rec["bound_by"] = attention_bound_ms(
            B, H, S, Sk, kv_len, D, m is not None)
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
    ex2.approx); dq, dk, dv by ``close_bf16``.  dkv and fused write dk and
    dv with no atomics, so a second launch on the same inputs must give
    identical dk and dv (``repeat_identical``); fused's second dq, whose
    key blocks add in another order, must be within ``close_bf16`` of its
    first.  ``timed`` names the kernels to time at this shape;
    ``backward=()`` checks the forward with lse alone."""
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
    repeats = {name: launch[name]() for name in ("flash_attn_bwd_fused", "flash_attn_bwd_dkv")
               if name in got}
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
        rec["repeat_identical"] = all(torch.equal(x, y)
                                      for x, y in zip(got[name][1:], again[1:]))
        rec["ok"] &= rec["repeat_identical"]
        if again[0] is not None:
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


def check_launches(FA, path, launches, per_call, dit_calls):
    """One path's kernel launches, counted from 0 just before it ran, must be
    one forward without lse per DiT block per DiT call, and nothing else: the
    sampling paths take no gradient."""
    others = {n: f.launches for n, f in FA.KERNEL_WRAPPERS.items() if n != "flash_attn_fwd"}
    emit({"phase": "launch_count", "path": path, "kernel": FA.KERNEL,
          "launches": launches, "dit_calls": dit_calls, "expected": per_call * dit_calls,
          "other_kernels": others})
    if launches != per_call * dit_calls or any(others.values()):
        raise AssertionError(f"{path}: {launches} launches != {per_call} x {dit_calls} "
                             f"DiT calls, or other kernels launched: {others}")


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


def profile_forward(torch, M, params, cfg, dev, card):
    """Where one DiT forward's device time goes at the serving shape (B=2,
    1024px: S = 512 + 4096): torch.profiler kernel times summed by class,
    and the device's idle share of the profiled wall time.  Runs after the
    launch count is read, so its launches are not counted."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

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
        torch.cuda.synchronize()

    fwd()
    t0 = time.perf_counter()
    fwd()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and str(e.device_type).endswith("CUDA"):
            kernels.append((e.key, us / 1e3, e.count))
    classes = {"flash_attn_fwd": 0.0, "gemm": 0.0, "other": 0.0}
    for name, ms, _ in kernels:
        low = name.lower()
        if "flash_fwd_kernel" in low:
            classes["flash_attn_fwd"] += ms
        elif any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "cublas")):
            classes["gemm"] += ms
        else:
            classes["other"] += ms
    busy = sum(classes.values())
    kernels.sort(key=lambda k: -k[1])
    emit({"phase": "profile", "what": "one flux_dev forward, B=2, 1024px, bf16",
          "wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms,
          "device_busy_ms": busy or None,
          "idle_share": (1 - busy / prof_wall_ms) if busy else None,
          "class_ms": classes if busy else None,
          "top_kernels": [{"name": n[:90], "ms": ms, "count": c}
                          for n, ms, c in kernels[:10]],
          "device": card})


def kernel_phase(torch, FA, F, dev, rows):
    """Every kernel against its plain version: small ragged shapes (D 32, 64,
    128; both layouts; a key mask; kv_valid; S != Sk) and the tile edges of
    the forward (with and without lse) and of dkv and fused, then the shapes
    of the main paths, timed: the forward without lse at the serving shape
    (B=2, S=4608), the forward with lse, the fused backward and, to compare
    with it, the split pair (dkv, dq) at the 720px update (B=12, S=2560,
    kv_valid 2537), dkv and dq at the 1024px update (B=2, S=4608); then
    autograd through the kernels on the card."""
    for D in (32, 64, 128):
        for kw in (dict(B=1, H=2, S=100, Sk=77), dict(B=2, H=3, S=130, Sk=201, layout="bshd"),
                   dict(B=1, H=2, S=130, Sk=200, mask=True),
                   dict(B=1, H=2, S=129, Sk=150, kv_valid=101),
                   dict(B=2, H=2, S=97, Sk=97, layout="bshd", kv_valid=64)):
            kw = dict(kw)
            B, H, S, Sk = (kw.pop(n) for n in ("B", "H", "S", "Sk"))
            check_attention(torch, FA, F, dev, B, H, S, Sk, D, **kw)
            check_training_kernels(torch, FA, F, dev, B, H, S, Sk, D, **kw)
        # the tile edges of the forward (128-row q tiles, 128-key tiles) and
        # of dkv and fused (128-key blocks, 64-row q tiles): one query row,
        # one key, fewer keys than a tile, kv_valid one key into a tile (129),
        # S not a multiple of the q tile (fused: dq rows past S never
        # written), key blocks wholly past kv_valid (zeros out)
        for kw in (dict(B=1, H=2, S=1, Sk=77), dict(B=1, H=1, S=1, Sk=1),
                   dict(B=2, H=2, S=65, Sk=40, layout="bshd"),
                   dict(B=2, H=2, S=65, Sk=40, mask=True),
                   dict(B=1, H=2, S=70, Sk=200, kv_valid=129),
                   dict(B=2, H=3, S=191, Sk=130, layout="bshd", kv_valid=65),
                   dict(B=1, H=2, S=100, Sk=300, mask=True),
                   dict(B=2, H=2, S=129, Sk=300, kv_valid=100)):
            kw = dict(kw)
            B, H, S, Sk = (kw.pop(n) for n in ("B", "H", "S", "Sk"))
            check_attention(torch, FA, F, dev, B, H, S, Sk, D, **kw)
            check_training_kernels(torch, FA, F, dev, B, H, S, Sk, D,
                                   backward=("flash_attn_bwd_fused", "flash_attn_bwd_dkv"),
                                   **kw)
    full = []
    for B in (1, 2):
        for S, kv_valid in ((1536, None), (2560, 2537), (4608, None)):
            full.append(check_attention(torch, FA, F, dev, B, 24, S, S, 128,
                                        kv_valid=kv_valid, timed=True))
    full.append(check_attention(torch, FA, F, dev, 2, 24, 4608, 4608, 128,
                                layout="bshd", timed=True))
    main_shape = next(r for r in full if r["B"] == 2 and r["S"] == 4608
                      and r["layout"] == "bhsd")
    rows["flash_attn_fwd"] = dict(main_shape, max_abs_err=max(r["max_abs_err"] for r in full))
    t720 = check_training_kernels(torch, FA, F, dev, 12, 24, 2560, 2560, 128, kv_valid=2537,
                                  timed=("flash_attn_fwd_lse", *BWD_KERNELS), cb=2)
    split = t720["flash_attn_bwd_dkv"]["ms"] + t720["flash_attn_bwd_dq"]["ms"]
    emit({"phase": "fused_vs_split", "B": 12, "H": 24, "S": 2560, "kv_valid": 2537, "D": 128,
          "fused_ms": t720["flash_attn_bwd_fused"]["ms"],
          "dkv_ms": t720["flash_attn_bwd_dkv"]["ms"], "dq_ms": t720["flash_attn_bwd_dq"]["ms"],
          "split_ms": split, "default_bwd": FA.default_bwd(2560, 2560)})
    t1024 = check_training_kernels(torch, FA, F, dev, 2, 24, 4608, 4608, 128,
                                   timed=("flash_attn_bwd_dkv", "flash_attn_bwd_dq"), cb=1)
    # each kernel's row is at its main path's shape: dkv and dq at 1024px
    for name, rec in (*t720.items(), *t1024.items()):
        if "ms" in rec:
            rows[name] = dict(rec)
    for bwd in ("fused", "split"):
        for layout in ("bhsd", "bshd"):
            check_autograd(torch, FA, dev, bwd, layout)


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

    FA.reset_launches()
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

    # 720px: S = 512 + 45*45 = 2537, padded to 2560 with kv_valid = 2537
    pipe720 = DualFluxPipeline(cfg, base, tuned, height=720, width=720, num_steps=2,
                               mix_sampling_steps=1, dtype=torch.bfloat16, device=dev)
    txt, pooled = encode(["a mountain lake"])
    FA.reset_launches()
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
    del base, tuned, vae, pipe, pipe720, gen, v_flash, v_eager
    torch.cuda.empty_cache()


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
            FA.reset_launches()
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
        FA.reset_launches()
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


PHASES = ("build", "kernels", "serve", "train", "update_full_depth")
TRAIN_DEPTH = (2, 4)
FULL_DEPTH = (19, 38)


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES} (default: all; the final "
                         "kernels and status lines need all)")
    only = set(ap.parse_args().only.split(","))
    if not only <= set(PHASES):
        ap.error(f"unknown phase in {sorted(only)}")
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": card, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # -- build: one nvcc per source, all started together ------------------------
    t0 = time.perf_counter()
    names = (FA.KERNEL, FA.BWD_KERNEL)
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
        for kernel in ("flash_bwd_kernelILi128ELb0E", "flash_bwd_kernelILi128ELb1E"):
            check_ptxas(build.reports.get(FA.BWD_KERNEL, ""), kernel)
        kernel_phase(torch, FA, F, dev, rows)
    if "serve" in only:
        serve_phase(torch, FA, F, M, dev, card, rows)
    if "train" in only:
        launches = train_phase(torch, FA, M, dev, card, root)
        for n in ("flash_attn_fwd_lse", "flash_attn_bwd_fused"):
            rows.setdefault(n, {})["launches"] = launches[n]
        torch.cuda.empty_cache()
    if "update_full_depth" in only:
        full = update_full_depth_phase(torch, FA, M, dev, card)
        for n in ("flash_attn_bwd_dkv", "flash_attn_bwd_dq"):
            rows.setdefault(n, {})["launches"] = full[1024]["launches"][n]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    if only != set(PHASES):
        print(f"chip_smoke: ran only {sorted(only)}; no result", file=sys.stderr)
        return 4
    sources = {FA.KERNEL: "mixgrpo_tpu_torch/csrc/flash_attn_fwd.cu",
               FA.BWD_KERNEL: "mixgrpo_tpu_torch/csrc/flash_attn_bwd.cu"}
    replaces = {"flash_attn_fwd": "mixgrpo_tpu/ops/flash_attention.py:61",
                "flash_attn_fwd_lse": "mixgrpo_tpu/ops/flash_attention.py:61",
                "flash_attn_bwd_fused": "mixgrpo_tpu/ops/flash_attention.py:186",
                "flash_attn_bwd_dkv": "mixgrpo_tpu/ops/flash_attention.py:123",
                "flash_attn_bwd_dq": "mixgrpo_tpu/ops/flash_attention.py:257"}
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name in FA.KERNEL_WRAPPERS:
        row = rows[name]
        if not row.get("launches"):
            raise AssertionError(f"{name} was not launched on its path")
        kernels.append({"name": name, "route": "cuda",
                        "source": sources[FA.KERNEL if name.startswith("flash_attn_fwd")
                                          else FA.BWD_KERNEL],
                        "replaces": replaces[name], **{k: row[k] for k in keys}})
    emit({"kernels": kernels})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
