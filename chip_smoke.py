#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mixgrpo_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Every phase prints one JSON record; a failing phase ends the run with a
non-zero exit code.  Phases:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every hand-written kernel compiled from ``mixgrpo_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
3. kernels: each kernel against its plain PyTorch version on the card, at
   small ragged shapes and at the FLUX shapes of the serving path, with its
   time, the plain version's time, the card's bound for the same work and
   one PyTorch library call's time as a yardstick (never used by the port);
4. reference: the model path through the kernel against the plain
   attention path on small inputs (tiny config, and full width at 256px);
5. serve: FLUX.1-dev at full width and depth with random bf16 weights from
   fixed seeds (base, tuned, VAE), ``DualFluxPipeline`` at 1024x1024 with 4
   steps (2 tuned + 2 base; the recipe runs 50) behind ``RequestBatcher``
   (batch 2, latency tier on) and ``InferenceServer`` on 127.0.0.1 with a
   crc32-seeded stand-in for the text encoders; three POSTs (two together,
   one alone), then one direct 720x720 call (S = 2537 padded to 2560, the
   kernel's kv_valid path).  The kernel's launch count is reset just before
   each of the two paths and read just after it, and must equal 57 x that
   path's DiT calls; the ``kernels`` line reports the serve path's count;
6. profile: where one full-depth forward's device time goes (B=2, 1024px);
7. the ``kernels`` line, the ``nvidia-smi`` line, and the final status line.

Exits 2 without a CUDA card; without the package beside it the import fails.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
import zlib

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


def check_launches(FA, path, launches, per_call, dit_calls):
    """One path's kernel launches, counted from 0 just before it ran, must be
    one per DiT block per DiT call."""
    emit({"phase": "launch_count", "path": path, "kernel": FA.KERNEL,
          "launches": launches, "dit_calls": dit_calls, "expected": per_call * dit_calls})
    if launches != per_call * dit_calls:
        raise AssertionError(f"{path}: {launches} launches != {per_call} x {dit_calls} "
                             "DiT calls")


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


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this runs on a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch.nn.functional as F
    from PIL import Image

    from mixgrpo_tpu_torch.models.flux import model as M
    from mixgrpo_tpu_torch.models.flux.rope import make_image_ids, make_text_ids, rope_tables
    from mixgrpo_tpu_torch.models.flux.vae import VAEConfig, init_vae_decoder
    from mixgrpo_tpu_torch.ops import build
    from mixgrpo_tpu_torch.ops import flash_attention as FA
    from mixgrpo_tpu_torch.sample import DualFluxPipeline
    from mixgrpo_tpu_torch.serve import InferenceServer, RequestBatcher, make_generate_fn

    dev = torch.device("cuda")
    card = smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": card, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # -- build -----------------------------------------------------------------
    t0 = time.perf_counter()
    build.load(FA.KERNEL)
    emit({"phase": "build", "kernel": FA.KERNEL, "seconds": time.perf_counter() - t0})

    # -- kernels against their plain versions ------------------------------------
    for D in (32, 64, 128):
        check_attention(torch, FA, F, dev, 1, 2, 100, 77, D)
        check_attention(torch, FA, F, dev, 2, 3, 130, 201, D, layout="bshd")
        check_attention(torch, FA, F, dev, 1, 2, 130, 200, D, mask=True)
        check_attention(torch, FA, F, dev, 1, 2, 129, 150, D, kv_valid=101)
        check_attention(torch, FA, F, dev, 2, 2, 97, 97, D, layout="bshd", kv_valid=64)
    full = []
    for B in (1, 2):
        for S, kv_valid in ((1536, None), (2560, 2537), (4608, None)):
            full.append(check_attention(torch, FA, F, dev, B, 24, S, S, 128,
                                        kv_valid=kv_valid, timed=True))
    full.append(check_attention(torch, FA, F, dev, 2, 24, 4608, 4608, 128,
                                layout="bshd", timed=True))
    main_shape = next(r for r in full if r["B"] == 2 and r["S"] == 4608
                      and r["layout"] == "bhsd")

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

    FA.flash_attn_fwd.launches = 0
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
    FA.flash_attn_fwd.launches = 0
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
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9})
    emit({"kernels": [{
        "name": FA.KERNEL, "route": "cuda",
        "source": "mixgrpo_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "mixgrpo_tpu/ops/flash_attention.py:61",
        "launches": serve_launches,
        "max_abs_err": max(r["max_abs_err"] for r in full),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
    }]})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
