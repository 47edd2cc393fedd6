"""The video as a unit of work: HunyuanVideo text-to-video through the
program's ``HunyuanVideoPipeline``.

Each video has inputs of its own, drawn from the seed and its index: LLM
text states with a text mask (the first ``text_tokens`` of
``text_len`` keys valid), a pooled CLIP vector and the initial noise.  The
weights (the DiT and the causal VAE decoder) are made from the seed on the
device.  Set-up runs the first video through the same call as the window.
Of that video and of the last one the run makes (the window's last, or the
traced one) the kind keeps the denoising trajectory (every latent of the
Euler loop, from the pipeline's own call of ``run_rollout``), the frames,
and at the checked steps the state that enters each stage of the DiT call
(the embedders' output, each block's input, the last block's output, the
velocity).  Of the window's videos it only holds on to the program's own
tensors, and copies the last one's once the window has closed.  The
pipeline instance's denoise and decode are wrapped in synchronised timers
from this file: the spans ``denoise_s.video`` and ``decode_s.video`` read.
Once the pipeline is freed, ``check`` has the references follow both videos
stage by stage from the program's own state, and decode their final
latents in tiles.

The checked steps are ``check_steps`` draws from the seed: all but one of
the first video's, one of the last's (each step's state is 1.6 GB).  The
reference pads the joint sequence as the program does, scales q in bf16
before the scores as the attention kernel takes it, and rounds the token
refiner's probabilities to bf16 as the program's eager attention there.

Faults for the control and the fault tests: ``int8`` is the control: the
DiT's block matmuls on the program's int8 path, and the reference decode
in fp8 (the program has no decode below bf16) put in the program's
place; ``frozen`` makes the first checked Euler step return its state
unchanged; ``altered`` darkens one decoded frame.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from benchlib import flops as F
from benchlib.seeds import derive
from benchlib.weights import materialize
from reference import grpo as ref_grpo
from reference import hunyuan as ref_dit
from reference import vae3d as ref_vae


def dit_dims(config: dict) -> dict:
    """The configuration file's keys in the names of the program's
    ``HunyuanVideoConfig`` and of the FLOP counts."""
    keys = ("in_channels", "hidden_size", "rope_theta", "text_states_dim",
            "text_states_dim_2", "guidance_embed")
    d = {k: config[k] for k in keys}
    d.update(num_heads=config["heads_num"], mlp_ratio=float(config["mlp_width_ratio"]),
             time_freq_dim=config["assumed"]["time_freq_dim"],
             depth_double=config["mm_double_blocks_depth"],
             depth_single=config["mm_single_blocks_depth"],
             refiner_depth=config["refiner_depth"],
             rope_dim_list=tuple(config["rope_dim_list"]),
             patch_size=tuple(config["patch_size"]))
    return d


class Run:
    def __init__(self, cell, seed: int, device, faults=()):
        self.config, self.traffic = cell.config, cell.traffic
        self.seed, self.device, self.faults = int(seed), torch.device(device), set(faults)
        self.dtype = getattr(torch, self.config["dtype"])
        self.dims = dit_dims(self.config)
        t = self.traffic
        self.lat_shape = (1, (t["frames"] - 1) // 4 + 1, t["height"] // 8, t["width"] // 8,
                          self.dims["in_channels"])
        self.sigmas = ref_grpo.sd3_shift(np.linspace(1.0, 0.0, t["steps"] + 1), t["shift"]
                                         ).astype(np.float32)
        self.index = 0
        self.cap = {}

    def inputs(self, k):
        """(text states, pooled, text mask, z0) of video ``k``."""
        t, d, dev = self.traffic, self.dims, self.device
        g = torch.Generator(dev).manual_seed(derive(self.seed, 1, k))
        txt = torch.randn((1, t["text_len"], d["text_states_dim"]), generator=g, device=dev)
        pooled = torch.randn((1, d["text_states_dim_2"]), generator=g, device=dev)
        z0 = torch.randn(self.lat_shape, generator=g, device=dev)
        mask = torch.zeros((1, t["text_len"]), dtype=torch.int32, device=dev)
        mask[:, : t["text_tokens"]] = 1
        return txt, pooled, mask, z0

    def setup(self):
        from mixgrpo_tpu_torch.models.hunyuan import pipeline as P
        from mixgrpo_tpu_torch.models.hunyuan.model import HunyuanVideoConfig, init_hunyuan_video
        from mixgrpo_tpu_torch.models.hunyuan.vae3d import (
            CausalVAEConfig, init_causal_vae_decoder,
        )
        from mixgrpo_tpu_torch.ops.quant import quantize_flux_params

        t, dev = self.traffic, self.device
        self.dit_cfg = HunyuanVideoConfig(**self.dims)
        v = self.config["vae"]
        self.vae_cfg = CausalVAEConfig(**{k: (tuple(x) if isinstance(x, list) else x)
                                          for k, x in v.items() if not k.startswith("_")})
        g = torch.Generator(dev).manual_seed(derive(self.seed, 0))
        kw = dict(device=dev, dtype=self.dtype)
        self.dit = materialize(init_hunyuan_video(self.dit_cfg, device="meta", dtype=self.dtype),
                               g, **kw)
        self.vae = materialize(init_causal_vae_decoder(self.vae_cfg, device="meta",
                                                       dtype=self.dtype), g, **kw)
        params = quantize_flux_params(self.dit) if "int8" in self.faults else self.dit
        self.pipe = pipe = P.HunyuanVideoPipeline(
            self.dit_cfg, params, vae_cfg=self.vae_cfg, vae_params=self.vae,
            num_steps=t["steps"], shift=t["shift"], guidance_scale=t["guidance_scale"],
            dtype=self.dtype, device=dev)
        self.spans = {"denoise_time": 0.0, "decode_time": 0.0}
        for key, name in (("denoise_time", "_sample"), ("decode_time", "_decode")):
            setattr(pipe, name, self._timed(key, getattr(pipe, name)))
        self._plant(P)
        self._hook(P)
        video = self._video(0)
        self.cap[0] = {"latents": self._held[0].float().cpu(), "video": video.float().cpu(),
                       "stages": self._stages}
        del video
        self.index = 1

    def _hook(self, P):
        """Hold on to the program's trajectory of each video and, at its
        checked steps, to the tensors that enter each stage of the DiT."""
        import mixgrpo_tpu_torch.models.hunyuan.model as HM

        self._orig = (P.run_rollout, P.hunyuan_video_forward, HM._double_block,
                      HM._single_block)
        rollout, forward, double, single = self._orig
        self._rec = None

        def kept(*a, **k):
            out = rollout(*a, **k)
            self._held = out.all_latents  # the program's own tensor, not copied
            return out

        def fwd(*a, **k):
            i = self._calls
            self._calls += 1
            if i in self._steps:
                self._rec = {"double": [], "single": []}
            v = forward(*a, **k)
            if self._rec is not None:
                self._rec["v"] = v
                # set-up's video copies each step's state at once; the window's hold it
                self._stages[i] = _to_host(self._rec) if self.index == 0 else self._rec
                self._rec = None
            return v

        def dbl(p, cfg, x, c, *a, **k):
            if self._rec is not None:
                self._rec["double"].append((x, c))
            return double(p, cfg, x, c, *a, **k)

        def sgl(p, cfg, j, *a, **k):
            out = single(p, cfg, j, *a, **k)
            if self._rec is not None:
                self._rec["single"].append(j)
                self._rec["last"] = out
            return out

        P.run_rollout, P.hunyuan_video_forward = kept, fwd
        HM._double_block, HM._single_block = dbl, sgl

    def _timed(self, key, fn):
        def run(*a, **k):
            self._sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self._sync()
            self.spans[key] = time.perf_counter() - t0
            return out
        return run

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def check_steps(self):
        """The checked steps of the first video and of the last: together
        ``check_steps`` draws from the seed, all but the last the first's."""
        rng = np.random.default_rng(derive(self.seed, 2))
        t = self.traffic
        draw = rng.choice(t["steps"], t["check_steps"], replace=False).tolist()
        return sorted(draw[:-1]), draw[-1:]

    def _plant(self, P):
        if "int8" in self.faults:  # the reference decode, in fp8, in the program's place
            def decode(lat):
                return ref_vae.decode_tiled(self.vae, self.config["vae"], lat, self.dtype,
                                            quant="fp8")

            self.pipe._decode = self._timed("decode_time", decode)
        if "frozen" in self.faults:
            model, calls, step = P.hunyuan_video_forward, [0], self.check_steps()[0][0]

            def frozen(*a, **k):
                calls[0] += 1
                out = model(*a, **k)
                return torch.zeros_like(out) if calls[0] == step + 1 else out

            P.hunyuan_video_forward = frozen
        if "altered" in self.faults:
            decode = self.pipe._decode

            def altered(lat):
                video = decode(lat)
                video[:, video.shape[1] // 2] *= 0.8
                return video

            self.pipe._decode = altered

    def _video(self, k):
        self._calls, self._stages = 0, {}
        self._steps = self.check_steps()[0 if k == 0 else 1]
        t = self.traffic
        txt, pooled, mask, z0 = self.inputs(k)
        return self.pipe(txt, pooled, video_length=t["frames"], height=t["height"],
                         width=t["width"], text_mask=mask, z0=z0)

    def run_unit(self):
        self._last = None  # the previous video is not the last: its state goes
        video = self._video(self.index)
        self._last = (self.index, self._held, video, self._stages)
        self.index += 1
        self._sync()
        ok = bool(torch.isfinite(video).all())
        return {"work": 1, "failed": 0 if ok else 1, "metrics": dict(self.spans)}

    def free(self):
        """Copy the last video's trajectory and frames, put the program's
        functions back and drop the pipeline."""
        import mixgrpo_tpu_torch.models.hunyuan.model as HM
        from mixgrpo_tpu_torch.models.hunyuan import pipeline as P

        k, lat, video, stages = self._last
        self.cap[k] = {"latents": lat[0].float().cpu(), "video": video.float().cpu(),
                       "stages": {i: _to_host(st) for i, st in stages.items()}}
        del self._last, self._held, self._stages, lat, video, stages
        P.run_rollout, _, HM._double_block, HM._single_block = self._orig
        P.hunyuan_video_forward = HM.hunyuan_video_forward
        del self.pipe

    # ------------------------------------------------------------------ shapes

    def _tokens(self):
        _, T, h, w, _ = self.lat_shape
        return T * (h // 2) * (w // 2), self.traffic["text_len"]

    def model_flops(self) -> float:
        """Model FLOPs of one video: the DiT at every step (the token refiner
        included) and every convolution and attention of each decode tile."""
        L_img, L_txt = self._tokens()
        d = dict(self.dims, pooled_dim=self.dims["text_states_dim_2"],
                 context_dim=self.dims["text_states_dim"], in_channels=4 * self.dims["in_channels"],
                 guidance_embeds=self.dims["guidance_embed"])
        f = F.mmdit_flops(d, 1, L_img, L_txt, refiner_tokens=L_txt)
        return self.traffic["steps"] * (f["gemm"] + f["attention"]) + self._decode_flops()

    def _decode_flops(self):
        """The tiled decode's tiles, each a causal VAE decode of 17 latent
        frames of at most 32 x 32 (counted as the program tiles)."""
        _, T, h, w, _ = self.lat_shape
        th, tw = min(32, h), min(32, w)
        n_s = len(ref_vae.tile_starts(h, th, 24)) * len(ref_vae.tile_starts(w, tw, 24))
        n_t = 1 + len(ref_vae.tile_starts(T, 16, 12, lo=1)) if T > 17 else 1
        L = 17 if T > 17 else T
        return n_s * n_t * F.causal_vae_decoder_flops(self.config["vae"], 1, L, th, tw)

    def attention_calls(self):
        """One flash forward per block per step: B = 1, the joint sequence
        padded to a multiple of 128 when long, the text mask and the pad keys as a key
        bias; the work is over the valid keys (the text tokens kept and the
        video tokens)."""
        L_img, L_txt = self._tokens()
        S = L_img + L_txt
        Sp = S + (-S) % 128 if S >= 8 * 128 else S  # the program pads long sequences
        H = self.dims["num_heads"]
        valid = L_img + self.traffic["text_tokens"]
        return {"flash_attn_fwd": (1, H, Sp, Sp, valid, self.dims["hidden_size"] // H, True)}

    # ------------------------------------------------------------------ check

    def check(self) -> dict:
        """``start`` (each video's noise, exact), ``denoise_stage`` (the
        worst stage of a checked DiT call or Euler step) and ``decode`` (the
        worst frame of the tiled decode), over the first and the last video."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out = {"start": 0.0, "denoise_stage": 0.0, "decode": 0.0}
        worst = {}
        with torch.no_grad():
            for k in (0, max(self.cap)):
                for name, v in self._check_video(k, worst).items():
                    out[name] = max(out[name], v)
        print(json.dumps({"info": {"denoise_stage_by_kind": worst}}), file=sys.stderr)
        return out

    def _check_video(self, k, worst):
        """The numbers of video ``k``; ``worst`` gathers each kind of
        stage's largest gap."""
        dev, t = self.device, self.traffic
        txt, pooled, mask, z0 = self.inputs(k)
        cap = self.cap[k]
        lat = cap["latents"]
        out = {"start": float((lat[0] - z0.reshape(-1).cpu()).abs().max())}
        sig = torch.as_tensor(self.sigmas, device=dev)
        g = torch.full((1,), t["guidance_scale"], device=dev)
        gaps = []
        for i, st in sorted(cap["stages"].items()):
            z = lat[i].to(dev).reshape(self.lat_shape)
            for kind, gap in self._stage_gaps(z, txt, pooled, sig[i:i + 1], g, mask, st):
                worst[kind] = max(worst.get(kind, 0.0), gap)
                gaps.append(gap)
            v = st["v"].to(dev).reshape(-1)
            step = (sig[i + 1] - sig[i]) * v
            gap = _rel(lat[i + 1].to(dev) - lat[i].to(dev), step)
            worst["euler"] = max(worst.get("euler", 0.0), gap)
            gaps.append(gap)
        out["denoise_stage"] = max(gaps)
        video = ref_vae.decode_tiled(self.vae, self.config["vae"],
                                     lat[-1].to(dev).reshape(self.lat_shape), self.dtype)
        prog = cap["video"].to(dev)
        out["decode"] = max(_rel(prog[0, f], video[0, f]) for f in range(video.shape[1]))
        return out

    def _stage_gaps(self, z, txt, pooled, t, g, mask, st):
        """(kind, gap) of each stage of one DiT call: the embedders against
        the first block's input; each block from the program's input, its
        output's change against the reference's; the final layer from the
        last block's output against the program's velocity."""
        dev, p = self.device, self.dit
        on = lambda x: x.to(dev)
        e = ref_dit.embed(p, self.dims, z, txt, pooled, t, g, mask, self.dtype)
        x0, c0 = (on(a) for a in st["double"][0])
        yield "embed", max(_rel(x0, e["x"]), _rel(c0, e["c"]))
        nd = len(st["double"])
        for i in range(nd):
            x, c = (on(a) for a in st["double"][i])
            if i + 1 < nd:
                nx, nc = (on(a) for a in st["double"][i + 1])
            else:
                j = on(st["single"][0])
                nc, nx = j[:, :c.shape[1]], j[:, c.shape[1]:]
            rx, rc = ref_dit.double(p, e, i, x, c)
            yield "double", _rel(torch.cat([nx, nc], 1), torch.cat([rx, rc], 1),
                                 torch.cat([x, c], 1))
        ns = len(st["single"])
        for i in range(ns):
            j = on(st["single"][i])
            nj = on(st["single"][i + 1] if i + 1 < ns else st["last"])
            yield "single", _rel(nj, ref_dit.single(p, e, i, j), j)
        yield "final", _rel(on(st["v"]), ref_dit.final(p, e, on(st["last"])))


def _rel(prog, ref, base=None):
    """|prog - ref| over |ref - base| (``base``: the stage's input, so that
    a block's change is compared), in f32."""
    ref = ref.float()
    d = ref if base is None else ref - base.float()
    return float((prog.float() - ref).norm() / d.norm())


def _to_host(st):
    """One checked step's stage tensors, copied to the host."""
    cpu = lambda x: x.cpu()
    return {"double": [(cpu(x), cpu(c)) for x, c in st["double"]],
            "single": [cpu(j) for j in st["single"]], "last": cpu(st["last"]),
            "v": st["v"].float().cpu()}
