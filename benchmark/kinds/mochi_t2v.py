"""The video as a unit of work: Mochi-1 text-to-video through the program's
``MochiPipeline``.

Each video has inputs of its own, drawn from the seed and its index: T5
features of the prompt and of the negative prompt, each ``text_len`` tokens
with a mask (the first ``text_tokens`` and ``neg_text_tokens`` valid; the
padded rows hold features too, which a correct DiT never reads), and the
initial noise.  The weights (the DiT and the VAE decoder) are made from the
seed on the device.  Set-up runs the first video through the same call as
the window.  Of that video and of the last one the run makes (the window's
last, or the traced one) the kind keeps the velocity of every DiT call, the
final latents of the guided Euler loop, the frames, and at the checked
steps, in both guidance branches, the latents the DiT was given and the
state that enters each stage of the call (the embedders' output, each
block's input, the final block's output, the velocity).  Of
the window's videos it holds on to the program's own tensors only, and
copies the last one's once the window has closed.  The pipeline instance's
denoise and decode are wrapped in synchronised timers from this file: the
spans ``denoise_s.video`` and ``decode_s.video`` read.  Once the pipeline
is freed, ``check`` has the references follow both videos stage by stage
from the program's own state, follow the guided Euler loop from the noise
to the final latents with the program's velocities, and decode the final
latents in tiles.

The checked steps are ``check_steps`` draws from the seed: all but one of
the first video's, one of the last's (each step's state, both branches, is
1.8 GB).  The reference takes each branch's valid T5 tokens only.

Faults for the control and the fault tests: ``int8`` is the control: the
DiT's visual block matmuls on the program's int8 path, and the reference decode
in fp8 (the program has no decode below bf16) put in the program's place;
``frozen`` makes both DiT calls of the first checked step return zeros, so
that the step leaves its state unchanged; ``altered`` darkens one decoded
frame.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from benchlib import mochi_flops as MF
from benchlib.seeds import derive
from benchlib.weights import default_rule, materialize
from reference import mochi as ref_dit
from reference import mochi_vae as ref_vae


def dit_config(config: dict):
    """The program's ``MochiConfig`` of the configuration file, its derived
    widths held to the file's."""
    from mixgrpo_tpu_torch.models.mochi.model import MochiConfig

    c = MochiConfig(patch_size=config["patch_size"], num_heads=config["num_attention_heads"],
                    head_dim=config["attention_head_dim"], num_layers=config["num_layers"],
                    in_channels=config["in_channels"], text_dim=config["pooled_projection_dim"],
                    text_embed_dim=config["text_embed_dim"],
                    time_freq_dim=config["time_embed_dim"], pool_heads=config["pool_heads"],
                    max_text_len=config["max_sequence_length"],
                    base_height=config["assumed"]["base_area"][0],
                    base_width=config["assumed"]["base_area"][1],
                    eps=config["assumed"]["norm_eps"])
    if (c.ff_inner, c.ff_context_inner) != (config["ff_inner_dim"],
                                            config["ff_context_inner_dim"]):
        raise ValueError("the configuration's feed-forward widths are not the program's")
    return c


def vae_config(v: dict):
    """The program's ``MochiVAEConfig`` (its lists innermost first) of the
    configuration file's decoder (outermost first)."""
    from mixgrpo_tpu_torch.models.mochi.vae import MochiVAEConfig

    return MochiVAEConfig(
        latent_channels=v["latent_channels"], out_channels=v["out_channels"],
        block_out_channels=tuple(v["block_out_channels"]),
        layers=tuple(reversed(v["layers_per_block"])),
        expansions=tuple(zip(reversed(v["temporal_expansions"]),
                             reversed(v["spatial_expansions"]))),
        norm_num_groups=v["norm_num_groups"])


class Run:
    def __init__(self, cell, seed: int, device, faults=()):
        self.config, self.traffic = cell.config, cell.traffic
        self.seed, self.device, self.faults = int(seed), torch.device(device), set(faults)
        self.dtype = getattr(torch, self.config["dtype"])
        t = self.traffic
        self.lat_shape = (1, (t["frames"] - 1) // 6 + 1, t["height"] // 8, t["width"] // 8,
                          self.config["in_channels"])
        self.sigmas = ref_dit.linear_quadratic(t["steps"], t["lq_threshold"])
        self.dsig = torch.as_tensor(np.diff(self.sigmas))
        self.index = 0
        self.cap = {}

    def inputs(self, k):
        """(T5 features, mask, negative features, negative mask, z0) of
        video ``k``."""
        t, dev = self.traffic, self.device
        g = torch.Generator(dev).manual_seed(derive(self.seed, 1, k))
        shape = (1, t["text_len"], self.config["text_embed_dim"])
        txt = torch.randn(shape, generator=g, device=dev)
        neg = torch.randn(shape, generator=g, device=dev)
        z0 = torch.randn(self.lat_shape, generator=g, device=dev)
        masks = []
        for n in (t["text_tokens"], t["neg_text_tokens"]):
            m = torch.zeros((1, t["text_len"]), dtype=torch.int32, device=dev)
            m[:, :n] = 1
            masks.append(m)
        return txt, masks[0], neg, masks[1], z0

    def setup(self):
        from mixgrpo_tpu_torch.models.mochi import model as MM
        from mixgrpo_tpu_torch.models.mochi import pipeline as P
        from mixgrpo_tpu_torch.models.mochi.vae import init_mochi_vae_decoder

        t, dev = self.traffic, self.device
        self.dit_cfg, self.vae_cfg = dit_config(self.config), vae_config(self.config["vae"])
        g = torch.Generator(dev).manual_seed(derive(self.seed, 0))
        kw = dict(device=dev, dtype=self.dtype)
        std = self.config["assumed"]["pos_frequencies_std"]

        def rule(path, shape):
            return (0.0, std) if path == "pos_frequencies" else default_rule(path, shape)

        self.dit = materialize(MM.init_mochi(self.dit_cfg, device="meta", dtype=self.dtype),
                               g, rule=rule, **kw)
        self.vae = materialize(init_mochi_vae_decoder(self.vae_cfg, device="meta",
                                                      dtype=self.dtype), g, **kw)
        self.pipe = pipe = P.MochiPipeline(
            self.dit_cfg, _int8_blocks(self.dit) if "int8" in self.faults else self.dit,
            num_steps=t["steps"], guidance_scale=t["guidance_scale"],
            lq_threshold=t["lq_threshold"], dtype=self.dtype, vae_cfg=self.vae_cfg,
            vae_params=self.vae, device=dev)
        self.spans = {"denoise_time": 0.0, "decode_time": 0.0}
        for key, name in (("denoise_time", "_sample"), ("decode_time", "_decode")):
            setattr(pipe, name, self._timed(key, getattr(pipe, name)))
        self._plant(P)
        self._hook(P, MM)
        video = self._video(0)
        self.cap[0] = _to_host_video(self._held, video, self._stages)
        del video
        self.index = 1

    def _hook(self, P, MM):
        """Hold on to the velocity of each DiT call of a video and, at its
        checked steps, to the tensors that enter each stage of both DiT
        calls."""
        self._orig = (P.mochi_forward, MM._mochi_block)
        forward, block = self._orig
        self._rec = None

        def fwd(params, cfg, z, *a, **k):
            i = self._calls
            self._calls += 1
            step = i // 2
            if step in self._steps:
                self._rec = {"blocks": [], "z": z}
            v = forward(params, cfg, z, *a, **k)
            self._held["v"].append(v)  # the program's own tensor, not copied
            if self._rec is not None:
                self._rec["v"] = v
                st = self._stages.setdefault(step, {})
                # set-up's video copies each step's state at once; the window's hold it
                st["cond" if i % 2 == 0 else "uncond"] = (
                    _to_host(self._rec) if self.index == 0 else self._rec)
                self._rec = None
            return v

        def blk(p, cfg, x, c, *a, **k):
            out = block(p, cfg, x, c, *a, **k)
            if self._rec is not None:
                self._rec["blocks"].append((x, c))
                self._rec["last"] = out[0]
            return out

        P.mochi_forward, MM._mochi_block = fwd, blk

    def _timed(self, key, fn):
        def run(*a, **k):
            self._sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self._sync()
            self.spans[key] = time.perf_counter() - t0
            if key == "denoise_time":
                self._held.update(z0=a[0], final=out)
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
            model, calls, step = P.mochi_forward, [0], self.check_steps()[0][0]

            def frozen(*a, **k):
                calls[0] += 1
                out = model(*a, **k)
                return torch.zeros_like(out) if (calls[0] - 1) // 2 == step else out

            P.mochi_forward = frozen
        if "altered" in self.faults:
            decode = self.pipe._decode

            def altered(lat):
                video = decode(lat)
                video[:, video.shape[1] // 2] *= 0.8
                return video

            self.pipe._decode = altered

    def _video(self, k):
        self._calls, self._stages, self._held = 0, {}, {"v": []}
        self._steps = self.check_steps()[0 if k == 0 else 1]
        t = self.traffic
        txt, mask, neg, neg_mask, z0 = self.inputs(k)
        return self.pipe(txt, num_frames=t["frames"], height=t["height"], width=t["width"],
                         text_mask=mask, neg_txt=neg, neg_mask=neg_mask, z0=z0)

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
        from mixgrpo_tpu_torch.models.mochi import model as MM
        from mixgrpo_tpu_torch.models.mochi import pipeline as P

        k, held, video, stages = self._last
        self.cap[k] = _to_host_video(held, video, {i: {b: _to_host(r) for b, r in st.items()}
                                                   for i, st in stages.items()})
        del self._last, self._held, self._stages, held, video, stages
        P.mochi_forward, MM._mochi_block = MM.mochi_forward, self._orig[1]
        del self.pipe

    # ------------------------------------------------------------------ shapes

    def _tokens(self):
        _, T, h, w, _ = self.lat_shape
        ps = self.config["patch_size"]
        t = self.traffic
        return T * (h // ps) * (w // ps), (t["text_tokens"], t["neg_text_tokens"])

    def model_flops(self) -> float:
        """Model FLOPs of one video: both guided DiT calls at every step (each
        over its branch's valid text tokens) and every convolution and
        Linear of each decode tile."""
        L_vis, texts = self._tokens()
        call = lambda n: sum(MF.mochi_dit_flops(self.config, 1, L_vis, n).values())
        return self.traffic["steps"] * sum(call(n) for n in texts) + self._decode_flops()

    def _decode_flops(self):
        """The tiled decode's tiles, each a decode of at most 17 latent frames
        of at most 32 x 32 (counted as the program tiles)."""
        _, T, h, w, _ = self.lat_shape
        th, tw = min(32, h), min(32, w)
        n_s = len(ref_vae.tile_starts(h, th, 24)) * len(ref_vae.tile_starts(w, tw, 24))
        n_t = 1 + len(ref_vae.tile_starts(T, 16, 12, lo=1)) if T > 17 else 1
        L = 17 if T > 17 else T
        return n_s * n_t * MF.mochi_decoder_flops(self.config["vae"], 1, L, th, tw)

    def attention_calls(self):
        """One flash forward per block per DiT call, B = 1, no mask: the
        program cuts each branch's text to its valid tokens, so a block
        attends over the video and the valid text keys, and the final block
        takes the video queries only.  The launches differ (the two branches
        by the difference of their valid text, the final block by its
        queries), so the one shape given is the mean launch: the mean keys,
        and the queries that make the product of queries and keys the
        launches' mean (the bound is that of the operations)."""
        L_vis, texts = self._tokens()
        n = self.config["num_layers"]
        H, D = self.config["num_attention_heads"], self.config["attention_head_dim"]
        shapes = [(L_vis + L_txt if i < n - 1 else L_vis, L_vis + L_txt)
                  for L_txt in texts for i in range(n)]
        keys = sum(k for _, k in shapes) / len(shapes)
        queries = sum(q * k for q, k in shapes) / len(shapes) / keys
        return {"flash_attn_fwd": (1, H, queries, keys, keys, D, False)}

    # ------------------------------------------------------------------ check

    def check(self) -> dict:
        """``start`` (each video's noise, exact), ``denoise_stage`` (the
        worst stage of a checked DiT call, guidance or Euler step) and
        ``decode`` (the worst frame of the tiled decode), over the first and
        the last video."""
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
        txt, _, neg, _, z0 = self.inputs(k)
        texts = {"cond": txt[:, :t["text_tokens"]], "uncond": neg[:, :t["neg_text_tokens"]]}
        cap = self.cap[k]
        gaps = []

        def note(kind, gap):
            worst[kind] = max(worst.get(kind, 0.0), gap)
            gaps.append(gap)

        for i, st in sorted(cap["stages"].items()):
            tt = torch.full((1,), float(self.sigmas[i]), device=dev)
            for branch, rec in st.items():
                for kind, gap in self._stage_gaps(texts[branch], tt, rec):
                    note(kind, gap)
        # the guided Euler loop from the noise, with the program's velocities
        v = cap["v"].to(dev)
        step = (self.dsig.to(dev)[:, None]
                * ref_dit.guided(v[0::2], v[1::2], t["guidance_scale"]).flatten(1)).sum(0)
        z0 = z0.float()
        note("guided_euler", _rel(cap["final"].to(dev) - z0, step.reshape(z0.shape)))
        out = {"start": float((cap["z0"] - z0.cpu()).abs().max()), "denoise_stage": max(gaps)}
        video = ref_vae.decode_tiled(self.vae, self.config["vae"], cap["final"].to(dev),
                                     self.dtype)
        prog = cap["video"].to(dev)
        out["decode"] = max(_rel(prog[0, f], video[0, f]) for f in range(video.shape[1]))
        return out

    def _stage_gaps(self, txt, t, rec):
        """(kind, gap) of each stage of one DiT call: the embedders against
        the first block's input (1 where the program's text stream is not
        the valid tokens: a DiT that attends padded tokens); each block from
        the program's input, its
        output's change against the reference's; the final layer from the
        final block's output against the program's velocity."""
        dev, p = self.device, self.dit
        on = lambda x: x.to(dev)
        e = ref_dit.embed(p, self.config, on(rec["z"]), txt, t, self.dtype)
        blocks = [(on(x), on(c)) for x, c in rec["blocks"]]
        c0 = blocks[0][1]  # a text stream of another length than the valid tokens: 1
        yield "embed", max(_rel(blocks[0][0], e["x"]),
                           _rel(c0, e["c"]) if c0.shape == e["c"].shape else 1.0)
        for i, (x, c) in enumerate(blocks[:-1]):
            nx, nc = blocks[i + 1]
            rx, rc = ref_dit.body(p, e, i, x, c)
            yield "block", _rel(_joined(nx, nc), _joined(rx, rc), _joined(x, c))
        x, c = blocks[-1]
        last = on(rec["last"])
        yield "final_block", _rel(last, ref_dit.final_block(p, e, x, c)[0], x)
        yield "final", _rel(on(rec["v"]), ref_dit.final(p, e, last))


VISUAL_MATMULS = ("qkv", "attn_out", "ff_in", "ff_out")


def _int8_blocks(params):
    """The DiT with the visual stream's block matmuls (the body stack's and
    the final block's; 99% of a call's block FLOPs) on the program's int8
    path.  The text stream's stay bf16: the card's int8 product takes more
    than 16 rows, and the negative prompt has one token.  Embedders,
    modulations and norms stay the input's tensors."""
    from mixgrpo_tpu_torch.ops.quant import quantize_linear_params

    def q(tree):
        return {k: quantize_linear_params(v) if k in VISUAL_MATMULS else v
                for k, v in tree.items()}

    return dict(params, blocks=q(params["blocks"]), final_block=q(params["final_block"]))


def _joined(x, c):
    """Both streams (of different widths) as one vector."""
    return torch.cat([x.flatten(), c.flatten()])


def _rel(prog, ref, base=None):
    """|prog - ref| over |ref - base| (``base``: the stage's input, so that
    a block's change is compared), in f32."""
    ref = ref.float()
    d = ref if base is None else ref - base.float()
    return float((prog.float() - ref).norm() / d.norm())


def _to_host(rec):
    """One checked call's stage tensors, copied to the host."""
    cpu = lambda x: x.cpu()
    return {"blocks": [(cpu(x), cpu(c)) for x, c in rec["blocks"]], "last": cpu(rec["last"]),
            "z": cpu(rec["z"]), "v": rec["v"].float().cpu()}


def _to_host_video(held, video, stages):
    """A video's record on the host: the noise its loop started from, every
    DiT call's velocity (in call order, each step's conditional call
    first), the final latents, the frames and the checked steps' stage
    tensors."""
    cpu = lambda x: x.float().cpu()
    return {"z0": cpu(held["z0"]), "v": cpu(torch.stack(held["v"])), "final": cpu(held["final"]),
            "video": cpu(video), "stages": stages}
