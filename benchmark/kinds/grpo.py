"""The GRPO iteration as a unit of work: MixGRPO training of a FLUX model
through the program's ``GRPOTrainer``.

Set-up makes every input from the seed (the frozen bf16 base, the VAE
decoder, the reward model, the LoRA factors, the prompt embeddings and
captions written to an embedding cache under ``TMPDIR`` and read back
through the program's ``PromptLoader``, each iteration's initial noise and
SDE draws), builds one trainer, and runs its first iteration through the
same call as the window (the body of ``GRPOTrainer._train_loop``: read and
advance the sliding window, ``train_one_step``), keeping what that
iteration produced: the rollout's latents and log-probs, the decoded
images, the rewards, each update's loss, the first gradient from the
optimizer's state and the factors after the third update.  That first
iteration is set-up; the window's iterations follow it on the same object.
Of each later iteration the kind holds on to the program's rollout and a
copy of the factors it started from, and once the window has closed keeps
the last one's (the window's last, or the traced one): one row's latents
and log-probs, its prompt and those factors.  Once the trainer is freed,
``check`` has the plain references in ``reference/`` follow the first
iteration from the program's own state, stage by stage, and the last
iteration's rollout of that row from the factors it started from, so that
state carried stale from one iteration to the next shows (see
``PERF.md``).

Faults for the control and the fault tests (``faults``): ``int8`` runs the
rollout on the program's int8 path; ``frozen`` puts the factors back after
every update; ``half`` drops half of each update's rows; ``altered``
alters one checked row's answer where each stage produces it (the last
window step applied twice, the image darkened, the reward raised).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from benchlib import flops as F
from benchlib.seeds import derive
from benchlib.weights import materialize
from reference import clip as ref_clip
from reference import flux as ref_flux
from reference import grpo as ref_grpo
from reference import vae as ref_vae
from reference.tokenizer import Tokenizer

MERGES = ("#version: 0.2\nt h\nth e</w>\na</w>\no f</w>\ni n</w>\no n</w>\na n\nan d</w>\n"
          "o r\ne r\ne s\nr e\nc a\nca t</w>\nd o\ndo g</w>\nr ed</w>\ne d</w>\ns t\nt r\n"
          "e e</w>\nb l\nbl u\nblu e</w>\ng r\ngr e\ngre en</w>\ne n</w>\np h\nph o\n")


def flux_dims(config: dict) -> dict:
    """The configuration file's published keys in the names of the
    benchmark's FLOP counts and of the program's ``FluxConfig``."""
    heads, hd = config["num_attention_heads"], config["attention_head_dim"]
    a = config["assumed"]
    return {"in_channels": config["in_channels"], "hidden_size": heads * hd,
            "num_heads": heads, "depth_double": config["num_layers"],
            "depth_single": config["num_single_layers"], "mlp_ratio": a["mlp_ratio"],
            "axes_dims": tuple(config["axes_dims_rope"]),
            "pooled_dim": config["pooled_projection_dim"],
            "context_dim": config["joint_attention_dim"],
            "guidance_embeds": config["guidance_embeds"],
            "time_freq_dim": a["time_freq_dim"], "theta": a["rope_theta"],
            "eps": a["norm_eps"]}


class Run:
    """One run of a GRPO cell on ``device``; ``faults`` plants the faults
    named in the module docstring."""

    def __init__(self, cell, seed: int, device, faults=()):
        self.config, self.traffic = cell.config, cell.traffic
        self.seed, self.device, self.faults = int(seed), torch.device(device), set(faults)
        self.dtype = getattr(torch, self.config["dtype"])
        self.dims = flux_dims(self.config)
        t = self.traffic
        self.B = t["prompts_per_iteration"] * t["num_generations"]
        self.grid = (t["resolution"] // 16, t["resolution"] // 16)
        self.L_img = self.grid[0] * self.grid[1]
        self.L_txt = self.config["assumed"]["text_len"]
        self.window = list(range(t["window_size"]))
        self.sigmas, self.num_steps = ref_grpo.flash_schedule(
            t["sampling_steps"], t["shift"], self.window, t["dpm"]["compress_ratio"])
        self.cap = {}
        self._tmp = tempfile.TemporaryDirectory(prefix="bench_grpo_")

    # ------------------------------------------------------------------ inputs

    def _weights(self):
        from mixgrpo_tpu_torch.models.flux.model import FluxConfig, init_flux
        from mixgrpo_tpu_torch.models.flux.vae import VAEConfig, init_vae_decoder
        from mixgrpo_tpu_torch.models.text.clip import CLIPConfig, CLIPTowerConfig, init_clip

        d, v, r = self.dims, self.config["vae"], self.config["reward_model"]
        self.flux_cfg = FluxConfig(**d)
        self.vae_cfg = VAEConfig(**{k: (tuple(x) if isinstance(x, list) else x)
                                    for k, x in v.items() if not k.startswith("_")})
        self.clip_cfg = CLIPConfig(embed_dim=r["embed_dim"], vision=CLIPTowerConfig(**r["vision"]),
                                   text=CLIPTowerConfig(**r["text"]))
        g = torch.Generator(self.device).manual_seed(derive(self.seed, 1))
        kw = dict(device=self.device, dtype=self.dtype)
        self.base = materialize(init_flux(self.flux_cfg, device="meta", dtype=self.dtype), g, **kw)
        self.vae = materialize(init_vae_decoder(self.vae_cfg, device="meta", dtype=self.dtype),
                               g, **kw)
        self.clip = materialize(init_clip(self.clip_cfg, device="meta", dtype=self.dtype), g, **kw)
        self.clip["logit_scale"] = self.clip["logit_scale"].float()  # kept f32, as served

    def _prompts(self):
        """The embedding cache, written under ``TMPDIR``, and the loader."""
        from mixgrpo_tpu_torch.data.dataset import (
            EmbeddingCacheWriter, LatentDataset, PromptLoader,
        )

        t = self.traffic
        rng = np.random.default_rng(derive(self.seed, 2))
        w = EmbeddingCacheWriter(os.path.join(self._tmp.name, "cache"))
        for _ in range(t["prompts"]):
            w.add(rng.standard_normal((self.L_txt, self.dims["context_dim"]), np.float32),
                  rng.standard_normal((self.dims["pooled_dim"],), np.float32),
                  " ".join(rng.choice(t["words"], t["caption_words"])))
        w.finish()
        ds = LatentDataset(os.path.join(self._tmp.name, "cache"))
        return iter(PromptLoader(ds, t["prompts_per_iteration"],
                                 seed=derive(self.seed, 3) % 2**31))

    def _z0(self, step):
        t = self.traffic
        n = t["prompts_per_iteration"] if t["init_same_noise"] else self.B
        g = torch.Generator(self.device).manual_seed(derive(self.seed, 4, step))
        z = torch.randn((n, 1, self.L_img, self.dims["in_channels"]), generator=g,
                        device=self.device)
        return z.expand(n, self.B // n, self.L_img, self.dims["in_channels"]).reshape(
            self.B, self.L_img, self.dims["in_channels"])

    def noise(self, step, chunk, i, shape):
        g = torch.Generator(self.device).manual_seed(derive(self.seed, 5, step, chunk, i))
        return torch.randn(shape, generator=g, device=self.device)

    # ------------------------------------------------------------------ program

    def setup(self):
        from mixgrpo_tpu_torch.config import DPMConfig, RunConfig, TrainConfig
        from mixgrpo_tpu_torch.rewards.clip_family import HPSReward
        from mixgrpo_tpu_torch.rewards.tokenizer import CLIPTokenizer
        from mixgrpo_tpu_torch.train import GRPOTrainer

        t = self.traffic
        self._weights()
        self.it = self._prompts()
        merges = os.path.join(self._tmp.name, "merges.txt")
        with open(merges, "w") as f:
            f.write(MERGES)
        dpm = t["dpm"]
        cfg = TrainConfig(
            dpm=DPMConfig(dpm_algorithm_type=dpm["algorithm"], dpm_apply_strategy=dpm["strategy"],
                          dpm_post_compress_ratio=dpm["compress_ratio"],
                          dpm_solver_order=dpm["order"], dpm_solver_type=dpm["solver_type"]),
            run=RunConfig(output_dir=os.path.join(self._tmp.name, "run"), experiment_name="bench",
                          export_safetensors="off"))
        g, o = cfg.grpo, cfg.optim
        g.h = g.w = t["resolution"]
        g.sampling_steps, g.eta, g.shift = t["sampling_steps"], t["eta"], t["shift"]
        g.guidance_scale, g.num_generations = t["guidance_scale"], t["num_generations"]
        g.init_same_noise, g.rollout_chunk = t["init_same_noise"], t["rollout_chunk"]
        g.clip_range, g.adv_clip_max = t["ppo"]["clip_range"], t["ppo"]["adv_clip_max"]
        g.loss_coef = t["ppo"]["loss_coef"]
        g.seed = g.sampler_seed = derive(self.seed, 6) % 2**31
        g.rollout_quant = "int8" if "int8" in self.faults else "none"
        cfg.window.group_size, cfg.window.iters_per_group = t["window_size"], t["iters_per_group"]
        o.gradient_accumulation_steps = t["gradient_accumulation_steps"]
        o.gradient_checkpointing = t["gradient_checkpointing"]
        o.learning_rate, o.weight_decay = t["optim"]["learning_rate"], t["optim"]["weight_decay"]
        o.max_grad_norm = t["optim"]["max_grad_norm"]
        cfg.reward.reward_model = t["reward"]
        reward = HPSReward(self.clip, self.clip_cfg,
                           CLIPTokenizer(merges, self.config["reward_model"]["text"]["context"]),
                           dtype=self.dtype)
        lo = t["lora"]
        self.trainer = tr = GRPOTrainer(
            cfg, flux_cfg=self.flux_cfg, params=self.base, vae_cfg=self.vae_cfg,
            vae_params=self.vae, reward_models={t["reward"]: reward}, text_len=self.L_txt,
            dtype=self.dtype, device=self.device, use_lora=True, lora_rank=lo["rank"],
            lora_alpha=lo["alpha"])
        gen = torch.Generator(self.device).manual_seed(derive(self.seed, 7))
        with torch.no_grad():
            for f in tr.lora_factors.values():
                f["a"].normal_(generator=gen).mul_(f["a"].shape[-2] ** -0.5)
                f["b"].normal_(generator=gen).mul_(lo["b_std"])
        self.cap["factors0"] = {p: {k: x.cpu().clone() for k, x in f.items()}
                                for p, f in tr.lora_factors.items()}
        self._plant()
        self._capture(True)
        self.run_unit()
        self._capture(False)

        rollout = tr.sampler.chunked_rollout

        def held(*a, **k):
            self._held = out = rollout(*a, **k)  # the program's own tensors, not copied
            return out

        tr.sampler.chunked_rollout = held

    def _plant(self):
        tr = self.trainer
        if "frozen" in self.faults or "half" in self.faults:
            update = tr.lora_update

            def faulty(factors, opt_state, meta, base, ub, sig):
                if "half" in self.faults:
                    ub = type(ub)(*(x[: x.shape[0] // 2] for x in ub))
                keep = [x.detach().clone() for f in factors.values() for x in f.values()]
                out = update(factors, opt_state, meta, base, ub, sig)
                if "frozen" in self.faults:
                    with torch.no_grad():
                        for x, k in zip((x for f in factors.values() for x in f.values()), keep):
                            x.copy_(k)
                return out

            tr.lora_update = faulty
        if "altered" in self.faults:  # one row's answer altered where each stage makes it
            rollout, decode, rewards = tr.sampler.chunked_rollout, tr._decode, tr._compute_rewards
            r = self.check_rows()[0]

            def altered_rollout(*a, **k):
                out = rollout(*a, **k)
                z = out.all_latents[r]
                z[4] += z[4] - z[3]  # the last window step applied twice
                return out

            def altered_decode(x):
                img = decode(x)
                img[r] *= 0.8
                return img

            def altered_rewards(images, captions):
                rd, sd = rewards(images, captions)
                rd = {k: np.array(v, np.float64) for k, v in rd.items()}
                for v in rd.values():
                    v[r] += 0.05
                return rd, sd

            tr.sampler.chunked_rollout = altered_rollout
            tr._decode, tr._compute_rewards = altered_decode, altered_rewards

    def _capture(self, on: bool):
        """Keep what the first iteration produces (on), or stop (off)."""
        tr, cap, n = self.trainer, self.cap, self.num_steps
        if not on:
            for name in ("_decode", "_compute_rewards"):
                tr.__dict__.pop(name, None)
            tr.sampler.chunked_rollout, tr.lora_update = self._orig
            return
        self._orig = (tr.sampler.chunked_rollout, tr.lora_update)
        rollout, update = self._orig
        decode, rewards = tr._decode, tr._compute_rewards
        cap["loss"] = []

        def c_rollout(*a, **k):
            out = rollout(*a, **k)
            cap["latents"] = out.all_latents[:, : n + 1].float().cpu()
            cap["log_probs"] = out.all_log_probs[:, :n].float().cpu()
            return out

        def c_decode(x):
            img = decode(x)
            cap["images"] = img.float().cpu()
            return img

        def c_rewards(images, captions):
            rd, sd = rewards(images, captions)
            cap["rewards"] = {k: np.asarray(v, np.float64) for k, v in rd.items()}
            cap["captions"] = list(captions)
            return rd, sd

        def c_update(factors, opt_state, meta, base, ub, sig):
            out = update(factors, opt_state, meta, base, ub, sig)
            cap["loss"].append(float(out[2]["loss"]))
            if len(cap["loss"]) == 1:
                opt = out[1]
                b1 = opt.param_groups[0]["betas"][0]
                cap["grad1"] = {p: {k: (opt.state[x]["exp_avg"] / (1 - b1)).cpu()
                                    for k, x in f.items()} for p, f in out[0].items()}
            if len(cap["loss"]) == self.traffic["check_update_steps"]:
                cap["factors3"] = {p: {k: x.detach().cpu().clone() for k, x in f.items()}
                                   for p, f in out[0].items()}
            return out

        tr.sampler.chunked_rollout, tr.lora_update = c_rollout, c_update
        tr._decode, tr._compute_rewards = c_decode, c_rewards

    def run_unit(self):
        """One iteration, as ``GRPOTrainer._train_loop`` runs it (no
        checkpoint); returns its samples and the trainer's metrics."""
        tr = self.trainer
        self._last = None  # the previous iteration is not the last: its state goes
        step = tr.global_step
        timesteps = tr.window.get_current_timesteps()
        tr.window.update_iteration(rng=tr.cfg.grpo.seed + step)
        batch = next(self.it)
        if step == 0:
            self.cap["batch"] = batch
            self.cap["timesteps"] = list(timesteps)
        else:
            with torch.no_grad():
                factors = {p: {k: x.detach().clone() for k, x in f.items()}
                           for p, f in tr.lora_factors.items()}
        m = tr.train_one_step(batch, timesteps, z0=self._z0(step),
                              noise_fn=lambda j, i, shape: self.noise(step, j, i, shape))
        if step > 0:
            self._last = (step, batch, factors, self._held)
        m.update(tr.metrics.tick())
        tr.metrics.log(step, m)
        tr.global_step += 1
        ok = all(np.isfinite(m[k]) for k in ("loss", "grad_norm", "reward"))
        return {"work": self.B, "failed": 0 if ok else self.B, "metrics": m}

    def free(self):
        """Keep the last iteration's checked row, then drop the program's
        state: the trainer, its optimizer and its tables (the weights stay:
        they are the benchmark's inputs)."""
        step, batch, factors, out = self._last
        r, n = self.last_row(), self.num_steps
        self.cap["last"] = {
            "step": step, "row": r, "batch": batch,
            "factors": {p: {k: x.cpu() for k, x in f.items()} for p, f in factors.items()},
            "latents": out.all_latents[r:r + 1, : n + 1].float().cpu(),
            "log_probs": out.all_log_probs[r:r + 1, :n].float().cpu()}
        del self._last, self._held, out, factors
        self.trainer.close()
        del self.trainer

    # ------------------------------------------------------------------ shapes

    def model_flops(self) -> float:
        """Model FLOPs of one iteration: the rollout's forwards, the decode,
        the reward, and each update pair's forward and backward (activation
        gradients, the attention's backward, the LoRA factors' gradients; no
        remat, no base weight gradients)."""
        t, d = self.traffic, self.dims
        fwd = F.mmdit_flops(d, 1, self.L_img, self.L_txt)
        lora = F.lora_flops(d, 1, self.L_img, self.L_txt, t["lora"]["rank"])
        pairs = self.B * len([s for s in self.window if s < self.num_steps])
        v = self.config["vae"]
        clip = self.config["reward_model"]
        return (self.B * self.num_steps * (fwd["gemm"] + fwd["attention"])
                + F.vae_decoder_flops(v, self.B, 2 * self.grid[0], 2 * self.grid[1])
                + F.clip_score_flops(clip, self.B)
                + pairs * (2 * fwd["gemm"] + 3 * fwd["attention"] + 3 * lora))

    def attention_calls(self):
        """{kernel: (B, H, S, Sk, kv_len, D, bias)} of each attention launch:
        the rollout's forwards on a chunk, the update's on one accumulation
        group; a long joint sequence padded to a multiple of 128."""
        t, d = self.traffic, self.dims
        S = self.L_img + self.L_txt
        Sp = S + (-S) % 128 if S >= 8 * 128 else S  # the program pads long sequences
        H, D = d["num_heads"], d["hidden_size"] // d["num_heads"]
        n = t["gradient_accumulation_steps"] * len(self.window)
        upd = (n, H, Sp, Sp, S, D, False)
        return {"flash_attn_fwd": (t["rollout_chunk"], H, Sp, Sp, S, D, False),
                "flash_attn_fwd_lse": upd, "flash_attn_bwd_fused": upd,
                "flash_attn_bwd_dkv": upd, "flash_attn_bwd_dq": upd}

    # ------------------------------------------------------------------ check

    def check_rows(self):
        rng = np.random.default_rng(derive(self.seed, 8))
        return sorted(rng.choice(self.B, self.traffic["check_rows"], replace=False).tolist())

    def last_row(self):
        """The row of the last iteration whose rollout is checked."""
        return int(np.random.default_rng(derive(self.seed, 9)).integers(self.B))

    @torch.no_grad()
    def _velocity(self, z, t, lora, b):
        """The reference's velocity of prompt batch ``b`` at packed latents
        z (N, L, C) and times t (N,)."""
        N = z.shape[0]
        txt = torch.as_tensor(b["prompt_embed"][:1]).to(self.device, self.dtype).expand(N, -1, -1)
        pooled = torch.as_tensor(b["pooled"][:1]).to(self.device, self.dtype).expand(N, -1)
        g = torch.full((N,), self.traffic["guidance_scale"], device=self.device)
        return ref_flux.flux_forward(self.base, self.dims, z, txt, pooled, t, g, self.grid,
                                     lora=lora)

    def check(self) -> dict:
        """The compared numbers (see ``PERF.md``), worked out by the plain
        references from the first iteration's inputs and the program's
        outputs stage by stage."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t, cap, dev = self.traffic, self.cap, self.device
        n = self.num_steps
        scale = t["lora"]["alpha"] / t["lora"]["rank"]
        f0 = {p: {k: x.to(dev) for k, x in f.items()} for p, f in cap["factors0"].items()}
        lora0 = {"factors": f0, "scale": scale}
        lat = cap["latents"]
        rows = self.check_rows()
        out = self._check_rollout(0, rows, lat, cap["log_probs"], lora0, cap["batch"])
        last = cap["last"]
        f = {p: {k: x.to(dev) for k, x in fl.items()} for p, fl in last["factors"].items()}
        for name, v in self._check_rollout(last["step"], [last["row"]], last["latents"],
                                           last["log_probs"], {"factors": f, "scale": scale},
                                           last["batch"], first=last["row"]).items():
            out[name] = max(out[name], v)
        del f

        img_ref = ref_vae.decode(self.vae, lat[rows, n].to(dev), *self.grid,
                                 groups=self.config["vae"]["norm_num_groups"], dtype=self.dtype)
        img = cap["images"][rows].to(dev)
        out["decode"] = max(float((img[i] - img_ref[i]).norm() / img_ref[i].norm())
                            for i in range(len(rows)))
        del img_ref
        tok = Tokenizer(MERGES, self.config["reward_model"]["text"]["context"])
        ids = tok([cap["captions"][r] for r in rows])
        s_ref = ref_clip.hps_scores(self.clip, self.config["reward_model"], img, ids, self.dtype)
        s_prog = cap["rewards"][t["reward"]][rows]
        out["reward"] = float(np.abs(s_ref.double().cpu().numpy() - s_prog).max())
        out.update(self._check_update(lat, lora0["factors"], scale))
        return out

    def _check_rollout(self, step, rows, lat, log_probs, lora, batch, first=0):
        """``start`` (of every row in ``lat``), ``rollout_step`` and
        ``rollout_log_prob`` (of ``rows``) of iteration ``step``, whose
        latents and log-probs are ``lat`` and ``log_probs`` from the row
        numbered ``first`` on."""
        t, dev = self.traffic, self.device
        n, eta = self.num_steps, t["eta"]
        sig = torch.as_tensor(self.sigmas, device=dev)
        z0 = self._z0(step)[first:first + lat.shape[0]].cpu()
        out = {"start": float((lat[:, 0] - z0).abs().max())}
        step_gap, lp_gap = 0.0, 0.0
        last_sde = max(self.window)
        chunk = t["rollout_chunk"]
        for r in rows:
            z = lat[r - first].to(dev)
            v = torch.cat([self._velocity(z[c:min(c + 6, n)],
                                          ref_grpo.model_time(sig[c:min(c + 6, n)]), lora, batch)
                           for c in range(0, n, 6)])
            x0 = z[:n] - sig[:n, None, None] * v
            for i in range(n):
                if i <= last_sde:
                    mean, std = ref_grpo.sde_mean_std(v[i], z[i], sig[i], sig[i + 1], sig[1], eta)
                    shape = (chunk,) + tuple(z.shape[1:])
                    nxt = mean + std * self.noise(step, r // chunk, i, shape)[r % chunk]
                    lp = ref_grpo.gaussian_log_prob(z[i + 1][None], mean[None], std)
                    lp_gap = max(lp_gap, abs(float(lp) - float(log_probs[r - first, i])))
                else:
                    prev = None if i == n - 1 else x0[i - 1]
                    nxt = ref_grpo.dpmpp_ode(z[i], x0[i], prev, sig[i + 1], sig[i], sig[i - 1])
                step_gap = max(step_gap, float((z[i + 1] - nxt).norm() / (nxt - z[i]).norm()))
        out["rollout_step"], out["rollout_log_prob"] = step_gap, lp_gap
        return out

    def _check_update(self, lat, f0, scale):
        """The first updates again from the program's rollout: each update's
        loss, the first (clipped) gradient and the factors' change."""
        t, cap, dev = self.traffic, self.cap, self.device
        sig = torch.as_tensor(self.sigmas, device=dev)
        adv = torch.as_tensor(ref_grpo.group_advantages(cap["rewards"][t["reward"]],
                                                        t["num_generations"]), device=dev)
        paths = sorted(f0)
        leaves = [f0[p][k].clone().requires_grad_(True) for p in paths for k in ("a", "b")]
        lora = {"factors": {p: {"a": leaves[2 * i], "b": leaves[2 * i + 1]}
                            for i, p in enumerate(paths)}, "scale": scale}
        opt = ref_grpo.AdamW(leaves, t["optim"]["learning_rate"],
                             weight_decay=t["optim"]["weight_decay"],
                             max_norm=t["optim"]["max_grad_norm"])
        acc = t["gradient_accumulation_steps"]
        ts = [s for s in cap["timesteps"] if s < self.num_steps]
        b = cap["batch"]
        txt = torch.as_tensor(b["prompt_embed"][:1]).to(dev, self.dtype)
        pooled = torch.as_tensor(b["pooled"][:1]).to(dev, self.dtype)
        g = torch.full((1,), t["guidance_scale"], device=dev)
        loss_gap, grad_sum, grad1 = 0.0, [0.0] * len(leaves), None
        for k in range(t["check_update_steps"]):
            rows = list(range(k * acc, (k + 1) * acc))
            pairs = [(r, s) for r in rows for s in ts]
            loss = 0.0
            for r, s in pairs:
                z, zn = lat[r, s][None].to(dev), lat[r, s + 1][None].to(dev)
                with torch.enable_grad():
                    v = ref_flux.flux_forward(self.base, self.dims, z, txt, pooled,
                                              ref_grpo.model_time(sig[s:s + 1]), g, self.grid,
                                              lora=lora, checkpoint_blocks=True)
                    mean, std = ref_grpo.sde_mean_std(v, z, sig[s], sig[s + 1], sig[1], t["eta"])
                    lp = ref_grpo.gaussian_log_prob(zn, mean, std)
                    term = ref_grpo.ppo_terms(lp, cap["log_probs"][r, s].to(dev), adv[r],
                                              t["ppo"]["clip_range"], t["ppo"]["adv_clip_max"])
                    term = term.sum() * t["ppo"]["loss_coef"] / len(pairs)
                    term.backward()
                loss += float(term.detach())
            grads = [x.grad.detach().clone() for x in leaves]
            for x in leaves:
                x.grad = None
            clipped = opt.step(grads)
            grad_sum = [a + float(c.norm()) for a, c in zip(grad_sum, clipped)]
            if k == 0:
                grad1 = clipped
            a_mean = float(adv[rows].clamp(-t["ppo"]["adv_clip_max"],
                                           t["ppo"]["adv_clip_max"]).abs().mean())
            loss_gap = max(loss_gap, abs(loss - cap["loss"][k]) / a_mean)
        names = [(p, k) for p in paths for k in ("a", "b")]
        g_ref = [float(x.norm()) for x in grad1]
        g_prog = [float(cap["grad1"][p][k].norm()) for p, k in names]
        d_ref = [float((x.detach() - f0[p][k]).norm()) for x, (p, k) in zip(leaves, names)]
        d_prog = [float((cap["factors3"][p][k] - cap["factors0"][p][k]).norm()) for p, k in names]
        keep = [i for i, s in enumerate(grad_sum) if s >= 1e-3 * float(np.median(grad_sum))]
        return {"update_loss": loss_gap,
                "first_grad": _worst_leaf(g_prog, g_ref, range(len(names))),
                "change": _worst_leaf(d_prog, d_ref, keep)}


def _worst_leaf(prog, ref, keep):
    """The largest gap between the program's and the reference's norm of a
    leaf, over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    med = float(np.median([ref[i] for i in keep]))
    return max(abs(prog[i] - ref[i]) / max(ref[i], med) for i in keep)

