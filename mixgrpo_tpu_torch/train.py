"""MixGRPO training: rollout -> rewards -> advantages -> PPO updates.

Port of mixgrpo_tpu/train.py's ``GRPOTrainer`` on one device.  One
iteration (``train_one_step``):

  1. take a prompt batch from the embedding cache and repeat each prompt
     ``num_generations`` times (a group);
  2. roll the group out with the sliding-window ODE/SDE mask, in chunks of
     ``rollout_chunk`` images (``FluxSampler.chunked_rollout``), keeping
     every latent and the SDE steps' log-probs;
  3. decode the final latents with the VAE and score them with ``reward_fn``;
  4. group-relative advantages with per-model success masks;
  5. optional positive/negative balancing of the sample order;
  6. PPO updates: each accumulation group of (sample, window timestep)
     pairs is one forward and backward, then one AdamW step;
  7. metrics, reward text streams; ``train`` adds the window walk, EMA,
     periodic checkpoints with the window state, and resume.

Randomness comes from ``torch.Generator``s seeded from (``sampler_seed``,
``global_step``, stream), so an iteration is reproducible on one device (the
numbers differ from JAX's ``jax.random``); ``train_one_step(z0=...,
noise_fn=...)`` takes the initial noise and the SDE draws from outside, which
the tests use to hand the port JAX's draws.

Waiting for later slices, and refused here: the reward model zoo (a
``reward_fn`` is required), LoRA, int8 rollouts, DPM-Solver schedules,
profiler traces, the diffusers safetensors export (``"auto"`` skips it with
one warning, ``"required"`` raises), meshes of more than one device; not
ported at all yet: image dumps and the CLI ``main`` (which needs the weight
loaders).
"""

from __future__ import annotations

import json
import os
import signal
import time
import uuid
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from mixgrpo_tpu_torch.config import MeshConfig, TrainConfig, window_state_from_config
from mixgrpo_tpu_torch.data.dataset import PromptLoader
from mixgrpo_tpu_torch.models.flux.latents import denormalize_latents, unpack_latents
from mixgrpo_tpu_torch.models.flux.model import FluxConfig, init_flux, param_leaves
from mixgrpo_tpu_torch.models.flux.vae import VAEConfig, postprocess_images, vae_decode
from mixgrpo_tpu_torch.rl.advantage import (
    global_advantages, group_advantages, masked_mix_advantages, masked_mix_rewards,
)
from mixgrpo_tpu_torch.rl.balance import balance_pos_neg
from mixgrpo_tpu_torch.rl.window import SlidingWindowState
from mixgrpo_tpu_torch.sampler import FluxSampler
from mixgrpo_tpu_torch.solvers.schedule import deterministic_mask, sigma_schedule
from mixgrpo_tpu_torch.trainer import build_update_batch, make_optimizer, make_update_fns
from mixgrpo_tpu_torch.utils.checkpoint import CheckpointManager
from mixgrpo_tpu_torch.utils.ema import ema_init, ema_update
from mixgrpo_tpu_torch.utils.logging import MetricLogger, main_print


def _refuse_unported(cfg: TrainConfig, reward_fn):
    if reward_fn is None:
        raise NotImplementedError("the reward model zoo waits for the port of rewards/; "
                                  "pass reward_fn")
    if cfg.runtime.use_lora:
        raise NotImplementedError("LoRA training waits for the port of lora.py")
    if cfg.grpo.rollout_quant != "none":
        raise NotImplementedError("rollout_quant waits for the port of ops/quant.py")
    if "dpmsolver" in cfg.dpm.dpm_algorithm_type:
        raise NotImplementedError("DPM-Solver schedules wait for the port of solvers/dpm.py")
    if cfg.run.profile_steps > 0:
        raise NotImplementedError("profile_steps waits for the port of utils/profiling.py")
    if cfg.run.export_safetensors == "required":
        raise NotImplementedError("export_safetensors='required': the diffusers export "
                                  "waits for a later slice")
    if cfg.mesh.resolved(1) != MeshConfig(1, 1, 1, 1):
        raise ValueError(f"the port's trainer runs on one device, not mesh {cfg.mesh}")


class GRPOTrainer:
    def __init__(
        self,
        cfg: TrainConfig,
        *,
        flux_cfg: Optional[FluxConfig] = None,
        params=None,
        vae_cfg: Optional[VAEConfig] = None,
        vae_params=None,
        reward_fn: Optional[Callable] = None,
        text_len: int = 512,
        attn_impl: str = "auto",
        dtype=torch.bfloat16,
        device="cuda",
    ):
        """``reward_fn(images01, captions) -> (rewards_dict, successes_dict)``
        (numpy arrays per model) scores the decoded images, (B, H, W, 3) in
        [0, 1] on the device.  ``params`` (fp32 master weights, updated in
        place) default to ``init_flux`` seeded from ``cfg.grpo.seed``."""
        _refuse_unported(cfg, reward_fn)
        self.cfg = cfg
        self.flux_cfg = flux_cfg or FluxConfig.flux_dev()
        self.device = torch.device(device)
        self.dtype = dtype
        if params is None:
            params = init_flux(self.flux_cfg, device=self.device,
                               generator=torch.Generator(self.device).manual_seed(cfg.grpo.seed))
        for t in param_leaves(params):
            t.requires_grad_(True)
        self.params = params

        self.vae_cfg, self.vae_params = vae_cfg, vae_params
        self.reward_fn = reward_fn
        self.reward_weights = cfg.reward.weights()

        self.sampler_cfg = cfg.sampler_config()
        self.sampler = FluxSampler(
            self.flux_cfg, self.sampler_cfg, height=cfg.grpo.h, width=cfg.grpo.w,
            text_len=text_len, guidance_scale=cfg.grpo.guidance_scale, dtype=dtype,
            attn_impl=attn_impl, device=self.device)
        o = cfg.optim
        self.optimizer = make_optimizer(
            learning_rate=o.learning_rate, weight_decay=o.weight_decay,
            max_grad_norm=o.max_grad_norm, lr_scheduler=o.lr_scheduler,
            warmup_steps=o.lr_warmup_steps, total_steps=o.max_train_steps,
            lr_num_cycles=o.lr_num_cycles, lr_power=o.lr_power)
        self.opt_state = self.optimizer.init(self.params)
        self.update_step, self.accum_step, self.apply_step = make_update_fns(
            self.flux_cfg, self.sampler_cfg, cfg.ppo_config(), self.optimizer,
            self.sampler.rope_cos, self.sampler.rope_sin,
            guidance_scale=cfg.grpo.guidance_scale, dtype=dtype, attn_impl=attn_impl,
            remat="dots" if o.gradient_checkpointing else False,
            loss_scale=float(cfg.grpo.loss_coef))
        self.ema_params = ema_init(self.params) if o.ema_decay > 0 else None
        self._export_warned = False
        self.window: SlidingWindowState = window_state_from_config(cfg)
        self.base_sigmas = sigma_schedule(cfg.grpo.sampling_steps, cfg.grpo.shift)
        self.global_step = 0

        self.run_dir = os.path.join(cfg.run.output_dir,
                                    f"{cfg.grpo.training_strategy}_{cfg.run.experiment_name}")
        self.ckpt = CheckpointManager(os.path.join(self.run_dir, "checkpoints"))
        # wandb run id: made once, kept in args.json, reused on resume
        self.wandb_run_id = self._load_or_create_run_id()
        self.metrics = MetricLogger(self.run_dir, run_name=cfg.run.experiment_name,
                                    wandb_key=cfg.run.wandb_key, resume_id=self.wandb_run_id)
        blob = json.loads(cfg.to_json())
        blob["wandb_run_id"] = self.wandb_run_id
        with open(os.path.join(self.run_dir, "args.json"), "w") as f:
            json.dump(blob, f, indent=2)
        if cfg.run.resume_from_checkpoint:
            self._resume()

    # ------------------------------------------------------------------

    def _load_or_create_run_id(self) -> str:
        path = os.path.join(self.run_dir, "args.json")
        if self.cfg.run.resume_from_checkpoint and os.path.exists(path):
            try:
                with open(path) as f:
                    rid = json.load(f).get("wandb_run_id")
                if rid:
                    return rid
            except (OSError, ValueError) as e:
                main_print(f"could not read wandb_run_id from args.json: {e}")
        return uuid.uuid4().hex[:8]

    @torch.no_grad()
    def _resume(self):
        p, o, win_d, step = self.ckpt.restore()
        for dst, src in zip(param_leaves(self.params), param_leaves(p)):
            dst.copy_(src)
        self.opt_state.load_state_dict(o)
        ema = self.ckpt.last_ema()
        if ema is not None and self.ema_params is not None:
            for dst, src in zip(param_leaves(self.ema_params), param_leaves(ema)):
                dst.copy_(src)
        if win_d:
            self.window = SlidingWindowState.from_dict(win_d)
        self.global_step = step
        main_print(f"resumed from step {step}")

    def _generator(self, *stream) -> torch.Generator:
        """A generator seeded from (sampler_seed, global_step, *stream)."""
        ss = np.random.SeedSequence([self.cfg.grpo.sampler_seed, self.global_step, *stream])
        seed = int(ss.generate_state(1, np.uint64)[0])
        return torch.Generator(self.device).manual_seed(seed)

    def _host_rng(self, stream: int) -> np.random.Generator:
        return np.random.default_rng([self.cfg.grpo.sampler_seed, self.global_step, stream])

    @torch.no_grad()
    def _decode(self, latents_packed):
        lat = unpack_latents(latents_packed, self.cfg.grpo.h, self.cfg.grpo.w)
        img = vae_decode(self.vae_params, self.vae_cfg, denormalize_latents(lat),
                         dtype=self.dtype)
        return postprocess_images(img)

    def _schedule_for_window(self, timesteps_train):
        """(sigmas, deterministic, num_steps) of this iteration."""
        T = self.cfg.grpo.sampling_steps
        if self.cfg.grpo.training_strategy == "part":
            det = deterministic_mask(T, timesteps_train)
        else:  # "all" = DanceGRPO: every step SDE
            det = np.zeros(T, dtype=bool)
        return self.base_sigmas, det, T

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------

    def train_one_step(self, batch, timesteps_train=None, *, z0=None,
                       noise_fn: Optional[Callable] = None) -> Dict[str, float]:
        """One GRPO iteration; returns its metrics.  ``z0`` (packed initial
        noise) and ``noise_fn(chunk, step, shape)`` (SDE draws, as
        ``chunked_rollout`` takes them) replace the trainer's own draws."""
        cfg, dev = self.cfg, self.device
        G = cfg.grpo.num_generations if cfg.grpo.use_group else 1
        B = batch["prompt_embed"].shape[0] * G
        # group expansion: each prompt repeated G times, consecutively
        txt = torch.as_tensor(np.repeat(batch["prompt_embed"], G, axis=0)).to(dev, self.dtype)
        pooled = torch.as_tensor(np.repeat(batch["pooled"], G, axis=0)).to(dev, self.dtype)
        captions = [c for c in batch["captions"] for _ in range(G)]

        if timesteps_train is None:
            timesteps_train = self.window.get_current_timesteps()
        sigmas, det, num_steps = self._schedule_for_window(timesteps_train)

        if z0 is None:
            z0 = self.sampler.init_noise(
                self._generator(0), B,
                same_noise_groups=G if cfg.grpo.init_same_noise else None)
        z0 = torch.as_tensor(z0, dtype=torch.float32, device=dev)
        chunk = cfg.grpo.rollout_chunk
        n_chunks = B // chunk if chunk and 0 < chunk < B and B % chunk == 0 else 1
        gens = None if noise_fn is not None else [self._generator(1, j)
                                                  for j in range(n_chunks)]

        t0 = time.perf_counter()
        out = self.sampler.chunked_rollout(self.params, z0, txt, pooled, sigmas, det,
                                           num_steps, gens, chunk=chunk, noise_fn=noise_fn)
        self._sync()
        t1 = time.perf_counter()
        images01 = self._decode(out.final_latents) if self.vae_params is not None \
            else out.final_latents
        self._sync()
        t2 = time.perf_counter()
        main_print(f"##### Sampling time per iteration: {t2 - t0:.2f} s")

        rewards_dict, successes_dict = self.reward_fn(images01, captions)
        # per-model success masks: a failed score leaves the group
        # statistics and gets zero advantage
        rd = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
              for k, v in rewards_dict.items()}
        sd = {k: torch.as_tensor(np.asarray(successes_dict.get(k, np.ones_like(v))),
                                 dtype=torch.float32)
              for k, v in rewards_dict.items()}
        if cfg.grpo.use_group:
            rewards = masked_mix_rewards(rd, sd, self.reward_weights)
            if cfg.reward.multi_reward_mix == "advantage_aggr":
                adv = masked_mix_advantages(rd, sd, self.reward_weights, G,
                                            cfg.grpo.trimmed_ratio)
            else:
                adv = group_advantages(rewards, G, cfg.grpo.trimmed_ratio)
        else:
            if cfg.reward.multi_reward_mix != "reward_aggr":
                raise ValueError("advantage_aggr requires use_group")
            rewards = masked_mix_rewards(rd, sd, self.reward_weights)
            adv = global_advantages(rewards, rewards.reshape(-1))

        # training timesteps; ignore_last drops the final MDP step's pair
        if cfg.grpo.training_strategy == "part":
            train_ts = [t for t in timesteps_train
                        if not (cfg.grpo.ignore_last and t >= num_steps - 1)]
        elif cfg.grpo.frozen_init_timesteps > 0:
            train_ts = list(range(cfg.grpo.frozen_init_timesteps))
        else:
            train_ts = list(range(int(cfg.grpo.sampling_steps * cfg.grpo.timestep_fraction)))

        order = np.arange(B)
        strat = cfg.grpo.advantage_rerange_strategy
        if cfg.grpo.training_strategy == "part" and strat != "null":
            order = balance_pos_neg(adv.numpy(), self._host_rng(2),
                                    use_random=(strat == "random"))
        if cfg.grpo.training_strategy == "all":
            host_rng = self._host_rng(3)
            perms = np.stack([host_rng.permutation(cfg.grpo.sampling_steps)
                              for _ in range(B)])

        accum = max(cfg.optim.gradient_accumulation_steps, 1)
        W = len(train_ts)
        if W == 0:
            main_print(f"empty training window at cur_timestep={self.window.cur_timestep}; "
                       "skipping update")
        agg: Dict[str, float] = {}
        n_updates = 0
        sig_dev = torch.as_tensor(sigmas, dtype=torch.float32, device=dev)
        adv_dev = adv.to(dev)
        for gstart in range(0, B if W > 0 else 0, accum):
            gidx = order[gstart : gstart + accum]
            sample_idx = np.repeat(gidx, W)
            if cfg.grpo.training_strategy == "all":
                t_idx = np.concatenate([perms[i][:W] for i in gidx])
            else:
                t_idx = np.tile(np.asarray(train_ts), len(gidx))
            ub = build_update_batch(out.all_latents, out.all_log_probs, adv_dev, txt, pooled,
                                    sample_idx, t_idx)
            self.params, self.opt_state, m = self.update_step(self.params, self.opt_state,
                                                              ub, sig_dev)
            n_updates += 1
            for k, v in m.items():
                agg[k] = agg.get(k, 0.0) + float(v)
        self._sync()
        t3 = time.perf_counter()

        metrics = {k: v / max(n_updates, 1) for k, v in agg.items()}
        metrics["reward"] = float(rewards.mean())
        for name, vals in rewards_dict.items():
            # success-masked per-model mean
            v = np.asarray(vals, np.float64).reshape(-1)
            s = np.asarray(sd[name], np.float64).reshape(-1)
            metrics[f"reward/{name}"] = float((v * s).sum() / s.sum()) if s.sum() > 0 else 0.0
        metrics["cur_timestep"] = self.window.cur_timestep
        metrics["cur_iter_in_group"] = self.window.cur_iter_in_group
        metrics["sampling_time"] = t2 - t0
        metrics["rollout_time"] = t1 - t0
        metrics["decode_time"] = t2 - t1
        metrics["update_time"] = t3 - t2
        self._dump_reward_stream(captions, rewards_dict, sd, rewards, metrics)
        return metrics

    # ------------------------------------------------------------------

    def _dump_reward_stream(self, captions, rewards_dict, sd, rewards, metrics):
        """Append-only reward text streams: ``rewards.txt`` (per-model means
        per step) and ``rewards_samples_rank0.jsonl`` (every sample's caption
        and scores)."""
        try:
            with open(os.path.join(self.run_dir, "rewards.txt"), "a") as f:
                f.write(f"step {self.global_step}\n")
                for name in rewards_dict:
                    f.write(f"{name}: {metrics[f'reward/{name}']}\n")
                f.write(f"reward: {metrics['reward']}\n")
            mixed = np.asarray(rewards).reshape(-1)
            with open(os.path.join(self.run_dir, "rewards_samples_rank0.jsonl"), "a") as f:
                for i, cap in enumerate(captions):
                    row = {"step": self.global_step, "caption": cap,
                           "reward": float(mixed[i]) if i < len(mixed) else None}
                    for name, vals in rewards_dict.items():
                        row[name] = float(np.asarray(vals).reshape(-1)[i])
                        row[f"{name}_ok"] = float(np.asarray(sd[name]).reshape(-1)[i])
                    f.write(json.dumps(row) + "\n")
        except OSError as e:
            main_print(f"reward stream write failed: {e}")

    def train(self, loader: PromptLoader):
        """Iterate until ``max_train_steps``; SIGTERM/SIGINT finish the
        current iteration, checkpoint and stop."""
        self._preempted = False

        def _on_term(signum, frame):
            self._preempted = True
            main_print(f"signal {signum}: will checkpoint and stop after this iteration")

        prev_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, _on_term)
            except ValueError:  # not the main thread
                pass
        try:
            self._train_loop(self.cfg, iter(loader))
        finally:
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)
        self.save_checkpoint()
        self.close()

    def _train_loop(self, cfg, it):
        while self.global_step < cfg.optim.max_train_steps:
            if self._preempted:
                main_print(f"preempted at step {self.global_step}")
                break
            if self.global_step > 0 and self.global_step % cfg.run.checkpointing_steps == 0:
                self.save_checkpoint(blocking=False)
            # the window is read BEFORE it advances, so the first group gets
            # its full iters_per_group iterations; the seed makes "random"
            # reproducible
            timesteps_train = self.window.get_current_timesteps()
            self.window.update_iteration(rng=cfg.grpo.seed + self.global_step)
            metrics = self.train_one_step(next(it), timesteps_train)
            if self.ema_params is not None:
                ema_update(self.ema_params, self.params, cfg.optim.ema_decay,
                           step=self.global_step, start_step=cfg.optim.ema_start_step)
            metrics.update(self.metrics.tick())
            self.metrics.log(self.global_step, metrics)
            main_print(f"step {self.global_step}: loss={metrics.get('loss', 0):.5f} "
                       f"reward={metrics['reward']:.4f} window@{self.window.cur_timestep}")
            self.global_step += 1

    def save_checkpoint(self, blocking: bool = True):
        self.ckpt.save(self.global_step, self.params, self.opt_state,
                       window_state=self.window.to_dict(), extra={"use_lora": False},
                       ema_params=self.ema_params, blocking=blocking)
        if self.cfg.run.export_safetensors == "auto" and not self._export_warned:
            self._export_warned = True
            warnings.warn("the diffusers safetensors export waits for a later slice and is "
                          "skipped for this run; pass --export_safetensors off to silence")
        main_print(f"checkpoint saved at step {self.global_step}")

    def close(self):
        """Join an in-flight checkpoint write and close the metrics file."""
        self.ckpt.close()
        self.metrics.close()
