"""MixGRPO training: rollout -> rewards -> advantages -> PPO updates.

Port of mixgrpo_tpu/train.py's ``GRPOTrainer``.  One iteration
(``train_one_step``):

  1. take a prompt batch from the embedding cache and repeat each prompt
     ``num_generations`` times (a group);
  2. roll the group out with the sliding-window ODE/SDE mask, in chunks of
     ``rollout_chunk`` images (``FluxSampler.chunked_rollout``), keeping
     every latent and the SDE steps' log-probs;
  3. decode the final latents with the VAE and score them with the reward
     models (``reward_models``, through ``rewards.compute_reward``), or with
     ``reward_fn`` where one is given;
  4. group-relative advantages with per-model success masks;
  5. optional positive/negative balancing of the sample order;
  6. PPO updates: each accumulation group of (sample, window timestep)
     pairs is one forward and backward, then one AdamW step;
  7. metrics, reward text streams; ``train`` adds the window walk, EMA,
     periodic checkpoints with the window state, resume, and a profiler
     trace of ``profile_steps`` iterations (``utils/profiling.py``).

MixGRPO-Flash: with a DPM-Solver algorithm and the "post" strategy the
schedule after the window is compressed (``flash_post_schedule``) and the
rollout runs that tail with DPM-Solver ODE steps; "all" runs every step as a
DPM-Solver step.  ``use_lora=True`` trains a LoRA adapter (``lora.py``) over
a frozen base (which can be bf16 and needs no grads): the rollout runs on
the merged weights, made once per iteration and freed before the decode;
the update merges each block's factors inside the block; EMA is off.

Randomness comes from ``torch.Generator``s seeded from (``sampler_seed``,
``global_step``, stream), so an iteration is reproducible on one device (the
numbers differ from JAX's ``jax.random``); ``train_one_step(z0=...,
noise_fn=...)`` takes the initial noise and the SDE draws from outside, which
the tests use to hand the port JAX's draws.

Each checkpoint also exports the parameters as a diffusers safetensors file
(``export_<step>/diffusion_pytorch_model.safetensors``, F32) unless
``cfg.run.export_safetensors`` is ``"off"``; with ``"auto"`` a failed export
warns once and is skipped for the rest of the run, with ``"required"`` it
raises.  As in JAX, a LoRA run exports the frozen base (its factors are in
the checkpoint).

``main`` is the CLI (``python -m mixgrpo_tpu_torch.train``, the reference's
flag names plus ``--device``, default ``cuda``): the FLUX transformer and VAE
of ``--pretrained_model_name_or_path`` (fp32 masters, or the base at the
compute dtype under LoRA), the reward models of ``--reward_model``
(``build_reward_models``) and the embedding cache of ``--data_json_path``.

With ``cfg.grpo.rollout_quant == "int8"`` the rollout runs on int8 block
matmuls (``ops/quant.py``), quantised each iteration after the LoRA merge;
the quantised network is the behaviour policy whose log-probs the PPO ratio
divides by, and the update stays bf16 over the fp32 masters.

On a mesh (``cfg.mesh``, one process per device, ``parallel/``) each rank
rolls out, decodes and scores its own prompt shard (each batch rank's noise
comes from generators that also take its batch rank, as JAX folds in the
process index), the FSDP update averages the gradients over the batch ranks,
and the reward means, ``global_advantages``' statistics and the metrics are
taken over every batch rank.  The parameters, the optimizer state and the
EMA parameters are each rank's fsdp shards (``parallel/sharding.py``); the
rollout gathers the whole tree once per iteration in the compute dtype.
Only rank 0 logs, writes ``args.json`` and ``rewards.txt`` and exports;
every rank writes its own ``rewards_samples_rank{r}.jsonl`` and checkpoint
shard.  Under LoRA the base and the adapter stay whole on every rank.
Refused: tensor parallelism (``tp > 1``, ROADMAP item 8b).
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import time
import uuid
import warnings
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from mixgrpo_tpu_torch.config import TrainConfig, window_state_from_config
from mixgrpo_tpu_torch.data.dataset import PromptLoader
from mixgrpo_tpu_torch.lora import apply_lora, init_lora
from mixgrpo_tpu_torch.models.flux.latents import denormalize_latents, unpack_latents
from mixgrpo_tpu_torch.models.flux.model import FluxConfig, init_flux, param_leaves
from mixgrpo_tpu_torch.models.flux.vae import VAEConfig, postprocess_images, vae_decode
from mixgrpo_tpu_torch.ops.quant import quantize_flux_params
from mixgrpo_tpu_torch.parallel.collectives import gather_objects
from mixgrpo_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from mixgrpo_tpu_torch.parallel.sharding import (
    flux_param_specs, gather_params, set_activation_mesh, shard_params,
)
from mixgrpo_tpu_torch.parallel.ulysses import set_sp_context
from mixgrpo_tpu_torch.rl.advantage import (
    global_advantages, group_advantages, masked_mix_advantages, masked_mix_rewards,
)
from mixgrpo_tpu_torch.rl.balance import balance_pos_neg
from mixgrpo_tpu_torch.rl.window import SlidingWindowState
from mixgrpo_tpu_torch.sampler import FluxSampler
from mixgrpo_tpu_torch.solvers.schedule import (
    deterministic_mask, flash_post_schedule, sigma_schedule,
)
from mixgrpo_tpu_torch.trainer import (
    build_update_batch, make_lora_update_fns, make_optimizer, make_update_fns,
)
from mixgrpo_tpu_torch.utils import profiling
from mixgrpo_tpu_torch.utils.checkpoint import CheckpointManager, export_flux_safetensors
from mixgrpo_tpu_torch.utils.ema import ema_init, ema_update
from mixgrpo_tpu_torch.utils.logging import MetricLogger, main_print


def _refuse_unported(cfg: TrainConfig, reward_fn, reward_models):
    if reward_fn is None and not reward_models:
        raise ValueError("GRPOTrainer needs reward_models (see build_reward_models) or a "
                         "reward_fn")
    if cfg.grpo.rollout_quant not in ("none", "int8"):
        raise ValueError(f"unknown rollout_quant {cfg.grpo.rollout_quant!r}")
    _refuse_tp(cfg.mesh)


def _refuse_tp(mesh_cfg):
    if mesh_cfg.tp > 1:
        raise ValueError(f"mesh {mesh_cfg}: tensor parallelism (tp > 1) waits for ROADMAP "
                         "item 8b (the Megatron split of the FLUX blocks)")


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
        reward_models: Optional[Mapping] = None,
        text_len: int = 512,
        attn_impl: str = "auto",
        dtype=torch.bfloat16,
        device="cuda",
        use_lora: Optional[bool] = None,
        lora_rank: Optional[int] = None,
        lora_alpha: Optional[float] = None,
    ):
        """``reward_models`` (name -> model, as ``build_reward_models`` makes
        them) score the decoded images, (B, H, W, 3) in [0, 1] on the device;
        ``reward_fn(images01, captions) -> (rewards_dict, successes_dict)``
        (numpy arrays per model), where given, replaces them.  ``params``
        (fp32 master weights, updated in
        place; under LoRA the frozen base, any dtype) default to
        ``init_flux`` seeded from ``cfg.grpo.seed``.  ``use_lora`` trains a
        rank-``lora_rank`` adapter over ``lora.DEFAULT_TARGETS``, its ``a``
        factors drawn from ``cfg.grpo.seed + 1``; each of the three defaults
        to its field of ``cfg.runtime``."""
        _refuse_unported(cfg, reward_fn, reward_models)
        rt = cfg.runtime
        use_lora = rt.use_lora if use_lora is None else use_lora
        lora_rank = rt.lora_rank if lora_rank is None else lora_rank
        lora_alpha = rt.lora_alpha if lora_alpha is None else lora_alpha
        self.cfg = cfg
        self.flux_cfg = flux_cfg or FluxConfig.flux_dev()
        self.device = torch.device(device)
        self.dtype = dtype
        self.mesh: Mesh = make_mesh(cfg.mesh, device=self.device)
        _refuse_tp(self.mesh.cfg)
        set_activation_mesh(self.mesh)
        set_sp_context(self.mesh, "sp")
        if params is None:
            params = init_flux(self.flux_cfg, device=self.device,
                               generator=torch.Generator(self.device).manual_seed(cfg.grpo.seed))
        # fsdp shards of the trained tree (the LoRA base stays whole)
        self.sharded = self.mesh.world > 1 and not use_lora
        self.param_specs = flux_param_specs(params, self.mesh) if self.sharded else None
        if self.sharded:
            params = shard_params(params, self.mesh, self.param_specs)
        if not use_lora:
            for t in param_leaves(params):
                t.requires_grad_(True)
        self.params = params

        self.vae_cfg, self.vae_params = vae_cfg, vae_params
        self.reward_fn = reward_fn
        self.reward_models = dict(reward_models or {})
        self.save_images = False
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
        kw = dict(guidance_scale=cfg.grpo.guidance_scale, dtype=dtype, attn_impl=attn_impl,
                  remat="dots" if o.gradient_checkpointing else False,
                  loss_scale=float(cfg.grpo.loss_coef))
        self.use_lora = use_lora
        if use_lora:
            lora = init_lora(torch.Generator(self.device).manual_seed(cfg.grpo.seed + 1),
                             self.params, rank=lora_rank, alpha=lora_alpha)
            self.lora_factors = lora["factors"]
            self.lora_meta = {"rank": lora["rank"], "alpha": lora["alpha"]}
            self.opt_state = self.optimizer.init(self.lora_factors)
            self.lora_update = make_lora_update_fns(
                self.flux_cfg, self.sampler_cfg, cfg.ppo_config(), self.optimizer,
                self.sampler.rope_cos, self.sampler.rope_sin, mesh=self.mesh, **kw)
        else:
            self.opt_state = self.optimizer.init(self.params)
            self.update_step, self.accum_step, self.apply_step = make_update_fns(
                self.flux_cfg, self.sampler_cfg, cfg.ppo_config(), self.optimizer,
                self.sampler.rope_cos, self.sampler.rope_sin, mesh=self.mesh,
                param_specs=self.param_specs, **kw)
        self.ema_params = ema_init(self.params) if o.ema_decay > 0 and not use_lora else None
        self.profile_trace: Optional[profiling.Trace] = None  # the last trace written
        self._export_warned = False
        self.window: SlidingWindowState = window_state_from_config(cfg)
        self.base_sigmas = sigma_schedule(cfg.grpo.sampling_steps, cfg.grpo.shift)
        self.global_step = 0

        self.run_dir = os.path.join(cfg.run.output_dir,
                                    f"{cfg.grpo.training_strategy}_{cfg.run.experiment_name}")
        self.ckpt = CheckpointManager(os.path.join(self.run_dir, "checkpoints"),
                                      mesh=self.mesh if self.mesh.world > 1 else None)
        # wandb run id: made once, kept in args.json, reused on resume
        self.wandb_run_id = self._load_or_create_run_id()
        self.metrics = MetricLogger(self.run_dir, run_name=cfg.run.experiment_name,
                                    wandb_key=cfg.run.wandb_key, resume_id=self.wandb_run_id)
        if self.mesh.rank == 0:
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
        trained = self.lora_factors if self.use_lora else self.params
        for dst, src in zip(param_leaves(trained), param_leaves(p)):
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
        """A generator seeded from (sampler_seed, global_step, *stream), and
        the batch rank when there is more than one, so that each prompt shard
        draws its own noise (the ranks of one ``sp`` group draw alike)."""
        rank = (self.mesh.batch_index,) if self.mesh.batch_size > 1 else ()
        ss = np.random.SeedSequence([self.cfg.grpo.sampler_seed, self.global_step, *stream,
                                     *rank])
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
        dpm = self.cfg.dpm
        if "dpmsolver" in dpm.dpm_algorithm_type and dpm.dpm_apply_strategy == "post":
            sig, n, det = flash_post_schedule(self.base_sigmas, det, self.cfg.grpo.shift,
                                              dpm.dpm_post_compress_ratio, pad_to=T)
            return sig, det, n
        return self.base_sigmas, det, T

    def _compute_rewards(self, images01, captions):
        """(rewards_dict, successes_dict) of numpy arrays."""
        if self.reward_fn is not None:
            return self.reward_fn(images01, captions)
        from mixgrpo_tpu_torch.rewards.base import compute_reward

        _, _, rd, sd = compute_reward(images01, captions, self.reward_models,
                                      self.reward_weights)
        return ({k: np.asarray(v) for k, v in rd.items()},
                {k: np.asarray(v) for k, v in sd.items()})

    def _save_first_image(self, images01):
        """The first decoded image of each step and rank,
        ``images/flux_<step>_<rank>.png``;
        best effort: a failure is printed and skipped."""
        try:
            from PIL import Image

            img_dir = os.path.join(self.run_dir, "images")
            os.makedirs(img_dir, exist_ok=True)
            arr = images01[0].float().cpu().numpy()
            Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(img_dir, f"flux_{self.global_step}_{self.mesh.rank}.png"))
        except Exception as e:  # image dumps are observability, not training
            main_print(f"image save skipped: {e}")

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
        with profiling.annotate("rollout"):
            # the LoRA policy: merged once, freed before the decode and update
            rollout_params = self.params
            if self.sharded:
                rollout_params = gather_params(self.params, self.mesh, self.param_specs,
                                               self.dtype)
            if self.use_lora:
                with torch.no_grad():
                    rollout_params = apply_lora(self.params, {**self.lora_meta,
                                                              "factors": self.lora_factors})
            if cfg.grpo.rollout_quant == "int8":
                rollout_params = quantize_flux_params(rollout_params)
            out = self.sampler.chunked_rollout(rollout_params, z0, txt, pooled, sigmas, det,
                                               num_steps, gens, chunk=chunk, noise_fn=noise_fn)
            del rollout_params
            self._sync()
        t1 = time.perf_counter()
        with profiling.annotate("decode"):
            images01 = self._decode(out.final_latents) if self.vae_params is not None \
                else out.final_latents
            self._sync()
        t2 = time.perf_counter()
        main_print(f"##### Sampling time per iteration: {t2 - t0:.2f} s")
        if self.vae_params is not None and self.save_images:
            self._save_first_image(images01)

        with profiling.annotate("reward"):
            rewards_dict, successes_dict = self._compute_rewards(images01, captions)
            self._sync()
        t_r = time.perf_counter()
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
            every = np.concatenate(gather_objects(rewards.numpy().reshape(-1), self.mesh))
            adv = global_advantages(rewards, torch.as_tensor(every))

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
        with profiling.annotate("update"):
            for gstart in range(0, B if W > 0 else 0, accum):
                gidx = order[gstart : gstart + accum]
                sample_idx = np.repeat(gidx, W)
                if cfg.grpo.training_strategy == "all":
                    t_idx = np.concatenate([perms[i][:W] for i in gidx])
                else:
                    t_idx = np.tile(np.asarray(train_ts), len(gidx))
                ub = build_update_batch(out.all_latents, out.all_log_probs, adv_dev, txt,
                                        pooled, sample_idx, t_idx)
                if self.use_lora:
                    self.lora_factors, self.opt_state, m = self.lora_update(
                        self.lora_factors, self.opt_state, self.lora_meta, self.params, ub,
                        sig_dev)
                else:
                    self.params, self.opt_state, m = self.update_step(
                        self.params, self.opt_state, ub, sig_dev)
                n_updates += 1
                for k, v in m.items():
                    agg[k] = agg.get(k, 0.0) + float(v)
            self._sync()
        t3 = time.perf_counter()

        metrics = {k: v / max(n_updates, 1) for k, v in agg.items()}
        # the reward means are over every batch rank's rows
        gathered = gather_objects(
            (rewards.numpy().reshape(-1),
             {k: (np.asarray(v, np.float64).reshape(-1), sd[k].numpy().reshape(-1))
              for k, v in rewards_dict.items()}), self.mesh)
        metrics["reward"] = float(np.concatenate([g[0] for g in gathered]).mean())
        for name in rewards_dict:
            # success-masked per-model mean
            v = np.concatenate([g[1][name][0] for g in gathered]).astype(np.float64)
            s = np.concatenate([g[1][name][1] for g in gathered]).astype(np.float64)
            metrics[f"reward/{name}"] = float((v * s).sum() / s.sum()) if s.sum() > 0 else 0.0
        metrics["cur_timestep"] = self.window.cur_timestep
        metrics["cur_iter_in_group"] = self.window.cur_iter_in_group
        metrics["sampling_time"] = t2 - t0
        metrics["rollout_time"] = t1 - t0
        metrics["decode_time"] = t2 - t1
        metrics["reward_time"] = t_r - t2
        metrics["update_time"] = t3 - t_r
        metrics["num_steps"] = num_steps
        self._dump_reward_stream(captions, rewards_dict, sd, rewards, metrics)
        return metrics

    # ------------------------------------------------------------------

    def _dump_reward_stream(self, captions, rewards_dict, sd, rewards, metrics):
        """Append-only reward text streams: ``rewards.txt`` (rank 0: the
        per-model means over every rank per step) and
        ``rewards_samples_rank{r}.jsonl`` (every rank: each of its samples'
        caption and scores)."""
        try:
            if self.mesh.rank == 0:
                with open(os.path.join(self.run_dir, "rewards.txt"), "a") as f:
                    f.write(f"step {self.global_step}\n")
                    for name in rewards_dict:
                        f.write(f"{name}: {metrics[f'reward/{name}']}\n")
                    f.write(f"reward: {metrics['reward']}\n")
            mixed = np.asarray(rewards).reshape(-1)
            path = os.path.join(self.run_dir, f"rewards_samples_rank{self.mesh.rank}.jsonl")
            with open(path, "a") as f:
                for i, cap in enumerate(captions):
                    row = {"step": self.global_step, "caption": cap,
                           "reward": float(mixed[i]) if i < len(mixed) else None}
                    for name, vals in rewards_dict.items():
                        row[name] = float(np.asarray(vals).reshape(-1)[i])
                        row[f"{name}_ok"] = float(np.asarray(sd[name]).reshape(-1)[i])
                    f.write(json.dumps(row) + "\n")
        except OSError as e:
            main_print(f"reward stream write failed: {e}")

    def train(self, loader: PromptLoader, save_images: bool = False):
        """Iterate until ``max_train_steps`` (``save_images``: the first
        decoded image of each step to ``<run_dir>/images``); SIGTERM/SIGINT
        finish the current iteration, checkpoint and stop.  With ``profile_steps`` > 0
        the iterations from ``global_step + 1`` on (the first one of this
        call is skipped: it allocates and warms up) are traced into
        ``profile_dir`` (default ``<run_dir>/profile``); the trace is closed
        and written even when an iteration raises."""
        self._preempted = False
        self.save_images = save_images

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
            with contextlib.ExitStack() as prof:
                self._train_loop(self.cfg, iter(loader), prof)
        finally:
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)
        self.save_checkpoint()
        self.close()

    def _train_loop(self, cfg, it, prof: contextlib.ExitStack):
        prof_start, prof_until = self.global_step + 1, None
        while self.global_step < cfg.optim.max_train_steps:
            if self._preempted:
                main_print(f"preempted at step {self.global_step}")
                break
            if cfg.run.profile_steps > 0 and self.global_step == prof_start:
                prof_dir = cfg.run.profile_dir or os.path.join(self.run_dir, "profile")
                self.profile_trace = prof.enter_context(profiling.trace(prof_dir))
                prof_until = prof_start + cfg.run.profile_steps
                main_print(f"profiler trace -> {prof_dir}")
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
            if prof_until is not None and self.global_step >= prof_until:
                prof.close()  # writes the trace
                prof_until = None

    def save_checkpoint(self, blocking: bool = True):
        trained = self.lora_factors if self.use_lora else self.params
        self.ckpt.save(self.global_step, trained, self.opt_state,
                       window_state=self.window.to_dict(), extra={"use_lora": self.use_lora},
                       ema_params=self.ema_params, blocking=blocking)
        mode = self.cfg.run.export_safetensors
        if mode != "off" and not self._export_warned:
            path = os.path.join(self.run_dir, f"export_{self.global_step}",
                                "diffusion_pytorch_model.safetensors")
            try:
                export_flux_safetensors(self.params, self.flux_cfg, path, mesh=self.mesh,
                                        specs=self.param_specs)
            except Exception as e:
                if mode == "required":
                    raise RuntimeError(f"safetensors export failed at step {self.global_step} "
                                       f"(--export_safetensors required): {e}") from e
                # auto: warn once and skip the export for the rest of the run
                self._export_warned = True
                warnings.warn(f"diffusers safetensors export FAILED and will be skipped for "
                              f"the rest of this run: {e!r}.  Pass --export_safetensors off "
                              "to silence, or required to make this fatal; checkpoints are "
                              "unaffected.")
        main_print(f"checkpoint saved at step {self.global_step}")

    def close(self):
        """Join an in-flight checkpoint write and close the metrics file."""
        self.ckpt.close()
        self.metrics.close()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def find_bert_vocab_dir(*paths: Optional[str]) -> str:
    """The first directory of ``paths`` (files or directories) that holds a
    ``vocab.txt`` or a ``tokenizer.json``; raises naming every directory
    searched when none does."""
    dirs = []
    for p in paths:
        if not p:
            continue
        d = p if os.path.isdir(p) else os.path.dirname(os.path.abspath(p))
        if d in dirs:
            continue
        dirs.append(d)
        if any(os.path.exists(os.path.join(d, n)) for n in ("vocab.txt", "tokenizer.json")):
            return d
    raise FileNotFoundError(f"image_reward needs its BERT tokenizer: no vocab.txt or "
                            f"tokenizer.json in {dirs}")


def build_reward_models(cfg: TrainConfig, device="cuda", names=None,
                        merges: Optional[str] = None) -> Dict[str, object]:
    """The reward models ``names`` (default ``cfg.reward.active_models()``)
    from ``cfg.reward``'s paths, loaded to ``device`` (bf16 on a card, f32
    on the CPU).

    Every tokenizer is found here, and a missing one raises here: the CLIP
    merges for HPS, PickScore and CLIP-score (``merges``, else found as JAX
    finds them: ``CLIP_BPE_PATH``, else ``<pretrained>/tokenizer/merges.txt``)
    and ImageReward's BERT vocabulary (``vocab.txt`` or ``tokenizer.json``
    beside ``image_reward_med_config`` or ``image_reward_path``).  JAX's
    ``build_reward_models`` passes ImageReward no vocabulary
    (``mixgrpo_tpu/train.py:734-739``), so its first reward call fails on
    ``assert self.tokenizer is not None``."""
    from mixgrpo_tpu_torch.rewards import (
        CLIPScoreReward, HPSReward, PickScoreReward, UnifiedReward,
    )
    from mixgrpo_tpu_torch.rewards.image_reward import ImageRewardModel

    r = cfg.reward
    active = names or r.active_models()
    kw = dict(device=device)
    if {"hpsv2", "pick_score", "clip_score"} & set(active):
        cand = os.path.join(cfg.paths.pretrained_model_name_or_path, "tokenizer", "merges.txt")
        merges = merges or os.environ.get("CLIP_BPE_PATH") or (
            cand if os.path.exists(cand) else None)
        if merges is None:
            raise FileNotFoundError(
                "the CLIP reward models need the CLIP BPE table: pass its path, set "
                f"CLIP_BPE_PATH or put it at {cand}")
    vocab_dir = None
    if "image_reward" in active:
        vocab_dir = find_bert_vocab_dir(r.image_reward_med_config, r.image_reward_path)
    out = {}
    if "hpsv2" in active:
        out["hpsv2"] = HPSReward.from_checkpoint(r.hps_path, merges, **kw)
    if "pick_score" in active:
        out["pick_score"] = PickScoreReward.from_checkpoint(r.pick_score_path, merges, **kw)
    if "clip_score" in active:
        out["clip_score"] = CLIPScoreReward.from_checkpoint(r.clip_score_path, merges, **kw)
    if "unified_reward" in active and r.unified_reward_url:
        out["unified_reward"] = UnifiedReward(
            r.unified_reward_url, r.unified_reward_default_question_type or "score",
            r.unified_reward_num_workers)
    if "image_reward" in active:
        out["image_reward"] = ImageRewardModel.from_checkpoint(
            r.image_reward_path, r.image_reward_med_config, vocab_dir, **kw)
    return out


def main(argv=None, family=None):
    """Train from a FLUX directory and an embedding cache.  ``family``
    defaults to ``presets.flux_family()`` (``MIXGRPO_MODEL_PRESET``).
    Returns the trainer, closed, after its last checkpoint."""
    from mixgrpo_tpu_torch.config import build_arg_parser, config_from_args
    from mixgrpo_tpu_torch.data.dataset import LatentDataset
    from mixgrpo_tpu_torch.models.flux.load import load_flux_params, load_vae_decoder_params
    from mixgrpo_tpu_torch.parallel.mesh import default_device
    from mixgrpo_tpu_torch.preprocess import compute_dtype
    from mixgrpo_tpu_torch.presets import flux_family

    p = build_arg_parser()
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (each rank takes cuda:<LOCAL_RANK mod cards>) or cpu")
    args = p.parse_args(argv)
    cfg = config_from_args(args)

    fam = family or flux_family()
    dev = default_device() if args.device == "cuda" else torch.device(args.device)
    # rendezvous from torchrun's environment; a no-op for one process
    init_distributed(device=dev)
    dtype = compute_dtype(args.device)
    root = cfg.paths.pretrained_model_name_or_path
    flux_cfg, vae_cfg = fam["flux"], fam["vae"]
    reward_models = build_reward_models(cfg, device=dev)
    # fp32 master weights; under LoRA the frozen base at the compute dtype
    params = load_flux_params(cfg.paths.dit_model_name_or_path or
                              os.path.join(root, "transformer"), flux_cfg,
                              dtype=dtype if cfg.runtime.use_lora else torch.float32,
                              device=dev)
    vae_params = load_vae_decoder_params(cfg.paths.vae_model_path or os.path.join(root, "vae"),
                                         vae_cfg, dtype=dtype, device=dev)
    trainer = GRPOTrainer(cfg, flux_cfg=flux_cfg, params=params, vae_cfg=vae_cfg,
                          vae_params=vae_params, reward_models=reward_models,
                          attn_impl=cfg.runtime.attn_impl, dtype=dtype, device=dev)
    ds = LatentDataset(cfg.data.data_json_path, cfg_rate=cfg.data.cfg_rate, seed=cfg.grpo.seed)
    # each batch rank (dp x fsdp) its own prompt shard; the ranks of one sp
    # group share theirs
    mesh = trainer.mesh
    trainer.train(PromptLoader(ds, cfg.data.train_batch_size, seed=cfg.grpo.seed,
                               process_index=mesh.batch_index,
                               process_count=mesh.batch_size))
    return trainer


if __name__ == "__main__":
    main()
