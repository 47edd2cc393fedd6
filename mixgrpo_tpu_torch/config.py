"""Training configuration: the reference's flag surface as dataclasses.

Port of mixgrpo_tpu/config.py: the same dataclasses, defaults (the MixGRPO
recipe: 720px, 25 steps, eta 0.7, 12 generations, a 4-step window,
accumulation 3, gradient checkpointing, bf16 compute over fp32 master
weights) and CLI flag names, so launch scripts carry over.  ``MeshConfig`` is
a local copy (JAX imports it from ``parallel/``, which is not ported); the
port's trainer takes one device only.  ``RuntimeConfig.attn_impl`` takes the
port's backends (``auto``, ``flash``, ``eager``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Optional

from mixgrpo_tpu_torch.rl.ppo import PPOConfig
from mixgrpo_tpu_torch.solvers.rollout import SamplerConfig


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh sizes, kept from mixgrpo_tpu/parallel/mesh.py so that the
    flags and the saved config match; the port's trainer runs on one device
    and refuses any other mesh until ``parallel/`` is ported."""

    dp: int = -1  # -1: use all remaining devices
    fsdp: int = 1
    sp: int = 1
    tp: int = 1

    def resolved(self, n_devices: int) -> "MeshConfig":
        """Resolve one ``-1`` axis to "all remaining devices"."""
        sizes = {"dp": self.dp, "fsdp": self.fsdp, "sp": self.sp, "tp": self.tp}
        free = [k for k, v in sizes.items() if v == -1]
        if len(free) > 1:
            raise ValueError(f"at most one -1 mesh axis, got {free}")
        if free:
            known = 1
            for k, v in sizes.items():
                if k != free[0]:
                    known *= v
            if n_devices % known:
                raise ValueError(f"{n_devices} devices do not divide by {known}")
            sizes[free[0]] = n_devices // known
        total = sizes["dp"] * sizes["fsdp"] * sizes["sp"] * sizes["tp"]
        if total != n_devices:
            raise ValueError(f"mesh {sizes} needs {total} devices, not {n_devices}")
        return MeshConfig(**sizes)


@dataclasses.dataclass
class DataConfig:
    data_json_path: str = ""
    dataloader_num_workers: int = 10
    train_batch_size: int = 1
    num_latent_t: int = 1
    cfg_rate: float = 0.0  # --cfg: prompt-embedding dropout


@dataclasses.dataclass
class ModelPathsConfig:
    pretrained_model_name_or_path: str = ""
    dit_model_name_or_path: Optional[str] = None
    vae_model_path: Optional[str] = None
    cache_dir: str = "./cache_dir"


@dataclasses.dataclass
class OptimConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 1e-4
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 3
    lr_scheduler: str = "constant_with_warmup"
    lr_warmup_steps: int = 0
    lr_num_cycles: int = 1
    lr_power: float = 1.0
    max_train_steps: int = 300
    mixed_precision: str = "bf16"
    master_weight_type: str = "fp32"
    gradient_checkpointing: bool = True
    selective_checkpointing: float = 1.0
    ema_decay: float = 0.0  # 0 disables EMA (reference default 0.995, unused)
    ema_start_step: int = 0
    allow_tf32: bool = True
    use_cpu_offload: bool = False


@dataclasses.dataclass
class GRPOConfig:
    h: int = 720
    w: int = 720
    t: int = 1
    sampling_steps: int = 25
    eta: float = 0.7
    seed: int = 714
    sampler_seed: int = 7144
    loss_coef: float = 1.0
    use_group: bool = True
    num_generations: int = 12
    ignore_last: bool = False
    init_same_noise: bool = True
    shift: float = 3.0
    timestep_fraction: float = 0.6
    clip_range: float = 1e-4
    adv_clip_max: float = 5.0
    advantage_rerange_strategy: str = "null"  # null|random|balance
    flow_grpo_sampling: bool = True
    drop_last_sample: bool = False
    trimmed_ratio: float = 0.0
    training_strategy: str = "part"  # part=MixGRPO, all=DanceGRPO
    frozen_init_timesteps: int = -1
    kl_coeff: float = 0.0
    guidance_scale: float = 3.5
    # "int8": rollout weights in int8 (ops/quant.py; the quantized net is the
    # behaviour policy)
    rollout_quant: str = "none"  # none|int8
    # images per rollout call: the group rollout runs as G/chunk calls in
    # row order (sampler.FluxSampler.chunked_rollout); 0 = the whole group
    # in one call, as is any chunk that does not divide the group
    rollout_chunk: int = 2


@dataclasses.dataclass
class WindowConfig:
    iters_per_group: int = 25
    group_size: int = 4
    sample_strategy: str = "progressive"  # progressive|random|decay|exp_decay
    prog_overlap: bool = True
    prog_overlap_step: int = 1
    max_iters_per_group: int = 10
    min_iters_per_group: int = 1
    roll_back: bool = True
    exp_decay_thre_timestep: int = 13
    exp_decay_k: float = 0.1


@dataclasses.dataclass
class DPMConfig:
    dpm_algorithm_type: str = "null"  # null|dpmsolver|dpmsolver++
    dpm_apply_strategy: str = "post"  # post|all
    dpm_post_compress_ratio: float = 0.4
    dpm_solver_order: int = 2
    dpm_solver_type: str = "midpoint"  # midpoint|heun


@dataclasses.dataclass
class RewardConfig:
    reward_model: str = "multi_reward"
    hps_path: str = "hps_ckpt/HPS_v2.1_compressed.pt"
    hps_clip_path: str = "hps_ckpt/open_clip_pytorch_model.bin"
    clip_score_path: str = "hf-hub:apple/DFN5B-CLIP-ViT-H-14-384"
    pick_score_path: str = "./pickscore_ckpt"  # local PickScore_v1 dir
    image_reward_path: str = "./image_reward_ckpt/ImageReward.pt"
    image_reward_med_config: str = "./image_reward_ckpt/med_config.json"
    unified_reward_url: Optional[str] = None
    unified_reward_default_question_type: Optional[str] = None
    unified_reward_num_workers: int = 1
    multi_reward_mix: str = "advantage_aggr"  # advantage_aggr|reward_aggr
    hps_weight: float = 1.0
    clip_score_weight: float = 1.0
    image_reward_weight: float = 1.0
    pick_score_weight: float = 1.0
    unified_reward_weight: float = 1.0

    def weights(self) -> Dict[str, float]:
        return {
            "hpsv2": self.hps_weight,
            "clip_score": self.clip_score_weight,
            "image_reward": self.image_reward_weight,
            "pick_score": self.pick_score_weight,
            "unified_reward": self.unified_reward_weight,
        }

    def active_models(self) -> List[str]:
        table = {
            "hpsv2": ["hpsv2"],
            "clip_score": ["clip_score"],
            "image_reward": ["image_reward"],
            "pick_score": ["pick_score"],
            "unified_reward": ["unified_reward"],
            "hpsv2_clip_score": ["hpsv2", "clip_score"],
            "multi_reward": ["hpsv2", "clip_score", "image_reward", "pick_score"],
        }
        return table[self.reward_model]


@dataclasses.dataclass
class RuntimeConfig:
    """Runtime knobs with no reference counterpart (the reference hardcodes
    flash-attn CUDA and wires LoRA through peft + env).  ``GRPOTrainer``
    reads the LoRA fields where its ``use_lora``, ``lora_rank`` and
    ``lora_alpha`` keywords are not given."""

    attn_impl: str = "auto"  # auto|flash|eager
    use_lora: bool = False
    lora_rank: int = 16
    lora_alpha: float = 16.0


@dataclasses.dataclass
class RunConfig:
    output_dir: str = "./out"
    experiment_name: str = "test"
    checkpointing_steps: int = 50
    resume_from_checkpoint: Optional[str] = None
    logging_dir: str = "logs"
    wandb_key: Optional[str] = None
    # a torch.profiler trace of N iterations, from the second of a run on
    profile_steps: int = 0
    profile_dir: Optional[str] = None  # default: <run_dir>/profile
    # diffusers-layout safetensors export at each checkpoint: waits for the
    # port of the exporter, so "auto" skips it with one warning, "off" never
    # tries, and "required" raises
    export_safetensors: str = "auto"
    sp_size: int = 1
    train_sp_batch_size: int = 1
    fsdp_sharding_strategy: str = "full"


@dataclasses.dataclass
class TrainConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    paths: ModelPathsConfig = dataclasses.field(default_factory=ModelPathsConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    grpo: GRPOConfig = dataclasses.field(default_factory=GRPOConfig)
    window: WindowConfig = dataclasses.field(default_factory=WindowConfig)
    dpm: DPMConfig = dataclasses.field(default_factory=DPMConfig)
    reward: RewardConfig = dataclasses.field(default_factory=RewardConfig)
    run: RunConfig = dataclasses.field(default_factory=RunConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def sampler_config(self) -> SamplerConfig:
        return SamplerConfig(
            num_steps_max=self.grpo.sampling_steps,
            eta=self.grpo.eta,
            flow_grpo_sampling=self.grpo.flow_grpo_sampling,
            dpm_algorithm_type=self.dpm.dpm_algorithm_type,
            dpm_apply_strategy=self.dpm.dpm_apply_strategy,
            dpm_solver_order=self.dpm.dpm_solver_order,
            dpm_solver_type=self.dpm.dpm_solver_type,
            drop_last_sample=self.grpo.drop_last_sample,
        )

    def ppo_config(self) -> PPOConfig:
        return PPOConfig(
            clip_range=self.grpo.clip_range,
            adv_clip_max=self.grpo.adv_clip_max,
            kl_coeff=self.grpo.kl_coeff,
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        kw = {}
        for f in dataclasses.fields(cls):
            # PEP 563: f.type is the annotation *string*; recover the class
            # from the field's default factory.
            typ = f.default_factory
            sub = d.get(f.name, {})
            if isinstance(sub, dict) and dataclasses.is_dataclass(typ):
                names = {x.name for x in dataclasses.fields(typ)}
                kw[f.name] = typ(**{k: v for k, v in sub.items() if k in names})
        return cls(**kw)


def build_arg_parser() -> argparse.ArgumentParser:
    """CLI with the reference's flag names (train_grpo_flux.py:894-1423)."""
    p = argparse.ArgumentParser()
    groups = {
        "data": DataConfig, "paths": ModelPathsConfig, "optim": OptimConfig,
        "grpo": GRPOConfig, "window": WindowConfig, "dpm": DPMConfig,
        "reward": RewardConfig, "run": RunConfig, "runtime": RuntimeConfig,
    }
    for _, cls in groups.items():
        for f in dataclasses.fields(cls):
            name = "--" + f.name
            default = f.default if f.default is not dataclasses.MISSING else None
            if f.type == "bool" or isinstance(default, bool):
                # supports both --flag and --no-flag (several recipe
                # defaults are True and must be disablable)
                p.add_argument(
                    name, action=argparse.BooleanOptionalAction, default=default
                )
            else:
                typ = {int: int, float: float}.get(type(default), str)
                p.add_argument(name, type=typ, default=default)
    p.add_argument("--mesh_dp", type=int, default=-1)
    p.add_argument("--mesh_fsdp", type=int, default=1)
    p.add_argument("--mesh_sp", type=int, default=1)
    p.add_argument("--mesh_tp", type=int, default=1)
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    d = vars(args)

    def pick(cls):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: _none(v) for k, v in d.items() if k in names and v is not None})

    def _none(v):
        # reference converts the literal string "None" to None (:1426-1435)
        return None if v == "None" else v

    return TrainConfig(
        data=pick(DataConfig), paths=pick(ModelPathsConfig), optim=pick(OptimConfig),
        grpo=pick(GRPOConfig), window=pick(WindowConfig), dpm=pick(DPMConfig),
        reward=pick(RewardConfig), run=pick(RunConfig),
        runtime=pick(RuntimeConfig),
        mesh=MeshConfig(
            dp=d.get("mesh_dp", -1), fsdp=d.get("mesh_fsdp", 1),
            sp=d.get("mesh_sp", 1), tp=d.get("mesh_tp", 1),
        ),
    )


def window_state_from_config(cfg: TrainConfig):
    from mixgrpo_tpu_torch.rl.window import SlidingWindowState

    return SlidingWindowState(
        iters_per_group=cfg.window.iters_per_group,
        group_size=cfg.window.group_size,
        # reference passes sampling_steps - 2 ("the max timestep index is
        # args.sampling_steps - 2", train_grpo_flux.py:807): the final MDP
        # pair is dropped by the unconditional double truncation (:407-410),
        # so the window never covers — and PPO never trains — the last two
        # step indices.  This also sets the roll_back cadence and the
        # random-strategy bounds.
        max_timesteps=cfg.grpo.sampling_steps - 2,
        sample_strategy=cfg.window.sample_strategy,
        prog_overlap=cfg.window.prog_overlap,
        prog_overlap_step=cfg.window.prog_overlap_step,
        max_iters_per_group=cfg.window.max_iters_per_group,
        min_iters_per_group=cfg.window.min_iters_per_group,
        roll_back=cfg.window.roll_back,
        exp_decay_thre_timestep=cfg.window.exp_decay_thre_timestep,
        exp_decay_k=cfg.window.exp_decay_k,
    )
