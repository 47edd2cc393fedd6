"""The port's spans where the work happens, on the CPU at tiny sizes.

Under ``torch.profiler``: one LoRA + MixGRPO-Flash ``train_one_step`` is
an ``iteration`` unit whose rollout holds one ``merge`` and chunks x steps
``dit`` calls, the sampled ones (one of every ``profiling.SAMPLE_EVERY``,
here 4) with their stages (``gemm``, ``attn``, ``norm_mod``, ``qk_rope``,
``gate_res``, ``act``); its update holds one ``group`` per accumulation
group, each with a ``dit`` forward, a ``backward`` holding the checkpointed
blocks' recompute (their ``merge``) and an ``optim``.  One ``HunyuanVideoPipeline`` call is a ``video`` unit whose
``denoise`` holds ``num_steps`` ``dit`` calls and whose ``decode`` holds a
``tile`` per tile, each with its ``norm`` spans.  Without a profiler the
same calls record nothing.
"""

import numpy as np
import pytest
import torch
from torch.profiler import profile

from mixgrpo_tpu_torch.config import (
    DataConfig, DPMConfig, GRPOConfig, OptimConfig, RunConfig, TrainConfig, WindowConfig,
)
from mixgrpo_tpu_torch.models.flux import model as M
from mixgrpo_tpu_torch.models.flux.vae import VAEConfig, init_vae_decoder
from mixgrpo_tpu_torch.models.hunyuan import model as HM
from mixgrpo_tpu_torch.models.hunyuan import pipeline as P
from mixgrpo_tpu_torch.models.hunyuan import vae3d as V
from mixgrpo_tpu_torch.train import GRPOTrainer
from mixgrpo_tpu_torch.utils import profiling

LEAVES = ("gemm", "attn", "norm_mod", "qk_rope", "gate_res", "act")


@pytest.fixture
def registry(monkeypatch):
    reg = profiling._Registry()
    monkeypatch.setattr(profiling, "REGISTRY", reg)
    return reg


def _trainer(tmp_path):
    cfg = TrainConfig(
        data=DataConfig(train_batch_size=1),
        optim=OptimConfig(gradient_accumulation_steps=2, gradient_checkpointing=True),
        grpo=GRPOConfig(h=32, w=32, sampling_steps=6, num_generations=4, rollout_chunk=2,
                        advantage_rerange_strategy="null"),
        window=WindowConfig(iters_per_group=2, group_size=2, prog_overlap=False),
        dpm=DPMConfig(dpm_algorithm_type="dpmsolver++", dpm_apply_strategy="post",
                      dpm_post_compress_ratio=0.8, dpm_solver_order=2,
                      dpm_solver_type="midpoint"),
        run=RunConfig(output_dir=str(tmp_path / "out"), export_safetensors="off"))
    fcfg = M.FluxConfig.tiny()
    params = M.init_flux(fcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    vcfg = VAEConfig.tiny(latent_channels=fcfg.in_channels // 4)
    vae = init_vae_decoder(vcfg, generator=torch.Generator().manual_seed(5), device="cpu")

    def brightness(images01, captions):
        r = images01.float().mean(dim=(1, 2, 3)).numpy().astype(np.float64)
        return {"synthetic": r}, {"synthetic": np.ones_like(r)}

    tr = GRPOTrainer(cfg, flux_cfg=fcfg, params=params, vae_cfg=vcfg, vae_params=vae,
                     reward_fn=brightness, text_len=8, attn_impl="eager", dtype=torch.float32,
                     device="cpu", use_lora=True, lora_rank=4, lora_alpha=8.0)
    tr.reward_weights = {"synthetic": 1.0}
    rng = np.random.default_rng(0)
    batch = {"prompt_embed": rng.standard_normal((1, 8, fcfg.context_dim)).astype(np.float32),
             "pooled": rng.standard_normal((1, fcfg.pooled_dim)).astype(np.float32),
             "captions": ["a tiny prompt"]}
    return tr, batch


def test_train_one_step_spans(tmp_path, registry, monkeypatch):
    every = 4  # a tiny rollout has too few DiT calls for the program's period
    monkeypatch.setattr(profiling, "SAMPLE_EVERY", every)
    tr, batch = _trainer(tmp_path)
    m = tr.train_one_step(batch, [1, 2])
    assert profiling.last_unit() is None and m["host_time"] >= 0
    with profile():
        m = tr.train_one_step(batch, [1, 2])
    rec = profiling.last_unit()
    tr.close()
    assert rec["iteration"]["count"] == 1 and m["host_time"] >= 0
    for stage in ("rollout", "decode", "reward", "update"):
        assert rec[f"iteration/{stage}"]["count"] == 1
    assert rec["iteration/rollout/merge"]["count"] == 1
    assert rec["iteration/rollout/chunk"]["count"] == 2
    calls = 2 * m["num_steps"]
    sampled = len(range(0, calls, every))
    assert sampled >= 2
    assert rec["iteration/rollout/chunk/dit"]["count"] == calls
    assert rec["iteration/rollout/chunk/dit"]["timed"] == sampled
    for leaf in LEAVES:
        assert rec[f"iteration/rollout/chunk/dit/{leaf}"]["count"] > 0
    # a double block's 7 products and 2 modulations, a single block's 2 and 1
    fcfg = M.FluxConfig.tiny()
    per_call = 9 * fcfg.depth_double + 3 * fcfg.depth_single
    gemm = rec["iteration/rollout/chunk/dit/gemm"]["count"]
    assert gemm % sampled == 0 and gemm // sampled > per_call
    groups = 4 // 2
    assert rec["iteration/update/group"]["count"] == groups
    for leaf in ("dit", "backward", "optim", "merge"):
        assert rec[f"iteration/update/group/{leaf}"]["count"] == groups
    blocks = groups * (fcfg.depth_double + fcfg.depth_single)
    assert rec["iteration/update/group/dit/merge"]["count"] == blocks
    assert rec["iteration/update/group/backward/merge"]["count"] == blocks  # the recompute
    # the update's calls continue the unit's count; the recompute is outside a call
    timed = sum(i % every == 0 for i in range(calls, calls + groups))
    assert rec["iteration/update/group/dit"]["timed"] == timed
    assert ("iteration/update/group/dit/gemm" in rec) == (timed > 0)
    assert not any(p.startswith("iteration/update/group/backward") and p.split("/")[-1] in LEAVES
                   for p in rec)
    assert not any(p.split("/")[-1] == "dit" and "backward" in p for p in rec)


def test_video_pipeline_spans(registry, monkeypatch):
    cfg, vcfg = HM.HunyuanVideoConfig.tiny(), V.CausalVAEConfig.tiny()
    params = HM.init_hunyuan_video(cfg, generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    vae = V.init_causal_vae_decoder(vcfg, generator=torch.Generator().manual_seed(1),
                                    device="cpu")
    pipe = P.HunyuanVideoPipeline(cfg, params, vae_cfg=vcfg, vae_params=vae, num_steps=3,
                                  dtype=torch.float32, attn_impl="eager", vae_tiling="on",
                                  device="cpu")
    tiles = []
    decode = V.causal_vae_decode
    monkeypatch.setattr(V, "causal_vae_decode", lambda *a, **k: tiles.append(1) or decode(*a, **k))
    rng = np.random.default_rng(0)
    txt = torch.from_numpy(rng.standard_normal((1, 6, cfg.text_states_dim)).astype(np.float32))
    pooled = torch.from_numpy(rng.standard_normal((1, cfg.text_states_dim_2)).astype(np.float32))
    kw = dict(video_length=5, height=32, width=32, generator=torch.Generator().manual_seed(2))
    with profile():
        video = pipe(txt, pooled, **kw)
    assert video.shape == (1, 5, 32, 32, 3)
    rec = profiling.last_unit()
    assert rec["video"]["count"] == 1
    assert rec["video/denoise/dit"]["count"] == 3 and rec["video/denoise/dit"]["timed"] == 1
    for leaf in LEAVES:
        assert rec[f"video/denoise/dit/{leaf}"]["count"] > 0
    assert tiles and rec["video/decode/tile"]["count"] == len(tiles)
    assert rec["video/decode/tile/norm"]["count"] > 0
    assert not any(p.startswith("video/denoise") and p.endswith("/norm") for p in rec)
