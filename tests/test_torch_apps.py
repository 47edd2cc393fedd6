"""The port's CLIs on the rehearsal tree (``scripts/make_rehearsal_ckpts.py``
at the tiny preset) against the JAX package.

- ``sample.main([... "--device", "cpu"])`` (f32 on the CPU): three
  prompts in batches of 2 (one over 512 T5 tokens, one non-ASCII), base
  plus a tuned export: its PNGs against JAX's ``PromptEncoder`` +
  ``DualFluxPipeline`` in f32 fed the same initial noise (``z0``, the
  port's draw from ``torch.Generator().manual_seed(seed)``), within one
  8-bit level; every batch's images and metadata entries are kept.
- ``preprocess.main`` against JAX's ``PromptEncoder`` in f32 (the cache
  stores f16: within f16 rounding).
- ``serve.build_server`` answering one request on the CPU; with
  ``--continuous``, two concurrent requests through ``ContinuousBatcher``
  equal the one-shot pipeline's images; with ``--quant int8`` the server,
  ``sample.main`` and ``train.main --rollout_quant int8`` run.
- the ``t5`` and ``clip`` preset entries equal JAX's.
- ``train.main --reward_model hpsv2 --device cpu`` for 2 steps;
  ``build_reward_models`` giving ImageReward its tokenizer where JAX's gives
  it none, and raising at build time without a vocabulary or CLIP merges.
- ``eval_rewards.main`` against JAX's ``evaluate``; ``verify_weights``
  record -> ok -> a changed golden caught, its fingerprints against JAX's
  ``run_checks``; ``tsne_probe.main`` against JAX's ``run_probe`` fed the
  same draws.
"""

import dataclasses
import io
import json
import os
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu import presets as JP
from mixgrpo_tpu import sample as JSa
from mixgrpo_tpu.models.flux import model as JM
from mixgrpo_tpu.models.flux.load import (
    load_flux_params, load_safetensors_dir, load_vae_decoder_params,
)
from mixgrpo_tpu.models.text.clip_load import load_clip_hf_text_only
from mixgrpo_tpu.models.text.t5 import load_t5_hf
from mixgrpo_tpu.preprocess import PromptEncoder as JPromptEncoder
from mixgrpo_tpu.rewards.tokenizer import CLIPTokenizer as JCLIPTokenizer
from mixgrpo_tpu.utils.checkpoint import export_flux_safetensors as j_export
from mixgrpo_tpu_torch import preprocess as Pre
from mixgrpo_tpu_torch import presets as P
from mixgrpo_tpu_torch import sample as Sa
from mixgrpo_tpu_torch import serve as Se
from mixgrpo_tpu_torch.config import build_arg_parser, config_from_args
from mixgrpo_tpu_torch.data.dataset import LatentDataset
from tests.test_torch_load import write_rehearsal_tree

RES, STEPS, MIX = 32, 3, 2
PROMPTS = ["a photo of a corgi wearing sunglasses",
           " ".join(["a futuristic cat and a dog on the beach"] * 80),
           "café crème 東京 at night 😀"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpts")
    flux_dir = write_rehearsal_tree(root)
    import jax

    tuned = JM.init_flux(jax.random.key(11), JP.flux_family("tiny")["flux"])
    j_export(tuned, JP.flux_family("tiny")["flux"], os.path.join(str(root), "tuned.safetensors"))
    with open(os.path.join(str(root), "prompts.txt"), "w") as f:
        f.write("\n".join(PROMPTS) + "\n\n")
    return flux_dir


def _jax_encoder(tree, fam):
    from transformers import AutoTokenizer

    return JPromptEncoder(
        load_t5_hf(load_safetensors_dir(os.path.join(tree, "text_encoder_2")), fam["t5"]),
        fam["t5"], AutoTokenizer.from_pretrained(os.path.join(tree, "tokenizer_2")),
        load_clip_hf_text_only(load_safetensors_dir(os.path.join(tree, "text_encoder")),
                               fam["clip"]),
        fam["clip"], JCLIPTokenizer(os.path.join(tree, "tokenizer", "merges.txt")),
        dtype=jnp.float32)


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path), np.int16)


def test_sample_main_matches_jax(tree, tmp_path):
    root = os.path.dirname(tree)
    out = str(tmp_path / "out")
    Sa.main(["--model_path", tree, "--new_model_ckpt", os.path.join(root, "tuned.safetensors"),
             "--prompt_path", os.path.join(root, "prompts.txt"), "--output_dir", out,
             "--h", str(RES), "--w", str(RES), "--sampling_steps", str(STEPS),
             "--mix_sampling_steps", str(MIX), "--batch_size", "2", "--seed", "7",
             "--device", "cpu"], family=P.flux_family("tiny"))
    with open(os.path.join(out, "metadata_0.json")) as f:
        meta = json.load(f)
    assert [m["prompt"] for m in meta] == PROMPTS
    assert [m["seed"] for m in meta] == [7, 8, 9]
    assert [m["image"] for m in meta] == [f"img_p0_{i:05d}.png" for i in range(3)]

    fam = JP.flux_family("tiny")
    cfg = fam["flux"]
    enc = _jax_encoder(tree, fam)
    pipe = JSa.DualFluxPipeline(
        cfg, load_flux_params(os.path.join(tree, "transformer"), cfg),
        load_flux_params(os.path.join(root, "tuned.safetensors"), cfg), vae_cfg=fam["vae"],
        vae_params=load_vae_decoder_params(os.path.join(tree, "vae"), fam["vae"]),
        height=RES, width=RES, num_steps=STEPS, mix_sampling_steps=MIX, dtype=jnp.float32,
        attn_impl="xla")
    tokens = (RES // 16) ** 2
    import jax

    for start in (0, 2):
        chunk = PROMPTS[start:start + 2]
        g = torch.Generator().manual_seed(7 + start)  # the port's draw, as sample.main makes it
        z0 = torch.randn((len(chunk), 1, tokens, cfg.in_channels), generator=g)
        emb, pooled = enc(chunk)
        want = np.asarray(pipe(jnp.asarray(emb), jnp.asarray(pooled), jax.random.key(0),
                               z0=jnp.asarray(z0.reshape(len(chunk), tokens, -1).numpy())))
        want = (np.clip(want, 0, 1) * 255).astype(np.uint8).astype(np.int16)
        for j in range(len(chunk)):
            got = _png(os.path.join(out, meta[start + j]["image"]))
            assert got.shape == (RES, RES, 3)
            assert np.abs(got - want[j]).max() <= 1


def test_preprocess_main_matches_jax(tree, tmp_path):
    root = os.path.dirname(tree)
    manifest = Pre.main(["--prompt_dir", os.path.join(root, "prompts.txt"), "--output_dir",
                         str(tmp_path / "cache"), "--model_path", tree, "--batch_size", "2",
                         "--device", "cpu"],
                        family=P.flux_family("tiny"))
    assert os.path.exists(manifest)
    ds = LatentDataset(str(tmp_path / "cache"))
    assert len(ds) == 3 and ds.captions == PROMPTS
    emb, pooled = _jax_encoder(tree, JP.flux_family("tiny"))(PROMPTS)
    for i in range(3):
        row = ds.get(i)
        assert row["prompt_embed"].shape == (512, 32) and row["pooled"].shape == (32,)
        np.testing.assert_allclose(row["prompt_embed"], emb[i].astype(np.float16),
                                   rtol=2e-3, atol=1e-3)
        np.testing.assert_allclose(row["pooled"], pooled[i].astype(np.float16),
                                   rtol=2e-3, atol=1e-3)
    assert Pre.read_prompts(root) == PROMPTS  # a directory reads every *.txt


def _args(tree, *extra):
    return Se.arg_parser().parse_args(
        ["--model_path", tree, "--host", "127.0.0.1", "--port", "0", "--batch_size", "2",
         "--height", str(RES), "--width", str(RES), "--num_steps", str(STEPS),
         "--mix_sampling_steps", str(MIX), "--device", "cpu",
         "--max_wait_ms", "20", *extra])


def test_serve_build_server_answers(tree):
    srv = Se.build_server(_args(tree), family=P.flux_family("tiny"))
    with srv:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/generate",
            data=json.dumps({"prompt": PROMPTS[2], "seed": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            status, ctype, body = r.status, r.headers.get("Content-Type"), r.read()
        stats = dict(srv.batcher.stats)
    assert status == 200 and ctype == "image/png"
    assert _png(io.BytesIO(body)).shape == (RES, RES, 3)
    assert stats["requests"] == 1 and stats["single_dispatches"] == 1 and stats["errors"] == 0


@pytest.mark.parametrize("flag", ["--continuous", "--quant=int8"])
def test_clis_refuse_unported_before_loading(flag, tree, cache, tmp_path):
    """Both flags are ported and run on the rehearsal tree; what the CLIs do
    not know is still refused before any weight is read.

    ``--continuous`` (no latency tier, one step per engine call): two
    concurrent requests ride the two slot pools, each moves from the tuned
    pool to the base pool once, and each PNG is the one-shot pipeline's for
    its (prompt, seed) within one 8-bit level.  ``--quant=int8``: the server
    answers, ``sample.main --quant int8`` writes its image, ``train.main
    --rollout_quant int8`` takes a step with a finite loss."""
    with pytest.raises(SystemExit):  # argparse's choices, before any file is read
        _args("/nonexistent", flag, "--quant=int4")
    if flag == "--continuous":
        tuned = os.path.join(os.path.dirname(tree), "tuned.safetensors")
        srv = Se.build_server(_args(tree, flag, "--no-latency_tier", "--max_steps_per_call", "1",
                                    "--tuned_path", tuned), family=P.flux_family("tiny"))
        assert isinstance(srv.batcher, Se.ContinuousBatcher) and len(srv.batcher.pools) == 2
        results = {}
        with srv:
            threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, urllib.request.urlopen(
                urllib.request.Request(
                    f"http://127.0.0.1:{srv.port}/generate",
                    data=json.dumps({"prompt": PROMPTS[i], "seed": 3 + i}).encode(),
                    headers={"Content-Type": "application/json"}), timeout=120).read()))
                for i in (0, 2)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            stats = dict(srv.batcher.stats)
        assert stats["requests"] == 2 and stats["migrations"] == 2 and stats["errors"] == 0
        gen = Se.make_generate_fn(srv.batcher.pipe, srv.batcher.encode_fn)
        for i in (0, 2):
            want = (np.clip(gen([PROMPTS[i]], [3 + i])[0], 0, 1) * 255).astype(np.uint8)
            got = _png(io.BytesIO(results[i]))
            assert np.abs(got - want.astype(np.int16)).max() <= 1
        return
    srv = Se.build_server(_args(tree, flag), family=P.flux_family("tiny"))
    with srv:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/generate",
            data=json.dumps({"prompt": PROMPTS[0], "seed": 1}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200 and _png(io.BytesIO(r.read())).shape == (RES, RES, 3)
    out, prompts = str(tmp_path / "samples"), tmp_path / "prompts.txt"
    prompts.write_text(PROMPTS[0] + "\n")
    Sa.main(["--model_path", tree, "--prompt_path", str(prompts), "--output_dir", out,
             "--h", str(RES), "--w", str(RES), "--sampling_steps", str(STEPS),
             "--mix_sampling_steps", str(MIX), flag, "--device", "cpu"],
            family=P.flux_family("tiny"))
    meta = json.load(open(os.path.join(out, "metadata_0.json")))
    assert [m["prompt"] for m in meta] == PROMPTS[:1]
    assert _png(os.path.join(out, meta[0]["image"])).shape == (RES, RES, 3)
    from mixgrpo_tpu_torch import train as T

    root = os.path.dirname(tree)
    tr = T.main(["--pretrained_model_name_or_path", tree, "--data_json_path", cache,
                 "--output_dir", str(tmp_path / "out"), "--h", str(RES), "--w", str(RES),
                 "--sampling_steps", "4", "--num_generations", "2", "--rollout_chunk", "2",
                 "--gradient_accumulation_steps", "1", "--reward_model", "hpsv2",
                 "--hps_path", os.path.join(root, "HPS_v2.1_compressed.pt"),
                 "--rollout_quant", "int8", "--max_train_steps", "1", "--checkpointing_steps",
                 "100", "--export_safetensors", "off", "--device", "cpu"],
                family=P.flux_family("tiny"))
    lines = [json.loads(x) for x in open(tr.metrics.path)]
    assert tr.cfg.grpo.rollout_quant == "int8" and tr.global_step == 1
    assert np.isfinite(lines[0]["loss"]) and np.isfinite(lines[0]["reward"])


def test_presets_match_jax():
    for name in ("flux-dev", "tiny"):
        mine, ref = P.flux_family(name), JP.flux_family(name)
        assert sorted(mine) == sorted(ref) == ["clip", "flux", "t5", "vae"]
        for key in mine:
            assert dataclasses.asdict(mine[key]) == dataclasses.asdict(ref[key]), key


# ---------------------------------------------------------------------------
# the CLIs on the reward zoo: train.main, eval_rewards, verify_weights,
# tsne_probe (tiny preset)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cache(tree, tmp_path_factory):
    """The rehearsal tree's prompts through ``preprocess.main``."""
    out = str(tmp_path_factory.mktemp("cache"))
    Pre.main(["--prompt_dir", os.path.join(os.path.dirname(tree), "prompts.txt"),
              "--output_dir", out, "--model_path", tree, "--device", "cpu"],
             family=P.flux_family("tiny"))
    return out


def test_train_main_on_rehearsal_tree(tree, cache, tmp_path):
    """``train.main`` with ``--reward_model hpsv2 --device cpu`` on the
    rehearsal tree (HPS beside it, the CLIP merges found at
    ``tokenizer/merges.txt``): two steps, the reward streams, a checkpoint at
    the last step; ``train(save_images=True)`` writes each step's first
    image."""
    from mixgrpo_tpu_torch import train as T

    root = os.path.dirname(tree)
    argv = ["--pretrained_model_name_or_path", tree, "--data_json_path", cache,
            "--output_dir", str(tmp_path / "out"), "--h", str(RES), "--w", str(RES),
            "--sampling_steps", "4", "--num_generations", "2", "--rollout_chunk", "2",
            "--gradient_accumulation_steps", "1", "--group_size", "2", "--iters_per_group", "1",
            "--reward_model", "hpsv2", "--hps_path", os.path.join(root, "HPS_v2.1_compressed.pt"),
            "--max_train_steps", "2", "--checkpointing_steps", "2", "--export_safetensors", "off",
            "--device", "cpu"]
    tr = T.main(argv, family=P.flux_family("tiny"))
    assert tr.global_step == 2 and tr.ckpt.latest_step() == 2
    assert sorted(tr.reward_models) == ["hpsv2"] and tr.reward_fn is None
    assert tr.params["double"]["img_qkv"]["w"].dtype == torch.float32
    txt = open(os.path.join(tr.run_dir, "rewards.txt")).read()
    assert txt.count("hpsv2: ") == 2
    rows = [json.loads(x) for x in open(os.path.join(tr.run_dir, "rewards_samples_rank0.jsonl"))]
    assert len(rows) == 4 and all(np.isfinite(r["hpsv2"]) and r["hpsv2_ok"] == 1.0 for r in rows)
    lines = [json.loads(x) for x in open(tr.metrics.path)]
    assert [x["step"] for x in lines] == [0, 1] and all(np.isfinite(x["loss"]) for x in lines)

    # image dumps: the first decoded image of each step
    cfg = config_from_args(T_parser().parse_args(argv))
    cfg.optim.max_train_steps = 3
    cfg.run.resume_from_checkpoint = "latest"
    tr2 = T.GRPOTrainer(cfg, flux_cfg=P.flux_family("tiny")["flux"], params=tr.params,
                        vae_cfg=tr.vae_cfg, vae_params=tr.vae_params,
                        reward_models=tr.reward_models, dtype=torch.float32, device="cpu")
    tr2.train(T.PromptLoader(LatentDataset(cache), 1, seed=0), save_images=True)
    assert tr2.global_step == 3
    assert _png(os.path.join(tr2.run_dir, "images", "flux_2_0.png")).shape == (RES, RES, 3)


def T_parser():

    p = build_arg_parser()
    p.add_argument("--device")
    return p


def test_build_reward_models_gives_image_reward_its_tokenizer(tmp_path, monkeypatch):
    """The JAX fault: ``build_reward_models`` passes ImageReward no BERT
    vocabulary (``mixgrpo_tpu/train.py:734-739``), so the model has no
    tokenizer and its first call fails.  The port's ``build_reward_models``
    takes the ``vocab.txt`` beside ``med_config.json``, and raises at build time,
    naming both directories, when neither that one nor the checkpoint's
    holds one.  (JAX's ``from_checkpoint`` hard-codes ViT-L: its geometry is
    patched to the tiny one here.)"""
    from mixgrpo_tpu import config as JC
    from mixgrpo_tpu import train as JTrain
    from mixgrpo_tpu.rewards import image_reward as JIR
    from mixgrpo_tpu_torch import config as C
    from mixgrpo_tpu_torch import train as T
    from mixgrpo_tpu_torch.models.text import blip as B
    from tests.test_torch_blip import JTCFG, JVCFG, VCFG, write_image_reward

    d = str(tmp_path / "ir")
    path, med, _ = write_image_reward(d)
    monkeypatch.setattr(JIR.BlipVisionConfig, "vit_large", classmethod(lambda cls: JVCFG))
    monkeypatch.setattr(JIR.BlipTextConfig, "base", classmethod(lambda cls: JTCFG))
    jcfg = JC.TrainConfig(reward=JC.RewardConfig(reward_model="image_reward",
                                                 image_reward_path=path,
                                                 image_reward_med_config=med))
    jm = JTrain.build_reward_models(jcfg)["image_reward"]
    assert jm.tokenizer is None
    with pytest.raises(AssertionError, match="tokenizer required"):
        jm(np.zeros((1, 32, 32, 3), np.float32), ["a cat"])

    monkeypatch.setattr(B.BlipVisionConfig, "vit_large", classmethod(lambda cls: VCFG))
    cfg = C.TrainConfig(reward=C.RewardConfig(reward_model="image_reward",
                                              image_reward_path=path,
                                              image_reward_med_config=med))
    m = T.build_reward_models(cfg, device="cpu")["image_reward"]
    assert m.tokenizer is not None
    scores, ok = m(np.zeros((1, 32, 32, 3), np.float32), ["a tiny cat"])
    assert np.isfinite(scores).all() and ok == [1.0]

    os.remove(os.path.join(d, "vocab.txt"))
    with pytest.raises(FileNotFoundError, match="vocab.txt or tokenizer.json") as e:
        T.build_reward_models(cfg, device="cpu")
    assert d in str(e.value)
    cfg.reward.image_reward_med_config = str(tmp_path / "elsewhere" / "med_config.json")
    with pytest.raises(FileNotFoundError) as e:
        T.build_reward_models(cfg, device="cpu")
    assert d in str(e.value) and str(tmp_path / "elsewhere") in str(e.value)


def test_build_reward_models_needs_clip_merges(tmp_path, monkeypatch):
    from mixgrpo_tpu_torch import config as C
    from mixgrpo_tpu_torch import train as T

    monkeypatch.delenv("CLIP_BPE_PATH", raising=False)
    cfg = C.TrainConfig(reward=C.RewardConfig(reward_model="hpsv2"))
    cfg.paths.pretrained_model_name_or_path = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="merges.txt"):
        T.build_reward_models(cfg, device="cpu")


def test_eval_rewards_main_matches_jax(tmp_path, monkeypatch):
    """``eval_rewards.main`` in batch mode with ``--reward_model all`` and
    UnifiedReward at ``chip_smoke.StubVLM``: every image's scores against
    JAX's ``evaluate`` with JAX's models on the same PNGs (1e-4), PickScore
    reported as (r * 8 + 18) / 100, the failed UnifiedReward item left out of
    its mean; then single-image mode."""
    import chip_smoke as CS
    from mixgrpo_tpu import eval_rewards as JE
    from mixgrpo_tpu.rewards import clip_family as JCF
    from mixgrpo_tpu_torch import eval_rewards as E
    from mixgrpo_tpu_torch.models.text import blip as B
    from mixgrpo_tpu_torch.rewards import unified_reward as UR
    from tests.test_torch_blip import VCFG, jax_image_reward, write_image_reward
    from tests.test_torch_rewards import write_clip_ckpts

    monkeypatch.setattr(B.BlipVisionConfig, "vit_large", classmethod(lambda cls: VCFG))
    monkeypatch.setattr(UR.time, "sleep", lambda s: None)
    ck = write_clip_ckpts(str(tmp_path / "clip"))
    ir, med, _ = write_image_reward(str(tmp_path / "ir"))
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(5)
    from PIL import Image

    prompts = list(CS.REWARD_PROMPTS[:9])
    meta = []
    for i, p in enumerate(prompts):
        Image.fromarray(rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)).save(
            img_dir / f"img_{i}.png")
        meta.append({"image": f"img_{i}.png", "prompt": p, "seed": i})
    with open(tmp_path / "metadata_0.json", "w") as f:
        json.dump(meta, f)
    paths = ["--hps_path", ck["hps"], "--clip_score_path", ck["clip_score"],
             "--pick_score_path", ck["pick_score"], "--image_reward_path", ir,
             "--image_reward_med_config", med, "--clip_bpe_path", ck["merges"], "--device", "cpu"]
    out = str(tmp_path / "eval")
    with CS.StubVLM() as stub:
        summary = E.main(["--metadata", str(tmp_path / "metadata_0.json"), "--image_dir",
                          str(img_dir), "--output_dir", out, "--reward_model", "all",
                          "--batch_size", "4", "--unified_reward_url", stub.url, *paths])
    rows = json.load(open(os.path.join(out, "rewards_0.json")))
    jmodels = {"hpsv2": JCF.HPSReward.from_checkpoint(ck["hps"], ck["merges"], dtype=jnp.float32),
               "clip_score": JCF.CLIPScoreReward.from_checkpoint(ck["clip_score"], ck["merges"],
                                                                 dtype=jnp.float32),
               "pick_score": JCF.PickScoreReward.from_checkpoint(ck["pick_score"], ck["merges"],
                                                                 dtype=jnp.float32),
               "image_reward": jax_image_reward(ir, str(tmp_path / "ir"))}
    want = JE.evaluate(meta, str(img_dir), jmodels, batch_size=4)
    for name in jmodels:
        np.testing.assert_allclose([r[f"{name}_reward"] for r in rows],
                                   [r[f"{name}_reward"] for r in want], rtol=0, atol=1e-4)
    ur = [CS.StubVLM.score(i) for i in range(9)]
    assert [r["unified_reward_reward"] for r in rows] == ur
    assert summary["unified_reward_count"] == 8
    assert summary["unified_reward_mean"] == pytest.approx(np.mean([u for u in ur if u]))
    pick = np.mean([r["pick_score_reward"] for r in rows])
    assert summary["pick_score_mean"] == pytest.approx((pick * 8 + 18) / 100)
    assert summary == JE.summarize(rows)
    assert "hpsv2_mean" in open(os.path.join(out, "reward_means.txt")).read()

    single = E.main(["--image", str(img_dir / "img_0.png"), "--prompt", prompts[0],
                     "--reward_model", "hpsv2", "--output_dir", str(tmp_path / "one"), *paths])
    assert single["hpsv2_reward"] == pytest.approx(rows[0]["hpsv2_reward"], abs=1e-6)


def test_verify_weights_record_check_and_corruption(tree, tmp_path, monkeypatch):
    """record -> check ok -> a changed golden caught, for every check the
    port has, at the tiny preset (as tests/test_verify_weights.py does for
    JAX's); the CLI refuses no checkpoint.  The fingerprints of the checks
    whose inputs JAX also draws from numpy (t5, clip_l, the four reward
    models and hunyuan_llm) equal those of JAX's ``run_checks`` on the same
    files within 1e-4, and so do hunyuan_vae's, hunyuan_dit's, mochi's and
    mochi_vae's, with JAX's ``jax.random.normal(key(s))`` replaced by the
    port's numpy draw of seed s (the HunyuanVideo and Mochi files written
    by the port's and ``chip_smoke``'s writers at the tiny geometry; the
    port's mochi check reads its config from the file).  JAX's reward checks score at its models'
    default bf16 and its ``ImageRewardModel.from_checkpoint`` hard-codes
    ViT-L and BERT-base: here its reward models compute in f32 and read the
    tiny geometry, as the port's checks do."""
    import jax

    from mixgrpo_tpu import verify_weights as JVW
    from mixgrpo_tpu.models.hunyuan import model as JHunyuan
    from mixgrpo_tpu.models.hunyuan import vae3d as JVae3d
    from mixgrpo_tpu.models.mochi import model as JMochi
    from mixgrpo_tpu.models.mochi import vae as JMochiVae
    from mixgrpo_tpu.models.text import blip as JB
    from mixgrpo_tpu.models.text import llama as JLlama
    from mixgrpo_tpu.rewards import clip_family as JCF
    from mixgrpo_tpu.rewards import image_reward as JIR
    from mixgrpo_tpu_torch import verify_weights as VW
    from tests.test_torch_blip import JTCFG, JVCFG, TCFG, VCFG, write_image_reward
    from tests.test_torch_rewards import write_clip_ckpts

    fam, jfam = P.flux_family("tiny"), JP.flux_family("tiny")
    ck = write_clip_ckpts(str(tmp_path / "clip"))
    # BERT's own vocabulary size: JAX's check draws its token ids below 30522
    tcfg, jtcfg = (dataclasses.replace(c, vocab=30524) for c in (TCFG, JTCFG))
    ir, med, _ = write_image_reward(str(tmp_path / "ir"), tcfg=tcfg)
    dev = {"device": "cpu"}
    specs = {"flux": {"path": os.path.join(tree, "transformer"), "cfg": fam["flux"], **dev},
             "flux_vae": {"path": os.path.join(tree, "vae"), "cfg": fam["vae"], **dev},
             "t5": {"path": os.path.join(tree, "text_encoder_2"), "cfg": fam["t5"], **dev},
             "clip_l": {"path": os.path.join(tree, "text_encoder"), "cfg": fam["clip"], **dev},
             "hps": {"path": ck["hps"], **dev}, "pick_score": {"path": ck["pick_score"], **dev},
             "clip_score": {"path": ck["clip_score"], **dev},
             "image_reward": {"path": ir, "med_config": med, "cfg": (VCFG, tcfg), **dev}}
    hv = write_hunyuan_ckpts(str(tmp_path / "hunyuan"))
    specs.update({"hunyuan_llm": {"path": hv["llm"], "cfg": hv["llm_cfg"], **dev},
                  "hunyuan_vae": {"path": hv["vae"], "cfg": hv["vae_cfg"], **dev},
                  # the tiny config: its RoPE split is not the one inferred from D = 24
                  "hunyuan_dit": {"path": hv["dit"], "cfg": hv["dit_cfg"], **dev}})
    mo = write_mochi_ckpts(str(tmp_path / "mochi"))
    specs.update({"mochi": {"path": mo["dit"], **dev},
                  "mochi_vae": {"path": mo["vae"], "cfg": mo["vae_cfg"], **dev}})
    goldens = str(tmp_path / "goldens.npz")
    assert set(VW.run_checks(specs, goldens, record=True).values()) == {"recorded"}
    assert VW.run_checks(specs, goldens, record=False) == {k: "ok" for k in specs}

    for cls in (JCF._ClipRewardBase, JIR.ImageRewardModel):
        init = cls.__init__
        monkeypatch.setattr(cls, "__init__", lambda self, *a, init=init, dtype=None, **k:
                            init(self, *a, dtype=jnp.float32, **k))
    monkeypatch.setattr(JB.BlipVisionConfig, "vit_large", classmethod(lambda cls: JVCFG))
    monkeypatch.setattr(JB.BlipTextConfig, "base", classmethod(lambda cls: jtcfg))
    jspecs = {"t5": {"path": specs["t5"]["path"], "cfg": jfam["t5"]},
              "clip_l": {"path": specs["clip_l"]["path"], "cfg": jfam["clip"]},
              "hps": {"path": ck["hps"]}, "pick_score": {"path": ck["pick_score"]},
              "clip_score": {"path": ck["clip_score"]},
              "image_reward": {"path": ir, "med_config": med},
              "hunyuan_llm": {"path": hv["llm"], "cfg": JLlama.LlamaConfig.tiny()},
              "hunyuan_vae": {"path": hv["vae"], "cfg": JVae3d.CausalVAEConfig.tiny()},
              "hunyuan_dit": {"path": hv["dit"], "cfg": JHunyuan.HunyuanVideoConfig.tiny()},
              "mochi": {"path": mo["dit"], "cfg": JMochi.MochiConfig.tiny()},
              "mochi_vae": {"path": mo["vae"], "cfg": JMochiVae.MochiVAEConfig.tiny()}}
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(
        VW._normal(int(jax.random.key_data(key)[-1]), shape), dtype))
    # JAX's checks call these eagerly, one compile per op: jitted, the same program
    for mod, name, static in ((JVae3d, "causal_vae_decode", ("dtype",)),
                              (JVae3d, "causal_vae_encode", ("sample", "dtype")),
                              (JHunyuan, "hunyuan_video_forward", ("dtype", "remat")),
                              (JMochi, "mochi_forward", ("dtype", "remat")),
                              (JMochiVae, "mochi_vae_decode", ("dtype",))):
        monkeypatch.setattr(mod, name, jax.jit(getattr(mod, name), static_argnums=(1,),
                                               static_argnames=static))
    jgoldens = str(tmp_path / "goldens_jax.npz")
    assert set(JVW.run_checks(jspecs, jgoldens, record=True).values()) == {"recorded"}
    mine, want = dict(np.load(goldens)), dict(np.load(jgoldens))
    assert sorted(want) == sorted(k for k in mine if k.split("/")[0] in jspecs)
    for k, w in want.items():
        np.testing.assert_allclose(mine[k], w, rtol=1e-4, atol=1e-4, err_msg=k)

    g = dict(np.load(goldens))
    g["hps/hps_scores.slice"] = g["hps/hps_scores.slice"] + 1.0
    np.savez(goldens, **g)
    chk = VW.run_checks(specs, goldens, record=False)
    assert chk["hps"].startswith("MISMATCH") and chk["flux"] == chk["image_reward"] == "ok"
    g["mochi/mochi_out.mean"] = g["mochi/mochi_out.mean"] + 1.0
    np.savez(goldens, **g)
    chk = VW.run_checks(specs, goldens, record=False)
    assert chk["mochi"].startswith("MISMATCH") and chk["mochi_vae"] == "ok"
    with pytest.raises(SystemExit):
        VW.main(["--goldens", goldens])
    # the CLI on the HPS file: record, then check
    assert VW.main(["--goldens", goldens, "--record", "--hps", ck["hps"], "--device", "cpu"]) \
        == {"hps": "recorded"}
    assert VW.main(["--goldens", goldens, "--hps", ck["hps"], "--device", "cpu"]) == {"hps": "ok"}


def write_hunyuan_ckpts(d):
    """Tiny HunyuanVideo files in the released layouts, by the port's and
    ``chip_smoke``'s writers: the transformer ``.pt`` (``{"module": ...}``),
    a Llama tower as HF-named safetensors and the causal VAE (decoder and
    encoder) as safetensors."""
    import chip_smoke as CS
    from mixgrpo_tpu_torch.models.hunyuan import load as HL
    from mixgrpo_tpu_torch.models.hunyuan import model as HM
    from mixgrpo_tpu_torch.models.hunyuan import vae3d as HV
    from mixgrpo_tpu_torch.models.text.llama import LlamaConfig
    from mixgrpo_tpu_torch.utils.safetensors_io import save_file

    g = lambda s: torch.Generator().manual_seed(s)
    cfg, vcfg, lcfg = HM.HunyuanVideoConfig.tiny(), HV.CausalVAEConfig.tiny(), LlamaConfig.tiny()
    dit = os.path.join(d, "transformer", "pytorch_model_module.pt")
    os.makedirs(os.path.dirname(dit))
    params = HM.init_hunyuan_video(cfg, generator=g(50), device="cpu")
    torch.save({"module": HL.export_hunyuan_state_dict(params, cfg)}, dit)
    llm, vae = os.path.join(d, "text_encoder"), os.path.join(d, "vae")
    save_file(CS.llama_hf_state(torch, lcfg, "cpu", 51, dtype=torch.float32),
              os.path.join(llm, "model.safetensors"))
    save_file(CS.causal_vae_state(
        HV.init_causal_vae_decoder(vcfg, generator=g(52), device="cpu"),
        HV.init_causal_vae_encoder(vcfg, generator=g(53), device="cpu")),
        os.path.join(vae, "diffusion_pytorch_model.safetensors"))
    return {"dit": dit, "dit_cfg": cfg, "llm": llm, "llm_cfg": lcfg, "vae": vae, "vae_cfg": vcfg}


def write_mochi_ckpts(d):
    """Tiny Mochi files in the diffusers layouts, by the port's writers: the
    transformer directory (``save_mochi_diffusers``) and the VAE decoder
    (``chip_smoke.mochi_vae_state``)."""
    import chip_smoke as CS
    from mixgrpo_tpu_torch.models.mochi import convert as MC
    from mixgrpo_tpu_torch.models.mochi import model as MM
    from mixgrpo_tpu_torch.models.mochi import vae as MV
    from mixgrpo_tpu_torch.utils.safetensors_io import save_file

    g = lambda s: torch.Generator().manual_seed(s)
    cfg, vcfg = MM.MochiConfig.tiny(), MV.MochiVAEConfig.tiny()
    dit, vae = os.path.join(d, "transformer"), os.path.join(d, "vae")
    MC.save_mochi_diffusers(MM.init_mochi(cfg, generator=g(60), device="cpu"), cfg, dit)
    save_file(CS.mochi_vae_state(MV.init_mochi_vae_decoder(vcfg, generator=g(61), device="cpu")),
              os.path.join(vae, "diffusion_pytorch_model.safetensors"))
    return {"dit": dit, "dit_cfg": cfg, "vae": vae, "vae_cfg": vcfg}


def test_tsne_probe_main(tree, cache, tmp_path, monkeypatch):
    """``tsne_probe.main``: 2 prompts, 2 generations each, SDE on steps 0-1
    of 4, fed JAX's initial noise and SDE draws: its (B, T+1, L, C) latents
    against JAX's ``run_probe`` on the same weights and embeddings (2e-4, as
    the rollout of ``tests/test_torch_train.py``)."""
    import jax

    from mixgrpo_tpu import sampler as JS
    from mixgrpo_tpu import tsne_probe as JTP
    from mixgrpo_tpu.solvers.rollout import SamplerConfig as JSamplerConfig
    from mixgrpo_tpu_torch import tsne_probe as TP
    from mixgrpo_tpu_torch.sampler import FluxSampler

    fam, jfam = P.flux_family("tiny"), JP.flux_family("tiny")
    ds = LatentDataset(cache)
    txt = np.stack([ds.get(i)["prompt_embed"] for i in range(2)]).astype(np.float32)
    pooled = np.stack([ds.get(i)["pooled"] for i in range(2)]).astype(np.float32)
    js = JS.FluxSampler(jfam["flux"], JSamplerConfig(num_steps_max=4, eta=0.7), height=RES,
                        width=RES, text_len=txt.shape[1], dtype=jnp.float32, attn_impl="xla")
    rng = jax.random.key(3)
    want = JTP.run_probe(js, load_flux_params(os.path.join(tree, "transformer"), jfam["flux"]),
                         jnp.asarray(txt), jnp.asarray(pooled), sampling_steps=4, shift=3.0,
                         sde_start=0, sde_end=2, num_generations=2, rng=rng,
                         output_dir=str(tmp_path / "jax"))

    z0 = js.init_noise(rng, 4, same_noise_groups=2)
    rollout = FluxSampler.rollout
    monkeypatch.setattr(FluxSampler, "init_noise", lambda self, g, b, same_noise_groups=None:
                        torch.from_numpy(np.array(z0)))
    monkeypatch.setattr(FluxSampler, "rollout", lambda self, *a, **k: rollout(
        self, *a, **k, noise_fn=lambda i, shape: np.array(
            jax.random.normal(jax.random.fold_in(rng, i), shape, jnp.float32))))
    out = str(tmp_path / "probe")
    TP.main(["--model_path", tree, "--data_json_path", cache, "--output_dir", out, "--h",
             str(RES), "--w", str(RES), "--sampling_steps", "4", "--SDE_sampling_start_step",
             "0", "--SDE_sampling_end_step", "2", "--num_generations", "2", "--num_prompts",
             "2", "--seed", "3", "--device", "cpu"], family=fam)
    lat = np.load(os.path.join(out, "latents_all_steps.npy"))
    L = (RES // 16) ** 2
    assert lat.shape == (4, 5, L, fam["flux"].in_channels) and np.isfinite(lat).all()
    assert not np.allclose(lat[0, -1], lat[1, -1])  # the SDE steps part each pair
    np.testing.assert_allclose(lat, np.asarray(want.all_latents), rtol=0, atol=2e-4)
    np.testing.assert_array_equal(np.load(os.path.join(out, "latents_final.npy")), lat[:, -1])
