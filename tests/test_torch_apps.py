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
- ``serve.build_server`` answering one request on the CPU; ``--continuous``
  and ``--quant int8`` raise before any weight is read.
- the ``t5`` and ``clip`` preset entries equal JAX's.
"""

import dataclasses
import io
import json
import os
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
def test_clis_refuse_unported_before_loading(flag):
    """Raised before any weight is read (the model path does not exist)."""
    with pytest.raises(NotImplementedError, match="item"):
        Se.build_server(_args("/nonexistent", flag))
    if flag.startswith("--quant"):
        with pytest.raises(NotImplementedError, match="item 6"):
            Sa.main(["--model_path", "/nonexistent", "--prompt_path", "x", "--output_dir", "y",
                     flag, "--device", "cpu"])


def test_presets_match_jax():
    for name in ("flux-dev", "tiny"):
        mine, ref = P.flux_family(name), JP.flux_family(name)
        assert sorted(mine) == sorted(ref) == ["clip", "flux", "t5", "vae"]
        for key in mine:
            assert dataclasses.asdict(mine[key]) == dataclasses.asdict(ref[key]), key
