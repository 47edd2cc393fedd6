"""The port's BLIP towers and ImageReward against the JAX package on the CPU,
in f32, at ``BlipVisionConfig.tiny()`` / ``BlipTextConfig.tiny()`` (with 40 positions).

- the ViT and the BERT-with-cross-attention encoders on JAX's weights (a
  padded key mask in the text encoder), within 1e-4 relative;
- the loaders: an ``ImageReward.pt`` written from the port's trees under the
  released names (``chip_smoke.blip_state``) read by both packages' loaders,
  equal leaf for leaf;
- ImageReward end to end: the port's ``from_checkpoint`` (tiny vision
  geometry, the text geometry from ``med_config.json``, the tokenizer from a
  ``vocab.txt`` beside it) against JAX's ``ImageRewardModel`` built from the
  same file with ``transformers.BertTokenizerFast``, scores within 1e-4.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from mixgrpo_tpu.models.text import blip as JB
from mixgrpo_tpu.rewards import image_reward as JIR
from mixgrpo_tpu_torch.convert import from_jax_params
from mixgrpo_tpu_torch.models.text import blip as B
from mixgrpo_tpu_torch.rewards import image_reward as IR
from tests.test_torch_load import flat
from tests.test_torch_rewards import bert_vocab_dir

# 40 positions: ImageReward tokenizes to 35
VCFG = B.BlipVisionConfig.tiny()
TCFG = dataclasses.replace(B.BlipTextConfig.tiny(encoder_width=32), max_position=40)
JVCFG = JB.BlipVisionConfig.tiny()
JTCFG = dataclasses.replace(JB.BlipTextConfig.tiny(encoder_width=32), max_position=40)
IR_WORDS = ["a", "tiny", "prompt", "of", "the", "cat", "dog", "on", "mat", "!", ",", "##s",
            "red", "fox", "in", "snow", "at", "golden", "hour"]


def _np(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def test_blip_towers_match_jax():
    vp = jax.jit(JB.init_blip_vision, static_argnums=1)(jax.random.key(0), JVCFG)
    tp = jax.jit(JB.init_blip_text, static_argnums=1)(jax.random.key(1), JTCFG)
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    want_v = np.asarray(jax.jit(JB.blip_vision_encode, static_argnums=1)(
        vp, JVCFG, jnp.asarray(imgs)))
    got_v = B.blip_vision_encode(from_jax_params(_np(vp), "cpu"), VCFG,
                                 torch.from_numpy(imgs)).numpy()
    assert got_v.shape == (2, 17, 32)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-4, atol=1e-5)

    ids = rng.integers(0, 64, size=(2, 9))
    mask = np.ones((2, 9), bool)
    mask[1, 5:] = False  # padded keys
    want_t = np.asarray(jax.jit(JB.blip_text_encode, static_argnums=1)(
        tp, JTCFG, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(want_v)))
    got_t = B.blip_text_encode(from_jax_params(_np(tp), "cpu"), TCFG, ids, mask,
                               torch.from_numpy(want_v.copy())).numpy()
    np.testing.assert_allclose(got_t, want_t, rtol=1e-4, atol=1e-5)


def write_image_reward(d, seed=0, tcfg=TCFG):
    """A tiny ImageReward directory: ``ImageReward.pt`` (F32, the released
    names), ``med_config.json`` (``tcfg``'s text geometry) and a ``vocab.txt``
    of 64 lines or fewer; returns (the .pt path, the med_config path, the
    port's trees)."""
    g = torch.Generator().manual_seed(seed)
    vp = B.init_blip_vision(VCFG, generator=g, device="cpu")
    tp = B.init_blip_text(tcfg, generator=g, device="cpu")
    for n in ("ca_k", "ca_v"):  # let the image move the CLS row: BERT's 0.02 init barely does
        tp["blocks"][n]["w"] *= 25.0
    dims = [(tcfg.hidden, 1024), (1024, 128), (128, 64), (64, 16), (16, 1)]
    mlp = {"layers": [{"w": torch.randn(dd, generator=g) * dd[0] ** -0.5,
                       "b": 0.1 * torch.randn(dd[1], generator=g)} for dd in dims]}
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "ImageReward.pt")
    torch.save({k: v.contiguous() for k, v in CS.blip_state(vp, tp, mlp, VCFG).items()}, path)
    med = os.path.join(d, "med_config.json")
    with open(med, "w") as f:
        json.dump(CS.med_config_json(tcfg), f)
    bert_vocab_dir(d, IR_WORDS)
    return path, med, (vp, tp, mlp)


def jax_image_reward(path, vocab_dir):
    """JAX's ImageRewardModel on ``path`` at the tiny geometry (its
    ``from_checkpoint`` hard-codes ViT-L), tokenizing with
    ``BertTokenizerFast`` as its ``from_checkpoint`` would."""
    from transformers import BertTokenizerFast

    from mixgrpo_tpu.models.text.clip_load import load_torch_state

    st = load_torch_state(path)
    mlp = {"layers": [{"w": jnp.asarray(st[f"mlp.layers.{i}.weight"].T),
                       "b": jnp.asarray(st[f"mlp.layers.{i}.bias"])} for i in (0, 2, 4, 6, 7)]}
    return JIR.ImageRewardModel(
        JB.load_blip_vision(st, JVCFG, prefix="blip.visual_encoder."), JVCFG,
        JB.load_blip_text(st, JTCFG, prefix="blip.text_encoder."), JTCFG, mlp,
        BertTokenizerFast.from_pretrained(vocab_dir), dtype=jnp.float32)


def test_loaders_match_jax(tmp_path):
    path, _, (vp, tp, _) = write_image_reward(str(tmp_path))
    st = torch.load(path, weights_only=True)
    npst = {k: v.numpy() for k, v in st.items()}
    for mine, ref, want in (
            (B.load_blip_vision(st, VCFG, prefix="blip.visual_encoder.", device="cpu"),
             JB.load_blip_vision(npst, JVCFG, prefix="blip.visual_encoder."), vp),
            (B.load_blip_text(st, TCFG, prefix="blip.text_encoder.", device="cpu"),
             JB.load_blip_text(npst, JTCFG, prefix="blip.text_encoder."), tp)):
        got, jax_, orig = flat(mine), flat(ref), flat(want)
        assert sorted(got) == sorted(jax_) == sorted(orig)
        for k in got:
            np.testing.assert_array_equal(got[k], jax_[k], err_msg=k)
            np.testing.assert_array_equal(got[k], orig[k], err_msg=k)


def test_image_reward_matches_jax(tmp_path):
    path, med, _ = write_image_reward(str(tmp_path))
    mine = IR.ImageRewardModel.from_checkpoint(path, med, str(tmp_path), vision_cfg=VCFG,
                                               device="cpu")
    assert mine.tcfg == TCFG and mine.dtype == torch.float32  # med_config's geometry
    ref = jax_image_reward(path, str(tmp_path))
    rng = np.random.default_rng(4)
    imgs = rng.uniform(size=(3, 40, 48, 3)).astype(np.float32)
    prompts = ["a tiny prompt of the cat!", "the red fox in snow at golden hour, dogs",
               "zebra " * 30]
    got, ok = mine(torch.from_numpy(imgs), prompts)
    want, jok = ref(imgs, prompts)
    assert ok == jok == [1.0] * 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert len(set(np.round(got, 5))) == 3


def test_image_reward_needs_its_tokenizer(tmp_path):
    path, med, _ = write_image_reward(str(tmp_path))
    m = IR.ImageRewardModel.from_checkpoint(path, med, vision_cfg=VCFG, device="cpu")
    with pytest.raises(AssertionError, match="tokenizer required"):
        m(np.zeros((1, 32, 32, 3), np.float32), ["a cat"])
