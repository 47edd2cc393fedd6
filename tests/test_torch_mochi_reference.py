"""The port's Mochi DiT, decoder and guided pipeline against the benchmark's
plain references (``benchmark/reference/mochi.py``, ``mochi_vae.py``) on
seeded random weights in f32 on the CPU, at a toy width with the published
head size 128.

- ``mochi_forward`` against the reference fed each row's valid T5 tokens
  only (the published text mask): rows of different valid lengths, through
  the cut to the longest valid row (masks that are prefixes) and the key
  mask (a mask that is no prefix), flash and eager: atol 1e-4 (f32 sums in
  another order over 3 blocks);
- changing the padded tokens' features changes no output bit;
- the final block (``context_pre_only``) attends its visual queries over
  visual and text keys, Sq != Sk, with a key mask: atol 1e-5;
- the decoder, whole and tiled (34 latent columns), against the reference
  decoder: atol 1e-4 (the convolutions' sums in another order);
- two guided steps of ``MochiPipeline`` with a masked prompt and a masked
  negative prompt against the reference's loop: atol 1e-4.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from mixgrpo_tpu_torch.models.mochi import model as M
from mixgrpo_tpu_torch.models.mochi import pipeline as P
from mixgrpo_tpu_torch.models.mochi import vae as V
from mixgrpo_tpu_torch.models.mochi.latents import MOCHI_LATENTS_MEAN, MOCHI_LATENTS_STD

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "benchmark"))
from reference import mochi as R  # noqa: E402
from reference import mochi_vae as RV  # noqa: E402

CFG = M.MochiConfig(num_heads=2, head_dim=128, num_layers=3, in_channels=12, text_dim=64,
                    text_embed_dim=128, time_freq_dim=64, max_text_len=6)
VCFG = dataclasses.replace(V.MochiVAEConfig.tiny(), latent_channels=12)
ATOL = 1e-4


def ref_config(cfg=CFG):
    """The configuration file's keys that the reference reads."""
    return {"patch_size": cfg.patch_size, "num_attention_heads": cfg.num_heads,
            "in_channels": cfg.in_channels, "time_embed_dim": cfg.time_freq_dim,
            "pool_heads": cfg.pool_heads}


def ref_vae_config(vcfg=VCFG):
    return {"block_out_channels": list(vcfg.block_out_channels),
            "layers_per_block": list(reversed(vcfg.layers)),
            "temporal_expansions": [te for te, _ in reversed(vcfg.expansions)],
            "spatial_expansions": [se for _, se in reversed(vcfg.expansions)],
            "norm_num_groups": vcfg.norm_num_groups,
            "latents_mean": MOCHI_LATENTS_MEAN.tolist(), "latents_std": MOCHI_LATENTS_STD.tolist()}


def _moved(tree, gen):
    """Every leaf moved off its init value (biases and norm scales reach the
    output)."""
    if isinstance(tree, dict):
        return {k: _moved(v, gen) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_moved(v, gen) for v in tree]
    return tree + 0.05 * torch.randn(tree.shape, generator=gen)


@pytest.fixture(scope="module")
def params():
    g = torch.Generator().manual_seed(0)
    return _moved(M.init_mochi(CFG, generator=g, device="cpu"), g)


def _inputs(mask_rows, B=2, T=2, H=8, W=6, seed=3):
    g = torch.Generator().manual_seed(seed)
    L = len(mask_rows[0])
    z = torch.randn((B, T, H, W, CFG.in_channels), generator=g)
    txt = torch.randn((B, L, CFG.text_embed_dim), generator=g)
    t = torch.tensor([0.7, 0.2][:B])
    return z, txt, t, torch.tensor(mask_rows, dtype=torch.int32)


def _forward(params, z, txt, t, mask, impl="flash"):
    with torch.no_grad():
        return M.mochi_forward(params, CFG, z, txt, t, mask, dtype=torch.float32,
                               attn_impl=impl, remat=False)


MASKS = {"cut": [[1, 1, 1, 1, 0, 0], [1, 1, 0, 0, 0, 0]],
         "key_mask": [[1, 0, 1, 1, 0, 1], [1, 1, 1, 0, 0, 0]]}


@pytest.mark.parametrize("impl", ["flash", "eager"])
@pytest.mark.parametrize("kind", sorted(MASKS))
def test_forward_matches_the_reference_on_valid_tokens(params, kind, impl):
    z, txt, t, mask = _inputs(MASKS[kind])
    got = _forward(params, z, txt, t, mask, impl)
    for b in range(z.shape[0]):
        valid = txt[b:b + 1, mask[b].bool()]
        with torch.no_grad():
            want = R.forward(params, ref_config(), z[b:b + 1], valid, t[b:b + 1], torch.float32)
        assert want.abs().max() > 0.1
        torch.testing.assert_close(got[b:b + 1], want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", sorted(MASKS))
def test_padded_text_changes_no_output_bit(params, kind):
    z, txt, t, mask = _inputs(MASKS[kind])
    other = torch.where(mask.bool()[..., None], txt, txt + 3.0)
    assert not torch.equal(other, txt)
    assert torch.equal(_forward(params, z, txt, t, mask), _forward(params, z, other, t, mask))
    # and the mask reaches the output: without it the padded rows are read
    assert (_forward(params, z, txt, t, None) - _forward(params, z, txt, t, mask)).abs().max() \
        > 1e-3


def test_final_block_attends_visual_queries_over_valid_text_keys(params, monkeypatch):
    z, txt, t, mask = _inputs(MASKS["key_mask"][:1], B=1)
    seen = []
    attention = M.attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[2], k.shape[2], kw.get("mask") is not None))
        return attention(q, k, v, **kw)

    monkeypatch.setattr(M, "attention", spy)
    _forward(params, z, txt, t, mask)
    n_vis, n_txt = 2 * (8 // 2) * (6 // 2), 6
    assert seen == [(n_vis + n_txt, n_vis + n_txt, True)] * (CFG.num_layers - 1) + [
        (n_vis, n_vis + n_txt, True)]
    # the final block alone, with a key mask, against the reference on the valid tokens
    g = torch.Generator().manual_seed(5)
    x = torch.randn((1, n_vis, CFG.dim), generator=g)
    c = torch.randn((1, n_txt, CFG.text_dim), generator=g)
    temb = torch.randn((1, CFG.dim), generator=g)
    cos, sin = M.mochi_rope(params["pos_frequencies"], M.mochi_positions(2, 4, 3, 192 * 192))
    keys = torch.cat([torch.ones((1, n_vis), dtype=torch.bool), mask.bool()], 1)
    gx, gc = M._mochi_block(params["final_block"], CFG, x, c, temb, cos, sin, True, "flash",
                            torch.float32, keys[:, None, None, :])
    e = {"temb": temb, "cos": cos, "sin": sin, "heads": CFG.num_heads}
    wx, wc = R.final_block(params, e, x, c[:, mask[0].bool()])
    torch.testing.assert_close(gx, wx, rtol=0, atol=1e-5)
    assert torch.equal(gc, c)


@pytest.fixture(scope="module")
def vae():
    g = torch.Generator().manual_seed(8)
    return _moved(V.init_mochi_vae_decoder(VCFG, generator=g, device="cpu"), g)


@pytest.mark.parametrize("size", [(3, 4, 4), (2, 34, 34)], ids=["whole", "tiled"])
def test_decoder_matches_the_reference(vae, size):
    g = torch.Generator().manual_seed(9)
    lat = torch.randn((1, *size, 12), generator=g)
    want = RV.decode_tiled(vae, ref_vae_config(), lat, torch.float32)
    pipe = P.MochiPipeline(CFG, None, vae_cfg=VCFG, vae_params=vae, dtype=torch.float32,
                           device="cpu")
    assert pipe.tiles(lat.shape) == (size[1] > 32)
    got = pipe._decode(lat)
    assert got.shape == (1, 1 + 6 * (size[0] - 1), 8 * size[1], 8 * size[2], 3)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    if size[1] <= 32:  # the whole decode, before the [0, 1] map
        whole = RV.decode(vae, ref_vae_config(), lat * torch.from_numpy(MOCHI_LATENTS_STD)
                          + torch.from_numpy(MOCHI_LATENTS_MEAN), torch.float32)
        assert whole.abs().max() > 0.1
        torch.testing.assert_close(torch.clamp(whole * 0.5 + 0.5, 0, 1), got, rtol=0,
                                   atol=ATOL)


def test_guided_pipeline_matches_the_reference_loop(params):
    z, txt, t, mask = _inputs([[1, 1, 1, 1, 0, 0]], B=1)
    g = torch.Generator().manual_seed(4)
    neg = torch.randn(txt.shape, generator=g)
    neg_mask = torch.tensor([[1, 0, 0, 0, 0, 0]], dtype=torch.int32)
    pipe = P.MochiPipeline(CFG, params, num_steps=2, dtype=torch.float32, device="cpu")
    got = pipe(txt, num_frames=7, height=64, width=48, text_mask=mask, neg_txt=neg,
               neg_mask=neg_mask, z0=z)
    with torch.no_grad():
        want = R.sample(params, ref_config(), z, txt[:, :4], neg[:, :1], 2, 4.5,
                        torch.float32)
    np.testing.assert_allclose(pipe.sigmas, R.linear_quadratic(2), rtol=0, atol=1e-7)
    assert (want[-1] - z).abs().max() > 0.1
    torch.testing.assert_close(got, want[-1], rtol=0, atol=ATOL)
