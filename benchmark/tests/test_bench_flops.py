"""The FLOP and attention-bound functions against hand counts at the two
cells' shapes."""

import pytest

from benchlib import flops as F
from benchlib.peaks import peaks_for

H100 = peaks_for("NVIDIA H100 80GB HBM3")
FLUX = {"in_channels": 64, "hidden_size": 3072, "num_heads": 24, "mlp_ratio": 4.0,
        "depth_double": 10, "depth_single": 19, "context_dim": 4096, "pooled_dim": 768,
        "time_freq_dim": 256, "guidance_embeds": True}


def test_flux_720px_rollout_attention():
    # B = 2 (a rollout chunk), 24 heads of 128, 512 + 45 * 45 = 2537 tokens
    # padded to 2560 queries and keys, 2537 keys valid
    flop, nbytes = F.attention_call("flash_attn_fwd", 2, 24, 2560, 2560, 2537, 128)
    assert flop == 2 * (2 * 2 * 24 * 2560 * 2537 * 128)
    assert nbytes == 2 * 2 * 24 * 128 * (2560 + 2560 + 2560 + 2560)
    assert F.bound_s(flop, nbytes, H100) == pytest.approx(159.61e9 / 989e12, rel=1e-3)
    # the fused backward of an update group of 12 pairs: five products
    flop, _ = F.attention_call("flash_attn_bwd_fused", 12, 24, 2560, 2560, 2537, 128)
    assert flop == 5 * 2 * 12 * 24 * 2560 * 2537 * 128


def test_flux_720px_forward_flops():
    L_img, L_txt, S = 2025, 512, 2537
    f = F.mmdit_flops(FLUX, 2, L_img, L_txt)
    h, mh = 3072, 12288
    stream = lambda n: 2 * 2 * n * (h * 3 * h + h * h + h * mh + mh * h)
    double = 2 * 2 * h * 6 * h * 2 + stream(L_img) + stream(L_txt)
    single = 2 * 2 * h * 3 * h + 2 * 2 * S * (h * (3 * h + mh) + (h + mh) * h)
    embed = 2 * 2 * (L_img * 64 * h + L_txt * 4096 * h) + 2 * 2 * (256 * h + h * h) * 2 \
        + 2 * 2 * (768 * h + h * h)
    final = 2 * 2 * h * 2 * h + 2 * 2 * L_img * h * 64
    assert f["gemm"] == 10 * double + 19 * single + embed + final
    assert f["attention"] == 29 * 4 * 2 * 24 * S * S * 128
    # about 19 TFLOP a sample-step at 10 + 19 blocks
    assert (f["gemm"] + f["attention"]) / 2 == pytest.approx(19.0e12, rel=0.05)


def test_hunyuan_masked_attention_bound():
    # S = 256 + 33 * 12 * 21 = 8572, padded to 8576; 220 of 256 text keys
    # and the 4 pad keys masked: 8352 keys valid; an f32 key bias
    flop, nbytes = F.attention_call("flash_attn_fwd", 1, 24, 8576, 8576, 8352, 128, True)
    assert flop == 4 * 24 * 8576 * 8352 * 128
    assert nbytes == 2 * 24 * 128 * 4 * 8576 + 4 * 8576
    assert F.bound_s(flop, nbytes, H100) * 1e3 == pytest.approx(0.890, abs=0.001)


def test_hunyuan_forward_flops():
    cfg = dict(FLUX, in_channels=64, depth_double=10, depth_single=20, refiner_depth=2)
    L_img, L_txt = 8316, 256
    plain = F.mmdit_flops(cfg, 1, L_img, L_txt)
    refined = F.mmdit_flops(cfg, 1, L_img, L_txt, refiner_tokens=L_txt)
    h, mh = 3072, 12288
    per_block = 2 * 2 * h * h + 2 * L_txt * (h * 3 * h + h * h + h * mh + mh * h)
    assert refined["gemm"] - plain["gemm"] == 2 * per_block
    assert refined["attention"] - plain["attention"] == 2 * 4 * 24 * L_txt * L_txt * 128
    assert plain["attention"] == 30 * 4 * 24 * 8572 ** 2 * 128


def test_vae_flops_at_a_hand_counted_size():
    # one resnet-free decoder: no up blocks' resnets, to count by hand
    v = {"latent_channels": 16, "out_channels": 3, "block_out_channels": [8, 8],
         "layers_per_block": 0}
    # conv_in 16->8 at 4x4; two mid resnets (two 3x3 8->8 each); attention
    # (q, k, v, out and two products over 16 tokens); block 0 resnet 8->8,
    # upsample conv at 8x8; block 1 resnet at 8x8; conv_out 8->3 at 8x8
    c = lambda H, k, ci, co: 2 * H * H * k * k * ci * co
    want = c(4, 3, 16, 8) + 4 * c(4, 3, 8, 8) + 4 * 2 * 16 * 8 * 8 + 4 * 16 * 16 * 8 \
        + 2 * c(4, 3, 8, 8) + c(8, 3, 8, 8) + 2 * c(8, 3, 8, 8) + c(8, 3, 8, 3)
    assert F.vae_decoder_flops(v, 1, 4, 4) == want
