"""The Mochi kind driven through a whole run at toy widths on the CPU (the
look for a card skipped), with the cell's own limits: a sound run comes out
correct, the control and each planted fault come out not correct.  The
control runs at the published head size and depth in bf16 (``toymochi.t2v``),
where bf16 rounding reads as it does at full size; the faults at a tiny f32
width (``tinymochi.t2v``).  Then the FLOP counts against a hand count at a
toy shape."""

import json
import os

import pytest
import torch

import conftest
import run
from benchlib import mochi_flops as MF
from benchlib.discover import Cell

with open(os.path.join(conftest.BENCH, "configs", "mochi.json")) as f:
    MOCHI = json.load(f)

TINY_MOCHI_CONFIG = dict(
    MOCHI, num_attention_heads=2, attention_head_dim=16, num_layers=2, pooled_projection_dim=24,
    text_embed_dim=48, time_embed_dim=32, max_sequence_length=8, ff_inner_dim=85,
    ff_context_inner_dim=64, dtype="float32",
    vae=dict(MOCHI["vae"], block_out_channels=[8, 8, 16, 16], layers_per_block=[1, 1, 1, 1, 1],
             norm_num_groups=4))
# the published head size and depth at a toy width, in bf16
TOY_MOCHI_CONFIG = dict(TINY_MOCHI_CONFIG, attention_head_dim=128, num_layers=12,
                        pooled_projection_dim=128, text_embed_dim=256, time_embed_dim=256,
                        ff_inner_dim=682, ff_context_inner_dim=341, dtype="bfloat16")
# 34 latent columns: the decode tiles in space
TINY_MOCHI_TRAFFIC = {"height": 48, "width": 272, "frames": 13, "steps": 4,
                      "guidance_scale": 4.5, "lq_threshold": 0.025, "text_len": 8,
                      "text_tokens": 3, "neg_text_tokens": 1, "check_steps": 3}
TOY_MOCHI_TRAFFIC = dict(TINY_MOCHI_TRAFFIC, height=64, width=96, steps=64, check_steps=6,
                         text_len=32, text_tokens=12)


@pytest.fixture
def mochi(bench_copy):
    with open(os.path.join(conftest.BENCH, "cells", "mochi.t2v-480x848x37.json")) as f:
        limits = json.load(f)["limits"]
    metric = {"name": "video_s_per_video", "form": "s_per_unit"}
    conftest._add(bench_copy, "tinymochi.t2v", TINY_MOCHI_CONFIG, TINY_MOCHI_TRAFFIC,
                  "mochi_t2v", metric, limits)
    conftest._add(bench_copy, "toymochi.t2v", TOY_MOCHI_CONFIG, TOY_MOCHI_TRAFFIC,
                  "mochi_t2v", metric, limits)
    return bench_copy


CASES = [("toymochi.t2v", (), True), ("toymochi.t2v", ("int8",), False),
         ("tinymochi.t2v", (), True), ("tinymochi.t2v", ("frozen",), False),
         ("tinymochi.t2v", ("altered",), False)]


@pytest.mark.parametrize("name,faults,want", CASES)
def test_correct_reads_the_fault(mochi, name, faults, want):
    result = run.measure(Cell(name, bench_dir=mochi), 2 ** 31 + 21, 0.1, False,
                         torch.device("cpu"), faults)
    failing = {k for k, v in result["checks"].items() if v["value"] > v["limit"]}
    assert result["correct"] is want, (faults, result["checks"])
    assert bool(failing) is not want
    assert list(result)[-1] == "checks" and result["attempted"] >= 1


def test_mochi_flops_against_a_hand_count():
    # 2 heads of 4, 1 joint block + the final block, 6 video and 2 text tokens
    cfg = dict(MOCHI, num_attention_heads=2, attention_head_dim=4, num_layers=2,
               pooled_projection_dim=4, text_embed_dim=16, time_embed_dim=8, in_channels=3,
               patch_size=2, ff_inner_dim=10, ff_context_inner_dim=6)
    d, td, te, Lv, Lt, S = 8, 4, 16, 6, 2, 8
    mm = lambda n, i, o: 2 * n * i * o
    embed = mm(Lv, 12, d) + mm(1, 8, d) + mm(1, d, d) + mm(Lt + 1, te, 2 * te) + mm(1, te, te) \
        + mm(1, te, d) + mm(Lt, te, td)
    joint = mm(1, d, 4 * d) + mm(1, d, 4 * td) + mm(Lv, d, 3 * d) + mm(Lt, td, 2 * d) \
        + mm(Lt, td, d) + mm(Lv, d, d) + mm(Lt, d, td) + mm(Lv, d, 20) + mm(Lv, 10, d) \
        + mm(Lt, td, 12) + mm(Lt, 6, td)
    final_block = mm(1, d, 4 * d) + mm(1, d, 2 * td) + mm(Lv, d, 3 * d) + mm(Lt, td, 2 * d) \
        + mm(Lv, d, d) + mm(Lv, d, 20) + mm(Lv, 10, d)
    out = mm(1, d, 2 * d) + mm(Lv, d, 12)
    f = MF.mochi_dit_flops(cfg, 1, Lv, Lt)
    assert f["gemm"] == embed + joint + final_block + out
    assert f["attention"] == 4 * (Lt + 1) * te + 4 * 2 * S * S * 4 + 4 * 2 * Lv * S * 4
    # the decoder: 12 -> 16 (1x1x1), block_in 1 ResNet, up blocks (te, se) = (3, 2),
    # (2, 2), (1, 2) with 1 ResNet each, block_out 1 ResNet, 1x1x1 to RGB
    v = dict(MOCHI["vae"], block_out_channels=[2, 4, 8, 16], layers_per_block=[1, 1, 1, 1, 1])
    c3 = lambda t, h, w, k, ci, co: 2 * t * h * w * k ** 3 * ci * co
    res = lambda t, h, w, c: 2 * c3(t, h, w, 3, c, c)
    T, h, w = 2, 3, 5
    want = c3(T, h, w, 1, 12, 16) + res(T, h, w, 16)
    want += res(T, h, w, 16) + 2 * T * h * w * 16 * 8 * 3 * 4  # -> 4 frames, 6 x 10
    want += res(4, 6, 10, 8) + 2 * 4 * 60 * 8 * 4 * 2 * 4  # -> 7 frames, 12 x 20
    want += res(7, 12, 20, 4) + 2 * 7 * 240 * 4 * 2 * 1 * 4  # -> 7 frames, 24 x 40
    want += res(7, 24, 40, 2) + c3(7, 24, 40, 1, 2, 3)
    assert MF.mochi_decoder_flops(v, 1, T, h, w) == want
    # at the cell's shape: 11,130 video and 96 text tokens, 12 blocks, about 50 TFLOP a call
    full = MF.mochi_dit_flops(MOCHI, 1, 11130, 96)
    assert sum(full.values()) == pytest.approx(50e12, rel=0.1)
