"""Both kinds driven through a whole run at toy widths on the CPU (the
look for a card skipped), with the cells' own limits: a sound run comes out
correct, the control and each planted fault the cell can have come out not
correct.  The controls run at the published depth in bf16 (``toy.grpo``,
``toyvideo.t2v``), where bf16 rounding reads as it does at full size.  The
faults: a step that returns its state unchanged, half of each update's
rows left out (the mean over the rest), an answer altered where it is
produced; the control is the program's int8 path (for the video cell's
decode, the reference decode in fp8 in its place).  (One chip: no
exchange between chips to leave out.)"""

import json
import os

import pytest
import torch

import conftest
import run
from benchlib.discover import Cell


def limits(cell):
    with open(os.path.join(conftest.BENCH, "cells", cell + ".json")) as f:
        return json.load(f)["limits"]


@pytest.fixture
def tiny(bench_copy):
    conftest.write_tiny(bench_copy, limits("flux1-dev.grpo-flash-lora"),
                        limits("hunyuan-video.t2v-192x336x129"))
    return bench_copy


CASES = [("toy.grpo", (), True), ("toy.grpo", ("int8",), False),
         ("tiny.grpo", ("frozen",), False), ("tiny.grpo", ("half",), False),
         ("tiny.grpo", ("altered",), False),
         ("toyvideo.t2v", (), True), ("toyvideo.t2v", ("int8",), False),
         ("tinyvideo.t2v", ("frozen",), False), ("tinyvideo.t2v", ("altered",), False)]


@pytest.mark.parametrize("name,faults,want", CASES)
def test_correct_reads_the_fault(tiny, name, faults, want):
    result = run.measure(Cell(name, bench_dir=tiny), 2 ** 31 + 12, 0.1, False,
                         torch.device("cpu"), faults)
    failing = {k for k, v in result["checks"].items() if v["value"] > v["limit"]}
    assert result["correct"] is want, (faults, result["checks"])
    assert bool(failing) is not want
    assert list(result)[-1] == "checks" and result["attempted"] >= 1



@pytest.mark.cuda
def test_toy_cell_on_the_card(tiny):
    """The bf16 toy cell through the kernels on a card: correct, traced, its
    per-layer metrics read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result = run.measure(Cell("toy.grpo", bench_dir=tiny), 2 ** 31 + 12, 0.1, True,
                         torch.device("cuda:0"))
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0 and "attn_roofline.train" in result["metrics"]
