"""Nothing the benchmark runs loads JAX or the JAX package, and the
references load nothing of the program either.  Top-level module names are
compared whole: the port's name, ``mixgrpo_tpu_torch``, begins with the
JAX package's."""

import ast
import json
import os
import subprocess
import sys

from benchlib.isolation import forbidden_modules
from conftest import BENCH, ROOT

REFERENCE_IMPORTS = {"__future__", "html", "math", "re", "typing", "numpy", "torch",
                     "reference"}


def test_names_are_compared_whole():
    assert forbidden_modules({"mixgrpo_tpu_torch": 0, "mixgrpo_tpu_torch.train": 0,
                              "jaxtyping": 0, "flaxen": 0}) == []
    assert forbidden_modules({"jax.numpy": 0, "jaxlib": 0, "flax": 0, "mixgrpo_tpu": 0,
                              "mixgrpo_tpu.models": 0}) == \
        ["flax", "jax.numpy", "jaxlib", "mixgrpo_tpu", "mixgrpo_tpu.models"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_references_import_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for name in sorted(os.listdir(ref)):
        if name.endswith(".py"):
            got = set(_imports(os.path.join(ref, name)))
            assert got <= REFERENCE_IMPORTS, (name, got - REFERENCE_IMPORTS)


def test_reference_modules_load_alone():
    code = ("import sys, json; sys.path[:0] = [%r]\n"
            "import reference.flux, reference.grpo, reference.vae, reference.clip, "
            "reference.tokenizer, reference.hunyuan, reference.vae3d\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"mixgrpo_tpu_torch", "mixgrpo_tpu", "jax", "jaxlib", "flax"}


def test_a_whole_run_loads_no_jax(bench_copy):
    """Both tiny cells end to end on the CPU in a fresh process: setup,
    window, check; then ``sys.modules``."""
    code = (
        "import sys, json, torch; sys.path[:0] = [%r, %r, %r]\n"
        "import conftest, run\n"
        "from benchlib.discover import Cell\n"
        "from benchlib.isolation import forbidden_modules\n"
        "conftest.write_tiny(%r, {}, {})\n"
        "for name in ('tiny.grpo', 'tinyvideo.t2v'):\n"
        "    run.measure(Cell(name, bench_dir=%r), 5, 0.1, False, torch.device('cpu'))\n"
        "print(json.dumps([forbidden_modules(sys.modules), 'mixgrpo_tpu_torch' in sys.modules]))"
        % (os.path.dirname(__file__), BENCH, ROOT, bench_copy, bench_copy))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    found, program = json.loads(out.stdout.strip().splitlines()[-1])
    assert found == [] and program


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "flux1-dev.grpo-flash-lora", "--seed", "3000000019", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
