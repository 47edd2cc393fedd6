"""The port stands alone: ``mixgrpo_tpu_torch`` and ``chip_smoke.py`` import
neither JAX (nor jaxlib, optax, orbax) nor the JAX package ``mixgrpo_tpu``;
only the tests import both."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "optax", "orbax", "mixgrpo_tpu"}


def _port_files():
    files = ["chip_smoke.py"]
    for d, _, names in os.walk(os.path.join(ROOT, "mixgrpo_tpu_torch")):
        files += [os.path.relpath(os.path.join(d, n), ROOT)
                  for n in names if n.endswith(".py")]
    return sorted(files)


def test_port_package_is_present():
    files = _port_files()
    assert os.path.exists(os.path.join(ROOT, "chip_smoke.py"))
    for module in ("ops/flash_attention.py", "trainer.py", "train.py", "config.py",
                   "rl/advantage.py", "utils/checkpoint.py", "data/dataset.py"):
        assert f"mixgrpo_tpu_torch/{module}" in files


@pytest.mark.parametrize("path", _port_files())
def test_imports_no_jax(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BANNED, f"{path} imports {name}"
