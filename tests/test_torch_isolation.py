"""The port stands alone: ``mixgrpo_tpu_torch`` and ``chip_smoke.py`` import
neither JAX (nor jaxlib, optax, orbax) nor the JAX package ``mixgrpo_tpu``,
nor the packages the card's machine lacks or is not known to have
(``transformers``, ``tokenizers``, ``regex``, ``safetensors``, ``requests``);
only the tests import them."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "optax", "orbax", "mixgrpo_tpu", "transformers", "tokenizers",
          "regex", "safetensors", "requests"}


def _port_files():
    files = ["chip_smoke.py", "reward_bf16_bound.py"]
    for d, _, names in os.walk(os.path.join(ROOT, "mixgrpo_tpu_torch")):
        files += [os.path.relpath(os.path.join(d, n), ROOT)
                  for n in names if n.endswith(".py")]
    return sorted(files)


def test_port_package_is_present():
    files = _port_files()
    assert os.path.exists(os.path.join(ROOT, "chip_smoke.py"))
    for module in ("ops/flash_attention.py", "trainer.py", "train.py", "config.py",
                   "rl/advantage.py", "utils/checkpoint.py", "data/dataset.py", "lora.py",
                   "solvers/dpm.py", "utils/profiling.py", "utils/timing.py", "utils/env.py",
                   "utils/safetensors_io.py", "models/flux/load.py", "models/registry.py",
                   "models/text/t5.py", "models/text/clip.py", "models/text/clip_load.py",
                   "models/text/tokenizer_json.py", "rewards/tokenizer.py", "preprocess.py",
                   "sample.py", "serve.py", "rewards/base.py", "rewards/preprocess.py",
                   "rewards/clip_family.py", "rewards/image_reward.py",
                   "rewards/unified_reward.py", "rewards/vqa.py", "rewards/__init__.py",
                   "models/text/blip.py", "eval_rewards.py", "verify_weights.py",
                   "tsne_probe.py", "data/sampler.py", "data/native_loader.py",
                   "ops/quant.py", "parallel/__init__.py", "parallel/mesh.py",
                   "parallel/collectives.py", "parallel/ulysses.py", "parallel/ring.py",
                   "parallel/sharding.py", "models/hunyuan/__init__.py",
                   "models/hunyuan/scheduler.py", "models/hunyuan/model.py",
                   "models/hunyuan/load.py", "models/hunyuan/prompting.py",
                   "models/hunyuan/text_encoder.py", "models/hunyuan/vae3d.py",
                   "models/hunyuan/pipeline.py", "models/hunyuan/sampler.py",
                   "models/text/llama.py", "models/video_tiling.py",
                   "models/mochi/__init__.py", "models/mochi/model.py", "models/mochi/vae.py",
                   "models/mochi/latents.py", "models/mochi/convert.py", "models/mochi/load.py",
                   "models/mochi/pipeline.py", "models/discriminator.py", "solvers/distill.py",
                   "data/video.py", "data/video_io.py", "data/t2v_dataset.py"):
        assert f"mixgrpo_tpu_torch/{module}" in files


def test_native_sources_stay_inside_the_package():
    """The port builds only its own sources: the native reader's C++ source
    and the kernels' CUDA sources resolve to ``mixgrpo_tpu_torch/csrc/`` (its
    own copy of ``cacheloader.cpp``, not the repository's ``csrc/`` one),
    and so do their build directories."""
    from mixgrpo_tpu_torch.data import native_loader
    from mixgrpo_tpu_torch.ops import build

    pkg_csrc = os.path.join(ROOT, "mixgrpo_tpu_torch", "csrc")
    assert os.path.dirname(native_loader.SOURCE) == build.CSRC == pkg_csrc
    assert native_loader.BUILD_DIR == build.BUILD_DIR == os.path.join(pkg_csrc, "build")
    assert not os.path.samefile(native_loader.SOURCE, os.path.join(ROOT, "csrc", "cacheloader.cpp"))
    with open(native_loader.SOURCE) as f:
        src = f.read()
    for fn in ("cl_open", "cl_close", "cl_size", "cl_prefetch", "cl_read", "cl_gather_f16_rows"):
        assert f" {fn}(" in src


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
