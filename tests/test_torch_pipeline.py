"""The port's serving slice as a whole vs the JAX package.

``DualFluxPipeline`` with tiny base and tuned FLUX weights and a tiny VAE,
all drawn by JAX and carried over with ``convert.from_jax_params``, the same
``z0``, 32x32 images, 3 steps (2 tuned + 1 base), with and without
``max_steps_per_call``: images agree within fp32 atol 1e-4 (the model's
matmuls and the decoder's convolutions sum in another order).  Then the HTTP
round trip through ``InferenceServer`` + ``RequestBatcher`` +
``make_generate_fn`` with a crc32-seeded stand-in for the text encoders.
"""

import base64
import dataclasses
import io
import json
import os
import threading
import urllib.request
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu import presets as JP
from mixgrpo_tpu import sample as JSa
from mixgrpo_tpu.models.flux import model as JM
from mixgrpo_tpu.models.flux import vae as JV
from mixgrpo_tpu_torch import presets as P
from mixgrpo_tpu_torch import sample as Sa
from mixgrpo_tpu_torch.convert import from_jax_params
from mixgrpo_tpu_torch.models.flux import model as M
from mixgrpo_tpu_torch.models.flux import vae as V
from mixgrpo_tpu_torch.serve import InferenceServer, RequestBatcher, make_generate_fn

TEXT_LEN = 8


@pytest.fixture(scope="module")
def weights():
    jcfg = JM.FluxConfig.tiny()
    jvcfg = JV.VAEConfig.tiny(latent_channels=jcfg.in_channels // 4)
    init = jax.jit(lambda k: JM.init_flux(k, jcfg))
    j = {"base": init(jax.random.key(0)), "tuned": init(jax.random.key(1)),
         "vae": jax.jit(lambda k: JV.init_vae_decoder(k, jvcfg))(jax.random.key(2))}
    t = {k: from_jax_params(jax.tree.map(np.asarray, v), "cpu") for k, v in j.items()}
    return jcfg, jvcfg, j, t


def _port_pipe(weights, **kw):
    jcfg, jvcfg, _, t = weights
    cfg = M.FluxConfig.tiny()
    vcfg = V.VAEConfig.tiny(latent_channels=cfg.in_channels // 4)
    return Sa.DualFluxPipeline(
        cfg, t["base"], t["tuned"], vae_cfg=vcfg, vae_params=t["vae"],
        height=32, width=32, num_steps=3, mix_sampling_steps=2, text_len=TEXT_LEN,
        dtype=torch.float32, device="cpu", **kw)


@pytest.mark.parametrize("max_steps_per_call", [None, 1])
def test_dual_pipeline_matches_jax(weights, max_steps_per_call):
    jcfg, jvcfg, j, _ = weights
    jpipe = JSa.DualFluxPipeline(
        jcfg, j["base"], j["tuned"], vae_cfg=jvcfg, vae_params=j["vae"],
        height=32, width=32, num_steps=3, mix_sampling_steps=2, text_len=TEXT_LEN,
        dtype=jnp.float32, attn_impl="xla", max_steps_per_call=max_steps_per_call)
    pipe = _port_pipe(weights, max_steps_per_call=max_steps_per_call)
    np.testing.assert_array_equal(pipe.sigmas, jpipe.sigmas)
    rng = np.random.default_rng(0)
    z0 = rng.standard_normal((2, 4, jcfg.in_channels)).astype(np.float32)
    txt = rng.standard_normal((2, TEXT_LEN, jcfg.context_dim)).astype(np.float32)
    pooled = rng.standard_normal((2, jcfg.pooled_dim)).astype(np.float32)
    want = jpipe(jnp.asarray(txt), jnp.asarray(pooled), jax.random.key(0),
                 z0=jnp.asarray(z0))
    got = pipe(torch.from_numpy(txt), torch.from_numpy(pooled),
               z0=torch.from_numpy(z0))
    assert tuple(got.shape) == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_schedule_and_presets_match_jax():
    for n, seq in ((3, 4), (50, 4096), (4, 2025)):
        mu = Sa.calculate_shift(seq)
        assert mu == JSa.calculate_shift(seq)
        np.testing.assert_array_equal(Sa.dynamic_shift_sigmas(n, mu),
                                      JSa.dynamic_shift_sigmas(n, mu))
    for name in ("flux-dev", "tiny"):
        mine, ref = P.flux_family(name), JP.flux_family(name)
        for key in ("flux", "vae"):
            assert dataclasses.asdict(mine[key]) == dataclasses.asdict(ref[key])
    with pytest.raises(ValueError):
        P.flux_family("sdxl")


def test_pipeline_refuses_int8(weights):
    """``quant="int8"`` is ported: the int8 pipeline's images agree with JAX's
    int8 pipeline within 1e-3 (JAX quantises under ``jax.jit``, which rounds
    one weight of the tiny model to the neighbouring step, and an activation
    whose f32 value differs in its last bit can round to the neighbouring
    step; measured 3.0e-4).  An unknown ``quant`` is refused."""
    jcfg, jvcfg, j, _ = weights
    jpipe = JSa.DualFluxPipeline(
        jcfg, j["base"], j["tuned"], vae_cfg=jvcfg, vae_params=j["vae"],
        height=32, width=32, num_steps=3, mix_sampling_steps=2, text_len=TEXT_LEN,
        dtype=jnp.float32, attn_impl="xla", quant="int8")
    pipe = _port_pipe(weights, quant="int8")
    assert pipe.base_params["double"]["img_qkv"]["w_q"].dtype == torch.int8
    rng = np.random.default_rng(0)
    z0 = rng.standard_normal((2, 4, jcfg.in_channels)).astype(np.float32)
    txt = rng.standard_normal((2, TEXT_LEN, jcfg.context_dim)).astype(np.float32)
    pooled = rng.standard_normal((2, jcfg.pooled_dim)).astype(np.float32)
    want = jpipe(jnp.asarray(txt), jnp.asarray(pooled), jax.random.key(0), z0=jnp.asarray(z0))
    got = pipe(torch.from_numpy(txt), torch.from_numpy(pooled), z0=torch.from_numpy(z0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="quant"):
        _port_pipe(weights, quant="int4")


def test_default_device_is_cuda_without_fallback():
    """Entry points default to ``device="cuda"``; without a card that raises
    instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        Sa.DualFluxPipeline(M.FluxConfig.tiny(), {}, height=32, width=32,
                            num_steps=2, text_len=TEXT_LEN)


def test_save_outputs_writes_pngs(tmp_path):
    imgs = torch.rand((2, 8, 8, 3))
    meta = Sa.save_outputs(imgs, ["a", "b"], str(tmp_path), [5, 6])
    assert [m["seed"] for m in meta] == [5, 6]
    assert all(os.path.exists(tmp_path / m["image"]) for m in meta)


def _encode(prompts):
    """Stand-in for the T5/CLIP encoders: a stable per-prompt seed."""
    cfg = M.FluxConfig.tiny()
    rngs = [np.random.default_rng(zlib.crc32(p.encode())) for p in prompts]
    txt = np.stack([r.standard_normal((TEXT_LEN, cfg.context_dim)) for r in rngs])
    pooled = np.stack([r.standard_normal((cfg.pooled_dim,)) for r in rngs])
    return txt.astype(np.float32), pooled.astype(np.float32)


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _pixels(png):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(png)), np.int16)


def test_http_round_trip_and_seed_reproducibility(weights):
    pipe = _port_pipe(weights)
    gen = make_generate_fn(pipe, _encode)
    batcher = RequestBatcher(gen, batch_size=2, max_wait_ms=200.0,
                             generate_fn_single=gen)
    out = {}
    with InferenceServer(batcher, host="127.0.0.1", port=0) as srv:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthz",
                                    timeout=30) as r:
            assert r.read() == b"ok"
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, _post(srv.port, {"prompt": f"a cat {i}", "seed": i}))) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        status, ctype, alone = _post(srv.port, {"prompt": "a cat 0", "seed": 0,
                                                "format": "json"})
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/stats",
                                    timeout=30) as r:
            stats = json.loads(r.read())
    assert status == 200 and ctype == "application/json"
    for i in range(2):
        assert out[i][0] == 200 and out[i][1] == "image/png"
        assert _pixels(out[i][2]).shape == (32, 32, 3)
    assert stats["requests"] == 3 and stats["single_dispatches"] == 1
    # the same (prompt, seed) alone (batch 1) and co-batched (batch 2): the
    # seed fixes its noise row; batch-shape-dependent matmul blocking may move
    # a pixel by one 8-bit level at most
    again = _pixels(base64.b64decode(json.loads(alone)["png_base64"]))
    assert np.abs(again - _pixels(out[0][2])).max() <= 1
    a = gen(["a cat 0", "a dog"], [0, 9])
    b = gen(["a cat 0"], [0])
    np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-5)

