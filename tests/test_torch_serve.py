"""The port's continuous batching (``serve.ContinuousEngine``,
``ContinuousBatcher``) on a tiny f32 FLUX, 32x32 images, text length 8.

- ``ContinuousEngine.run`` against JAX's on the same weights, latents, text,
  per-row offsets (one row frozen from the start, one that freezes
  mid-chunk) and ``t_end``: within 2e-4 (the f32 forward parity's tolerance;
  the model's matmuls sum in another order).
- The four scenarios of JAX's ``tests/test_serve.py`` for
  ``ContinuousBatcher``, each request's result against the port's own
  one-shot pipeline for its (prompt, seed) within 2e-5: a burst of twice
  the slot count through two pools (mid-flight admission, every request
  migrated once); a single-model pipeline whose chunk does not divide the
  steps; the latency tier (a lone request through ``single_fn``, then a
  burst through the pools); an encoder error that reaches its request, then
  recovery.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu import sample as JSa
from mixgrpo_tpu import serve as JSe
from mixgrpo_tpu.models.flux import model as JM
from mixgrpo_tpu_torch import sample as Sa
from mixgrpo_tpu_torch.convert import from_jax_params
from mixgrpo_tpu_torch.models.flux import model as M
from mixgrpo_tpu_torch.serve import ContinuousBatcher, ContinuousEngine, make_generate_fn

TEXT_LEN = 8


def _pipe(base, tuned, num_steps=6, mix=3, chunk=2):
    return Sa.DualFluxPipeline(M.FluxConfig.tiny(), base, tuned, height=32, width=32,
                               num_steps=num_steps, mix_sampling_steps=mix, text_len=TEXT_LEN,
                               dtype=torch.float32, max_steps_per_call=chunk, device="cpu")


@pytest.fixture(scope="module")
def weights():
    cfg = M.FluxConfig.tiny()
    return [M.init_flux(cfg, generator=torch.Generator().manual_seed(s), device="cpu")
            for s in (0, 1)]


def _encode(prompts):
    cfg = M.FluxConfig.tiny()
    rngs = [np.random.default_rng(sum(map(ord, p))) for p in prompts]
    txt = np.stack([r.normal(size=(TEXT_LEN, cfg.context_dim)) for r in rngs])
    pooled = np.stack([r.normal(size=(cfg.pooled_dim,)) for r in rngs])
    return txt.astype(np.float32), pooled.astype(np.float32)


def _one_shot(pipe, prompt, seed):
    """The pipeline alone at batch 1, with the request's own noise row."""
    txt, pooled = _encode([prompt])
    sampler = pipe._seg1 or pipe._seg2
    z0 = sampler.init_noise(torch.Generator("cpu").manual_seed(seed), 1)
    return pipe(torch.from_numpy(txt), torch.from_numpy(pooled), z0=z0)[0].numpy()


def _burst(b, requests):
    results = {}
    threads = [threading.Thread(target=lambda k=k, p=p, s=s: results.__setitem__(
        k, b.submit(p, s, timeout=300))) for k, (p, s) in enumerate(requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return results


def test_engine_run_matches_jax():
    jcfg = JM.FluxConfig.tiny()
    jb, jt = (JM.init_flux(jax.random.key(s), jcfg) for s in (0, 1))
    jpipe = JSa.DualFluxPipeline(jcfg, jb, jt, height=32, width=32, num_steps=6,
                                 mix_sampling_steps=3, text_len=TEXT_LEN, dtype=jnp.float32,
                                 attn_impl="xla", max_steps_per_call=2)
    pipe = _pipe(*(from_jax_params(jax.tree.map(np.asarray, p), "cpu") for p in (jb, jt)))
    rng = np.random.default_rng(0)
    B, S = 4, 4
    z = rng.standard_normal((B, S, jcfg.in_channels)).astype(np.float32)
    txt = rng.standard_normal((B, TEXT_LEN, jcfg.context_dim)).astype(np.float32)
    pooled = rng.standard_normal((B, jcfg.pooled_dim)).astype(np.float32)
    offsets = np.array([0, 2, 3, 5], np.int32)  # t_end 4: row 2 freezes after a step, 3 stays
    jeng, eng = JSe.ContinuousEngine(jpipe), ContinuousEngine(pipe)
    assert eng.chunk == jeng.chunk == 2 and eng.T == jeng.T == 6
    np.testing.assert_array_equal(eng.sigmas.numpy(), jeng.sigmas)
    want = np.asarray(jeng.run(jpipe.base_params, jnp.asarray(z), jnp.asarray(txt),
                               jnp.asarray(pooled), offsets, 4))
    got = eng.run(pipe.base_params, torch.from_numpy(z), torch.from_numpy(txt),
                  torch.from_numpy(pooled), offsets, 4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(got[3].numpy(), z[3])  # frozen throughout


def test_continuous_batcher_matches_pipeline_under_burst(weights):
    """A burst of twice the slot count: mid-flight admission, and every
    request moves from the tuned pool to the base pool once."""
    pipe = _pipe(*weights)
    b = ContinuousBatcher(pipe, _encode, batch_size=2)
    try:
        requests = [(f"prompt-{i}", 100 + i) for i in range(4)]
        results = _burst(b, requests)
        for k, (p, s) in enumerate(requests):
            np.testing.assert_allclose(results[k], _one_shot(pipe, p, s), rtol=2e-5, atol=2e-5)
        assert b.stats["mid_flight_admissions"] >= 1
        assert b.stats["migrations"] == 4
        assert b.stats["requests"] == 4 and b.stats["errors"] == 0
    finally:
        b.close()


def test_continuous_batcher_single_model_and_unaligned_boundary(weights):
    """One pool, 5 steps in chunks of 2 + 2 + 1: the row freezes mid-chunk."""
    pipe = _pipe(weights[0], None, num_steps=5, chunk=2)
    b = ContinuousBatcher(pipe, _encode, batch_size=2)
    try:
        assert len(b.pools) == 1
        got = b.submit("lonely", 7, timeout=300)
        np.testing.assert_allclose(got, _one_shot(pipe, "lonely", 7), rtol=2e-5, atol=2e-5)
        assert b.stats["batches"] == 3
    finally:
        b.close()


def test_continuous_batcher_latency_tier(weights):
    """A lone request on an idle system rides ``single_fn``; a 3-deep burst
    goes through the pools; every result is its one-shot image."""
    pipe = _pipe(*weights)
    b = ContinuousBatcher(pipe, _encode, batch_size=2, single_fn=make_generate_fn(pipe, _encode))
    try:
        lone = b.submit("prompt-solo", 42, timeout=300)
        assert b.stats["single_dispatches"] == 1 and b.stats["requests"] == 1
        assert b.stats["batches"] == 0
        np.testing.assert_allclose(lone, _one_shot(pipe, "prompt-solo", 42), rtol=2e-5, atol=2e-5)
        requests = [(f"prompt-{i}", 100 + i) for i in range(3)]
        results = _burst(b, requests)
        for k, (p, s) in enumerate(requests):
            np.testing.assert_allclose(results[k], _one_shot(pipe, p, s), rtol=2e-5, atol=2e-5)
        assert b.stats["requests"] == 4 and b.stats["errors"] == 0
    finally:
        b.close()


def test_continuous_batcher_error_surfaces_and_recovers(weights):
    pipe = _pipe(*weights)
    boom = {"on": True}

    def flaky_encode(prompts):
        if boom["on"]:
            raise RuntimeError("encoder exploded")
        return _encode(prompts)

    b = ContinuousBatcher(pipe, flaky_encode, batch_size=2)
    try:
        with pytest.raises(RuntimeError, match="encoder exploded"):
            b.submit("bad", 1, timeout=60)
        boom["on"] = False
        out = b.submit("good", 2, timeout=300)
        np.testing.assert_allclose(out, _one_shot(pipe, "good", 2), rtol=2e-5, atol=2e-5)
        assert b.stats["errors"] == 1 and b.stats["requests"] == 1
    finally:
        b.close()
