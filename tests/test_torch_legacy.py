"""The port's legacy distillation modules (``solvers/distill.py``,
``models/discriminator.py``) against the JAX package on the same inputs.

- ``linear_quadratic_schedule`` (Python float arithmetic cast to f32, the
  Mochi pipeline's schedule) and ``pcm_sigma_schedule`` (time-shifted and
  linear-quadratic): bit for bit.
- ``EulerSolver``: the tables bit for bit; ``euler_step`` and
  ``multiphase_pred`` (phase ends and jumps, ``is_target`` both ways):
  atol 1e-6; the exact linear path stays on the path (rtol 1e-5, as JAX's
  test).
- ``pcm_scheduler_step``: atol 1e-6 per step, and three steps land on x0.
- ``discriminator_forward`` with JAX's init carried over: atol 1e-5 in
  f32; the port's init has JAX's tree structure and shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu.models import discriminator as JDisc
from mixgrpo_tpu.solvers import distill as JDist
from mixgrpo_tpu_torch.convert import from_jax_params
from mixgrpo_tpu_torch.models import discriminator as Disc
from mixgrpo_tpu_torch.solvers import distill as Dist


@pytest.mark.parametrize("steps, threshold, linear", [(64, 0.025, 32), (100, 0.025, 50),
                                                      (3, 0.025, 1), (1000, 0.025, 500),
                                                      (50, 0.1, None)])
def test_linear_quadratic_schedule_is_jax_bit_for_bit(steps, threshold, linear):
    got = Dist.linear_quadratic_schedule(steps, threshold, linear)
    want = JDist.linear_quadratic_schedule(steps, threshold, linear)
    assert got.dtype == want.dtype == np.float32 and got.shape == (steps,)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 1.0


def test_pcm_schedule_and_euler_solver_match_jax():
    for kw in (dict(shift=3.0), dict(shift=1.0), dict(linear_quadratic=True)):
        got, want = Dist.pcm_sigma_schedule(1000, **kw), JDist.pcm_sigma_schedule(1000, **kw)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    sig = Dist.pcm_sigma_schedule(1000, shift=3.0)
    solver = Dist.EulerSolver.build(sig, 1000, euler_timesteps=50)
    jsolver = JDist.EulerSolver.build(sig, 1000, euler_timesteps=50)
    for a, b in zip(solver, jsolver):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype

    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(3, 8)).astype(np.float32)
    eps = rng.normal(size=(3, 8)).astype(np.float32)
    t_idx = np.asarray([10, 30, 49])
    s = solver.sigmas[t_idx, None]
    sample = ((1 - s) * x0 + s * eps).astype(np.float32)
    pred = (eps - x0).astype(np.float32)
    stepped = solver.euler_step(torch.from_numpy(sample), torch.from_numpy(pred), t_idx)
    want = jsolver.euler_step(jnp.asarray(sample), jnp.asarray(pred), t_idx)
    np.testing.assert_allclose(stepped.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    sp = solver.sigmas_prev[t_idx, None]
    np.testing.assert_allclose(stepped.numpy(), (1 - sp) * x0 + sp * eps, rtol=1e-5)
    for phases in (1, 4, 7):
        for target in (False, True):
            got, te = solver.multiphase_pred(torch.from_numpy(sample), torch.from_numpy(pred),
                                             t_idx, multiphase=phases, is_target=target)
            want, jte = jsolver.multiphase_pred(jnp.asarray(sample), jnp.asarray(pred), t_idx,
                                                multiphase=phases, is_target=target)
            np.testing.assert_array_equal(te.numpy(), np.asarray(jte))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
            assert (te.numpy() <= t_idx).all()
    # the jump lands on its phase boundary's sigma
    got, te = solver.multiphase_pred(torch.from_numpy(sample), torch.from_numpy(pred), t_idx, 4)
    sp = solver.sigmas_prev[te.numpy(), None]
    np.testing.assert_allclose(got.numpy(), (1 - sp) * x0 + sp * eps, rtol=1e-5)


def test_pcm_scheduler_step_matches_jax():
    sig = np.asarray([0.8, 0.5, 0.2, 0.0], np.float32)
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=(2, 4)).astype(np.float32)
    eps = rng.normal(size=(2, 4)).astype(np.float32)
    z = ((1 - sig[0]) * x0 + sig[0] * eps).astype(np.float32)
    jz, tz = jnp.asarray(z), torch.from_numpy(z)
    for i in range(3):
        jz = JDist.pcm_scheduler_step(sig, i, jnp.asarray(eps - x0), jz)
        tz = Dist.pcm_scheduler_step(sig, i, torch.from_numpy(eps - x0), tz)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tz.numpy(), x0, rtol=1e-5)


def test_discriminator_matches_jax():
    cfg = Disc.DiscriminatorConfig(stride=2, num_h_per_head=2, adapter_channels=(32,),
                                   total_layers=4, inner_channels=64, groups=8)
    jcfg = JDisc.DiscriminatorConfig(stride=2, num_h_per_head=2, adapter_channels=(32,),
                                     total_layers=4, inner_channels=64, groups=8)
    assert cfg.head_channels == jcfg.head_channels == (32, 32)
    jp = JDisc.init_discriminator(jax.random.key(0), jcfg)
    rng = np.random.default_rng(2)
    tree = jax.tree.map(lambda a: (np.asarray(a) + (0.1 * rng.standard_normal(a.shape)
                                                    if a.ndim == 1 else 0)).astype(np.float32),
                        jp)  # biases and GroupNorm affines off their init
    mine = Disc.init_discriminator(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.structure(mine) == jax.tree.structure(tree)
    assert [tuple(t.shape) for t in jax.tree.leaves(mine)] == [a.shape for a in
                                                               jax.tree.leaves(tree)]
    feats = [rng.standard_normal((2, 12, 32)).astype(np.float32) * (1 + i) for i in range(2)]
    want = JDisc.discriminator_forward(jax.tree.map(jnp.asarray, tree), jcfg,
                                       [jnp.asarray(f) for f in feats])
    got = Disc.discriminator_forward(from_jax_params(tree, "cpu"), cfg,
                                     [torch.from_numpy(f) for f in feats])
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 12, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="feature maps"):
        Disc.discriminator_forward(from_jax_params(tree, "cpu"), cfg, feats[:1])
