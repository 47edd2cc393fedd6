"""Port's RL pieces vs the JAX package on the same numpy inputs.

Advantages (every variant, masked and trimmed included), the PPO loss, the
pos/neg balancing permutation (same numpy generator state), the sliding
window's state sequences for every strategy, and the sigma schedules.
Tolerances: fp32 within 1e-5 relative/1e-6 absolute (the same f32 ops in
another order); integer results (permutations, window states, masks) and the
numpy schedules must be equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu.rl import advantage as JA
from mixgrpo_tpu.rl import balance as JB
from mixgrpo_tpu.rl import ppo as JP
from mixgrpo_tpu.rl import window as JW
from mixgrpo_tpu.solvers import schedule as JS
from mixgrpo_tpu_torch.rl import advantage as A
from mixgrpo_tpu_torch.rl import balance as Bal
from mixgrpo_tpu_torch.rl import ppo as P
from mixgrpo_tpu_torch.rl import window as W
from mixgrpo_tpu_torch.solvers import schedule as S


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _rewards(seed, n=24, models=("a", "b")):
    rng = np.random.default_rng(seed)
    r = {m: rng.standard_normal(n).astype(np.float32) for m in models}
    s = {m: (rng.random(n) > 0.25).astype(np.float32) for m in models}
    s["a"][:4] = 1.0  # group 0 of model a: all successful
    s["b"][4:8] = 0.0  # group 1 of model b: all failed
    return r, s


@pytest.mark.parametrize("trim", [0.0, 0.25, 0.5])
def test_group_and_global_advantages(trim):
    r, _ = _rewards(0)
    x = r["a"]
    _close(A.group_advantages(torch.from_numpy(x), 4, trim),
           JA.group_advantages(jnp.asarray(x), 4, trim))
    _close(A.global_advantages(torch.from_numpy(x[:8]), torch.from_numpy(x)),
           JA.global_advantages(jnp.asarray(x[:8]), jnp.asarray(x)))


@pytest.mark.parametrize("trim", [0.0, 0.34])
def test_mixed_and_masked_advantages(trim):
    r, s = _rewards(1)
    w = {"a": 1.0, "b": 0.5}
    rt = {k: torch.from_numpy(v) for k, v in r.items()}
    st = {k: torch.from_numpy(v) for k, v in s.items()}
    rj = {k: jnp.asarray(v) for k, v in r.items()}
    sj = {k: jnp.asarray(v) for k, v in s.items()}
    _close(A.mix_advantages(rt, w, 6, trim), JA.mix_advantages(rj, w, 6, trim))
    _close(A.mix_rewards(rt, w), JA.mix_rewards(rj, w))
    _close(A.masked_group_advantages(rt["b"], st["b"], 6, trim),
           JA.masked_group_advantages(rj["b"], sj["b"], 6, trim))
    _close(A.masked_mix_advantages(rt, st, w, 6, trim),
           JA.masked_mix_advantages(rj, sj, w, 6, trim))
    _close(A.masked_mix_rewards(rt, st, w), JA.masked_mix_rewards(rj, sj, w))


def test_masked_advantages_reduce_to_plain_with_all_successes():
    r, _ = _rewards(2)
    x = torch.from_numpy(r["a"])
    _close(A.masked_group_advantages(x, torch.ones_like(x), 4), A.group_advantages(x, 4))


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("kl", [0.0, 0.1])
def test_ppo_loss(mask, kl):
    rng = np.random.default_rng(3)
    new = rng.normal(0, 1e-3, (6, 4)).astype(np.float32)
    old = rng.normal(0, 1e-3, (6, 4)).astype(np.float32)
    adv = (rng.standard_normal((6, 1)) * 4).astype(np.float32)
    m = (rng.random((6, 4)) > 0.3) if mask else None
    cfg = dict(clip_range=1e-4, adv_clip_max=5.0, kl_coeff=kl)
    lt, mt = P.ppo_loss(torch.from_numpy(new), torch.from_numpy(old), torch.from_numpy(adv),
                        P.PPOConfig(**cfg), loss_scale=0.5,
                        mask=None if m is None else torch.from_numpy(m))
    lj, mj = JP.ppo_loss(jnp.asarray(new), jnp.asarray(old), jnp.asarray(adv),
                         JP.PPOConfig(**cfg), loss_scale=0.5,
                         mask=None if m is None else jnp.asarray(m))
    _close(lt, lj)
    assert set(mt) == set(mj)
    for k in mj:
        _close(mt[k], mj[k])


@pytest.mark.parametrize("use_random", [False, True])
def test_balance_pos_neg_same_rng(use_random):
    adv = np.array([0.5, -1.0, 0.0, 2.0, -0.2, -0.3, 0.1, 0.0, -2.0, 1.5])
    got = Bal.balance_pos_neg(adv, np.random.default_rng(7), use_random=use_random)
    want = JB.balance_pos_neg(adv, np.random.default_rng(7), use_random=use_random)
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(len(adv)))


WINDOWS = [
    dict(sample_strategy="progressive", prog_overlap=True, roll_back=True),
    dict(sample_strategy="progressive", prog_overlap=False, roll_back=False),
    dict(sample_strategy="random"),
    dict(sample_strategy="decay", max_iters_per_group=6, min_iters_per_group=1,
         roll_back=True),
    dict(sample_strategy="exp_decay", exp_decay_thre_timestep=5, exp_decay_k=0.3,
         roll_back=True),
]


@pytest.mark.parametrize("kw", WINDOWS, ids=lambda k: k["sample_strategy"])
def test_window_state_sequences(kw):
    """80 iterations (past roll-backs and clips) of every strategy give the
    same window, iteration counter and state dict; from_dict round-trips."""
    base = dict(iters_per_group=3, group_size=4, max_timesteps=23, **kw)
    tw, jw = W.SlidingWindowState(**base), JW.SlidingWindowState(**base)
    for it in range(80):
        assert tw.get_current_timesteps() == jw.get_current_timesteps()
        assert tw.is_training_complete() == jw.is_training_complete()
        tw.update_iteration(rng=714 + it)
        jw.update_iteration(rng=714 + it)
        assert (tw.cur_timestep, tw.cur_iter_in_group) == (jw.cur_timestep,
                                                           jw.cur_iter_in_group)
    assert tw.to_dict() == dataclasses.asdict(jw)
    assert W.SlidingWindowState.from_dict(tw.to_dict()) == tw


@pytest.mark.parametrize("T,shift", [(25, 3.0), (6, 1.0), (50, 3.0)])
def test_schedules(T, shift):
    np.testing.assert_array_equal(S.sigma_schedule(T, shift), JS.sigma_schedule(T, shift))
    for window in ([0, 1, 2, 3], [5], []):
        window = [t for t in window if t < T]
        np.testing.assert_array_equal(S.deterministic_mask(T, window),
                                      JS.deterministic_mask(T, window))
        det = S.deterministic_mask(T, window)
        base = S.sigma_schedule(T, shift)
        got = S.flash_post_schedule(base, det, shift, 0.4, pad_to=T)
        want = JS.flash_post_schedule(base, det, shift, 0.4, pad_to=T)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
