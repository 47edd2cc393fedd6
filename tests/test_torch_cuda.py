"""Card-only tests of the port: the hand-written CUDA kernels against their
plain PyTorch versions (the forward with and without lse, the fused, dkv and
dq backward kernels), what they refuse, and the model and update paths
through them.

Every test carries the ``cuda`` marker and skips without a card.  This file
imports neither JAX nor the JAX package, so it also runs on a machine with
only PyTorch: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest`` skips the JAX set-up of tests/conftest.py).
"""

import pytest
import torch

from mixgrpo_tpu_torch.models.flux import model as M
from mixgrpo_tpu_torch.ops import flash_attention as FA
from mixgrpo_tpu_torch.rl.ppo import PPOConfig
from mixgrpo_tpu_torch.sample import DualFluxPipeline
from mixgrpo_tpu_torch.sampler import FluxSampler, quantized_timestep
from mixgrpo_tpu_torch.solvers.rollout import SamplerConfig
from mixgrpo_tpu_torch.solvers.schedule import sigma_schedule
from mixgrpo_tpu_torch.trainer import (
    UpdateBatch, make_optimizer, make_update_fns, recompute_log_prob,
)

pytestmark = pytest.mark.cuda


def assert_close_bf16(got, want, kv_len):
    """The kernel's tolerance against its plain version (as in chip_smoke.py):
    an output entry averages about kv_len unit-normal keys, so its scale is
    near sqrt(e/kv_len); |got - want| <= 0.15/sqrt(kv_len) + 1e-2*|want| and
    a relative L2 error <= 5e-3, a few bf16 ulps above rounding p in another
    order."""
    diff = got.float() - want.float()
    assert torch.isfinite(got).all()
    assert (diff.abs() <= 0.15 / kv_len ** 0.5 + 1e-2 * want.float().abs()).all()
    assert diff.norm() / want.float().norm() <= 5e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_kernel_matches_plain(dev, layout, D):
    """bf16 forward kernel, without and with lse, vs its plain version at
    ragged S/Sk and at the edges of its 128-row query and 128-key tiles (S = 1,
    Sk below one key tile, kv_valid one key into a tile, S not a multiple of
    the q tile), with no mask, a key mask and kv_valid; o by
    ``assert_close_bf16``, lse within 1e-3."""
    g = torch.Generator(dev).manual_seed(0)
    B, H = 2, 3
    shp = (lambda s: (B, s, H, D)) if layout == "bshd" else (lambda s: (B, H, s, D))
    for S, Sk, kv_valid in ((130, 201, 150), (1, 77, 65), (65, 40, 1), (70, 200, 129)):
        q, k, v = (torch.randn(shp(s), generator=g, device=dev).bfloat16()
                   for s in (S, Sk, Sk))
        mask = torch.rand((B, Sk), generator=g, device=dev) > 0.3
        mask[:, 0] = True
        for kw in ({}, {"mask": mask}, {"kv_valid": kv_valid}):
            before = FA.flash_attn_fwd.launches
            got = FA.flash_attention(q, k, v, layout=layout, **kw)
            torch.cuda.synchronize()
            assert FA.flash_attn_fwd.launches == before + 1
            want = FA.flash_attention_reference(q, k, v, layout=layout, **kw)
            kv_len = kw.get("kv_valid", Sk)
            assert_close_bf16(got, want, kv_len)
            kbias = FA._key_bias(mask, B, Sk) if "mask" in kw else None
            lw = dict(kbias=kbias, kv_len=kv_len, layout=layout)
            o, lse = FA.flash_attn_fwd_lse(FA._scaled_q(q), k, v, **lw)
            o_ref, lse_ref = FA.flash_attention_fwd_lse_reference(FA._scaled_q(q), k, v, **lw)
            assert_close_bf16(o, o_ref, kv_len)
            assert (lse - lse_ref).abs().max() <= 1e-3


def test_kernel_refuses_what_it_does_not_take(dev):
    """No fallback: unsupported inputs on the card raise instead of running
    the plain version."""
    q = torch.randn((1, 2, 64, 128), device=dev)
    before = FA.flash_attn_fwd.launches
    with pytest.raises(TypeError):
        FA.flash_attention(q, q, q)  # fp32
    with pytest.raises(TypeError):
        FA.flash_attention(q.half(), q.half(), q.half())  # fp16
    with pytest.raises(ValueError):
        x = torch.randn((1, 2, 64, 80), device=dev).bfloat16()
        FA.flash_attention(x, x, x)  # head dim 80
    with pytest.raises(ValueError):
        x = torch.randn((1, 2, 64, 256), device=dev).bfloat16()[..., ::2]
        FA.flash_attention(x, x, x)  # strided last axis
    assert FA.flash_attn_fwd.launches == before


def test_tiny_pipeline_kernel_path_matches_eager(dev):
    """Tiny DualFluxPipeline in bf16 on the card: attention through the
    kernel vs through the eager path; relative L2 of the latents < 2e-2."""
    cfg = M.FluxConfig.tiny()
    w = [M.init_flux(cfg, generator=torch.Generator(dev).manual_seed(s), device=dev,
                     dtype=torch.bfloat16) for s in (0, 1)]
    g = torch.Generator(dev).manual_seed(2)
    z0 = torch.randn((2, 16, cfg.in_channels), generator=g, device=dev)
    txt = torch.randn((2, 24, cfg.context_dim), generator=g, device=dev).bfloat16()
    pooled = torch.randn((2, cfg.pooled_dim), generator=g, device=dev).bfloat16()
    out = {}
    for impl in ("flash", "eager"):
        pipe = DualFluxPipeline(cfg, w[0], w[1], height=64, width=64, num_steps=4,
                                mix_sampling_steps=2, text_len=24, attn_impl=impl,
                                device=dev)
        out[impl] = pipe(txt, pooled, z0=z0).float()
    rel = (out["flash"] - out["eager"]).norm() / out["eager"].norm()
    assert torch.isfinite(out["flash"]).all() and rel < 2e-2, rel.item()


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_kernel_reads_projection_views(dev, layout):
    """q, k, v as the model makes them: views into one packed qkv projection
    (sequence stride 3*H*D, no copies), batch 1."""
    B, S, H, D = 1, 77, 4, 128
    qkv = torch.randn((B, S, 3 * H * D), device=dev).bfloat16()
    q, k, v = (t.reshape(B, S, H, D) for t in qkv.chunk(3, dim=-1))
    if layout == "bhsd":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    got = FA.flash_attention(q, k, v, layout=layout)
    want = FA.flash_attention_reference(q, k, v, layout=layout)
    assert_close_bf16(got, want, S)


def assert_close_grad(got, want):
    """A backward kernel's bf16 output against its plain version: both round
    p and ds to bf16 before their products and the outputs to bf16, so they
    differ by p landing on another bf16 neighbour after exp and by sums in
    another order: relative L2 <= 1e-2 and |got - want| <= 5e-2 max|want|
    (as in chip_smoke.py; measured on an H100 about 2e-4 relative L2)."""
    diff = got.float() - want.float()
    assert torch.isfinite(got).all()
    assert diff.norm() / want.float().norm() <= 1e-2
    assert diff.abs().max() <= 5e-2 * want.float().abs().max()


def _training_inputs(dev, layout, D, B=2, H=3, S=130, Sk=201, seed=1):
    g = torch.Generator(dev).manual_seed(seed)
    shp = (lambda s: (B, s, H, D)) if layout == "bshd" else (lambda s: (B, H, s, D))
    q, k, v = (torch.randn(shp(s), generator=g, device=dev).bfloat16() for s in (S, Sk, Sk))
    do = torch.randn(shp(S), generator=g, device=dev).bfloat16()
    mask = torch.rand((B, Sk), generator=g, device=dev) > 0.3
    mask[:, 0] = True
    return q, k, v, do, mask


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_training_kernels_match_plain(dev, layout, D):
    """The forward with lse, and the fused, dkv and dq backward kernels
    (each fed the kernel forward's o and lse, as is its plain version),
    ragged S/Sk, with no mask, a key mask and kv_valid; lse within 1e-3,
    o by ``assert_close_bf16``, dq/dk/dv by ``assert_close_grad``."""
    q, k, v, do, mask = _training_inputs(dev, layout, D)
    B, Sk = q.shape[0], k.shape[1 if layout == "bshd" else 2]
    qs = FA._scaled_q(q)
    for kbias, kv_len in ((None, None), (FA._key_bias(mask, B, Sk), None), (None, 150)):
        kw = dict(kbias=kbias, kv_len=kv_len, layout=layout)
        o, lse = FA.flash_attn_fwd_lse(qs, k, v, **kw)
        o_ref, lse_ref = FA.flash_attention_fwd_lse_reference(qs, k, v, **kw)
        assert_close_bf16(o, o_ref, kv_len or Sk)
        assert (lse - lse_ref).abs().max() <= 1e-3
        want = FA.flash_attention_bwd_reference(qs, k, v, o, lse, do, **kw)
        fused = FA.flash_attn_bwd_fused(qs, k, v, o, lse, do, **kw)
        dk, dv = FA.flash_attn_bwd_dkv(qs, k, v, o, lse, do, **kw)
        dq = FA.flash_attn_bwd_dq(qs, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        for got, w in zip((*fused, dq, dk, dv), (*want, *want)):
            assert_close_grad(got, w)


def test_dkv_writes_zeros_past_kv_len(dev):
    """Key tiles at or past kv_len get zero dk and dv from dkv and fused (the
    outputs come from torch.empty, so the kernels must write them), in both
    layouts and at D = 128; fused's dq gets nothing from them and matches
    its plain version."""
    for layout, D in (("bhsd", 64), ("bshd", 128)):
        q, k, v, do, _ = _training_inputs(dev, layout, D, S=100, Sk=300)
        qs = FA._scaled_q(q)
        kw = dict(kv_len=70, layout=layout)
        o, lse = FA.flash_attn_fwd_lse(qs, k, v, **kw)
        dq, dk_f, dv_f = FA.flash_attn_bwd_fused(qs, k, v, o, lse, do, **kw)
        for dk, dv in (FA.flash_attn_bwd_dkv(qs, k, v, o, lse, do, **kw), (dk_f, dv_f)):
            if layout == "bshd":
                dk, dv = dk.transpose(1, 2), dv.transpose(1, 2)
            assert (dk[:, :, 70:] == 0).all() and (dv[:, :, 70:] == 0).all()
            assert dk[:, :, :70].abs().sum() > 0
        assert_close_grad(dq, FA.flash_attention_bwd_reference(qs, k, v, o, lse, do, **kw)[0])


# (S, Sk, kv_valid, mask) at the edges of the dkv and fused kernels' 128-key
# blocks and 64-row q tiles
TILE_EDGES = ((1, 77, None, False), (1, 1, None, False), (65, 40, None, True),
              (70, 200, 129, False), (191, 130, 65, False), (129, 300, 100, False),
              (100, 300, None, True))


def _tile_edge_runs(dev, layout, D, kernel):
    """For each tile edge: ``kernel``'s outputs and the plain backward's
    (dq, dk, dv), on the kernel forward's o and lse, and Sk."""
    for S, Sk, kv_valid, mask in TILE_EDGES:
        q, k, v, do, m = _training_inputs(dev, layout, D, S=S, Sk=Sk)
        qs = FA._scaled_q(q)
        kw = dict(kbias=FA._key_bias(m, q.shape[0], Sk) if mask else None, kv_len=kv_valid,
                  layout=layout)
        o, lse = FA.flash_attn_fwd_lse(qs, k, v, **kw)
        want = FA.flash_attention_bwd_reference(qs, k, v, o, lse, do, **kw)
        got = kernel(qs, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        yield got, want, Sk


def assert_grad_or_noise(got, want, Sk):
    """``assert_close_grad``, except with a single key: a softmax over one key
    has no gradient, so dk and dq are 0 and both versions give the f32
    rounding noise of dp - delta (about 1e-7 here), which has no relative
    error; both must then be within 1e-4 of 0."""
    if Sk == 1:
        assert torch.isfinite(got).all()
        assert got.float().abs().max() <= 1e-4 and want.float().abs().max() <= 1e-4
    else:
        assert_close_grad(got, want)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_dkv_tile_edges(dev, layout, D):
    """The dkv kernel at the edges of its 128-key blocks and 64-row q tiles:
    S = 1, Sk = 1, Sk below one key block, kv_valid one key into a block,
    S not a multiple of the q tile, key blocks wholly past kv_valid (zeros),
    and a key mask; dk, dv by ``assert_close_grad`` (dk with one key by
    ``assert_grad_or_noise``)."""
    for (dk, dv), (_, dk_ref, dv_ref), Sk in _tile_edge_runs(dev, layout, D,
                                                             FA.flash_attn_bwd_dkv):
        assert_grad_or_noise(dk, dk_ref, Sk)
        assert_close_grad(dv, dv_ref)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_fused_tile_edges(dev, layout, D):
    """The fused kernel at the same edges: dq (summed across key blocks by TMA
    reduce-adds; rows past S never written), dk and dv by
    ``assert_close_grad`` (dq and dk with one key by
    ``assert_grad_or_noise``)."""
    for (dq, dk, dv), (dq_ref, dk_ref, dv_ref), Sk in _tile_edge_runs(dev, layout, D,
                                                                      FA.flash_attn_bwd_fused):
        assert_grad_or_noise(dq, dq_ref, Sk)
        assert_grad_or_noise(dk, dk_ref, Sk)
        assert_close_grad(dv, dv_ref)


def test_dkv_repeat_is_bit_identical(dev):
    """dkv has no atomics: two launches on the same inputs (ragged S and Sk,
    a key mask, bshd) give identical dk and dv."""
    q, k, v, do, m = _training_inputs(dev, "bshd", 128, S=700, Sk=650)
    qs = FA._scaled_q(q)
    kw = dict(kbias=FA._key_bias(m, q.shape[0], 650), layout="bshd")
    o, lse = FA.flash_attn_fwd_lse(qs, k, v, **kw)
    first = FA.flash_attn_bwd_dkv(qs, k, v, o, lse, do, **kw)
    second = FA.flash_attn_bwd_dkv(qs, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_fused_repeat(dev):
    """fused writes dk and dv with no atomics: two launches on the same inputs
    (ragged S and Sk, a key mask, bshd) give identical dk and dv; dq is summed
    across key blocks in an order that changes from run to run, so the two
    dq agree to f32 rounding before the cast (``assert_close_grad``)."""
    q, k, v, do, m = _training_inputs(dev, "bshd", 128, S=700, Sk=650)
    qs = FA._scaled_q(q)
    kw = dict(kbias=FA._key_bias(m, q.shape[0], 650), layout="bshd")
    o, lse = FA.flash_attn_fwd_lse(qs, k, v, **kw)
    first = FA.flash_attn_bwd_fused(qs, k, v, o, lse, do, **kw)
    second = FA.flash_attn_bwd_fused(qs, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first[1:], second[1:]))
    assert_close_grad(second[0], first[0])


@pytest.mark.parametrize("bwd", ["fused", "split"])
def test_autograd_through_kernels(dev, bwd):
    """``flash_attention`` under autograd launches the lse forward and the
    ``bwd`` kernels, and its q, k, v grads match the plain backward (dq
    carrying the 1/sqrt(D) scale, applied in bf16 as the wrapper's multiply
    does)."""
    q, k, v, do, _ = _training_inputs(dev, "bhsd", 128, S=160, Sk=160)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    before = {n: f.launches for n, f in FA.KERNEL_WRAPPERS.items()}
    FA.flash_attention(qg, kg, vg, kv_valid=150, bwd=bwd).backward(do)
    used = {n for n, f in FA.KERNEL_WRAPPERS.items() if f.launches != before[n]}
    assert used == ({"flash_attn_fwd_lse", "flash_attn_bwd_fused"} if bwd == "fused" else
                    {"flash_attn_fwd_lse", "flash_attn_bwd_dkv", "flash_attn_bwd_dq"})
    qs = FA._scaled_q(q)
    o, lse = FA.flash_attention_fwd_lse_reference(qs, k, v, kv_len=150)
    dqs, dk, dv = FA.flash_attention_bwd_reference(qs, k, v, o, lse, do, kv_len=150)
    dq = dqs * torch.tensor(1.0 / 128 ** 0.5, dtype=q.dtype).item()
    for got, want in ((qg.grad, dq), (kg.grad, dk), (vg.grad, dv)):
        assert_close_grad(got, want)


def test_training_kernels_refuse_what_they_do_not_take(dev):
    """No fallback in the backward either: wrong dtypes, head dims, lse
    shapes or strides raise before any launch."""
    q, k, v, do, _ = _training_inputs(dev, "bhsd", 64)
    qs = FA._scaled_q(q)
    o, lse = FA.flash_attn_fwd_lse(qs, k, v)
    before = {n: f.launches for n, f in FA.KERNEL_WRAPPERS.items()}
    bad = [
        (TypeError, (qs.float(), k, v, o, lse, do)),  # fp32 q
        (ValueError, (qs, k, v, o, lse[:, :, :-1], do)),  # lse of the wrong shape
        (ValueError, (qs, k, v, o, lse.double(), do)),  # lse not f32
        (ValueError, (qs, k, v, o, lse, do[..., ::2].contiguous())),  # do of another shape
        (ValueError, (qs, k, v, o, lse, torch.cat([do, do], -1)[..., ::2])),  # strided
        (ValueError, (qs.cpu(), k, v, o, lse, do)),  # two devices
    ]
    for fn in (FA.flash_attn_bwd_fused, FA.flash_attn_bwd_dkv, FA.flash_attn_bwd_dq):
        for err, args in bad:
            with pytest.raises(err):
                fn(*args)
    x = torch.randn((1, 2, 64, 80), device=dev).bfloat16()
    with pytest.raises(ValueError):
        FA.flash_attn_fwd_lse(x, x, x)  # head dim 80
    assert {n: f.launches for n, f in FA.KERNEL_WRAPPERS.items()} == before


def test_tiny_update_step_kernel_path_matches_eager(dev):
    """One bf16 ``update_step`` of a tiny FLUX at a padded joint sequence
    (S = 8 + 1024 -> 1152, kv_valid 1032) through the kernels vs through
    eager attention, from the same weights, old log-probs recomputed by the
    eager model (so the ratio is near 1): grad norms within 5e-2 relative
    (bf16 attention in two different orders), finite losses, and both steps
    move the parameters."""
    cfg = M.FluxConfig.tiny()
    sampler = FluxSampler(cfg, SamplerConfig(num_steps_max=4), height=512, width=512,
                          text_len=8, device=dev)
    g = torch.Generator(dev).manual_seed(3)
    N, L = 2, sampler.num_image_tokens
    x = torch.randn((N, L, cfg.in_channels), generator=g, device=dev)
    nxt = x + 0.05 * torch.randn(x.shape, generator=g, device=dev)
    txt = torch.randn((N, 8, cfg.context_dim), generator=g, device=dev).bfloat16()
    pooled = torch.randn((N, cfg.pooled_dim), generator=g, device=dev).bfloat16()
    t_index = torch.tensor([0, 2], device=dev)
    sig = torch.as_tensor(sigma_schedule(4, 3.0), device=dev)
    make = lambda: M.init_flux(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    with torch.no_grad():
        t = quantized_timestep(sig[t_index])
        pred = M.flux_forward(make(), cfg, x.bfloat16(), txt, pooled, t,
                              torch.full((N,), 3.5, device=dev), sampler.rope_cos,
                              sampler.rope_sin, attn_impl="eager")
        old = recompute_log_prob(sampler.sampler_cfg, pred, x, nxt, sig, t_index)
    batch = UpdateBatch(latents=x, next_latents=nxt, t_index=t_index, old_log_probs=old,
                        advantages=torch.tensor([1.0, -1.0], device=dev), txt=txt,
                        pooled=pooled)
    out = {}
    for impl in ("flash", "eager"):
        params = make()
        before = M.param_leaves(params)[0].detach().clone()
        opt = make_optimizer(learning_rate=1e-4)
        step, _, _ = make_update_fns(cfg, sampler.sampler_cfg, PPOConfig(clip_range=0.2), opt,
                                     sampler.rope_cos, sampler.rope_sin, attn_impl=impl,
                                     remat=True)
        launched = FA.flash_attn_bwd_fused.launches
        params, _, m = step(params, opt.init(params), batch, sig)
        assert (FA.flash_attn_bwd_fused.launches > launched) == (impl == "flash")
        assert not torch.equal(before, M.param_leaves(params)[0])
        out[impl] = {k: float(v) for k, v in m.items()}
    assert all(torch.isfinite(torch.tensor(list(o.values()))).all() for o in out.values())
    assert abs(out["flash"]["grad_norm"] - out["eager"]["grad_norm"]) <= \
        5e-2 * out["eager"]["grad_norm"]
