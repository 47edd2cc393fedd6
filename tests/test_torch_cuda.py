"""Card-only tests of the port: the hand-written CUDA kernels against their
plain PyTorch versions (the forward with and without lse, the fused, dkv and
dq backward kernels), what they refuse, and the model and update paths
through them (LoRA's update among them), a MixGRPO-Flash rollout on the
card against the CPU, ``backend_smoke``, the safetensors reader's BF16 path
straight to the card, T5 and CLIP on the card against the CPU, the four
reward models on a CUDA batch (bf16 against f32, no kernel launch), and the
video DiTs' shapes: HunyuanVideo's masked forward and Mochi's final block
(Sq != Sk), and both pipelines at a tiny size.

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
# blocks and 64-row q tiles, and of the dq kernel's 128-row q blocks (two
# 64-row warpgroups; S = 65 leaves the second one row, S = 64 none) and
# 64-key tiles
TILE_EDGES = ((1, 77, None, False), (1, 1, None, False), (65, 40, None, True),
              (70, 200, 129, False), (191, 130, 65, False), (129, 300, 100, False),
              (100, 300, None, True), (64, 193, None, True))


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


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_dq_tile_edges(dev, layout, D):
    """The dq kernel at the same edges, which include its own: S = 1, a
    second warpgroup with one row (S = 65) or none (S = 64), S not a
    multiple of its 128-row block, Sk below one 64-key tile, kv_valid one key
    into a tile, and a key mask; dq by ``assert_grad_or_noise`` (0 with one
    key)."""
    for dq, (dq_ref, _, _), Sk in _tile_edge_runs(dev, layout, D, FA.flash_attn_bwd_dq):
        assert_grad_or_noise(dq, dq_ref, Sk)


def test_dq_repeat_is_bit_identical(dev):
    """dq has no atomics (each row is written once): two launches on the same
    inputs (ragged S and Sk, a key mask, bshd) give identical dq."""
    q, k, v, do, m = _training_inputs(dev, "bshd", 128, S=700, Sk=650)
    qs = FA._scaled_q(q)
    kw = dict(kbias=FA._key_bias(m, q.shape[0], 650), layout="bshd")
    o, lse = FA.flash_attn_fwd_lse(qs, k, v, **kw)
    first = FA.flash_attn_bwd_dq(qs, k, v, o, lse, do, **kw)
    second = FA.flash_attn_bwd_dq(qs, k, v, o, lse, do, **kw)
    assert torch.equal(first, second)


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


def test_tiny_lora_update_step_kernel_path_matches_eager(dev):
    """One LoRA ``update_step`` over a frozen bf16 tiny FLUX (rank 4, ``b``
    made nonzero) at the padded joint sequence above, through the kernels vs
    through eager attention, from the same base and factors: grad norms
    within 5e-2 relative (bf16 attention in two different orders), finite
    losses, the factors move and the base is left bit for bit."""
    from mixgrpo_tpu_torch.lora import init_lora
    from mixgrpo_tpu_torch.trainer import make_lora_update_fns

    cfg = M.FluxConfig.tiny()
    sampler = FluxSampler(cfg, SamplerConfig(num_steps_max=4), height=512, width=512,
                          text_len=8, device=dev)
    g = torch.Generator(dev).manual_seed(4)
    N, L = 2, sampler.num_image_tokens
    x = torch.randn((N, L, cfg.in_channels), generator=g, device=dev)
    batch = UpdateBatch(latents=x, next_latents=x + 0.05 * torch.randn(x.shape, generator=g,
                                                                        device=dev),
                        t_index=torch.tensor([0, 2], device=dev),
                        old_log_probs=torch.zeros(N, device=dev),
                        advantages=torch.tensor([1.0, -1.0], device=dev),
                        txt=torch.randn((N, 8, cfg.context_dim), generator=g,
                                        device=dev).bfloat16(),
                        pooled=torch.randn((N, cfg.pooled_dim), generator=g,
                                           device=dev).bfloat16())
    sig = torch.as_tensor(sigma_schedule(4, 3.0), device=dev)
    base = M.init_flux(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev,
                       dtype=torch.bfloat16)
    snapshot = [t.clone() for t in M.param_leaves(base)]
    out = {}
    for impl in ("flash", "eager"):
        lora = init_lora(torch.Generator(dev).manual_seed(1), base, rank=4, alpha=8.0)
        gb = torch.Generator(dev).manual_seed(5)
        for f in lora["factors"].values():
            f["b"].normal_(0.0, 0.05, generator=gb)
        factors = lora["factors"]
        b0 = [f["b"].clone() for f in factors.values()]
        opt = make_optimizer(learning_rate=1e-4)
        step = make_lora_update_fns(cfg, sampler.sampler_cfg, PPOConfig(clip_range=0.2), opt,
                                    sampler.rope_cos, sampler.rope_sin, attn_impl=impl,
                                    remat=True)
        launched = FA.flash_attn_bwd_fused.launches
        factors, _, m = step(factors, opt.init(factors), {"rank": 4, "alpha": 8.0}, base,
                             batch, sig)
        assert (FA.flash_attn_bwd_fused.launches > launched) == (impl == "flash")
        assert any(not torch.equal(f["b"], b) for f, b in zip(factors.values(), b0))
        out[impl] = {k: float(v) for k, v in m.items()}
    assert all(torch.equal(a, b) and a.grad is None
               for a, b in zip(M.param_leaves(base), snapshot))
    assert all(torch.isfinite(torch.tensor(list(o.values()))).all() for o in out.values())
    assert abs(out["flash"]["grad_norm"] - out["eager"]["grad_norm"]) <= \
        5e-2 * out["eager"]["grad_norm"]


def test_flash_post_rollout_on_card_matches_cpu(dev):
    """A MixGRPO-Flash "post" rollout of a tiny fp32 FLUX (eager attention;
    window [2, 3] of 8 steps, DPM-Solver++ order-2 tail compressed by 0.6) on
    the card against the same rollout on the CPU, with the same weights and
    noise: latents within 2e-4, log-probs within 1e-4 relative."""
    import numpy as np

    from mixgrpo_tpu_torch.solvers.schedule import deterministic_mask, flash_post_schedule

    cfg = M.FluxConfig.tiny()
    scfg = SamplerConfig(num_steps_max=8, eta=0.7, dpm_algorithm_type="dpmsolver++")
    sig, n, det = flash_post_schedule(sigma_schedule(8, 3.0), deterministic_mask(8, [2, 3]),
                                      3.0, 0.6, pad_to=8)
    rng = np.random.default_rng(6)
    noise = {i: rng.standard_normal((2, 4, cfg.in_channels)).astype(np.float32)
             for i in range(n)}
    z0, txt, pooled = (rng.standard_normal(s).astype(np.float32)
                       for s in ((2, 4, cfg.in_channels), (2, 8, cfg.context_dim),
                                 (2, cfg.pooled_dim)))
    outs = []
    for d in ("cpu", dev):
        params = _to(M.init_flux(cfg, generator=torch.Generator().manual_seed(2), device="cpu"),
                     d)
        s = FluxSampler(cfg, scfg, height=32, width=32, text_len=8, dtype=torch.float32,
                        attn_impl="eager", device=d)
        outs.append(s.rollout(params, *(torch.from_numpy(a).to(d) for a in (z0, txt, pooled)),
                              sig, det, n, noise_fn=lambda i, shape: noise[i]))
    cpu, card = outs
    assert n < 8
    torch.testing.assert_close(card.all_latents.cpu(), cpu.all_latents, rtol=0, atol=2e-4)
    torch.testing.assert_close(card.all_log_probs.cpu(), cpu.all_log_probs, rtol=1e-4,
                               atol=2e-4)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_backend_smoke(dev):
    from mixgrpo_tpu_torch.utils.timing import backend_smoke

    assert backend_smoke() >= 0.0


def test_safetensors_bf16_straight_to_card(dev, tmp_path):
    """The reader's BF16 (and F16) path: a file written by the port read to
    the card bit for bit, in its own dtype and cast to f32 there; a FLUX
    export loads onto the card in bf16 equal to the CPU load."""
    from mixgrpo_tpu_torch.models.flux.load import load_flux_params
    from mixgrpo_tpu_torch.utils.checkpoint import export_flux_safetensors
    from mixgrpo_tpu_torch.utils.safetensors_io import SafetensorsFile, save_file

    g = torch.Generator().manual_seed(0)
    ts = {"w": torch.randn((300, 257), generator=g).bfloat16(),
          "h": torch.randn((5, 7), generator=g).half()}
    path = str(tmp_path / "x.safetensors")
    save_file(ts, path)
    f = SafetensorsFile(path)
    for name, want in ts.items():
        got = f.get(name, device=dev)
        assert got.device.type == "cuda" and got.dtype == want.dtype
        assert torch.equal(got.cpu(), want)
        assert torch.equal(f.get(name, device=dev, dtype=torch.float32).cpu(), want.float())
    cfg = M.FluxConfig.tiny()
    export_flux_safetensors(M.init_flux(cfg, generator=torch.Generator().manual_seed(1),
                                        device="cpu"), cfg, str(tmp_path / "t.safetensors"))
    on_card = load_flux_params(str(tmp_path / "t.safetensors"), cfg, dtype=torch.bfloat16,
                               device=dev)
    on_cpu = load_flux_params(str(tmp_path / "t.safetensors"), cfg, dtype=torch.bfloat16,
                              device="cpu")
    assert all(a.is_cuda and torch.equal(a.cpu(), b)
               for a, b in zip(M.param_leaves(on_card), M.param_leaves(on_cpu)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_text_encoders_on_card_match_cpu(dev, dtype):
    """T5 (with a mask) and both CLIP towers on the card against the CPU
    with the same random weights: f32 within 1e-4 absolute, bf16 within a
    relative L2 of 2e-2 (bf16 matmuls round differently on the two)."""
    from mixgrpo_tpu_torch.models.text import clip as C
    from mixgrpo_tpu_torch.models.text import t5 as T5

    tcfg, ccfg = T5.T5Config.tiny(), C.CLIPConfig.tiny()
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(0, tcfg.vocab, (2, 40), generator=g)
    mask = torch.ones((2, 40), dtype=torch.bool)
    mask[1, 30:] = False
    cids = torch.randint(1, 60, (2, 16), generator=g)
    cids[:, 9] = 63
    images = torch.randn((2, 32, 32, 3), generator=g)
    outs = {}
    for d in ("cpu", dev):
        tp = _to(T5.init_t5(tcfg, generator=torch.Generator().manual_seed(4), device="cpu"), d)
        cp = _to(C.init_clip(ccfg, generator=torch.Generator().manual_seed(5), device="cpu"), d)
        outs[d] = [T5.t5_encode(tp, tcfg, ids.to(d), mask.to(d), dtype=dtype),
                   C.clip_text_features(cp, ccfg, cids.to(d), dtype=dtype, project=False,
                                        normalize=False),
                   C.clip_image_features(cp, ccfg, images.to(d), dtype=dtype)]
    for cpu, card in zip(outs["cpu"], outs[dev]):
        assert card.is_cuda and torch.isfinite(card).all()
        if dtype == torch.float32:
            torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=1e-4)
        else:
            assert (card.cpu() - cpu).norm() / cpu.norm() <= 2e-2


@pytest.fixture(scope="module")
def reward_files(tmp_path_factory):
    """The four reward checkpoints at full width, cut to 2 blocks per tower,
    written by ``chip_smoke.write_reward_ckpts`` (released layouts)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    import chip_smoke as CS

    cut = lambda c: dataclasses.replace(c, vision=dataclasses.replace(c.vision, layers=2),
                                        text=dataclasses.replace(c.text, layers=2))
    geo = CS.reward_geometry()
    geo = {**{k: cut(geo[k]) for k in ("hps", "pick_score", "clip_score")},
           "blip_vision": dataclasses.replace(geo["blip_vision"], layers=2),
           "blip_text": dataclasses.replace(geo["blip_text"], layers=2)}
    paths, _ = CS.write_reward_ckpts(torch, torch.device("cuda"), geo,
                                     str(tmp_path_factory.mktemp("rewards") / "r"))
    return paths, geo


@pytest.mark.parametrize("name", ["hpsv2", "pick_score", "clip_score", "image_reward"])
def test_reward_models_on_card(dev, reward_files, name):
    """Each reward model (full width, 2 blocks per tower) scores a CUDA batch
    of four 720px images where it lies (the batch is not copied; the scores
    are computed on the card), launches no hand-written kernel, and its bf16
    scores are within ``chip_smoke.REWARD_BF16_BOUND`` of its f32 model's."""
    import chip_smoke as CS
    from mixgrpo_tpu_torch.rewards import CLIPScoreReward, HPSReward, PickScoreReward
    from mixgrpo_tpu_torch.rewards.image_reward import ImageRewardModel
    from mixgrpo_tpu_torch.rewards.preprocess import as_image_batch
    from mixgrpo_tpu_torch.train import find_bert_vocab_dir

    paths, geo = reward_files

    def make(dtype):
        if name == "image_reward":
            return ImageRewardModel.from_checkpoint(
                paths["image_reward"], paths["med_config"],
                find_bert_vocab_dir(paths["med_config"]), vision_cfg=geo["blip_vision"],
                device=dev, dtype=dtype)
        cls, key = {"hpsv2": (HPSReward, "hps"), "pick_score": (PickScoreReward, "pick_score"),
                    "clip_score": (CLIPScoreReward, "clip_score")}[name]
        return cls.from_checkpoint(paths[key], paths["merges"], device=dev, dtype=dtype)

    images = CS.smoke_images(torch, dev, 4, 720, 40)
    assert as_image_batch(images, dev).data_ptr() == images.data_ptr()
    prompts = list(CS.REWARD_PROMPTS[:4])
    m16 = make(torch.bfloat16)
    assert m16.dtype == torch.bfloat16 and m16.device.type == "cuda"
    FA.reset_launches()
    s16, ok = m16(images, prompts)
    assert not any(f.launches for f in FA.KERNEL_WRAPPERS.values())
    assert ok == [1.0] * 4 and all(map(lambda s: s == s, s16))
    s32, _ = make(torch.float32)(images, prompts)
    err = max(abs(a - b) for a, b in zip(s16, s32))
    assert err <= CS.REWARD_BF16_BOUND[name], (s16, s32)


@pytest.mark.parametrize("m,k,n", [(2 * 4608, 3072, 9216), (1024, 15360, 3072), (17, 8, 8)])
def test_qlinear_on_card_matches_cpu(dev, m, k, n):
    """``torch._int_mm`` on the card (cuBLASLt, the column-major int8 weight
    of ``quantize_weight``) gives the CPU's int32 sums exactly, at FLUX's
    block shapes and at _int_mm's smallest (17 rows, K = N = 8); ``qlinear``
    in f32 on the card equals the CPU's to f32 rounding."""
    from mixgrpo_tpu_torch.ops import quant as Q

    g = torch.Generator().manual_seed(m + k)
    p = Q.quantize_linear_params({"w": torch.randn((k, n), generator=g) * 0.02,
                                  "b": torch.randn((n,), generator=g) * 0.01})
    x = torch.randn((m, k), generator=g)
    xq = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    pc = {key: t.to(dev) for key, t in p.items()}
    assert pc["w_q"].stride() == p["w_q"].stride() == (1, k)
    got = torch._int_mm(xq.to(dev), pc["w_q"])
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), torch._int_mm(xq, p["w_q"]))
    y = Q.qlinear(pc, x.to(dev), torch.float32).cpu()
    want = Q.qlinear(p, x, torch.float32)
    assert ((y - want).abs() <= 1e-6 * want.abs().max()).all()


def test_native_reader_rows_to_card(dev, tmp_path):
    """``NativeShardReader`` rows (f16 -> f32 on the host) moved to the card
    equal the memmap reader's, bit for bit."""
    import numpy as np

    from mixgrpo_tpu_torch.data.dataset import EmbeddingCacheWriter, LatentDataset

    rng = np.random.default_rng(0)
    w = EmbeddingCacheWriter(str(tmp_path), shard_size=3)
    for i in range(5):
        w.add(rng.normal(size=(16, 32)).astype(np.float32), rng.normal(size=(8,)), f"p{i}")
    w.finish()
    native, plain = LatentDataset(str(tmp_path)), LatentDataset(str(tmp_path), use_native=False)
    for i in range(5):
        a, b = native.get(i), plain.get(i)
        for key in ("prompt_embed", "pooled"):
            on_card = torch.from_numpy(a[key]).to(dev)
            assert on_card.dtype == torch.float32
            assert torch.equal(on_card.cpu(), torch.from_numpy(b[key]))


def test_masked_forward_at_hunyuan_shape(dev):
    """The forward kernel's key-bias branch at HunyuanVideo's 192x336, 129
    frame shape: B = 1, H = 24, S = Sk = 8,576 (8,572 tokens padded), D =
    128, the joint key mask of 40 kept text tokens (key tile 1 wholly masked)
    and the 4 pad keys, against its plain version (``assert_close_bf16``),
    through ``attention(impl="flash")`` and launched once."""
    from mixgrpo_tpu_torch.ops.attention import attention

    g = torch.Generator(dev).manual_seed(8)
    q, k, v = (torch.randn((1, 24, 8576, 128), generator=g, device=dev).bfloat16()
               for _ in range(3))
    m = torch.ones((1, 8576), dtype=torch.bool, device=dev)
    m[:, 40:256] = False
    m[:, 8572:] = False
    FA.reset_launches()
    got = attention(q, k, v, mask=m[:, None, None, :], impl="flash")
    assert FA.flash_attn_fwd.launches == 1
    want = FA.flash_attention_reference(q, k, v, mask=m)
    assert_close_bf16(got, want, int(m.sum()))


def test_tiny_hunyuan_predict_on_card(dev):
    """``HunyuanVideoSampler.predict`` at the tiny config on the card (bf16,
    the forward kernel under every block): 60 forwards per DiT call become
    3 per call here (1 double + 2 single blocks), nothing else launches, the
    frames are finite in [0, 1], and the DiT's latents with the kernel are
    close to eager attention's on the same noise."""
    import numpy as np

    from mixgrpo_tpu_torch.models.hunyuan import model as HM
    from mixgrpo_tpu_torch.models.hunyuan import pipeline as HP
    from mixgrpo_tpu_torch.models.hunyuan import sampler as HS
    from mixgrpo_tpu_torch.models.hunyuan import vae3d as HV

    # the tiny config at head dim 32, the least the kernel takes
    cfg = HM.HunyuanVideoConfig(**{**vars(HM.HunyuanVideoConfig.tiny()), "hidden_size": 128,
                                   "rope_dim_list": (8, 12, 12)})
    vcfg = HV.CausalVAEConfig.tiny()
    gen = lambda s: torch.Generator(dev).manual_seed(s)
    params = HM.init_hunyuan_video(cfg, generator=gen(0), device=dev, dtype=torch.bfloat16)
    vae = HV.init_causal_vae_decoder(vcfg, generator=gen(1), device=dev, dtype=torch.bfloat16)

    class Encoder:
        def __call__(self, prompts, data_type="video"):
            txt = torch.randn((len(prompts), 6, cfg.text_states_dim), generator=gen(2),
                              device=dev)
            mask = torch.ones((len(prompts), 6), dtype=torch.int64, device=dev)
            mask[:, 4:] = 0
            return txt, mask

    pipe = HP.HunyuanVideoPipeline(cfg, params, vae_cfg=vcfg, vae_params=vae, num_steps=3,
                                   text_encoder=Encoder(), device=dev)
    FA.reset_launches()
    out = HS.HunyuanVideoSampler(pipe).predict(["a", "b"], height=32, width=32, video_length=5,
                                               seed=3)
    assert FA.flash_attn_fwd.launches == 3 * 3 * 2
    assert all(f.launches == 0 for n, f in FA.KERNEL_WRAPPERS.items() if n != "flash_attn_fwd")
    for s in out["samples"]:
        assert s.shape == (5, 32, 32, 3) and np.isfinite(s).all()
        assert 0 <= s.min() and s.max() <= 1
    txt, mask = Encoder()(["a"])
    pooled = torch.zeros((1, cfg.text_states_dim_2), device=dev)
    z0 = torch.randn((1, 2, 4, 4, cfg.in_channels), generator=gen(4), device=dev)
    lat = {}
    for impl in ("flash", "eager"):
        p = HP.HunyuanVideoPipeline(cfg, params, num_steps=3, attn_impl=impl, device=dev)
        lat[impl] = p(txt, pooled, text_mask=mask, video_length=5, height=32, width=32, z0=z0)
    rel = (lat["flash"] - lat["eager"]).norm() / lat["eager"].norm()
    assert torch.isfinite(lat["flash"]).all() and rel < 2e-2


def test_forward_at_mochi_final_block_shape(dev):
    """The forward kernel with Sq != Sk at Mochi's final block at 480x848, 37
    frames: B = 1, H = 24, S = 11,130 visual queries over Sk = 11,386 visual
    + text keys, D = 128, no mask, against its plain version computed 8
    heads at a time (``assert_close_bf16``), launched once."""
    from mixgrpo_tpu_torch.ops.attention import attention

    g = torch.Generator(dev).manual_seed(9)
    q = torch.randn((1, 24, 11130, 128), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((1, 24, 11386, 128), generator=g, device=dev).bfloat16()
            for _ in range(2))
    FA.reset_launches()
    got = attention(q, k, v, impl="flash")
    assert FA.flash_attn_fwd.launches == 1 and got.shape == q.shape
    want = torch.cat([FA.flash_attention_reference(q[:, h:h + 8], k[:, h:h + 8], v[:, h:h + 8])
                      for h in range(0, 24, 8)], dim=1)
    assert_close_bf16(got, want, 11386)


def test_tiny_mochi_pipeline_on_card(dev):
    """``MochiPipeline`` at the tiny config on the card (bf16, the forward
    kernel in every block, the final block at Sq != Sk): 2 blocks x 2 CFG
    calls x 3 steps forwards and nothing else, frames finite in [0, 1]; the
    latents through the kernel close to eager attention's on the same noise;
    a gradient through ``mochi_forward`` (forward with lse, then dkv and dq
    at these lengths) close to eager's."""
    from mixgrpo_tpu_torch.models.mochi import model as MM
    from mixgrpo_tpu_torch.models.mochi import pipeline as MP
    from mixgrpo_tpu_torch.models.mochi import vae as MV

    cfg = MM.MochiConfig(**{**vars(MM.MochiConfig.tiny()), "head_dim": 32})
    vcfg = MV.MochiVAEConfig.tiny()
    gen = lambda s: torch.Generator(dev).manual_seed(s)
    params = MM.init_mochi(cfg, generator=gen(0), device=dev, dtype=torch.bfloat16)
    vae = MV.init_mochi_vae_decoder(vcfg, generator=gen(1), device=dev, dtype=torch.bfloat16)
    txt = torch.randn((1, 6, cfg.text_embed_dim), generator=gen(2), device=dev)
    mask = torch.ones((1, 6), dtype=torch.int32, device=dev)
    mask[:, 4:] = 0
    pipe = MP.MochiPipeline(cfg, params, num_steps=3, vae_cfg=vcfg, vae_params=vae, device=dev)
    FA.reset_launches()
    video = pipe(txt, text_mask=mask, num_frames=7, height=32, width=32, generator=gen(3))
    assert FA.flash_attn_fwd.launches == cfg.num_layers * 2 * 3
    assert all(f.launches == 0 for n, f in FA.KERNEL_WRAPPERS.items() if n != "flash_attn_fwd")
    assert video.shape == (1, 7, 32, 32, 3) and torch.isfinite(video).all()
    assert 0 <= video.min() and video.max() <= 1
    z0 = torch.randn((1, 2, 4, 4, cfg.in_channels), generator=gen(4), device=dev)
    lat = {}
    for impl in ("flash", "eager"):
        p = MP.MochiPipeline(cfg, params, num_steps=3, attn_impl=impl, device=dev)
        lat[impl] = p(txt, text_mask=mask, num_frames=7, height=32, width=32, z0=z0)
    rel = (lat["flash"] - lat["eager"]).norm() / lat["eager"].norm()
    assert torch.isfinite(lat["flash"]).all() and rel < 2e-2, rel.item()
    grads = {}
    for impl in ("flash", "eager"):
        z = z0.clone().requires_grad_(True)
        out = MM.mochi_forward(params, cfg, z, txt, torch.full((1,), 0.5, device=dev), mask,
                               attn_impl=impl)
        (out.float() ** 2).mean().backward()
        grads[impl] = z.grad
    rel = (grads["flash"] - grads["eager"]).norm() / grads["eager"].norm()
    assert torch.isfinite(grads["flash"]).all() and rel < 2e-2, rel.item()
