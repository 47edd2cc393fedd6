"""Card-only tests of the port: the hand-written CUDA kernels against their
plain PyTorch versions, and the model path through them.

Every test carries the ``cuda`` marker and skips without a card.  This file
imports neither JAX nor the JAX package, so it also runs on a machine with
only PyTorch: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest`` skips the JAX set-up of tests/conftest.py).
"""

import pytest
import torch

from mixgrpo_tpu_torch.models.flux import model as M
from mixgrpo_tpu_torch.ops import flash_attention as FA
from mixgrpo_tpu_torch.sample import DualFluxPipeline

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
    """bf16 kernel vs its plain version, ragged S/Sk, with no mask, a key
    mask and kv_valid; tolerance of ``assert_close_bf16``."""
    g = torch.Generator(dev).manual_seed(0)
    B, H, S, Sk = 2, 3, 130, 201
    shp = (lambda s: (B, s, H, D)) if layout == "bshd" else (lambda s: (B, H, s, D))
    q, k, v = (torch.randn(shp(s), generator=g, device=dev).bfloat16()
               for s in (S, Sk, Sk))
    mask = torch.rand((B, Sk), generator=g, device=dev) > 0.3
    mask[:, 0] = True
    for kw in ({}, {"mask": mask}, {"kv_valid": 150}):
        before = FA.flash_attn_fwd.launches
        got = FA.flash_attention(q, k, v, layout=layout, **kw)
        torch.cuda.synchronize()
        assert FA.flash_attn_fwd.launches == before + 1
        want = FA.flash_attention_reference(q, k, v, layout=layout, **kw)
        assert_close_bf16(got, want, kw.get("kv_valid", Sk))


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
