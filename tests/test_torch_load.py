"""The port's checkpoint I/O against the JAX package.

- ``utils/safetensors_io.py``: BF16, F16 and F32 files written by the
  ``safetensors`` package are read bit for bit, to the CPU and across a
  sharded directory; files it writes are read back by ``safetensors``; an
  unknown dtype code raises; LoRA adapter files keep their bytes.
- ``models/flux/load.py`` on the tree that ``scripts/make_rehearsal_ckpts.py``
  writes at the tiny preset (diffusers FLUX and VAE names): every leaf equal
  to the JAX loaders' (f32), and bf16 loads equal to JAX's f32 values cast;
  the VAE encoder loader on a synthetic diffusers encoder file likewise.
- exports read across the packages exactly (JAX's by the port, the port's
  by JAX).
- ``vae_encode`` with ``sample=False`` against JAX's in f32 (atol 1e-4: the
  convolutions and the mid-block attention sum in another order).
- the registry's entries.
"""

import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from mixgrpo_tpu import lora as JLoRA
from mixgrpo_tpu import presets as JP
from mixgrpo_tpu.models.flux import load as JLd
from mixgrpo_tpu.models.flux import model as JM
from mixgrpo_tpu.models.flux import vae as JV
from mixgrpo_tpu.utils.checkpoint import export_flux_safetensors as j_export
from mixgrpo_tpu_torch import lora as L
from mixgrpo_tpu_torch import presets as P
from mixgrpo_tpu_torch.convert import from_jax_params
from mixgrpo_tpu_torch.models import registry as R
from mixgrpo_tpu_torch.models.flux import load as Ld
from mixgrpo_tpu_torch.models.flux import model as M
from mixgrpo_tpu_torch.models.flux import vae as V
from mixgrpo_tpu_torch.utils import safetensors_io as S
from mixgrpo_tpu_torch.utils.checkpoint import diffusers_state, export_flux_safetensors

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_rehearsal_tree(out) -> str:
    """The released FLUX.1-dev directory layout at the tiny preset, written
    by ``scripts/make_rehearsal_ckpts.py``'s functions in this process;
    returns the FLUX directory."""
    spec = importlib.util.spec_from_file_location(
        "make_rehearsal_ckpts", os.path.join(ROOT, "scripts", "make_rehearsal_ckpts.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fam = JP.flux_family("tiny")
    flux_dir = os.path.join(str(out), "flux-dev")
    for sub in ("transformer", "vae", "text_encoder", "text_encoder_2", "tokenizer",
                "tokenizer_2"):
        os.makedirs(os.path.join(flux_dir, sub), exist_ok=True)
    mod.write_flux(fam, flux_dir)
    mod.write_vae(fam, flux_dir)
    mod.write_t5(fam, flux_dir)
    mod.write_clip_l(fam, flux_dir)
    mod.write_hps(fam, str(out))
    return flux_dir


def flat(tree, prefix=""):
    """{path: numpy array} of a JAX or torch parameter tree."""
    if isinstance(tree, dict):
        return {k: v for n in sorted(tree) for k, v in flat(tree[n], f"{prefix}{n}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in flat(t, f"{prefix}{i}/").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree.detach().float().numpy()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def assert_trees_equal(got, want):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_rehearsal_tree(tmp_path_factory.mktemp("ckpts"))


# ---------------------------------------------------------------------------
# safetensors files
# ---------------------------------------------------------------------------


def test_reads_package_files_bit_for_bit(tmp_path):
    """BF16, F16, F32 and I64 tensors written by ``safetensors.torch`` in two
    shards come back bit for bit, each in its own dtype or cast on read."""
    from safetensors.torch import save_file as st_save

    g = torch.Generator().manual_seed(0)
    a = {"w.bf16": torch.randn((7, 5), generator=g).bfloat16(),
         "w.f16": torch.randn((3, 2, 4), generator=g).half(),
         "scalar": torch.tensor(2.5)}
    b = {"w.f32": torch.randn((6,), generator=g), "ids": torch.arange(5),
         "empty": torch.zeros((0, 3)).bfloat16()}
    st_save(a, str(tmp_path / "model-00001-of-00002.safetensors"))
    st_save(b, str(tmp_path / "model-00002-of-00002.safetensors"))
    state = S.SafetensorsDir(str(tmp_path))
    assert sorted(state) == sorted({**a, **b})
    for name, want in {**a, **b}.items():
        got = state[name]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want), name
    assert torch.equal(state.get("w.bf16", device="cpu", dtype=torch.float32),
                       a["w.bf16"].float())


def test_written_files_read_by_the_package(tmp_path):
    """Tensors of every dtype the writer takes (numpy arrays too), with
    metadata, come back through ``safetensors``; ``dtype=`` casts on write."""
    from safetensors import safe_open

    g = torch.Generator().manual_seed(1)
    ts = {"b": torch.randn((4, 3), generator=g).bfloat16(), "a": torch.randn((2,), generator=g),
          "h": np.arange(6, dtype=np.float16).reshape(2, 3),
          "t": torch.randn((3, 4), generator=g).t()}  # not contiguous
    path = str(tmp_path / "x.safetensors")
    S.save_file(ts, path, metadata={"rank": 4})
    with safe_open(path, "pt") as f:
        assert f.metadata() == {"rank": "4"}
        for name, want in ts.items():
            want = want if isinstance(want, torch.Tensor) else torch.from_numpy(want)
            assert torch.equal(f.get_tensor(name), want), name
    S.save_file(ts, path, dtype=torch.float32)
    with safe_open(path, "pt") as f:
        assert f.get_tensor("b").dtype == torch.float32
        assert torch.equal(f.get_tensor("b"), ts["b"].float())


def test_unknown_dtype_raises(tmp_path):
    from safetensors.torch import save_file as st_save

    st_save({"x": torch.zeros(3, dtype=torch.uint8), "y": torch.zeros(2)},
            str(tmp_path / "x.safetensors"))
    f = S.SafetensorsFile(str(tmp_path / "x.safetensors"))
    assert torch.equal(f.get("y", device="cpu"), torch.zeros(2))
    with pytest.raises(ValueError, match="U8"):
        f.get("x", device="cpu")
    with pytest.raises(ValueError):
        S.save_file({"x": torch.zeros(2, dtype=torch.uint8)}, str(tmp_path / "y.safetensors"))


def test_lora_files_keep_their_bytes(tmp_path):
    """An adapter file is byte for byte what ``save_lora`` wrote before it
    moved onto the shared writer: an 8-byte header length, a compact JSON
    header of ``__metadata__`` {rank, alpha} then the names in sorted order,
    space-padded to 8 bytes, then each factor's f32 bytes in that order.
    (JAX's files differ only in the order of the two metadata keys, which
    its writer does not fix; test_torch_lora.py reads each package's file
    with the other.)"""
    import json
    import struct

    rng = np.random.default_rng(2)
    f = {"double/img_qkv/w": {"a": rng.standard_normal((2, 8, 4)).astype(np.float32),
                              "b": rng.standard_normal((2, 4, 24)).astype(np.float32)},
         "x_embedder/w": {"a": rng.standard_normal((8, 4)).astype(np.float32),
                          "b": rng.standard_normal((4, 8)).astype(np.float32)}}
    arrays = {f"{p}.lora_{'A' if k == 'a' else 'B'}": v for p, d in f.items()
              for k, v in d.items()}
    header, off = {"__metadata__": {"rank": "4", "alpha": "8.0"}}, 0
    for name in sorted(arrays):
        header[name] = {"dtype": "F32", "shape": list(arrays[name].shape),
                        "data_offsets": [off, off + arrays[name].nbytes]}
        off += arrays[name].nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    want = struct.pack("<Q", len(blob)) + blob + b"".join(
        arrays[n].astype("<f4").tobytes() for n in sorted(arrays))
    L.save_lora({"factors": from_jax_params(f, "cpu"), "rank": 4, "alpha": 8.0},
                str(tmp_path / "t.safetensors"))
    assert (tmp_path / "t.safetensors").read_bytes() == want
    JLoRA.save_lora({"factors": jax.tree.map(jax.numpy.asarray, f), "rank": 4, "alpha": 8.0},
                    str(tmp_path / "j.safetensors"))
    assert len((tmp_path / "j.safetensors").read_bytes()) == len(want)


# ---------------------------------------------------------------------------
# loaders on the rehearsal tree
# ---------------------------------------------------------------------------


def test_flux_loader_matches_jax(tree):
    fam, jfam = P.flux_family("tiny"), JP.flux_family("tiny")
    path = os.path.join(tree, "transformer")
    want = JLd.load_flux_params(path, jfam["flux"])
    got = Ld.load_flux_params(path, fam["flux"], device="cpu")
    assert_trees_equal(got, want)
    # bf16 on read == JAX's f32 values cast; the stacks keep their depth axis
    got16 = Ld.load_flux_params(path, fam["flux"], dtype=torch.bfloat16, device="cpu")
    for k, w in flat(want).items():
        g = flat(got16)[k]
        np.testing.assert_array_equal(g, torch.from_numpy(np.array(w)).bfloat16().float().numpy())
    assert got16["single"]["linear1"]["w"].shape[0] == fam["flux"].depth_single


def test_vae_decoder_loader_matches_jax(tree):
    path = os.path.join(tree, "vae")
    want = JLd.load_vae_decoder_params(path, JP.flux_family("tiny")["vae"])
    got = Ld.load_vae_decoder_params(path, P.flux_family("tiny")["vae"], device="cpu")
    assert_trees_equal(got, want)


def _encoder_state(cfg, seed=3):
    """Random diffusers ``AutoencoderKL`` encoder names (numpy f32)."""
    rng = np.random.default_rng(seed)
    st = {}

    def conv(name, cin, cout, k=3):
        st[f"{name}.weight"] = rng.normal(size=(cout, cin, k, k)).astype(np.float32) * 0.05
        st[f"{name}.bias"] = rng.normal(size=(cout,)).astype(np.float32) * 0.01

    def gn(name, c):
        st[f"{name}.weight"] = 1 + 0.1 * rng.normal(size=(c,)).astype(np.float32)
        st[f"{name}.bias"] = 0.1 * rng.normal(size=(c,)).astype(np.float32)

    def resnet(name, cin, cout):
        gn(f"{name}.norm1", cin)
        conv(f"{name}.conv1", cin, cout)
        gn(f"{name}.norm2", cout)
        conv(f"{name}.conv2", cout, cout)
        if cin != cout:
            conv(f"{name}.conv_shortcut", cin, cout, k=1)

    chans = cfg.block_out_channels
    top = chans[-1]
    conv("encoder.conv_in", 3, chans[0])
    cin = chans[0]
    for bi, cout in enumerate(chans):
        for li in range(cfg.layers_per_block):
            resnet(f"encoder.down_blocks.{bi}.resnets.{li}", cin, cout)
            cin = cout
        if bi < len(chans) - 1:
            conv(f"encoder.down_blocks.{bi}.downsamplers.0.conv", cout, cout)
    resnet("encoder.mid_block.resnets.0", top, top)
    resnet("encoder.mid_block.resnets.1", top, top)
    a = "encoder.mid_block.attentions.0"
    gn(f"{a}.group_norm", top)
    for n in ("to_q", "to_k", "to_v", "to_out.0"):
        st[f"{a}.{n}.weight"] = rng.normal(size=(top, top)).astype(np.float32) * 0.1
        st[f"{a}.{n}.bias"] = rng.normal(size=(top,)).astype(np.float32) * 0.01
    gn("encoder.conv_norm_out", top)
    conv("encoder.conv_out", top, 2 * cfg.latent_channels)
    return st


def test_vae_encoder_loader_and_encode_match_jax(tmp_path):
    """The encoder loader on a diffusers-named file equals JAX's; then
    ``vae_encode`` (``sample=False``) on 32px images: f32 within 1e-4."""
    from safetensors.numpy import save_file as st_save

    jcfg, cfg = JP.flux_family("tiny")["vae"], P.flux_family("tiny")["vae"]
    path = str(tmp_path / "vae.safetensors")
    st_save(_encoder_state(cfg), path)
    want = JLd.load_vae_encoder_params(path, jcfg)
    got = Ld.load_vae_encoder_params(path, cfg, device="cpu")
    assert_trees_equal(got, want)
    images = np.random.default_rng(4).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    zj = np.asarray(JV.vae_encode(want, jcfg, jax.numpy.asarray(images), dtype=jax.numpy.float32,
                                  sample=False))
    z = V.vae_encode(got, cfg, torch.from_numpy(images), dtype=torch.float32, sample=False)
    assert tuple(z.shape) == (2, 4, 4, cfg.latent_channels)
    np.testing.assert_allclose(z.numpy(), zj, rtol=0, atol=1e-4)


def test_vae_encode_random_init_matches_jax():
    """JAX's ``init_vae_encoder`` weights carried over: the mean matches in
    f32 (atol 1e-4); sampling draws from the generator, reproducibly, and
    needs one."""
    jcfg = JV.VAEConfig.tiny()
    cfg = V.VAEConfig.tiny()
    jp = JV.init_vae_encoder(jax.random.key(7), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    assert sorted(flat(V.init_vae_encoder(cfg, device="cpu"))) == sorted(flat(tp))
    images = np.random.default_rng(8).uniform(-1, 1, (1, 64, 48, 3)).astype(np.float32)
    zj = JV.vae_encode(jp, jcfg, jax.numpy.asarray(images), dtype=jax.numpy.float32,
                       sample=False)
    z = V.vae_encode(tp, cfg, torch.from_numpy(images), dtype=torch.float32, sample=False)
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), rtol=0, atol=1e-4)
    draw = lambda: V.vae_encode(tp, cfg, torch.from_numpy(images), torch.Generator().manual_seed(1),
                                dtype=torch.float32)
    assert torch.equal(draw(), draw()) and not torch.equal(draw(), z)
    with pytest.raises(ValueError):
        V.vae_encode(tp, cfg, torch.from_numpy(images), dtype=torch.float32)


# ---------------------------------------------------------------------------
# exports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_exports_read_across_packages(tmp_path, writer):
    """A JAX export read by the port, and a port export read by JAX: every
    leaf equal (F32 both ways); the names are diffusers'."""
    cfg = M.FluxConfig.tiny()
    path = str(tmp_path / "diffusion_pytorch_model.safetensors")
    if writer == "jax":
        params = jax.tree.map(np.asarray, JM.init_flux(jax.random.key(5), JM.FluxConfig.tiny()))
        j_export(params, JM.FluxConfig.tiny(), path)
        got = Ld.load_flux_params(path, cfg, device="cpu")
    else:
        params = M.init_flux(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
        export_flux_safetensors(params, cfg, path)
        got = JLd.load_flux_params(path, JM.FluxConfig.tiny())
    assert_trees_equal(got, params)
    f = S.SafetensorsFile(path)
    assert {f.header[n]["dtype"] for n in f.keys()} == {"F32"}
    assert "single_transformer_blocks.3.proj_mlp.weight" in f


def test_diffusers_state_keeps_dtype_and_views():
    """The export's first half: names -> views in the parameters' dtype; a
    bf16 base is written as BF16 by ``save_file`` without a cast."""
    cfg = M.FluxConfig.tiny()
    params = M.init_flux(cfg, generator=torch.Generator().manual_seed(6), device="cpu",
                         dtype=torch.bfloat16)
    st = diffusers_state(params, cfg)
    assert {t.dtype for t in st.values()} == {torch.bfloat16}
    h = cfg.hidden_size
    w = st["transformer_blocks.1.attn.to_k.weight"]
    assert w.data_ptr() == params["double"]["img_qkv"]["w"][1, :, h].data_ptr()
    assert torch.equal(w, params["double"]["img_qkv"]["w"][1, :, h:2 * h].t())


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_registry_entries():
    assert R.available_models() == ["flux", "hunyuan_video", "mochi"]
    e = R.get_model("flux")
    assert e.config() == M.FluxConfig.flux_dev() and e.load is Ld.load_flux_params
    assert e.init is M.init_flux and e.forward is M.flux_forward
    v = R.load_vae("flux")
    assert v.config() == V.VAEConfig.flux_dev() and v.load is Ld.load_vae_decoder_params
    from mixgrpo_tpu_torch.models.hunyuan import load as HL
    from mixgrpo_tpu_torch.models.hunyuan import model as HM
    from mixgrpo_tpu_torch.models.hunyuan import vae3d as HV

    h = R.get_model("hunyuan_video")
    assert h.config() == HM.HunyuanVideoConfig.hunyuan_video() and h.load is HL.load_hunyuan_video
    assert h.init is HM.init_hunyuan_video and h.forward is HM.hunyuan_video_forward
    hv = R.load_vae("hunyuan_video")
    assert hv.config() == HV.CausalVAEConfig.hunyuan_video()
    assert (hv.init, hv.forward, hv.load) == (HV.init_causal_vae_decoder, HV.causal_vae_decode,
                                              HV.load_causal_vae_decoder)
    from mixgrpo_tpu.models import registry as JR
    from mixgrpo_tpu_torch.models.mochi import model as MM

    m, jm = R.get_model("mochi"), JR.get_model("mochi")
    assert m.config() == MM.MochiConfig.mochi_preview()
    assert dataclasses.asdict(m.config()) == dataclasses.asdict(jm.config())
    assert (m.init, m.forward, m.load) == (MM.init_mochi, MM.mochi_forward, None)
    assert jm.load is None
    with pytest.raises(ValueError):
        R.get_model("sdxl")
    for reg in (R, JR):  # no VAE entry for Mochi in either package
        with pytest.raises(ValueError):
            reg.load_vae("mochi")
