"""The video DiTs of the port under sequence parallelism and through the
backward, against one rank and against the JAX package, at the tiny
configurations in f32.

- ``make_video_ids(sp_size=2)`` equals JAX's (atol 0).
- ``hunyuan_video_forward`` with a text mask and pad keys (S = 6 + 72 = 78
  padded to 80 with ``pad_seq_multiple=8``) and ``mochi_forward`` (its final
  block attends 24 queries over 30 keys) under ``attn_impl="ulysses"`` and
  ``"ring"`` on two ``gloo`` CPU ranks (``tests/torch_parallel_worker.py``,
  case ``video_sp``): each rank's output against one rank's eager forward
  (rel L2 <= 1e-5) and the Ulysses outputs against JAX's forward (atol
  1e-4): HunyuanVideo's with ``attn_impl="ulysses"`` on a two-device CPU
  mesh; Mochi's, whose port keeps padded text out of the joint attention
  where JAX masks the pooler only, one row at a time on that row's valid
  tokens with an all-ones mask (rows of 28 and 29 tokens, which two ranks
  cannot split, so with ``attn_impl="xla"``); the HunyuanVideo pipeline
  under Ulysses against one rank's (rel L2 <= 1e-5).
- The gradient of ``hunyuan_video_forward(remat=True)`` (latents and every
  parameter) against ``jax.grad`` of JAX's (atol 1e-4 times the gradient's
  largest entry, at least 1e-3), and ``remat=True`` equal to ``remat=False``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu.models.hunyuan import model as JHM
from mixgrpo_tpu.models.mochi import model as JMM
from mixgrpo_tpu.parallel import mesh as JMesh
from mixgrpo_tpu.parallel import ulysses as JU
from mixgrpo_tpu_torch.convert import from_jax_params
from mixgrpo_tpu_torch.models.hunyuan import model as HM
from mixgrpo_tpu_torch.models.hunyuan.pipeline import HunyuanVideoPipeline
from mixgrpo_tpu_torch.models.mochi import model as MM
from tests.test_torch_hunyuan import _np_tree as hunyuan_tree
from tests.test_torch_mochi import _np_tree as mochi_tree
from tests.torch_parallel_worker import save_tree, spawn_ranks

HCFG, JHCFG = HM.HunyuanVideoConfig.tiny(), JHM.HunyuanVideoConfig.tiny()
MCFG, JMCFG = MM.MochiConfig.tiny(), JMM.MochiConfig.tiny()
PAD = 8  # S = 78 >= 8 x 8: padded to 80, two pad keys


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def trees():
    return (hunyuan_tree(HM.init_hunyuan_video, HCFG, JHM.init_hunyuan_video, JHCFG, 0),
            mochi_tree(MM.init_mochi, MCFG, JMM.init_mochi, JMCFG, 0))


def _inputs():
    rng = np.random.default_rng(4)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    hmask = np.ones((2, 6), np.int32)
    hmask[0, 4:] = 0
    mmask = hmask.copy()
    mmask[1, 5:] = 0
    return dict(
        h_z=f(2, 2, 12, 12, HCFG.in_channels), h_txt=f(2, 6, HCFG.text_states_dim),
        h_pooled=f(2, HCFG.text_states_dim_2), h_t=np.array([0.7, 0.2], np.float32),
        h_g=np.full((2,), 6.0, np.float32), h_mask=hmask,
        m_z=f(2, 2, 8, 6, MCFG.in_channels), m_txt=f(2, 6, MCFG.text_embed_dim),
        m_t=np.array([0.6, 0.3], np.float32), m_mask=mmask)


def _hunyuan(tp, x, **kw):
    t = torch.from_numpy
    with torch.no_grad():
        return HM.hunyuan_video_forward(
            tp, HCFG, t(x["h_z"]), t(x["h_txt"]), t(x["h_pooled"]), t(x["h_t"]), t(x["h_g"]),
            t(x["h_mask"]), dtype=torch.float32, **kw).numpy()


def _mochi(tp, x, **kw):
    t = torch.from_numpy
    with torch.no_grad():
        return MM.mochi_forward(tp, MCFG, t(x["m_z"]), t(x["m_txt"]), t(x["m_t"]),
                                t(x["m_mask"]), dtype=torch.float32, **kw).numpy()


def _jax_mochi_rows(mtree, x):
    """JAX's Mochi forward, each row on its valid tokens with an all-ones mask."""
    p = jax.tree.map(jnp.asarray, mtree)
    rows = []
    for b, keep in enumerate(x["m_mask"].astype(bool)):
        rows.append(np.asarray(JMM.mochi_forward(
            p, JMCFG, jnp.asarray(x["m_z"][b:b + 1]), jnp.asarray(x["m_txt"][b:b + 1, keep]),
            jnp.asarray(x["m_t"][b:b + 1]), jnp.ones((1, int(keep.sum())), jnp.int32),
            dtype=jnp.float32, attn_impl="xla", remat=False)))
    return np.concatenate(rows)


def _jax_ulysses(htree, x):
    """JAX's HunyuanVideo forward with ``attn_impl="ulysses"`` on two CPU devices."""
    jm = JMesh.make_mesh(JMesh.MeshConfig(dp=1, sp=2), devices=jax.devices()[:2])
    a = {k: jnp.asarray(v) for k, v in x.items()}
    JU.set_sp_context(jm, "sp")
    try:
        h = jax.jit(lambda p: JHM.hunyuan_video_forward(
            p, JHCFG, a["h_z"], a["h_txt"], a["h_pooled"], a["h_t"], a["h_g"], a["h_mask"],
            dtype=jnp.float32, attn_impl="ulysses", remat=False))(
            jax.tree.map(jnp.asarray, htree))
        return np.asarray(h)
    finally:
        JU.set_sp_context(None)


def test_video_ids_with_sp_size_match_jax():
    for t, h, w, sp in ((3, 8, 6, 2), (2, 4, 4, 4), (1, 6, 2, 1)):
        got = HM.make_video_ids(t, h, w, sp_size=sp)
        assert got.shape == (t * sp * (h // 2) * (w // 2), 3)
        np.testing.assert_array_equal(got, JHM.make_video_ids(t, h, w, sp_size=sp))


def test_video_dits_under_sp_match_one_rank_and_jax(trees, tmp_path):
    htree, mtree = trees
    x = _inputs()
    z = dict(x)
    save_tree("h", htree, z)
    save_tree("m", mtree, z)
    np.savez(tmp_path / "in.npz", **z)
    (tmp_path / "in.json").write_text(json.dumps(dict(mesh=dict(dp=1, sp=2), pad=PAD)))
    ranks = spawn_ranks("video_sp", 2, str(tmp_path))

    hp, mp = from_jax_params(htree, "cpu"), from_jax_params(mtree, "cpu")
    h1 = _hunyuan(hp, x, attn_impl="eager", pad_seq_multiple=PAD)
    m1 = _mochi(mp, x, attn_impl="eager")
    jh, jm = _jax_ulysses(htree, x), _jax_mochi_rows(mtree, x)
    assert np.abs(h1 - _hunyuan(hp, x, attn_impl="eager", pad_seq_multiple=0)).max() < 2e-4
    assert np.abs(jh).max() > 0.1 and np.abs(jm).max() > 0.1
    for got, _ in ranks:
        for impl in ("ulysses", "ring"):
            assert _rel(got[f"h_{impl}"], h1) <= 1e-5, impl
            assert _rel(got[f"m_{impl}"], m1) <= 1e-5, impl
        np.testing.assert_allclose(got["h_ulysses"], jh, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["m_ulysses"], jm, rtol=0, atol=1e-4)
    # the pipeline under Ulysses against one rank's eager pipeline
    pipe = HunyuanVideoPipeline(HCFG, hp, num_steps=2, dtype=torch.float32, attn_impl="eager",
                                device="cpu")
    t = torch.from_numpy
    want = pipe(t(x["h_txt"][:1]), t(x["h_pooled"][:1]), video_length=1, height=96, width=96,
                text_mask=t(x["h_mask"][:1]), z0=t(x["h_z"][:1])).numpy()
    for got, info in ranks:
        assert _rel(got["h_pipeline"], want) <= 1e-5
        # Ulysses moves q, k, v and o by all-to-all; ring rotates k and v
        assert info["transport"]["direct"]["all_to_all"] > 0
        assert info["transport"]["staged"].get("send_recv", 0) + \
            info["transport"]["direct"].get("send_recv", 0) > 0


def test_sp_predict_needs_a_seed(trees):
    from mixgrpo_tpu_torch.models.hunyuan.sampler import HunyuanVideoSampler

    pipe = HunyuanVideoPipeline(HCFG, from_jax_params(trees[0], "cpu"), num_steps=1,
                                dtype=torch.float32, attn_impl="ulysses", device="cpu")
    with pytest.raises(ValueError, match="seed"):
        HunyuanVideoSampler(pipe).predict("a prompt", height=16, width=16, video_length=1)


def test_hunyuan_gradient_with_remat_matches_jax(trees):
    htree = trees[0]
    x = _inputs()
    w = np.random.default_rng(12).standard_normal(x["h_z"].shape).astype(np.float32)
    a = {k: jnp.asarray(v) for k, v in x.items()}

    def jloss(p, zz):
        out = JHM.hunyuan_video_forward(p, JHCFG, zz, a["h_txt"], a["h_pooled"], a["h_t"],
                                        a["h_g"], a["h_mask"], dtype=jnp.float32,
                                        attn_impl="xla", remat=True)
        return jnp.sum(out * w)

    jg_p, jg_z = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jax.tree.map(jnp.asarray, htree),
                                                          a["h_z"])
    grads = {}
    for remat in (True, False):
        tp = from_jax_params(htree, "cpu")
        leaves = jax.tree.leaves(tp)
        for t in leaves:
            t.requires_grad_(True)
        zz = torch.from_numpy(x["h_z"]).requires_grad_(True)
        t = torch.from_numpy
        out = HM.hunyuan_video_forward(tp, HCFG, zz, t(x["h_txt"]), t(x["h_pooled"]),
                                       t(x["h_t"]), t(x["h_g"]), t(x["h_mask"]),
                                       dtype=torch.float32, attn_impl="eager", remat=remat)
        (out * t(w)).sum().backward()
        grads[remat] = [zz.grad.numpy()] + [l.grad.numpy() for l in leaves]
    want = [np.asarray(jg_z)] + [np.asarray(g) for g in jax.tree.leaves(jg_p)]
    assert len(want) == len(grads[True])
    for got, ref in zip(grads[True], want):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * max(np.abs(ref).max(), 1e-3))
    for a_, b_ in zip(grads[True], grads[False]):
        np.testing.assert_array_equal(a_, b_)
    assert np.abs(np.asarray(jg_p["double"]["img_qkv"]["w"])).max() > 1e-3
