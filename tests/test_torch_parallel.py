"""The port's ``parallel/`` against JAX's, with the torch side on ``gloo``
ranks spawned on the CPU (``tests/torch_parallel_worker.py``) and the JAX
side on the virtual CPU devices of ``tests/conftest.py``.

- ``MeshConfig.resolved``: the -1 axis and its errors (JAX asserts, the port
  raises ``ValueError``).
- The port's per-leaf specs equal JAX's ``flux_param_specs`` for every leaf
  of the tiny FLUX on meshes fsdp=2, fsdp=2 x tp=2 and dp=2 x fsdp=2.
- Collectives on 2 ranks: the all-to-alls, ``all_gather_seq``, ``psum``,
  ``pmean`` and ``broadcast_from`` and their gradients against JAX's in
  ``shard_map``, round trips, and the gradients of the port's own
  ``split_seq`` and ring rotation against the convention of
  ``parallel/collectives.py`` (``all_gather_seq``'s is the rank's own slice,
  not a sum).
- ``data_spec``, ``batch_axes_for``, ``replicated_spec`` and the activation
  mesh against JAX's on meshes of 2 and 4 devices.
- Ulysses and ring attention against JAX's ``ulysses_attention`` /
  ``ring_attention`` at sp=2 (ring also at sp=4 with 3 heads), with and
  without a key mask: outputs and q/k/v gradients in f32 within 1e-5 abs.
- ``attention(impl="ulysses"|"ring", kv_valid=...)`` on whole tensors, both
  layouts, against JAX's ``attention(impl="xla")`` (1e-5 abs).
- The tensor-parallel cut: at tp = 2 and 4 (with fsdp = 2) every leaf of
  the tiny FLUX cut into its (fsdp, tp) slices joins back bit for bit, and
  each tp slice of a fused leaf holds whole heads (``[q_t | k_t | v_t]``,
  ``[q_t | k_t | v_t | mlp_t]``, ``[attn_t | mlp_t]``); on 4 spawned tp
  ranks ``shard_params`` then ``gather_params`` is the identity.
- Megatron's ``f`` (``tp_enter``) and ``g`` (``tp_reduce``) on 2 tp ranks:
  values and gradients against JAX's ``shard_map`` (a replicated input's
  gradient summed over the axis; ``psum``'s).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu.models.flux import model as JM
from mixgrpo_tpu.ops.attention import attention as jattention
from mixgrpo_tpu.parallel import collectives as JC
from mixgrpo_tpu.parallel import mesh as JMesh
from mixgrpo_tpu.parallel import sharding as JSh
from mixgrpo_tpu.parallel.ring import ring_attention as jring
from mixgrpo_tpu.parallel.ulysses import ulysses_attention as julysses
from mixgrpo_tpu_torch.models.flux import model as M
from mixgrpo_tpu_torch.parallel import MeshConfig, make_mesh
from mixgrpo_tpu_torch.parallel import sharding as Sh
from tests.torch_parallel_worker import spawn_ranks

ATOL = 1e-5
B, H, S, D = 2, 4, 16, 8


def _jmesh(dp=1, fsdp=1, sp=1, tp=1):
    n = dp * fsdp * sp * tp
    return JMesh.make_mesh(JMesh.MeshConfig(dp, fsdp, sp, tp), devices=jax.devices()[:n])


# ----------------------------------------------------------------------------
# mesh and specs (no processes)
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("cfg,n,want", [
    (MeshConfig(), 8, (8, 1, 1, 1)),
    (MeshConfig(dp=1, fsdp=-1), 8, (1, 8, 1, 1)),
    (MeshConfig(dp=2, fsdp=-1, sp=2), 8, (2, 2, 2, 1)),
    (MeshConfig(dp=1, fsdp=1, sp=-1, tp=2), 4, (1, 1, 2, 2)),
    (MeshConfig(dp=1, fsdp=2), 2, (1, 2, 1, 1)),
])
def test_mesh_config_resolves_like_jax(cfg, n, want):
    got = cfg.resolved(n)
    assert dataclasses.astuple(got) == want
    assert dataclasses.astuple(JMesh.MeshConfig(*dataclasses.astuple(cfg)).resolved(n)) == want


@pytest.mark.parametrize("cfg,n", [
    (MeshConfig(dp=-1, fsdp=-1), 8),  # two free axes
    (MeshConfig(dp=-1, fsdp=3), 8),  # does not divide
    (MeshConfig(dp=2, fsdp=2), 8),  # too few
])
def test_mesh_config_errors_like_jax(cfg, n):
    with pytest.raises(ValueError):
        cfg.resolved(n)
    with pytest.raises(AssertionError):
        JMesh.MeshConfig(*dataclasses.astuple(cfg)).resolved(n)


def test_one_process_mesh_is_trivial():
    m = make_mesh(MeshConfig(), device="cpu")
    assert m.shape == {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1}
    assert (m.rank, m.world, m.batch_index, m.batch_size) == (0, 1, 0, 1)
    with pytest.raises(ValueError):
        make_mesh(MeshConfig(dp=1, fsdp=2), device="cpu")


@pytest.mark.parametrize("mesh", [dict(fsdp=2), dict(fsdp=2, tp=2), dict(dp=2, fsdp=2)])
def test_param_specs_match_jax(mesh):
    jparams = jax.eval_shape(lambda: JM.init_flux(jax.random.key(0), JM.FluxConfig.tiny()))
    want = JSh.flux_param_specs(jparams, _jmesh(**mesh))
    params = M.init_flux(M.FluxConfig.tiny(), device="meta")
    got = Sh.flux_param_specs(params, MeshConfig(**{"dp": 1, **mesh}))
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    assert len(flat) == len(Sh.leaf_paths(params))
    sharded = 0
    for path, ns in flat:
        p = "/".join(str(k.key) for k in path)
        assert Sh._lookup(got, p) == tuple(ns.spec), p
        sharded += bool(ns.spec)
    assert sharded > 10  # the rules shard most block leaves


@pytest.mark.parametrize("mesh", [dict(fsdp=2), dict(dp=2, fsdp=2), dict(sp=2), dict(dp=2, tp=2)])
def test_batch_specs_match_jax(mesh):
    jm, cfg = _jmesh(**mesh), MeshConfig(**{"dp": 1, **mesh})
    norm = lambda spec: tuple(tuple(a) if isinstance(a, tuple) else a for a in spec)
    for ndim in (1, 3):
        assert Sh.data_spec(cfg, ndim) == norm(JSh.data_spec(jm, ndim).spec)
        assert Sh.data_spec(cfg, ndim, ("dp",)) == norm(JSh.data_spec(jm, ndim, ("dp",)).spec)
    for dim in (1, 2, 3, 4, 6, 8):
        assert Sh.batch_axes_for(cfg, dim) == JSh.batch_axes_for(jm, dim), dim
    assert Sh.replicated_spec(cfg) == tuple(JSh.replicated_spec(jm).spec) == ()
    m = make_mesh(MeshConfig(), device="cpu")
    try:
        Sh.set_activation_mesh(m)
        assert Sh.get_activation_mesh() is m
    finally:
        Sh.set_activation_mesh(None)
    assert Sh.get_activation_mesh() is None


def test_shard_and_gather_round_trip_one_process():
    params = M.init_flux(M.FluxConfig.tiny(), generator=torch.Generator().manual_seed(0),
                         device="cpu")
    mesh = make_mesh(MeshConfig(), device="cpu")
    specs = Sh.flux_param_specs(params, mesh)
    shards = Sh.shard_params(params, mesh, specs)
    full = Sh.gather_params(shards, mesh, specs)
    for a, b in zip(M.param_leaves(params), M.param_leaves(full)):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------------
# collectives and attention on spawned ranks
# ----------------------------------------------------------------------------


def _inputs(seed, h=H):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, h, S, D)).astype(np.float32) for _ in range(4))
    mask = rng.random((B, S)) > 0.3
    mask[:, 0] = True  # every row keeps a key
    return dict(q=q, k=k, v=v, do=do, mask=mask)


@pytest.fixture(scope="module")
def sp2(tmp_path_factory):
    """Collectives and attention on a 2-rank sp mesh, one spawn each."""
    d = tmp_path_factory.mktemp("sp2")
    rng = np.random.default_rng(1)
    z = dict(x=rng.standard_normal((B, H, S, D)).astype(np.float32),
             w_h2s=rng.standard_normal((B, H, S, D)).astype(np.float32),
             w_full=rng.standard_normal((B, H, S, D)).astype(np.float32), **_inputs(2))
    np.savez(d / "in.npz", **z)
    (d / "in.json").write_text('{"mesh": {"dp": 1, "sp": 2}, "kv_valid": 11}')
    coll = spawn_ranks("collectives", 2, str(d))
    att = spawn_ranks("attention", 2, str(d))
    return z, coll, att


@pytest.fixture(scope="module")
def sp4(tmp_path_factory):
    d = tmp_path_factory.mktemp("sp4")
    z = _inputs(3, h=3)
    np.savez(d / "in.npz", **z)
    (d / "in.json").write_text('{"mesh": {"dp": 1, "sp": 4}, "kv_valid": 13}')
    return z, spawn_ranks("attention", 4, str(d))


def test_collectives_round_trips_and_gradients(sp2):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    z, coll, _ = sp2
    n, x = 2, z["x"]
    jm = _jmesh(sp=2)
    seq, heads = P(None, None, "sp", None), P(None, "sp", None, None)
    j_h2s = np.asarray(shard_map(lambda a: JC.all_to_all_heads_to_seq(a, "sp"), mesh=jm,
                                 in_specs=seq, out_specs=heads)(x))
    j_gather = np.asarray(shard_map(lambda a: JC.all_gather_seq(a, "sp", dim=2), mesh=jm,
                                    in_specs=seq, out_specs=P(), check_vma=False)(x))
    w, wf = z["w_h2s"], z["w_full"]
    # psum, pmean and broadcast_from of the ranks' (4,) values, and their
    # gradients under the replicated cotangent wv, from JAX's shard_map
    vals = [np.arange(4.0) + 10 * r for r in range(n)]
    wv = jnp.arange(1.0, 5.0)
    red = {}
    for name, fn in (("psum", lambda a: JC.psum(a, "sp")), ("pmean", lambda a: JC.pmean(a, "sp")),
                     ("bcast", lambda a: JC.broadcast_from(a, "sp", src=1))):
        f = shard_map(fn, mesh=jm, in_specs=P("sp"), out_specs=P(), check_vma=False)
        xs = jnp.asarray(np.concatenate(vals))
        red[name] = (np.asarray(f(xs)), np.asarray(jax.grad(lambda a: jnp.sum(f(a) * wv))(xs)))
    for i, (o, _) in enumerate(coll):
        sl = lambda a, dim: np.split(a, n, axis=dim)[i]
        np.testing.assert_array_equal(o["h2s"], sl(j_h2s, 1))
        np.testing.assert_array_equal(o["roundtrip"], sl(x, 2))
        np.testing.assert_array_equal(o["h2s_grad"], sl(w, 2))
        np.testing.assert_array_equal(o["gathered"], j_gather)
        np.testing.assert_array_equal(o["gather_grad"], sl(wf, 2))  # own slice, not 2x
        np.testing.assert_array_equal(o["split"], sl(x, 2))
        want = np.concatenate([np.split(wf, n, axis=2)[r] * (1 + r) for r in range(n)], axis=2)
        np.testing.assert_array_equal(o["split_grad"], want)
        for name, (jval, jgrad) in red.items():
            np.testing.assert_array_equal(o[name], jval)
            np.testing.assert_array_equal(o[f"{name}_grad"], np.split(jgrad, n)[i])
        np.testing.assert_array_equal(o["perm"], vals[(i - 1) % n])
        np.testing.assert_array_equal(o["perm_grad"], np.arange(1.0, 5.0) * (1 + (i + 1) % n))
    # gloo on CPU tensors: every operation direct, none staged
    assert coll[0][1]["transport"]["staged"] == {}


def _jax_sp(fn, z, masked):
    """A JAX sequence-parallel attention's output and q/k/v gradients
    (global arrays)."""
    m = jnp.asarray(z["mask"]) if masked else None
    f = lambda q, k, v: jnp.sum(fn(q, k, v, m) * z["do"])
    qkv = [jnp.asarray(z[a]) for a in "qkv"]
    o = np.asarray(jax.jit(lambda q, k, v: fn(q, k, v, m))(*qkv))
    grads = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*qkv)
    return o, [np.asarray(g) for g in grads]


def _check_sp(z, ranks, impl, fn):
    n = len(ranks)
    for masked in (False, True):
        o, grads = _jax_sp(fn, z, masked)
        tag = f"{impl}_{int(masked)}"
        for i, (got, _) in enumerate(ranks):
            sl = lambda a: np.split(a, n, axis=2)[i]
            np.testing.assert_allclose(got[f"{tag}_o"], sl(o), rtol=0, atol=ATOL)
            for name, g in zip("qkv", grads):
                np.testing.assert_allclose(got[f"{tag}_d{name}"], sl(g), rtol=0, atol=ATOL)


def test_ulysses_matches_jax_sp2(sp2):
    z, _, att = sp2
    jm = _jmesh(sp=2)
    _check_sp(z, att, "ulysses",
              lambda q, k, v, m: julysses(q, k, v, jm, "sp", base_impl="xla", mask=m))


@pytest.mark.parametrize("which", ["sp2", "sp4_odd_heads"])
def test_ring_matches_jax(which, sp2, sp4):
    if which == "sp2":
        z, _, att = sp2
    else:
        z, att = sp4
    jm = _jmesh(sp=len(att))
    _check_sp(z, att, "ring", lambda q, k, v, m: jring(q, k, v, jm, "sp", mask=m))


@pytest.mark.parametrize("impl,which", [("ulysses", "sp2"), ("ring", "sp2"),
                                        ("ring", "sp4_odd_heads")])
def test_attention_dispatch_with_kv_valid(impl, which, sp2, sp4):
    """``attention(impl=..., kv_valid=...)`` on whole tensors: every rank
    holds JAX's whole output and gradients, in both layouts."""
    z, ranks, kv = (sp2[0], sp2[2], 11) if which == "sp2" else (sp4[0], sp4[1], 13)
    f = lambda q, k, v: jnp.sum(jattention(q, k, v, impl="xla", kv_valid=kv) * z["do"])
    o = np.asarray(jattention(*(jnp.asarray(z[a]) for a in "qkv"), impl="xla", kv_valid=kv))
    grads = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(z[a]) for a in "qkv"))
    for got, _ in ranks:
        for layout in ("bhsd", "bshd"):
            tag = f"dispatch_{impl}_{layout}"
            np.testing.assert_allclose(got[f"{tag}_o"], o, rtol=0, atol=ATOL)
            for name, g in zip("qkv", grads):
                np.testing.assert_allclose(got[f"{tag}_d{name}"], np.asarray(g), rtol=0,
                                           atol=ATOL)


def test_sp_attention_needs_a_context():
    from mixgrpo_tpu_torch.ops.attention import attention

    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="set_sp_context"):
        attention(q, q, q, impl="ulysses")


# ----------------------------------------------------------------------------
# tensor parallelism: the head-aware cut and Megatron's f and g
# ----------------------------------------------------------------------------


def _index(f=0, nf=1, t=0, nt=1):
    return {"dp": (0, 1), "sp": (0, 1), "fsdp": (f, nf), "tp": (t, nt)}


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_cut_holds_whole_heads_and_round_trips(tp):
    cfg = M.FluxConfig.tiny()
    params = M.init_flux(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    specs = Sh.flux_param_specs(params, MeshConfig(dp=1, fsdp=2, tp=tp))
    n_split = 0
    for path in Sh.leaf_paths(params):
        t, spec = Sh._lookup(params, path), Sh._lookup(specs, path)
        rows = []
        for f in range(2 if "fsdp" in spec else 1):
            cols = [Sh.cut_leaf(t, spec, _index(f, 2, r, tp))
                    for r in range(tp if "tp" in spec else 1)]
            rows.append(Sh.join_slices(cols, spec, "tp", spec.index("tp"))
                        if len(cols) > 1 else cols[0])
        full = torch.cat(rows, spec.index("fsdp")) if len(rows) > 1 else rows[0]
        assert torch.equal(full, t), path
        n_split += "tp" in spec
    assert n_split == 4 * 2 + 2 * 2 + 3  # double: 4 weights + 4 column biases; single
    h, mh = cfg.hidden_size, cfg.mlp_hidden
    a, m = h // tp, mh // tp  # a rank's attention channels and MLP units
    d, sg = params["double"], params["single"]
    for r in range(tp):
        cut = lambda stack, k: Sh.cut_leaf(params[stack][k]["w"], specs[stack][k]["w"],
                                           _index(t=r, nt=tp))
        qkv = d["img_qkv"]["w"]
        want = torch.cat([qkv[..., j * h + r * a:j * h + (r + 1) * a] for j in range(3)], -1)
        assert torch.equal(cut("double", "img_qkv"), want)
        l1 = sg["linear1"]["w"]
        want = torch.cat([l1[..., j * h + r * a:j * h + (r + 1) * a] for j in range(3)]
                         + [l1[..., 3 * h + r * m:3 * h + (r + 1) * m]], -1)
        assert torch.equal(cut("single", "linear1"), want)
        l2 = sg["linear2"]["w"]
        want = torch.cat([l2[:, r * a:(r + 1) * a], l2[:, h + r * m:h + (r + 1) * m]], 1)
        assert torch.equal(cut("single", "linear2"), want)


@pytest.fixture(scope="module")
def tiny_tree():
    params = M.init_flux(M.FluxConfig.tiny(), generator=torch.Generator().manual_seed(0),
                         device="cpu")
    return params


def test_tp_shard_and_gather_round_trip_on_four_ranks(tiny_tree, tmp_path):
    from tests.torch_parallel_worker import load_tree, save_tree

    z = {}
    save_tree("p", tiny_tree, z)
    np.savez(tmp_path / "in.npz", **z)
    (tmp_path / "in.json").write_text('{"mesh": {"dp": 1, "tp": 4}}')
    ranks = spawn_ranks("roundtrip", 4, str(tmp_path))
    specs = Sh.flux_param_specs(tiny_tree, MeshConfig(dp=1, tp=4))
    for r, (o, j) in enumerate(ranks):
        assert j["linear1_parts"] == [128, 128, 128, 512]
        full = load_tree("p", o)
        for a, b in zip(M.param_leaves(full), M.param_leaves(tiny_tree)):
            assert torch.equal(a, b)
        slices = load_tree("s", o)  # this rank's fused leaves
        for stack, k in (("double", "img_qkv"), ("single", "linear1"), ("single", "linear2")):
            for leaf in ("w", "b"):
                want = Sh.cut_leaf(tiny_tree[stack][k][leaf], specs[stack][k][leaf],
                                   _index(t=r, nt=4))
                assert torch.equal(slices[stack][k][leaf], want), (r, k, leaf)


def test_tp_enter_and_reduce_match_jax_shard_map(tmp_path):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(4)
    z = dict(x=rng.standard_normal(4).astype(np.float32),
             w=rng.standard_normal((2, 4)).astype(np.float32),
             v=rng.standard_normal((2, 4)).astype(np.float32),
             wv=rng.standard_normal(4).astype(np.float32))
    np.savez(tmp_path / "in.npz", **z)
    (tmp_path / "in.json").write_text('{"mesh": {"dp": 1, "tp": 2}}')
    ranks = spawn_ranks("tp_ops", 2, str(tmp_path))
    jm = _jmesh(tp=2)
    # f: a replicated input to per-rank products; its gradient sums the ranks'
    enter = shard_map(lambda x, w: x * w[0], mesh=jm, in_specs=(P(), P("tp")),
                      out_specs=P("tp"))
    j_enter_grad = jax.grad(lambda x: jnp.sum(enter(x, jnp.asarray(z["w"]))))(
        jnp.asarray(z["x"]))
    # g: the sum of the ranks' parts; each part's gradient is the cotangent
    red = shard_map(lambda v: JC.psum(v[0], "tp"), mesh=jm, in_specs=P("tp"), out_specs=P(),
                    check_vma=False)
    vs = jnp.asarray(z["v"])
    j_red = np.asarray(red(vs))
    j_red_grad = np.asarray(jax.grad(lambda v: jnp.sum(red(v) * z["wv"]))(vs))
    for i, (o, j) in enumerate(ranks):
        np.testing.assert_array_equal(o["enter"], z["x"])
        np.testing.assert_allclose(o["enter_grad"], np.asarray(j_enter_grad), rtol=1e-6)
        np.testing.assert_allclose(o["reduce"], j_red, rtol=1e-6)
        np.testing.assert_array_equal(o["reduce_grad"], j_red_grad[i])
        # one all-reduce each way, the x gradient's and v's 4 floats
        assert j["tp"] == {"enter_grad": 1, "enter_grad_bytes": 16, "reduce": 1,
                           "reduce_bytes": 16}
