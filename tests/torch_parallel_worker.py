"""One rank of the port's multi-process CPU tests (``gloo``).

``python tests/torch_parallel_worker.py CASE RANK WORLD PORT DIR`` joins a
``gloo`` group of WORLD ranks at ``localhost:PORT``, runs CASE on the inputs
the test wrote to ``DIR/in.npz`` (and ``DIR/in.json``), and writes
``DIR/out_<RANK>.npz`` (and ``.json``).  Spawned by ``spawn_ranks`` from
``tests/test_torch_parallel.py`` and ``tests/test_torch_parallel_train.py``;
it imports the port only, never JAX.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


# ----------------------------------------------------------------------------
# the test side
# ----------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(case: str, world: int, d: str, timeout: float = 240.0):
    """Run ``case`` on ``world`` ranks over ``d``; raises with every failed
    rank's output.  Returns each rank's (npz dict, json dict)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(world))
    procs = []
    for r in range(world):
        env_r = dict(env, RANK=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(r), str(world), str(port), d],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env_r))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [f"rank {r} (exit {p.returncode}):\n{o[-6000:]}"
           for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode != 0]
    if bad:
        raise AssertionError(f"{case}: " + "\n".join(bad))
    res = []
    for r in range(world):
        z = np.load(os.path.join(d, f"out_{r}.npz"))
        j = json.load(open(os.path.join(d, f"out_{r}.json")))
        res.append(({k: z[k] for k in z.files}, j))
    return res


def save_tree(prefix: str, tree, out: dict):
    """A parameter tree into ``out`` as ``prefix.path.to.leaf`` -> numpy (a
    copy: a trainer built on ``load_tree`` of it updates its leaves in
    place).  A list's items are keyed ``#<index>``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            save_tree(f"{prefix}.{k}", v, out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            save_tree(f"{prefix}.#{i}", v, out)
    else:
        out[prefix] = np.array(tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree)


def load_tree(prefix: str, z) -> dict:
    tree: dict = {}
    for key in z:
        if not key.startswith(prefix + "."):
            continue
        parts = key[len(prefix) + 1:].split(".")
        t = tree
        for p in parts[:-1]:
            t = t.setdefault(p, {})
        t[parts[-1]] = torch.as_tensor(np.asarray(z[key]))
    return _lists(tree)


def _lists(tree):
    """``save_tree``'s ``#<index>`` keys back into lists."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    if out and all(k.startswith("#") for k in out):
        return [out[f"#{i}"] for i in range(len(out))]
    return out


# ----------------------------------------------------------------------------
# the cases (one rank)
# ----------------------------------------------------------------------------


def case_collectives(mesh, z, cfg, out, info):
    """Round trips and gradients of every collective over the sp axis, on
    rank-dependent inputs the test recomputes."""
    from mixgrpo_tpu_torch.parallel import collectives as C

    n, i = mesh.size("sp"), mesh.index("sp")
    x = torch.as_tensor(z["x"])  # (B, H, S, D), the global tensor
    local = x.chunk(n, dim=2)[i].clone().requires_grad_(True)
    h2s = C.all_to_all_heads_to_seq(local, mesh)
    out["h2s"] = h2s.detach().numpy()
    back = C.all_to_all_seq_to_heads(h2s, mesh)
    out["roundtrip"] = back.detach().numpy()
    w = torch.as_tensor(z["w_h2s"]).chunk(n, dim=1)[i]  # cotangent of this rank's h2s
    (g,) = torch.autograd.grad((h2s * w).sum(), local)
    out["h2s_grad"] = g.numpy()

    full = C.all_gather_seq(local, mesh, dim=2)
    out["gathered"] = full.detach().numpy()
    wf = torch.as_tensor(z["w_full"])  # replicated cotangent of the gathered tensor
    (g,) = torch.autograd.grad((full * wf).sum(), local)
    out["gather_grad"] = g.numpy()

    xr = x.clone().requires_grad_(True)  # replicated in, sharded out
    piece = C.split_seq(xr, mesh, dim=2)
    out["split"] = piece.detach().numpy()
    wl = torch.as_tensor(z["w_full"]).chunk(n, dim=2)[i] * (1 + i)
    (g,) = torch.autograd.grad((piece * wl).sum(), xr)
    out["split_grad"] = g.numpy()

    v = (torch.arange(4.0) + 10 * i).requires_grad_(True)
    s, m, b = C.psum(v, mesh, "sp"), C.pmean(v, mesh, "sp"), C.broadcast_from(v, mesh, "sp", 1)
    out["psum"], out["pmean"], out["bcast"] = (t.detach().numpy() for t in (s, m, b))
    wv = torch.arange(1.0, 5.0)  # the cotangent of each replicated result
    out["psum_grad"] = torch.autograd.grad((s * wv).sum(), v)[0].numpy()
    out["pmean_grad"] = torch.autograd.grad((m * wv).sum(), v)[0].numpy()
    out["bcast_grad"] = torch.autograd.grad((b * wv).sum(), v)[0].numpy()
    r = C.ppermute_next(v, mesh, "sp")
    out["perm"] = r.detach().numpy()
    out["perm_grad"] = torch.autograd.grad((r * torch.arange(1.0, 5.0) * (1 + i)).sum(),
                                           v)[0].numpy()
    info["transport"] = C.transport_record()


def case_attention(mesh, z, cfg, out, info):
    """Ulysses and ring on this rank's slices (outputs and q/k/v gradients),
    with and without a key mask; then ``attention(impl=...)`` on whole
    tensors with ``kv_valid``."""
    from mixgrpo_tpu_torch.ops.attention import attention
    from mixgrpo_tpu_torch.parallel import collectives as C
    from mixgrpo_tpu_torch.parallel.ring import ring_attention
    from mixgrpo_tpu_torch.parallel.ulysses import set_sp_context, ulysses_attention

    n, i = mesh.size("sp"), mesh.index("sp")
    q, k, v, do = (torch.as_tensor(z[a]) for a in ("q", "k", "v", "do"))
    mask = torch.as_tensor(z["mask"])
    impls = ["ring"] + (["ulysses"] if q.shape[1] % n == 0 else [])
    for impl in impls:
        for masked in (False, True):
            ql, kl, vl = (t.chunk(n, dim=2)[i].clone().requires_grad_(True) for t in (q, k, v))
            m = mask.chunk(n, dim=1)[i] if masked else None
            if impl == "ring":
                o = ring_attention(ql, kl, vl, mesh, "sp", mask=m)
            else:
                o = ulysses_attention(ql, kl, vl, mesh, "sp", mask=m)
            grads = torch.autograd.grad((o * do.chunk(n, dim=2)[i]).sum(), (ql, kl, vl))
            tag = f"{impl}_{int(masked)}"
            out[f"{tag}_o"] = o.detach().numpy()
            for name, g in zip("qkv", grads):
                out[f"{tag}_d{name}"] = g.numpy()
    set_sp_context(mesh, "sp")
    kv = int(cfg["kv_valid"])
    for impl in impls:
        for layout in ("bhsd", "bshd"):
            tr = (lambda t: t.transpose(1, 2)) if layout == "bshd" else (lambda t: t)
            qf, kf, vf = (tr(t).clone().requires_grad_(True) for t in (q, k, v))
            o = tr(attention(qf, kf, vf, impl=impl, layout=layout, kv_valid=kv))
            grads = torch.autograd.grad((o * do).sum(), (qf, kf, vf))
            tag = f"dispatch_{impl}_{layout}"
            out[f"{tag}_o"] = o.detach().numpy()
            for name, g in zip("qkv", grads):
                out[f"{tag}_d{name}"] = tr(g).numpy()
    set_sp_context(None)
    info["transport"] = C.transport_record()


def case_video_sp(mesh, z, cfg, out, info):
    """HunyuanVideo (a text mask and pad keys) and Mochi (the final block's
    Sq != Sk) with ``attn_impl="ulysses"`` and ``"ring"`` on whole inputs
    that every rank holds; then HunyuanVideo's pipeline under Ulysses."""
    from mixgrpo_tpu_torch.models.hunyuan import model as HM
    from mixgrpo_tpu_torch.models.hunyuan.pipeline import HunyuanVideoPipeline
    from mixgrpo_tpu_torch.models.mochi import model as MM
    from mixgrpo_tpu_torch.parallel import collectives as C
    from mixgrpo_tpu_torch.parallel.ulysses import set_sp_context

    t = lambda k: torch.as_tensor(z[k])
    hp, mp = load_tree("h", z), load_tree("m", z)
    hcfg, mcfg = HM.HunyuanVideoConfig.tiny(), MM.MochiConfig.tiny()
    set_sp_context(mesh, "sp")
    with torch.no_grad():
        for impl in ("ulysses", "ring"):
            out[f"h_{impl}"] = HM.hunyuan_video_forward(
                hp, hcfg, t("h_z"), t("h_txt"), t("h_pooled"), t("h_t"), t("h_g"),
                t("h_mask"), dtype=torch.float32, attn_impl=impl,
                pad_seq_multiple=cfg["pad"]).numpy()
            out[f"m_{impl}"] = MM.mochi_forward(
                mp, mcfg, t("m_z"), t("m_txt"), t("m_t"), t("m_mask"), dtype=torch.float32,
                attn_impl=impl).numpy()
    pipe = HunyuanVideoPipeline(hcfg, hp, num_steps=2, dtype=torch.float32,
                                attn_impl="ulysses", device="cpu")
    z0 = t("h_z")[:1]
    out["h_pipeline"] = pipe(t("h_txt")[:1], t("h_pooled")[:1], video_length=1,
                             height=z0.shape[2] * 8, width=z0.shape[3] * 8,
                             text_mask=t("h_mask")[:1], z0=z0).numpy()
    set_sp_context(None)
    info["transport"] = C.transport_record()


def case_tp_ops(mesh, z, cfg, out, info):
    """Megatron's ``f`` (``tp_enter``) and ``g`` (``tp_reduce``) over the tp
    axis: values and gradients under this rank's cotangent."""
    from mixgrpo_tpu_torch.parallel import collectives as C

    i = mesh.index("tp")
    x = torch.as_tensor(z["x"]).clone().requires_grad_(True)  # whole on every rank
    y = C.tp_enter(x, mesh)
    out["enter"] = y.detach().numpy()
    out["enter_grad"] = torch.autograd.grad((y * torch.as_tensor(z["w"][i])).sum(), x)[0].numpy()
    v = torch.as_tensor(z["v"][i]).clone().requires_grad_(True)  # this rank's part
    s = C.tp_reduce(v, mesh)
    out["reduce"] = s.detach().numpy()
    out["reduce_grad"] = torch.autograd.grad((s * torch.as_tensor(z["wv"])).sum(), v)[0].numpy()
    info["tp"] = C.transport_record()["tp"]


def case_roundtrip(mesh, z, cfg, out, info):
    """``shard_params`` then ``gather_params`` of the whole tree, and this
    rank's slices of the fused leaves."""
    from mixgrpo_tpu_torch.parallel.sharding import (
        flux_param_specs, gather_params, shard_params,
    )

    params = load_tree("p", z)
    specs = flux_param_specs(params, mesh)
    shards = shard_params(params, mesh, specs)
    info["linear1_parts"] = list(specs["single"]["linear1"]["w"].parts)
    save_tree("s", {"double": {"img_qkv": shards["double"]["img_qkv"]},
                    "single": {k: shards["single"][k] for k in ("linear1", "linear2")}}, out)
    save_tree("p", gather_params(shards, mesh, specs), out)


def case_forward(mesh, z, cfg, out, info):
    """``flux_forward`` on this rank's tp slices of the tree, in f32 and in
    int8 (quantised with the scales over tp)."""
    from mixgrpo_tpu_torch.models.flux.model import FluxConfig, flux_forward
    from mixgrpo_tpu_torch.ops.quant import quantize_flux_params
    from mixgrpo_tpu_torch.parallel.sharding import flux_param_specs, shard_params

    params = load_tree("p", z)
    mine = shard_params(params, mesh, flux_param_specs(params, mesh))
    args = [torch.as_tensor(z[k]) for k in ("img", "txt", "pooled", "t", "g", "rope_cos",
                                            "rope_sin")]
    for tag, p in (("out", mine), ("out_int8", quantize_flux_params(mine, tp=mesh))):
        out[tag] = flux_forward(p, FluxConfig.tiny(), *args, dtype=torch.float32,
                                attn_impl="eager", tp=mesh).numpy()


def case_update(mesh, z, cfg, out, info):
    """One ``update_step`` on this rank's rows and shards; rank 0 writes the
    gathered parameters after it and the metrics."""
    from mixgrpo_tpu_torch.models.flux.model import FluxConfig, param_leaves
    from mixgrpo_tpu_torch.parallel.sharding import (
        flux_param_specs, gather_params, shard_params,
    )
    from mixgrpo_tpu_torch.parallel.ulysses import set_sp_context
    from mixgrpo_tpu_torch.rl.ppo import PPOConfig
    from mixgrpo_tpu_torch.solvers.rollout import SamplerConfig
    from mixgrpo_tpu_torch.trainer import UpdateBatch, make_optimizer, make_update_fns

    params = load_tree("p", z)
    specs = flux_param_specs(params, mesh)
    params = shard_params(params, mesh, specs)
    for t in param_leaves(params):
        t.requires_grad_(True)
    rows = lambda a: torch.as_tensor(a).chunk(mesh.batch_size)[mesh.batch_index]
    ub = UpdateBatch(*(rows(z[f"b_{f}"]) for f in UpdateBatch._fields))
    scfg = SamplerConfig(**cfg["sampler"])
    opt = make_optimizer(learning_rate=cfg["lr"], weight_decay=cfg["wd"],
                         max_grad_norm=cfg["max_grad_norm"])
    update_step = make_update_fns(
        FluxConfig.tiny(), scfg, PPOConfig(clip_range=0.2), opt,
        torch.as_tensor(z["rope_cos"]), torch.as_tensor(z["rope_sin"]), dtype=torch.float32,
        attn_impl=cfg.get("attn", "eager"), remat=cfg["remat"], mesh=mesh, param_specs=specs)[0]
    set_sp_context(mesh, "sp")
    state = opt.init(params)
    params, state, m = update_step(params, state, ub, torch.as_tensor(z["sigmas"]))
    info["metrics"] = {k: float(v) for k, v in m.items()}
    full = gather_params(params, mesh, specs)
    if mesh.rank == 0:
        save_tree("p", full, out)


def base_shards(params, specs) -> dict:
    """Each sharded leaf's local shape and spec, by path."""
    from mixgrpo_tpu_torch.models.flux.model import param_leaves
    from mixgrpo_tpu_torch.parallel.sharding import flatten_specs, leaf_paths

    return {p: [list(t.shape), list(s)] for p, t, s in
            zip(leaf_paths(params), param_leaves(params), flatten_specs(specs)) if any(s)}


def case_update_lora(mesh, z, cfg, out, info):
    """One LoRA ``update_step`` over this rank's shards of the frozen base
    (the factors whole, from the test); writes the factors after it, the
    metrics and the base's shard shapes."""
    from mixgrpo_tpu_torch.models.flux.model import FluxConfig
    from mixgrpo_tpu_torch.parallel.sharding import flux_param_specs, shard_params
    from mixgrpo_tpu_torch.rl.ppo import PPOConfig
    from mixgrpo_tpu_torch.solvers.rollout import SamplerConfig
    from mixgrpo_tpu_torch.trainer import UpdateBatch, make_lora_update_fns, make_optimizer

    params = load_tree("p", z)
    specs = flux_param_specs(params, mesh)
    base = shard_params(params, mesh, specs)
    factors = {}
    for key in z:
        if key.startswith("f."):
            path, kind = key[2:].rsplit(".", 1)
            factors.setdefault(path.replace("|", "/"), {})[kind] = torch.as_tensor(z[key])
    rows = lambda a: torch.as_tensor(a).chunk(mesh.batch_size)[mesh.batch_index]
    ub = UpdateBatch(*(rows(z[f"b_{f}"]) for f in UpdateBatch._fields))
    opt = make_optimizer(learning_rate=cfg["lr"], weight_decay=cfg["wd"],
                         max_grad_norm=cfg["max_grad_norm"])
    step = make_lora_update_fns(
        FluxConfig.tiny(), SamplerConfig(**cfg["sampler"]), PPOConfig(clip_range=0.2), opt,
        torch.as_tensor(z["rope_cos"]), torch.as_tensor(z["rope_sin"]), dtype=torch.float32,
        attn_impl="eager", remat=True, mesh=mesh, param_specs=specs)
    state = opt.init(factors)
    factors, state, m = step(factors, state, cfg["meta"], base, ub, torch.as_tensor(z["sigmas"]))
    info["metrics"] = {k: float(v) for k, v in m.items()}
    info["base_shards"] = base_shards(base, specs)
    for path, f in factors.items():
        for kind, t in f.items():
            out[f"f.{path.replace('/', '|')}.{kind}"] = t.detach().numpy()


def _trainer(mesh, z, cfg, d, **over):
    from mixgrpo_tpu_torch.config import (
        DataConfig, GRPOConfig, MeshConfig, OptimConfig, RunConfig, TrainConfig, WindowConfig,
    )
    from mixgrpo_tpu_torch.models.flux.model import FluxConfig
    from mixgrpo_tpu_torch.models.flux.vae import VAEConfig, init_vae_decoder
    from mixgrpo_tpu_torch.train import GRPOTrainer

    quant = {"rollout_quant": "int8"} if cfg.get("int8") else {}
    tc = TrainConfig(
        data=DataConfig(train_batch_size=1),
        optim=OptimConfig(gradient_accumulation_steps=cfg["accum"], learning_rate=1e-4,
                          weight_decay=1e-2),
        grpo=GRPOConfig(h=cfg["res"], w=cfg["res"], sampling_steps=cfg["steps"],
                        num_generations=cfg["G"], rollout_chunk=cfg["chunk"],
                        clip_range=0.2, advantage_rerange_strategy="null",
                        timestep_fraction=0.5, **quant),
        window=WindowConfig(iters_per_group=2, group_size=2, prog_overlap=False),
        run=RunConfig(output_dir=d, checkpointing_steps=100,
                      export_safetensors=over.pop("export", "off"),
                      resume_from_checkpoint=over.pop("resume", False)),
        mesh=MeshConfig(**cfg["mesh"]))
    vcfg = VAEConfig.tiny(latent_channels=FluxConfig.tiny().in_channels // 4)
    vae = init_vae_decoder(vcfg, generator=torch.Generator().manual_seed(5), device="cpu")

    def brightness(images01, captions):
        r = images01.float().mean(dim=(1, 2, 3)).cpu().numpy().astype(np.float64)
        return {"synthetic": r}, {"synthetic": np.ones_like(r)}

    lora = dict(use_lora=True, lora_rank=4, lora_alpha=8.0) if cfg.get("lora") else {}
    tr = GRPOTrainer(tc, flux_cfg=FluxConfig.tiny(), params=load_tree("p", z), vae_cfg=vcfg,
                     vae_params=vae, reward_fn=brightness,
                     text_len=int(cfg["text_len"]), attn_impl="eager", dtype=torch.float32,
                     device="cpu", **lora)
    tr.reward_weights = {"synthetic": 1.0}
    return tr


def run_train_step(tr, mesh, z, cfg):
    """One ``train_one_step`` on this batch rank's prompt with the noise the
    test drew for its rows."""
    b, n = mesh.batch_index, mesh.batch_size
    rows = lambda a: a[b * len(a) // n:(b + 1) * len(a) // n]
    batch = {"prompt_embed": rows(z["prompt_embed"]), "pooled": rows(z["pooled"]),
             "captions": rows(list(cfg["captions"]))}
    z0 = torch.as_tensor(rows(z["z0"]))
    noise = z["noise"]  # (chunks of the one-rank run, steps, rows, L, C)
    chunks_per_rank = noise.shape[0] // n
    local_rows = z0.shape[0]

    def noise_fn(j, i, shape):
        # this rank's rows are chunks [b*c, (b+1)*c) of the one-rank run
        parts = noise[b * chunks_per_rank:(b + 1) * chunks_per_rank, i]
        flat = parts.reshape(-1, *parts.shape[2:])[:local_rows]
        if j is not None:
            flat = flat[j * shape[0]:(j + 1) * shape[0]]
        return torch.as_tensor(flat.reshape(shape))

    return tr.train_one_step(batch, list(cfg["window"]), z0=z0, noise_fn=noise_fn)


def case_train(mesh, z, cfg, out, info):
    """One iteration on the mesh; then a checkpoint, a resume on the same
    mesh into a new trainer, and the export."""
    from mixgrpo_tpu_torch.parallel.sharding import gather_params

    d = cfg["out_dir"]
    tr = _trainer(mesh, z, cfg, d, export="required")
    m = run_train_step(tr, mesh, z, cfg)
    info["metrics"] = {k: float(v) for k, v in m.items() if np.isscalar(v)}
    full = gather_params(tr.params, mesh, tr.param_specs)
    moments = _gathered_moments(tr, mesh)
    if mesh.rank == 0:
        save_tree("p", full, out)
        out.update(moments)
    tr.global_step = 1
    tr.save_checkpoint()
    tr.close()
    tr2 = _trainer(mesh, z, cfg, d, resume=True)
    same = all(torch.equal(a, b) for a, b in zip(_leaves(tr.params), _leaves(tr2.params)))
    same_opt = all(
        torch.equal(sa["exp_avg"], sb["exp_avg"])
        for sa, sb in zip(tr.opt_state.state.values(), tr2.opt_state.state.values()))
    info["resumed"] = {"step": tr2.global_step, "params_equal": same, "opt_equal": same_opt,
                       "shard_shape": list(tr.params["double"]["img_qkv"]["w"].shape)}
    tr2.close()


def case_restore(mesh, z, cfg, out, info):
    """A trainer resumed on this mesh from the checkpoint under
    ``out_dir``; rank 0 writes the gathered parameters and AdamW moments."""
    from mixgrpo_tpu_torch.parallel.sharding import gather_params

    tr = _trainer(mesh, z, cfg, cfg["out_dir"], resume=True)
    full = gather_params(tr.params, mesh, tr.param_specs)
    moments = _gathered_moments(tr, mesh)
    info["step"] = tr.global_step
    info["shard_shape"] = list(tr.params["single"]["linear1"]["w"].shape)
    if mesh.rank == 0:
        save_tree("p", full, out)
        out.update(moments)
    tr.close()


def _gathered_moments(tr, mesh) -> dict:
    """The AdamW moments of every leaf, whole (``m.<moment>.<leaf index>``)."""
    from mixgrpo_tpu_torch.parallel.sharding import flatten_specs, gather_leaf

    specs = flatten_specs(tr.param_specs) if tr.param_specs is not None else None
    out = {}
    opt = tr.opt_state
    for i, p in enumerate(opt.param_groups[0]["params"]):
        st = opt.state[p]
        for k in ("exp_avg", "exp_avg_sq"):
            t = st[k] if specs is None else gather_leaf(st[k], mesh, specs[i])
            out[f"m.{k}.{i}"] = t.numpy()
    return out


def case_rollout_int8(mesh, z, cfg, out, info):
    """The trainer's int8 rollout of both prompts (every row on every rank)
    with the test's noise: the rollout copy gathered over fsdp, quantised
    with the scales over tp, run on the tp slices."""
    from mixgrpo_tpu_torch.ops.quant import quantize_flux_params
    from mixgrpo_tpu_torch.parallel.sharding import gather_params

    tr = _trainer(mesh, z, cfg, cfg["out_dir"])
    p = tr.params
    if tr.sharded:
        p = gather_params(p, mesh, tr.param_specs, tr.dtype, axes=("fsdp",))
    q = quantize_flux_params(p, tp=tr.tp)
    G = cfg["G"]
    txt, pooled = (torch.as_tensor(np.repeat(z[k], G, 0)) for k in ("prompt_embed", "pooled"))
    sig, det, n = tr._schedule_for_window(list(cfg["window"]))
    o = tr.sampler.chunked_rollout(
        q, torch.as_tensor(z["z0"]), txt, pooled, sig, det, n, None, chunk=cfg["chunk"],
        noise_fn=lambda j, i, shape: torch.as_tensor(z["noise"][j, i]), tp=tr.tp)
    out["log_probs"], out["latents"] = o.all_log_probs.numpy(), o.all_latents.numpy()
    tr.close()


def case_train_lora(mesh, z, cfg, out, info):
    """One LoRA iteration on the mesh (the frozen base sharded, the factors
    whole on every rank); then a checkpoint with the export, counting this
    rank's safetensors writes, and the base's shard shapes."""
    from mixgrpo_tpu_torch.utils import checkpoint as CK

    writes = []
    save_file = CK.save_file

    def counted(*a, **k):
        writes.append(a[1])
        return save_file(*a, **k)

    CK.save_file = counted
    tr = _trainer(mesh, z, cfg, cfg["out_dir"], export="required")
    info["base_shards"] = base_shards(tr.params, tr.param_specs)
    m = run_train_step(tr, mesh, z, cfg)
    info["metrics"] = {k: float(v) for k, v in m.items() if np.isscalar(v)}
    for j, t in enumerate(_leaves(tr.lora_factors)):
        out[f"f{j}"] = t.numpy()
    tr.global_step = 1
    tr.save_checkpoint()
    tr.close()
    info["export_writes"] = len(writes)


def _leaves(tree):
    from mixgrpo_tpu_torch.models.flux.model import param_leaves

    return [t.detach() for t in param_leaves(tree)]


def case_train_main(mesh, z, cfg, out, info):
    """``train.main`` under torchrun's environment with ``cfg["argv"]``."""
    from mixgrpo_tpu_torch import presets as P
    from mixgrpo_tpu_torch import train as T

    tr = T.main(cfg["argv"], family=P.flux_family("tiny"))
    ck = os.path.join(tr.run_dir, "checkpoints", str(tr.global_step))
    info.update(step=tr.global_step, mesh=tr.mesh.to_dict(), files=sorted(os.listdir(ck)),
                qkv_shape=list(tr.params["double"]["img_qkv"]["w"].shape),
                run_files=sorted(os.listdir(tr.run_dir)))


def case_preprocess(mesh, z, cfg, out, info):
    """``preprocess.main`` under torchrun's environment: each rank encodes
    its share into ``host_<rank>``."""
    from mixgrpo_tpu_torch import preprocess as Pre
    from mixgrpo_tpu_torch import presets as P

    info["manifest"] = Pre.main(cfg["argv"], family=P.flux_family("tiny"))


def case_cli(mesh, z, cfg, out, info):
    """``sample.main`` then ``eval_rewards.main`` under torchrun's
    environment (each rank its own prompts and entries)."""
    from mixgrpo_tpu_torch import eval_rewards as E
    from mixgrpo_tpu_torch import presets as P
    from mixgrpo_tpu_torch import sample as Sa

    Sa.main(["--model_path", cfg["tree"], "--prompt_path", cfg["prompts"],
             "--output_dir", cfg["out"], "--h", "32", "--w", "32", "--sampling_steps", "2",
             "--mix_sampling_steps", "1", "--batch_size", "2", "--seed", "7",
             "--device", "cpu"], family=P.flux_family("tiny"))
    import torch.distributed as dist

    dist.barrier()  # every rank's metadata is on disk before the scoring
    summary = E.main(["--metadata", cfg["out"], "--image_dir", cfg["out"],
                      "--output_dir", cfg["eval"], "--reward_model", "hpsv2",
                      "--hps_path", cfg["hps"], "--clip_bpe_path", cfg["merges"],
                      "--batch_size", "2", "--device", "cpu"])
    info["summary"] = summary


CASES = {"collectives": case_collectives, "attention": case_attention,
         "update": case_update, "train": case_train, "train_lora": case_train_lora,
         "tp_ops": case_tp_ops, "roundtrip": case_roundtrip, "restore": case_restore,
         "rollout_int8": case_rollout_int8, "forward": case_forward,
         "train_main": case_train_main, "video_sp": case_video_sp,
         "update_lora": case_update_lora, "preprocess": case_preprocess,
         "cli": case_cli}


def main():
    case, rank, world, port, d = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.manual_seed(0)
    from mixgrpo_tpu_torch.parallel.mesh import MeshConfig, init_distributed, make_mesh

    init_distributed(f"localhost:{port}", world, rank, device="cpu", timeout_s=180)
    cfg = json.load(open(os.path.join(d, "in.json")))
    z = np.load(os.path.join(d, "in.npz"))
    mesh = make_mesh(MeshConfig(**cfg["mesh"]), device="cpu")
    out, info = {}, {}
    try:
        CASES[case](mesh, z, cfg, out, info)
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # no collective waits for a rank that failed
    np.savez(os.path.join(d, f"out_{rank}.npz"), **out)
    with open(os.path.join(d, f"out_{rank}.json"), "w") as f:
        json.dump(info, f)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
