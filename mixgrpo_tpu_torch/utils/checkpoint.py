"""Training checkpoints on ``torch.save``, one file per (fsdp, tp) shard.

Port of mixgrpo_tpu/utils/checkpoint.py's ``CheckpointManager``.  JAX writes
sharded Orbax checkpoints in which every host writes its own shards; here
each (fsdp, tp) shard of the parameters, the optimizer state and the EMA
parameters is written by the rank that holds it, with no gather of the whole
state to one rank: ``<directory>/<step>/shard<f>of<F>.pt``, or
``shard<f>of<F>_tp<t>of<T>.pt`` when ``tp`` splits the tree (one rank per
(fsdp, tp) pair writes: the one at dp and sp index 0; the others hold the
same values).  The file also holds the sliding-window state, extra metadata
and the step, so a resumed run continues the window walk.  Rank 0 writes
``<step>/manifest.json`` (the mesh, the file names and each parameter's
spec, ``parallel.sharding.Spec``) once every shard is on disk, and a step
exists only once its manifest does.

``restore`` on a mesh with the same fsdp and tp sizes reads this rank's file.
On any other mesh (one process included) it assembles each leaf of the
parameters, the EMA parameters and the AdamW moments from every file
through the saved specs (``sharding.join_slices``, the inverse of the cut)
and keeps this rank's slice of it under the current specs
(``sharding.cut_leaf``), one leaf at a time from memory-mapped files, so no
rank holds the whole state; the leaves are JAX's layout bit for bit, as
JAX's Orbax restore onto another mesh gives them.

Tensors are copied to the host before the write.  ``blocking=False`` lets the
disk write run in a background thread (joined by the next save, ``wait`` or
``close``) on one process; across ranks the save blocks, since the manifest
waits for every rank's file.  Each file is written under a temporary name,
then renamed.  ``max_to_keep`` (JAX's Orbax option) keeps only the newest
steps: once a save's manifest is written (inside the background thread,
when there is one), the writer of the manifest removes the oldest step
directories beyond it.

``export_flux_safetensors`` writes FLUX parameters under diffusers
``FluxTransformer2DModel`` names in F32, as JAX's does, so trained weights
load into diffusers and into ``models/flux/load.py::load_flux_params`` (it
is that loader's inverse).  It is two halves: ``diffusers_state`` (names ->
views of the parameters, transposed and split, on their device and in their
dtype) and ``utils.safetensors_io.save_file`` (which casts and copies one
tensor at a time to the host).  On a mesh, the leaves are gathered one at a
time to rank 0's host, and rank 0 alone writes.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from mixgrpo_tpu_torch.utils.safetensors_io import save_file

_MANIFEST = "manifest.json"
_ONE = {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1}


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None, mesh=None,
                 specs=None):
        """``max_to_keep``: the number of newest steps kept (None: every
        step).  ``mesh``: the ``parallel.mesh.Mesh`` the state is sharded on
        (None: one process).  ``specs``: the tree of
        ``sharding.flux_param_specs`` the parameters are cut by on ``mesh``
        (None: whole on every rank)."""
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError(f"max_to_keep must be at least 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.mesh = mesh
        self.specs = specs
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._last_ema = None

    # -- layout ------------------------------------------------------------

    def _mesh_dict(self) -> Dict[str, int]:
        return self.mesh.to_dict() if self.mesh is not None else dict(_ONE)

    def _shard(self) -> Tuple[int, int, int, int]:
        """(fsdp index, fsdp size, tp index, tp size) of this rank."""
        if self.mesh is None:
            return 0, 1, 0, 1
        c, m = self.mesh.coords, self.mesh.cfg
        return c["fsdp"], m.fsdp, c["tp"], m.tp

    def _writes(self) -> bool:
        c = self.mesh.coords if self.mesh is not None else None
        return c is None or c["dp"] == c["sp"] == 0

    @staticmethod
    def _file(f: int, n: int, t: int = 0, nt: int = 1) -> str:
        return f"shard{f}of{n}.pt" if nt == 1 else f"shard{f}of{n}_tp{t}of{nt}.pt"

    def _spec_blob(self):
        """Each parameter's spec by path (None: whole on every rank)."""
        if self.specs is None:
            return None
        out = {}

        def walk(tree, path):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, f"{path}{k}/")
            else:
                out[path[:-1]] = tree.to_json()

        walk(self.specs, "")
        return out

    def _barrier(self):
        if self.mesh is not None and self.mesh.world > 1:
            import torch.distributed as dist

            dist.barrier()

    # -- save --------------------------------------------------------------

    def save(self, step: int, params: Any, opt_state: Any = None,
             window_state: Optional[dict] = None, extra: Optional[dict] = None,
             ema_params: Any = None, blocking: bool = True) -> None:
        """Save one step (this rank's shard).  ``opt_state`` is a
        ``torch.optim`` optimizer or its ``state_dict``."""
        self.wait()
        multi = self.mesh is not None and self.mesh.world > 1
        state = None
        if self._writes():
            if opt_state is not None and hasattr(opt_state, "state_dict"):
                opt_state = opt_state.state_dict()
            state = _to_host({
                "params": params, "opt_state": opt_state, "ema_params": ema_params,
                "meta": {"window_state": window_state, "extra": extra or {}, "step": step},
            })
        if blocking or multi:
            self._write(step, state)
        else:
            self._thread = threading.Thread(target=self._write_logged, args=(step, state),
                                            daemon=True)
            self._thread.start()

    def _write_logged(self, step, state):
        try:
            self._write(step, state)
        except Exception as e:  # re-raised by wait() in the caller's thread
            self._error = e

    def _write(self, step, state):
        d = os.path.join(self.directory, str(step))
        os.makedirs(d, exist_ok=True)
        f, n, t, nt = self._shard()
        if state is not None:
            tmp = os.path.join(d, self._file(f, n, t, nt) + ".tmp")
            torch.save(state, tmp)
            os.replace(tmp, os.path.join(d, self._file(f, n, t, nt)))
        self._barrier()  # every shard is on disk before the manifest
        if self.mesh is None or self.mesh.rank == 0:
            manifest = {"step": step, "mesh": self._mesh_dict(),
                        "files": [self._file(i, n, j, nt) for i in range(n)
                                  for j in range(nt)],
                        "specs": self._spec_blob()}
            tmp = os.path.join(d, _MANIFEST + ".tmp")
            with open(tmp, "w") as fh:
                json.dump(manifest, fh)
            os.replace(tmp, os.path.join(d, _MANIFEST))
            self._prune()
        self._barrier()

    def _prune(self):
        """Remove the oldest steps beyond ``max_to_keep``."""
        if self.max_to_keep is None:
            return
        for step in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(step)), ignore_errors=True)

    def wait(self) -> None:
        """Join an in-flight background save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint save failed") from err

    # -- restore -----------------------------------------------------------

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(os.path.join(self.directory, name, _MANIFEST)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Tuple[Any, Any, Optional[dict], int]:
        """(params, optimizer state_dict, window_state, step) of ``step`` (the
        latest by default): this rank's shard on the current mesh, whatever
        mesh wrote it, tensors on the host; the EMA parameters, if saved,
        through ``last_ema``."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        d = os.path.join(self.directory, str(step))
        with open(os.path.join(d, _MANIFEST)) as fh:
            manifest = json.load(fh)
        saved = manifest["mesh"]
        f, n, t, nt = self._shard()
        if (saved["fsdp"], saved["tp"]) == (n, nt):
            state = torch.load(os.path.join(d, self._file(f, n, t, nt)), map_location="cpu",
                               weights_only=True)
        elif "specs" not in manifest:  # written before manifests named the specs
            raise ValueError(f"checkpoint {d} was written on mesh {saved} without its specs: "
                             f"resume it on a mesh of fsdp {saved['fsdp']} and tp {saved['tp']}")
        else:
            state = self._restore_resharded(d, manifest)
        self._last_ema = state.get("ema_params")
        meta = state["meta"]
        return state["params"], state.get("opt_state"), meta.get("window_state"), meta["step"]

    def _restore_resharded(self, d: str, manifest: dict) -> dict:
        """This rank's state assembled from a checkpoint of another mesh, one
        leaf at a time (module docstring)."""
        from mixgrpo_tpu_torch.parallel.mesh import AXES
        from mixgrpo_tpu_torch.parallel.sharding import (
            Spec, cut_leaf, join_slices, leaf_paths,
        )

        n_f, n_t = manifest["mesh"]["fsdp"], manifest["mesh"]["tp"]
        files = {(i, j): torch.load(os.path.join(d, self._file(i, n_f, j, n_t)),
                                    map_location="cpu", weights_only=True, mmap=True)
                 for i in range(n_f) for j in range(n_t)}
        first = files[(0, 0)]
        saved = {p: Spec.from_json(b) for p, b in (manifest.get("specs") or {}).items()}
        paths = leaf_paths(first["params"])
        mine = {p: _lookup(self.specs, p) for p in paths} if self.specs is not None else {}
        index = {ax: (self.mesh.index(ax), self.mesh.size(ax)) if self.mesh is not None
                 else (0, 1) for ax in AXES}

        def assemble(path, piece):
            spec = saved.get(path, Spec())
            rows = []
            for i in range(n_f if "fsdp" in spec else 1):
                cols = [piece(files[(i, j)]) for j in range(n_t if "tp" in spec else 1)]
                rows.append(join_slices(cols, spec, "tp", spec.index("tp"))
                            if len(cols) > 1 else cols[0])
            full = torch.cat(rows, spec.index("fsdp")) if len(rows) > 1 else rows[0]
            return cut_leaf(full, mine.get(path, Spec()), index).clone()

        def tree(key):
            if first.get(key) is None:
                return None
            out = {}
            for p in paths:
                node = out
                *head, last = p.split("/")
                for k in head:
                    node = node.setdefault(k, {})
                node[last] = assemble(p, lambda st, p=p: _lookup(st[key], p))
            return out

        state = {"params": tree("params"), "ema_params": tree("ema_params"),
                 "meta": first["meta"], "opt_state": None}
        opt = first.get("opt_state")
        if opt is not None:
            moments = {}
            for i, st in opt["state"].items():
                moments[i] = {k: (assemble(paths[i], lambda s, i=i, k=k:
                                           s["opt_state"]["state"][i][k])
                                  if k.startswith("exp_avg") else v.clone())
                              for k, v in st.items()}
            state["opt_state"] = {"state": moments, "param_groups": opt["param_groups"]}
        return state

    def last_ema(self) -> Any:
        """EMA parameters from the most recent ``restore``, if saved."""
        return self._last_ema

    def close(self):
        self.wait()


def _lookup(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# diffusers interop export (inverse of models/flux/load.py)
# ---------------------------------------------------------------------------


def diffusers_state(params: Any, cfg) -> Dict[str, torch.Tensor]:
    """FLUX parameters as diffusers ``FluxTransformer2DModel`` names: views
    of ``params`` ((in, out) weights transposed to (out, in), fused
    projections split, block stacks indexed), on their device and in their
    dtype."""
    st: Dict[str, torch.Tensor] = {}

    def lin(name, p):
        st[f"{name}.weight"] = p["w"].detach().t()
        if "b" in p:
            st[f"{name}.bias"] = p["b"].detach()

    def lin_split(names, p, sizes):
        w = p["w"].detach().t()  # (out, in)
        off = 0
        for name, s in zip(names, sizes):
            st[f"{name}.weight"] = w[off:off + s]
            if "b" in p:
                st[f"{name}.bias"] = p["b"].detach()[off:off + s]
            off += s

    def embedder(name, p):
        lin(f"{name}.linear_1", p["in"])
        lin(f"{name}.linear_2", p["out"])

    lin("x_embedder", params["x_embedder"])
    lin("context_embedder", params["context_embedder"])
    embedder("time_text_embed.timestep_embedder", params["time_in"])
    embedder("time_text_embed.text_embedder", params["vector_in"])
    if "guidance_in" in params:
        embedder("time_text_embed.guidance_embedder", params["guidance_in"])
    lin("norm_out.linear", params["final_mod"]["lin"])
    lin("proj_out", params["proj_out"])

    def block(stack, i):
        return {k: block(v, i) if isinstance(v, dict) else v[i] for k, v in stack.items()}

    h, mh = cfg.hidden_size, cfg.mlp_hidden
    for i in range(cfg.depth_double):
        p = block(params["double"], i)
        b = f"transformer_blocks.{i}"
        lin(f"{b}.norm1.linear", p["img_mod"]["lin"])
        lin(f"{b}.norm1_context.linear", p["txt_mod"]["lin"])
        lin_split([f"{b}.attn.to_q", f"{b}.attn.to_k", f"{b}.attn.to_v"],
                  p["img_qkv"], [h, h, h])
        lin_split([f"{b}.attn.add_q_proj", f"{b}.attn.add_k_proj", f"{b}.attn.add_v_proj"],
                  p["txt_qkv"], [h, h, h])
        st[f"{b}.attn.norm_q.weight"] = p["img_qnorm"].detach()
        st[f"{b}.attn.norm_k.weight"] = p["img_knorm"].detach()
        st[f"{b}.attn.norm_added_q.weight"] = p["txt_qnorm"].detach()
        st[f"{b}.attn.norm_added_k.weight"] = p["txt_knorm"].detach()
        lin(f"{b}.attn.to_out.0", p["img_attn_out"])
        lin(f"{b}.attn.to_add_out", p["txt_attn_out"])
        lin(f"{b}.ff.net.0.proj", p["img_mlp_in"])
        lin(f"{b}.ff.net.2", p["img_mlp_out"])
        lin(f"{b}.ff_context.net.0.proj", p["txt_mlp_in"])
        lin(f"{b}.ff_context.net.2", p["txt_mlp_out"])

    for i in range(cfg.depth_single):
        p = block(params["single"], i)
        b = f"single_transformer_blocks.{i}"
        lin(f"{b}.norm.linear", p["mod"]["lin"])
        lin_split([f"{b}.attn.to_q", f"{b}.attn.to_k", f"{b}.attn.to_v", f"{b}.proj_mlp"],
                  p["linear1"], [h, h, h, mh])
        st[f"{b}.attn.norm_q.weight"] = p["qnorm"].detach()
        st[f"{b}.attn.norm_k.weight"] = p["knorm"].detach()
        lin(f"{b}.proj_out", p["linear2"])
    return st


def export_flux_safetensors(params: Any, cfg, path: str, mesh=None, specs=None) -> None:
    """Write FLUX params as diffusers ``FluxTransformer2DModel`` names, F32.
    On a ``mesh`` of more than one rank, rank 0 alone writes.  Where
    ``specs`` (the tree of ``parallel.sharding.flux_param_specs``) is given,
    ``params`` are this rank's shards: every rank takes part in gathering
    each leaf in turn, and rank 0 keeps it on the host; without ``specs`` the
    tree is whole on every rank."""
    if mesh is not None and mesh.world > 1:
        if specs is not None:
            from mixgrpo_tpu_torch.parallel.sharding import gather_leaf

            def full(tree, spec):
                if isinstance(tree, dict):
                    return {k: full(v, spec[k]) for k, v in tree.items()}
                t = gather_leaf(tree.detach(), mesh, spec)
                return t.cpu() if mesh.rank == 0 else None

            with torch.no_grad():
                params = full(params, specs)
        if mesh.rank != 0:
            return
    save_file(diffusers_state(params, cfg), path, dtype=torch.float32)
