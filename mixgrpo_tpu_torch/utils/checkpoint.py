"""Training checkpoints on ``torch.save``.

Port of mixgrpo_tpu/utils/checkpoint.py's ``CheckpointManager`` (JAX writes
sharded Orbax checkpoints; the port runs on one device and writes one file
per step): ``<directory>/<step>/state.pt`` holds the parameters, the
optimizer state, the EMA parameters, the sliding-window state, extra
metadata and the step, so a resumed run continues the window walk.  Tensors
are copied to the host before the write; ``blocking=False`` lets the disk
write run in a background thread (joined by the next save, ``wait`` or
``close``).  A step appears only once its file is complete (written under a
temporary name, then renamed).

``export_flux_safetensors`` writes FLUX parameters under diffusers
``FluxTransformer2DModel`` names in F32, as JAX's does, so trained weights
load into diffusers and into ``models/flux/load.py::load_flux_params`` (it
is that loader's inverse).  It is two halves: ``diffusers_state`` (names ->
views of the parameters, transposed and split, on their device and in their
dtype) and ``utils.safetensors_io.save_file`` (which casts and copies one
tensor at a time to the host).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from mixgrpo_tpu_torch.utils.safetensors_io import save_file

_FILE = "state.pt"


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._last_ema = None

    def save(self, step: int, params: Any, opt_state: Any = None,
             window_state: Optional[dict] = None, extra: Optional[dict] = None,
             ema_params: Any = None, blocking: bool = True) -> None:
        """Save one step.  ``opt_state`` is a ``torch.optim`` optimizer or its
        ``state_dict``."""
        self.wait()
        if opt_state is not None and hasattr(opt_state, "state_dict"):
            opt_state = opt_state.state_dict()
        state = _to_host({
            "params": params, "opt_state": opt_state, "ema_params": ema_params,
            "meta": {"window_state": window_state, "extra": extra or {}, "step": step},
        })
        if blocking:
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
        tmp = os.path.join(d, _FILE + ".tmp")
        torch.save(state, tmp)
        os.replace(tmp, os.path.join(d, _FILE))

    def wait(self) -> None:
        """Join an in-flight background save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint save failed") from err

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(os.path.join(self.directory, name, _FILE)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Tuple[Any, Any, Optional[dict], int]:
        """(params, optimizer state_dict, window_state, step) of ``step`` (the
        latest by default), tensors on the host; the EMA parameters, if
        saved, through ``last_ema``."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        state = torch.load(os.path.join(self.directory, str(step), _FILE),
                           map_location="cpu", weights_only=True)
        self._last_ema = state.get("ema_params")
        meta = state["meta"]
        return state["params"], state.get("opt_state"), meta.get("window_state"), meta["step"]

    def last_ema(self) -> Any:
        """EMA parameters from the most recent ``restore``, if saved."""
        return self._last_ema

    def close(self):
        self.wait()


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


def export_flux_safetensors(params: Any, cfg, path: str) -> None:
    """Write FLUX params as diffusers ``FluxTransformer2DModel`` names, F32."""
    save_file(diffusers_state(params, cfg), path, dtype=torch.float32)
