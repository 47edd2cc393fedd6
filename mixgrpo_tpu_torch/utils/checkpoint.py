"""Training checkpoints on ``torch.save``.

Port of mixgrpo_tpu/utils/checkpoint.py's ``CheckpointManager`` (JAX writes
sharded Orbax checkpoints; the port runs on one device and writes one file
per step): ``<directory>/<step>/state.pt`` holds the parameters, the
optimizer state, the EMA parameters, the sliding-window state, extra
metadata and the step, so a resumed run continues the window walk.  Tensors
are copied to the host before the write; ``blocking=False`` lets the disk
write run in a background thread (joined by the next save, ``wait`` or
``close``).  A step appears only once its file is complete (written under a
temporary name, then renamed).  The diffusers safetensors export
(``export_flux_safetensors``) waits for a later slice.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Optional, Tuple

import torch

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
