"""Printing and training metrics.

Port of mixgrpo_tpu/utils/logging.py: ``main_print`` and ``MetricLogger``
(a JSONL file of metrics per step, a rolling step-time average over the last
100 steps, and wandb when the package is present and a key is given).  As in
JAX, only process 0 prints and logs (the rank of the default process group,
0 without one).
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Dict, Optional


def process_index() -> int:
    """This process's rank (0 when ``torch.distributed`` is not started)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 when ``torch.distributed`` is not started)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def main_print(*args, **kwargs) -> None:
    if process_index() == 0:
        print(*args, **kwargs)


class MetricLogger:
    def __init__(self, output_dir: str, run_name: str = "run",
                 wandb_key: Optional[str] = None, wandb_project: str = "mixgrpo_tpu",
                 resume_id: Optional[str] = None):
        self._wandb = None
        self._step_times = collections.deque(maxlen=100)
        self._last_tick: Optional[float] = None
        self.enabled = process_index() == 0
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, f"{run_name}_metrics.jsonl")
        self._f = open(self.path, "a") if self.enabled else None
        if wandb_key and self.enabled:
            try:
                import wandb
            except ImportError:
                print("wandb disabled: the package is not installed")
            else:
                wandb.login(key=wandb_key)
                self._wandb = wandb.init(project=wandb_project, name=run_name, id=resume_id,
                                         resume="allow" if resume_id else None)

    def tick(self) -> Dict[str, float]:
        """Record a step boundary; returns step_time / avg_step_time."""
        now = time.time()
        out = {}
        if self._last_tick is not None:
            dt = now - self._last_tick
            self._step_times.append(dt)
            out = {"step_time": dt,
                   "avg_step_time": sum(self._step_times) / len(self._step_times)}
        self._last_tick = now
        return out

    def log(self, step: int, metrics: Dict) -> None:
        clean = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}
        clean["step"] = step
        if self._f is None:
            return
        self._f.write(json.dumps(clean) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(clean, step=step)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
