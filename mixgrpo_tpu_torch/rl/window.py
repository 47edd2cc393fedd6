"""MixGRPO sliding-window timestep scheduler.

Port of mixgrpo_tpu/rl/window.py, copied (pure Python): the host-side state
machine choosing which rollout timesteps are SDE steps (and PPO-trained)
this iteration, with the strategies ``progressive``, ``random``, ``decay``
and ``exp_decay``, ``roll_back``, and ``to_dict``/``from_dict`` for the
training checkpoint.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional


@dataclasses.dataclass
class SlidingWindowState:
    iters_per_group: int
    group_size: int
    max_timesteps: int
    cur_timestep: int = 0
    cur_iter_in_group: int = 0
    sample_strategy: str = "progressive"
    prog_overlap: bool = False
    prog_overlap_step: int = 1
    max_iters_per_group: Optional[int] = None
    min_iters_per_group: Optional[int] = None
    roll_back: bool = False
    exp_decay_thre_timestep: int = 13
    exp_decay_k: float = 0.1
    init_timestep: int = dataclasses.field(default=None)  # type: ignore[assignment]

    def __post_init__(self):
        if self.sample_strategy == "decay":
            if self.max_iters_per_group is None:
                self.max_iters_per_group = self.iters_per_group
            if self.min_iters_per_group is None:
                self.min_iters_per_group = max(1, self.iters_per_group // 4)
        if self.init_timestep is None:
            self.init_timestep = self.cur_timestep

    # -- iteration budgets ---------------------------------------------------

    def _decay_iters(self) -> int:
        progress = self.cur_timestep / self.max_timesteps
        cur = int(
            self.max_iters_per_group * (1 - progress) + self.min_iters_per_group * progress
        )
        return max(self.min_iters_per_group, cur)

    def _exp_decay_iters(self) -> int:
        relu = max(0, self.cur_timestep - self.exp_decay_thre_timestep)
        return int(math.ceil(self.iters_per_group * math.exp(-self.exp_decay_k * relu)))

    def current_iters_per_group(self) -> int:
        if self.sample_strategy == "decay":
            return self._decay_iters()
        if self.sample_strategy == "exp_decay":
            return self._exp_decay_iters()
        return self.iters_per_group

    # -- transitions ----------------------------------------------------------

    def update_iteration(self, rng=None) -> None:
        """Advance one training iteration (grpo_states.py:85-133)."""
        if self.sample_strategy == "random":
            import numpy as np

            gen = rng if rng is not None else np.random.default_rng()
            if isinstance(gen, (int,)):
                gen = np.random.default_rng(gen)
            self.cur_timestep = int(
                gen.integers(0, self.max_timesteps - self.group_size + 1)
            )
            return
        if self.sample_strategy not in ("progressive", "decay", "exp_decay"):
            raise ValueError(f"Invalid sample strategy: {self.sample_strategy}")

        self.cur_iter_in_group += 1
        if self.cur_iter_in_group >= self.current_iters_per_group():
            self.cur_iter_in_group = 0
            step = self.prog_overlap_step if self.prog_overlap else self.group_size
            self.cur_timestep += step
        if self.cur_timestep > self.max_timesteps:
            if self.roll_back:
                self.roll_back_start()
            else:
                self.cur_timestep = self.max_timesteps

    def roll_back_start(self) -> None:
        self.cur_timestep = self.init_timestep
        self.cur_iter_in_group = 0

    def get_current_timesteps(self) -> List[int]:
        """Window timestep indices ``[cur, min(cur+group, max))`` (:141-148)."""
        return list(
            range(
                self.cur_timestep,
                min(self.cur_timestep + self.group_size, self.max_timesteps),
            )
        )

    def is_training_complete(self) -> bool:
        if self.sample_strategy in ("progressive", "decay"):
            return self.cur_timestep >= self.max_timesteps
        return False

    # -- (de)serialization for checkpointing ----------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SlidingWindowState":
        return cls(**d)
