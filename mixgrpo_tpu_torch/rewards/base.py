"""Reward model protocol + multi-reward aggregation.

Port of mixgrpo_tpu/rewards/base.py.  ``compute_reward`` runs every model in
``reward_models`` and returns ``(rewards, successes, rewards_dict,
successes_dict)`` keyed by model name, with rewards mixed by ``weights`` (the
``reward_aggr`` case; the ``advantage_aggr`` consumer mixes per-model
advantages downstream).

The models on the card take the decoded batch as the CUDA tensor it already
is (JAX copies it to the host and back); only UnifiedReward, an HTTP client,
brings images to the host.

An item a model could not score (UnifiedReward returns the score ``None``)
gets the score 0.0 and the success 0: the masks multiply, so a NaN would
spread, and the success-0 sample leaves its group's statistics
(``rl/advantage.py``).  JAX's ``float(None)`` raises ``TypeError`` there and
stops training at the first failed request.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Protocol, Sequence, Tuple

import numpy as np


class RewardModel(Protocol):
    name: str

    def __call__(
        self, images, prompts: Sequence[str]
    ) -> Tuple[List[float], List[float]]:
        """Score a batch.  Returns (scores, successes) as python lists."""
        ...


def compute_reward(
    images,
    prompts: Sequence[str],
    reward_models: Mapping[str, RewardModel],
    weights: Mapping[str, float],
) -> Tuple[List[float], List[float], Dict[str, List[float]], Dict[str, List[float]]]:
    n = len(prompts)
    rewards_dict: Dict[str, List[float]] = {}
    successes_dict: Dict[str, List[float]] = {}
    for name, model in reward_models.items():
        scores, successes = model(images, prompts)
        assert len(scores) == n, (name, len(scores), n)
        rewards_dict[name] = [0.0 if s is None else float(s) for s in scores]
        successes_dict[name] = [0.0 if s is None else float(ok)
                                for s, ok in zip(scores, successes)]

    total = np.zeros(n, np.float64)
    ok = np.ones(n, np.float64)
    for name, scores in rewards_dict.items():
        w = float(weights.get(name, 1.0))
        total += np.asarray(scores) * w
        ok *= np.asarray(successes_dict[name])
    return total.tolist(), ok.tolist(), rewards_dict, successes_dict
