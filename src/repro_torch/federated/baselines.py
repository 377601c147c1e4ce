"""Baseline method descriptors (paper §V-A), port of
``repro/federated/baselines.py``: the descriptors, HetLoRA's capability
ranks and the map from a method to its server rule.

- HomoLoRA [25]: fixed uniform rank + FedAvg on factors.
- HetLoRA [27]: capability-based heterogeneous ranks, zero-padding
  aggregation, self-pruning.
- FedRA [28]: random layer allocation per client per round.
- ours: UCB-DUAL adaptive ranks + truncated-SVD redistribution +
  energy-aware scheduling + mobility fault tolerance.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class MethodSpec:
    name: str
    adaptive_rank: bool          # UCB-DUAL on/off
    energy_scheduler: bool       # Algorithm 1 on/off
    mobility_aware: bool         # §IV-E on/off
    fixed_rank_fn: Optional[str] = None   # how non-adaptive ranks are set


METHODS = {
    "ours": MethodSpec("ours", adaptive_rank=True, energy_scheduler=True,
                       mobility_aware=True),
    "homolora": MethodSpec("homolora", adaptive_rank=False,
                           energy_scheduler=False, mobility_aware=False,
                           fixed_rank_fn="uniform"),
    "hetlora": MethodSpec("hetlora", adaptive_rank=False,
                          energy_scheduler=False, mobility_aware=False,
                          fixed_rank_fn="capability"),
    "fedra": MethodSpec("fedra", adaptive_rank=False,
                        energy_scheduler=False, mobility_aware=False,
                        fixed_rank_fn="uniform"),
    # ablations (Table III)
    "ours_no_energy": MethodSpec("ours_no_energy", adaptive_rank=True,
                                 energy_scheduler=False, mobility_aware=True),
    "ours_no_mobility": MethodSpec("ours_no_mobility", adaptive_rank=True,
                                   energy_scheduler=True,
                                   mobility_aware=False),
    # beyond-paper: residual (increment) aggregation — the paper's replace
    # rule collapses the global adapter to one round's client-rank span
    "ours_residual": MethodSpec("ours_residual", adaptive_rank=True,
                                energy_scheduler=True, mobility_aware=True),
}


def capability_ranks(candidates: Sequence[int], freqs: np.ndarray
                     ) -> np.ndarray:
    """HetLoRA: rank ∝ device capability (compute frequency quantiles)."""
    qs = np.argsort(np.argsort(freqs)) / max(len(freqs) - 1, 1)
    idx = np.clip((qs * len(candidates)).astype(int), 0,
                  len(candidates) - 1)
    return np.asarray(candidates)[idx]


def server_method(name: str) -> str:
    """Which RSUServer aggregation a method uses."""
    return {"ours": "ours", "ours_no_energy": "ours",
            "ours_no_mobility": "ours", "ours_residual": "ours",
            "homolora": "homolora", "hetlora": "hetlora",
            "fedra": "fedra"}[name]


def is_residual(name: str) -> bool:
    return name == "ours_residual"
