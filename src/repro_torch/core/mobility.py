"""§IV-E Mobility-aware fault-tolerant scheduling, port of
``repro/core/mobility.py`` (host floats, unchanged).

On *predicted* departure of vehicle v from RSU coverage before round
completion, evaluate the three fallback strategies and pick the cheapest:

  0 early upload: Cost₀ = γ·max(0, q* − q_v)
  1 migration:    Cost₁ = α·τ_mig + β·e_mig   (needs a nearby peer)
  2 abandonment:  Cost₂ = β·ê_spent + γ·q*
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.config import MobilityConfig, UCBDualConfig

EARLY_UPLOAD, MIGRATE, ABANDON = 0, 1, 2


@dataclass
class FallbackDecision:
    strategy: int
    cost: float
    costs: Tuple[float, float, float]


def decide_fallback(mob: MobilityConfig, ucb: UCBDualConfig, *,
                    local_accuracy: float, energy_spent: float,
                    migration_available: bool,
                    migration_latency: Optional[float] = None,
                    migration_energy: Optional[float] = None
                    ) -> FallbackDecision:
    q_star = mob.accuracy_threshold
    c0 = ucb.gamma * max(0.0, q_star - local_accuracy)
    tl = mob.migration_latency if migration_latency is None else migration_latency
    te = mob.migration_energy if migration_energy is None else migration_energy
    c1 = (ucb.alpha * tl + mob.beta * te) if migration_available else float("inf")
    c2 = mob.beta * energy_spent + ucb.gamma * q_star
    costs = (c0, c1, c2)
    strategy = min(range(3), key=lambda i: costs[i])
    return FallbackDecision(strategy=strategy, cost=costs[strategy],
                            costs=costs)
