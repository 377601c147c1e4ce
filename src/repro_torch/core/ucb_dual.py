"""UCB-DUAL (paper Algorithm 2), port of ``repro/core/ucb_dual.py``.

Each vehicle v keeps per-arm statistics over the candidate rank set φ_η
and selects, at round m,

    η_v^m = argmax_η [ R̂_v(η) − λ^m·Ê_v(η) + ε·√(ln m / (N_v(η)+1)) ]

and the RSU updates the dual variable from the aggregated energy alone:

    λ^{m+1} = [ λ^m + ω·(Σ_v E_v^m − Ē_t^m) ]_+

float32 tensors with the reference's operations in its order, so the
arms match it exactly; ``torch.argmax`` takes the first maximal index, as
``jnp.argmax`` does (the unexplored arms' scores tie). The state is tiny
(V x K) and lives on the CPU whatever device trains.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.config import UCBDualConfig

F32 = torch.float32


class UCBDualState(NamedTuple):
    counts: torch.Tensor        # (V, K) N_v(η)
    reward_sum: torch.Tensor    # (V, K) running sums for R̂
    energy_sum: torch.Tensor    # (V, K) running sums for Ê
    lam: torch.Tensor           # () dual variable λ
    round: torch.Tensor         # () m


def init_state(num_vehicles: int, num_arms: int) -> UCBDualState:
    z = torch.zeros((num_vehicles, num_arms), dtype=F32)
    return UCBDualState(counts=z, reward_sum=z.clone(), energy_sum=z.clone(),
                        lam=torch.zeros((), dtype=F32),
                        round=torch.zeros((), dtype=F32))


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


def reward(cfg: UCBDualConfig, accuracy, latency) -> torch.Tensor:
    """R_v^m(η) = γ·q − α·τ/τ_ref (paper §IV-C; τ normalized)."""
    return cfg.gamma * _f32(accuracy) - cfg.alpha * _f32(latency) \
        / cfg.latency_ref


def select_ranks(state: UCBDualState, cfg: UCBDualConfig,
                 active) -> torch.Tensor:
    """Arm index per vehicle, -1 where ``active`` (V,) bool is False."""
    m = torch.clamp(state.round, min=1.0)
    n = state.counts
    r_hat = state.reward_sum / torch.clamp(n, min=1.0)
    e_hat = state.energy_sum / torch.clamp(n, min=1.0)
    bonus = cfg.epsilon * torch.sqrt(torch.log(m) / (n + 1.0))
    score = r_hat - state.lam * e_hat + bonus
    # unexplored arms first, by a large constant
    score = torch.where(n == 0, 1e9 + bonus, score)
    arms = torch.argmax(score, dim=-1)
    return torch.where(torch.as_tensor(active, dtype=torch.bool), arms,
                       torch.full_like(arms, -1))


def record(state: UCBDualState, arms, rewards, energies
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-vehicle half of :func:`update`: (counts, reward_sum,
    energy_sum) after recording each active vehicle's reward and energy
    on its arm. Each row reads only its own vehicle, so a fleet split
    into lane shards records shard by shard."""
    K = state.counts.shape[-1]
    arms = torch.as_tensor(arms, dtype=torch.int64)
    rewards, energies = _f32(rewards), _f32(energies)
    act = arms >= 0
    arms_c = torch.where(act, arms, torch.zeros_like(arms))
    onehot = (torch.nn.functional.one_hot(arms_c, K).to(F32)
              * act[:, None].to(F32))
    return (state.counts + onehot,
            state.reward_sum + onehot * rewards[:, None],
            state.energy_sum + onehot * energies[:, None])


def dual_step(cfg: UCBDualConfig, lam, total_energy, budget
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dual half of :func:`update`: (λ^{m+1}, the violation
    Σ_v E_v − Ē_t) from the fleet's total energy."""
    violation = total_energy - _f32(budget)
    return torch.clamp(lam + cfg.omega * violation, min=0.0), violation


def update(state: UCBDualState, cfg: UCBDualConfig, arms, rewards,
           energies, budget) -> Tuple[UCBDualState, Dict[str, torch.Tensor]]:
    """Record per-vehicle observations and take the dual subgradient step.

    arms: (V,) selected arm, -1 = inactive this round; rewards/energies:
    (V,) realized R_v^m / E_v^m (ignored where arm == -1); budget: the
    task's Ē_t^m."""
    arms = torch.as_tensor(arms, dtype=torch.int64)
    energies = _f32(energies)
    counts, reward_sum, energy_sum = record(state, arms, rewards, energies)
    total_e = torch.sum(torch.where(arms >= 0, energies,
                                    torch.zeros_like(energies)))
    lam, violation = dual_step(cfg, state.lam, total_e, budget)
    new = UCBDualState(counts=counts, reward_sum=reward_sum,
                       energy_sum=energy_sum, lam=lam,
                       round=state.round + 1.0)
    info = {"lambda": lam, "total_energy": total_e,
            "violation": torch.clamp(violation, min=0.0)}
    return new, info
