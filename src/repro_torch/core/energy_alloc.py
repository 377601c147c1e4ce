"""Algorithm 1: dynamic task-level energy allocation, port of
``repro/core/energy_alloc.py``.

Every Q rounds the cloud recomputes
    h_t = ξ·h_t + (1−ξ)·(Ē_t / q_t)        (EMA difficulty, Eq. 5)
    μ_t = E_t / Ē_t                         (utilization, Eq. 6)
    w_t = h_t^ζ · μ_t                       (priority, Eq. 7)
and redistributes the reclaimed budget in proportion to w_t under a
per-task cap. float32 tensors in the reference's order (T is tiny): on
the CPU for the serial and batched engines; on the fused engine's device,
through :func:`step_scan`, whose round counter is a tensor.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.config import EnergyAllocConfig

F32 = torch.float32


class AllocState(NamedTuple):
    budgets: torch.Tensor       # (T,) Ē_t^m
    difficulty: torch.Tensor    # (T,) h_t
    round: int          # a () int tensor in step_scan's state


def init_alloc(cfg: EnergyAllocConfig, num_tasks: int) -> AllocState:
    eq = torch.full((num_tasks,), cfg.e_total / num_tasks, dtype=F32)
    return AllocState(budgets=eq, difficulty=torch.ones((num_tasks,),
                                                        dtype=F32),
                      round=0)


def _realloc(state: AllocState, cfg: EnergyAllocConfig, consumed, accuracy
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (budgets, difficulty, weights)."""
    consumed = torch.as_tensor(consumed, dtype=F32)
    accuracy = torch.as_tensor(accuracy, dtype=F32)
    budgets = state.budgets
    q_safe = torch.clamp(accuracy, min=1e-3)
    ratio = budgets / q_safe
    ratio = ratio / torch.clamp(torch.max(ratio), min=1e-12)  # h ∈ (0, 1]
    difficulty = cfg.xi * state.difficulty + (1 - cfg.xi) * ratio
    util = torch.clamp(consumed / torch.clamp(budgets, min=1e-12), 0.0, 1.0)
    w = torch.pow(torch.clamp(difficulty, min=1e-6), cfg.zeta) * util
    w = torch.clamp(w, min=1e-9)
    # reclaim over-provisioned budget (shrink each task toward what it
    # consumed), then hand the pool out in proportion to w_t under the cap
    floor = torch.minimum(budgets, torch.maximum(consumed, 0.05 * budgets))
    remaining = cfg.e_total - torch.sum(floor)
    delta = w * remaining / torch.sum(w)
    budgets = torch.clamp(floor + delta, max=cfg.task_cap_frac * cfg.e_total)
    total = torch.sum(budgets)
    budgets = torch.where(total > cfg.e_total,
                          budgets * cfg.e_total / total, budgets)
    return budgets, difficulty, w


def step(state: AllocState, cfg: EnergyAllocConfig, consumed, accuracy
         ) -> Tuple[AllocState, dict]:
    """One round of Algorithm 1. consumed: (T,) E_t^m spent this round;
    accuracy: (T,) q_t^m per task."""
    m = state.round + 1
    budgets = state.budgets
    difficulty = state.difficulty
    info = {"reallocated": False}
    if m % cfg.warmup_q == 0:
        budgets, difficulty, w = _realloc(state, cfg, consumed, accuracy)
        info = {"reallocated": True, "weights": w, "difficulty": difficulty}
    return AllocState(budgets=budgets, difficulty=difficulty, round=m), info


def step_scan(state: AllocState, cfg: EnergyAllocConfig, consumed, accuracy
              ) -> AllocState:
    """:func:`step` with a () int tensor round counter and no Python
    branch on it (the fused round program): the every-Q-rounds trigger
    is a ``torch.where``, so the reallocation is computed every round and
    kept on the rounds :func:`step` would take it. Equal to :func:`step`
    on both kinds of round."""
    m = state.round + 1
    do = torch.remainder(m, cfg.warmup_q) == 0
    budgets, difficulty, _ = _realloc(state, cfg, consumed, accuracy)
    return AllocState(budgets=torch.where(do, budgets, state.budgets),
                      difficulty=torch.where(do, difficulty,
                                             state.difficulty),
                      round=m)
