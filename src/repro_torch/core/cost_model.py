"""§III-C four-stage latency/energy model for one federated round.

Stages: (1) model distribution (downlink of truncated SVD factors),
(2) local fine-tuning, (3) parameter upload, (4) RSU aggregation.

All formulas are the paper's, with the rank-dependent payload
Ω(η) = Σ_targets η·(d_in + d_out) and complexity factor
g(η) = 1 + (LoRA fwd+bwd FLOPs at rank η) / (frozen-base FLOPs) derived
from the actual model dimensions (instead of an opaque fitted g).

Port of ``repro/core/cost_model.py``: host floats, unchanged, with the
model dimensions read from the port's own transformer, and the fleet
twin ``vehicle_round_costs_vec`` in f32 tensors for the fused engine.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import LoRAConfig, ModelConfig


@dataclass(frozen=True)
class DeviceProfile:
    """Per-vehicle compute/energy parameters (paper's C_v, f_v, κ_v, p_v)."""
    flops_per_sample: float      # C_v (FLOPs per sample at rank 0, fwd+bwd)
    freq: float                  # f_v — effective FLOP/s
    kappa: float                 # κ_v — energy coefficient (E = κ f³ τ)
    tx_power: float              # p_v (W)


@dataclass(frozen=True)
class RSUProfile:
    agg_flops_per_vehicle: float  # C_agg
    freq: float                   # f_k
    kappa: float                  # κ_k
    tx_power: float               # p_{v,k} (downlink)


# ---------------------------------------------------------------------------
# Rank-dependent payload and complexity
# ---------------------------------------------------------------------------

def adapter_payload_params(target_dims: Sequence[Tuple[int, int]],
                           rank: int) -> int:
    """Ω(η) = Σ η(d_in+d_out) over LoRA-targeted linears (#parameters)."""
    return sum(rank * (di + do) for di, do in target_dims)


def target_dims_of(cfg: ModelConfig, lora: LoRAConfig
                   ) -> List[Tuple[int, int]]:
    """Per-layer LoRA target (d_in, d_out) pairs × their layer counts."""
    from repro_torch.models.transformer import _lora_targets, segments_of
    dims: List[Tuple[int, int]] = []
    for kind, n in segments_of(cfg):
        for (_path, din, dout) in _lora_targets(kind, cfg, lora):
            if isinstance(din, tuple):        # per-expert adapters
                E, di = din
                _, do = dout
                dims += [(di, do)] * (E * n)
            else:
                dims += [(din, dout)] * n
    return dims


def g_factor(cfg: ModelConfig, lora: LoRAConfig, rank: int) -> float:
    """g(η): relative per-sample training cost vs a frozen-base pass.

    fwd+bwd on frozen base ≈ 4·N_active FLOPs/token (no weight grads);
    each adapter adds ≈ 6·η·(d_in+d_out) FLOPs/token (fwd + full bwd).
    """
    base = 4.0 * cfg.param_counts()["active"]
    extra = 6.0 * adapter_payload_params(
        [(di, do) for di, do in target_dims_of(cfg, lora)], rank)
    return 1.0 + extra / max(base, 1.0)


# ---------------------------------------------------------------------------
# Four stages (paper Eqs. in §III-C)
# ---------------------------------------------------------------------------

@dataclass
class RoundCosts:
    tau_down: float
    tau_comp: float
    tau_up: float
    e_down: float
    e_comp: float
    e_up: float

    @property
    def latency(self) -> float:
        return self.tau_down + self.tau_comp + self.tau_up

    @property
    def energy(self) -> float:
        return self.e_down + self.e_comp + self.e_up


def vehicle_round_costs(dev: DeviceProfile, rsu: RSUProfile, *,
                        rank: int, payload_params: int, bytes_per_param: int,
                        rate_down: float, rate_up: float,
                        num_samples: int, g: float) -> RoundCosts:
    """Stages 1–3 for one vehicle (stage 4 is per-RSU, below).

    rate_down/rate_up: Shannon rates in bit/s from sim.channel.
    """
    bits = payload_params * bytes_per_param * 8
    tau_down = bits / max(rate_down, 1e-9)
    e_down = rsu.tx_power * tau_down
    tau_comp = dev.flops_per_sample * num_samples * g / dev.freq
    e_comp = dev.kappa * dev.freq ** 3 * tau_comp
    tau_up = bits / max(rate_up, 1e-9)
    e_up = dev.tx_power * tau_up
    return RoundCosts(tau_down=tau_down, tau_comp=tau_comp, tau_up=tau_up,
                      e_down=e_down, e_comp=e_comp, e_up=e_up)


def vehicle_round_costs_vec(*, freq, comp_power, tx_power, flops_per_sample,
                            rsu_tx_power, payload_params, bytes_per_param,
                            rate_down, rate_up, num_samples, g
                            ) -> Dict[str, torch.Tensor]:
    """f32 tensor twin of :func:`vehicle_round_costs` over a fleet axis.

    Every argument broadcasts to the (V,) fleet shape (Python scalars
    too). comp_power is κ·f³ (W), folded by the caller on the host in
    float64: the cube of a >1e12 FLOP/s frequency overflows float32.
    Returns a dict of (V,) tensors with :class:`RoundCosts`' stage split
    plus ``latency`` and ``energy``; no host reads, so the fused round
    can capture it."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32)
    bits = f32(payload_params) * float(bytes_per_param) * 8.0
    rd = torch.clamp(f32(rate_down), min=1e-9)
    ru = torch.clamp(f32(rate_up), min=1e-9)
    tau_down = bits / rd
    e_down = rsu_tx_power * tau_down
    tau_comp = (f32(flops_per_sample) * f32(num_samples) * f32(g)
                / f32(freq))
    e_comp = f32(comp_power) * tau_comp
    tau_up = bits / ru
    e_up = f32(tx_power) * tau_up
    return {"tau_down": tau_down, "tau_comp": tau_comp, "tau_up": tau_up,
            "e_down": e_down, "e_comp": e_comp, "e_up": e_up,
            "latency": tau_down + tau_comp + tau_up,
            "energy": e_down + e_comp + e_up}


def handoff_costs(handoff_latency: float, handoff_energy: float, handoffs):
    """Adapter-migration penalty for RSU handoffs (two-tier hierarchy).

    When a vehicle's nearest-in-range association changes between two valid
    RSUs, the old RSU forwards the vehicle's adapter/optimizer context to
    the new one — an extra control-plane exchange charged like the §IV-E
    migration fallback. ``handoffs`` is a (V,) bool mask (numpy);
    returns ``(extra_latency, extra_energy)`` per vehicle, zeros where no
    handoff fired. With zero penalties (the default RSUTierSpec) this is an
    exact no-op, which the trivial-tier regression pin relies on.
    """
    lat = handoffs * handoff_latency
    e = handoffs * handoff_energy
    return lat, e


def rsu_agg_costs(rsu: RSUProfile, num_vehicles: int) -> Tuple[float, float]:
    tau = rsu.agg_flops_per_vehicle * num_vehicles / rsu.freq
    e = rsu.kappa * rsu.freq ** 3 * tau
    return tau, e


def task_round_summary(per_vehicle: Sequence[RoundCosts],
                       agg: Tuple[float, float]) -> Dict[str, float]:
    """Eq. (1)–(2): wall-clock τ_t (max per stage) and total energy E_t."""
    if not per_vehicle:
        return {"latency": 0.0, "energy": agg[1], "comp_latency": 0.0}
    tau_agg, e_agg = agg
    lat = (max(c.tau_down for c in per_vehicle)
           + max(c.tau_comp for c in per_vehicle)
           + max(c.tau_up for c in per_vehicle) + tau_agg)
    energy = sum(c.energy for c in per_vehicle) + e_agg
    return {"latency": lat, "energy": energy,
            "comp_latency": max(c.tau_comp for c in per_vehicle)}


# ---------------------------------------------------------------------------
# Default heterogeneous fleet profiles (used by the simulator)
# ---------------------------------------------------------------------------

def default_device_profiles(rng: np.random.Generator, n: int,
                            base_flops_per_sample: float
                            ) -> List[DeviceProfile]:
    """Heterogeneous vehicles: ~3× spread in compute, 2× in energy coeff."""
    profs = []
    for _ in range(n):
        freq = float(rng.uniform(0.5, 1.5) * 2e12)        # 1–3 TFLOP/s
        kappa = float(rng.uniform(0.5, 1.0) * 1e-37)      # E=κf³τ ⇒ ~10–30 W
        tx = float(rng.uniform(0.2, 0.5))                  # W
        profs.append(DeviceProfile(
            flops_per_sample=base_flops_per_sample, freq=freq, kappa=kappa,
            tx_power=tx))
    return profs


def default_rsu_profile() -> RSUProfile:
    return RSUProfile(agg_flops_per_vehicle=5e9, freq=1e13, kappa=1e-38,
                      tx_power=1.0)
