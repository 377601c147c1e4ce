"""Vehicle↔RSU channel: Shannon capacity with path loss + Rayleigh fading
(paper §III-C, [32] Tse & Viswanath). Port of ``repro/sim/channel.py``
(numpy, unchanged: the same fading stream per seed).

R = W·log2(1 + SINR);  SINR = P·G·d^{−α}·|h|² / (N₀·W + I),
|h|² ~ Exp(1) small-scale Rayleigh power.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ChannelConfig:
    bandwidth_hz: float = 10e6           # W
    noise_density: float = 4e-21         # N0 (W/Hz) ≈ −174 dBm/Hz
    pathloss_exp: float = 3.0            # α (urban)
    ref_gain: float = 1e-4               # G at 1 m (antenna + carrier)
    interference: float = 0.0            # constant interference power (W)
    # floor (bit/s): deep-fade links fall back to robust low-order MCS
    # rather than stalling the round (bounded-tail latency)
    min_rate: float = 1e6


class ChannelModel:
    def __init__(self, cfg: ChannelConfig, seed: int = 0):
        self.cfg = cfg
        self._rng = np.random.default_rng(seed)

    def rate(self, tx_power: float, distance_m: np.ndarray,
             shadow_gain: float = 1.0) -> np.ndarray:
        """Shannon rate in bit/s; distance: (...,) meters. Rayleigh fading
        redrawn per call (per round, per link); shadow_gain is a per-vehicle
        log-normal shadowing multiplier (persistent heterogeneity)."""
        c = self.cfg
        d = np.maximum(np.asarray(distance_m, np.float64), 1.0)
        h2 = self._rng.exponential(1.0, size=d.shape)
        sinr = (tx_power * c.ref_gain * d ** (-c.pathloss_exp) * h2
                * shadow_gain
                / (c.noise_density * c.bandwidth_hz + c.interference))
        r = c.bandwidth_hz * np.log2(1.0 + sinr)
        return np.maximum(r, c.min_rate)

    def round_rates(self, rsu_tx_power: float, dev_tx_powers: np.ndarray,
                    distances: np.ndarray, shadow: np.ndarray,
                    active_ids: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
        """Per-round link rates for one task, drawn in the CANONICAL order:
        for each active vehicle (ascending id) the downlink fade first, then
        the uplink. Every engine (serial, batched, fused staging) draws
        through here, so the Rayleigh stream is engine-independent — the
        cross-engine regression tests compare energy accounting to float
        tolerance, which requires identical fades.

        Returns ((V,) rate_down, (V,) rate_up); inactive lanes hold the
        config min_rate (they are masked downstream, but must stay finite
        for the fused engine's dense arithmetic).
        """
        V = len(distances)
        down = np.full(V, self.cfg.min_rate, np.float64)
        up = np.full(V, self.cfg.min_rate, np.float64)
        for v in active_ids:
            down[v] = float(self.rate(rsu_tx_power, distances[v], shadow[v]))
            up[v] = float(self.rate(dev_tx_powers[v], distances[v],
                                    shadow[v]))
        return down, up
