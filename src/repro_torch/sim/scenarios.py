"""Named scenario presets for the IoV simulator (paper §V evaluation axis),
port of ``repro/sim/scenarios.py``.

Each preset is a declarative recipe — mobility regime (online Gauss-Markov
or a staged :class:`~repro_torch.config.TraceSpec`), RSU layout, coverage
geometry, fleet size/schedule, outage windows, energy budget — that builds
a ready-to-run :class:`~repro_torch.sim.simulator.SimConfig`. The paper
evaluates one urban map; the registry spans the mobility/topology regimes
that related work (arXiv 2503.06468) shows dominate vehicular-FL outcomes:

  urban-grid        dense city: hotspot-pulled traffic, gridded RSUs
  highway-corridor  fast near-1D flow along a corridor of RSUs; short
                    dwell times, constant handoffs
  rush-hour         DYNAMIC FLEET: staged arrivals ramp to a mid-run peak,
                    then the fleet drains (time-varying participation)
  sparse-rural      huge area, few vehicles, isolated RSUs; intermittent
                    coverage and long dead zones
  rsu-outage        mid-run coverage loss per RSU followed by handoff
                    storms when coverage returns
  dense-rsu         TWO-TIER HIERARCHY: 3 RSUs per task with per-round
                    nearest-in-range association and periodic global sync
  handoff-storm     fast corridor traffic across 4 RSUs per task: constant
                    re-association, adapter-migration penalties, stale
                    partials merged every few rounds

Adding a preset: write a builder returning a SimConfig and decorate it
with ``@register_scenario(name, description)``. All presets run under
every round engine the port runs; dynamic fleets reuse the fused engine's
rank-padded no-op lanes (an absent vehicle is a zero-weight lane).
A preset's ``rounds`` sets its trace length (and ``rsu-outage``'s
windows), both part of the config's fingerprint: a resumed run rebuilds
the preset with the same ``rounds`` and passes a longer horizon to
``run``/``run_scanned`` instead.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from repro_torch.config import (EnergyAllocConfig, LoRAConfig, OutageSpec,
                                ParticipationSpec, RSUTierSpec, TraceSpec)
from repro_torch.sim.mobility_model import MobilitySimConfig
from repro_torch.sim.simulator import SimConfig


@dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    builder: Callable[..., SimConfig]


SCENARIOS: Dict[str, Scenario] = {}


def register_scenario(name: str, description: str):
    def deco(fn: Callable[..., SimConfig]):
        SCENARIOS[name] = Scenario(name, description, fn)
        return fn
    return deco


def list_scenarios() -> List[str]:
    return sorted(SCENARIOS)


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {list_scenarios()}")
    return SCENARIOS[name]


def build_config(name: str, method: str = "ours",
                 rounds: Optional[int] = None, seed: int = 0,
                 **overrides: Any) -> SimConfig:
    """Build the preset's SimConfig. ``rounds``/``seed`` feed the trace
    horizon; any SimConfig field can be overridden (e.g. ``engine``,
    ``train_arch``, ``num_vehicles``)."""
    return get_scenario(name).builder(method=method, rounds=rounds,
                                      seed=seed, **overrides)


# IoVSimulator's keyword arguments, which build_sim passes through
_SIM_KWARGS = ("params", "server_draws", "draw_omega", "mask_draws",
               "fleet_devices")


def build_sim(name: str, method: str = "ours",
              rounds: Optional[int] = None, seed: int = 0,
              device="cuda", **overrides):
    """The preset's simulator on ``device`` (``cuda`` unless asked).
    ``params``, ``server_draws``, ``draw_omega``, ``mask_draws`` and
    ``fleet_devices`` go to
    :class:`~repro_torch.sim.simulator.IoVSimulator`; every other keyword
    overrides a SimConfig field."""
    from repro_torch.sim.simulator import IoVSimulator
    sim_kw = {k: overrides.pop(k) for k in _SIM_KWARGS if k in overrides}
    return IoVSimulator(build_config(name, method=method, rounds=rounds,
                                     seed=seed, **overrides),
                        device=device, **sim_kw)


# ---------------------------------------------------------------------------
# Shared plumbing
# ---------------------------------------------------------------------------

_LORA = LoRAConfig(rank=8, max_rank=32, candidate_ranks=(2, 4, 8, 16, 32))


def _cfg(scenario: str, method: str, rounds: int, seed: int,
         nv: int, nt: int, mobility_sim: MobilitySimConfig,
         **overrides: Any) -> SimConfig:
    nv = overrides.get("num_vehicles", nv)
    nt = overrides.get("num_tasks", nt)
    base: Dict[str, Any] = dict(
        method=method, rounds=rounds, seed=seed, scenario=scenario,
        num_vehicles=nv, num_tasks=nt, local_steps=2,
        lora=_LORA,
        # budget scaled with the fleet so the UCB dual stays healthy and
        # rank selection remains heterogeneous across every regime (see
        # benchmarks/fused_round.py on budget starvation)
        energy=EnergyAllocConfig(e_total=110.0 * nv * nt, warmup_q=4),
        mobility_sim=mobility_sim)
    # num_vehicles / seed overrides need no mobility_sim surgery: the
    # simulator re-stamps both onto its own mobility_sim copy, and the
    # trace is materialized for whatever fleet size that copy carries
    base.update(overrides)
    if "participation" in base:
        # string sugar: participation="semi-sync" builds the default
        # ParticipationSpec for that mode (full specs pass through)
        base["participation"] = ParticipationSpec.of(base["participation"])
    return SimConfig(**base)


def _horizon(rounds: Optional[int], default: int) -> int:
    return default if rounds is None else rounds


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

@register_scenario(
    "urban-grid",
    "dense city blocks: hotspot-pulled traffic over gridded RSUs, "
    "near-full coverage (the paper's §V urban regime)")
def urban_grid(method: str = "ours", rounds: Optional[int] = None,
               seed: int = 0, **overrides: Any) -> SimConfig:
    R = _horizon(rounds, 24)
    ms = MobilitySimConfig(
        area=3000.0, coverage_radius=1200.0, dt=10.0, seed=seed,
        rsu_layout="grid",
        trace=TraceSpec(kind="synthetic", length=R + 1, mean_speed=9.0,
                        speed_std=3.0, gm_alpha=0.85, hotspot_pull=0.4,
                        seed=seed))
    return _cfg("urban-grid", method, R, seed, 16, 3, ms, **overrides)


@register_scenario(
    "highway-corridor",
    "fast near-1D flow along a corridor of RSUs: short dwell times, "
    "constant handoffs, departure-heavy rounds")
def highway_corridor(method: str = "ours", rounds: Optional[int] = None,
                     seed: int = 0, **overrides: Any) -> SimConfig:
    R = _horizon(rounds, 24)
    ms = MobilitySimConfig(
        area=6000.0, coverage_radius=1400.0, dt=12.0, seed=seed,
        rsu_layout="corridor",
        trace=TraceSpec(kind="synthetic", length=R + 1, mean_speed=27.0,
                        speed_std=6.0, gm_alpha=0.92, hotspot_pull=0.1,
                        corridor_frac=0.12, seed=seed))
    return _cfg("highway-corridor", method, R, seed, 16, 2, ms, **overrides)


@register_scenario(
    "rush-hour",
    "dynamic fleet: staged arrivals ramp participation to a mid-run peak, "
    "then the fleet drains — time-varying vehicle sets every round")
def rush_hour(method: str = "ours", rounds: Optional[int] = None,
              seed: int = 0, **overrides: Any) -> SimConfig:
    R = _horizon(rounds, 24)
    ms = MobilitySimConfig(
        area=2600.0, coverage_radius=1150.0, dt=10.0, seed=seed,
        rsu_layout="grid",
        trace=TraceSpec(kind="synthetic", length=R + 1, mean_speed=8.0,
                        speed_std=3.5, gm_alpha=0.8, hotspot_pull=0.45,
                        arrivals="waves", min_dwell=5, seed=seed))
    return _cfg("rush-hour", method, R, seed, 20, 3, ms, **overrides)


@register_scenario(
    "sparse-rural",
    "huge area, few vehicles, isolated RSUs: intermittent coverage, long "
    "dead zones, every upload counts")
def sparse_rural(method: str = "ours", rounds: Optional[int] = None,
                 seed: int = 0, **overrides: Any) -> SimConfig:
    R = _horizon(rounds, 24)
    ms = MobilitySimConfig(
        area=9000.0, coverage_radius=1500.0, dt=15.0, seed=seed,
        rsu_layout="sparse",
        trace=TraceSpec(kind="synthetic", length=R + 1, mean_speed=18.0,
                        speed_std=5.0, gm_alpha=0.9, hotspot_pull=0.3,
                        arrivals="staggered", min_dwell=8, seed=seed))
    return _cfg("sparse-rural", method, R, seed, 10, 2, ms, **overrides)


@register_scenario(
    "rsu-outage",
    "mid-run RSU coverage loss and recovery: each task's RSU goes dark for "
    "a window, then a handoff storm floods it on recovery")
def rsu_outage(method: str = "ours", rounds: Optional[int] = None,
               seed: int = 0, **overrides: Any) -> SimConfig:
    R = _horizon(rounds, 24)
    third = max(R // 3, 2)
    ms = MobilitySimConfig(
        area=2800.0, coverage_radius=1300.0, dt=10.0, seed=seed,
        rsu_layout="grid",
        outages=(OutageSpec(rsu_id=0, start=third, end=2 * third),
                 OutageSpec(rsu_id=1, start=third + 2, end=2 * third + 2)),
        trace=TraceSpec(kind="synthetic", length=R + 1, mean_speed=10.0,
                        speed_std=3.0, gm_alpha=0.85, hotspot_pull=0.4,
                        seed=seed))
    return _cfg("rsu-outage", method, R, seed, 16, 2, ms, **overrides)


@register_scenario(
    "dense-rsu",
    "two-tier hierarchy over a dense city: 3 RSUs per task, nearest-"
    "in-range association each round, per-RSU partial aggregation and a "
    "staleness-weighted global sync every 2 rounds")
def dense_rsu(method: str = "ours", rounds: Optional[int] = None,
              seed: int = 0, **overrides: Any) -> SimConfig:
    R = _horizon(rounds, 24)
    ms = MobilitySimConfig(
        # per-RSU cells are deliberately smaller than the map so the
        # nearest-in-range winner changes as vehicles cross the city
        area=3200.0, coverage_radius=900.0, dt=10.0, seed=seed,
        rsu_layout="grid",
        trace=TraceSpec(kind="synthetic", length=R + 1, mean_speed=11.0,
                        speed_std=3.5, gm_alpha=0.85, hotspot_pull=0.4,
                        seed=seed))
    overrides.setdefault("rsu_tier", RSUTierSpec(
        num_rsus_per_task=3, sync_period=2, staleness_decay=0.7,
        handoff_energy=6.0, handoff_latency=0.4))
    return _cfg("dense-rsu", method, R, seed, 18, 3, ms, **overrides)


@register_scenario(
    "handoff-storm",
    "fast corridor traffic across 4 RSUs per task: constant re-"
    "association (every handoff charges an adapter-migration penalty), "
    "partials go stale between syncs every 3 rounds")
def handoff_storm(method: str = "ours", rounds: Optional[int] = None,
                  seed: int = 0, **overrides: Any) -> SimConfig:
    R = _horizon(rounds, 24)
    ms = MobilitySimConfig(
        area=6400.0, coverage_radius=1000.0, dt=12.0, seed=seed,
        rsu_layout="corridor",
        trace=TraceSpec(kind="synthetic", length=R + 1, mean_speed=30.0,
                        speed_std=6.0, gm_alpha=0.93, hotspot_pull=0.1,
                        corridor_frac=0.1, seed=seed))
    overrides.setdefault("rsu_tier", RSUTierSpec(
        num_rsus_per_task=4, sync_period=3, staleness_decay=0.6,
        handoff_energy=12.0, handoff_latency=0.8))
    return _cfg("handoff-storm", method, R, seed, 16, 2, ms, **overrides)
