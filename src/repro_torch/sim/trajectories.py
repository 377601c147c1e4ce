"""Trajectory staging for the IoV simulator (paper §V-A), port of
``repro/sim/trajectories.py``.

Produces :class:`TraceSet` objects — pre-staged per-round position and
presence arrays — that :class:`repro_torch.sim.mobility_model.MobilityModel`
replays instead of stepping Gauss-Markov dynamics online. Two sources:

``load_tdrive``
    Ingests the T-Drive taxi-trace format (one fix per line:
    ``taxi_id,YYYY-MM-DD HH:MM:SS,longitude,latitude``), projects WGS-84
    fixes to local meters, rescales the cloud into the simulation area and
    resamples every trajectory onto the round clock (one position per
    ``dt`` seconds). Gaps longer than ``max_gap_s`` mark the vehicle ABSENT
    for those ticks (positions keep interpolating through the gap, but the
    presence mask bars participation).

``synthesize``
    Statistically matched synthetic traces: a Gauss-Markov rollout with the
    online mobility model's speed distribution, memory and hotspot
    attraction, plus a ``corridor_frac`` anisotropy knob (highway regime)
    and declarative arrival/departure schedules (``"staggered"``,
    ``"waves"``) that stage time-varying fleets.

Both are deterministic functions of a frozen
:class:`repro_torch.config.TraceSpec` (plus area geometry). numpy only,
the reference's calls in the reference's order, so one spec gives the
reference's arrays bit for bit. ``build_trace`` dispatches on
``TraceSpec.kind``.

Replay semantics (consumed by ``MobilityModel``): tick ``i`` of the trace
is the fleet state after the ``i``-th ``step()`` call; tick 0 is the
initial placement. Replay wraps modulo the trace length, so a simulation
may run longer than the staged horizon.
"""
from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config import TraceSpec
# mobility_model imports this module only lazily (inside MobilityModel),
# so depending on its reflection helper at module level cannot cycle
from repro_torch.sim.mobility_model import reflect_into

EARTH_RADIUS_M = 6.371e6


@dataclass
class TraceSet:
    """Pre-staged fleet trajectory.

    positions: (L, V, 2) float64 — per-tick xy in meters, inside [0, area].
    presence:  (L, V) bool — False while a vehicle has not yet arrived,
               has departed, or its source trace has a gap. Presence gates
               the ``active`` mask downstream: an absent vehicle can never
               participate in a round (it becomes a zero-weight lane in the
               fused engine's rank-padded fleet arrays).
    dt:        seconds between consecutive ticks (the round clock).
    """
    positions: np.ndarray
    presence: np.ndarray
    dt: float

    def __post_init__(self):
        self.positions = np.asarray(self.positions, np.float64)
        self.presence = np.asarray(self.presence, bool)
        assert self.positions.ndim == 3 and self.positions.shape[-1] == 2
        assert self.presence.shape == self.positions.shape[:2]

    @property
    def length(self) -> int:
        return self.positions.shape[0]

    @property
    def num_vehicles(self) -> int:
        return self.positions.shape[1]

    def at(self, tick: int) -> Tuple[np.ndarray, np.ndarray]:
        """(positions, presence) at ``tick``, wrapping modulo the length."""
        i = tick % self.length
        return self.positions[i], self.presence[i]

    def velocity_at(self, tick: int) -> np.ndarray:
        """Finite-difference velocity (m/s) used for departure prediction.
        A vehicle absent at either endpoint of the difference reports zero
        velocity (it must not be predicted to depart on arrival)."""
        i = tick % self.length
        # at the wrap boundary (i == 0) a backward difference would span the
        # end→start teleport; use the forward difference instead
        j, k = (i, i - 1) if i > 0 else (1, 0)
        vel = (self.positions[j] - self.positions[k]) / max(self.dt, 1e-9)
        both = self.presence[j] & self.presence[k]
        return np.where(both[:, None], vel, 0.0)


# ---------------------------------------------------------------------------
# T-Drive ingestion
# ---------------------------------------------------------------------------

def parse_tdrive(lines: Iterable[str]) -> dict:
    """Parse T-Drive format lines into {taxi_id: [(unix_s, lon, lat), ...]}.

    Tolerates blank/malformed lines (skipped) and unsorted fixes (sorted per
    taxi). The format is the published T-Drive sample release layout."""
    fixes: dict = {}
    for line in lines:
        line = line.strip()
        if not line:
            continue
        parts = line.split(",")
        if len(parts) != 4:
            continue
        try:
            ts = _dt.datetime.strptime(parts[1].strip(),
                                       "%Y-%m-%d %H:%M:%S")
            lon, lat = float(parts[2]), float(parts[3])
        except ValueError:
            continue
        key = parts[0].strip()
        fixes.setdefault(key, []).append(
            (ts.replace(tzinfo=_dt.timezone.utc).timestamp(), lon, lat))
    for key in fixes:
        fixes[key].sort()
    return fixes


def _project_fit(fixes_by_id: dict, area: float) -> dict:
    """Equirectangular-project all fixes around the corpus centroid and
    rescale isotropically so the point cloud fits [0, area]²."""
    all_lon = np.concatenate([[f[1] for f in v] for v in fixes_by_id.values()])
    all_lat = np.concatenate([[f[2] for f in v] for v in fixes_by_id.values()])
    lon0, lat0 = float(np.mean(all_lon)), float(np.mean(all_lat))
    cos0 = np.cos(np.deg2rad(lat0))

    def to_m(lon, lat):
        x = EARTH_RADIUS_M * cos0 * np.deg2rad(np.asarray(lon) - lon0)
        y = EARTH_RADIUS_M * np.deg2rad(np.asarray(lat) - lat0)
        return x, y

    xs, ys = to_m(all_lon, all_lat)
    span = max(float(xs.max() - xs.min()), float(ys.max() - ys.min()), 1e-9)
    scale = area / span
    x_min, y_min = float(xs.min()), float(ys.min())
    out = {}
    for key, v in fixes_by_id.items():
        t = np.asarray([f[0] for f in v])
        x, y = to_m([f[1] for f in v], [f[2] for f in v])
        xy = np.stack([(x - x_min) * scale, (y - y_min) * scale], axis=-1)
        out[key] = (t, np.clip(xy, 0.0, area))
    return out


def load_tdrive(path_or_lines, area: float, dt: float,
                num_vehicles: Optional[int] = None,
                length: Optional[int] = None,
                max_gap_s: float = 600.0) -> TraceSet:
    """Build a :class:`TraceSet` from a T-Drive format file (or an iterable
    of lines, for tests).

    Vehicles are the ``num_vehicles`` taxis with the most fixes (all taxis
    if None). The shared clock starts at the corpus' earliest fix and ticks
    every ``dt`` seconds for ``length`` ticks (default: until the corpus
    ends). At each tick a vehicle is PRESENT iff it has fixes within
    ``max_gap_s`` on both sides of the tick; positions are linearly
    interpolated (through gaps too — absence is a participation mask, not
    a position override).
    """
    if isinstance(path_or_lines, (str,)):
        with open(path_or_lines) as f:
            fixes = parse_tdrive(f)
    else:
        fixes = parse_tdrive(path_or_lines)
    if not fixes:
        raise ValueError("no parseable T-Drive fixes")
    ids = sorted(fixes, key=lambda k: (-len(fixes[k]), k))
    if num_vehicles is not None:
        ids = ids[:num_vehicles]
    proj = _project_fit({k: fixes[k] for k in ids}, area)
    t0 = min(float(proj[k][0][0]) for k in ids)
    t1 = max(float(proj[k][0][-1]) for k in ids)
    L = length if length is not None else max(int((t1 - t0) // dt) + 1, 2)
    V = len(ids)
    pos = np.zeros((L, V, 2))
    pres = np.zeros((L, V), bool)
    ticks = t0 + dt * np.arange(L)
    for v, key in enumerate(ids):
        t, xy = proj[key]
        for axis in range(2):
            pos[:, v, axis] = np.interp(ticks, t, xy[:, axis])
        idx = np.searchsorted(t, ticks, side="right")
        prev_t = t[np.clip(idx - 1, 0, len(t) - 1)]
        next_t = t[np.clip(idx, 0, len(t) - 1)]
        pres[:, v] = ((ticks >= t[0]) & (ticks <= t[-1])
                      & (ticks - prev_t <= max_gap_s)
                      & (next_t - ticks <= max_gap_s))
    return TraceSet(pos, pres, dt)


# ---------------------------------------------------------------------------
# Synthetic (statistically matched) traces
# ---------------------------------------------------------------------------

def _presence_schedule(spec: TraceSpec, L: int, V: int,
                       rng: np.random.Generator) -> np.ndarray:
    """(L, V) presence mask from the spec's declarative arrival mode."""
    pres = np.ones((L, V), bool)
    if spec.arrivals == "all":
        return pres
    dwell_min = max(1, int(spec.min_dwell))
    if spec.arrivals == "staggered":
        # arrivals spread over the first 60% of the trace, single window
        arrive = rng.integers(0, max(int(0.6 * L), 1), V)
        dwell = rng.integers(dwell_min, max(L // 2, dwell_min + 1), V)
    elif spec.arrivals == "waves":
        # rush hour: arrivals concentrate toward the mid-trace peak and the
        # fleet drains afterwards — participation ramps up, peaks, falls
        arrive = (np.sort(rng.beta(2.0, 3.5, V)) * 0.55 * L).astype(int)
        dwell = rng.integers(dwell_min, max(int(0.55 * L), dwell_min + 1), V)
    else:
        raise ValueError(f"unknown arrivals mode {spec.arrivals!r}; "
                         "have ('all', 'staggered', 'waves')")
    # pull the earliest arrival to tick 0 so the first round is never
    # guaranteed-empty by construction (windows stay contiguous)
    arrive[int(np.argmin(arrive))] = 0
    depart = np.minimum(arrive + np.maximum(dwell, dwell_min), L)
    ticks = np.arange(L)[:, None]
    return (ticks >= arrive[None]) & (ticks < depart[None])


def synthesize(spec: TraceSpec, area: float, num_vehicles: int, dt: float,
               rsu_centers: Optional[Sequence[Tuple[float, float]]] = None
               ) -> TraceSet:
    """Offline Gauss-Markov rollout matched to the spec's statistics.

    Mirrors the online mobility model's dynamics (velocity memory
    ``gm_alpha``, hotspot attraction, boundary reflection) so replayed and
    online-stepped scenarios live in the same mobility regime, then adds
    what the online model cannot express: corridor anisotropy and staged
    arrival/departure windows.
    """
    rng = np.random.default_rng(spec.seed)
    L, V = max(int(spec.length), 2), int(num_vehicles)
    centers = (np.asarray(rsu_centers, np.float64)
               if rsu_centers is not None and len(rsu_centers) else None)
    # corridor: motion confined to a horizontal band around mid-height
    band = (max(min(spec.corridor_frac, 1.0), 0.0) * area / 2.0
            if spec.corridor_frac > 0 else area / 2.0)
    y_lo, y_hi = area / 2.0 - band, area / 2.0 + band
    aniso = np.array([1.0, max(spec.corridor_frac, 0.05)
                      if spec.corridor_frac > 0 else 1.0])

    pos = np.empty((L, V, 2))
    pos[0, :, 0] = rng.uniform(0, area, V)
    pos[0, :, 1] = rng.uniform(y_lo, y_hi, V)
    angles = rng.uniform(0, 2 * np.pi, V)
    speeds = np.abs(rng.normal(spec.mean_speed, spec.speed_std, V))
    vel = np.stack([speeds * np.cos(angles),
                    speeds * np.sin(angles)], axis=1) * aniso

    for i in range(1, L):
        drift = np.zeros_like(vel)
        if centers is not None and spec.hotspot_pull > 0:
            d = np.linalg.norm(pos[i - 1][:, None, :] - centers[None],
                               axis=-1)
            nearest = centers[np.argmin(d, axis=1)]
            dirn = nearest - pos[i - 1]
            norm = np.maximum(np.linalg.norm(dirn, axis=1, keepdims=True),
                              1.0)
            drift = spec.hotspot_pull * spec.mean_speed * dirn / norm
        noise = rng.normal(0, spec.speed_std, vel.shape) * aniso
        vel = (spec.gm_alpha * vel + (1 - spec.gm_alpha) * drift * aniso
               + np.sqrt(1 - spec.gm_alpha ** 2) * noise)
        nxt = pos[i - 1] + vel * dt
        # the online model's exact reflection, x into the area and y into
        # the corridor band (shared helper keeps the two sources in parity)
        reflect_into(nxt, vel, 0, 0.0, area)
        reflect_into(nxt, vel, 1, y_lo, y_hi)
        pos[i] = nxt

    # vehicles keep moving while absent (drive-in/drive-out); the presence
    # mask alone gates participation
    pres = _presence_schedule(spec, L, V, rng)
    return TraceSet(pos, pres, dt)


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------

def build_trace(spec: TraceSpec, *, area: float, num_vehicles: int,
                dt: float,
                rsu_centers: Optional[Sequence[Tuple[float, float]]] = None
                ) -> TraceSet:
    """Materialize the TraceSpec into a TraceSet (deterministic)."""
    if spec.kind == "synthetic":
        return synthesize(spec, area, num_vehicles, dt, rsu_centers)
    if spec.kind == "tdrive":
        if not spec.path:
            raise ValueError("TraceSpec(kind='tdrive') requires `path`")
        ts = load_tdrive(spec.path, area, dt, num_vehicles=num_vehicles,
                         length=spec.length, max_gap_s=spec.max_gap_s)
        if ts.num_vehicles < num_vehicles:
            raise ValueError(
                f"trace {spec.path!r} has {ts.num_vehicles} vehicles, "
                f"scenario needs {num_vehicles}")
        return ts
    raise ValueError(f"unknown TraceSpec.kind {spec.kind!r}; "
                     "have ('synthetic', 'tdrive')")
