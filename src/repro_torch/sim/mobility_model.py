"""Vehicular mobility with RSU coverage (paper §V-A), port of
``repro/sim/mobility_model.py``.

Online Gauss-Markov motion over a bounded urban area with attraction
toward RSU hotspots: bounded dwell times inside coverage, intermittent
connectivity, early departures, RSU handoffs. Coverage honors
:class:`repro_torch.config.OutageSpec` windows (an RSU in outage has zero
effective radius). Departure *prediction* (used by §IV-E fault tolerance)
extrapolates the current velocity over the expected round duration.

Trace replay (``trace=TraceSpec(...)``): pre-staged per-round positions
and presence built once by :func:`repro_torch.sim.trajectories.build_trace`
(T-Drive ingestion or statistically matched synthesis), replayed tick by
tick; a vehicle absent at a tick is active for no task (dynamic fleets),
and departure prediction reads the trace's finite-difference velocity.

numpy, the same calls in the same order as the reference, so one seed
gives its trajectories bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config import OutageSpec, TraceSpec


@dataclass(frozen=True)
class RSU:
    rsu_id: int
    xy: Tuple[float, float]
    radius: float
    task_id: int


@dataclass(frozen=True)
class MobilitySimConfig:
    area: float = 3000.0           # square side (m)
    num_vehicles: int = 30
    mean_speed: float = 10.0       # m/s
    speed_std: float = 3.0
    gm_alpha: float = 0.85         # Gauss-Markov memory
    hotspot_pull: float = 0.35     # attraction toward nearest RSU hotspot
    dt: float = 10.0               # seconds per round tick
    coverage_radius: float = 1100.0
    seed: int = 0
    # scenario subsystem (repro.sim.scenarios): declarative trace replay,
    # RSU placement style, and coverage outage windows
    trace: Optional[TraceSpec] = None
    rsu_layout: str = "grid"       # "grid" | "corridor" | "sparse"
    outages: Tuple[OutageSpec, ...] = ()


def associate_nearest(pos: np.ndarray, centers: np.ndarray,
                      radii: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-in-range RSU association (two-tier hierarchy, pure part).

    pos: (V, 2) vehicle positions; centers: (K, 2) RSU positions; radii:
    (K,) effective coverage radii (0 during outages). Returns
    ``(assoc, dist)``: assoc (V,) int64 — index of the nearest center whose
    coverage contains the vehicle, or ``-1`` when no center is in range
    (the vehicle becomes a zero-weight lane downstream); dist (V, K) —
    distances to every center. Idempotent by construction (a pure function
    of positions and geometry).
    """
    pos = np.asarray(pos, np.float64)
    centers = np.asarray(centers, np.float64)
    radii = np.asarray(radii, np.float64)
    d = np.linalg.norm(pos[:, None, :] - centers[None], axis=-1)   # (V, K)
    in_range = d <= radii[None, :]
    nearest = np.argmin(np.where(in_range, d, np.inf), axis=1)
    assoc = np.where(in_range.any(axis=1), nearest, -1)
    return assoc.astype(np.int64), d


def handoff_events(prev_assoc: np.ndarray,
                   assoc: np.ndarray) -> np.ndarray:
    """True where a vehicle's association CHANGED between two valid RSUs.

    Entering coverage (-1 → k) and leaving it (k → -1) are not handoffs:
    there is no source/target RSU pair to migrate adapter state between, so
    no migration penalty applies. A handoff fires iff both associations are
    valid and differ.
    """
    prev_assoc = np.asarray(prev_assoc)
    assoc = np.asarray(assoc)
    return (prev_assoc >= 0) & (assoc >= 0) & (prev_assoc != assoc)


def reflect_into(pos: np.ndarray, vel: np.ndarray, ax: int,
                 lo: float, hi: float) -> None:
    """Exact boundary reflection of ``pos[:, ax]`` into [lo, hi], in place.

    Triangle-wave folding is exact for ANY overshoot (the old single-bounce
    update left a vehicle out of bounds whenever it overshot by more than
    the box width); velocity flips when the fold count is odd. Single-bounce
    cases reproduce the previous arithmetic exactly, so RNG-pinned
    regression histories are unchanged in normal speed regimes.
    """
    width = max(hi - lo, 1e-9)
    p = pos[:, ax] - lo
    m = np.mod(p, 2.0 * width)
    refl = np.where(m > width, 2.0 * width - m, m)
    flip = (np.floor_divide(p, width).astype(np.int64) % 2) != 0
    pos[:, ax] = np.clip(lo + refl, lo, hi)
    vel[flip, ax] *= -1


class MobilityModel:
    def __init__(self, cfg: MobilitySimConfig, rsus: List[RSU]):
        self.cfg = cfg
        self.rsus = rsus
        rng = np.random.default_rng(cfg.seed)
        self._rng = rng
        self.tick = 0                  # number of step() calls so far
        # per-task association memory for handoff detection: task_id ->
        # {"tick", "prev", "cur"} — see round_view_group (idempotent per
        # tick: re-querying the same tick never re-advances "prev")
        self._assoc_log: Dict[int, Dict[str, np.ndarray]] = {}
        self._trace = None
        if cfg.trace is not None:
            # replay: tick 0 of the trace, and none of the online draws
            # below, so the mobility stream stays the reference's
            from repro_torch.sim.trajectories import build_trace
            self._trace = build_trace(
                cfg.trace, area=cfg.area, num_vehicles=cfg.num_vehicles,
                dt=cfg.dt, rsu_centers=[r.xy for r in rsus])
            pos, pres = self._trace.at(0)
            self.pos = np.array(pos)
            self.vel = self._trace.velocity_at(0).copy()
            self.present = np.array(pres)
            return
        self.present = np.ones(cfg.num_vehicles, bool)
        self.pos = rng.uniform(0, cfg.area, size=(cfg.num_vehicles, 2))
        angles = rng.uniform(0, 2 * np.pi, cfg.num_vehicles)
        speeds = np.abs(rng.normal(cfg.mean_speed, cfg.speed_std,
                                   cfg.num_vehicles))
        self.vel = np.stack([speeds * np.cos(angles),
                             speeds * np.sin(angles)], axis=1)

    @staticmethod
    def place_rsus(num_tasks: int, area: float, radius: float,
                   seed: int = 0, layout: str = "grid",
                   num_per_task: int = 1) -> List[RSU]:
        """RSU placement, clipped into [0, area] (Gaussian jitter used to
        silently push edge RSUs out of the map, shrinking their coverage).

        layouts:
          - "grid": jittered grid positions (traffic hotspots; default)
          - "corridor": evenly spaced along the mid-height horizontal
            corridor (highway deployments)
          - "sparse": uniform random draws rejected toward spread (rural
            deployments with large inter-RSU gaps)

        num_per_task > 1 (two-tier hierarchy): each task deploys a PRIMARY
        RSU at the legacy position (drawn first, from the same stream as
        the 1-RSU layout — so the 1-RSU placement is unchanged regardless
        of num_per_task) plus satellites around it. Each satellite draws
        its jitter from its own (task, rsu) subkey stream — a shared
        per-task key would collapse every satellite onto the same jittered
        offset. Satellites ring the primary on grid/sparse layouts and
        alternate along the road on corridor layouts. Primaries keep
        ``rsu_id = task`` under ANY num_per_task (an OutageSpec written
        against the 1-RSU layout keeps meaning "task t's primary");
        satellites are numbered above num_tasks:
        ``rsu_id = num_tasks + task*(num_per_task-1) + (j-1)``.
        """
        if num_per_task < 1:
            raise ValueError("num_per_task must be >= 1")
        rng = np.random.default_rng(seed + 17)
        rsus = []
        if layout == "grid":
            side = int(np.ceil(np.sqrt(num_tasks)))
            for t in range(num_tasks):
                gx, gy = t % side, t // side
                x = (gx + 0.5) / side * area + rng.normal(0, area * 0.05)
                y = (gy + 0.5) / side * area + rng.normal(0, area * 0.05)
                rsus.append((x, y))
        elif layout == "corridor":
            for t in range(num_tasks):
                x = (t + 0.5) / num_tasks * area + rng.normal(0, area * 0.02)
                y = area / 2.0 + rng.normal(0, area * 0.03)
                rsus.append((x, y))
        elif layout == "sparse":
            pts: List[Tuple[float, float]] = []
            for _ in range(num_tasks):
                best, best_d = None, -1.0
                for _try in range(16):   # farthest-of-16 spreads the sites
                    cand = tuple(rng.uniform(0.15 * area, 0.85 * area, 2))
                    d = min((np.hypot(cand[0] - p[0], cand[1] - p[1])
                             for p in pts), default=np.inf)
                    if d > best_d:
                        best, best_d = cand, d
                pts.append(best)
            rsus = pts
        else:
            raise ValueError(f"unknown rsu_layout {layout!r}; "
                             "have ('grid', 'corridor', 'sparse')")
        out: List[RSU] = []
        for t, (px, py) in enumerate(rsus):
            group = [(px, py)]
            for j in range(1, num_per_task):
                # per-(task, rsu) subkey: independent jitter per satellite
                sub = np.random.default_rng(
                    np.random.SeedSequence([seed + 17, t, j]))
                if layout == "corridor":
                    # alternate down-/up-road of the primary
                    step = 0.8 * radius * ((j + 1) // 2)
                    dx = step * (1.0 if j % 2 == 1 else -1.0)
                    dy = sub.normal(0, area * 0.02)
                    dx += sub.normal(0, radius * 0.05)
                else:
                    # ring around the primary; coverages overlap but the
                    # nearest-in-range winner differs across the cell
                    ang = (2.0 * np.pi * (j - 1) / max(num_per_task - 1, 1)
                           + sub.uniform(-0.2, 0.2))
                    rad = 0.6 * radius * sub.uniform(0.8, 1.2)
                    dx, dy = rad * np.cos(ang), rad * np.sin(ang)
                group.append((px + dx, py + dy))
            for j, (x, y) in enumerate(group):
                rsu_id = (t if j == 0
                          else num_tasks + t * (num_per_task - 1) + (j - 1))
                out.append(RSU(rsu_id=rsu_id,
                               xy=(float(np.clip(x, 0.0, area)),
                                   float(np.clip(y, 0.0, area))),
                               radius=radius, task_id=t))
        return out

    # -- dynamics ---------------------------------------------------------
    def step(self) -> None:
        c = self.cfg
        self.tick += 1
        if self._trace is not None:
            pos, pres = self._trace.at(self.tick)
            self.pos = np.array(pos)
            self.vel = self._trace.velocity_at(self.tick).copy()
            self.present = np.array(pres)
            return
        rng = self._rng
        # Gauss-Markov velocity update
        noise = rng.normal(0, c.speed_std, self.vel.shape)
        self.vel = (c.gm_alpha * self.vel
                    + (1 - c.gm_alpha) * self._drift()
                    + np.sqrt(1 - c.gm_alpha ** 2) * noise)
        self.pos = self.pos + self.vel * c.dt
        for ax in range(2):
            reflect_into(self.pos, self.vel, ax, 0.0, c.area)

    def _drift(self) -> np.ndarray:
        """Mean velocity: toward the nearest hotspot (traffic attraction)."""
        c = self.cfg
        if not self.rsus:
            return np.zeros_like(self.vel)
        centers = np.array([r.xy for r in self.rsus])
        d = np.linalg.norm(self.pos[:, None, :] - centers[None], axis=-1)
        nearest = centers[np.argmin(d, axis=1)]
        dirn = nearest - self.pos
        norm = np.maximum(np.linalg.norm(dirn, axis=1, keepdims=True), 1.0)
        return c.hotspot_pull * c.mean_speed * dirn / norm

    # -- coverage queries --------------------------------------------------
    @property
    def round_idx(self) -> int:
        """0-based index of the round the current tick belongs to (the
        simulator steps once at the start of each round)."""
        return max(self.tick - 1, 0)

    def effective_radius(self, rsu: RSU,
                         at_round: Optional[int] = None) -> float:
        """The RSU's radius at ``at_round`` (default: the current round),
        honoring outage windows. Departure prediction passes the round its
        extrapolation horizon lands in, so the predicted-exit signal and
        the in-flight upload buffer see the same coverage truth across an
        outage edge."""
        rnd = self.round_idx if at_round is None else at_round
        for o in self.cfg.outages:
            if o.rsu_id == rsu.rsu_id and o.start <= rnd < o.end:
                return 0.0
        return rsu.radius

    def _horizon_round(self, horizon_s: float) -> int:
        """The round a `horizon_s`-ahead extrapolation lands in (at least
        one round ahead — a prediction is always about the future)."""
        return self.round_idx + max(1, int(np.ceil(horizon_s / self.cfg.dt)))

    def distances_to(self, rsu: RSU) -> np.ndarray:
        return np.linalg.norm(self.pos - np.asarray(rsu.xy), axis=1)

    def in_coverage(self, rsu: RSU) -> np.ndarray:
        return self.distances_to(rsu) <= self.effective_radius(rsu)

    def predict_departure(self, rsu: RSU, horizon_s: float) -> np.ndarray:
        """True for vehicles predicted to exit coverage within `horizon_s`
        (linear velocity extrapolation — §IV-E's anticipation signal).
        The future position is tested against the radius AT the horizon
        round, not the current one: predicting through an outage edge with
        the current radius would call vehicles 'staying' inside a window
        that is about to collapse to radius 0 (and vice versa)."""
        future = self.pos + self.vel * horizon_s
        d_future = np.linalg.norm(future - np.asarray(rsu.xy), axis=1)
        r_future = self.effective_radius(
            rsu, at_round=self._horizon_round(horizon_s))
        return (d_future > r_future) & self.in_coverage(rsu)

    def round_view(self, rsu: RSU, horizon_s: Optional[float] = None) -> dict:
        """Everything one task round needs from mobility, in one snapshot:
        coverage, predicted departures, distances and peer availability.

        Shared by the serial planner and the fused engine's round staging so
        both consume identical geometry (the fused engine ships these arrays
        straight into its jit program). ``active`` is presence-gated: a
        vehicle outside its arrival/departure slot can never participate,
        regardless of geometry — the dynamic-fleet invariant every engine
        inherits from this one mask.
        """
        h = self.cfg.dt if horizon_s is None else horizon_s
        active = self.in_coverage(rsu) & self.present
        departing = ((self.predict_departure(rsu, h) & active)
                     if active.any()
                     else np.zeros(self.cfg.num_vehicles, bool))
        staying = active & ~departing
        return {
            "active": active,
            "departing": departing,
            "staying": staying,
            "distances": self.distances_to(rsu),
            # §IV-E migration target exists iff any in-coverage vehicle is
            # predicted to stay (a departing vehicle is never its own peer)
            "peer_available": bool(staying.any()),
        }

    def round_view_group(self, rsus: Sequence[RSU],
                         horizon_s: Optional[float] = None) -> dict:
        """:meth:`round_view` generalized to a task's RSU GROUP (two-tier
        hierarchy). Vehicles are associated to the nearest in-range RSU of
        the group; the snapshot gains:

          assoc    (V,) int64 — local RSU index within the group, -1 when
                   no RSU of the group is in range (zero-weight lane);
          handoff  (V,) bool — the association changed between two VALID
                   RSUs since the previous tick (adapter migration);
          distances (V,) — to the ASSOCIATED RSU (group RSU 0 for
                   unassociated vehicles; they are masked downstream).

        For a 1-RSU group every field reduces exactly to
        ``round_view(rsus[0])`` (``assoc`` degenerates to 0/-1 and
        ``handoff`` can never fire) — the hierarchy's equivalence contract.

        Departure prediction is group-wide: a vehicle departs when its
        extrapolated position leaves the coverage of EVERY RSU of the group
        — moving between two RSUs of the same task is a handoff, not a
        departure.

        Handoff memory is keyed on the group's task_id and advances at most
        once per mobility tick: re-querying the same tick recomputes the
        same snapshot (idempotent), so serial planning, fused staging and
        diagnostic probes can all call this without double-advancing.
        """
        if not rsus:
            raise ValueError("round_view_group needs at least one RSU")
        task_id = rsus[0].task_id
        h = self.cfg.dt if horizon_s is None else horizon_s
        centers = np.array([r.xy for r in rsus], np.float64)
        radii = np.array([self.effective_radius(r) for r in rsus],
                         np.float64)
        assoc, d = associate_nearest(self.pos, centers, radii)
        assoc = np.where(self.present, assoc, -1)
        active = assoc >= 0
        # distances to the associated RSU (column 0 for unassociated lanes
        # — identical to the single-RSU view when the group has one RSU)
        dist = d[np.arange(len(assoc)), np.maximum(assoc, 0)]
        # departure: the extrapolated position escapes the whole group —
        # judged against the radii AT the horizon round (an RSU entering
        # an outage next round has radius 0 there; see predict_departure)
        future = self.pos + self.vel * h
        d_future = np.linalg.norm(future[:, None, :] - centers[None],
                                  axis=-1)
        rnd_future = self._horizon_round(h)
        radii_future = np.array(
            [self.effective_radius(r, at_round=rnd_future) for r in rsus],
            np.float64)
        future_covered = (d_future <= radii_future[None, :]).any(axis=1)
        departing = active & ~future_covered
        staying = active & ~departing
        # handoff memory: advance once per tick, idempotent within a tick
        log = self._assoc_log.get(task_id)
        if log is None or log["tick"] != self.tick:
            prev = (log["cur"] if log is not None
                    else np.full(len(assoc), -1, np.int64))
            log = {"tick": self.tick, "prev": prev, "cur": assoc}
            self._assoc_log[task_id] = log
        handoff = handoff_events(log["prev"], assoc)
        return {
            "active": active,
            "departing": departing,
            "staying": staying,
            "distances": dist,
            "assoc": assoc,
            "handoff": handoff,
            "peer_available": bool(staying.any()),
        }

    def nearby_peer(self, rsu: RSU, vehicle: int,
                    staying: np.ndarray) -> Optional[int]:
        """Closest in-coverage vehicle predicted to stay (migration target)."""
        cand = np.where(staying)[0]
        cand = cand[cand != vehicle]
        if len(cand) == 0:
            return None
        d = np.linalg.norm(self.pos[cand] - self.pos[vehicle], axis=1)
        return int(cand[np.argmin(d)])
