"""The port's trace layer (``repro_torch.sim.trajectories``) and trace
replay in its mobility model, against the reference's, on the CPU.

Every array is numpy in both packages, drawn by the same calls in the
same order, so they are held equal bit for bit: ``build_trace`` for every
arrival mode and the corridor, the T-Drive loader on hand-written fixes
(a gap, a vehicle cap, malformed lines, an empty input that raises), and
a replaying ``MobilityModel`` (positions, velocities, presence,
``round_view``'s active set and association) past the staged horizon,
where replay wraps. Presence gates the active set, and an outage window
zeroes an RSU's coverage and lifts again.
"""
import numpy as np
import pytest

from repro.config import OutageSpec as JOutageSpec
from repro.config import TraceSpec as JTraceSpec
from repro.sim import trajectories as jtraj
from repro.sim.mobility_model import MobilityModel as JMobilityModel
from repro.sim.mobility_model import MobilitySimConfig as JMobilitySimConfig
from repro_torch.config import OutageSpec, TraceSpec
from repro_torch.sim import trajectories as traj
from repro_torch.sim.mobility_model import MobilityModel, MobilitySimConfig

AREA = 2000.0
CENTERS = [(500.0, 500.0), (1500.0, 1200.0)]

TDRIVE = [
    # taxi 1: fixes every 2 min, continuously present
    "1,2008-02-02 15:36:08,116.51172,39.88823",
    "1,2008-02-02 15:38:08,116.51222,39.88962",
    "1,2008-02-02 15:40:08,116.51372,39.89120",
    "1,2008-02-02 15:42:08,116.51542,39.89302",
    "1,2008-02-02 15:44:08,116.51722,39.89440",
    # taxi 2: two early fixes, a gap of 5 min, two late fixes
    "2,2008-02-02 15:36:30,116.49800,39.90000",
    "2,2008-02-02 15:38:30,116.49900,39.90110",
    "2,2008-02-02 15:43:30,116.50500,39.90700",
    "2,2008-02-02 15:44:30,116.50600,39.90810",
    # taxi 3: out of order, fewest fixes
    "3,2008-02-02 15:41:00,116.52000,39.88000",
    "3,2008-02-02 15:37:00,116.51800,39.87900",
    "",                                    # blank: skipped
    "garbage line",                        # malformed: skipped
    "4,not-a-date,116.5,39.9",             # bad timestamp: skipped
    "5,2008-02-02 15:40:00,east,39.9",     # bad longitude: skipped
]

SPECS = {
    "all": dict(length=12, seed=4),
    "staggered": dict(length=30, arrivals="staggered", min_dwell=5, seed=1),
    "waves": dict(length=30, arrivals="waves", min_dwell=4, seed=3),
    "corridor": dict(length=20, mean_speed=27.0, speed_std=6.0,
                     gm_alpha=0.92, hotspot_pull=0.1, corridor_frac=0.12,
                     seed=2),
    "no_pull": dict(length=8, hotspot_pull=0.0, seed=9),
}


def _same_trace(a, b):
    assert a.dt == b.dt
    assert a.positions.dtype == b.positions.dtype == np.float64
    assert np.array_equal(a.positions, b.positions)
    assert np.array_equal(a.presence, b.presence)


# ---------------------------------------------------------------------------
# Staging
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("centers", [CENTERS, None], ids=["rsus", "none"])
def test_build_trace_equals_the_reference_bit_for_bit(name, centers):
    kw = dict(area=AREA, num_vehicles=14, dt=10.0, rsu_centers=centers)
    got = traj.build_trace(TraceSpec(**SPECS[name]), **kw)
    want = jtraj.build_trace(JTraceSpec(**SPECS[name]), **kw)
    _same_trace(got, want)
    assert got.positions.min() >= 0.0 and got.positions.max() <= AREA


def test_corridor_confines_y_to_its_band():
    ts = traj.synthesize(TraceSpec(**SPECS["corridor"]), 4000.0, 12, 10.0)
    band = 0.12 * 4000.0 / 2.0
    y = ts.positions[..., 1]
    assert y.min() >= 2000.0 - band and y.max() <= 2000.0 + band


@pytest.mark.parametrize("mode", ["staggered", "waves"])
def test_presence_windows_are_dynamic_and_contiguous(mode):
    ts = traj.synthesize(TraceSpec(**SPECS[mode]), AREA, 16, 10.0)
    counts = ts.presence.sum(axis=1)
    assert len(set(counts.tolist())) > 1 and counts[0] > 0
    for v in range(16):
        on = np.flatnonzero(ts.presence[:, v])
        assert len(on) == 0 or on[-1] - on[0] + 1 == len(on)


def test_trace_set_wraps_and_its_velocity_skips_absent_ends():
    spec = TraceSpec(**SPECS["staggered"])
    ts = traj.synthesize(spec, AREA, 10, 10.0)
    jts = jtraj.synthesize(JTraceSpec(**SPECS["staggered"]), AREA, 10, 10.0)
    for tick in (0, 1, 29, 30, 31, 61):
        for a, b in zip(ts.at(tick), jts.at(tick)):
            assert np.array_equal(a, b)
        assert np.array_equal(ts.velocity_at(tick), jts.velocity_at(tick))
    assert np.array_equal(ts.at(31)[0], ts.positions[1])
    i = 5
    gone = ~(ts.presence[i] & ts.presence[i - 1])
    assert np.all(ts.velocity_at(i)[gone] == 0.0)


@pytest.mark.parametrize("bad, match", [
    (dict(arrivals="bogus"), "arrivals"), (dict(kind="bogus"), "kind"),
    (dict(kind="tdrive"), "path")], ids=["arrivals", "kind", "path"])
def test_bad_specs_raise_as_the_reference(bad, match):
    for mod, spec in ((traj, TraceSpec), (jtraj, JTraceSpec)):
        with pytest.raises(ValueError, match=match):
            mod.build_trace(spec(length=6, **bad), area=AREA,
                            num_vehicles=4, dt=10.0)


# ---------------------------------------------------------------------------
# T-Drive
# ---------------------------------------------------------------------------

def test_parse_tdrive_equals_the_reference():
    got = traj.parse_tdrive(reversed(TDRIVE))
    assert got == jtraj.parse_tdrive(reversed(TDRIVE))
    assert sorted(got) == ["1", "2", "3"]
    assert all([f[0] for f in v] == sorted(f[0] for f in v)
               for v in got.values())


@pytest.mark.parametrize("kw", [
    dict(dt=60.0, max_gap_s=240.0),
    dict(dt=30.0, num_vehicles=2, length=9),
    dict(dt=45.0, num_vehicles=1, length=4, max_gap_s=100.0),
], ids=["gaps", "capped", "one"])
def test_load_tdrive_equals_the_reference_bit_for_bit(kw):
    got = traj.load_tdrive(TDRIVE, area=AREA, **kw)
    _same_trace(got, jtraj.load_tdrive(TDRIVE, area=AREA, **kw))
    assert got.num_vehicles == kw.get("num_vehicles", 3)
    assert got.positions.min() >= 0.0 and got.positions.max() <= AREA


def test_load_tdrive_marks_the_gap_absent():
    ts = traj.load_tdrive(TDRIVE, area=AREA, dt=60.0, max_gap_s=240.0)
    assert ts.presence[1:5, 0].all()        # taxi 1 (most fixes) first
    gap = np.flatnonzero(~ts.presence[:, 1])
    assert len(gap) and ts.presence[gap, 0].any()


def test_tdrive_file_through_build_trace(tmp_path):
    path = tmp_path / "taxis.txt"
    path.write_text("\n".join(TDRIVE))
    kw = dict(area=AREA, num_vehicles=2, dt=60.0)
    got = traj.build_trace(TraceSpec(kind="tdrive", path=str(path),
                                     length=7), **kw)
    _same_trace(got, jtraj.build_trace(JTraceSpec(
        kind="tdrive", path=str(path), length=7), **kw))
    with pytest.raises(ValueError, match="scenario needs 5"):
        traj.build_trace(TraceSpec(kind="tdrive", path=str(path)),
                         area=AREA, num_vehicles=5, dt=60.0)


def test_load_tdrive_empty_raises():
    for mod in (traj, jtraj):
        with pytest.raises(ValueError, match="no parseable"):
            mod.load_tdrive(["nonsense", ""], area=AREA, dt=60.0)


# ---------------------------------------------------------------------------
# Replay in the mobility model
# ---------------------------------------------------------------------------

def _models(spec_kw, V=12, outages=()):
    out = []
    for ms, trace, outage, model in (
            (MobilitySimConfig, TraceSpec, OutageSpec, MobilityModel),
            (JMobilitySimConfig, JTraceSpec, JOutageSpec, JMobilityModel)):
        cfg = ms(area=AREA, num_vehicles=V, dt=10.0, coverage_radius=800.0,
                 seed=5, trace=trace(**spec_kw),
                 outages=tuple(outage(*o) for o in outages))
        rsus = model.place_rsus(2, AREA, cfg.coverage_radius, seed=5,
                                num_per_task=2)
        out.append(model(cfg, rsus))
    return out


@pytest.mark.parametrize("name", ["all", "waves"])
def test_replay_equals_the_reference_and_wraps(name):
    m, jm = _models(SPECS[name])
    ts = traj.build_trace(TraceSpec(**SPECS[name]), area=AREA,
                          num_vehicles=12, dt=10.0,
                          rsu_centers=[r.xy for r in m.rsus])
    L = ts.length
    online = np.random.default_rng(5).bit_generator.state
    for tick in range(0, L + 7):      # past the horizon: wraps modulo L
        if tick:
            m.step()
            jm.step()
        for a, b in ((m.pos, jm.pos), (m.vel, jm.vel),
                     (m.present, jm.present)):
            assert np.array_equal(a, b)
        assert np.array_equal(m.pos, ts.positions[tick % L])
        assert np.array_equal(m.present, ts.presence[tick % L])
        groups = [[r for r in m.rsus if r.task_id == t] for t in range(2)]
        jgroups = [[r for r in jm.rsus if r.task_id == t]
                   for t in range(2)]
        for g, jg in zip(groups, jgroups):
            view, jview = m.round_view_group(g), jm.round_view_group(jg)
            for k in ("active", "departing", "staying", "assoc",
                      "handoff"):
                assert np.array_equal(view[k], jview[k]), k
    # replay draws nothing from the online stream
    assert m._rng.bit_generator.state == online


def test_presence_gates_the_active_set():
    m, _ = _models(SPECS["waves"], V=16)
    absent_in_cover = False
    for _ in range(29):
        m.step()
        for rsu in m.rsus:
            view = m.round_view(rsu)
            assert not np.any(view["active"] & ~m.present)
            assert not np.any(view["departing"] & ~view["active"])
            covered = m.distances_to(rsu) <= rsu.radius
            absent_in_cover |= bool(np.any(covered & ~m.present))
    assert absent_in_cover, "the schedule never tested the presence gate"


def test_outage_zeroes_coverage_then_recovers():
    m, jm = _models(dict(length=20, seed=9), outages=((0, 3, 6),))
    counts = {r.rsu_id: [] for r in m.rsus}
    for _ in range(12):
        m.step()
        jm.step()
        for rsu, jrsu in zip(m.rsus, jm.rsus):
            a = m.round_view(rsu)["active"]
            assert np.array_equal(a, jm.round_view(jrsu)["active"])
            counts[rsu.rsu_id].append(int(a.sum()))
    assert counts[0][3:6] == [0, 0, 0]       # rounds 3-5: RSU 0 dark
    assert sum(counts[0][:3]) + sum(counts[0][6:]) > 0
    assert sum(counts[1][3:6]) > 0           # the other task's RSU is lit
