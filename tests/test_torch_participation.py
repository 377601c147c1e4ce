"""Semi-synchronous participation (``ParticipationSpec(mode="semi_sync")``)
in the port against the reference, on the CPU: the upload buffer's
algebra, the server's buffer (release, drop, re-admit, drain, adoption),
and four rounds of the paper's method under ``serial`` and ``batched``,
each against the reference's serial run (the fused engine and
``run_scanned``: ``test_torch_participation_fused.py``; with a tier:
``test_torch_participation_tier.py``; ``max_delay`` 0 against sync:
``test_torch_participation_sync.py``).

The configuration is ``semi`` of ``test_torch_tier.py``: the default
spec (``max_delay`` 3, decay 0.6, buffered handoffs) on its 24-vehicle,
3-task map with the shape of the reference's ``rsu-outage`` preset, task
0's RSU dark in round 1 and task 1's in round 2. Task 0's ten vehicles
all depart in round 0 and defer their uploads, and nine come back and
release theirs in round 2; task 1 defers ten in round 1 and releases
ten in round 3. Every round of the port starts from the reference's
server state (merged deltas and buffer) as that round found it. The
checks and tolerances are ``test_torch_tier.py``'s.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ParticipationSpec as JParticipationSpec
from repro.core import aggregation as jagg
from repro.federated.server import RSUServer as JRSUServer
from repro_torch.config import ParticipationSpec
from repro_torch.core import aggregation as agg
from repro_torch.federated.server import RSUServer
from test_torch_sim import one_torch_thread  # noqa: F401
from test_torch_tier import (  # noqa: F401  (fixtures and tests)
    JLORA, LORA, _fleet, _tiny, port_run, reference, server_state,
    test_engine_check_dev_is_exact, test_plans_match_reference,
    test_records_match_reference, test_server_states_match_reference,
    tree_err)

ROUNDS = 4


# ---------------------------------------------------------------------------
# The buffer's algebra
# ---------------------------------------------------------------------------

def _deltas(V, seed):
    """A random per-lane delta tree in the port's layout (lanes third
    from the end) and the reference's (lanes first)."""
    a = np.random.default_rng(seed).normal(size=(2, V, 5, 4)).astype(
        np.float32)
    return ({"x": {"delta": torch.from_numpy(a)}},
            {"x": {"delta": jnp.asarray(np.moveaxis(a, 1, 0))}})


def test_merge_delta_fleet_matches_reference():
    """The port's per-target merge_delta_lanes over a fleet equals the
    reference's merge_delta_fleet (the fused program calls it one target
    at a time into a reused scratch)."""
    fleet, jfleet = _fleet(5, seed=7)
    got = agg.merge_delta_lanes(fleet["q"], 1.5).numpy()
    want = np.asarray(jagg.merge_delta_fleet(jfleet, 1.5)["q"]["delta"])
    assert np.allclose(got, np.moveaxis(want, 0, 1), atol=1e-5)
    # a lane's delta is its own adapter's, lane by lane
    lane = {"a": fleet["q"]["a"].select(-3, 2), "b": fleet["q"]["b"]
            .select(-3, 2)}
    assert torch.allclose(agg.merge_delta_lanes(fleet["q"], 1.5)
                          .select(-3, 2), 1.5 * lane["a"] @ lane["b"],
                          atol=1e-5)


def test_release_sums_match_reference():
    """Trivial-tier and per-RSU release sums; a lane at weight 0 or with
    destination -1 is an exact no-op."""
    buf, jbuf = _deltas(6, 1)
    relw = np.asarray([0.0, 2.0, 0.5, 0.0, 1.0, 3.0], np.float32)
    dest = np.asarray([0, 1, -1, 2, 1, 0])
    raw, tot = agg.buffer_release_sum(buf, relw)
    jraw, jtot = jagg.buffer_release_sum(jbuf, jnp.asarray(relw))
    assert np.allclose(raw["x"]["delta"].numpy(),
                       np.asarray(jraw["x"]["delta"]), atol=1e-5)
    assert float(tot) == pytest.approx(float(jtot))
    raw_k, w_k = agg.segment_buffer_release(buf, relw, dest, 3)
    jraw_k, jw_k = jagg.segment_buffer_release(jbuf, jnp.asarray(relw),
                                               jnp.asarray(dest), 3)
    assert np.allclose(raw_k["x"]["delta"].numpy(),
                       np.moveaxis(np.asarray(jraw_k["x"]["delta"]), 0, 1),
                       atol=1e-5)
    assert w_k.tolist() == pytest.approx([3.0, 3.0, 0.0])
    assert np.allclose(w_k.numpy(), np.asarray(jw_k))


def test_combine_with_released_matches_reference():
    """Live merge and releases in raw-weight space: the normalised
    aggregate over both, scalar and per-segment."""
    merged, jmerged = _deltas(3, 2)
    raw, jraw = _deltas(3, 3)
    for lw, rw in ((5.0, 2.5), (np.asarray([2.0, 0.0, 1.0], np.float32),
                                np.asarray([1.0, 3.0, 0.0], np.float32))):
        got = agg.combine_with_released(merged, lw, raw, rw)
        if np.ndim(lw):
            want = jagg.combine_with_released(
                jmerged, jnp.asarray(lw), jraw, jnp.asarray(rw))
            want = np.moveaxis(np.asarray(want["x"]["delta"]), 0, 1)
        else:
            m, r = merged["x"]["delta"], raw["x"]["delta"]
            want = ((m * lw + r) / (lw + rw)).numpy()
        assert np.allclose(got["x"]["delta"].numpy(), want, atol=1e-6)


# ---------------------------------------------------------------------------
# The server's buffer against the reference's
# ---------------------------------------------------------------------------

def _servers(**part):
    kw = dict({"mode": "semi_sync"}, **part)
    return (RSUServer(_tiny(False), LORA, "ours", device="cpu",
                      participation=ParticipationSpec(**kw)),
            JRSUServer(_tiny(True), JLORA, "ours",
                       participation=JParticipationSpec(**kw)))


def _delta(v):
    return ({"x": {"delta": torch.full((2, 2), float(v))}},
            {"x": {"delta": jnp.full((2, 2), float(v), jnp.float32)}})


def _same(srv, jsrv):
    a, b = server_state(srv, False), server_state(jsrv, True)
    assert sorted(a["buffer"]) == sorted(b["buffer"])
    for v, e in b["buffer"].items():
        g = a["buffer"][v]
        assert (g["age"], g["dest"]) == (e["age"], e["dest"])
        assert g["w"] == pytest.approx(e["w"]) and tree_err(
            g["delta"], e["delta"]) == 0.0


def _released(rel, jrel):
    assert len(rel) == len(jrel)
    for (d, w, dest), (jd, jw, jdest) in zip(rel, jrel):
        assert dest == jdest and w == pytest.approx(jw, rel=1e-6)
        assert np.array_equal(d["x"]["delta"].numpy(),
                              np.asarray(jd["x"]["delta"]))


@pytest.mark.parametrize("handoffs", [True, False])
def test_buffer_release_weight_and_destination(handoffs):
    """An entry released two rounds late lands at w·decay², at the
    vehicle's current RSU with buffered handoffs, else where it
    trained."""
    srv, jsrv = _servers(max_delay=3, vehicle_staleness_decay=0.5,
                         buffer_handoffs=handoffs)
    d, jd = _delta(4)
    srv.admit_buffered([(4, d, 10.0, 1)])
    jsrv.admit_buffered([(4, jd, 10.0, 1)])
    active, assoc = np.zeros(8, bool), np.full(8, 2, np.int64)
    assert srv.release_buffered(active) == jsrv.release_buffered(active) \
        == []
    _same(srv, jsrv)
    active[4] = True
    rel, jrel = (s.release_buffered(active, assoc) for s in (srv, jsrv))
    _released(rel, jrel)
    assert rel[0][1] == pytest.approx(10.0 * 0.5 ** 2)
    assert rel[0][2] == (2 if handoffs else 1) and not srv.buffer


def test_buffer_drops_overdue_and_readmits():
    srv, jsrv = _servers(max_delay=2)
    d, jd = _delta(1)
    srv.admit_buffered([(0, d, 1.0, 0)])
    jsrv.admit_buffered([(0, jd, 1.0, 0)])
    inactive = np.zeros(4, bool)
    for _ in range(2):
        srv.release_buffered(inactive)
        jsrv.release_buffered(inactive)
        _same(srv, jsrv)
    assert 0 in srv.buffer
    for s in (srv, jsrv):
        s.release_buffered(inactive)          # age 3 > max_delay: dropped
    assert not srv.buffer and not jsrv.buffer
    # a vehicle's new entry replaces its old one
    for v, w, dest in ((2, 5.0, 0), (2, 7.0, 1)):
        d, jd = _delta(v + w)
        srv.admit_buffered([(v, d, w, dest)])
        jsrv.admit_buffered([(v, jd, w, dest)])
    _same(srv, jsrv)
    assert srv.buffer[2]["w"] == 7.0 and srv.buffer[2]["dest"] == 1


def test_buffer_drains_in_the_reference_order():
    """Random coverage over max_delay + 2 rounds: every entry is released
    once or dropped, in the reference's lane order and weights."""
    rng = np.random.default_rng(0)
    for max_delay in (1, 2, 4):
        srv, jsrv = _servers(max_delay=max_delay)
        for v in range(6):
            d, jd = _delta(v)
            srv.admit_buffered([(v, d, 1.0 + v, 0)])
            jsrv.admit_buffered([(v, jd, 1.0 + v, 0)])
        seen = []
        for _ in range(max_delay + 2):
            active = rng.random(6) < 0.4
            rel = srv.release_buffered(active, np.zeros(6, np.int64))
            _released(rel, jsrv.release_buffered(active,
                                                 np.zeros(6, np.int64)))
            seen += [float(d["x"]["delta"][0, 0]) for d, _, _ in rel]
        assert not srv.buffer and not jsrv.buffer
        assert len(seen) == len(set(seen))


def test_load_buffer_adopts_lanes_with_weight():
    """The fused engine's buffer (lanes on the lane axis) into host
    entries: weight 0 is an empty lane; each entry a copy."""
    srv, _ = _servers()
    deltas, _ = _deltas(4, 5)
    srv.load_buffer(deltas, [0.0, 2.0, 0.0, 1.5], [0, 1, 0, 2],
                    [-1, 0, -1, 2])
    assert sorted(srv.buffer) == [1, 3]
    e = srv.buffer[3]
    assert (e["w"], e["age"], e["dest"]) == (1.5, 2, 2)
    got = srv.buffer[1]["delta"]["x"]["delta"]
    assert torch.equal(got, deltas["x"]["delta"].select(-3, 1))
    got.zero_()
    assert float(deltas["x"]["delta"].select(-3, 1).abs().sum()) > 0


# ---------------------------------------------------------------------------
# Four rounds of the paper's method, serial and batched
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["serial", "batched"])
def runs(request, tmp_path_factory):
    ref = reference(tmp_path_factory, "semi", "ours", ROUNDS)
    return ref, port_run(ref, request.param)


def test_uploads_defer_and_release(runs):
    """Task 0 defers all ten uploads in round 0 and releases nine in
    round 2, task 1 defers ten in round 1 and releases ten in round 3;
    a round that keeps none and releases none evaluates no model."""
    _, run = runs
    t0 = [r["tasks"][0] for r in run["hist"]]
    t1 = [r["tasks"][1] for r in run["hist"]]
    assert [t["deferred"] for t in t0] == [10, 0, 0, 0]
    assert [t["released"] for t in t0] == [0, 0, 9, 0]
    assert [t["deferred"] for t in t1] == [0, 10, 0, 0]
    assert [t["released"] for t in t1] == [0, 0, 0, 10]
    assert t0[0]["accuracy"] == 0.0 and t0[2]["rel_weight"] > 0
    assert len(run["states"][0][0]["buffer"]) == 10
    assert run["states"][0][0]["global"] is None
    assert run["states"][2][0]["global"] is not None
