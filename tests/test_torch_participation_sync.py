"""``semi_sync`` with ``max_delay`` 0 is sync, bit for bit, under every
engine of the port, on the CPU: the buffer cannot hold a round, so no
upload defers and none is released (the fused program's defer set is
statically empty). Two rounds of ``test_torch_participation.py``'s map
and outages at 12 vehicles and 2 tasks (three departures of task 0 in
round 0 and four of task 1 in round 1, which a longer delay would defer)
under each engine and ``run_scanned``, against the same rounds under
``mode="sync"``: equal histories once the semi_sync-only tallies (all
zero) are taken out, equal merged deltas. A sync history has no
tallies. And the ablations (``ours_no_energy``, ``ours_no_mobility``)
under a tier with semi_sync, run free, their fused rounds held to their
serial ones (each held to the reference's serial run, round by round
from one state, in ``test_torch_modes_no_energy.py`` and
``test_torch_modes_no_mobility.py``).
"""
import dataclasses

import pytest
import torch

from repro_torch.config import ParticipationSpec
from repro_torch.optim.adam import leaves
from repro_torch.sim.simulator import IoVSimulator
from test_torch_sim import one_torch_thread  # noqa: F401
from test_torch_tier import sim_config

ROUNDS = 2
ENGINES = ("serial", "batched", "batched_check", "fused", "fused_check",
           "run_scanned")


def _run(engine, participation):
    cfg = dataclasses.replace(sim_config("semi", "ours", False, engine=(
        "fused" if engine == "run_scanned" else engine)),
        participation=participation, num_vehicles=12, num_tasks=2)
    sim = IoVSimulator(cfg, device="cpu")
    hist = (sim.run_scanned(ROUNDS) if engine == "run_scanned"
            else sim.run(ROUNDS))
    return sim, hist


def _strip(hist):
    out = []
    for r in hist:
        r = dict(r, tasks=[dict(t) for t in r["tasks"]])
        for t in r["tasks"]:
            assert t.pop("deferred") == 0 and t.pop("released") == 0
            assert t.pop("rel_weight") == 0.0
        out.append(r)
    return out


@pytest.mark.parametrize("engine", ENGINES)
def test_max_delay_zero_is_sync_bit_for_bit(engine):
    sync, hist = _run(engine, ParticipationSpec())
    semi, semi_hist = _run(engine, ParticipationSpec(mode="semi_sync",
                                                     max_delay=0))
    assert all("deferred" not in t for r in hist for t in r["tasks"])
    assert [r["tasks"][r["round"]]["departing"] for r in hist] == [3, 4]
    assert _strip(semi_hist) == hist
    for a, b in zip(semi.servers, sync.servers):
        assert not a.buffer
        for x, y in zip(leaves(a.merged), leaves(b.merged)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("method", ["ours_no_energy", "ours_no_mobility"])
def test_ablations_take_the_modes_in_every_engine(method):
    """The ablations run a tier with semi_sync (the reference allows
    both for the ours family): on the map of the mode files (24
    vehicles, 3 tasks), the fused engine's two rounds equal the serial
    engine's (ranks, counts,
    deferrals and releases exactly; energy and latency 1e-5 relative;
    the partials' weights and ages exactly), each ablation's static
    branch included (without §IV-E a departure loses its upload, so
    nothing defers)."""
    runs = {}
    for engine in ("serial", "fused"):
        sim = IoVSimulator(sim_config("tier+semi", method, False,
                                      engine=engine), device="cpu")
        runs[engine] = (sim, sim.run(ROUNDS))
    (serial, hist), (fused, fhist) = runs["serial"], runs["fused"]
    for r, f in zip(hist, fhist):
        for t, u in zip(r["tasks"], f["tasks"]):
            for key in ("active", "departing", "handoffs", "fallbacks",
                        "comm_params", "mean_rank", "deferred",
                        "released"):
                assert t[key] == u[key], (r["round"], key)
            for key in ("energy", "latency", "rel_weight"):
                assert abs(t[key] - u[key]) <= 1e-5 * max(abs(t[key]),
                                                          1e-12)
    for a, b in zip(serial.servers, fused.servers):
        assert a.partial_w == pytest.approx(b.partial_w, rel=1e-5)
        assert (a.partial_age == b.partial_age).all()
    deferred = sum(t["deferred"] for r in hist for t in r["tasks"])
    assert (deferred == 0) == (method == "ours_no_mobility")
    assert any(t["handoffs"] for r in hist for t in r["tasks"])
