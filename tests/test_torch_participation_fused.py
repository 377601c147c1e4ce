"""Semi-synchronous participation in the port's fused engine against the
reference's serial run, on the CPU: ``test_torch_participation.py``'s
four rounds under ``fused`` (its checks collected here over this file's
run) and ``run_scanned(4)``.

The fused program carries the buffer with the fleet on the lane axis:
each round ages it, releases the entries of lanes back in coverage into
the merge, drops the overdue ones and admits the deferred lanes' merged
deltas, and the engine mirrors it onto the host servers after every
round. ``run_scanned`` draws fresh adapters for every round of a task
that has no global model yet, as the serial server does: task 0 keeps
no upload in round 0 (all ten defer) and trains from fresh draws again
in round 2.
"""
import numpy as np
import pytest
import torch

from repro_torch.optim.adam import leaves
from test_torch_participation import (  # noqa: F401  (fixtures and tests)
    ROUNDS, test_uploads_defer_and_release)
from test_torch_sim import one_torch_thread  # noqa: F401
from test_torch_tier import (  # noqa: F401  (fixtures and tests)
    check_records, port_run, port_sim, reference, reference_svds,
    test_plans_match_reference, test_records_match_reference,
    test_server_states_match_reference)


@pytest.fixture(scope="module", params=["fused"])
def runs(request, tmp_path_factory):
    ref = reference(tmp_path_factory, "semi", "ours", ROUNDS)
    return ref, port_run(ref, request.param)


def test_carry_buffer_is_mirrored(runs):
    """After the last round the host servers hold the carry's occupied
    lanes, the vehicles the reference's buffer holds."""
    ref, run = runs
    eng = run["sim"].fused
    for t, srv in enumerate(run["sim"].servers):
        occupied = np.flatnonzero(eng.carry["buf_w"][t].numpy() > 0)
        assert sorted(srv.buffer) == occupied.tolist()
        assert sorted(srv.buffer) == sorted(ref["states"][-1][t]["buffer"])


def test_run_scanned_matches_run_round_and_reference(tmp_path_factory):
    """run_scanned(4) equals the fused engine's four rounds run one by
    one from its own state, exactly (records, merged deltas, buffer),
    and the reference's records."""
    ref = reference(tmp_path_factory, "semi", "ours", ROUNDS)
    sim = port_sim(ref, "fused")
    with reference_svds(sim):
        hist = sim.run_scanned(ROUNDS)
    one = port_run(ref, "fused", pinned=False)
    assert hist == one["hist"]
    check_records(ref, hist)
    for s, o in zip(sim.servers, one["sim"].servers):
        for x, y in zip(leaves(s.merged), leaves(o.merged)):
            assert torch.equal(x, y)
        assert sorted(s.buffer) == sorted(o.buffer)
        for v, e in s.buffer.items():
            assert (e["w"], e["age"], e["dest"]) == (
                o.buffer[v]["w"], o.buffer[v]["age"], o.buffer[v]["dest"])
            for x, y in zip(leaves(e["delta"]), leaves(o.buffer[v]["delta"])):
                assert torch.equal(x, y)
