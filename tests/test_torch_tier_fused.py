"""Multi-RSU tiers in the port's fused engines against the reference's
serial run, on the CPU: ``fused``, ``fused_check`` and ``run_scanned``
over ``test_torch_tier.py``'s three rounds of the paper's method on the
``dense-rsu`` tier, whose checks are collected here over this file's
runs, at its tolerances.

On the CPU the round program runs eagerly; whether a round syncs is its
staged ``sync`` input. The fused engine mirrors its carry's partials
onto the host servers after every round, where a segment that never
had an upload is a zero tree (the host keeps None).
"""
import numpy as np
import pytest
import torch

from repro_torch.optim.adam import leaves
from test_torch_sim import one_torch_thread  # noqa: F401
from test_torch_tier import (  # noqa: F401  (fixtures and tests)
    ROUNDS, check_records, port_run, port_sim, reference, reference_svds,
    server_state,
    test_engine_check_dev_is_exact, test_plans_match_reference,
    test_records_match_reference, test_server_states_match_reference,
    test_tier_syncs_and_charges_handoffs, tree_err)


@pytest.fixture(scope="module", params=["fused", "fused_check"])
def runs(request, tmp_path_factory):
    ref = reference(tmp_path_factory, "tier", "ours", ROUNDS)
    return ref, port_run(ref, request.param)


def test_sync_gate_is_staged_per_round(runs):
    """The program reads whether a round syncs from its staged input:
    rounds 0 and 2 do not, round 1 does."""
    _, run = runs
    eng = run["sim"].fused
    assert eng.x["sync"].tolist() == [0] * 3      # round 2, the last
    assert eng.K == 3 and tuple(eng.carry["partial_w"].shape) == (3, 3)


def test_run_scanned_matches_run_round_and_reference(tmp_path_factory):
    """run_scanned(3): one staging of three rounds, fresh adapters drawn
    for every round of a task before its first sync (as the serial
    server draws them), run without the host between rounds. It equals
    the fused engine's three rounds run one by one from its own state,
    exactly (records, merged deltas, partials), and holds the
    reference's records and its merged deltas after the last round (a
    tier merges only at its syncs: round 1's merge of partials trained
    from fresh draws). Round 2's partials, trained from the SVD of that
    merge, are held only to the one-by-one rounds: without a round's
    start from the reference's state a difference of 1e-7 grows past
    1e-4 in one round of Adam (ROADMAP, "What one round can be held
    to")."""
    ref = reference(tmp_path_factory, "tier", "ours", ROUNDS)
    sim = port_sim(ref, "fused")
    with reference_svds(sim):
        hist = sim.run_scanned(ROUNDS)
    one = port_run(ref, "fused", pinned=False)
    assert sim.history == hist == one["hist"]
    check_records(ref, hist)
    for srv, o, want in zip(sim.servers, one["sim"].servers,
                            ref["states"][-1]):
        got = server_state(srv, False)
        assert tree_err(got["global"], want["global"]) < 1e-4
        assert np.allclose(got["partial_w"], want["partial_w"], rtol=1e-5)
        assert np.array_equal(got["partial_age"], want["partial_age"])
        for x, y in zip(leaves([srv.merged, srv.partials]),
                        leaves([o.merged, o.partials])):
            assert torch.equal(x, y)
