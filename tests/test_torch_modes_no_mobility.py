"""``ours_no_mobility`` (the paper's ablation without §IV-E) on a
multi-RSU tier with semi-synchronous participation, in the port against
the reference's serial run, on the CPU: two rounds of
``test_torch_tier.py``'s ``dense-rsu`` tier with
``test_torch_participation.py``'s spec and outage windows, under
``serial``, ``batched`` and ``fused``, with the checks and tolerances of
``test_torch_tier.py`` collected here over this file's runs (plans,
records, and the servers' partials, buffer and merged deltas, each
round from the reference's state).

Without §IV-E a departing vehicle's upload is lost: nothing defers, so
the buffer stays empty under semi_sync, while the tier still syncs and
charges handoffs. ``ours_no_energy``: ``test_torch_modes_no_energy.py``.
"""
import pytest

from test_torch_sim import one_torch_thread  # noqa: F401
from test_torch_tier import (  # noqa: F401  (fixtures and tests)
    port_run, reference, test_plans_match_reference,
    test_records_match_reference, test_server_states_match_reference)

METHOD = "ours_no_mobility"
ROUNDS = 2


@pytest.fixture(scope="module", params=["serial", "batched", "fused"])
def runs(request, tmp_path_factory):
    ref = reference(tmp_path_factory, "tier+semi", METHOD, ROUNDS)
    return ref, port_run(ref, request.param)


def test_modes_take_the_ablation(runs):
    """Round 1 syncs every task's partials into its first global model
    and a handoff is charged; vehicles depart, but no upload defers or
    comes back, no fallback is counted and the buffer stays empty."""
    _, run = runs
    hist, states = run["hist"], run["states"]
    assert all(st["global"] is None for st in states[0])
    assert all(st["global"] is not None for st in states[1])
    assert any(t["handoffs"] for r in hist for t in r["tasks"])
    assert any(t["departing"] for r in hist for t in r["tasks"])
    for rec in hist:
        for t in rec["tasks"]:
            assert t["deferred"] == t["released"] == 0
            assert t["fallbacks"] == {0: 0, 1: 0, 2: 0}
    assert all(not st["buffer"] for sts in states for st in sts)
