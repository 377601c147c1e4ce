"""``ours_no_energy`` (the paper's ablation without Algorithm 1) on a
multi-RSU tier with semi-synchronous participation, in the port against
the reference's serial run, on the CPU: two rounds of
``test_torch_tier.py``'s ``dense-rsu`` tier with
``test_torch_participation.py``'s spec and outage windows, under
``serial``, ``batched`` and ``fused``, with the checks and tolerances of
``test_torch_tier.py`` collected here over this file's runs (plans,
records, and the servers' partials, buffer and merged deltas, each
round from the reference's state).

The ablation keeps §IV-E, so departing vehicles still defer their
uploads; its budgets stay as initialised while the tier charges the
handoffs against them. ``ours_no_mobility``:
``test_torch_modes_no_mobility.py``.
"""
import numpy as np
import pytest

from test_torch_sim import one_torch_thread  # noqa: F401
from test_torch_tier import (  # noqa: F401  (fixtures and tests)
    KW, port_run, reference, test_plans_match_reference,
    test_records_match_reference, test_server_states_match_reference)

METHOD = "ours_no_energy"
ROUNDS = 2


@pytest.fixture(scope="module", params=["serial", "batched", "fused"])
def runs(request, tmp_path_factory):
    ref = reference(tmp_path_factory, "tier+semi", METHOD, ROUNDS)
    return ref, port_run(ref, request.param)


def test_modes_take_the_ablation(runs):
    """Round 1 syncs every task's partials into its first global model,
    a handoff is charged, departing vehicles defer their uploads and one
    comes back; the budgets never move."""
    _, run = runs
    hist, states = run["hist"], run["states"]
    assert all(st["global"] is None for st in states[0])
    assert all(st["global"] is not None for st in states[1])
    assert any(t["handoffs"] for r in hist for t in r["tasks"])
    assert sum(t["deferred"] for r in hist for t in r["tasks"]) > 0
    assert sum(t["released"] for r in hist for t in r["tasks"]) > 0
    assert np.array_equal(hist[0]["budgets"], hist[-1]["budgets"])
    assert len(hist[0]["tasks"]) == KW["num_tasks"]
