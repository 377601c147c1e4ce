"""Semi-synchronous participation on a multi-RSU tier in the port
against the reference's serial run, on the CPU: three rounds of the
paper's method with ``test_torch_tier.py``'s ``dense-rsu`` tier and
``test_torch_participation.py``'s spec and outage windows, under
``serial`` and ``fused``, with the checks and tolerances of
``test_torch_tier.py`` collected here over this file's runs.

A release lands at its destination RSU's partial: in round 1, a sync
round, task 1 releases the upload one vehicle deferred in round 0; in
round 2 task 0 releases one into a partial that then waits for the next
sync. Uploads defer in rounds 0 and 1.
"""
import pytest

from test_torch_sim import one_torch_thread  # noqa: F401
from test_torch_tier import (  # noqa: F401  (fixtures and tests)
    port_run, reference, test_plans_match_reference,
    test_records_match_reference, test_server_states_match_reference)

ROUNDS = 3


@pytest.fixture(scope="module", params=["serial", "fused"])
def runs(request, tmp_path_factory):
    ref = reference(tmp_path_factory, "tier+semi", "ours", ROUNDS)
    return ref, port_run(ref, request.param)


def test_releases_land_in_partials(runs):
    """Deferrals in rounds 0 and 1, releases in rounds 1 and 2; round 2's
    release refreshes task 0's partial, whose weight then holds the
    release's discounted weight besides the live uploads."""
    _, run = runs
    hist, states = run["hist"], run["states"]
    deferred = [sum(t["deferred"] for t in r["tasks"]) for r in hist]
    released = [[t["released"] for t in r["tasks"]] for r in hist]
    assert deferred[0] > 0 and deferred[1] > 0
    assert released == [[0, 0, 0], [0, 1, 0], [1, 0, 0]]
    rel = hist[2]["tasks"][0]["rel_weight"]
    assert rel > 0 and any(abs(w - round(w)) > 0 and w > rel
                           for w in states[2][0]["partial_w"])
