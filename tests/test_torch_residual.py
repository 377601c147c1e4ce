"""``ours_residual`` (residual aggregation: the retained merged deltas
plus the clients' increments over what they were sent) in the port's
simulator against the reference's, on the CPU.

``test_torch_sim.py``'s two rounds under ``serial``, ``batched`` and
``batched_check``, on the reference's draws, held to the reference's
serial run at ``test_torch_baselines.py``'s tolerances, whose checks are
collected here over this file's runs. The server's residual branch on
its own: ``test_torch_methods.py``.
"""
import pytest

from test_torch_baselines import (  # noqa: F401  (fixtures and tests)
    port_runs, test_accuracy_reward_and_lambda_match,
    test_energy_and_latency_match, test_engine_check_dev_is_exact,
    test_plans_match_reference, test_round_counts_are_exact,
    test_server_state_matches, test_ucb_state_matches)
from test_torch_sim import one_torch_thread  # noqa: F401

ENGINES = ("serial", "batched", "batched_check")


@pytest.fixture(scope="module", params=[("ours_residual", e)
                                        for e in ENGINES],
                ids=[f"ours_residual-{e}" for e in ENGINES])
def runs(request):
    return port_runs(request)


def test_residual_branch_fired(runs):
    """ours_residual keeps the §IV-E fallbacks of ``ours`` (round 0: one
    departing vehicle of task 0 takes one) and the trees it distributed
    in the last round, the bases of its increments. (At this config the
    increments give the replace rule's state: every round-1 vehicle
    gets the rank-4 factors of a round-0 delta of rank at most 4;
    ``test_grouped_residual_aggregation_matches_list_path`` holds a case
    where they differ.)"""
    _, _, _, sim, hist, _ = runs
    assert all(s.residual and s.method == "ours" for s in sim.servers)
    assert hist[0]["tasks"][0]["fallbacks"] == {0: 1, 1: 0, 2: 0}
    for t, s in enumerate(sim.servers):
        assert len(s._distributed) == hist[-1]["tasks"][t]["active"]
