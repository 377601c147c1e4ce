"""The paper's mobility ablation (its Table III: ``ours_no_mobility``,
without the §IV-E fallbacks) in the port's simulator against the
reference's, on the CPU, under every engine it runs: ``serial``,
``batched``, ``batched_check``, ``fused``, ``fused_check`` and
``run_scanned``.

``test_torch_sim.py``'s two rounds on the reference's draws, held to the
reference's serial run at ``test_torch_baselines.py``'s tolerances,
whose checks are collected here over this file's runs. At this config
one vehicle of task 0 departs in round 0 and loses its upload, so task 0
keeps one rank-2 upload and its round 1 redistributes that delta at rank
4 (see ``test_torch_baselines.py::_undetermined``).
"""
import pytest

from repro_torch.core import cost_model as cm
from test_torch_ablation_energy import scanned_equals_run_round
from test_torch_baselines import (  # noqa: F401  (fixtures and tests)
    port_runs, test_accuracy_reward_and_lambda_match,
    test_energy_and_latency_match, test_engine_check_dev_is_exact,
    test_plans_match_reference, test_round_counts_are_exact,
    test_server_state_matches, test_ucb_state_matches)
from test_torch_sim import ROUNDS, one_torch_thread  # noqa: F401

ENGINES = ("serial", "batched", "batched_check", "fused", "fused_check")


@pytest.fixture(scope="module",
                params=[("ours_no_mobility", e) for e in ENGINES],
                ids=[f"ours_no_mobility-{e}" for e in ENGINES])
def runs(request):
    return port_runs(request)


def test_departures_lose_the_upload(runs):
    """No fallback is counted and a departing vehicle's upload is lost
    (round 0's comm_params: the staying vehicles' rank-2 payloads)."""
    _, _, _, sim, hist, _ = runs
    t0 = hist[0]["tasks"][0]
    assert t0["departing"] >= 1
    for rec in hist:
        for t in rec["tasks"]:
            assert t["fallbacks"] == {0: 0, 1: 0, 2: 0}
    kept = t0["active"] - t0["departing"]
    assert t0["comm_params"] == kept * cm.adapter_payload_params(
        sim.cost_dims, 2)


def test_allocator_steps(runs):
    """Algorithm 1 runs as under ``ours``."""
    _, _, _, sim, _, _ = runs
    assert int(sim.alloc.round) == ROUNDS


def test_run_scanned_equals_run_round():
    scanned_equals_run_round("ours_no_mobility")
