"""HetLoRA on a multi-RSU tier in the port against the reference's serial
run, on the CPU, under ``serial``, ``batched`` and ``batched_check`` (the
fused engine takes the ``ours`` family only, as in the reference):
``test_torch_tier.py``'s three rounds on the ``dense-rsu`` tier, whose
checks are collected here over this file's runs, at its tolerances.

Each RSU's partial is the zero-padding factor average of its uploads at
max_rank; the sync merges the partials' factors. The global adapters
exist from round 0 (the server's fresh draw that it distributes), so
every round evaluates one.
"""
import pytest

from test_torch_sim import one_torch_thread  # noqa: F401
from test_torch_tier import (  # noqa: F401  (fixtures and tests)
    KW, ROUNDS, port_run, reference, test_engine_check_dev_is_exact,
    test_plans_match_reference, test_records_match_reference,
    test_server_states_match_reference)


@pytest.fixture(scope="module", params=["serial", "batched",
                                        "batched_check"])
def runs(request, tmp_path_factory):
    ref = reference(tmp_path_factory, "tier", "hetlora", ROUNDS)
    return ref, port_run(ref, request.param)


def test_partials_are_factor_trees_at_max_rank(runs):
    """Round 0 fills two or more partials per task, each an {a, b} tree
    zero-padded to max_rank; round 1 merges them into the global
    adapters and opens a new window."""
    _, run = runs
    R = run["sim"].cfg.lora.max_rank
    for t in range(KW["num_tasks"]):
        st0, st1 = run["states"][0][t], run["states"][1][t]
        live = [p for p, w in zip(st0["partials"], st0["partial_w"]) if w]
        assert len(live) >= 2
        for p in live:
            ad = p["segments"][0]["attn"]["q"]
            assert ad["a"].shape[-1] == R and ad["b"].shape[-2] == R
        assert st1["partial_w"].sum() == 0.0
        assert st1["global"]["segments"][0]["attn"]["q"]["a"].shape[-1] == R


def test_capability_ranks_and_a_handoff(runs):
    """HetLoRA's capability ranks (more than one per task) and task 1's
    two handoffs of round 1."""
    _, run = runs
    assert any(len(set(rs)) > 1 for _, _, rs, _ in run["plans"])
    assert [r["tasks"][1]["handoffs"] for r in run["hist"]] == [0, 2, 0]
