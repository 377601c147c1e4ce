"""Two of the paper's baselines (HomoLoRA, HetLoRA; its Table I) in the
port's simulator against the reference's, on the CPU (FedRA:
``test_torch_fedra.py``).

``test_torch_sim.py``'s config (6 vehicles, 2 tasks, 2 local steps, 2
rounds) under each baseline: the reference's serial run once per method,
the port's under ``serial``, ``batched`` and ``batched_check``, each held
to it. The reference's ``jax.random`` draws go to the port: the base
weights, each server's fresh adapters and FedRA's layer masks, drawn
from the server's one key in the reference's order. Round 1
redistributes round 0's global adapters, so two rounds show each server
rule. Tolerances are ``test_torch_sim.py``'s: ranks, active sets,
departures, fallbacks, comm_params and budgets exactly; energy and
latency 1e-5 relative; accuracy and the servers' state 1e-4.

The engine-generic checks are ``test_torch_sim.py``'s, collected here
over this file's runs; this file's own are collected again by
``test_torch_fedra.py``, ``test_torch_ablations.py`` and
``test_torch_methods.py`` over theirs (the reference's runs take ~6-14 s
each, so the methods are spread over files that the suite's workers
take one each).
"""
import functools

import numpy as np
import pytest

from repro_torch.core import cost_model as cm
from repro_torch.core.aggregation import (tree_get, tree_paths,
                                          tree_paths_delta)
from test_torch_sim import (  # noqa: F401  (fixtures and tests)
    KW, ROUNDS, _omega_ref, _port_run, _reference_run, one_torch_thread,
    test_accuracy_reward_and_lambda_match, test_energy_and_latency_match,
    test_round_counts_are_exact, test_ucb_state_matches)

ENGINES = ("serial", "batched", "batched_check")
METHODS = ("homolora", "hetlora")


@functools.lru_cache(maxsize=None)
def reference(method):
    """The reference's serial run of KW under ``method`` (once per
    method and worker) and the sketch draw it shares with the port."""
    return _reference_run(method) + (_omega_ref(),)


def port_runs(request):
    """(reference sim, history, plans, port sim, history, plans) of the
    port under ``request.param`` = (method, engine)."""
    method, engine = request.param
    jsim, jhist, jplans, omega = reference(method)
    return (jsim, jhist, jplans) + _port_run(jsim, omega, method=method,
                                              engine=engine)


@pytest.fixture(scope="module",
                params=[(m, e) for m in METHODS for e in ENGINES],
                ids=[f"{m}-{e}" for m in METHODS for e in ENGINES])
def runs(request):
    return port_runs(request)


def test_plans_match_reference(runs):
    """Active sets, ranks and departures of every task and round."""
    _, _, jplans, _, _, plans = runs
    assert len(plans) == ROUNDS * KW["num_tasks"]
    assert plans == jplans


def _max_rel(got, want) -> float:
    """Largest |got - want| over the largest |want| of one leaf."""
    got, want = got.detach().cpu().numpy(), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / max(
        1.0, float(np.max(np.abs(want))))


def _state_err(got, want) -> float:
    """Largest _max_rel over the leaves of two server states (merged
    deltas or adapters), leaf by path."""
    paths = tree_paths_delta(want) or tree_paths(want)
    assert sorted(paths) == sorted(tree_paths_delta(got) or tree_paths(got))
    return max(_max_rel(tree_get(got, p)[k], w)
               for p in paths for k, w in tree_get(want, p).items())


def _undetermined(sim, hist, plans, t) -> bool:
    """Whether task t's last round trained ``ours``' factors that no
    implementation fixes: it redistributed, at a rank above the round
    before's merged delta's, a delta whose SVD then has zero singular
    values, whose vectors are any basis of the null space (the two
    packages' QR and SVD give different ones). The bound on that rank:
    the kept clients' ranks summed, comm_params over one rank's
    payload."""
    if sim.servers[t].method != "ours" or len(hist) < 2:
        return False
    per_rank = cm.adapter_payload_params(sim.cost_dims, 1)
    bound = hist[-2]["tasks"][t]["comm_params"] // per_rank
    last = [rs for ti, _, rs, _ in plans[-sim.cfg.num_tasks:] if ti == t][0]
    return 0 < bound < max(last, default=0)


def test_server_state_matches(runs):
    """The ``ours`` family's merged deltas, or the baselines' global
    adapters, as each round found them and after the last; FedRA's masks
    of the kept clients. A task whose last round redistributed a
    rank-deficient delta above its rank (see :func:`_undetermined`;
    ``ours_no_mobility``'s task 0 here, one upload kept in round 0) has
    its final state held only in the rounds before."""
    jsim, jhist, _, sim, hist, plans = runs
    for rnd, (got, want) in enumerate(zip(sim.round_states,
                                          jsim.round_states)):
        for t, (g, w) in enumerate(zip(got, want)):
            assert (g is None) == (w is None), (rnd, t)
            if w is not None:
                assert _state_err(g, w) < 1e-4, (rnd, t)
    for t, (js, s) in enumerate(zip(jsim.servers, sim.servers)):
        assert s.method == js.method and s.residual == js.residual
        assert s.round == js.round == ROUNDS
        if s.method == "ours":
            got, want = s.merged, js.merged
        else:
            got, want = s.global_adapters, js.global_adapters
        if _undetermined(sim, hist, plans, t):
            assert _undetermined(jsim, jhist, plans, t)
            assert sim.cfg.method == "ours_no_mobility" and t == 0
        else:
            assert _state_err(got, want) < 1e-4, t
        assert len(s.masks) == len(js.masks)
        for m, jm in zip(s.masks, js.masks):
            assert np.array_equal(np.asarray(m), np.asarray(jm))


def test_engine_check_dev_is_exact(runs):
    """The batched and fused engines replay the serial trainer bit for
    bit on the CPU (0 where nothing was checked)."""
    _, _, _, sim, _, _ = runs
    assert sim.engine_check_dev == 0.0


# ---------------------------------------------------------------------------
# Each baseline's own branches fired
# ---------------------------------------------------------------------------

def test_departures_lose_the_upload(runs):
    """Without §IV-E a departing vehicle's upload is lost and no fallback
    is counted; at KW one vehicle of task 0 departs in round 0. HomoLoRA
    and FedRA upload one rank-8 payload (FedRA 0.6 of it) per kept
    vehicle."""
    _, _, _, sim, hist, _ = runs
    t0 = hist[0]["tasks"][0]
    assert t0["departing"] >= 1 and t0["active"] > t0["departing"]
    for rec in hist:
        for t in rec["tasks"]:
            assert t["fallbacks"] == {0: 0, 1: 0, 2: 0}
            assert t["lambda"] == 0.0
    if sim.cfg.method != "hetlora":
        kept = t0["active"] - t0["departing"]
        payload = cm.adapter_payload_params(sim.cost_dims, sim.cfg.lora.rank)
        if sim.cfg.method == "fedra":
            payload = int(payload * sim.servers[0].fedra_fraction)
        assert t0["comm_params"] == kept * payload


def test_baseline_ranks(runs):
    """HomoLoRA and FedRA train at lora.rank; HetLoRA at each vehicle's
    capability rank, more than one rank group in a task."""
    _, _, _, sim, hist, plans = runs
    ranks = [r for _, _, rs, _ in plans for r in rs]
    if sim.cfg.method == "hetlora":
        assert any(len(set(rs)) > 1 for _, _, rs, _ in plans)
        assert any(9 <= t["mean_rank"] <= 10 for rec in hist
                   for t in rec["tasks"])
        assert all(r == sim._het_ranks[v] for _, ids, rs, _ in plans
                   for v, r in zip(ids, rs))
    else:
        assert set(ranks) == {sim.cfg.lora.rank}


def test_fedra_layer_masks(runs):
    """FedRA's servers hold one mask of round(0.6·L) layers per kept
    vehicle; the other baselines' hold none."""
    _, _, _, sim, _, _ = runs
    L = sim.model_cfg.num_layers
    for s in sim.servers:
        if sim.cfg.method != "fedra":
            assert s.masks == []
            continue
        assert s.masks
        for m in s.masks:
            assert tuple(m.shape) == (L,)
            assert float(m.sum()) == max(1, round(0.6 * L))
