"""The paper's energy ablation (its Table III: ``ours_no_energy``,
without Algorithm 1) in the port's simulator against the reference's,
on the CPU, under every engine it runs: ``serial``, ``batched``,
``batched_check``, ``fused``, ``fused_check`` and ``run_scanned``; and
the engine and option rules of every method.

``test_torch_sim.py``'s two rounds on the reference's draws, held to the
reference's serial run at ``test_torch_baselines.py``'s tolerances,
whose checks are collected here over this file's runs. At this config
one vehicle of task 0 departs in round 0 and takes §IV-E's early upload,
as under ``ours``. The mobility ablation: ``test_torch_ablation_mobility.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.config import (EnergyAllocConfig, ParticipationSpec,
                                RSUTierSpec)
from repro_torch.core import energy_alloc
from repro_torch.federated.baselines import METHODS
from repro_torch.optim.adam import leaves
from repro_torch.sim.simulator import IoVSimulator, SimConfig
from test_torch_baselines import (  # noqa: F401  (fixtures and tests)
    port_runs, reference, test_accuracy_reward_and_lambda_match,
    test_energy_and_latency_match, test_engine_check_dev_is_exact,
    test_plans_match_reference, test_round_counts_are_exact,
    test_server_state_matches, test_ucb_state_matches)
from test_torch_sim import KW, ROUNDS, _port_sim, one_torch_thread  # noqa: F401

ENGINES = ("serial", "batched", "batched_check", "fused", "fused_check")
ABLATIONS = ("ours_no_energy", "ours_no_mobility")


@pytest.fixture(scope="module",
                params=[("ours_no_energy", e) for e in ENGINES],
                ids=[f"ours_no_energy-{e}" for e in ENGINES])
def runs(request):
    return port_runs(request)


def test_fallback_of_the_departing_vehicle(runs):
    """Task 0's departing vehicle of round 0 takes §IV-E's early upload."""
    _, _, _, _, hist, _ = runs
    t0 = hist[0]["tasks"][0]
    assert t0["departing"] >= 1
    assert t0["fallbacks"] == {0: 1, 1: 0, 2: 0}


def test_allocator_follows_the_energy_scheduler(runs):
    """Without Algorithm 1 the budgets stay as initialised; the serial
    and batched engines leave the allocator untouched, the fused one
    advances its round only (as the reference's engines do)."""
    _, _, _, sim, _, _ = runs
    init = energy_alloc.init_alloc(sim.cfg.energy, sim.cfg.num_tasks)
    assert torch.equal(sim.alloc.budgets, init.budgets)
    assert torch.equal(sim.alloc.difficulty, init.difficulty)
    assert int(sim.alloc.round) == (ROUNDS if sim.fused is not None else 0)


@pytest.mark.parametrize("engine", ["serial", "fused"])
def test_budgets_move_only_with_the_energy_scheduler(engine):
    """Reallocating every round (warmup_q 1): ``ours`` moves the budgets
    after round 0, ``ours_no_energy`` keeps them; the fused engine's
    budgets equal the serial engine's."""
    def budgets(method, eng):
        cfg = SimConfig(**dict(KW, method=method, engine=eng,
                               energy=EnergyAllocConfig(e_total=900.0,
                                                        warmup_q=1)))
        return [r["budgets"] for r in IoVSimulator(cfg, device="cpu")
                .run(ROUNDS)]
    ours, ablated = budgets("ours", engine), budgets("ours_no_energy",
                                                     engine)
    assert ours[1] != ours[0]
    assert ablated == [ablated[0]] * ROUNDS == [ours[0]] * ROUNDS
    if engine == "fused":
        assert np.allclose(ours, budgets("ours", "serial"), rtol=1e-5,
                           atol=0)


def scanned_equals_run_round(method):
    """Two fused rounds staged first and run without the host between
    them equal two rounds run one by one, exactly."""
    jsim, _, _, omega = reference(method)
    one, _ = _port_sim(jsim, omega, method=method, engine="fused")
    hist = one.run(ROUNDS)
    scan, _ = _port_sim(jsim, omega, method=method, engine="fused")
    assert scan.run_scanned(ROUNDS) == hist
    for s, r in zip(scan.servers, one.servers):
        for x, y in zip(leaves(s.merged), leaves(r.merged)):
            assert torch.equal(x, y)
    assert torch.equal(scan.alloc.budgets, one.alloc.budgets)


def test_run_scanned_equals_run_round():
    scanned_equals_run_round("ours_no_energy")


# ---------------------------------------------------------------------------
# Which engines and options each method runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", sorted(METHODS))
def test_fused_engine_takes_the_ours_family_only(method, monkeypatch):
    """An explicit fused engine with another method raises ValueError; a
    fused engine from the environment falls back to batched."""
    fused = method in ("ours",) + ABLATIONS
    cfg = SimConfig(**dict(KW, method=method, engine="fused"))
    if fused:
        assert IoVSimulator(cfg, device="cpu").engine == "fused"
    else:
        with pytest.raises(ValueError, match="does not support"):
            IoVSimulator(cfg, device="cpu")
    monkeypatch.setenv("REPRO_SIM_ENGINE", "fused_check")
    sim = IoVSimulator(dataclasses.replace(cfg, engine=None), device="cpu")
    assert sim.engine == ("fused_check" if fused else "batched")


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("change", [
    {"rsu_tier": RSUTierSpec(num_rsus_per_task=2)},
    {"participation": ParticipationSpec(mode="semi_sync")},
], ids=["two_rsus", "semi_sync"])
def test_tiers_and_semi_sync_raise_for_every_method(method, change):
    """Tiers and semi_sync raise ValueError for every method the
    reference refuses them for, as its servers do (a tier takes the
    ``ours`` family and HetLoRA, semi_sync the ``ours`` family, neither
    the residual rule), and build for the others."""
    cfg = dataclasses.replace(SimConfig(**dict(KW, method=method)),
                              **change)
    tier = "rsu_tier" in change
    refused = (method in ("homolora", "fedra", "ours_residual") if tier
               else method not in ("ours",) + ABLATIONS)
    if refused:
        with pytest.raises(ValueError, match="residual|multi-RSU|semi_sync"):
            IoVSimulator(cfg, device="cpu")
    else:
        sim = IoVSimulator(cfg, device="cpu")
        assert all((s.tier if tier else s.participation) == change[
            "rsu_tier" if tier else "participation"] for s in sim.servers)
