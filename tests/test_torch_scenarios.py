"""The port's scenario presets (``repro_torch.sim.scenarios``) against
the reference's, on the CPU.

The registry (names, descriptions) and every preset's config fingerprint
equal the reference's; every preset's mobility, built as the simulator
builds it (RSU layout and tier, trace or online dynamics, outages), equals
the reference's bit for bit over its horizon and past it, where the trace
wraps: positions, presence, and per task ``round_view_group``'s active
set, association and handoffs. Then one round of ``rush-hour`` (a dynamic
fleet) and of ``handoff-storm`` (a 4-RSU tier on a corridor) in both
packages at a 2-layer d-32 ViT with the reference's draws injected (as in
``test_torch_sim.py``), the port under ``batched`` and ``fused`` against
the reference's serial round: active sets, ranks, departures, handoffs,
fallbacks and comm_params exact; energy and latency within 1e-5 relative;
no absent vehicle trains.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.checkpoint import config_fingerprint as jfingerprint
from repro.config import LoRAConfig as JLoRAConfig
from repro.configs import vit_base_paper as jvit
from repro.sim import scenarios as jscenarios
from repro.sim.mobility_model import MobilityModel as JMobilityModel
from repro_torch import interop
from repro_torch.checkpoint import config_fingerprint
from repro_torch.config import LoRAConfig, ParticipationSpec
from repro_torch.configs import vit_base_paper
from repro_torch.sim import scenarios
from repro_torch.sim.mobility_model import MobilityModel
from test_torch_sim import (_np, _omega_ref, _recording, _server_draw,  # noqa: F401
                            one_torch_thread)

TINY = dict(name="vit-test-scn", num_layers=2, d_model=32, num_heads=2,
            num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64)
LORA = LoRAConfig(rank=4, max_rank=8, candidate_ranks=(2, 4, 8))
JLORA = JLoRAConfig(rank=4, max_rank=8, candidate_ranks=(2, 4, 8))
HORIZON = 6
SEED = 1
NAMES = scenarios.list_scenarios()


def _configs(name, tiny=False, **over):
    """The preset's config in the port and in the reference (``tiny``:
    with the test ViT and LoRA)."""
    jover = dict(over)
    if tiny:
        over.update(lora=LORA, train_arch=vit_base_paper.vit_base_paper()
                    .with_overrides(**TINY))
        jover.update(lora=JLORA, train_arch=jvit.vit_base_paper()
                     .with_overrides(**TINY))
    return (scenarios.build_config(name, rounds=HORIZON, seed=SEED, **over),
            jscenarios.build_config(name, rounds=HORIZON, seed=SEED,
                                    **jover))


def test_registry_equals_the_reference():
    assert NAMES == jscenarios.list_scenarios()
    assert len(NAMES) == 7
    for n in NAMES:
        sc, jsc = scenarios.get_scenario(n), jscenarios.get_scenario(n)
        assert (sc.name, sc.description) == (jsc.name, jsc.description)
    with pytest.raises(KeyError, match="unknown scenario"):
        scenarios.get_scenario("does-not-exist")


@pytest.mark.parametrize("name", NAMES)
def test_preset_fingerprint_equals_the_reference(name):
    for over in ({}, {"participation": "semi-sync"},
                 {"tiny": True, "num_vehicles": 6}):
        cfg, jcfg = _configs(name, **over)
        assert cfg.scenario == name and cfg.rounds == HORIZON
        assert cfg.mobility_sim.trace.length == HORIZON + 1
        assert config_fingerprint(cfg) == jfingerprint(jcfg), over
    full = scenarios.build_config(
        name, train_arch=vit_base_paper.vit_base_paper())
    jfull = jscenarios.build_config(
        name, train_arch=jvit.vit_base_paper())
    assert config_fingerprint(full) == jfingerprint(jfull)


def test_overrides_and_participation_sugar_flow_through():
    cfg = scenarios.build_config("urban-grid", num_vehicles=6, num_tasks=2,
                                 participation="semi-sync")
    assert (cfg.num_vehicles, cfg.num_tasks) == (6, 2)
    assert cfg.energy.e_total == pytest.approx(110.0 * 6 * 2)
    assert cfg.participation == ParticipationSpec(mode="semi_sync")
    assert scenarios.build_config("dense-rsu").rsu_tier.num_rsus_per_task == 3
    assert scenarios.build_config("rsu-outage", rounds=9).mobility_sim \
        .outages[0].start == 3


def _mobility(cfg, model):
    """The preset's mobility as the simulator builds it."""
    ms = dataclasses.replace(cfg.mobility_sim, num_vehicles=cfg.num_vehicles,
                             seed=cfg.seed)
    rsus = model.place_rsus(cfg.num_tasks, ms.area, ms.coverage_radius,
                            seed=cfg.seed, layout=ms.rsu_layout,
                            num_per_task=cfg.rsu_tier.num_rsus_per_task)
    m = model(ms, rsus)
    return m, [[r for r in rsus if r.task_id == t]
               for t in range(cfg.num_tasks)]


@pytest.mark.parametrize("name", NAMES)
def test_preset_mobility_equals_the_reference(name):
    cfg, jcfg = _configs(name)
    (m, groups), (jm, jgroups) = (_mobility(cfg, MobilityModel),
                                  _mobility(jcfg, JMobilityModel))
    assert [[r.xy for r in g] for g in groups] == \
        [[r.xy for r in g] for g in jgroups]
    varied = set()
    for _ in range(HORIZON + 4):       # past the trace's end: it wraps
        m.step()
        jm.step()
        assert np.array_equal(m.pos, jm.pos)
        assert np.array_equal(m.present, jm.present)
        for g, jg in zip(groups, jgroups):
            view, jview = m.round_view_group(g), jm.round_view_group(jg)
            for k in ("active", "departing", "assoc", "handoff",
                      "distances"):
                assert np.array_equal(view[k], jview[k]), (k, m.tick)
            assert not np.any(view["active"] & ~m.present)
            varied.add(int(view["active"].sum()))
    assert len(varied) > 1


# ---------------------------------------------------------------------------
# One round against the reference
# ---------------------------------------------------------------------------

ROUND_PRESETS = ("rush-hour", "handoff-storm")
KW = dict(local_steps=1)


@pytest.fixture(scope="module")
def reference_rounds():
    """The reference's serial round 0 of each preset: (sim, record,
    plans), and the draws the port gets."""
    out = {}
    for name in ROUND_PRESETS:
        jsim = jscenarios.build_sim(
            name, rounds=HORIZON, seed=SEED, engine="serial",
            train_arch=jvit.vit_base_paper().with_overrides(**TINY),
            lora=JLORA, **KW)
        plans = []
        _recording(jsim, plans)
        out[name] = (jsim, jsim.run_round(), plans)
    return out, _omega_ref()


@pytest.fixture(scope="module", params=[
    (n, e) for n in ROUND_PRESETS for e in ("batched", "fused")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def rounds(request, reference_rounds):
    name, engine = request.param
    refs, omega = reference_rounds
    jsim, jrec, jplans = refs[name]
    jcfg = jsim.model_cfg
    draws = [_server_draw(SEED + 7 * t, jcfg, JLORA)
             for t in range(jsim.cfg.num_tasks)]
    sim = scenarios.build_sim(
        name, rounds=HORIZON, seed=SEED, device="cpu", engine=engine,
        train_arch=vit_base_paper.vit_base_paper().with_overrides(**TINY),
        lora=LORA, params=interop.params_from_jax(_np(jsim.params),
                                                  device="cpu"),
        server_draws=[d for d, _ in draws],
        mask_draws=[mk for _, mk in draws], draw_omega=omega, **KW)
    plans = []
    _recording(sim, plans)
    present = []
    step = sim.mobility.step

    def spy():
        step()
        present.append(sim.mobility.present.copy())
    sim.mobility.step = spy
    return jrec, jplans, sim.run_round(), plans, present[0]


def test_round_plans_are_exact_and_absent_vehicles_do_not_train(rounds):
    _, jplans, _, plans, present = rounds
    assert plans == jplans
    for _, ids, _, _ in plans:
        assert present[ids].all()
    assert sum(len(ids) for _, ids, _, _ in plans) > 0


def test_round_counts_are_exact(rounds):
    jrec, _, rec, _, _ = rounds
    keys = ("active", "departing", "handoffs", "fallbacks", "comm_params",
            "mean_rank", "task", "budget")
    for jt, t in zip(jrec["tasks"], rec["tasks"]):
        assert {k: t[k] for k in keys} == {k: jt[k] for k in keys}
    assert rec["budgets"] == jrec["budgets"]


def test_round_energy_and_latency_match(rounds):
    jrec, _, rec, _, _ = rounds
    for jt, t in zip(jrec["tasks"] + [jrec], rec["tasks"] + [rec]):
        for k in ("energy", "latency"):
            assert abs(t[k] - jt[k]) <= 1e-5 * max(abs(jt[k]), 1e-12), k
        assert abs(t["accuracy"] - jt["accuracy"]) < 1e-4


def test_build_sim_runs_on_the_requested_device():
    sim = scenarios.build_sim(
        "sparse-rural", rounds=3, device="cpu", num_vehicles=4,
        train_arch=vit_base_paper.vit_base_paper().with_overrides(**TINY),
        lora=LORA, local_steps=1)
    assert sim.device == torch.device("cpu")
    assert sim.cfg.scenario == "sparse-rural"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            scenarios.build_sim("sparse-rural", rounds=3)
