"""Two federated rounds of the paper's method in the port's simulator
against the reference's, on the CPU.

One config, ``SimConfig(method="ours", engine="serial", num_vehicles=6,
num_tasks=2, local_steps=2)``, in both packages; the port also runs it
under ``engine="batched"`` and ``engine="fused"`` (eager on the CPU),
each held to the same reference run (the reference's own suite pins its
batched and fused engines to its serial one). The
reference's ``jax.random`` draws are handed to the port: the base
weights (``params=``), each server's fresh adapters (``server_draws``)
and the SVD sketch Ω (``draw_omega``); everything else is the same numpy
streams in both. Round 1 redistributes round 0's merged deltas through
the SVD.

Tolerances: ranks, active sets, departures, fallbacks and comm_params
exactly equal; energy and latency 1e-5 relative (host float64 over the
same channel draws: they differ only if an active set or rank differs);
accuracy and the servers' merged deltas 1e-4 (f32 training through two
GEMM libraries).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vit_base_paper as jvit
from repro.core import aggregation as jagg
from repro.models import transformer as JT
from repro.sim.simulator import IoVSimulator as JSimulator
from repro.sim.simulator import SimConfig as JSimConfig
from repro.config import ShardSpec as JShardSpec
from repro_torch import interop
from repro_torch.config import (CheckpointSpec, ParticipationSpec,
                                RSUTierSpec, ShardSpec, TraceSpec)
from repro_torch.core.aggregation import tree_get, tree_paths_delta
from repro_torch.sim.mobility_model import MobilitySimConfig
from repro_torch.sim.simulator import IoVSimulator, SimConfig

ROUNDS = 2
KW = dict(method="ours", engine="serial", num_vehicles=6, num_tasks=2,
          local_steps=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The reduced ViT's tensors are tiny; with the suite's parallel
    workers each running a full intra-op thread pool, the workers'
    threads spin on oversubscribed cores. One thread per worker,
    restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _recording(sim, plans):
    """Wrap the simulator's planner to keep each task's active set and
    ranks. The fused engine has no host planner: its active sets and
    departures come from the staged inputs, its ranks from the arm each
    vehicle's UCB-DUAL count moved on."""
    if getattr(sim, "fused", None) is not None:
        _recording_fused(sim, plans)
        return
    plan_task = sim._plan_task

    def plan(ti):
        p = plan_task(ti)
        plans.append((int(ti), p["active_ids"].tolist(),
                      [int(p["ranks"][v]) for v in p["active_ids"]],
                      np.asarray(p["departing"]).tolist()))
        return p
    sim._plan_task = plan


def _recording_fused(sim, plans):
    eng, staged = sim.fused, []
    stage, run_round = eng._stage_round, sim.run_round

    def stage_spy(*a, **kw):
        out = stage(*a, **kw)
        staged.append(out[0])
        return out
    eng._stage_round = stage_spy

    def rr():
        before = [s.counts.clone() for s in sim.ucb_states]
        rec = run_round()
        x, cand = staged[-1], sim.cfg.lora.candidate_ranks
        for ti in range(sim.cfg.num_tasks):
            ids = np.where(x["active"][ti])[0]
            arms = torch.argmax(sim.ucb_states[ti].counts - before[ti], -1)
            plans.append((ti, ids.tolist(),
                          [int(cand[int(arms[v])]) for v in ids],
                          x["departing"][ti].astype(bool).tolist()))
        return rec
    sim.run_round = rr


def _keep_round_states(sim):
    """Wrap run_round to keep the servers' state as each round finds it
    (``ours``: merged deltas; the baselines: global adapters) in
    ``sim.round_states``."""
    sim.round_states = []
    run_round = sim.run_round

    def rr():
        sim.round_states.append([
            s.merged if s.method == "ours" else s.global_adapters
            for s in sim.servers])
        return run_round()
    sim.run_round = rr


def _server_draw(seed, cfg, lora):
    """The reference server's two draws from its one key: the fresh
    adapters (server.py _fresh) and FedRA's layer masks (distribute),
    closed over one key cell, so that the splits come in the reference's
    order whichever draw the server asks for."""
    key = [jax.random.PRNGKey(seed)]

    def draw():
        key[0], k = jax.random.split(key[0])
        return interop.adapters_from_jax(
            _np(JT.init_adapters(k, cfg, lora, rank=lora.max_rank)),
            device="cpu")

    def draw_mask():
        key[0], k = jax.random.split(key[0])
        return np.asarray(jagg.fedra_layer_mask(k, cfg.num_layers, 0.6))
    return draw, draw_mask


def _omega_ref():
    cache = {}

    def draw(seed, d2, r):
        if (seed, d2, r) not in cache:
            cache[(seed, d2, r)] = torch.from_numpy(np.array(
                jax.random.normal(jax.random.PRNGKey(seed), (d2, r),
                                  jnp.float32)))
        return cache[(seed, d2, r)]
    return draw


def _port_sim(jsim, omega, **change):
    """The port's simulator of KW (with ``change``) on the reference's
    draws, recording its plans."""
    jcfg, jlora = jvit.reduced(), jsim.cfg.lora
    draws = [_server_draw(7 * t, jcfg, jlora)
             for t in range(KW["num_tasks"])]
    sim = IoVSimulator(
        SimConfig(**dict(KW, **change)), device="cpu",
        params=interop.params_from_jax(_np(jsim.params), device="cpu"),
        server_draws=[d for d, _ in draws],
        mask_draws=[m for _, m in draws], draw_omega=omega)
    plans = []
    _recording(sim, plans)
    _keep_round_states(sim)
    return sim, plans


def _port_run(jsim, omega, **change):
    """The port's run of KW (with ``change``) on the reference's draws."""
    sim, plans = _port_sim(jsim, omega, **change)
    return sim, sim.run(ROUNDS), plans


def _reference_run(method="ours"):
    """The reference's serial run of KW under ``method``: (sim, history,
    plans)."""
    jsim = JSimulator(JSimConfig(**dict(KW, method=method)))
    jplans = []
    _recording(jsim, jplans)
    _keep_round_states(jsim)
    jhist = [jsim.run_round() for _ in range(ROUNDS)]
    return jsim, jhist, jplans


@pytest.fixture(scope="module")
def reference_and_omega():
    return _reference_run() + (_omega_ref(),)


@pytest.fixture(scope="module", params=["serial", "batched", "fused"])
def runs(request, reference_and_omega):
    """The port under each engine it runs, against the reference's serial
    run: the same draws, the same tolerances."""
    jsim, jhist, jplans, omega = reference_and_omega
    return (jsim, jhist, jplans) + _port_run(jsim, omega,
                                              engine=request.param)


def test_active_sets_ranks_and_departures_are_exact(runs):
    _, _, jplans, _, _, plans = runs
    assert len(plans) == ROUNDS * KW["num_tasks"]
    assert plans == jplans
    # UCB-DUAL explores arms in order: round 0 at rank 2, round 1 at 4
    assert {r for _, _, ranks, _ in plans[:2] for r in ranks} <= {2}
    assert {r for _, _, ranks, _ in plans[2:] for r in ranks} <= {4}


ROUND_KEYS = ["active", "departing", "handoffs", "fallbacks",
              "comm_params", "mean_rank", "task", "budget"]


@pytest.mark.parametrize("key", ROUND_KEYS)
def test_round_counts_are_exact(runs, key):
    _, jhist, _, _, hist, _ = runs
    for jrec, rec in zip(jhist, hist):
        for jt, t in zip(jrec["tasks"], rec["tasks"]):
            assert t[key] == jt[key], (rec["round"], t["task"], key)
        assert rec["budgets"] == jrec["budgets"]


@pytest.mark.parametrize("key", ["energy", "latency"])
def test_energy_and_latency_match(runs, key):
    _, jhist, _, _, hist, _ = runs
    for jrec, rec in zip(jhist, hist):
        for jt, t in zip(jrec["tasks"] + [jrec], rec["tasks"] + [rec]):
            assert abs(t[key] - jt[key]) <= 1e-5 * max(abs(jt[key]), 1e-12)


def test_accuracy_reward_and_lambda_match(runs):
    _, jhist, _, _, hist, _ = runs
    for jrec, rec in zip(jhist, hist):
        assert abs(rec["accuracy"] - jrec["accuracy"]) < 1e-4
        for jt, t in zip(jrec["tasks"], rec["tasks"]):
            assert abs(t["accuracy"] - jt["accuracy"]) < 1e-4
            assert abs(t["reward"] - jt["reward"]) < 2e-4
            assert abs(t["lambda"] - jt["lambda"]) < 1e-6


def test_merged_deltas_match(runs):
    jsim, _, _, sim, _, _ = runs
    for js, s in zip(jsim.servers, sim.servers):
        assert s.round == js.round == ROUNDS
        paths = tree_paths_delta(s.merged)
        assert sorted(paths) == sorted(tree_paths_delta(js.merged))
        for p in paths:
            got = tree_get(s.merged, p)["delta"].numpy()
            want = np.asarray(tree_get(js.merged, p)["delta"])
            assert got.shape == want.shape
            assert float(np.max(np.abs(got - want))) < 1e-4


def test_ucb_state_matches(runs):
    jsim, _, _, sim, _, _ = runs
    for js, s in zip(jsim.ucb_states, sim.ucb_states):
        assert np.array_equal(s.counts.numpy(), np.asarray(js.counts))
        assert abs(float(s.lam) - float(js.lam)) < 1e-6
        assert np.allclose(s.energy_sum.numpy(), np.asarray(js.energy_sum),
                           rtol=1e-5, atol=0)


def test_summary_and_history_shape(runs):
    jsim, _, _, sim, hist, _ = runs
    assert sim.history is hist and len(hist) == ROUNDS
    s, js = sim.summary(), jsim.summary()
    assert sorted(s) == sorted(js)
    assert s["rounds"] == js["rounds"]
    assert s["avg_comm_params"] == js["avg_comm_params"]
    assert sorted(hist[0]) == sorted(jsim.history[0])
    assert sorted(hist[0]["tasks"][0]) == sorted(jsim.history[0]["tasks"][0])
    assert IoVSimulator(SimConfig(**KW), device="cpu").summary()["rounds"] == 0


# ---------------------------------------------------------------------------
# A sharded fleet on one visible device raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("change", [
    {"engine": "fused_sharded"},
    {"shard": ShardSpec(num_shards=2)},
], ids=["fused_sharded", "two_shards"])
def test_unported_options_raise(change):
    """The sharded fleet runs (``tests/test_torch_sharded_engine.py``),
    but the CPU shows one device: ``fused_sharded`` without
    ``fleet_devices`` raises, as the reference does on a host without
    forced devices; a shard spec under KW's explicit serial engine is
    refused, as the reference refuses it."""
    cfg = dataclasses.replace(SimConfig(**KW), **change)
    with pytest.raises(ValueError, match="visible|cannot shard"):
        IoVSimulator(cfg, device="cpu")
    with pytest.raises(ValueError, match="visible|cannot shard"):
        JSimulator(JSimConfig(**dict(
            KW, engine=change.get("engine", KW["engine"]),
            shard=JShardSpec(num_shards=getattr(change.get("shard"),
                                                "num_shards", 1)))))


@pytest.mark.parametrize("option", ["checkpoint", "trace"])
def test_checkpoint_and_trace_options_run(tmp_path, option):
    """Checkpoints and trace replay run (their parity with the reference:
    ``test_torch_resume.py``, ``test_torch_trajectories.py``)."""
    change = ({"checkpoint": CheckpointSpec(interval=1, dir=str(tmp_path))}
              if option == "checkpoint" else
              {"mobility_sim": MobilitySimConfig(trace=TraceSpec(length=3))})
    sim = IoVSimulator(dataclasses.replace(SimConfig(**KW), **change),
                       device="cpu")
    assert len(sim.run(1)) == 1
    if option == "checkpoint":
        assert os.listdir(tmp_path) == ["round_000001.npz"]
    else:
        assert sim.mobility.tick == 1
        assert np.array_equal(sim.mobility.pos,
                              sim.mobility._trace.positions[1])


def test_run_scanned_raises():
    """run_scanned needs a fused engine, as in the reference."""
    sim = IoVSimulator(SimConfig(**KW), device="cpu")
    with pytest.raises(ValueError, match="fused"):
        sim.run_scanned(2)


def test_engine_none_resolves_to_serial(monkeypatch):
    """None takes $REPRO_SIM_ENGINE first, as in the reference."""
    monkeypatch.setenv("REPRO_SIM_ENGINE", "serial")
    sim = IoVSimulator(SimConfig(num_vehicles=4, num_tasks=1), device="cpu")
    assert sim.engine == "serial"
    assert SimConfig().engine is None


def test_engine_none_resolves_to_batched(monkeypatch):
    monkeypatch.delenv("REPRO_SIM_ENGINE", raising=False)
    cfg = SimConfig(num_vehicles=4, num_tasks=1)
    assert IoVSimulator(cfg, device="cpu").engine == "batched"
    assert cfg.engine is None   # resolved on the simulator, not the config
    assert (JSimulator._resolve_engine(JSimConfig(num_vehicles=4))
            == "batched")


@pytest.mark.parametrize("engine", ["fused_sharded"])
def test_unported_engine_from_the_environment_raises(monkeypatch, engine):
    """fused_sharded from the environment on a host that shows one device
    raises, naming the visible devices, rather than run one shard."""
    monkeypatch.setenv("REPRO_SIM_ENGINE", engine)
    with pytest.raises(ValueError, match="visible device"):
        IoVSimulator(SimConfig(**dict(KW, engine=None)), device="cpu")


@pytest.mark.parametrize("engine", ["fused", "fused_check"])
def test_fused_engine_from_the_environment_takes_every_mode(monkeypatch,
                                                            engine):
    """From the environment the fused engines take a tier, semi_sync and
    checkpoints together, with a fused engine's carry to restore into."""
    monkeypatch.setenv("REPRO_SIM_ENGINE", engine)
    sim = IoVSimulator(SimConfig(**dict(
        KW, engine=None, rsu_tier=RSUTierSpec(num_rsus_per_task=2),
        participation=ParticipationSpec(mode="semi_sync"),
        checkpoint=CheckpointSpec(interval=2, dir="ck"))), device="cpu")
    assert sim.engine == engine and sim.fused.check == (engine ==
                                                         "fused_check")
    assert sim.fused.K == 2 and "buf_w" in sim.fused.carry


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="unknown engine"):
        IoVSimulator(SimConfig(**dict(KW, engine="vmap")), device="cpu")


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IoVSimulator(SimConfig(**KW))


def test_departing_vehicle_is_charged_other_samples_than_it_trains(
        monkeypatch):
    """A reference fault the port keeps (ROADMAP Queue 3, item 3): a
    departing vehicle trains max(1, round(local_steps·f)) steps (Python
    rounds half to even) but is charged int(batch·local_steps·f) samples
    (repro/sim/simulator.py:354-355 against :543). At local_steps 3 and
    f 0.5 it trains 2 steps (20 samples) and is charged 15."""
    from repro_torch.core import cost_model
    charged = []
    real = cost_model.vehicle_round_costs

    def spy(*a, **kw):
        charged.append(kw["num_samples"])
        return real(*a, **kw)
    monkeypatch.setattr(cost_model, "vehicle_round_costs", spy)
    sim = IoVSimulator(SimConfig(**dict(KW, local_steps=3)), device="cpu")
    plans = []
    plan_task = sim._plan_task
    sim._plan_task = lambda ti: plans.append(plan_task(ti)) or plans[-1]
    sim.run_round()
    steps = [s for p in plans for s in p["steps_list"]]
    departing = [bool(p["departing"][v]) for p in plans
                 for v in p["active_ids"]]
    assert len(steps) == len(charged) and any(departing)
    for s, c, dep in zip(steps, charged, departing):
        assert (s, c) == ((2, 15) if dep else (3, 30))
