"""The port's device-sharded fleet (``engine="fused_sharded"``,
``ShardSpec``, ``fleet_slots``, the fleet mesh) on the CPU, the
counterpart of ``tests/test_sharded_engine.py``.

One process drives every shard: ``fleet_devices=["cpu"] * N`` runs N
shards in-process, as the reference's forced host devices do. Held:
``fleet_slots`` bit-equal to the reference's for V 1-13, N 1-5 and both
placements; ``ShardSpec`` validation and ``resolve``; engine resolution
against the reference's ``_resolve_engine`` on the same configs; the
port's sharded round (N 2 and 4, both placements) against the
reference's unsharded fused round run in-process with its draws
injected, at the reference test's contract (integer facts exact, energy
2e-4 relative, lambda 1e-4, accuracy 8e-3 absolute, budgets 1e-5
relative, merged deltas within 5e-3); the presets urban-grid, dense-rsu
(partials' weights 1e-4 relative, ages exact) and rsu-outage under
semi_sync through ``run_scanned(8)`` (buffers in vehicle order) against
the port's unsharded fused round at the same contract; a sharded
``run_scanned(3)`` equal to three rounds, two sharded runs equal, bit for
bit; UCB-DUAL states in vehicle order; the segmented primitives over a
split fleet within 1e-5 of one device; a checkpoint written at N 4
resumed at N 1 and N 2, continuing the uninterrupted run.

The reference's fused round (~20 s, most of it eager and program
compiles) runs on a thread of its own from the first test on; the tests
that read it come last.
"""
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro.config import LoRAConfig as JLoRAConfig
from repro.config import ShardSpec as JShardSpec
from repro.configs import vit_base_paper as jvit
from repro.federated import fused_engine as jfused
from repro.sim.simulator import IoVSimulator as JSimulator
from repro.sim.simulator import SimConfig as JSimConfig
from repro_torch import interop
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.config import (CheckpointSpec, LoRAConfig,
                                ParticipationSpec, ShardSpec)
from repro_torch.configs import vit_base_paper
from repro_torch.core import aggregation as agg
from repro_torch.core import lora as lora_lib
from repro_torch.federated import fused_engine as fused
from repro_torch.federated.batched_client import stack_trees
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import sharding as sh
from repro_torch.models import transformer as T
from repro_torch.optim.adam import leaves
from repro_torch.sim import scenarios
from repro_torch.sim.simulator import IoVSimulator, SimConfig
from test_torch_sim import (_np, _omega_ref, _server_draw,  # noqa: F401
                            one_torch_thread)

TINY = dict(name="vit-test-shard", num_layers=2, d_model=32, num_heads=2,
            num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64)
LORA = LoRAConfig(rank=4, max_rank=8, candidate_ranks=(2, 4, 8))
JLORA = JLoRAConfig(rank=4, max_rank=8, candidate_ranks=(2, 4, 8))
# the reference test's _sim: 6 vehicles, 2 tasks, 1 local step, 2 rounds
BASE = dict(method="ours", rounds=2, num_vehicles=6, num_tasks=2, seed=3,
            local_steps=1)
# the reference's program compiles with XLA's backend optimisation off
# (options of this one executable; the values are the same functions')
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
TOPOLOGIES = [(2, "roundrobin"), (2, "block"), (4, "roundrobin"),
              (4, "block")]


def _arch():
    return vit_base_paper.vit_base_paper().with_overrides(**TINY)


def _jarch():
    return jvit.vit_base_paper().with_overrides(**TINY)


class _Reference:
    """The reference's unsharded fused run of BASE on a thread of its
    own: ``params`` (set once its simulator is built) and ``history``."""

    def __init__(self):
        self.built = threading.Event()
        self.done = threading.Event()
        self.error = None
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        try:
            jsim = JSimulator(JSimConfig(engine="fused", train_arch=_jarch(),
                                         lora=JLORA, **BASE))
            self.params = _np(jsim.params)
            self.built.set()
            eng, cache = jsim.fused, {}

            def fast(carry, x, data):
                if "c" not in cache:
                    cache["c"] = jax.jit(eng._round_step).lower(
                        carry, x, data).compile(FAST_COMPILE)
                return cache["c"](carry, x, data)
            eng._jit_round = fast
            self.history = jsim.run()
            self.merged = [_np(s.merged) for s in jsim.servers]
            self.ucb = [_np(s) for s in jsim.ucb_states]
        except BaseException as e:    # handed to the waiting test
            self.error = e
        finally:
            self.built.set()
            self.done.set()

    def wait(self, event):
        assert event.wait(timeout=600), "the reference's run did not end"
        if self.error is not None:
            raise self.error
        return self


@pytest.fixture(scope="module", autouse=True)
def reference():
    """The reference's run, started with the file's first test. Its
    eager ops compile without XLA's optimisation passes too (a third of
    its build) while this file runs; the flag is put back after it."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    ref = _Reference()
    yield ref
    ref.done.wait(timeout=600)
    jax.config.update("jax_disable_most_optimizations", before)


def _sim(engine="fused", n=None, placement="roundrobin", rounds=2, *,
         params=None, **kw):
    """BASE in the port on the CPU; ``n`` shards on ``["cpu"] * n``."""
    cfg = SimConfig(engine=engine, train_arch=_arch(), lora=LORA,
                    **dict(BASE, rounds=rounds), **kw)
    sim_kw = {}
    if n:
        cfg = dataclasses.replace(cfg, shard=ShardSpec(
            num_shards=n, placement=placement))
        sim_kw["fleet_devices"] = ["cpu"] * n
    if params is not None:
        draws = [_server_draw(BASE["seed"] + 7 * t, _jarch(), JLORA)[0]
                 for t in range(BASE["num_tasks"])]
        sim_kw.update(params=interop.params_from_jax(params, device="cpu"),
                      server_draws=draws, draw_omega=_omega_ref())
    return IoVSimulator(cfg, device="cpu", **sim_kw)


def _preset(name, n=None, rounds=2, **kw):
    sim_kw = {} if n is None else {"engine": "fused_sharded",
                                   "fleet_devices": ["cpu"] * n}
    return scenarios.build_sim(name, method="ours", rounds=rounds, seed=1,
                               device="cpu", train_arch=_arch(), lora=LORA,
                               local_steps=1, **{"engine": "fused", **kw,
                                                 **sim_kw})


def _assert_parity(ha, hb, rel=2e-4):
    """History ha against the sharded history hb at the reference test's
    contract: integer trajectory facts exactly, the float accounting to
    the tolerance of a changed summation order."""
    assert len(ha) == len(hb)
    for r_a, r_b in zip(ha, hb):
        for t_a, t_b in zip(r_a["tasks"], r_b["tasks"]):
            for k in ("active", "departing", "handoffs", "comm_params",
                      "fallbacks"):
                assert t_a[k] == t_b[k], (r_a["round"], k)
            assert t_a["mean_rank"] == pytest.approx(t_b["mean_rank"],
                                                     abs=1e-5)
            assert t_a["energy"] == pytest.approx(t_b["energy"], rel=rel)
            assert t_a["lambda"] == pytest.approx(t_b["lambda"], abs=1e-4)
        assert r_a["energy"] == pytest.approx(r_b["energy"], rel=rel)
        assert r_a["accuracy"] == pytest.approx(r_b["accuracy"], abs=8e-3)
        assert r_a["budgets"] == pytest.approx(r_b["budgets"], rel=1e-5)


def _merged_dev(a, b) -> float:
    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
               for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Slot maps, ShardSpec, the fleet mesh, engine resolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("placement", ["roundrobin", "block"])
def test_fleet_slots_equal_reference(placement):
    for v in range(1, 14):
        for n in range(1, 6):
            slot, vp = fused.fleet_slots(v, n, placement)
            want, jvp = jfused.fleet_slots(v, n, placement)
            assert vp == jvp and slot.dtype == want.dtype
            assert np.array_equal(slot, want), (v, n)
    for bad in ((6, 4, "diagonal"), (6, 0)):
        with pytest.raises(ValueError):
            fused.fleet_slots(*bad)
        with pytest.raises(ValueError):
            jfused.fleet_slots(*bad)


def test_shard_spec_validation_and_resolve():
    assert ShardSpec().trivial and not ShardSpec(num_shards=2).trivial
    assert not ShardSpec(num_shards=0).trivial
    # 0: every device the engine will use; one CPU on a host without a
    # card, as the reference's unforced CPU backend
    assert ShardSpec(num_shards=0).resolve() == max(
        torch.cuda.device_count(), 1)
    assert ShardSpec(num_shards=0).resolve(["cpu"] * 3) == 3
    assert ShardSpec(num_shards=3).resolve() == 3
    if not torch.cuda.is_available():
        assert ShardSpec(num_shards=0).resolve() == 1
    for bad in ({"num_shards": -1}, {"placement": "diagonal"},
                {"axis_name": ""}):
        with pytest.raises(ValueError):
            ShardSpec(**bad)
        with pytest.raises(ValueError):
            JShardSpec(**bad)


def test_fleet_mesh_and_constrainer_split_the_lanes():
    mesh = pmesh.make_fleet_mesh(devices=["cpu"] * 3)
    assert mesh.sizes == (3,) and mesh.devices == (torch.device("cpu"),) * 3
    assert pmesh.make_fleet_mesh(2, devices=["cpu"] * 3).size == 2
    with pytest.raises(ValueError, match="given"):
        pmesh.make_fleet_mesh(4, devices=["cpu"] * 3)
    assert [list(r) for r in sh.fleet_lanes(mesh, 6)] == [[0, 1], [2, 3],
                                                         [4, 5]]
    tree = {"a": torch.arange(2 * 6 * 4 * 1.0).reshape(2, 6, 4, 1),
            "w": torch.arange(6.0), "k": torch.ones(2)}
    parts = sh.fleet_constrainer(mesh, 6)(tree)
    assert len(parts) == 3
    assert torch.equal(torch.cat([p["a"] for p in parts], dim=1), tree["a"])
    assert torch.equal(parts[2]["w"], torch.tensor([4.0, 5.0]))
    assert all(torch.equal(p["k"], tree["k"]) for p in parts)
    assert sh.fleet_shardings(mesh, tree, fleet_size=6)["w"] == ("fleet",)
    one = pmesh.make_fleet_mesh(devices=["cpu"])
    assert sh.fleet_constrainer(one, 6)(tree) is tree


def test_engine_resolution_matches_reference(monkeypatch):
    """The reference test's cases, each against the reference's
    ``_resolve_engine`` on the same config: the result, or the same
    refusal."""
    cases = [("fused_sharded", dict(method="hetlora")),
             ("fused_sharded", dict(method="ours")),
             (None, dict(method="hetlora", engine="fused_sharded")),
             (None, dict(method="ours", engine="batched", shard=2)),
             (None, dict(method="ours", engine="fused_check", shard=2)),
             ("batched", dict(method="ours", shard=2)),
             ("fused_check", dict(method="ours", shard=2)),
             (None, dict(method="ours", shard=2)),
             (None, dict(method="hetlora", shard=2)),
             (None, dict(method="ours", engine="fused", shard=0))]
    for env, kw in cases:
        if env is None:
            monkeypatch.delenv("REPRO_SIM_ENGINE", raising=False)
        else:
            monkeypatch.setenv("REPRO_SIM_ENGINE", env)
        n = kw.pop("shard", 1)
        got = want = None
        try:
            want = JSimulator._resolve_engine(JSimConfig(
                shard=JShardSpec(num_shards=n), **kw))
        except ValueError as e:
            want = ("raises", str(e).split(";")[0])
        try:
            got = IoVSimulator._resolve_engine(SimConfig(
                shard=ShardSpec(num_shards=n), **kw))
        except ValueError as e:
            got = ("raises", str(e).split(";")[0])
        assert got == want, (env, kw)


def test_check_engine_never_shards(monkeypatch):
    """An explicit fused_check with a shard spec is refused; one from the
    environment leaves the spec inert."""
    with pytest.raises(ValueError, match="cannot shard"):
        _sim("fused_check", n=2)
    monkeypatch.setenv("REPRO_SIM_ENGINE", "fused_check")
    sim = _sim(None, n=2)
    assert sim.engine == "fused_check" and sim.fused.n_shards == 1


def test_fused_sharded_refuses_fewer_than_two_devices():
    """fused_sharded resolving to one device raises, naming the visible
    devices, rather than run one shard under the sharded name."""
    for kw in ({}, {"shard": ShardSpec(num_shards=0)}):
        cfg = SimConfig(engine="fused_sharded", train_arch=_arch(),
                        lora=LORA, **BASE, **kw)
        with pytest.raises(ValueError, match=r"visible device.*cpu"):
            IoVSimulator(cfg, device="cpu")
    with pytest.raises(ValueError, match="visible device"):
        IoVSimulator(cfg, device="cpu", fleet_devices=["cpu"])
    # without fleet_devices the CPU shows one device: two shards raise
    with pytest.raises(ValueError, match="visible"):
        _sim("fused", n=None, shard=ShardSpec(num_shards=2))


# ---------------------------------------------------------------------------
# Presets, repeats, UCB state, primitives, resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["urban-grid", "dense-rsu", "rsu-outage"])
def test_presets_match_unsharded_fused(name):
    """Each preset sharded over 2 against the port's unsharded fused
    round (held to the reference by the fused tests): rsu-outage under
    semi_sync through run_scanned(8), with its buffers in vehicle
    order; dense-rsu's RSU partials."""
    kw, rounds = {}, 2
    if name == "rsu-outage":
        kw["participation"] = ParticipationSpec(mode="semi_sync",
                                                max_delay=3)
        rounds = 8
    a, b = _preset(name, rounds=rounds, **kw), _preset(name, 2, rounds,
                                                       **kw)
    assert b.fused.n_shards == 2 and b.fused.Vp % 2 == 0
    run = (lambda s: s.run_scanned(rounds)) if rounds > 2 else (
        lambda s: s.run())
    # the two runs share nothing; torch's kernels release the
    # interpreter, so they overlap on two cores
    with ThreadPoolExecutor(2) as pool:
        ha, hb = pool.map(run, (a, b))
    _assert_parity(ha, hb)
    for ta, tb in zip(a.servers, b.servers):
        assert _merged_dev(leaves(ta.merged), leaves(tb.merged)) < 5e-3
        if name == "dense-rsu":
            assert np.allclose(ta.partial_w, tb.partial_w, rtol=1e-4)
            assert np.array_equal(ta.partial_age, tb.partial_age)
        if name == "rsu-outage":
            assert sorted(ta.buffer) == sorted(tb.buffer)
            for v, ent in ta.buffer.items():
                got = tb.buffer[v]
                assert (got["age"], got["dest"]) == (ent["age"],
                                                     ent["dest"])
                assert got["w"] == pytest.approx(ent["w"], rel=1e-6)
                assert _merged_dev(leaves(ent["delta"]),
                                   leaves(got["delta"])) < 5e-3
    if name == "rsu-outage":
        assert any(t["deferred"] for r in b.history for t in r["tasks"])


@pytest.fixture(scope="module")
def four_shards(tmp_path_factory, reference):
    """BASE over four shards (round-robin: the lanes really permute) on
    the reference's draws, four rounds one by one with a checkpoint every
    two; the servers' merged deltas and UCB-DUAL states as round 2 left
    them in ``sim.at_two``."""
    d = str(tmp_path_factory.mktemp("ckpt"))
    sim = _sim("fused", 4, rounds=4, params=reference.wait(
        reference.built).params, checkpoint=CheckpointSpec(interval=2,
                                                           dir=d))
    assert not np.array_equal(sim.fused.slot, np.arange(6))
    sim.run(2)
    sim.at_two = ([s.merged for s in sim.servers], list(sim.ucb_states))
    sim.run(2)
    return sim, d


def test_sharded_scanned_equals_per_round_and_repeats(four_shards,
                                                     reference):
    """A sharded run_scanned(3) equals the per-round sharded run's first
    three rounds, and another per-round run its first, bit for bit."""
    hist, params = four_shards[0].history, reference.params
    assert _sim("fused_sharded", 4, rounds=3,
                params=params).run_scanned(3) == hist[:3]
    assert _sim("fused_sharded", 4, params=params).run(1) == hist[:1]


@pytest.mark.parametrize("n", [2, 4])
def test_segmented_primitives_over_a_split_fleet(n):
    """aggregate_hetlora_segmented and aggregate_merged_padded_segmented
    over a fleet split on a fleet mesh equal the one-device result to
    1e-5 (the batched engine's HetLoRA tier consumes the first
    unchanged)."""
    cfg, V = _arch(), 2 * n
    rng = np.random.default_rng(0)
    stacked = stack_trees([interop.tree_map(
        lambda x, i=i: x + 0.01 * (i + 1), T.init_adapters(
            cfg, LORA, seed=i, rank=LORA.max_rank, device="cpu"))
        for i in range(V)])
    ranks = torch.as_tensor(rng.choice(LORA.candidate_ranks, V))
    stacked = fused._mask_lanes(stacked, lora_lib.rank_arange_mask(
        ranks, LORA.max_rank))
    weights = torch.as_tensor(rng.uniform(0.5, 3.0, V), dtype=torch.float32)
    assoc = torch.as_tensor(rng.integers(-1, 3, V))
    split = sh.fleet_constrainer(
        pmesh.make_fleet_mesh(devices=["cpu"] * n), V)
    for fn, arg in ((agg.aggregate_hetlora_segmented, LORA.max_rank),
                    (agg.aggregate_merged_padded_segmented, LORA.scale)):
        ref, ref_w = fn(stacked, weights, assoc, 3, arg)
        got, got_w = fn(stacked, weights, assoc, 3, arg, constrain=split)
        assert torch.allclose(got_w, ref_w, rtol=1e-5)
        assert _merged_dev(leaves(ref), leaves(got)) < 1e-5


@pytest.mark.parametrize("n", [1, 2])
def test_checkpoint_resumes_on_any_topology(four_shards, reference, n):
    """The N 4 run's checkpoint at round 2 (vehicle order: the
    reference's file format) resumes at N 1 and at N 2; both continue the
    uninterrupted run's trajectory."""
    full, d = four_shards
    res = _sim("fused", None if n == 1 else n, rounds=4,
               params=reference.params)
    assert restore_checkpoint(res, d, round_idx=2) == 2
    assert res.fused.n_shards == n
    res.run(2)
    _assert_parity(full.history[2:], res.history[2:])
    for sa, sb in zip(full.servers, res.servers):
        assert _merged_dev(leaves(sa.merged), leaves(sb.merged)) < 5e-3


# ---------------------------------------------------------------------------
# The base config against the reference's fused round (last: they wait
# for the reference's thread)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=TOPOLOGIES,
                ids=[f"{n}-{p}" for n, p in TOPOLOGIES])
def base_run(request, reference, four_shards):
    """Two rounds of BASE per topology on the reference's draws: (the
    history, the servers' merged deltas, the UCB-DUAL states); four
    round-robin shards are the first two rounds of ``four_shards``."""
    n, placement = request.param
    if (n, placement) == (4, "roundrobin"):
        sim = four_shards[0]
        return sim, sim.history[:2], sim.at_two[0], sim.at_two[1]
    sim = _sim("fused_sharded", n, placement,
               params=reference.wait(reference.built).params)
    hist = sim.run()
    return (sim, hist, [s.merged for s in sim.servers],
            list(sim.ucb_states))


def test_base_round_matches_reference_fused(base_run, reference):
    sim, hist, _, _ = base_run
    ref = reference.wait(reference.done)
    eng = sim.fused
    n = eng.n_shards
    assert eng.Vp == -(-6 // n) * n and eng.segments == n + 2
    assert np.array_equal(eng.slot, jfused.fleet_slots(
        6, n, sim.cfg.shard.placement)[0])
    _assert_parity(ref.history, hist)


def test_base_merged_deltas_match_reference(base_run, reference):
    _, _, merged, _ = base_run
    ref = reference.wait(reference.done)
    for want, got in zip(ref.merged, merged):
        paths = agg.tree_paths_delta(got)
        assert sorted(paths) == sorted(agg.tree_paths_delta(want))
        assert _merged_dev(
            [agg.tree_get(want, p)["delta"] for p in paths],
            [agg.tree_get(got, p)["delta"] for p in paths]) < 5e-3


def test_ucb_states_in_vehicle_order(base_run, reference):
    """After the rounds the host's UCB-DUAL states are in vehicle order,
    (6, 3), as the reference's unsharded run leaves them."""
    _, _, _, ucb = base_run
    ref = reference.wait(reference.done)
    for want, got in zip(ref.ucb, ucb):
        assert got.counts.shape == want.counts.shape == (6, 3)
        assert np.array_equal(got.counts.numpy(), want.counts)
        assert np.allclose(got.reward_sum.numpy(), want.reward_sum,
                           atol=1e-4)
        assert np.allclose(got.energy_sum.numpy(), want.energy_sum,
                           rtol=2e-4)
