"""The port's fused round engine on the CPU: its modules against the
reference's functions on the same numpy inputs, and the engine in the
simulator against itself (per-round against scanned execution, the serial
replay of ``fused_check``, a static layout across rounds). The fused run
against the reference's serial run is a case of ``runs`` in
``tests/test_torch_sim.py``.

On the CPU the round program runs eagerly; CUDA graphs exist only on a
card (``tests/test_torch_cuda.py``). Tolerances: the cost vector 1e-6
relative; step_scan equal to step; padded aggregation 1e-6 of each
leaf's largest entry, zero-weight lanes exact no-ops; the padded SVD
factors 1e-5 against ``redistribute`` (one Ω); per-round against scanned
execution exactly equal; ``engine_check_dev`` < 1e-5.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import cost_model as jcm
from repro.core import energy_alloc as jea
from repro.federated import fused_engine as jfused
from repro_torch import interop
from repro_torch.config import (CheckpointSpec, EnergyAllocConfig,
                                LoRAConfig, ParticipationSpec, RSUTierSpec,
                                ShardSpec)
from repro_torch.core import aggregation as agg
from repro_torch.core import cost_model as cm
from repro_torch.core import energy_alloc as ea
from repro_torch.core.lora import pad_adapter_tree, rank_arange_mask
from repro_torch.federated import fused_engine as fused
from repro_torch.federated.batched_client import stack_trees
from repro_torch.federated.server import RSUServer
from repro_torch.optim.adam import leaves
from repro_torch.sim.simulator import IoVSimulator, SimConfig

KW = dict(method="ours", num_vehicles=6, num_tasks=2, local_steps=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors; with the suite's parallel workers each running a
    full intra-op thread pool the workers' threads spin on oversubscribed
    cores. One thread per worker, restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-30))


def _omega_ref(seed, d2, r):
    return _t(np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                           (d2, r), jnp.float32)))


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def test_vehicle_round_costs_vec_matches_reference():
    """A fleet of 8 with per-vehicle ranks, rates and sample counts: every
    stage against the reference's jnp twin (1e-6 relative) and against
    the host function per vehicle (float64, 1e-6 relative)."""
    rng = np.random.default_rng(3)
    profs = cm.default_device_profiles(rng, 8, 1e11)
    rsu = cm.default_rsu_profile()
    kw = dict(
        freq=np.array([p.freq for p in profs]),
        comp_power=np.array([p.kappa * p.freq ** 3 for p in profs]),
        tx_power=np.array([p.tx_power for p in profs]),
        flops_per_sample=np.array([p.flops_per_sample for p in profs]),
        rsu_tx_power=rsu.tx_power,
        payload_params=rng.integers(1e4, 1e6, 8).astype(np.float32),
        bytes_per_param=4,
        rate_down=rng.uniform(1e5, 1e7, 8),
        rate_up=rng.uniform(1e5, 1e7, 8),
        num_samples=np.where(rng.random(8) < 0.5, 15, 30),
        g=rng.uniform(1.0, 1.2, 8).astype(np.float32))
    f32 = {k: (v.astype(np.float32) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    got = cm.vehicle_round_costs_vec(**{
        k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
        for k, v in f32.items()})
    want = jcm.vehicle_round_costs_vec(**{
        k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
        for k, v in f32.items()})
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == torch.float32 and got[k].shape == (8,)
        assert _rel(got[k], want[k]) < 1e-6, k
    for v, p in enumerate(profs):
        host = cm.vehicle_round_costs(
            p, rsu, rank=0, payload_params=int(kw["payload_params"][v]),
            bytes_per_param=4, rate_down=float(kw["rate_down"][v]),
            rate_up=float(kw["rate_up"][v]),
            num_samples=int(kw["num_samples"][v]), g=float(kw["g"][v]))
        assert abs(float(got["energy"][v]) - host.energy) <= 1e-6 * host.energy
        assert abs(float(got["latency"][v]) - host.latency) <= \
            1e-6 * host.latency


@pytest.mark.parametrize("rounds_done", [5, 2], ids=["realloc", "plain"])
def test_step_scan_equals_step(rounds_done):
    """Algorithm 1 with a tensor round counter: on the round that
    reallocates (Q = 6) and on one that does not, equal to ``step`` and
    to the reference's ``step_scan``."""
    cfg = EnergyAllocConfig(e_total=900.0)
    st = ea.AllocState(budgets=torch.tensor([200.0, 400.0, 300.0]),
                       difficulty=torch.tensor([1.0, 0.6, 0.8]),
                       round=rounds_done)
    consumed = torch.tensor([150.0, 410.0, 90.0])
    acc = torch.tensor([0.4, 0.2, 0.7])
    want, info = ea.step(st, cfg, consumed, acc)
    assert info["reallocated"] == (rounds_done == 5)
    got = ea.step_scan(st._replace(round=torch.tensor(rounds_done)), cfg,
                       consumed, acc)
    assert torch.equal(got.budgets, want.budgets)
    assert torch.equal(got.difficulty, want.difficulty)
    assert int(got.round) == want.round
    jst = jea.AllocState(budgets=jnp.asarray(st.budgets.numpy()),
                         difficulty=jnp.asarray(st.difficulty.numpy()),
                         round=jnp.asarray(rounds_done, jnp.int32))
    jgot = jea.step_scan(jst, cfg, jnp.asarray(consumed.numpy()),
                         jnp.asarray(acc.numpy()))
    assert _rel(got.budgets, jgot.budgets) < 1e-6
    assert _rel(got.difficulty, jgot.difficulty) < 1e-6


def _client_trees(ranks, L=2, d_in=16, d_out=24, seed=0):
    rng = np.random.default_rng(seed)
    return [{"segments": [{"attn": {
        "q": {"a": rng.standard_normal((L, d_in, r)).astype(np.float32),
              "b": rng.standard_normal((L, r, d_out)).astype(np.float32)},
        "o": {"a": rng.standard_normal((L, d_out, r)).astype(np.float32),
              "b": rng.standard_normal((L, r, d_in)).astype(np.float32)},
    }}]} for r in ranks]


def _padded_fleet(trees, max_rank):
    return stack_trees([pad_adapter_tree(interop.tree_map(_t, t), max_rank)
                        for t in trees])


def test_aggregate_merged_padded_matches_list_path_and_reference():
    """Three clients at ranks 2, 4 and 8, padded to 8, plus two lanes of
    weight 0: equal to ``aggregate_merged`` over the three (1e-6 of each
    leaf's largest entry) and to the reference's padded aggregator; the
    zero-weight lanes' contents change nothing, to the bit."""
    trees = _client_trees([2, 4, 8, 8, 4])
    weights = [30.0, 10.0, 60.0, 0.0, 0.0]
    scale = 2.0
    fleet = _padded_fleet(trees, 8)
    w = torch.tensor(weights)
    got = agg.aggregate_merged_padded(fleet, w, scale)
    want = agg.aggregate_merged([interop.tree_map(_t, t) for t in trees[:3]],
                                weights[:3], scale)
    jfleet = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.moveaxis(x.numpy(), -3, 0)), fleet)
    jwant = jagg.aggregate_merged_padded(jfleet, jnp.asarray(weights), scale)
    other = _padded_fleet(trees[:3] + _client_trees([8, 4], seed=9), 8)
    again = agg.aggregate_merged_padded(other, w, scale)
    for p in agg.tree_paths_delta(want):
        g = agg.tree_get(got, p)["delta"]
        assert _rel(g, agg.tree_get(want, p)["delta"]) < 1e-6
        assert _rel(g, jagg.tree_get(jwant, p)["delta"]) < 1e-6
        assert torch.equal(g, agg.tree_get(again, p)["delta"])


@pytest.fixture(scope="module")
def merged():
    trees = _client_trees([2, 4, 8], d_in=32, d_out=40, seed=4)
    return agg.aggregate_merged([interop.tree_map(_t, t) for t in trees],
                                [3.0, 1.0, 2.0], 2.0)


def test_merged_svd_and_factors_for_ranks_equal_redistribute(merged):
    """One shared SVD at max_rank 8 with the reference's Ω at seed 5, cut
    per lane at ranks 2, 4, 8 and 4: each lane equal to ``redistribute``
    at its rank, zero-padded (1e-5); the products a·b equal to the
    reference's merged_svd + factors_for_ranks (1e-5)."""
    ranks = [2, 4, 8, 4]
    svd = agg.merged_svd(merged, 8, agg.draw_omegas(merged, 8, 5,
                                                    _omega_ref))
    lanes = agg.factors_for_ranks(svd, rank_arange_mask(
        torch.tensor(ranks), 8), 2.0)
    jm = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), merged)
    jlanes = jagg.factors_for_ranks(
        jagg.merged_svd(jm, 8, seed=5),
        jnp.asarray(rank_arange_mask(torch.tensor(ranks), 8).numpy()), 2.0)
    for v, r in enumerate(ranks):
        want = pad_adapter_tree(agg.redistribute(
            merged, rank=r, scale=2.0, max_rank=8, seed=5,
            draw_omega=_omega_ref), 8)
        for p in agg.tree_paths(want):
            got = agg.tree_get(lanes, p)
            for k in ("a", "b"):
                assert _rel(got[k].select(-3, v), agg.tree_get(want, p)[k]) \
                    < 1e-5
            jl = jagg.tree_get(jlanes, p)
            prod = np.asarray(jl["a"][v]) @ np.asarray(jl["b"][v])
            assert _rel(got["a"].select(-3, v) @ got["b"].select(-3, v),
                        prod) < 1e-5


def test_factors_full_equals_eval_adapters(merged):
    """The fused engine's global-eval adapter equals the server's
    ``eval_adapters`` (seed 0, max_rank) on the same merged deltas."""
    from repro_torch.configs import vit_base_paper
    lora = LoRAConfig(rank=4, max_rank=8, candidate_ranks=(2, 4, 8))
    srv = RSUServer(vit_base_paper.reduced(), lora, "ours", device="cpu",
                    draw_omega=_omega_ref)
    srv.load_merged(merged, 3)
    want = srv.eval_adapters()
    got = agg.factors_full(agg.merged_svd(
        merged, 8, agg.draw_omegas(merged, 8, 0, _omega_ref)), lora.scale)
    for p in agg.tree_paths(want):
        for k in ("a", "b"):
            assert torch.equal(agg.tree_get(got, p)[k],
                               agg.tree_get(want, p)[k])
    assert srv.round == 3


@pytest.mark.parametrize("injected", [False, True], ids=["own", "injected"])
def test_fresh_padded_equals_n_fresh_draws(injected):
    """``fresh_padded(n)`` consumes the fresh-adapter stream exactly as n
    ``_fresh`` calls (the server's own generator, or an injected draw),
    call after call."""
    from repro_torch.configs import vit_base_paper
    from repro_torch.models import transformer as T
    cfg = vit_base_paper.reduced()
    lora = LoRAConfig(rank=4, max_rank=8, candidate_ranks=(2, 4, 8))

    def server():
        draw = None
        if injected:
            g = torch.Generator().manual_seed(11)
            draw = lambda: T.init_adapters(cfg, lora, rank=8,  # noqa: E731
                                           generator=g)
        return RSUServer(cfg, lora, "ours", seed=5, device="cpu",
                         draw_adapters=draw)
    a, b = server(), server()
    stacked = a.fresh_padded(3)
    one_by_one = [b._fresh(8) for _ in range(3)]
    for x, y in zip(leaves(stacked), leaves(stack_trees(one_by_one))):
        assert torch.equal(x, y)
    nxt = stack_trees([b._fresh(8) for _ in range(2)])
    for x, y in zip(leaves(a.fresh_padded(2)), leaves(nxt)):
        assert torch.equal(x, y)


def test_supports_method_matches_reference():
    for m in ("ours", "ours_no_energy", "ours_no_mobility", "hetlora",
              "homolora", "fedra", "ours_residual"):
        assert fused.supports_method(m) == jfused.supports_method(m)
    assert fused.FUSED_METHODS == jfused.FUSED_METHODS


# ---------------------------------------------------------------------------
# The engine in the simulator
# ---------------------------------------------------------------------------

def _sim(**change):
    return IoVSimulator(SimConfig(**{**KW, "engine": "fused", **change}),
                        device="cpu")


@pytest.fixture(scope="module")
def per_round():
    """Four fused rounds through run_round, recording each round's staged
    input layout and the static buffers' addresses."""
    sim = _sim()
    eng = sim.fused
    layouts = []
    upload = eng._upload

    def spy(ints, f32s, fresh):
        layouts.append({
            "vectors": [(a.shape, a.dtype) for a in (ints, f32s)],
            "fresh": [None if f is None else [(x.shape, x.dtype)
                                              for x in leaves(f)]
                      for f in fresh],
            "buffers": [t.data_ptr() for t in
                        [eng.int_in, eng.f32_in, eng.out]
                        + leaves(eng.carry) + leaves(eng.fresh)]})
        upload(ints, f32s, fresh)
    eng._upload = spy
    hist = [sim.run_round() for _ in range(4)]
    return sim, hist, layouts


def test_run_scanned_equals_run_round(per_round):
    """Two rounds staged first and run without the host between them
    equal the first two rounds run one by one, exactly."""
    ref_sim, ref_hist, _ = per_round
    sim = _sim()
    hist = sim.run_scanned(2)
    assert hist == ref_hist[:2] and sim.history == hist
    ref = IoVSimulator(SimConfig(**dict(KW, engine="fused")), device="cpu")
    ref.run(2)
    for s, r in zip(sim.servers, ref.servers):
        assert s.round == r.round == 2
        for x, y in zip(leaves(s.merged), leaves(r.merged)):
            assert torch.equal(x, y)
    for s, r in zip(sim.ucb_states, ref.ucb_states):
        for x, y in zip(s, r):
            assert torch.equal(x, y)
    assert torch.equal(sim.alloc.budgets, ref.alloc.budgets)
    assert sim.alloc.round == ref.alloc.round == 2
    # a scan goes on where the last round left off
    assert sim.run_scanned(2) == ref_hist[2:4]


def test_static_layout_across_rounds(per_round):
    """The CPU form of the reference's one-compile guard: over four rounds
    whose active sets and mean ranks differ, every staged input has the
    same shape and dtype and every static buffer the same address."""
    _, hist, layouts = per_round
    actives = {tuple(t["active"] for t in r["tasks"]) for r in hist}
    mean_ranks = {tuple(t["mean_rank"] for t in r["tasks"]) for r in hist}
    assert len(actives) >= 2 and len(mean_ranks) >= 4
    for lay in layouts[1:]:
        assert lay["vectors"] == layouts[0]["vectors"]
        assert lay["buffers"] == layouts[0]["buffers"]
    fresh = [f for lay in layouts for f in lay["fresh"] if f is not None]
    assert fresh and all(f == fresh[0] for f in fresh)


def test_fused_check_replays_the_serial_trainer():
    sim = _sim(engine="fused_check")
    sim.run(2)
    assert 0.0 <= sim.engine_check_dev < 1e-5
    with pytest.raises(ValueError, match="round by round"):
        sim.run_scanned(2)


def test_mirrored_state_readopts_exactly(per_round):
    """After a round the engine mirrors its carry onto the simulator
    (UCB-DUAL states, allocator, merged deltas); ``reset_carry`` adopts
    that mirror back, and the next round is the one the engine would
    have run from its own carry, exactly."""
    _, ref_hist, _ = per_round
    sim = _sim()
    sim.run_round()
    sim.fused.reset_carry()
    assert sim.run_round() == ref_hist[1]


@pytest.mark.parametrize("change", [
    {"engine": "fused_sharded"},
    {"rsu_tier": RSUTierSpec(num_rsus_per_task=2),
     "shard": ShardSpec(num_shards=2)},
    {"shard": ShardSpec(num_shards=2)},
], ids=["fused_sharded", "two_rsus", "two_shards"])
def test_unported_fused_options_raise(change):
    """The fused engine runs tiers, semi_sync and checkpoints; with them,
    as without, a sharded fleet on the one device the CPU shows raises
    (``fleet_devices`` runs it: ``tests/test_torch_sharded_engine.py``)."""
    with pytest.raises(ValueError, match="visible"):
        _sim(**change)


def test_fused_engine_takes_semi_sync_with_checkpoints(tmp_path):
    """semi_sync with checkpoints: the chunked scan writes one at its
    boundary, and its buffer's carry is there to restore into."""
    sim = _sim(participation=ParticipationSpec(mode="semi_sync"),
               checkpoint=CheckpointSpec(interval=1, dir=str(tmp_path)))
    assert "buf_delta" in sim.fused.carry
    assert len(sim.run_scanned(1)) == 1
    assert sorted(os.listdir(tmp_path)) == ["round_000001.npz"]


def test_engine_rejects_a_tier_and_the_sharded_fleet_itself():
    """The engine takes a tier (its partials in the carry); a sharded
    fleet builds the sharded engine over the devices given, and without
    them, on the one device the CPU shows, raises, with a tier or
    without."""
    sim = _sim()
    sim.cfg = dataclasses.replace(sim.cfg, rsu_tier=RSUTierSpec(
        num_rsus_per_task=2))
    eng = fused.FusedRoundEngine(sim)
    assert eng.K == 2 and tuple(eng.carry["partial_w"].shape) == (2, 2)
    sim.cfg = dataclasses.replace(sim.cfg, shard=ShardSpec(num_shards=2))
    with pytest.raises(ValueError, match="visible"):
        fused.FusedRoundEngine(sim)
    eng = fused.FusedRoundEngine(sim, devices=["cpu", "cpu"])
    assert isinstance(eng, fused.ShardedRoundEngine) and eng.n_shards == 2
    assert tuple(eng.carry["partial_w"].shape) == (2, 2)
    sim.cfg = dataclasses.replace(sim.cfg, rsu_tier=RSUTierSpec())
    with pytest.raises(ValueError, match="visible"):
        fused.FusedRoundEngine(sim)
    sim.cfg = dataclasses.replace(sim.cfg, shard=ShardSpec())
    with pytest.raises(ValueError, match="CUDA"):
        fused.FusedRoundEngine(sim, capture=True)
    assert fused.FusedRoundEngine(sim).capture is False


def test_fused_engine_resolution(monkeypatch):
    """As the reference's: an explicit fused engine with a method it does
    not support raises; one chosen by the environment falls back to
    batched."""
    monkeypatch.setenv("REPRO_SIM_ENGINE", "fused")
    resolve = IoVSimulator._resolve_engine
    assert resolve(SimConfig(**KW)) == "fused"
    assert resolve(SimConfig(**dict(KW, method="hetlora"))) == "batched"
    with pytest.raises(ValueError, match="does not support"):
        resolve(SimConfig(**dict(KW, method="hetlora", engine="fused")))
    assert IoVSimulator(SimConfig(**dict(KW, num_vehicles=4)),
                        device="cpu").fused is not None


def test_fused_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IoVSimulator(SimConfig(**dict(KW, engine="fused")))
