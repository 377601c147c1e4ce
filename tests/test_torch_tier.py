"""Multi-RSU tiers (``RSUTierSpec``) in the port against the reference, on
the CPU: the hierarchy's algebra on random fleets, the server's tier
state, and three rounds of the paper's method on a tier under every
engine of the port, each against the reference's serial run.

The tier is ``tier`` below (the reference's ``dense-rsu`` tier: 3 RSUs
per task, a sync every 2 rounds, staleness decay 0.7, a handoff costs
6 J and 0.4 s) on the default synthetic map: 24 vehicles, 3 tasks, seed
0, one local step, a 2-layer d-32 ViT. The port gets the reference's
``jax.random`` draws (base weights, each server's fresh adapters, the
SVD sketch), as in ``test_torch_sim.py``. Round 1 syncs: every task's
first global model is the staleness-weighted merge of its RSUs'
partials, and task 1 charges two handoffs. Every round of the port
starts from the reference's server state as that round found it
(merged deltas, partials, buffer) and takes the reference's SVDs of it,
so that each round is held from one state (ROADMAP, "What one round can
be held to"). This file runs the
serial and batched engines; ``test_torch_tier_fused.py`` the fused ones
and ``run_scanned``, with the checks collected here.

Tolerances: ranks, active sets, departures, handoffs, fallbacks,
comm_params, the buffer's tallies and the sync rounds exactly; energy,
latency, release weights and the partials' weights 1e-5 relative;
accuracy 1e-4; partials, buffered deltas and merged deltas (or HetLoRA's
global adapters) 1e-4 of each leaf's largest entry. The semi-synchronous
buffer: ``test_torch_participation.py``; HetLoRA on a tier:
``test_torch_tier_hetlora.py``.
"""
import contextlib
import dataclasses
import fcntl
import itertools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LoRAConfig as JLoRAConfig
from repro.config import OutageSpec as JOutageSpec
from repro.config import ParticipationSpec as JParticipationSpec
from repro.config import RSUTierSpec as JRSUTierSpec
from repro.configs import vit_base_paper as jvit
from repro.core import aggregation as jagg
from repro.federated.server import RSUServer as JRSUServer
from repro.sim.mobility_model import MobilitySimConfig as JMobilitySimConfig
from repro.sim.simulator import IoVSimulator as JSimulator
from repro.sim.simulator import SimConfig as JSimConfig
from repro_torch import interop
from repro_torch.config import (LoRAConfig, OutageSpec, ParticipationSpec,
                                RSUTierSpec)
from repro_torch.configs import vit_base_paper
from repro_torch.core import aggregation as agg
from repro_torch.federated.server import RSUServer
from repro_torch.sim.mobility_model import MobilitySimConfig
from repro_torch.sim.simulator import IoVSimulator, SimConfig
from test_torch_sim import (_np, _omega_ref, _recording, _server_draw,  # noqa: F401
                            one_torch_thread)

TINY = dict(name="vit-test-modes", num_layers=2, d_model=32, num_heads=2,
            num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64)
KW = dict(num_vehicles=24, num_tasks=3, local_steps=1, seed=0)
TIER = dict(num_rsus_per_task=3, sync_period=2, staleness_decay=0.7,
            handoff_energy=6.0, handoff_latency=0.4)
# the shape of the reference's rsu-outage preset: task 0's RSU dark in
# round 1, task 1's in round 2, so deferred uploads are released later
OUTAGES = ((0, 1, 2), (1, 2, 3))
TOL_STATE = 1e-4
TOL_REL = 1e-5
LORA = LoRAConfig(rank=4, max_rank=8, candidate_ranks=(2, 4, 8))
JLORA = JLoRAConfig(rank=4, max_rank=8, candidate_ranks=(2, 4, 8))


# ---------------------------------------------------------------------------
# The modes' configurations in both packages
# ---------------------------------------------------------------------------

def mode_kw(mode: str, reference: bool, **part) -> dict:
    """SimConfig fields of ``mode`` ("tier", "semi" or "tier+semi"; a
    semi mode takes ``part``'s ParticipationSpec fields) in the
    reference's package or the port's."""
    tier, sync, out, mob = ((JRSUTierSpec, JParticipationSpec, JOutageSpec,
                             JMobilitySimConfig) if reference else
                            (RSUTierSpec, ParticipationSpec, OutageSpec,
                             MobilitySimConfig))
    kw = {}
    if "tier" in mode:
        kw["rsu_tier"] = tier(**TIER)
    if "semi" in mode:
        kw["participation"] = sync(**dict({"mode": "semi_sync"}, **part))
        kw["mobility_sim"] = mob(outages=tuple(
            out(rsu_id=r, start=s, end=e) for r, s, e in OUTAGES))
    return kw


def sim_config(mode, method, reference, **change):
    arch = (jvit if reference else vit_base_paper).vit_base_paper()
    part = change.pop("part", {})
    return (JSimConfig if reference else SimConfig)(**dict(
        KW, method=method, train_arch=arch.with_overrides(**TINY),
        **mode_kw(mode, reference, **part), **change))


# ---------------------------------------------------------------------------
# Server state, as numpy, and pinning the port to the reference's
# ---------------------------------------------------------------------------

def _tree_np(tree):
    if tree is None:
        return None
    return interop.tree_map(lambda x: np.asarray(
        x.detach().cpu() if isinstance(x, torch.Tensor) else x), tree)


def _jtree_np(tree):
    return None if tree is None else jax.tree_util.tree_map(np.asarray, tree)


def server_state(srv, reference: bool) -> dict:
    """A server's state as numpy: the global model (merged deltas, or
    HetLoRA's global adapters), the RSU partials with their weights and
    ages, the in-flight buffer."""
    conv = _jtree_np if reference else _tree_np
    glob = srv.merged if srv.method == "ours" else srv.global_adapters
    return {
        "global": conv(glob),
        "partials": (None if srv.partials is None else
                     [conv(p) for p in srv.partials]),
        "partial_w": np.asarray(srv.partial_w, np.float64).copy(),
        "partial_age": np.asarray(srv.partial_age, np.int64).copy(),
        "buffer": {v: {"delta": conv(e["delta"]), "w": e["w"],
                       "age": e["age"], "dest": e["dest"]}
                   for v, e in srv.buffer.items()}}


def _torch(tree):
    return None if tree is None else interop.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def pin_state(sim, states) -> None:
    """Give the port's servers the reference's state ``states`` (one per
    task, from :func:`server_state`); a fused engine re-adopts it."""
    for srv, st in zip(sim.servers, states):
        if srv.method == "ours":
            srv.merged = _torch(st["global"])
        else:
            srv.global_adapters = _torch(st["global"])
        srv.partials = (None if st["partials"] is None else
                        [_torch(p) for p in st["partials"]])
        srv.partial_w = st["partial_w"].copy()
        srv.partial_age = st["partial_age"].copy()
        srv.buffer = {v: dict(e, delta=_torch(e["delta"]))
                      for v, e in st["buffer"].items()}
    if sim.fused is not None:
        sim.fused.reset_carry()


def reference_run(mode, method, rounds):
    """The reference's serial run of ``mode``, as plain data: its base
    weights (numpy), LoRA config and seed, history, plans and every
    server's state before each round and after the last."""
    jsim = JSimulator(sim_config(mode, method, True, engine="serial"))
    plans, states, hist = [], [], []
    _recording(jsim, plans)
    for _ in range(rounds):
        states.append([server_state(s, True) for s in jsim.servers])
        hist.append(jsim.run_round())
    states.append([server_state(s, True) for s in jsim.servers])
    return {"params": _np(jsim.params), "lora": jsim.cfg.lora,
            "seed": jsim.cfg.seed, "hist": hist, "plans": plans,
            "states": states, "mode": mode, "method": method}


def _reference_delta_svd(delta, max_rank, seed, draw_omega=None):
    """The reference's truncated SVD of one merged delta (its
    ``_delta_svd``, the same sketch seed), as tensors on the delta's
    device."""
    out = jagg._delta_svd(jnp.asarray(delta.detach().cpu().numpy()),
                          max_rank, seed)
    return tuple(torch.from_numpy(np.array(x)).to(delta.device)
                 for x in out)


def _fill_svds(eng, out, seed):
    """A fused engine's eager SVD segment with the reference's SVDs:
    every task's carried merged delta into ``out``, zero-padded to
    max_rank."""
    R = eng.Rmax
    for t in range(eng.T):
        merged = eng.carry["merged"][t]
        for path in agg.tree_paths_delta(merged):
            u, s, vt = _reference_delta_svd(
                agg.tree_get(merged, path)["delta"], R, seed)
            pad = R - s.shape[-1]
            dst = agg.tree_get(out[t], path)
            dst["u"].copy_(torch.nn.functional.pad(u, (0, pad)))
            dst["s"].copy_(torch.nn.functional.pad(s, (0, pad)))
            dst["vt"].copy_(torch.nn.functional.pad(vt, (0, 0, 0, pad)))


@contextlib.contextmanager
def reference_svds(sim):
    """Inside, every SVD that ``sim`` takes of a merged delta (the
    redistribution at seed = round, the global eval's at seed 0) is the
    reference's on the same delta. The two packages' QR and SVD part by
    rounding, which a round of Adam from the redistributed factors
    amplifies past 1e-4 (ROADMAP, "What one round can be held to"); the
    port's SVD is held to the reference's in ``test_torch_train.py`` and
    ``test_torch_fused.py``."""
    real = agg._delta_svd
    agg._delta_svd = _reference_delta_svd
    eng = sim.fused
    if eng is not None:
        rounds = itertools.count(eng._round)
        eng._dist_svd = lambda: _fill_svds(eng, eng.dist_svd, next(rounds))
        eng._eval_svd = lambda: _fill_svds(eng, eng.eval_svd, 0)
    try:
        yield sim
    finally:
        agg._delta_svd = real
        if eng is not None:
            del eng._dist_svd, eng._eval_svd


def port_sim(ref, engine, **change):
    """The port's simulator of the reference run's config under
    ``engine``, on the reference's draws."""
    jcfg = jvit.vit_base_paper().with_overrides(**TINY)
    draws = [_server_draw(ref["seed"] + 7 * t, jcfg, ref["lora"])
             for t in range(KW["num_tasks"])]
    return IoVSimulator(
        sim_config(ref["mode"], ref["method"], False, engine=engine,
                   **change), device="cpu",
        params=interop.params_from_jax(ref["params"], device="cpu"),
        server_draws=[d for d, _ in draws], mask_draws=[m for _, m in draws],
        draw_omega=_omega_ref())


def port_run(ref, engine, pinned=True):
    """The port's rounds of the reference run under ``engine`` on the
    reference's SVDs, each started from the reference's state as that
    round found it (with ``pinned``): (sim, history, plans, the servers'
    state after each round)."""
    sim = port_sim(ref, engine)
    plans, states = [], []
    _recording(sim, plans)
    hist = []
    with reference_svds(sim):
        for r in range(len(ref["hist"])):
            if pinned and r:
                pin_state(sim, ref["states"][r])
            hist.append(sim.run_round())
            states.append([server_state(s, False) for s in sim.servers])
    return {"sim": sim, "hist": hist, "plans": plans, "states": states}


# ---------------------------------------------------------------------------
# Held against the reference (collected again by the other modes' files)
# ---------------------------------------------------------------------------

COUNT_KEYS = ("active", "departing", "handoffs", "fallbacks", "comm_params",
              "mean_rank", "deferred", "released", "task")


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want), initial=0.0)) / max(
        1.0, float(np.max(np.abs(want), initial=0.0)))


def tree_err(got, want) -> float:
    """Largest _max_rel over the leaves of two numpy trees, leaf by
    path."""
    assert (got is None) == (want is None)
    if want is None:
        return 0.0
    paths = agg.tree_paths_delta(want) or agg.tree_paths(want)
    assert sorted(paths) == sorted(agg.tree_paths_delta(got)
                                   or agg.tree_paths(got))
    return max(_max_rel(agg.tree_get(got, p)[k], w)
               for p in paths for k, w in agg.tree_get(want, p).items())


def _partial_err(got, want) -> float:
    """One RSU partial against another; a segment that never had an
    upload is None on the host and a zero tree in the fused carry."""
    if (got is None) != (want is None):
        zero = interop.tree_map(np.zeros_like, got if want is None else want)
        return tree_err(zero, got) if want is None else tree_err(want, zero)
    return tree_err(got, want)


def state_errors(got, want) -> dict:
    """One server's state against another's: the exact parts as bools,
    the rest as relative errors."""
    assert (got["partials"] is None) == (want["partials"] is None)
    parts = [_partial_err(g, w) for g, w in zip(got["partials"] or [],
                                                want["partials"] or [])]
    assert sorted(got["buffer"]) == sorted(want["buffer"])
    buf = want["buffer"]
    return {
        "global": tree_err(got["global"], want["global"]),
        "partials": max(parts, default=0.0),
        "partial_w": _max_rel(got["partial_w"], want["partial_w"]),
        "buffer": max((tree_err(got["buffer"][v]["delta"], e["delta"])
                       for v, e in buf.items()), default=0.0),
        "buffer_w": max((abs(got["buffer"][v]["w"] - e["w"]) / e["w"]
                         for v, e in buf.items()), default=0.0),
        "exact": (np.array_equal(got["partial_age"], want["partial_age"])
                  and np.array_equal(got["partial_w"] > 0,
                                     want["partial_w"] > 0)
                  and all(got["buffer"][v]["age"] == e["age"]
                          and got["buffer"][v]["dest"] == e["dest"]
                          for v, e in buf.items()))}


def check_plans(ref, run):
    assert len(run["plans"]) == len(ref["plans"])
    assert run["plans"] == ref["plans"]


FLOAT_KEYS = ("energy", "latency", "rel_weight")
RECORD_KEYS = ("schema", "budgets", "accuracy") + COUNT_KEYS + FLOAT_KEYS


def check_records(ref, hist, keys=RECORD_KEYS):
    """Counts exactly; energy, latency, release weights and budgets 1e-5
    relative; accuracy 1e-4. A history has the buffer's tallies exactly
    where the reference's has them ("schema")."""
    assert len(hist) == len(ref["hist"])
    for jrec, rec in zip(ref["hist"], hist):
        if "schema" in keys:
            assert sorted(rec) == sorted(jrec)
        if "budgets" in keys:
            assert np.allclose(rec["budgets"], jrec["budgets"],
                               rtol=TOL_REL, atol=0)
        for jt, t in zip(jrec["tasks"] + [jrec], rec["tasks"] + [rec]):
            if "schema" in keys:
                assert sorted(t) == sorted(jt), rec["round"]
            for key in keys:
                if key in COUNT_KEYS:
                    assert t.get(key) == jt.get(key), (rec["round"], key)
                elif key in FLOAT_KEYS and key in jt:
                    assert abs(t[key] - jt[key]) <= TOL_REL * max(
                        abs(jt[key]), 1e-12), (rec["round"], key)
            if "accuracy" in keys:
                assert abs(t["accuracy"] - jt["accuracy"]) < 1e-4


STATE_PARTS = ("exact", "global", "partials", "partial_w", "buffer",
               "buffer_w")


def check_states(ref, states, parts=STATE_PARTS):
    """Every round's server state, the round started from the
    reference's: which partials are live, their ages and the buffer's
    vehicles, ages and destinations exactly ("exact"); the weights 1e-5
    relative; the trees 1e-4 of each leaf's largest entry."""
    for r, (got, want) in enumerate(zip(states, ref["states"][1:])):
        for t, (g, w) in enumerate(zip(got, want)):
            e = state_errors(g, w)
            for part in parts:
                if part == "exact":
                    assert e["exact"], (r, t)
                else:
                    tol = TOL_REL if part.endswith("_w") else TOL_STATE
                    assert e[part] <= tol, (r, t, part, e[part])


# ---------------------------------------------------------------------------
# The hierarchy's algebra, on random fleets
# ---------------------------------------------------------------------------

def _fleet(V, d1=12, d2=10, R=4, seed=0, L=2):
    """A random stacked fleet in both layouts: the reference's (lanes
    first) and the port's (lanes third from the end)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(L, V, d1, R)).astype(np.float32)
    b = rng.normal(size=(L, V, R, d2)).astype(np.float32)
    port = {"q": {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}}
    ref = {"q": {"a": jnp.asarray(np.moveaxis(a, 1, 0)),
                 "b": jnp.asarray(np.moveaxis(b, 1, 0))}}
    return port, ref


def _lane(tree, v):
    return interop.tree_map(lambda x: x.select(-3, v), tree)


def test_staleness_weights_match_reference():
    """decay**age as an f32 power: exactly 1.0 at age 0, strictly
    decreasing, the reference's values."""
    ages = np.arange(8, dtype=np.float32)
    for decay in (0.3, 0.6, 0.7, 1.0):
        got = agg.staleness_weights(ages, decay).numpy()
        want = np.asarray(jagg.staleness_weights(jnp.asarray(ages), decay))
        assert got.dtype == np.float32 and got[0] == 1.0
        assert np.allclose(got, want, rtol=1e-6, atol=0)
        if decay < 1.0:
            assert np.all(np.diff(got) < 0)
    # the host's float64 ages and the program's f32 ones agree
    assert torch.equal(agg.staleness_weights(np.arange(5), 0.7),
                       agg.staleness_weights(torch.arange(5.0), 0.7))


def test_sync_weights_match_reference():
    """Segments without uploads are exact no-ops; the rest sum to 1; one
    live partial weighs exactly 1.0."""
    data_w, ages = [3.0, 0.0, 5.0, 0.0], [0.0, 7.0, 2.0, 1.0]
    got = agg.sync_weights(data_w, ages, 0.5).numpy()
    want = np.asarray(jagg.sync_weights(jnp.asarray(data_w),
                                        jnp.asarray(ages), 0.5))
    assert got[1] == 0.0 and got[3] == 0.0
    assert np.allclose(got, want, rtol=1e-6, atol=0)
    assert abs(float(got.sum()) - 1.0) < 1e-6
    assert agg.sync_weights([4.0], [0.0], 0.6).tolist() == [1.0]


def test_segmented_partials_match_per_subset_aggregation():
    """Slot k of the segment sum equals aggregate_merged over the lanes
    associated with RSU k (an unassociated or zero-weight lane is an
    exact no-op), and the reference's segment sum."""
    V, K = 6, 3
    fleet, jfleet = _fleet(V)
    weights = np.asarray([2.0, 1.0, 0.0, 3.0, 1.5, 2.5], np.float32)
    assoc = np.asarray([0, 2, -1, 0, 2, 1])
    parts, seg_w = agg.aggregate_merged_padded_segmented(
        fleet, weights, assoc, K, scale=2.0)
    jparts, jseg_w = jagg.aggregate_merged_padded_segmented(
        jfleet, jnp.asarray(weights), jnp.asarray(assoc), K, scale=2.0)
    got = parts["q"]["delta"].numpy()
    assert got.shape == (2, K, 12, 10)
    assert np.allclose(got, np.moveaxis(np.asarray(jparts["q"]["delta"]),
                                        0, 1), atol=1e-5)
    assert np.allclose(seg_w.numpy(), np.asarray(jseg_w), rtol=1e-6)
    for k in range(K):
        sel = [v for v in range(V) if assoc[v] == k and weights[v] > 0]
        ref = agg.aggregate_merged([_lane(fleet, v) for v in sel],
                                   [float(weights[v]) for v in sel], 2.0)
        assert np.allclose(got[:, k], ref["q"]["delta"].numpy(), atol=1e-5)
        assert float(seg_w[k]) == pytest.approx(
            sum(float(weights[v]) for v in sel))


def test_merge_partials_with_period_one_equals_pooled_aggregation():
    """K > 1 with every age 0: the merge of the locally normalised
    partials equals the one-RSU aggregate over the same lanes."""
    V, K = 8, 3
    fleet, _ = _fleet(V, seed=3)
    rng = np.random.default_rng(5)
    weights = rng.uniform(0.5, 4.0, V).astype(np.float32)
    assoc = rng.integers(0, K, V)
    parts, seg_w = agg.aggregate_merged_padded_segmented(
        fleet, weights, assoc, K, scale=1.5)
    merged, alive = agg.merge_partials(parts, seg_w, np.zeros(K), 0.42)
    assert bool(alive)
    pooled = agg.aggregate_merged_padded(fleet, torch.from_numpy(weights),
                                         scale=1.5)
    assert np.allclose(merged["q"]["delta"].numpy(),
                       pooled["q"]["delta"].numpy(), atol=1e-5)


def test_merge_partials_matches_reference_with_stale_partials():
    """Partials of different ages merge at data weight times decay**age,
    as the reference's merge does."""
    K = 3
    rng = np.random.default_rng(2)
    parts = rng.normal(size=(K, 2, 5, 4)).astype(np.float32)
    w, ages = np.asarray([3.0, 0.0, 5.0]), np.asarray([0, 4, 2])
    got = agg.merge_partials(
        {"x": {"delta": torch.from_numpy(np.moveaxis(parts, 0, 1))}}, w,
        ages, 0.7)[0]["x"]["delta"].numpy()
    want = np.asarray(jagg.merge_partials(
        {"x": {"delta": jnp.asarray(parts)}}, jnp.asarray(w),
        jnp.asarray(ages, jnp.float32), 0.7)["x"]["delta"])
    assert np.allclose(got, want, atol=1e-6)


def test_hetlora_segmented_matches_per_subset():
    V, K, max_rank = 5, 2, 8
    fleet, jfleet = _fleet(V, R=4, seed=9)
    weights = np.asarray([1.0, 2.0, 3.0, 0.5, 1.5], np.float32)
    assoc = np.asarray([0, 1, 0, -1, 1])
    parts, _ = agg.aggregate_hetlora_segmented(fleet, weights, assoc, K,
                                               max_rank)
    jparts, _ = jagg.aggregate_hetlora_segmented(
        jfleet, jnp.asarray(weights), jnp.asarray(assoc), K, max_rank)
    for k in range(K):
        sel = [v for v in range(V) if assoc[v] == k]
        ref = agg.aggregate_hetlora([_lane(fleet, v) for v in sel],
                                    [float(weights[v]) for v in sel],
                                    max_rank)
        for f in ("a", "b"):
            got = parts["q"][f].select(-3, k).numpy()
            assert np.allclose(got, ref["q"][f].numpy(), atol=1e-5)
            assert np.allclose(got, np.asarray(jparts["q"][f][k]), atol=1e-5)


def test_merge_partials_all_stale_fallback():
    """Every partial aged past the float range: the sum is the zero tree
    and the merge flag is false, where the reference's merge with a
    ``fallback=`` returns the previous global (the port's server and
    program keep it on the flag); live weights merge as the
    reference's."""
    parts = {"x": {"delta": torch.ones((2, 3, 4))}}
    jparts = {"x": {"delta": jnp.ones((2, 3, 4))}}
    w = np.ones(2)
    fallback = {"x": {"delta": jnp.full((3, 4), 7.0)}}
    stale = np.full(2, 4000.0)
    merged, alive = agg.merge_partials(parts, w, stale, 0.5)
    assert not bool(alive)
    assert float(merged["x"]["delta"].abs().max()) == 0.0
    kept = jagg.merge_partials(jparts, jnp.asarray(w),
                               jnp.asarray(stale, jnp.float32), 0.5,
                               fallback=fallback)
    assert np.all(np.asarray(kept["x"]["delta"]) == 7.0)
    live, alive = agg.merge_partials(parts, w, np.zeros(2), 0.5)
    assert bool(alive)
    assert np.array_equal(live["x"]["delta"].numpy(), np.asarray(
        jagg.merge_partials(jparts, jnp.asarray(w), jnp.zeros(2), 0.5,
                            fallback=fallback)["x"]["delta"]))


def test_stack_and_unstack_partials_round_trip():
    trees = [{"x": {"delta": torch.full((2, 3, 4), float(k))}}
             for k in range(3)]
    stacked = agg.stack_partials(trees)
    assert tuple(stacked["x"]["delta"].shape) == (2, 3, 3, 4)
    back = agg.unstack_partials(stacked, 3)
    for t, b in zip(trees, back):
        assert torch.equal(t["x"]["delta"], b["x"]["delta"])


# ---------------------------------------------------------------------------
# The server's tier state
# ---------------------------------------------------------------------------

def _tiny(reference):
    return (jvit if reference else vit_base_paper).vit_base_paper(
    ).with_overrides(**TINY)


@pytest.mark.parametrize("method,residual,spec", [
    ("homolora", False, "tier"), ("fedra", False, "tier"),
    ("ours", True, "tier"), ("hetlora", False, "semi"),
    ("homolora", False, "semi"), ("ours", True, "semi")],
    ids=["tier-homolora", "tier-fedra", "tier-residual", "semi-hetlora",
         "semi-homolora", "semi-residual"])
def test_server_rejects_what_the_reference_rejects(method, residual, spec):
    """ValueError with the reference's message: a tier with HomoLoRA or
    FedRA, semi_sync with any method but ``ours``, residual aggregation
    with either."""
    def kw(reference):
        if spec == "tier":
            return {"tier": (JRSUTierSpec if reference else RSUTierSpec)(
                num_rsus_per_task=2)}
        return {"participation": (JParticipationSpec if reference else
                                  ParticipationSpec)(mode="semi_sync")}
    with pytest.raises(ValueError) as want:
        JRSUServer(_tiny(True), JLORA, method, residual=residual, **kw(True))
    with pytest.raises(ValueError) as got:
        RSUServer(_tiny(False), LORA, method, residual=residual, device="cpu",
                  **kw(False))
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]


@pytest.mark.parametrize("method", ["ours", "hetlora"])
def test_server_takes_a_tier(method):
    srv = RSUServer(_tiny(False), LORA, method, device="cpu",
                    tier=RSUTierSpec(num_rsus_per_task=2))
    assert srv.partials is None and srv.partial_w.tolist() == [0.0, 0.0]


def _clients(n, seed):
    fleet, _ = _fleet(n, seed=seed)
    return [_lane(fleet, v) for v in range(n)]


def test_server_tier_sync_period_defers_global():
    """sync_period 2: no global model after round 0, the ω-weighted merge
    of the partials after round 1 (the round-0 partial one round stale),
    then a new window; the reference's server on the same uploads."""
    tier = dict(num_rsus_per_task=2, sync_period=2, staleness_decay=0.5)
    srv = RSUServer(_tiny(False), LORA, "ours", device="cpu",
                    tier=RSUTierSpec(**tier))
    jsrv = JRSUServer(_tiny(True), JLORA, "ours", tier=JRSUTierSpec(**tier))
    clients = _clients(4, 11)
    jclients = [jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), c)
                for c in clients]
    for s, cl in ((srv, clients), (jsrv, jclients)):
        s.aggregate(cl[:2], [1.0, 2.0], assoc=[0, 0])
    assert srv.merged is None and jsrv.merged is None
    assert srv.partial_w.tolist() == [3.0, 0.0] and srv.partial_age[0] == 0
    for s, cl in ((srv, clients), (jsrv, jclients)):
        s.aggregate(cl[2:], [1.0, 1.0], assoc=[1, 1])
    assert srv.partial_w.sum() == 0.0 and srv.partial_age.sum() == 0
    p0 = agg.aggregate_merged(clients[:2], [1.0, 2.0], LORA.scale)
    p1 = agg.aggregate_merged(clients[2:], [1.0, 1.0], LORA.scale)
    w0, w1 = 3.0 * 0.5, 2.0
    want = (w0 * p0["q"]["delta"] + w1 * p1["q"]["delta"]) / (w0 + w1)
    got = srv.merged["q"]["delta"]
    assert torch.allclose(got, want, atol=1e-6)
    assert np.allclose(got.numpy(), np.asarray(jsrv.merged["q"]["delta"]),
                       atol=1e-6)
    assert srv.round == jsrv.round == 2


def test_tier_commit_all_stale_keeps_global():
    """A sync round whose every staleness discount underflowed keeps the
    previous global model instead of zeroing it."""
    srv = RSUServer(_tiny(False), LORA, "ours", device="cpu",
                    tier=RSUTierSpec(num_rsus_per_task=2, sync_period=1,
                                     staleness_decay=0.5))
    old = {"x": {"delta": torch.full((3, 4), 2.0)}}
    srv.merged = old
    srv.partials = [{"x": {"delta": torch.ones((3, 4))}}, None]
    srv.partial_w = np.asarray([1.0, 0.0])
    srv.partial_age = np.asarray([4000, 0])
    srv._tier_commit(refreshed={})
    assert srv.merged is old
    assert srv.partial_w.tolist() == [0.0, 0.0]


@pytest.mark.parametrize("method", ["ours", "hetlora"])
def test_grouped_tier_aggregation_matches_list_path(method):
    """The batched engine's segment sums over two rank groups equal the
    serial engine's per-client partials."""
    tier = RSUTierSpec(num_rsus_per_task=3, sync_period=2)
    srvs = [RSUServer(_tiny(False), LORA, method, device="cpu", tier=tier)
            for _ in range(2)]
    g2, _ = _fleet(3, R=2, seed=4)
    g4, _ = _fleet(4, R=4, seed=5)
    groups = [{"adapters": g2, "weights": np.asarray([1.0, 2.0, 3.0]),
               "assoc": np.asarray([0, 2, 0])},
              {"adapters": g4, "weights": np.asarray([2.0, 1.0, 1.0, 4.0]),
               "assoc": np.asarray([2, 2, 0, 0])}]
    srvs[0].aggregate_grouped(groups)
    clients = [_lane(g["adapters"], v) for g in groups
               for v in range(len(g["weights"]))]
    srvs[1].aggregate(clients, np.concatenate([g["weights"]
                                               for g in groups]),
                      assoc=np.concatenate([g["assoc"] for g in groups]))
    a, b = (server_state(s, False) for s in srvs)
    assert a["partials"][1] is None and b["partials"][1] is None
    assert a["partial_w"].tolist() == b["partial_w"].tolist() == [
        9.0, 0.0, 5.0]
    for k in (0, 2):
        assert tree_err(a["partials"][k], b["partials"][k]) < 1e-6


# ---------------------------------------------------------------------------
# Three rounds of the paper's method on the tier, under the serial and
# batched engines (the fused ones: test_torch_tier_fused.py)
# ---------------------------------------------------------------------------

ROUNDS = 3


_MEMO = {}


def reference(tmp_path_factory, mode, method, rounds):
    """:func:`reference_run` once per pytest run: the first worker
    that asks runs it, under a lock in the directory the workers share,
    and leaves it there; the others, and later files, read it. A
    reference's serial run takes ~25 s here (mostly XLA compiles), and
    two files hold the port's engines to each of the tier's and
    semi_sync's runs."""
    key = (mode, method, rounds)
    if key not in _MEMO:
        root = tmp_path_factory.getbasetemp()
        if os.environ.get("PYTEST_XDIST_WORKER"):
            root = root.parent
        name = f"reference-{mode}-{method}-{rounds}"
        path = root / f"{name}.pkl"
        with open(root / f"{name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if path.exists():
                with open(path, "rb") as fh:
                    _MEMO[key] = pickle.load(fh)
            else:
                _MEMO[key] = reference_run(mode, method, rounds)
                tmp = path.with_suffix(".tmp")
                with open(tmp, "wb") as fh:
                    pickle.dump(_MEMO[key], fh)
                tmp.rename(path)
    return _MEMO[key]


@pytest.fixture(scope="module", params=["serial", "batched",
                                        "batched_check"])
def runs(request, tmp_path_factory):
    ref = reference(tmp_path_factory, "tier", "ours", ROUNDS)
    return ref, port_run(ref, request.param)


def test_plans_match_reference(runs):
    check_plans(*runs)


@pytest.mark.parametrize("key", RECORD_KEYS)
def test_records_match_reference(runs, key):
    ref, run = runs
    check_records(ref, run["hist"], (key,))


@pytest.mark.parametrize("part", STATE_PARTS)
def test_server_states_match_reference(runs, part):
    ref, run = runs
    check_states(ref, run["states"], (part,))


def test_engine_check_dev_is_exact(runs):
    _, run = runs
    assert run["sim"].engine_check_dev == 0.0


def test_tier_syncs_and_charges_handoffs(runs):
    """Round 0 fills the partials (two or more live per task) but no
    task has a global model, so none evaluates one; round 1 syncs (the
    window resets) and every task has one; task 1 charges two handoffs
    in round 1. A sync history has no buffer tallies."""
    _, run = runs
    after = run["states"]
    for t in range(KW["num_tasks"]):
        assert after[0][t]["global"] is None
        assert int(np.sum(after[0][t]["partial_w"] > 0)) >= 2
        assert after[1][t]["global"] is not None
        assert after[1][t]["partial_w"].sum() == 0.0
        assert run["hist"][0]["tasks"][t]["accuracy"] == 0.0
    assert [r["tasks"][1]["handoffs"] for r in run["hist"]] == [0, 2, 0]
    assert "deferred" not in run["hist"][0]["tasks"][0]


def test_handoff_penalty_is_charged():
    """A handoff adds the tier's energy to its vehicle: round 1 without
    the penalty costs task 1 its two handoffs' 2 × 6 J less."""
    costs = []
    for energy in (6.0, 0.0):
        cfg = sim_config("tier", "ours", False, engine="batched")
        cfg = dataclasses.replace(cfg, rsu_tier=dataclasses.replace(
            cfg.rsu_tier, handoff_energy=energy))
        sim = IoVSimulator(cfg, device="cpu")
        costs.append([sim.run_round() for _ in range(2)][-1])
    t1 = [c["tasks"][1] for c in costs]
    assert t1[0]["handoffs"] == t1[1]["handoffs"] == 2
    assert t1[0]["energy"] - t1[1]["energy"] == pytest.approx(12.0, abs=1e-3)
