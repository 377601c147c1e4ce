"""The port's batched round engine on the CPU: its trainer against the
reference's batched trainer and against the port's own serial trainer,
lane by lane; grouped aggregation against the list path and the
reference's; the identity cache; ``batched_check`` in the simulator.

Inputs are numpy arrays from a seed. One reference call in the file (its
``BatchedLocalTrainer.finetune_group``, ~12 s of XLA compiles), on the
reference suite's tiny config. Tolerances, the reference suite's
(``tests/test_batched_engine.py``): adapters 1e-5, eval accuracy 1e-6,
loss 1e-4; grouped aggregation 1e-5 of each leaf's largest entry;
``engine_check_dev`` < 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LoRAConfig as JLoRAConfig
from repro.configs import vit_base_paper as jvit
from repro.core import aggregation as jagg
from repro.data import ClientDataset as JClientDataset
from repro.federated.batched_client import BatchedLocalTrainer as JBatched
from repro.federated.batched_client import stack_trees as jstack
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.config import LoRAConfig
from repro_torch.configs import vit_base_paper
from repro_torch.core import aggregation as agg
from repro_torch.core.cache import IdentityLRU
from repro_torch.data import ClientDataset
from repro_torch.federated.batched_client import (BatchedLocalTrainer,
                                                  draw_batches, stack_trees,
                                                  take_lanes, unstack_tree)
from repro_torch.federated.client import LocalTrainer
from repro_torch.federated.server import RSUServer
from repro_torch.models import transformer as T
from repro_torch.optim.adam import leaves
from repro_torch.sim.simulator import IoVSimulator, SimConfig

LORA = LoRAConfig(rank=4, max_rank=8, candidate_ranks=(2, 4, 8))
JLORA = JLoRAConfig(rank=4, max_rank=8, candidate_ranks=(2, 4, 8))
B, S, STEPS, LR = 4, 8, 3, 5e-3
TOL_AD, TOL_ACC, TOL_LOSS = 1e-5, 1e-6, 1e-4
TINY = dict(name="vit-test-engine", num_layers=2, d_model=32, num_heads=2,
            num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are tiny; with the suite's parallel workers each
    running a full intra-op thread pool, the workers' threads spin on
    oversubscribed cores. One thread per worker, restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(**extra):
    return vit_base_paper.vit_base_paper().with_overrides(**TINY, **extra)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(n_vehicles, seed, per_shard=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, TINY["vocab_size"],
                        (n_vehicles * per_shard, S)).astype(np.int32)
    labs = rng.integers(0, 8, (n_vehicles * per_shard,)).astype(np.int32)
    shards = [(toks[i * per_shard:(i + 1) * per_shard],
               labs[i * per_shard:(i + 1) * per_shard])
              for i in range(n_vehicles)]
    return shards, {"tokens": toks[:16], "labels": labs[:16]}


def _max_dev(a, b):
    return max(float(torch.max(torch.abs(x - y)))
               for x, y in zip(leaves(a), leaves(b)))


def _nontrivial(ad, seed):
    """b drawn off its zero init, so a's gradients are not all 0."""
    g = torch.Generator().manual_seed(seed)

    def fix(node):
        if isinstance(node, dict) and "a" in node and "b" in node:
            return {"a": node["a"],
                    "b": 0.05 * torch.randn(node["b"].shape, generator=g)}
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return [fix(v) for v in node]
    return fix(ad)


# ---------------------------------------------------------------------------
# The trainer against the reference's, once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_group():
    """Three vehicles at rank 2 with step budgets 1, 3 and 2, through the
    reference's batched trainer and the port's, on the same batches."""
    jcfg = jvit.vit_base_paper().with_overrides(**TINY)
    jparams = JT.init_params(jax.random.PRNGKey(1), jcfg, dtype=jnp.float32)
    counts = [1, 3, 2]
    shards, evb = _data(len(counts), seed=3)
    dss = [JClientDataset(t, lab, B, seed=3 + i)
           for i, (t, lab) in enumerate(shards)]
    batches = [draw_batches(ds, c, STEPS) for ds, c in zip(dss, counts)]
    jads = [JT.init_adapters(jax.random.PRNGKey(20 + i), jcfg, JLORA, rank=2)
            for i in range(len(counts))]
    jout, jm = JBatched(jcfg, JLORA, lr=LR, max_steps=STEPS).finetune_group(
        jparams, jads, batches, counts, eval_batch=evb)
    params = interop.params_from_jax(_np(jparams), device="cpu")
    ads = [interop.adapters_from_jax(_np(a), device="cpu") for a in jads]
    stacked, m = BatchedLocalTrainer(_cfg(), LORA, lr=LR, max_steps=STEPS,
                                     device="cpu").finetune_group_stacked(
        params, ads, batches, counts, eval_batch=evb)
    return jout, jm, unstack_tree(stacked, len(counts)), m


def test_batched_trainer_matches_reference(reference_group):
    jout, jm, out, m = reference_group
    for i in range(len(out)):
        want = interop.adapters_from_jax(_np(jout[i]), device="cpu")
        assert _max_dev(out[i], want) < TOL_AD, i
        assert abs(m["eval_accuracy"][i] - jm[i]["eval_accuracy"]) < TOL_ACC
        assert abs(m["loss"][i] - jm[i]["loss"]) < TOL_LOSS, i
        assert abs(m["accuracy"][i] - jm[i]["accuracy"]) < TOL_ACC, i
        assert sorted(m) == sorted(jm[i])


# ---------------------------------------------------------------------------
# The batched trainer against the port's serial trainer, lane by lane
# ---------------------------------------------------------------------------

def _serial(trainer, params, ad, batches, steps, evb, mask=None):
    per_step = [{k: a[si] for k, a in batches.items()}
                for si in range(steps)]
    return trainer.finetune(params, ad, None, steps, eval_batch=evb,
                            layer_mask=mask, batches=per_step)


# (ranks of the lanes, step budgets, per-lane layer masks, shared tree,
# extra model config)
CASES = {
    "two_rank_groups": ([2, 4, 2, 4, 4], [3, 2, 1, 3, 3], None, False, {}),
    "layer_masks": ([4, 4, 4], [3, 3, 2],
                    [[1.0, 0.0], None, [0.0, 1.0]], False, {}),
    "ten_lanes_shared": ([4] * 10, [3, 2] * 5, None, True, {}),
    "qkv_bias": ([2, 2, 4], [3, 1, 2], None, False, {"qkv_bias": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_trainer_matches_serial_lane_by_lane(case):
    ranks, counts, masks, shared, extra = CASES[case]
    cfg = _cfg(**extra)
    params = T.init_params(cfg, seed=5, dtype=torch.float32, device="cpu")
    if extra.get("qkv_bias"):   # biases off zero, so they matter
        g = torch.Generator().manual_seed(6)
        for name in ("q", "k", "v"):
            p = params["segments"][0]["attn"][name]
            p["b"] = 0.1 * torch.randn(p["b"].shape, generator=g)
    shards, evb = _data(len(ranks), seed=11)
    batches = [draw_batches(ClientDataset(t, lab, B, seed=40 + i), c, STEPS)
               for i, ((t, lab), c) in enumerate(zip(shards, counts))]
    base = {r: _nontrivial(T.init_adapters(cfg, LORA, seed=r, rank=r,
                                           device="cpu"), r)
            for r in set(ranks)}
    ads = [base[r] if shared else
           _nontrivial(T.init_adapters(cfg, LORA, seed=50 + i, rank=r,
                                       device="cpu"), 60 + i)
           for i, r in enumerate(ranks)]
    serial = LocalTrainer(cfg, LORA, lr=LR, device="cpu")
    want = [_serial(serial, params, ads[i], batches[i], counts[i], evb,
                    None if masks is None else masks[i])
            for i in range(len(ranks))]

    trainer = BatchedLocalTrainer(cfg, LORA, lr=LR, max_steps=STEPS,
                                  device="cpu")
    groups = {}
    for i, r in enumerate(ranks):
        groups.setdefault(r, []).append(i)
    jobs = [{"adapters_list": [ads[i] for i in idxs],
             "batches_list": [batches[i] for i in idxs],
             "step_counts": [counts[i] for i in idxs], "eval_batch": evb,
             "layer_masks": None if masks is None else
             [masks[i] for i in idxs]}
            for idxs in groups.values()]
    for idxs, (stacked, m) in zip(groups.values(),
                                  trainer.run_jobs(params, jobs)):
        for j, lane in enumerate(unstack_tree(stacked, len(idxs))):
            ad, wm = want[idxs[j]]
            assert _max_dev(lane, ad) < TOL_AD, (case, idxs[j])
            assert abs(m["eval_accuracy"][j] - wm["eval_accuracy"]) < TOL_ACC
            assert abs(m["loss"][j] - wm["loss"]) < TOL_LOSS
            assert abs(m["accuracy"][j] - wm["accuracy"]) < TOL_ACC
    if masks is not None:   # lane 0's masked-out layer 1 did not move
        got = unstack_tree(trainer.finetune_group_stacked(
            params, ads[:1], batches[:1], counts[:1],
            layer_masks=masks[:1])[0], 1)[0]
        assert _max_dev([t[1] for t in leaves(got)],
                        [t[1] for t in leaves(ads[0])]) == 0.0
        assert _max_dev([t[0] for t in leaves(got)],
                        [t[0] for t in leaves(ads[0])]) > 0.0


def test_shared_tree_gets_per_lane_gradients():
    """One tree shared by every lane trains each lane on its own batches:
    two lanes with different data end apart, as in the serial engine."""
    cfg = _cfg()
    params = T.init_params(cfg, seed=2, dtype=torch.float32, device="cpu")
    shards, _ = _data(2, seed=4)
    batches = [draw_batches(ClientDataset(t, lab, B, seed=i), 2, 2)
               for i, (t, lab) in enumerate(shards)]
    ad = _nontrivial(T.init_adapters(cfg, LORA, seed=3, rank=4,
                                     device="cpu"), 3)
    trainer = BatchedLocalTrainer(cfg, LORA, lr=LR, max_steps=2,
                                  device="cpu")
    l0, l1 = unstack_tree(trainer.finetune_group_stacked(
        params, [ad, ad], batches, [2, 2])[0], 2)
    assert _max_dev(l0, l1) > 1e-4
    serial = LocalTrainer(cfg, LORA, lr=LR, device="cpu")
    assert _max_dev(l1, _serial(serial, params, ad, batches[1], 2,
                                None)[0]) < TOL_AD


@pytest.mark.parametrize("labels", ["class", "next_token"])
def test_lane_loss_is_each_lanes_own(labels):
    """loss_fn(lanes=V) gives each lane the loss and accuracy of its own
    rows, and the sum of the lanes' losses; lanes=None is unchanged."""
    cfg = _cfg()
    params = T.init_params(cfg, seed=7, dtype=torch.float32, device="cpu")
    V = 3
    ads = [_nontrivial(T.init_adapters(cfg, LORA, seed=70 + i, rank=4,
                                       device="cpu"), 70 + i)
           for i in range(V)]
    rng = np.random.default_rng(8)
    tok = torch.from_numpy(rng.integers(0, 32, (V, B, S)))
    if labels == "class":
        lab = torch.from_numpy(rng.integers(0, 8, (V, B)))
    else:
        lab = torch.from_numpy(rng.integers(0, 32, (V, B, S)))
        lab[:, :, :2] = -100
    total, m = T.loss_fn(params, stack_trees(ads), cfg, LORA,
                         {"tokens": tok.reshape(V * B, S),
                          "labels": lab.reshape((V * B,) + lab.shape[2:])},
                         lanes=V)
    assert m["loss"].shape == m["accuracy"].shape == (V,)
    for v in range(V):
        lv, mv = T.loss_fn(params, ads[v], cfg, LORA,
                           {"tokens": tok[v], "labels": lab[v]})
        assert abs(float(m["loss"][v]) - float(lv)) < 1e-6
        assert abs(float(m["accuracy"][v]) - float(mv["accuracy"])) < 1e-7
    assert abs(float(total) - float(m["loss"].sum())) < 1e-6


def test_trainer_refuses_wrong_budgets():
    cfg = _cfg()
    trainer = BatchedLocalTrainer(cfg, LORA, max_steps=2, device="cpu")
    ad = T.init_adapters(cfg, LORA, rank=2, device="cpu")
    b = {"tokens": np.zeros((2, B, S), np.int32),
         "labels": np.zeros((2, B), np.int32)}
    with pytest.raises(ValueError):
        trainer.finetune_group_stacked(None, [ad], [b], [3])
    with pytest.raises(ValueError):
        trainer.finetune_group_stacked(None, [ad, ad], [b], [1, 1])
    with pytest.raises(ValueError):
        draw_batches(None, 3, 2)


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedLocalTrainer(_cfg(), LORA)


# ---------------------------------------------------------------------------
# Grouped aggregation
# ---------------------------------------------------------------------------

def _clients(cfg, ranks, seed=0):
    return [_nontrivial(T.init_adapters(cfg, LORA, seed=seed + i, rank=r,
                                        device="cpu"), seed + 100 + i)
            for i, r in enumerate(ranks)]


def _by_rank(ranks):
    groups = {}
    for i, r in enumerate(ranks):
        groups.setdefault(r, []).append(i)
    return [groups[r] for r in sorted(groups)]


def _leaf_rel(got, want):
    """Largest error over each merged-delta leaf's largest entry."""
    worst = 0.0
    for p in agg.tree_paths_delta(want):
        w = np.asarray(agg.tree_get(want, p)["delta"], np.float32)
        g = np.asarray(agg.tree_get(got, p)["delta"], np.float32)
        assert g.shape == w.shape
        worst = max(worst, float(np.max(np.abs(g - w)))
                    / max(float(np.max(np.abs(w))), 1e-30))
    return worst


RANKS = [2, 4, 2, 8, 4]
WEIGHTS = [2.0, 1.0, 3.0, 0.5, 1.5]


def test_aggregate_merged_grouped_matches_list_and_reference():
    cfg = _cfg()
    clients = _clients(cfg, RANKS)
    want = agg.aggregate_merged(clients, WEIGHTS, LORA.scale)
    groups = [(stack_trees([clients[i] for i in idx]),
               np.asarray([WEIGHTS[i] for i in idx], np.float32))
              for idx in _by_rank(RANKS)]
    got = agg.aggregate_merged_grouped(groups, LORA.scale)
    assert _leaf_rel(got, want) < 1e-5
    # the reference's on the same numbers, its lane axis in front
    jgroups = [(jstack([jax.tree_util.tree_map(
        jnp.asarray, interop.to_numpy(clients[i])) for i in idx]),
        np.asarray([WEIGHTS[i] for i in idx], np.float32))
        for idx in _by_rank(RANKS)]
    jwant = jagg.aggregate_merged_grouped(jgroups, LORA.scale)
    assert _leaf_rel(got, _np(jwant)) < 1e-5


@pytest.mark.parametrize("change", ["scaled_weights", "zero_weight_lane"])
def test_aggregate_merged_grouped_weights(change):
    """The weights are normalised over all groups: scaling every weight
    leaves the merge as it was, and a lane of weight 0 adds nothing."""
    cfg = _cfg()
    clients = _clients(cfg, RANKS, seed=60)
    groups = [(stack_trees([clients[i] for i in idx]),
               np.asarray([WEIGHTS[i] for i in idx], np.float32))
              for idx in _by_rank(RANKS)]
    want = agg.aggregate_merged_grouped(groups, LORA.scale)
    if change == "scaled_weights":
        other = [(st, 8.0 * w) for st, w in groups]
    else:   # one more lane, of weight 0, in the first group
        extra = _clients(cfg, [RANKS[0]], seed=99)[0]
        first = _by_rank(RANKS)[0]
        other = [(stack_trees([clients[i] for i in first] + [extra]),
                  np.append(groups[0][1], np.float32(0.0)))] + groups[1:]
    assert _leaf_rel(agg.aggregate_merged_grouped(other, LORA.scale),
                     want) < 1e-6


def test_server_aggregate_grouped_matches_list_path():
    cfg = _cfg()
    sa = RSUServer(cfg, LORA, "ours", seed=11, device="cpu")
    sb = RSUServer(cfg, LORA, "ours", seed=11, device="cpu")
    clients = _clients(cfg, RANKS, seed=30)
    sa.aggregate(clients, WEIGHTS)
    sb.aggregate_grouped([
        {"adapters": stack_trees([clients[i] for i in idx]),
         "weights": np.asarray([WEIGHTS[i] for i in idx], np.float32),
         "indices": idx} for idx in _by_rank(RANKS)])
    assert sa.round == sb.round == 1
    assert _leaf_rel(sb.merged, sa.merged) < 1e-5
    # no group: the state stays and the round advances
    before = sb.merged
    sb.aggregate_grouped([])
    assert sb.merged is before and sb.round == 2


def test_take_lanes_and_unstack_invert_stack():
    cfg = _cfg()
    clients = _clients(cfg, [4, 4, 4], seed=90)
    stacked = stack_trees(clients)
    assert leaves(stacked)[0].shape[:2] == (cfg.num_layers, 3)
    for lane, ad in zip(unstack_tree(stacked, 3), clients):
        assert _max_dev(lane, ad) == 0.0
    sub = unstack_tree(take_lanes(stacked, [2, 0]), 2)
    assert _max_dev(sub[0], clients[2]) == _max_dev(sub[1], clients[0]) == 0


# ---------------------------------------------------------------------------
# The identity cache
# ---------------------------------------------------------------------------

def test_identity_lru_identity_and_eviction():
    lru = IdentityLRU(maxsize=2)
    a, b, c = {"x": 1}, {"x": 2}, {"x": 3}
    lru.put(a, "A")
    lru.put(b, "B")
    assert lru.get(a) == "A" and lru.get(b) == "B"
    lru.put(c, "C")           # evicts a (least recently used)
    assert lru.get(a) is None and len(lru) == 2
    # identity, not equality: a look-alike never hits
    assert lru.get(dict(b)) is None
    # ``extra`` is part of the key: (b, 1) evicts (b, None), not c
    lru.put(b, "B2", extra=1)
    assert lru.get(b, extra=1) == "B2" and lru.get(b) is None
    assert lru.get(c) == "C"


@pytest.mark.parametrize("maxsize", [0, -1])
def test_identity_lru_refuses_an_empty_bound(maxsize):
    with pytest.raises(ValueError, match="maxsize"):
        IdentityLRU(maxsize)


def test_trainer_eval_cache_stays_bounded_over_rounds():
    """Fresh eval-batch dicts every round (the leak case) keep the
    trainer's eval cache at its bound; the same dict hits."""
    cfg = _cfg()
    params = T.init_params(cfg, seed=4, dtype=torch.float32, device="cpu")
    shards, _ = _data(1, seed=9)
    ds = ClientDataset(*shards[0], B, seed=9)
    ad = T.init_adapters(cfg, LORA, seed=50, rank=4, device="cpu")
    trainer = BatchedLocalTrainer(cfg, LORA, lr=LR, max_steps=1,
                                  device="cpu")
    sizes = []
    for _ in range(20):
        evb = {"tokens": np.asarray(ds.tokens[:8]),
               "labels": np.asarray(ds.labels[:8])}
        trainer.finetune_group_stacked(params, [ad], [draw_batches(ds, 1, 1)],
                                       [1], eval_batch=evb)
        sizes.append(len(trainer._eval_cache))
    assert max(sizes) <= trainer._eval_cache.maxsize
    assert len(set(sizes[-5:])) == 1, sizes
    cached = trainer._eval_batch(evb)
    assert trainer._eval_batch(evb) is cached


# ---------------------------------------------------------------------------
# batched_check in the simulator
# ---------------------------------------------------------------------------

def test_batched_check_deviation_with_two_rank_groups():
    """8 vehicles, seed 1: in round 1 task 0 trains ranks 2 and 4 (a
    vehicle first active then explores its first arm)."""
    sim = IoVSimulator(SimConfig(method="ours", engine="batched_check",
                                 num_vehicles=8, num_tasks=2, local_steps=2,
                                 seed=1), device="cpu")
    seen = []
    check = sim._check_against_serial

    def spy(plans, results):
        seen.append([sorted(res["groups"]) for res in results])
        return check(plans, results)
    sim._check_against_serial = spy
    sim.run(2)
    assert any(len(g) >= 2 for rnd in seen for g in rnd), seen
    assert 0.0 <= sim.engine_check_dev < 1e-5


def test_batched_engine_matches_serial_engine_over_rounds():
    """The same SimConfig under both engines: ranks, active sets,
    comm_params exact; energy 1e-5 relative; accuracy 1e-4."""
    kw = dict(method="ours", num_vehicles=8, num_tasks=2, local_steps=2,
              seed=1)
    hist = {e: IoVSimulator(SimConfig(engine=e, **kw), device="cpu").run(2)
            for e in ("serial", "batched")}
    for rs, rb in zip(hist["serial"], hist["batched"]):
        for ts, tb in zip(rs["tasks"], rb["tasks"]):
            for key in ("mean_rank", "active", "comm_params", "fallbacks"):
                assert ts[key] == tb[key], (rs["round"], key)
            assert tb["energy"] == pytest.approx(ts["energy"], rel=1e-5)
            assert abs(tb["accuracy"] - ts["accuracy"]) < 1e-4
