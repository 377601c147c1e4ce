"""The port's method modules against the reference's, on the CPU.

Modules: HetLoRA's capability ranks; the baselines' reductions
(HomoLoRA's stacked mean, HetLoRA's zero-padding average list and
grouped, its self-pruning rank, FedRA's layer mask with the reference's
permutation injected, its layer mix and its per-layer average list and
stacked); the server's uplink volume; and, as the reference's
``tests/test_batched_engine.py`` holds them, each method's grouped
aggregation against its list path and the residual branch with
zero-weight lanes. Inputs are numpy-seeded trees on the reference
suite's tiny config; tolerance 1e-5 of each leaf's largest entry (f32
sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vit_base_paper as jvit
from repro.core import aggregation as jagg
from repro.federated import baselines as jbase
from repro.federated.batched_client import stack_trees as jstack
from repro.federated.server import RSUServer as JServer
from repro_torch import interop
from repro_torch.core import aggregation as agg
from repro_torch.federated import baselines
from repro_torch.federated.batched_client import stack_trees
from repro_torch.federated.server import RSUServer
from repro_torch.models import transformer as T
from repro_torch.optim.adam import leaves
from repro_torch.sim.simulator import IoVSimulator, SimConfig
from test_torch_batched import JLORA, LORA, TINY, _cfg, one_torch_thread  # noqa: F401

TOL = 1e-5
WEIGHTS = [2.0, 1.0, 3.0, 0.5, 1.5]


def _trees(ranks, seed):
    """One adapter tree per rank on the tiny config, numpy-seeded."""
    rng = np.random.default_rng(seed)
    out = []
    for r in ranks:
        like = T.init_adapters(_cfg(), LORA, rank=r, device="cpu")
        out.append(interop.tree_map(lambda t: torch.from_numpy(
            rng.normal(0.0, 0.1, tuple(t.shape)).astype(np.float32)), like))
    return out


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, interop.to_numpy(tree))


def _numpy(tree):
    """Either package's tree as numpy leaves."""
    return interop.tree_map(
        lambda x: (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                   else np.asarray(x)), tree)


def _err(got, want) -> float:
    """Largest |got - want| over each leaf's largest |want| (at least 1),
    leaf by path (adapter or merged-delta nodes)."""
    got, want = _numpy(got), _numpy(want)
    paths = agg.tree_paths(want) or agg.tree_paths_delta(want)
    assert sorted(paths) == sorted(agg.tree_paths(got)
                                   or agg.tree_paths_delta(got))
    worst = 0.0
    for p in paths:
        w_node, g_node = agg.tree_get(want, p), agg.tree_get(got, p)
        for k, w in w_node.items():
            g = g_node[k]
            assert g.shape == w.shape, (p, k)
            worst = max(worst, float(np.max(np.abs(g - w)))
                        / max(1.0, float(np.max(np.abs(w)))))
    return worst


def _groups(trees, weights, ranks):
    """The per-rank groups of a client list: [(indices, port stacked,
    reference stacked, weights)]."""
    by = {}
    for i, r in enumerate(ranks):
        by.setdefault(r, []).append(i)
    return [(idx, stack_trees([trees[i] for i in idx]),
             jstack([_j(trees[i]) for i in idx]),
             np.asarray([weights[i] for i in idx], np.float32))
            for idx in (by[r] for r in sorted(by))]


# ---------------------------------------------------------------------------
# Baselines' module functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 24])
def test_capability_ranks_match_reference(n):
    freqs = np.random.default_rng(n).uniform(1e9, 3e9, n)
    cand = (2, 4, 8, 16, 32)
    got = baselines.capability_ranks(cand, freqs)
    assert np.array_equal(got, jbase.capability_ranks(cand, freqs))
    assert set(got.tolist()) <= set(cand)


def test_capability_ranks_of_the_default_fleet():
    """The default SimConfig's fleet: the reference's ranks at seed 0."""
    sim = IoVSimulator(SimConfig(method="hetlora"), device="cpu")
    assert sim._het_ranks.tolist() == [
        16, 2, 16, 32, 32, 2, 4, 2, 16, 32, 16, 16, 8, 4, 8, 32, 2, 4, 4,
        32, 8, 8, 4, 2]


@pytest.mark.parametrize("name", ["ours", "ours_no_energy",
                                  "ours_no_mobility", "ours_residual",
                                  "homolora", "hetlora", "fedra"])
def test_server_method_and_residual_match_reference(name):
    assert baselines.server_method(name) == jbase.server_method(name)
    assert baselines.is_residual(name) == jbase.is_residual(name)
    assert dataclasses.asdict(baselines.METHODS[name]) == \
        dataclasses.asdict(jbase.METHODS[name])


def test_average_stacked_grouped_matches_reference():
    ranks = [4, 4, 4, 4, 4]
    trees = _trees(ranks, 1)
    gs = _groups(trees, WEIGHTS, [0, 0, 1, 1, 1])
    got = agg.average_stacked_grouped([(st, w) for _, st, _, w in gs])
    want = jagg.average_stacked_grouped([(jst, w) for _, _, jst, w in gs])
    assert _err(got, want) < TOL


def test_aggregate_hetlora_list_and_grouped_match_reference():
    ranks = [2, 4, 2, 8, 4]
    trees = _trees(ranks, 2)
    want = jagg.aggregate_hetlora([_j(t) for t in trees], WEIGHTS, 8)
    got = agg.aggregate_hetlora(trees, WEIGHTS, 8)
    assert _err(got, want) < TOL
    gs = _groups(trees, WEIGHTS, ranks)
    grouped = agg.aggregate_hetlora_grouped([(st, w) for _, st, _, w in gs],
                                            8)
    jgrouped = jagg.aggregate_hetlora_grouped(
        [(jst, w) for _, _, jst, w in gs], 8)
    assert _err(grouped, jgrouped) < TOL
    assert _err(grouped, got) < TOL


@pytest.mark.parametrize("gamma", [0.5, 0.9, 0.99])
def test_hetlora_prune_rank_matches_reference(gamma):
    tree = _trees([8], 3)[0]
    # a decaying column mass, so that the rank depends on gamma
    decay = torch.pow(torch.tensor(0.6), torch.arange(8.0))
    for p in agg.tree_paths(tree):
        ad = agg.tree_get(tree, p)
        tree = agg.tree_set(tree, p, {"a": ad["a"] * decay,
                                      "b": ad["b"] * decay[:, None]})
    got = agg.hetlora_prune_rank(tree, gamma)
    assert got == jagg.hetlora_prune_rank(_j(tree), gamma)
    assert 1 <= got <= 8


@pytest.mark.parametrize("L,fraction", [(2, 0.6), (12, 0.6), (12, 0.05),
                                        (12, 1.0)])
def test_fedra_layer_mask_with_injected_permutation(L, fraction):
    for seed in range(4):
        k = jax.random.PRNGKey(seed)
        want = np.asarray(jagg.fedra_layer_mask(k, L, fraction))
        perm = np.asarray(jax.random.permutation(k, L))
        got = agg.fedra_layer_mask(L, fraction, perm=perm)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), want)
    # the default draw: from the generator, round(fraction·L) layers
    g = torch.Generator().manual_seed(0)
    m = agg.fedra_layer_mask(L, fraction, generator=g)
    assert float(m.sum()) == max(1, round(fraction * L))
    assert torch.equal(m, agg.fedra_layer_mask(
        L, fraction, generator=torch.Generator().manual_seed(0)))


def test_apply_layer_mask_matches_reference():
    new, old = _trees([4, 4], 4)
    mask = np.asarray([1.0, 0.0], np.float32)
    got = agg.apply_layer_mask(new, old, torch.from_numpy(mask))
    want = jagg.apply_layer_mask(_j(new), _j(old), jnp.asarray(mask))
    assert _err(got, want) < TOL
    for path in agg.tree_paths(got):
        for k in ("a", "b"):
            assert torch.equal(agg.tree_get(got, path)[k][1],
                               agg.tree_get(old, path)[k][1])


def test_aggregate_fedra_list_and_stacked_match_reference():
    ranks = [4] * 5
    trees = _trees(ranks, 5)
    L = _cfg().num_layers
    rng = np.random.default_rng(5)
    masks = (rng.uniform(size=(5, L)) < 0.5).astype(np.float32)
    masks[0] = 0.0          # a client that trained no layer
    masks[1, 0] = 1.0       # every layer trained by someone
    got = agg.aggregate_fedra(trees, WEIGHTS, [torch.from_numpy(m)
                                               for m in masks])
    want = jagg.aggregate_fedra([_j(t) for t in trees], WEIGHTS,
                                [jnp.asarray(m) for m in masks])
    assert _err(got, want) < TOL
    stacked = agg.aggregate_fedra_stacked(stack_trees(trees), WEIGHTS, masks)
    jstacked = jagg.aggregate_fedra_stacked(
        jstack([_j(t) for t in trees]), WEIGHTS, jnp.asarray(masks))
    assert _err(stacked, jstacked) < TOL
    assert _err(stacked, got) < TOL


@pytest.mark.parametrize("method", ["ours", "homolora", "hetlora",
                                    "fedra"])
def test_comm_params_per_round_matches_reference(method):
    jcfg = jvit.vit_base_paper().with_overrides(**TINY)
    ranks = [2, 4, 8, 4, 2]
    got = RSUServer(_cfg(), LORA, method, device="cpu")
    want = JServer(jcfg, JLORA, method)
    assert got.comm_params_per_round(ranks) == \
        want.comm_params_per_round(ranks)


# ---------------------------------------------------------------------------
# The server: grouped aggregation equals the list path (the reference's
# tests/test_batched_engine.py, ported)
# ---------------------------------------------------------------------------

def _clients(ads, rnd=0):
    """Distributed trees made to differ per client, by numpy-seeded noise
    (b starts at 0; a constant shift would leave every product rank 1)."""
    rng = np.random.default_rng(100 + rnd)
    return [interop.tree_map(lambda x: x + torch.from_numpy(rng.normal(
        0.0, 0.01, tuple(x.shape)).astype(np.float32)), ad) for ad in ads]


@pytest.mark.parametrize("method", ["ours", "homolora", "hetlora",
                                    "fedra"])
def test_grouped_aggregation_matches_list_path(method):
    cfg = _cfg()
    ranks = [2, 2, 4] if method in ("ours", "hetlora") else [4, 4, 4]
    sa = RSUServer(cfg, LORA, method, seed=11, device="cpu")
    sb = RSUServer(cfg, LORA, method, seed=11, device="cpu")
    clients = _clients(sa.distribute(list(ranks)))
    sb.distribute(list(ranks))
    weights = [2.0, 1.0, 3.0]
    masks = sa.masks if method == "fedra" else None
    if masks is not None:
        assert len(masks) == 3 and all(
            torch.equal(m, n) for m, n in zip(masks, sb.masks))
    sa.aggregate(clients, weights, masks=list(masks) if masks else None,
                 indices=list(range(3)))
    gspecs = [{"adapters": st, "weights": w,
               "masks": (np.stack([np.asarray(masks[i]) for i in idx])
                         if masks else None),
               "indices": idx}
              for idx, st, _, w in _groups(clients, weights, ranks)]
    sb.aggregate_grouped(gspecs)
    state = "merged" if method == "ours" else "global_adapters"
    assert sa.round == sb.round == 1
    assert _err(getattr(sb, state), getattr(sa, state)) < TOL
    # the reference's list path on the same clients and masks
    js = JServer(jvit.vit_base_paper().with_overrides(**TINY), JLORA,
                 method, seed=11)
    js.distribute(list(ranks))
    js.aggregate([_j(c) for c in clients], weights,
                 masks=[jnp.asarray(np.asarray(m)) for m in masks]
                 if masks else None, indices=list(range(3)))
    assert _err(getattr(sa, state), getattr(js, state)) < TOL


def test_grouped_residual_aggregation_matches_list_path():
    """merged += new − old over the distributed bases, with a zero-weight
    pad lane per group, as the reference's batched simulator emits."""
    cfg = _cfg()
    ranks = [2, 4, 4]
    sa = RSUServer(cfg, LORA, "ours", seed=13, residual=True, device="cpu")
    sb = RSUServer(cfg, LORA, "ours", seed=13, residual=True, device="cpu")
    weights = [1.0, 2.0, 1.5]
    for rnd in range(2):   # round 1: merged is set, the residual branch
        clients = _clients(sa.distribute(list(ranks)), rnd)
        sb.distribute(list(ranks))
        sa.aggregate(clients, list(weights), indices=list(range(3)))
        gspecs = []
        for idx, _, _, w in _groups(clients, weights, ranks):
            gspecs.append({
                "adapters": stack_trees([clients[i] for i in idx]
                                        + [clients[idx[0]]]),
                "weights": np.append(w, np.float32(0.0)),
                "masks": None, "indices": idx + [idx[0]]})
        sb.aggregate_grouped(gspecs)
        assert _err(sb.merged, sa.merged) < TOL
    # the branch fired: the replace rule would give another state
    plain = RSUServer(cfg, LORA, "ours", seed=13, device="cpu")
    plain.aggregate(clients, list(weights))
    apart = [np.abs(a - b).max() / np.abs(b).max() for a, b in zip(
        leaves(_numpy(plain.merged)), leaves(_numpy(sa.merged)))]
    assert max(apart) > 1e-2
