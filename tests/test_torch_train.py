"""The port's training round, module by module, against the reference on
the CPU.

Inputs are numpy arrays from a seed, handed to both packages; weights and
adapters come from the reference's seeded init through
``repro_torch.interop``. Tolerances: loss, accuracy and adapter grads of
``loss_fn`` 1e-5 relative to the largest entry (f32, summation order of
two GEMM libraries); Adam 1e-6; SVD singular values and the rank-r
reconstruction 1e-5 relative; aggregation products 1e-6 relative;
UCB-DUAL arms exact, λ 1e-6; everything on the host (cost model, data,
partitions, batches, mobility, channel) exactly equal.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.configs import qwen2_0_5b as jqwen
from repro.configs import vit_base_paper as jvit
from repro.core import aggregation as jagg
from repro.core import cost_model as jcm
from repro.core import energy_alloc as jalloc
from repro.core import lora as jlora
from repro.core import mobility as jmob
from repro.core import svd as jsvd
from repro.core import ucb_dual as jucb
from repro.data import ClientDataset as JClientDataset
from repro.data import DEFAULT_TASKS as J_TASKS
from repro.data import dirichlet_partition as j_partition
from repro.data import make_task as j_make_task
from repro.models import transformer as JT
from repro.sim.channel import ChannelModel as JChannel
from repro.sim.mobility_model import MobilityModel as JMobility
from repro.sim.mobility_model import MobilitySimConfig as JMobilityCfg
from repro_torch import config
from repro_torch import interop
from repro_torch.configs import qwen2_0_5b, vit_base_paper
from repro_torch.core import aggregation as agg
from repro_torch.core import cost_model as cm
from repro_torch.core import energy_alloc
from repro_torch.core import lora
from repro_torch.core import mobility as mob
from repro_torch.core import svd
from repro_torch.core import ucb_dual
from repro_torch.data import (DEFAULT_TASKS, ClientDataset,
                              dirichlet_partition, make_task)
from repro_torch.models import transformer as T
from repro_torch.optim import schedules
from repro_torch.sim.channel import ChannelModel
from repro_torch.sim.mobility_model import MobilityModel, MobilitySimConfig


# the optim packages re-export the function ``adam``, which shadows the
# module of the same name on attribute access
adam_mod = importlib.import_module("repro_torch.optim.adam")
jadam_mod = importlib.import_module("repro.optim.adam")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-12)


def _flat(tree, path=()):
    """{path: numpy leaf}: JAX rebuilds dicts with sorted keys, so trees
    are compared by path, not by leaf order."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (i,)))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().numpy()
    return {path: np.asarray(tree)}


def _same_leaves(got, want, tol):
    """Every leaf within ``tol`` of the reference's, relative to the
    largest entry over the whole tree."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    top = max(float(np.max(np.abs(w))) for w in want.values())
    for k in want:
        assert got[k].shape == want[k].shape, k
        err = float(np.max(np.abs(got[k] - want[k])))
        assert err <= tol * max(top, 1e-12), (k, err, top)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# Config copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["UCBDualConfig", "EnergyAllocConfig",
                                  "MobilityConfig", "TraceSpec",
                                  "RSUTierSpec", "ParticipationSpec",
                                  "ShardSpec", "CheckpointSpec",
                                  "LoRAConfig"])
def test_round_config_copies_match_reference(name):
    mine, ref = getattr(config, name)(), getattr(jconfig, name)()
    assert [f.name for f in dataclasses.fields(mine)] == \
        [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("which", ["vit_base_paper", "reduced", "fleet"])
def test_vit_config_copy_matches_reference(which):
    pc, jc = getattr(vit_base_paper, which)(), getattr(jvit, which)()
    for f in dataclasses.fields(pc):
        assert getattr(pc, f.name) == getattr(jc, f.name), f.name
    assert pc.param_counts() == jc.param_counts()
    assert config.get_arch("vit-base-paper") == vit_base_paper.vit_base_paper()


def test_spec_validation_matches_reference():
    for cls, kw in (("RSUTierSpec", {"sync_period": 0}),
                    ("ParticipationSpec", {"mode": "async"}),
                    ("ShardSpec", {"placement": "random"}),
                    ("CheckpointSpec", {"interval": 2})):
        for mod in (config, jconfig):
            with pytest.raises(ValueError):
                getattr(mod, cls)(**kw)
    assert config.ParticipationSpec.of("semi-sync").mode == "semi_sync"
    assert not config.RSUTierSpec(num_rsus_per_task=2).trivial


# ---------------------------------------------------------------------------
# loss_fn: loss, accuracy and adapter grads
# ---------------------------------------------------------------------------

def _shifted(tree):
    # b is zero-init; shift both factors so every adapter moves the loss
    return jax.tree_util.tree_map(lambda x: x + 0.01 * jnp.ones_like(x),
                                  tree)


def _loss_case(name):
    rng = np.random.default_rng(7)
    if name == "vit_cls":
        jcfg, cfg = jvit.reduced(), vit_base_paper.reduced()
        B, S = 4, 24
        labels = rng.integers(0, 6, (B,))
        ce_chunk = 0
    else:
        jcfg, cfg = jqwen.reduced(), qwen2_0_5b.reduced()
        B, S = 2, 16
        labels = rng.integers(0, jcfg.vocab_size, (B, S))
        labels[0, :3] = -100
        ce_chunk = 8 if name == "qwen_lm_chunked" else 0
    tokens = rng.integers(0, jcfg.vocab_size, (B, S))
    jlo = jconfig.LoRAConfig(rank=4, max_rank=8)
    lo = config.LoRAConfig(rank=4, max_rank=8)
    return jcfg, cfg, jlo, lo, tokens, labels, ce_chunk


@pytest.mark.parametrize("name", ["vit_cls", "qwen_lm", "qwen_lm_chunked"])
def test_loss_fn_matches_reference(name):
    jcfg, cfg, jlo, lo, tokens, labels, ce_chunk = _loss_case(name)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    jads = _shifted(JT.init_adapters(jax.random.PRNGKey(1), jcfg, jlo))
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32),
              "labels": jnp.asarray(labels, jnp.int32)}

    def jloss(ad):
        return JT.loss_fn(jparams, ad, jcfg, jlo, jbatch, ce_chunk=ce_chunk)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jads)

    params = interop.params_from_jax(_np(jparams), device="cpu",
                                     dtype=torch.float32)
    ads = interop.tree_map(lambda t: t.requires_grad_(),
                           interop.adapters_from_jax(_np(jads), device="cpu"))
    batch = {"tokens": _t(tokens).long(), "labels": _t(labels).long()}
    loss, m = T.loss_fn(params, ads, cfg, lo, batch, ce_chunk=ce_chunk)
    grads = torch.autograd.grad(loss, adam_mod.leaves(ads))

    assert _rel(loss.detach(), jl) < 1e-5
    assert abs(float(m["accuracy"]) - float(jm["accuracy"])) < 1e-5
    assert _rel(m["loss"].detach(), jm["loss"]) < 1e-5
    _same_leaves(adam_mod.unflatten(ads, grads), _np(jg), 1e-5)


def test_loss_fn_chunked_equals_unchunked():
    """ce_chunk changes where the lm head runs, not the result."""
    jcfg, cfg, jlo, lo, tokens, labels, _ = _loss_case("qwen_lm")
    params = T.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    batch = {"tokens": _t(tokens).long(), "labels": _t(labels).long()}
    full, mf = T.loss_fn(params, None, cfg, lo, batch)
    chunked, mc = T.loss_fn(params, None, cfg, lo, batch, ce_chunk=4)
    assert abs(float(full) - float(chunked)) < 1e-6
    assert float(mf["accuracy"]) == float(mc["accuracy"])


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

def _grad_trees(seed, steps):
    rng = np.random.default_rng(seed)
    shapes = {"segments": [{"attn": {"q": {"a": (2, 8, 4), "b": (2, 4, 6)}}}],
              "head": (5,)}
    return [_tree_of(shapes, rng) for _ in range(steps + 1)]


def _tree_of(shapes, rng):
    if isinstance(shapes, dict):
        return {k: _tree_of(v, rng) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree_of(v, rng) for v in shapes]
    return rng.standard_normal(shapes).astype(np.float32)


@pytest.mark.parametrize("kind", ["adam", "adamw", "sgd", "adam_warmup"])
def test_optimizer_matches_reference(kind):
    trees = _grad_trees(3, 4)
    params_np, grads_np = trees[0], trees[1:]
    if kind == "adam":
        jopt, opt = jadam_mod.adam(5e-3), adam_mod.adam(5e-3)
    elif kind == "adamw":
        jopt = jadam_mod.adamw(1e-2, weight_decay=0.1)
        opt = adam_mod.adamw(1e-2, weight_decay=0.1)
    elif kind == "sgd":
        jopt, opt = jadam_mod.sgd(0.1, momentum=0.9), \
            adam_mod.sgd(0.1, momentum=0.9)
    else:
        from repro.optim import schedules as jsched
        jopt = jadam_mod.adam(jsched.cosine_decay(1e-2, 10, 2))
        opt = adam_mod.adam(schedules.cosine_decay(1e-2, 10, 2))
    jp = jax.tree_util.tree_map(jnp.asarray, params_np)
    p = interop.tree_map(_t, params_np)
    js, st = jopt.init(jp), opt.init(p)
    for g in grads_np:
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jadam_mod.apply_updates(jp, ju)
        u, st = opt.update(interop.tree_map(_t, g), st, p)
        p = adam_mod.apply_updates(p, u)
    for k, want in _flat(_np(jp)).items():
        assert float(np.max(np.abs(_flat(p)[k] - want))) < 1e-6
    assert int(st.step) == int(js.step) == len(grads_np)
    if kind != "sgd":
        for k, want in _flat(_np(js.nu)).items():
            assert float(np.max(np.abs(_flat(st.nu)[k] - want))) < 1e-6


def test_global_norm_and_clip_match_reference():
    g = _grad_trees(5, 1)[1]
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    tg = interop.tree_map(_t, g)
    assert _rel(adam_mod.global_norm(tg), jadam_mod.global_norm(jg)) < 1e-6
    clipped, n = adam_mod.clip_by_global_norm(tg, 1.5)
    jclipped, jn = jadam_mod.clip_by_global_norm(jg, 1.5)
    assert _rel(n, jn) < 1e-6
    _same_leaves(clipped, _np(jclipped), 1e-6)


def test_schedules_match_reference():
    from repro.optim import schedules as jsched
    for step in (0, 1, 5, 20):
        js_, ts = jnp.asarray(step, jnp.int32), torch.tensor(step)
        for jf, f in ((jsched.constant(0.1), schedules.constant(0.1)),
                      (jsched.linear_warmup(0.1, 4),
                       schedules.linear_warmup(0.1, 4)),
                      (jsched.cosine_decay(0.1, 10, 3),
                       schedules.cosine_decay(0.1, 10, 3))):
            assert abs(float(f(ts)) - float(jf(js_))) < 1e-7


# ---------------------------------------------------------------------------
# SVD, merged deltas, redistribution
# ---------------------------------------------------------------------------

def _omega_ref(seed, d2, r):
    return _t(np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                           (d2, r), jnp.float32)))


def _low_rank(seed, shape, rank):
    rng = np.random.default_rng(seed)
    lead, (d1, d2) = shape[:-2], shape[-2:]
    u = rng.standard_normal(lead + (d1, rank))
    v = rng.standard_normal(lead + (rank, d2))
    s = np.geomspace(1.0, 1e-2, rank)
    noise = 1e-4 * rng.standard_normal(lead + (d1, d2))
    return ((u * s) @ v / np.sqrt(d1) + noise).astype(np.float32)


@pytest.mark.parametrize("d1,d2,rank", [(64, 64, 8), (64, 128, 16),
                                        (128, 64, 32)])
def test_randomized_svd_with_reference_omega(d1, d2, rank):
    """Singular values to 1e-5, and U·diag(s)·Vt (not the factors, whose
    signs the two LAPACK calls may choose differently)."""
    a = _low_rank(d1 + d2, (d1, d2), 40)
    ju, js, jvt = jsvd.randomized_svd(jnp.asarray(a), rank, seed=3)
    omega = _omega_ref(3, d2, svd.sketch_width(rank, d1, d2))
    u, s, vt = svd.randomized_svd(_t(a), rank, omega=omega)
    assert _rel(s, js) < 1e-5
    want = (np.asarray(ju) * np.asarray(js)) @ np.asarray(jvt)
    assert _rel((u * s) @ vt, want) < 1e-5
    eu, es, evt = svd.exact_svd(_t(a), rank)
    assert _rel(es, np.asarray(jsvd.exact_svd(jnp.asarray(a), rank)[1])) \
        < 1e-5
    assert abs(float(svd.truncation_energy(s, rank // 2))
               - float(jsvd.truncation_energy(js, rank // 2))) < 1e-6


def test_randomized_svd_rejects_a_wrong_omega():
    with pytest.raises(ValueError):
        svd.randomized_svd(torch.zeros(8, 6), 2, omega=torch.zeros(6, 3))


def _client_trees(ranks, L=2, d_in=16, d_out=24, seed=0):
    rng = np.random.default_rng(seed)
    trees = []
    for r in ranks:
        trees.append({"segments": [{"attn": {
            "q": {"a": rng.standard_normal((L, d_in, r)).astype(np.float32),
                  "b": rng.standard_normal((L, r, d_out)).astype(np.float32)},
            "o": {"a": rng.standard_normal((L, d_out, r)).astype(np.float32),
                  "b": rng.standard_normal((L, r, d_in)).astype(np.float32)},
        }}]})
    return trees


def test_aggregate_merged_and_redistribute_match_reference():
    """Clients at ranks 2, 4 and 8 with data weights: the merged deltas,
    and the redistributed a·b at ranks 4 and 8 (one Ω for each layer of a
    stack, the reference's), to 1e-6 relative to the largest entry."""
    trees = _client_trees([2, 4, 8])
    weights = [30.0, 10.0, 60.0]
    scale = 16.0 / 8
    jm = jagg.aggregate_merged(
        [jax.tree_util.tree_map(jnp.asarray, t) for t in trees], weights,
        scale)
    m = agg.aggregate_merged([interop.tree_map(_t, t) for t in trees],
                             weights, scale)
    assert sorted(agg.tree_paths_delta(m)) == \
        sorted(jagg.tree_paths_delta(jm))
    for p in agg.tree_paths_delta(m):
        assert _rel(agg.tree_get(m, p)["delta"],
                    jagg.tree_get(jm, p)["delta"]) < 1e-6
    for rank in (4, 8):
        jr = jagg.redistribute(jm, rank=rank, scale=scale, max_rank=8,
                               seed=5)
        r = agg.redistribute(m, rank=rank, scale=scale, max_rank=8, seed=5,
                             draw_omega=_omega_ref)
        for p in agg.tree_paths(r):
            got, want = agg.tree_get(r, p), jagg.tree_get(jr, p)
            assert got["a"].shape == want["a"].shape
            assert _rel(got["a"] @ got["b"],
                        np.asarray(want["a"]) @ np.asarray(want["b"])) < 1e-5
    cut = agg.hetlora_truncate(interop.tree_map(_t, trees[2]), 3)
    assert lora.tree_rank(cut) == 3


def test_lora_helpers_match_reference():
    tree = _client_trees([4])[0]
    ad = tree["segments"][0]["attn"]["q"]
    jd = jlora.merge_delta({k: jnp.asarray(v) for k, v in ad.items()}, 2.0)
    assert _rel(lora.merge_delta(interop.tree_map(_t, ad), 2.0), jd) < 1e-6
    a = _low_rank(1, (32, 24), 8)
    u, s, vt = (np.asarray(x) for x in jsvd.exact_svd(jnp.asarray(a), 8))
    jf = jlora.factors_from_svd(jnp.asarray(u), jnp.asarray(s),
                                jnp.asarray(vt), 4, 2.0)
    f = lora.factors_from_svd(_t(u), _t(s), _t(vt), 4, 2.0)
    for k in ("a", "b"):
        assert _rel(f[k], jf[k]) < 1e-6
    assert lora.adapter_num_params(64, 128, 4) == \
        jlora.adapter_num_params(64, 128, 4)
    assert lora.count_params(interop.tree_map(_t, tree)) == \
        jlora.count_params(jax.tree_util.tree_map(jnp.asarray, tree))


# ---------------------------------------------------------------------------
# UCB-DUAL and Algorithm 1
# ---------------------------------------------------------------------------

def test_ucb_dual_matches_reference_over_rounds():
    """12 rounds with random coverage, rewards and energies: the arms
    exactly (the unexplored arms tie and the first wins, as in
    jnp.argmax), λ to 1e-6."""
    V, K = 9, 5
    ucfg, jcfg = config.UCBDualConfig(), jconfig.UCBDualConfig()
    st, jst = ucb_dual.init_state(V, K), jucb.init_state(V, K)
    rng = np.random.default_rng(11)
    for rnd in range(12):
        active = rng.random(V) < 0.7
        arms = ucb_dual.select_ranks(st, ucfg, torch.as_tensor(active))
        jarms = jucb.select_ranks(jst, jcfg, jnp.asarray(active))
        assert arms.tolist() == np.asarray(jarms).tolist(), rnd
        if rnd == 0:   # every arm unexplored: all tie, arm 0 wins
            assert set(arms[active].tolist()) <= {0}
        acc = rng.random(V).astype(np.float32)
        tau = (20 + 60 * rng.random(V)).astype(np.float32)
        rew = np.asarray([float(ucb_dual.reward(ucfg, a, t))
                          for a, t in zip(acc, tau)], np.float32)
        jrew = np.asarray(jucb.reward(jcfg, jnp.asarray(acc),
                                      jnp.asarray(tau)))
        assert np.array_equal(rew, jrew)
        en = (5 + 40 * rng.random(V)).astype(np.float32)
        budget = np.float32(150.0)
        st, info = ucb_dual.update(st, ucfg, arms, torch.as_tensor(rew),
                                   torch.as_tensor(en), budget)
        jst, jinfo = jucb.update(jst, jcfg, jarms, jnp.asarray(rew),
                                 jnp.asarray(en), jnp.asarray(budget))
        assert abs(float(info["lambda"]) - float(jinfo["lambda"])) < 1e-6
        assert np.array_equal(st.counts.numpy(), np.asarray(jst.counts))


def test_energy_alloc_matches_reference():
    ecfg = config.EnergyAllocConfig(e_total=900.0)
    jecfg = jconfig.EnergyAllocConfig(e_total=900.0)
    st, jst = energy_alloc.init_alloc(ecfg, 3), jalloc.init_alloc(jecfg, 3)
    rng = np.random.default_rng(2)
    for rnd in range(13):
        consumed = 100 + 300 * rng.random(3)
        acc = rng.random(3)
        st, info = energy_alloc.step(st, ecfg, torch.as_tensor(consumed),
                                     torch.as_tensor(acc))
        jst, jinfo = jalloc.step(jst, jecfg, jnp.asarray(consumed),
                                 jnp.asarray(acc))
        assert info["reallocated"] == jinfo["reallocated"]
        assert _rel(st.budgets, jst.budgets) < 1e-6
        assert _rel(st.difficulty, jst.difficulty) < 1e-6
        assert st.round == jst.round


# ---------------------------------------------------------------------------
# Host-side modules: exact equality
# ---------------------------------------------------------------------------

def test_cost_model_matches_reference():
    lo = config.LoRAConfig(rank=8, max_rank=32, candidate_ranks=(2, 4, 8))
    jlo = jconfig.LoRAConfig(rank=8, max_rank=32, candidate_ranks=(2, 4, 8))
    for name in ("vit-base-paper", "qwen2-0.5b"):
        c, jc = config.get_arch(name), jconfig.get_arch(name)
        assert cm.target_dims_of(c, lo) == jcm.target_dims_of(jc, jlo)
        for r in (2, 8, 32):
            assert cm.g_factor(c, lo, r) == jcm.g_factor(jc, jlo, r)
    dims = cm.target_dims_of(config.get_arch("vit-base-paper"), lo)
    profs = cm.default_device_profiles(np.random.default_rng(4), 5, 1e11)
    jprofs = jcm.default_device_profiles(np.random.default_rng(4), 5, 1e11)
    assert [dataclasses.asdict(p) for p in profs] == \
        [dataclasses.asdict(p) for p in jprofs]
    rsu, jrsu = cm.default_rsu_profile(), jcm.default_rsu_profile()
    costs, jcosts = [], []
    for i, (p, jp) in enumerate(zip(profs, jprofs)):
        kw = dict(rank=4, payload_params=cm.adapter_payload_params(dims, 4),
                  bytes_per_param=4, rate_down=2e6 * (i + 1),
                  rate_up=1e6 * (i + 2), num_samples=30, g=1.1)
        costs.append(cm.vehicle_round_costs(p, rsu, **kw))
        jcosts.append(jcm.vehicle_round_costs(jp, jrsu, **kw))
        assert dataclasses.asdict(costs[-1]) == dataclasses.asdict(jcosts[-1])
    agg_c = cm.rsu_agg_costs(rsu, 4)
    assert agg_c == jcm.rsu_agg_costs(jrsu, 4)
    assert cm.task_round_summary(costs, agg_c) == \
        jcm.task_round_summary(jcosts, agg_c)
    for acc, e, peer in ((0.3, 10.0, True), (0.9, 1.0, False),
                         (0.0, 0.0, False)):
        d = mob.decide_fallback(config.MobilityConfig(),
                                config.UCBDualConfig(), local_accuracy=acc,
                                energy_spent=e, migration_available=peer)
        jd = jmob.decide_fallback(jconfig.MobilityConfig(),
                                  jconfig.UCBDualConfig(), local_accuracy=acc,
                                  energy_spent=e, migration_available=peer)
        assert (d.strategy, d.cost, d.costs) == (jd.strategy, jd.cost,
                                                 jd.costs)


def test_data_partition_and_batches_match_reference():
    for ti, spec in enumerate(DEFAULT_TASKS):
        assert dataclasses.asdict(spec) == dataclasses.asdict(J_TASKS[ti])
        d, jd = make_task(spec, seed=ti), j_make_task(J_TASKS[ti], seed=ti)
        for k in d:
            assert np.array_equal(d[k], jd[k]) and d[k].dtype == jd[k].dtype
        parts = dirichlet_partition(d["labels"], 8, alpha=0.5, seed=ti)
        jparts = j_partition(jd["labels"], 8, alpha=0.5, seed=ti)
        assert all(np.array_equal(a, b) for a, b in zip(parts, jparts))
        for v in (0, 3):
            ds = ClientDataset(d["tokens"][parts[v]], d["labels"][parts[v]],
                               10, seed=31 * v)
            jds = JClientDataset(jd["tokens"][jparts[v]],
                                 jd["labels"][jparts[v]], 10, seed=31 * v)
            for _ in range(12):
                b, jb = ds.next_batch(), jds.next_batch()
                assert all(np.array_equal(b[k], jb[k]) for k in b)


def test_mobility_and_channel_match_reference_over_ten_ticks():
    ms = MobilitySimConfig(num_vehicles=12, seed=3)
    jms = JMobilityCfg(num_vehicles=12, seed=3)
    rsus = MobilityModel.place_rsus(3, ms.area, ms.coverage_radius, seed=3)
    jrsus = JMobility.place_rsus(3, jms.area, jms.coverage_radius, seed=3)
    assert [dataclasses.asdict(r) for r in rsus] == \
        [dataclasses.asdict(r) for r in jrsus]
    m, jm = MobilityModel(ms, rsus), JMobility(jms, jrsus)
    ch, jch = ChannelModel(__import__(
        "repro_torch.sim.channel", fromlist=["ChannelConfig"]
    ).ChannelConfig(), seed=6), JChannel(__import__(
        "repro.sim.channel", fromlist=["ChannelConfig"]).ChannelConfig(),
        seed=6)
    tx = np.linspace(0.2, 0.5, 12)
    shadow = np.exp(np.random.default_rng(1).normal(0, 1.2, 12))
    for _ in range(10):
        m.step()
        jm.step()
        assert np.array_equal(m.pos, jm.pos)
        for t in range(3):
            view = m.round_view_group([rsus[t]])
            jview = jm.round_view_group([jrsus[t]])
            for k in view:
                assert np.array_equal(view[k], jview[k]), k
            ids = np.where(view["active"])[0]
            rates = ch.round_rates(1.0, tx, view["distances"], shadow, ids)
            jrates = jch.round_rates(1.0, tx, jview["distances"], shadow,
                                     ids)
            assert all(np.array_equal(a, b) for a, b in zip(rates, jrates))
            if len(ids):
                assert m.nearby_peer(rsus[t], int(ids[0]), view["staying"]) \
                    == jm.nearby_peer(jrsus[t], int(ids[0]),
                                      jview["staying"])


def test_trace_replay_matches_the_reference():
    """Trace replay: the reference's positions, velocities and presence,
    wrapping past the staged horizon (more in
    ``test_torch_trajectories.py``)."""
    spec = dict(length=5, arrivals="staggered", min_dwell=2, seed=3)
    m = MobilityModel(MobilitySimConfig(num_vehicles=6, trace=config
                                        .TraceSpec(**spec)),
                      MobilityModel.place_rsus(1, 3000.0, 1100.0))
    jm = JMobility(JMobilityCfg(num_vehicles=6, trace=jconfig
                                .TraceSpec(**spec)),
                   JMobility.place_rsus(1, 3000.0, 1100.0))
    for _ in range(8):
        for a, b in ((m.pos, jm.pos), (m.vel, jm.vel),
                     (m.present, jm.present)):
            assert np.array_equal(a, b)
        m.step()
        jm.step()
