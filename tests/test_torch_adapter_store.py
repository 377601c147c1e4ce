"""The port's adapter store and LRU cache against the reference's, on the
CPU, after the reference's ``tests/test_adapter_cache.py`` (its store
cases): train -> checkpoint -> serve.

One tiny reference fleet trains once (1 task, 4 vehicles, 1 round, 1
local step, serial) and checkpoints; one more runs on a dense-rsu-style
tier (3 RSUs, sync every 2 rounds), so its RSUs hold live partials after
round 0. The port's store reads each checkpoint twice: restored into the
port's simulator (``from_sim``) and straight from the file
(``from_checkpoint``). The reference's SVD sketch Ω (``jax.random`` at
``seed = version``) is injected through ``draw_omega``.

Tolerances, per rank of the candidate set (2, 4, 8) and per adapter
leaf: ``a·b`` within 1e-5 of the reference's largest entry; the factors
within 1e-5 (relative to the leaf's largest entry) on every column whose
singular value exceeds 1e-6 of the largest, up to the joint sign of the
pair (a[:, j], b[j]), which each package's SVD picks freely (the
product does not see it). The remaining columns span
the merged delta's null space, for which each package's QR picks its own
basis (as in ``tests/test_torch_baselines.py::_undetermined``). Between
the port's own paths (from_sim, from_checkpoint, the cached max-rank
tree): bit for bit.
"""
import dataclasses
import threading
from collections import OrderedDict

import numpy as np
import pytest
import torch

from repro.checkpoint.carry import save_checkpoint as jsave_checkpoint
from repro.config import LoRAConfig as JLoRAConfig
from repro.config import RSUTierSpec as JRSUTierSpec
from repro.launch.adapter_cache import AdapterStore as JAdapterStore
from repro.sim.simulator import IoVSimulator as JSimulator
from repro.sim.simulator import SimConfig as JSimConfig
from repro_torch import interop
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.config import LoRAConfig, RSUTierSpec, ServeSpec
from repro_torch.core import lora as lora_lib
from repro_torch.core.cache import IdentityLRU, LRUCache
from repro_torch.launch.adapter_cache import GLOBAL_RSU, AdapterStore
from repro_torch.launch.serve import ServeEngine
from repro_torch.sim.simulator import IoVSimulator, SimConfig
from test_torch_sim import _np, _omega_ref

from hypothesis import given, settings, strategies as st

torch.set_num_threads(1)

RANKS = (2, 4, 8)
KW = dict(method="ours", num_tasks=1, num_vehicles=4, rounds=1,
          local_steps=1, seed=0, engine="serial")
TIER = dict(num_rsus_per_task=3, sync_period=2)
PROD_TOL = 1e-5
FACTOR_TOL = 1e-5
SV_CUT = 1e-6


def _lora(mod):
    return mod(rank=4, max_rank=8, candidate_ranks=RANKS)


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """Per run ("plain", "tier"): (reference sim, checkpoint dir, port
    SimConfig, port sim restored from the reference's file)."""
    out = {}
    for name, tier in (("plain", None), ("tier", TIER)):
        kw = dict(KW, lora=_lora(JLoRAConfig))
        if tier:
            kw["rsu_tier"] = JRSUTierSpec(**tier)
        jsim = JSimulator(JSimConfig(**kw))
        jsim.run()
        d = str(tmp_path_factory.mktemp(f"ckpt_{name}"))
        jsave_checkpoint(jsim, ckpt_dir=d)
        pkw = dict(KW, lora=_lora(LoRAConfig))
        if tier:
            pkw["rsu_tier"] = RSUTierSpec(**tier)
        cfg = SimConfig(**pkw)
        sim = IoVSimulator(cfg, device="cpu",
                           params=interop.params_from_jax(
                               _np(jsim.params), device="cpu"))
        assert restore_checkpoint(sim, d) == 1
        out[name] = (jsim, d, cfg, sim)
    return out


@pytest.fixture(scope="module")
def omega():
    return _omega_ref()


def _pairs(tree, path=()):
    """(path, node) of every {'a', 'b'} adapter node of a tree."""
    if isinstance(tree, dict) and "a" in tree and "b" in tree:
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _pairs(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _pairs(v, path + (i,))


def _np_tree(tree):
    return interop.to_numpy(tree)


def _held_to_reference(got, want):
    """The stated rule: products per leaf, factors on determined columns.
    Returns the number of determined columns held."""
    got, want = _np_tree(got), _np(want)
    held = 0
    for (path, g), (jpath, w) in zip(_pairs(got), _pairs(want)):
        assert path == jpath
        ga, gb = np.asarray(g["a"], np.float64), np.asarray(g["b"], np.float64)
        wa, wb = np.asarray(w["a"], np.float64), np.asarray(w["b"], np.float64)
        assert ga.shape == wa.shape and gb.shape == wb.shape, path
        want_prod = wa @ wb
        scale = np.abs(want_prod).max()
        assert np.abs(ga @ gb - want_prod).max() <= PROD_TOL * scale, path
        # b's rows are orthonormal, so a's column norms are the singular
        # values (over the scale)
        sv = np.linalg.norm(wa, axis=-2)                     # (L, r)
        det = sv > SV_CUT * sv.max(axis=-1, keepdims=True)
        amax, bmax = np.abs(wa).max(), np.abs(wb).max()
        for idx in zip(*np.nonzero(det)):
            *lead, j = idx
            lead = tuple(lead)
            sign = np.sign(ga[lead][:, j] @ wa[lead][:, j])
            assert np.abs(sign * ga[lead][:, j] - wa[lead][:, j]).max() \
                <= FACTOR_TOL * amax, (path, idx)
            assert np.abs(sign * gb[lead][j] - wb[lead][j]).max() \
                <= FACTOR_TOL * bmax, (path, idx)
            held += 1
    return held


def _bit_equal(a, b):
    la, lb = _np_tree(a), _np_tree(b)
    pa, pb = list(_pairs(la)), list(_pairs(lb))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    return all(np.array_equal(x[k], y[k]) for (_, x), (_, y) in zip(pa, pb)
               for k in ("a", "b"))


# ---------------------------------------------------------------------------
# LRUCache
# ---------------------------------------------------------------------------

def _lru_model_run(ops, maxsize):
    cache, model = LRUCache(maxsize), OrderedDict()
    hits = misses = 0
    for op, k in ops:
        if op == "put":
            cache.put(k, k * 10)
            model[k] = k * 10
            model.move_to_end(k)
            while len(model) > maxsize:
                model.popitem(last=False)
        else:
            want = model.get(k)
            if want is not None:
                model.move_to_end(k)
                hits += 1
            else:
                misses += 1
            assert cache.get(k) == want
        assert cache.keys() == list(model)
        assert len(cache) == len(model) <= maxsize
    assert (cache.hits, cache.misses) == (hits, misses)


@settings(max_examples=50, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["put", "get"]),
                          st.integers(0, 7)), max_size=60),
       st.integers(1, 5))
def test_lrucache_matches_ordereddict_model(ops, maxsize):
    _lru_model_run(ops, maxsize)


@pytest.mark.parametrize("seed", range(3))
def test_lrucache_deterministic_model_twin(seed):
    rng = np.random.default_rng(seed)
    ops = [("put" if rng.random() < 0.5 else "get", int(rng.integers(0, 6)))
           for _ in range(200)]
    _lru_model_run(ops, 3)


def test_lrucache_get_or_load_loads_once():
    cache = LRUCache(maxsize=4)
    calls = []
    for _ in range(2):
        assert cache.get_or_load("k", lambda: calls.append(1) or "v") == "v"
    assert len(calls) == 1
    assert cache.hits == 1 and cache.misses == 1
    assert "k" in cache and "x" not in cache
    with pytest.raises(ValueError):
        LRUCache(0)


def test_lrucache_under_threads_keeps_its_bound_and_counts():
    """More threads than cores hammer one cache with a short switch
    interval: the bound holds and no get is lost from the counters."""
    import sys
    cache = LRUCache(maxsize=8)
    per, n = 400, 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for i in range(per):
                cache.get_or_load((t + i) % 16, lambda: i)
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(cache) <= 8
    assert cache.hits + cache.misses == per * n


def test_identitylru_is_an_lru_over_identities():
    cache = IdentityLRU(maxsize=2)
    a, b, c = {"k": 1}, {"k": 1}, object()
    cache.put(a, "A")
    cache.put(b, "B")
    assert cache.get(a) == "A" and cache.get({"k": 1}) is None
    cache.put(c, "C")                 # evicts b, the least recently used
    assert cache.get(b) is None and cache.get(c) == "C"
    assert isinstance(cache, LRUCache)


# ---------------------------------------------------------------------------
# The store against the reference's
# ---------------------------------------------------------------------------

def test_store_matches_reference_for_every_rank(fleets, omega):
    jsim, _, _, sim = fleets["plain"]
    jstore = JAdapterStore.from_sim(jsim)
    store = AdapterStore.from_sim(sim, draw_omega=omega)
    assert store.version(0) == jstore.version(0) == 1
    assert store.rsus(0) == jstore.rsus(0) == [GLOBAL_RSU]
    held = 0
    for rank in RANKS:
        got, want = store.get(0, rank=rank), jstore.get(0, rank=rank)
        assert (got.key, got.rank, got.slot_rank, got.scale) == \
            (want.key, want.rank, want.slot_rank, want.scale)
        held += _held_to_reference(got.adapters, want.adapters)
    assert held > 0


def test_store_pages_every_rank_from_one_cached_svd(fleets, omega):
    """Rank-r pages are prefixes of the cached max_rank redistribution,
    zero-padded to the slot: one cache entry, one SVD, for every rank."""
    sim = fleets["plain"][3]
    store = AdapterStore.from_sim(sim, draw_omega=omega)
    full = store.get(0, rank=8)
    assert store.cache.misses == 1
    for rank in (2, 4):
        paged = store.get(0, rank=rank)
        assert store.cache.misses == 1 and len(store.cache) == 1
        assert paged.rank == rank and paged.slot_rank == store.slot_rank
        want = lora_lib.pad_adapter_tree(
            lora_lib.truncate_adapter_tree(full.adapters, rank),
            store.slot_rank)
        assert _bit_equal(paged.adapters, want)
        tail = lora_lib.mask_adapter_tree(
            paged.adapters,
            1.0 - lora_lib.rank_arange_mask(torch.tensor(rank),
                                            store.slot_rank))
        assert all(float(n[k].abs().max()) == 0.0
                   for _, n in _pairs(tail) for k in ("a", "b"))
    assert store.cache.hits == 2


def test_store_versioned_keying_no_stale_hits(fleets, omega):
    """A version bump changes the cache KEY; an explicit old version hits
    its own entry while cached and raises once aged out."""
    sim = fleets["plain"][3]
    store = AdapterStore.from_sim(sim, spec=ServeSpec(cache_capacity=2),
                                  draw_omega=omega)
    store.servers = [dict(s) for s in store.servers]
    v0 = store.version(0)
    old = store.get(0, rank=4)
    store.servers[0]["round"] = v0 + 1
    store.servers[0]["merged"] = interop.tree_map(
        lambda x: x * 1.5, store.servers[0]["merged"])
    new = store.get(0, rank=4)
    assert new.version == v0 + 1 and store.cache.misses == 2
    assert not _bit_equal(old.adapters, new.adapters)
    still = store.get(0, rank=4, version=v0)
    assert still.version == v0 and _bit_equal(still.adapters, old.adapters)
    for bump in (2, 3):
        store.servers[0]["round"] = v0 + bump
        store.get(0, rank=4)
    with pytest.raises(KeyError):
        store.get(0, rank=4, version=v0)
    with pytest.raises(ValueError):
        store.get(0, rank=9)


def test_reference_checkpoint_serves_the_bits_of_from_sim(fleets, omega):
    """train -> checkpoint -> serve loses nothing: a reference-written
    file read by ``from_checkpoint`` serves the bits that ``from_sim``
    serves from the same state restored into the port's simulator."""
    for name in ("plain", "tier"):
        _, d, cfg, sim = fleets[name]
        live = AdapterStore.from_sim(sim, draw_omega=omega)
        restored = AdapterStore.from_checkpoint(cfg, d, draw_omega=omega,
                                                device="cpu")
        assert restored.rsus(0) == live.rsus(0)
        for rsu in live.rsus(0):
            if rsu == GLOBAL_RSU and live.servers[0]["merged"] is None:
                continue
            for rank in RANKS:
                a = live.get(0, rsu=rsu, rank=rank)
                b = restored.get(0, rsu=rsu, rank=rank)
                assert a.key == b.key
                assert _bit_equal(a.adapters, b.adapters), (name, rsu, rank)


def test_from_checkpoint_refuses_a_foreign_config(fleets):
    _, d, cfg, _ = fleets["plain"]
    other = dataclasses.replace(cfg, seed=cfg.seed + 1)
    with pytest.raises(ValueError, match="DIFFERENT SimConfig"):
        AdapterStore.from_checkpoint(other, d, device="cpu")


def test_tier_partials_serve_as_the_reference_does(fleets, omega):
    """Live partials after round 0 of the tier (no sync yet): the same
    servable RSUs, the same pages per RSU and rank, and no global state
    to serve yet — in both packages."""
    jsim, _, _, sim = fleets["tier"]
    jstore = JAdapterStore.from_sim(jsim)
    store = AdapterStore.from_sim(sim, draw_omega=omega)
    rsus = store.rsus(0)
    assert rsus == jstore.rsus(0) and len(rsus) >= 2
    for rsu in rsus[1:]:
        for rank in RANKS:
            got, want = store.get(0, rsu=rsu, rank=rank), \
                jstore.get(0, rsu=rsu, rank=rank)
            assert got.key == want.key
            _held_to_reference(got.adapters, want.adapters)
    assert store.cache.misses == len(rsus) - 1      # one SVD per RSU
    for s in (store, jstore):
        with pytest.raises(KeyError):
            s.get(0)                   # no sync yet: no merged state
        with pytest.raises(KeyError):
            s.get(0, rsu=2)            # RSU 2 holds no partial


# ---------------------------------------------------------------------------
# Store-driven admission into the paged engine
# ---------------------------------------------------------------------------

def test_store_admit_churn_paged_equals_dense(fleets, omega):
    """Trained tenants admitted by the store into a paged and a dense
    engine through retire, re-admit and evict_oldest decode the same
    bits, and the paged engine recycles blocks."""
    _, _, _, sim = fleets["tier"]
    store = AdapterStore.from_sim(sim, draw_omega=omega)
    r0, r1 = store.rsus(0)[1:3]

    def build(block_size):
        return ServeEngine(sim.params, sim.model_cfg, sim.cfg.lora,
                           ServeSpec(max_batch=2, cache_len=8,
                                     block_size=block_size,
                                     admission="evict_oldest"),
                           device="cpu")

    def churn(eng):
        toks = np.ones(2, np.int64)
        out = []
        lane = store.admit(eng, 0, rsu=r0, rank=4)
        store.admit(eng, 0, rsu=r1, rank=2, lane=1 - lane)
        for _ in range(5):
            out.append(eng.step(toks))
        eng.retire(lane)
        store.admit(eng, 0, rsu=r1, rank=8)      # recycles the lane's blocks
        for _ in range(5):
            out.append(eng.step(toks))
        store.admit(eng, 0, rsu=r0, rank=2)      # full: evicts the oldest
        for _ in range(6):
            out.append(eng.step(toks))           # the ring of 8 wraps
        return out

    paged = build(4)
    out_p, out_d = churn(paged), churn(build(0))
    assert paged.allocator_stats()["recycles"] > 0
    paged.allocator.check()
    for t, (a, b) in enumerate(zip(out_p, out_d)):
        assert torch.equal(a, b), f"paged != dense at step {t}"
    assert store.cache.misses == 2                 # one SVD per (rsu, v)
