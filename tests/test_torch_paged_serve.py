"""The port's block-paged serving engine under continuous batching, on the
CPU, after the reference's ``tests/test_continuous_batching.py`` (its
qwen2 cases).

Contracts, driven by an adversarial admit / retire / re-admit schedule on
one lane while two siblings hold tenants, through a ring wrap:

1. **Paged == dense, bit for bit.** A block-paged engine decodes the
   exact bits of the port's dense engine, every lane, every step (the
   position mask and the exact-zero masked softmax), and each lane's
   gathered cache equals the dense one wherever ``pos >= 0``.
2. **Paged == the reference's paged engine** to 1e-5 (f32 logits), with
   equal allocator tables and counters. The reference's ``_decode`` is
   blocked on every step: its ``step`` hands an asynchronous decode a
   host array that it increments right after (ROADMAP Queue 3, fault 1).
3. **Sibling isolation** and the allocator's observables: recycling,
   loud exhaustion mid-step, blocks back to the pool on reset, pools and
   tables that never move, the admission policies.
4. rwkv6 (recurrent state only) under ``block_size > 0`` has no pools
   and decodes its dense engine's bits.

Config: ``qwen2_0_5b.reduced()`` (2 layers, d 128) and
``rwkv6_7b.reduced()``, f32, weights from the reference's seeded init.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LoRAConfig as JLoRAConfig
from repro.config import ServeSpec as JServeSpec
from repro.configs import qwen2_0_5b as jqwen
from repro.configs import rwkv6_7b as jrwkv
from repro.core import lora as jlora
from repro.launch.adapter_cache import PagedAdapter as JPagedAdapter
from repro.launch.serve import ServeEngine as JServeEngine
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.config import LoRAConfig, ServeSpec
from repro_torch.configs import qwen2_0_5b, rwkv6_7b
from repro_torch.core import kv_blocks as kvb
from repro_torch.core.kv_blocks import BlockPoolExhausted
from repro_torch.launch.adapter_cache import PagedAdapter
from repro_torch.launch.serve import ServeEngine
from repro_torch.models import transformer as T

torch.set_num_threads(1)

SLOT = 8
TOL = 1e-5
STEPS, PROMPT, CHURN = 20, 1, 2
JLORA = JLoRAConfig(rank=4, max_rank=SLOT, candidate_ranks=(2, 4, 8))
LORA = LoRAConfig(rank=4, max_rank=SLOT)
ARCHS = {"qwen2-0.5b": (jqwen, qwen2_0_5b), "rwkv6-7b": (jrwkv, rwkv6_7b)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """Reference params and their port copies, per arch."""
    out = {}
    for arch, (jmod, _) in ARCHS.items():
        jp = JT.init_params(jax.random.PRNGKey(0), jmod.reduced(),
                            jnp.float32)
        out[arch] = (jp, interop.params_from_jax(_np(jp), device="cpu",
                                                 dtype=torch.float32))
    return out


def _tenant(arch, rank, seed):
    """(reference PagedAdapter, port PagedAdapter) of the same adapter."""
    jmod = ARCHS[arch][0]
    ads = JT.init_adapters(jax.random.PRNGKey(seed), jmod.reduced(), JLORA,
                           rank=rank)
    ads = jax.tree_util.tree_map(lambda x: x + 0.01 * jnp.ones_like(x), ads)
    ads = jlora.pad_adapter_tree(ads, SLOT)
    kw = dict(task=0, rsu=-1, version=0, rank=rank, slot_rank=SLOT,
              scale=JLORA.scale)
    return (JPagedAdapter(adapters=ads, **kw),
            PagedAdapter(adapters=interop.adapters_from_jax(_np(ads), "cpu"),
                         **kw))


def _engine(models, arch="qwen2-0.5b", *, lanes=3, cache_len=16,
            block_size=0, max_blocks=0, admission="strict"):
    spec = ServeSpec(max_batch=lanes, cache_len=cache_len, max_rank=SLOT,
                     block_size=block_size, max_blocks=max_blocks,
                     admission=admission)
    return ServeEngine(models[arch][1], ARCHS[arch][1].reduced(), LORA,
                       spec, device="cpu")


def _ref_engine(models, arch="qwen2-0.5b", *, block_size=0):
    eng = JServeEngine(models[arch][0], ARCHS[arch][0].reduced(), JLORA,
                       JServeSpec(max_batch=3, cache_len=16, max_rank=SLOT,
                                  block_size=block_size))
    decode = eng._decode
    eng._decode = lambda *a: jax.block_until_ready(decode(*a))
    return eng


def _churn_events(arch, side):
    """The reference's schedule on lane CHURN: admit mid-stream, retire,
    re-admit at another rank, then retire + re-admit in one step (ranks
    2/4/8 on the churned lane). ``side`` 0 admits the reference's
    adapters, 1 the port's."""
    def admit(rank, seed):
        def fn(eng, toks):
            eng.admit(_tenant(arch, rank, seed)[side], lane=CHURN)
            toks[CHURN] = PROMPT            # the churned stream restarts
        return fn

    def retire(eng, toks):
        eng.retire(CHURN)
        toks[CHURN] = PROMPT

    return {3: [admit(2, 11)], 7: [retire], 10: [admit(4, 12)],
            14: [retire, admit(8, 13)]}


def _drive(eng, events, side=1, check=None):
    """Greedy-decode all lanes for STEPS, churn events applied before
    their step's decode; each lane feeds back its own argmax. Returns
    (per-step logits, per-lane streams)."""
    toks = np.full(eng.max_batch, PROMPT, np.int64)
    history, streams = [], [[] for _ in range(eng.max_batch)]
    for t in range(STEPS):
        for fn in events.get(t, ()):
            fn(eng, toks)
            if check is not None:
                check(eng)
        logits = np.asarray(eng.step(toks))
        history.append(logits)
        nxt = logits.argmax(-1)
        for lane in range(eng.max_batch):
            streams[lane].append(int(nxt[lane]))
        toks = nxt.astype(np.int64)
        if check is not None:
            check(eng)
    return history, streams


def _seat(eng, arch, side):
    eng.assign(0, _tenant(arch, 4, 1)[side])
    eng.assign(1, _tenant(arch, 8, 2)[side])


@pytest.fixture(scope="module")
def reference_paged(models):
    """The reference's paged engine through the churn schedule, once."""
    eng = _ref_engine(models, block_size=4)
    _seat(eng, "qwen2-0.5b", 0)
    hist, streams = _drive(eng, _churn_events("qwen2-0.5b", 0), side=0)
    return hist, streams, eng


# ---------------------------------------------------------------------------
# 1. Paged == dense, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_size", [4, 8])
def test_paged_equals_dense_through_churn(models, block_size):
    """Ring of 16 wraps at step 16; every lane, every step, bit-equal;
    retire -> admit recycles blocks; the allocator's invariants hold after
    every mutation; each lane's gathered cache equals the dense one at
    every live slot."""
    arch = "qwen2-0.5b"
    dense = _engine(models)
    paged = _engine(models, block_size=block_size)
    _seat(dense, arch, 1)
    _seat(paged, arch, 1)
    hist_d, streams_d = _drive(dense, _churn_events(arch, 1))
    hist_p, streams_p = _drive(paged, _churn_events(arch, 1),
                               check=lambda e: e.allocator.check())
    assert streams_p == streams_d
    for t in range(STEPS):
        np.testing.assert_array_equal(hist_p[t], hist_d[t],
                                      err_msg=f"paged != dense at step {t}")
    stats = paged.allocator_stats()
    assert stats["recycles"] > 0 and stats["oom_events"] == 0
    assert dense.allocator_stats() == {}
    for lane in range(3):
        _, rings_p = kvb.split_cache_tree(paged.cfg, paged.lane_cache(lane))
        _, rings_d = kvb.split_cache_tree(dense.cfg, dense.lane_cache(lane))
        for rp, rd in zip(rings_p, rings_d):
            assert rp["pos"].shape == rd["pos"].shape == (2, 1, 16)
            np.testing.assert_array_equal(rp["pos"], rd["pos"])
            live = (rp["pos"] >= 0)[..., None, None]
            for name in ("k", "v"):
                np.testing.assert_array_equal(
                    torch.where(live, rp[name], 0),
                    torch.where(live, rd[name], 0),
                    err_msg=f"lane {lane} live {name}")


def test_paged_decode_step_equals_dense_decode_step(models):
    """The model-level step on its own: decode_step_paged over pools and
    tables gives decode_step's logits and written entries bit for bit,
    lanes at different positions."""
    cfg = qwen2_0_5b.reduced()
    params = models["qwen2-0.5b"][1]
    B, Sc, bs = 3, 8, 4
    dense = T.init_caches(cfg, B, Sc, dtype=torch.float32, device="cpu")
    one = T.init_caches(cfg, 1, Sc, dtype=torch.float32, device="cpu")
    state, (ring0,) = kvb.split_cache_tree(cfg, one)
    pools = (kvb.make_pool(ring0, 1 + B * Sc // bs, bs),)
    alloc = kvb.BlockAllocator(1 + B * Sc // bs, B, Sc // bs)
    rng = np.random.default_rng(0)
    positions = np.array([0, 2, 5])
    for _ in range(2 * Sc):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))
        for lane in range(B):
            alloc.ensure(lane, (int(positions[lane]) % Sc) // bs)
        pos = torch.from_numpy(positions)
        want, _ = T.decode_step(params, None, cfg, LORA, tok, dense, pos)
        got, _, _ = T.decode_step_paged(
            params, None, cfg, LORA, tok, state, pools,
            torch.from_numpy(alloc.tables).long(), pos)
        assert torch.equal(got, want)
        positions += 1
    view = kvb.gather_lanes(pools[0], torch.from_numpy(alloc.tables))
    for name in ("k", "v", "pos"):
        assert torch.equal(view[name], dense["segments"][0][name]), name


# ---------------------------------------------------------------------------
# 2. Against the reference's paged engine
# ---------------------------------------------------------------------------

def test_paged_engine_matches_reference_paged_engine(models, reference_paged):
    hist_j, streams_j, jeng = reference_paged
    eng = _engine(models, block_size=4)
    _seat(eng, "qwen2-0.5b", 1)
    hist_p, streams_p = _drive(eng, _churn_events("qwen2-0.5b", 1))
    for t in range(STEPS):
        err = float(np.max(np.abs(hist_p[t] - hist_j[t])))
        assert err <= TOL, f"step {t}: max abs {err}"
    assert streams_p == streams_j
    np.testing.assert_array_equal(eng.allocator.tables, jeng.allocator.tables)
    assert eng.allocator_stats() == jeng.allocator_stats()
    np.testing.assert_array_equal(eng._positions, jeng._positions)
    assert (eng.admits, eng.retires, eng.swaps) == \
        (jeng.admits, jeng.retires, jeng.swaps)
    for lane in range(3):
        _, rings_p = kvb.split_cache_tree(eng.cfg, eng.lane_cache(lane))
        _, rings_j = jax.tree_util.tree_map(
            np.asarray, kvb.split_cache_tree(eng.cfg,
                                             jeng.lane_cache(lane)))
        np.testing.assert_array_equal(rings_p[0]["pos"], rings_j[0]["pos"])
        live = (rings_p[0]["pos"] >= 0).numpy()[..., None, None]
        for name in ("k", "v"):
            diff = np.where(live, rings_p[0][name].numpy()
                            - rings_j[0][name], 0)
            assert float(np.max(np.abs(diff))) <= TOL, (lane, name)


def test_spec_copy_adds_the_paged_fields():
    spec = ServeSpec(max_batch=3, cache_len=16, block_size=4)
    assert spec.resolve_max_blocks() == \
        JServeSpec(max_batch=3, cache_len=16,
                   block_size=4).resolve_max_blocks() == 13
    assert ServeSpec(block_size=4, max_blocks=7).resolve_max_blocks() == 7
    assert ServeSpec().resolve_max_blocks() == 0
    for bad in (dict(cache_len=10, block_size=4), dict(max_blocks=1),
                dict(max_blocks=-1), dict(cache_capacity=0)):
        with pytest.raises(ValueError):
            ServeSpec(**bad)
        with pytest.raises(ValueError):
            JServeSpec(**bad)


# ---------------------------------------------------------------------------
# 3. Sibling isolation and the allocator's observables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_size", [0, 4])
def test_sibling_lanes_bit_identical_under_churn(models, block_size):
    arch = "qwen2-0.5b"
    churn = _engine(models, block_size=block_size)
    quiet = _engine(models, block_size=block_size)
    _seat(churn, arch, 1)
    _seat(quiet, arch, 1)
    hist_c, streams_c = _drive(churn, _churn_events(arch, 1))
    hist_q, streams_q = _drive(quiet, {})
    for lane in (0, 1):
        assert streams_c[lane] == streams_q[lane], f"lane {lane}"
        for t in range(STEPS):
            np.testing.assert_array_equal(hist_c[t][lane], hist_q[t][lane])
    assert churn.admits == 3 and churn.retires == 2


def test_pools_and_tables_never_move(models):
    """Admit, retire, block growth, ring wrap and recycling update the
    pools and the device tables in place."""
    eng = _engine(models, block_size=4)
    ptrs = ([leaf.data_ptr() for pool in eng._pools
             for leaf in pool.values()], eng._tables.data_ptr())
    _seat(eng, "qwen2-0.5b", 1)
    _drive(eng, _churn_events("qwen2-0.5b", 1))
    assert eng.allocator_stats()["recycles"] > 0
    assert ([leaf.data_ptr() for pool in eng._pools
             for leaf in pool.values()], eng._tables.data_ptr()) == ptrs


def test_block_pool_exhaustion_raises_mid_step(models):
    """An undersized pool fails LOUDLY the moment a stream outgrows it —
    never by taking a sibling's block; retiring a lane un-wedges it."""
    eng = _engine(models, lanes=2, cache_len=8, block_size=4,
                  max_blocks=4)                       # 3 usable blocks
    eng.assign(0, _tenant("qwen2-0.5b", 4, 1)[1])
    eng.assign(1, _tenant("qwen2-0.5b", 8, 2)[1])
    toks = np.ones(2, np.int64)
    for _ in range(4):                 # one block per lane: fits
        eng.step(toks)
    with pytest.raises(BlockPoolExhausted):
        eng.step(toks)                 # both lanes grow; one block left
    assert eng.allocator_stats()["oom_events"] == 1
    eng.allocator.check()
    eng.retire(1)
    eng.step(toks)
    assert eng.allocator_stats()["recycles"] >= 1


def test_reset_lane_returns_blocks_to_the_pool(models):
    eng = _engine(models, lanes=2, cache_len=8, block_size=4)
    eng.assign(0, _tenant("qwen2-0.5b", 4, 1)[1])
    toks = np.ones(2, np.int64)
    for _ in range(6):
        eng.step(toks)
    assert eng.allocator.in_use_count == 4       # 2 blocks x 2 lanes
    eng.reset_lane(0)
    assert eng.allocator.in_use_count == 2
    assert eng.allocator.lane_blocks(0) == []
    eng.allocator.check()
    ring = eng.lane_cache(0)["segments"][0]
    assert bool(torch.all(ring["pos"] == -1))    # freed blocks read empty
    assert bool(torch.all(eng._pools[0]["pos"][:, :, [1, 3]] == -1))


def test_admission_strict_refuses_when_full(models):
    eng = _engine(models, lanes=2, block_size=4)
    eng.admit(_tenant("qwen2-0.5b", 2, 1)[1])
    eng.admit(_tenant("qwen2-0.5b", 4, 2)[1])
    with pytest.raises(RuntimeError, match="no free lane"):
        eng.admit(_tenant("qwen2-0.5b", 8, 3)[1])
    assert eng.admit(_tenant("qwen2-0.5b", 8, 3)[1], lane=1) == 1


def test_admission_evict_oldest_retires_the_head(models):
    eng = _engine(models, lanes=2, block_size=4, admission="evict_oldest")
    assert [eng.admit(_tenant("qwen2-0.5b", r, s)[1])
            for r, s in ((2, 1), (4, 2))] == [0, 1]
    eng.step(np.ones(2, np.int64))
    assert eng.admit(_tenant("qwen2-0.5b", 8, 3)[1]) == 0
    assert eng.retires == 1 and eng.allocator.lane_blocks(0) == []
    assert eng.assigned[0].rank == 8 and eng.assigned[1].rank == 4
    assert eng.admit(_tenant("qwen2-0.5b", 2, 4)[1]) == 1


# ---------------------------------------------------------------------------
# 4. Recurrent state stays dense
# ---------------------------------------------------------------------------

def test_rwkv6_paged_engine_equals_dense(models):
    arch = "rwkv6-7b"
    dense = _engine(models, arch)
    paged = _engine(models, arch, block_size=4)
    assert paged._pools == () and kvb.paged_slots(paged.cfg) == []
    _seat(dense, arch, 1)
    _seat(paged, arch, 1)
    hist_d, streams_d = _drive(dense, _churn_events(arch, 1))
    hist_p, streams_p = _drive(paged, _churn_events(arch, 1))
    assert streams_p == streams_d
    for t in range(STEPS):
        np.testing.assert_array_equal(hist_p[t], hist_d[t])
    for name, leaf in paged.lane_cache(CHURN)["segments"][0].items():
        assert torch.equal(leaf, dense.lane_cache(CHURN)["segments"][0][name])
