"""The port's block-paged KV plumbing (``repro_torch.core.kv_blocks``)
against the reference's ``repro.core.kv_blocks``, on the CPU.

Two layers, after the reference's ``tests/test_kv_blocks.py``:

1. The host-side :class:`BlockAllocator` is model-checked against the
   reference's allocator and a straight-line re-statement of the
   contract under random ensure / free_lane / reset sequences
   (hypothesis), with deterministic twins: tables, free lists, return
   values, exhaustion and every counter equal; the invariants hold
   after every operation.
2. The pool plumbing (make_pool, gather_lane, gather_lanes,
   written_slot, scatter_written, release_blocks) on the same numpy
   inputs gives the reference's arrays bit for bit, a stream of writes
   gathers back to a dense ring buffer, and paged_slots / split / merge
   page exactly the attention caches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen2_0_5b as jqwen
from repro.configs import rwkv6_7b as jrwkv
from repro.core import kv_blocks as jkvb
from repro.models import transformer as JT
from repro_torch.configs import qwen2_0_5b, rwkv6_7b
from repro_torch.core import kv_blocks as kvb
from repro_torch.core.kv_blocks import (BlockAllocator, BlockPoolExhausted,
                                        NULL_BLOCK)
from repro_torch.models import transformer as T

from hypothesis import given, settings, strategies as st

torch.set_num_threads(1)

FAST = dict(max_examples=80, deadline=None)


# ---------------------------------------------------------------------------
# The allocator against the reference's and a plain model
# ---------------------------------------------------------------------------

class RefAllocator:
    """Straight-line re-statement of the allocator contract: a LIFO free
    list over blocks 1..num_blocks-1, NULL_BLOCK-initialised tables,
    ensure() maps one fresh block per unmapped entry."""

    def __init__(self, num_blocks, num_lanes, blocks_per_lane):
        self.tables = np.full((num_lanes, blocks_per_lane), NULL_BLOCK,
                              np.int32)
        self.free = list(range(num_blocks - 1, 0, -1))

    def ensure(self, lane, logical):
        if self.tables[lane, logical] != NULL_BLOCK:
            return None
        if not self.free:
            raise BlockPoolExhausted("model: pool exhausted")
        blk = self.free.pop()
        self.tables[lane, logical] = blk
        return blk

    def free_lane(self, lane):
        freed = [int(b) for b in self.tables[lane] if b != NULL_BLOCK]
        self.free.extend(freed)
        self.tables[lane] = NULL_BLOCK
        return freed

    def reset(self):
        out = []
        for lane in range(self.tables.shape[0]):
            out.extend(self.free_lane(lane))
        return out


def _apply(op, port, ref, model):
    """One op on the port's allocator, the reference's and the model; all
    agree on success, return value and exhaustion."""
    kind = op[0]
    if kind == "ensure":
        _, lane, logical = op
        try:
            want = model.ensure(lane, logical)
        except BlockPoolExhausted:
            with pytest.raises(BlockPoolExhausted):
                port.ensure(lane, logical)
            with pytest.raises(jkvb.BlockPoolExhausted):
                ref.ensure(lane, logical)
            return
        assert port.ensure(lane, logical) == ref.ensure(lane, logical) == want
    elif kind == "free":
        assert port.free_lane(op[1]) == ref.free_lane(op[1]) == \
            model.free_lane(op[1])
    else:
        assert port.reset() == ref.reset() == model.reset()


def _same(port, ref, model):
    np.testing.assert_array_equal(port.tables, ref.tables)
    np.testing.assert_array_equal(port.tables, model.tables)
    assert port._free == ref._free
    assert sorted(port._free) == sorted(model.free)
    assert port.stats() == ref.stats()
    port.check()
    ref.check()


def _run(schedule, nb, nl, bpl):
    port, ref, model = (BlockAllocator(nb, nl, bpl),
                        jkvb.BlockAllocator(nb, nl, bpl),
                        RefAllocator(nb, nl, bpl))
    for op in schedule:
        _apply(op, port, ref, model)
        _same(port, ref, model)
    return port


_geometry = st.tuples(st.integers(2, 12),    # num_blocks
                      st.integers(1, 4),     # num_lanes
                      st.integers(1, 4))     # blocks_per_lane


def _ops(num_lanes, blocks_per_lane):
    ensure = st.tuples(st.just("ensure"),
                       st.integers(0, num_lanes - 1),
                       st.integers(0, blocks_per_lane - 1))
    free = st.tuples(st.just("free"), st.integers(0, num_lanes - 1))
    reset = st.tuples(st.just("reset"))
    return st.lists(st.one_of(ensure, free, reset), max_size=60)


@settings(**FAST)
@given(data=st.data())
def test_allocator_model_check(data):
    nb, nl, bpl = data.draw(_geometry)
    _run(data.draw(_ops(nl, bpl)), nb, nl, bpl)


SCHEDULE = [("ensure", 0, 0), ("ensure", 0, 0),   # idempotent re-map
            ("ensure", 1, 0), ("ensure", 0, 1), ("ensure", 1, 2),
            ("ensure", 1, 1),                     # pool now full -> OOM
            ("free", 0), ("ensure", 1, 1),        # recycle lane 0's
            ("reset",), ("ensure", 0, 2), ("free", 1), ("free", 1)]


@pytest.mark.parametrize("cut", [len(SCHEDULE), 6, 9])
def test_allocator_model_check_deterministic(cut):
    """Twins of the property: a fixed adversarial schedule (alloc,
    interleaved frees, reset, recycling, exhaustion), whole and cut
    before the recycling and before the reset."""
    port = _run(SCHEDULE[:cut], 5, 2, 3)    # 4 usable blocks, 6 entries
    assert port.oom_events == (1 if cut >= 6 else 0)


@pytest.mark.parametrize("seed", range(4))
def test_allocator_random_schedules_match_reference(seed):
    """Seeded random schedules on random geometries (the property's
    deterministic twin)."""
    rng = np.random.default_rng(seed)
    nb, nl, bpl = (int(rng.integers(2, 13)), int(rng.integers(1, 5)),
                   int(rng.integers(1, 5)))
    ops = []
    for _ in range(60):
        u = rng.random()
        if u < 0.7:
            ops.append(("ensure", int(rng.integers(nl)),
                        int(rng.integers(bpl))))
        elif u < 0.95:
            ops.append(("free", int(rng.integers(nl))))
        else:
            ops.append(("reset",))
    _run(ops, nb, nl, bpl)


def test_allocator_never_hands_out_null_block():
    a = BlockAllocator(4, 1, 3)
    got = [a.ensure(0, i) for i in range(3)]
    assert NULL_BLOCK not in got
    assert sorted(got) == [1, 2, 3]   # low ids first


def test_allocator_oom_raises_and_counts():
    a = BlockAllocator(2, 2, 2)       # exactly ONE usable block
    assert a.ensure(0, 0) == 1
    with pytest.raises(BlockPoolExhausted):
        a.ensure(1, 0)
    assert a.oom_events == 1
    a.check()                         # OOM must not corrupt state
    a.free_lane(0)
    assert a.ensure(1, 0) == 1
    assert a.recycles == 1


def test_allocator_free_then_realloc_recycles():
    a = BlockAllocator(6, 2, 2)
    a.ensure(0, 0), a.ensure(0, 1)
    assert sorted(a.free_lane(0)) == [1, 2]
    assert a.frees == 2
    assert {a.ensure(1, 0), a.ensure(1, 1)} == {1, 2}   # LIFO: recycled
    assert a.recycles == 2
    assert a.stats()["reuse_rate"] == pytest.approx(0.5)
    a.check()


def test_allocator_conservation_after_every_op():
    a = BlockAllocator(7, 3, 2)
    for lane in range(3):
        for logical in range(2):
            a.ensure(lane, logical)
            assert a.free_count + a.in_use_count == 6
            a.check()
    assert a.high_water == 6
    a.reset()
    assert a.free_count == 6 and a.in_use_count == 0
    a.check()


def test_allocator_check_catches_a_double_assignment():
    a = BlockAllocator(4, 2, 2)
    a.ensure(0, 0)
    a.tables[1, 0] = a.tables[0, 0]   # planted: one block, two owners
    with pytest.raises(AssertionError, match="double-assigned"):
        a.check()


@pytest.mark.parametrize("geometry", [(1, 1, 1), (4, 0, 1), (4, 1, 0)])
def test_allocator_rejects_degenerate_geometry(geometry):
    with pytest.raises(ValueError):
        BlockAllocator(*geometry)


# ---------------------------------------------------------------------------
# Pool plumbing against the reference's, and against a dense ring
# ---------------------------------------------------------------------------

L, SC, BS, TAIL = 2, 8, 4, (3,)      # 2 layers, ring of 8, 2 blocks/lane


def _np_dense_cache(seed=0):
    """A minimal attention-style one-lane cache: k/v rings + pos."""
    rng = np.random.default_rng(seed)
    return {"k": rng.normal(size=(L, 1, SC) + TAIL).astype(np.float32),
            "v": rng.normal(size=(L, 1, SC) + TAIL).astype(np.float32),
            "pos": np.full((L, 1, SC), -1, np.int32)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _eq(port, ref):
    assert port.keys() == ref.keys()
    for name in port:
        np.testing.assert_array_equal(port[name].numpy(),
                                      np.asarray(ref[name]), err_msg=name)


def test_make_pool_matches_reference():
    pool = kvb.make_pool(_t(_np_dense_cache()), 5, BS)
    _eq(pool, jkvb.make_pool(_j(_np_dense_cache()), 5, BS))
    assert pool["k"].shape == (L, 1, 5, BS) + TAIL
    assert pool["pos"].dtype == torch.int32
    assert kvb.pool_block_size(pool) == BS


def _written(rng, lanes, positions):
    return {"k": rng.normal(size=(lanes, L, 1) + TAIL).astype(np.float32),
            "v": rng.normal(size=(lanes, L, 1) + TAIL).astype(np.float32),
            "pos": np.broadcast_to(positions[:, None, None].astype(np.int32),
                                   (lanes, L, 1)).copy()}


def test_scatter_and_gather_match_reference_and_a_dense_ring():
    """Stream tokens through two lanes: the port's in-place scatter gives
    the reference's pool after every step, and gathering each lane (one
    at a time and all at once) gives the reference's view and a dense
    numpy ring buffer."""
    nb, lanes, T_ = 6, 2, SC // BS
    alloc = BlockAllocator(nb, lanes, T_)
    pool = kvb.make_pool(_t(_np_dense_cache()), nb, BS)
    jpool = jkvb.make_pool(_j(_np_dense_cache()), nb, BS)
    dense = [{k: np.array(v) for k, v in _np_dense_cache().items()}
             for _ in range(lanes)]
    rng = np.random.default_rng(1)
    positions = np.array([0, 3], np.int64)      # lanes out of step
    for step in range(SC + 3):                  # wrap the ring
        w = _written(rng, lanes, positions)
        for lane in range(lanes):
            alloc.ensure(lane, (int(positions[lane]) % SC) // BS)
            slot = int(positions[lane]) % SC
            for name in w:
                dense[lane][name][:, :, slot] = w[name][lane]
        tables = alloc.tables.copy()
        out = kvb.scatter_written(pool, _t(w), torch.from_numpy(tables),
                                  torch.from_numpy(positions), BS)
        assert out is pool                       # in place
        jpool = jkvb.scatter_written(jpool, _j(w), jnp.asarray(tables),
                                     jnp.asarray(positions, jnp.int32), BS)
        _eq(pool, jpool)
        positions += 1
    both = kvb.gather_lanes(pool, torch.from_numpy(alloc.tables))
    for lane in range(lanes):
        row = alloc.tables[lane]
        got = kvb.gather_lane(pool, torch.from_numpy(row))
        _eq(got, jkvb.gather_lane(jpool, jnp.asarray(row)))
        for name in got:
            np.testing.assert_array_equal(got[name].numpy(),
                                          dense[lane][name])
            np.testing.assert_array_equal(both[name][:, lane:lane + 1],
                                          got[name])


def test_written_slots_match_the_reference_per_lane():
    rng = np.random.default_rng(2)
    B = 3
    cache = {"k": rng.normal(size=(L, B, SC) + TAIL).astype(np.float32),
             "pos": rng.integers(-1, 9, (L, B, SC)).astype(np.int32)}
    idx = np.array([0, 7, 3])
    got = kvb.written_slots(_t(cache), torch.from_numpy(idx))
    for b in range(B):
        lane = {k: v[:, b:b + 1] for k, v in cache.items()}
        want = jkvb.written_slot(_j(lane), jnp.int32(idx[b]))
        one = kvb.written_slot(_t(lane), idx[b])
        for name in cache:
            np.testing.assert_array_equal(got[name][b].numpy(),
                                          np.asarray(want[name]))
            np.testing.assert_array_equal(one[name].numpy(),
                                          np.asarray(want[name]))


def test_gather_unallocated_entries_read_null_block():
    alloc = BlockAllocator(4, 1, SC // BS)
    pool = kvb.make_pool(_t(_np_dense_cache()), 4, BS)
    alloc.ensure(0, 0)                # only the FIRST logical block
    got = kvb.gather_lane(pool, torch.from_numpy(alloc.tables[0]))
    assert got["pos"].shape == (L, 1, SC)
    assert bool(torch.all(got["pos"][:, :, BS:] == -1))


def test_release_blocks_matches_reference_in_place():
    pool = kvb.make_pool(_t(_np_dense_cache()), 5, BS)
    pool["pos"][:, :, 1:] = 7                    # blocks 1..4 "written"
    k_before = pool["k"].clone()
    jpool = dict(jkvb.make_pool(_j(_np_dense_cache()), 5, BS))
    jpool["pos"] = jpool["pos"].at[:, :, 1:].set(7)
    out = kvb.release_blocks(pool, [2, 3])
    assert out is pool
    _eq(pool, jkvb.release_blocks(jpool, [2, 3]))
    assert bool(torch.all(pool["pos"][:, :, [1, 4]] == 7))
    assert torch.equal(pool["k"], k_before)      # values untouched
    assert kvb.release_blocks(pool, []) is pool


# ---------------------------------------------------------------------------
# paged_slots: exactly the position-indexed caches page
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "rwkv6-7b"])
def test_paged_slots_split_and_merge_match_reference(arch):
    jcfg = (jqwen if arch == "qwen2-0.5b" else jrwkv).reduced()
    cfg = (qwen2_0_5b if arch == "qwen2-0.5b" else rwkv6_7b).reduced()
    assert kvb.paged_slots(cfg) == jkvb.paged_slots(jcfg)
    caches = T.init_caches(cfg, 1, SC, dtype=torch.float32, device="cpu")
    jcaches = JT.init_caches(jcfg, 1, SC, dtype=jnp.float32)
    state, paged = kvb.split_cache_tree(cfg, caches)
    jstate, jpaged = jkvb.split_cache_tree(jcfg, jcaches)
    assert len(paged) == len(jpaged) == len(kvb.paged_slots(cfg))
    for p, jp in zip(paged, jpaged):
        _eq(p, jp)
    assert [sorted(s) for s in state["segments"]] == \
        [sorted(s) for s in jstate["segments"]]
    for s, js in zip(state["segments"], jstate["segments"]):
        _eq(s, js)
    merged = kvb.merge_lane_caches(cfg, state, paged)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda x: 0, merged)) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda x: 0, caches))
    stripped = kvb.strip_paged(cfg, caches)
    assert all(stripped["segments"][s[1]] == {}
               for s in kvb.paged_slots(cfg))
