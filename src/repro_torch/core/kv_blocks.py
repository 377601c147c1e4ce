"""Block-paged KV cache for the serving tier, port of
``repro/core/kv_blocks.py``.

Dense serving gives every lane a full ``cache_len``-token ring buffer up
front. Paged serving replaces the per-lane ring with a shared pool of
fixed-size *blocks* (``block_size`` tokens each) plus a per-lane *block
table* mapping logical block index -> physical pool block: long streams
allocate blocks as their position crosses block boundaries, and a
retired lane's blocks return to the free list for the next tenant.

Layout. The port's dense cache leaf is ``(L, B, Sc, *tail)`` (layer
stack, lanes, a ring of ``Sc = cache_len`` slots); one lane's view is
``(L, 1, Sc, *tail)``. A pool keeps the reference's layout, ``(L, 1,
num_blocks, block_size, *tail)``, so a pool converts leaf for leaf
through :mod:`repro_torch.interop`. Logical slot ``s`` of a lane lives
at ``(table[s // block_size], s % block_size)``. One table row per lane
serves every paged cache of the model.

Physical block 0 is the permanent NULL block: never allocated, never
written, ``pos == -1`` everywhere. Unallocated table entries point at it,
so a gather is always in bounds and the attention mask (``kv_positions
>= 0``) hides it. Freeing a block stamps its ``pos`` entries back to -1
(:func:`release_blocks`), so a recycled block never leaks a previous
tenant's positions; its stale K/V values are unreachable behind the
mask, and masked slots contribute exact zeros through the softmax, so
paged decode gives the dense engine's bits.

Only ring-buffer caches page: attention's k/v/pos, MLA's latent
c_kv/k_rope/pos and zamba2's shared-attention rings. Recurrent state
(rwkv6, mamba2) is O(1) per lane and stays a dense per-lane carry.

Pools, tables and lane caches are torch tensors updated IN PLACE
(:func:`scatter_written`, :func:`release_blocks`), so the serve engine's
pools never move; the allocator's tables are host-side numpy.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import BLOCK_ATTN, BLOCK_MLA, ModelConfig

# physical block 0: permanently empty, the target of unallocated table
# entries — gathers stay in bounds, the pos == -1 mask does the rest
NULL_BLOCK = 0


class BlockPoolExhausted(RuntimeError):
    """The block pool has no free blocks left. Raised loudly — silently
    wrapping into another tenant's blocks would corrupt sibling streams."""


# ---------------------------------------------------------------------------
# Host-side free-list allocator
# ---------------------------------------------------------------------------

class BlockAllocator:
    """Free-list allocator over ``num_blocks`` physical blocks.

    Host-side bookkeeping: the tables are int32 numpy (one row per lane,
    ``blocks_per_lane`` logical entries, ``NULL_BLOCK`` = unallocated)
    that the serve engine copies to the device each step. Invariants:

    - a physical block is owned by at most one (lane, logical) entry at a
      time — :meth:`ensure` never double-assigns;
    - conservation: ``free_count + in_use_count == num_blocks - 1`` (the
      null block is outside the economy) after every operation;
    - exhaustion raises :class:`BlockPoolExhausted`, it never wraps.
    """

    def __init__(self, num_blocks: int, num_lanes: int,
                 blocks_per_lane: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (null block + at least one "
                f"usable block), got {num_blocks}")
        if num_lanes < 1 or blocks_per_lane < 1:
            raise ValueError("num_lanes and blocks_per_lane must be >= 1")
        self.num_blocks = int(num_blocks)
        self.num_lanes = int(num_lanes)
        self.blocks_per_lane = int(blocks_per_lane)
        self.tables = np.full((num_lanes, blocks_per_lane), NULL_BLOCK,
                              np.int32)
        # stack: pop() hands out low ids first (1, 2, ...)
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._in_use: set = set()
        self._ever_used: set = set()
        self.allocs = 0
        self.frees = 0
        self.recycles = 0      # allocations served by a previously-freed block
        self.oom_events = 0
        self.high_water = 0

    # -- queries --------------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use_count(self) -> int:
        return len(self._in_use)

    def lane_blocks(self, lane: int) -> List[int]:
        """Physical blocks currently owned by ``lane`` (table order)."""
        return [int(b) for b in self.tables[lane] if b != NULL_BLOCK]

    def stats(self) -> Dict[str, Any]:
        return {
            "num_blocks": self.num_blocks,
            "allocs": self.allocs,
            "frees": self.frees,
            "recycles": self.recycles,
            "oom_events": self.oom_events,
            "in_use": self.in_use_count,
            "free": self.free_count,
            "high_water": self.high_water,
            "reuse_rate": (self.recycles / self.allocs
                           if self.allocs else 0.0),
        }

    def check(self) -> None:
        """Raise AssertionError unless the structural invariants hold
        (cheap; tests call this after every mutation)."""
        live = [int(b) for b in self.tables.ravel() if b != NULL_BLOCK]
        if len(live) != len(set(live)):
            raise AssertionError("block double-assigned")
        if set(live) != self._in_use:
            raise AssertionError("table/in-use set diverged")
        if self._in_use & set(self._free):
            raise AssertionError("block both free and in use")
        if self.free_count + self.in_use_count != self.num_blocks - 1:
            raise AssertionError("free-list conservation violated")
        if NULL_BLOCK in self._in_use or NULL_BLOCK in self._free:
            raise AssertionError("null block entered the economy")

    # -- mutations ------------------------------------------------------
    def ensure(self, lane: int, logical: int) -> Optional[int]:
        """Make sure ``lane``'s logical block ``logical`` is backed by a
        physical block. Returns the physical id if this call allocated a
        fresh block, None if it was already mapped."""
        if self.tables[lane, logical] != NULL_BLOCK:
            return None
        if not self._free:
            self.oom_events += 1
            raise BlockPoolExhausted(
                f"block pool exhausted: all {self.num_blocks - 1} usable "
                f"blocks in use (lane {lane} needs logical block "
                f"{logical}); raise ServeSpec.max_blocks or retire lanes")
        blk = self._free.pop()
        self._in_use.add(blk)
        if blk in self._ever_used:
            self.recycles += 1
        self._ever_used.add(blk)
        self.tables[lane, logical] = blk
        self.allocs += 1
        self.high_water = max(self.high_water, len(self._in_use))
        return blk

    def free_lane(self, lane: int) -> List[int]:
        """Release every block ``lane`` owns back to the free list. Returns
        the freed physical ids (the engine stamps their pool ``pos`` back
        to -1 with :func:`release_blocks`)."""
        freed = self.lane_blocks(lane)
        for blk in freed:
            self._in_use.discard(blk)
            self._free.append(blk)
            self.frees += 1
        self.tables[lane] = NULL_BLOCK
        return freed

    def reset(self) -> List[int]:
        """Free every lane. Returns all freed physical ids."""
        freed: List[int] = []
        for lane in range(self.num_lanes):
            freed.extend(self.free_lane(lane))
        return freed


# ---------------------------------------------------------------------------
# Cache-tree plumbing: which slots page, pool construction, gather/scatter
# ---------------------------------------------------------------------------

Slot = Tuple


def paged_slots(cfg: ModelConfig) -> List[Slot]:
    """Tree addresses of the ring-buffer (position-indexed) caches in
    ``transformer.init_caches(cfg, ...)`` order: the attention and MLA
    segments, plus zamba2's shared block (``("shared_attn",)``, its
    rings stacked over the applications as a layer axis). Recurrent-state
    segments carry no ``pos`` ring and stay dense."""
    from repro_torch.models.transformer import segments_of
    slots: List[Slot] = [("segments", i)
                         for i, (kind, _) in enumerate(segments_of(cfg))
                         if kind in (BLOCK_ATTN, BLOCK_MLA)]
    if cfg.shared_attn_every:
        slots.append(("shared_attn",))
    return slots


def get_slot(caches: Dict, slot: Slot):
    return (caches["segments"][slot[1]] if slot[0] == "segments"
            else caches["shared_attn"])


def _set_slot(caches: Dict, slot: Slot, value) -> Dict:
    out = dict(caches)
    if slot[0] == "segments":
        segs = list(out["segments"])
        segs[slot[1]] = value
        out["segments"] = segs
    else:
        out["shared_attn"] = value
    return out


def split_cache_tree(cfg: ModelConfig, caches: Dict
                     ) -> Tuple[Dict, List[Dict]]:
    """Split a cache tree into (state_tree, paged_caches): the state tree
    keeps the recurrent segments and holds an EMPTY dict at each paged
    slot; paged_caches lists the ring-buffer cache dicts in
    :func:`paged_slots` order."""
    paged = []
    state = caches
    for slot in paged_slots(cfg):
        paged.append(get_slot(state, slot))
        state = _set_slot(state, slot, {})
    return state, paged


def merge_lane_caches(cfg: ModelConfig, state_caches: Dict,
                      gathered: Sequence[Dict]) -> Dict:
    """Inverse of :func:`split_cache_tree`: drop the gathered dense views
    back into the paged slots of the state tree."""
    out = state_caches
    for slot, g in zip(paged_slots(cfg), gathered):
        out = _set_slot(out, slot, g)
    return out


def strip_paged(cfg: ModelConfig, caches: Dict) -> Dict:
    """Replace the paged slots of a full cache tree with empty dicts —
    what remains is the dense recurrent carry."""
    out = caches
    for slot in paged_slots(cfg):
        out = _set_slot(out, slot, {})
    return out


def make_pool(cache: Dict, num_blocks: int, block_size: int) -> Dict:
    """A shared block pool shaped after one lane's dense cache: every leaf
    ``(L, 1, Sc, *tail)`` becomes ``(L, 1, num_blocks, block_size,
    *tail)`` on the leaf's device. ``pos`` starts at -1 everywhere
    (including the null block), value leaves at zero."""
    def mk(name, leaf):
        shape = (tuple(leaf.shape[:2]) + (num_blocks, block_size)
                 + tuple(leaf.shape[3:]))
        fill = -1 if name == "pos" else 0
        return torch.full(shape, fill, dtype=leaf.dtype, device=leaf.device)

    return {name: mk(name, leaf) for name, leaf in cache.items()}


def pool_block_size(pool: Dict) -> int:
    return int(pool["pos"].shape[3])


def gather_lane(pool: Dict, table_row: torch.Tensor) -> Dict:
    """One lane's dense ring-buffer view of a pool: its table's blocks,
    flattened back to ``(L, 1, Sc, *tail)`` (a copy). Unallocated entries
    read the null block (pos = -1 -> masked)."""
    return {name: g[:, :1] for name, g in
            gather_lanes(pool, table_row.reshape(1, -1)).items()}


def gather_lanes(pool: Dict, tables: torch.Tensor) -> Dict:
    """Every lane's dense view at once: ``tables`` (B, T) gives leaves
    ``(L, B, T * block_size, *tail)``, the port's dense cache layout (a
    copy). Lane ``b`` equals :func:`gather_lane` of ``tables[b]``."""
    idx = tables.to(device=pool["pos"].device, dtype=torch.long)
    B, T = idx.shape

    def g(leaf):
        got = leaf[:, 0][:, idx]                  # (L, B, T, bs, *tail)
        return got.reshape((leaf.shape[0], B, T * leaf.shape[3])
                           + tuple(leaf.shape[4:]))

    return {name: g(leaf) for name, leaf in pool.items()}


def written_slot(dense_cache: Dict, idx) -> Dict:
    """The single ring slot one lane's decode step just wrote: leaf
    ``(L, 1, Sc, *tail)`` -> ``(L, 1, *tail)`` at ring index ``idx``."""
    return {name: leaf[:, :, int(idx)] for name, leaf in dense_cache.items()}


def written_slots(dense_caches: Dict, idx: torch.Tensor) -> Dict:
    """Every lane's just-written ring slot from the lane-batched dense
    cache: leaf ``(L, B, Sc, *tail)`` and ``idx`` (B,) -> ``(B, L, 1,
    *tail)``, the stacked layout :func:`scatter_written` takes (lane b's
    entry is :func:`written_slot` of its lane at ``idx[b]``)."""
    idx = idx.to(dtype=torch.long)
    lanes = torch.arange(idx.shape[0], device=idx.device)
    return {name: leaf[:, lanes, idx].movedim(1, 0)[:, :, None]
            for name, leaf in dense_caches.items()}


def scatter_written(pool: Dict, written: Dict, tables: torch.Tensor,
                    positions: torch.Tensor, block_size: int) -> Dict:
    """Write every lane's just-decoded slot into the pool, IN PLACE.

    written: leaves ``(B, L, 1, *tail)`` (:func:`written_slots`). tables:
    ``(B, T)``. positions: ``(B,)`` absolute per-lane positions of the
    tokens being written. Destination slots are distinct across lanes
    (the allocator never double-assigns a block), so the order of the
    writes cannot matter. Returns ``pool``."""
    tables = tables.to(device=pool["pos"].device, dtype=torch.long)
    positions = positions.to(device=tables.device, dtype=torch.long)
    ring = positions % (tables.shape[1] * block_size)
    blk = torch.gather(tables, 1, (ring // block_size)[:, None])[:, 0]
    off = ring % block_size
    for name, leaf in pool.items():
        upd = written[name].movedim(0, 2)         # (L, 1, B, *tail)
        leaf[:, :, blk, off] = upd.to(leaf.dtype)
    return pool


def release_blocks(pool: Dict, block_ids: Sequence[int]) -> Dict:
    """Retire path: stamp freed physical blocks empty (``pos = -1``), IN
    PLACE, so a tenant that later recycles them can never attend to the
    previous owner's entries. K/V values stay — they are unreachable
    behind the position mask. Returns ``pool``."""
    if len(block_ids):
        ids = torch.as_tensor(np.asarray(block_ids, np.int64),
                              device=pool["pos"].device)
        pool["pos"][:, :, ids] = -1
    return pool
