"""Serving tier of the port: prefill/decode step factories and the dense
multi-tenant :class:`ServeEngine`.

Port of ``repro/launch/serve.py``. The factories take a ``device`` where
the reference takes a mesh, and return plain callables (PyTorch runs
eagerly; there is no jit builder). On a card, prefill runs the
``lora_matmul`` kernel and, by block kind, ``flash_attention`` (attn) or
``wkv6`` (rwkv6); decode runs ``lora_matmul``. On the CPU the same code
takes their plain versions. Prefill returns logits only, as the
reference's does; the engine teacher-forces prompts through decode steps.

:class:`ServeEngine` decodes ``ServeSpec.max_batch`` lanes in one step.
The reference gets its lanes by ``vmap`` of a single-sequence decode;
here the lane axis is written out: adapters are stored lane-batched
(leaves (L, B, ...)), each lane has its own scale, position, ring slot
and RoPE angle, and every LoRA linear of a step is one kernel launch for
all lanes. ``assign``/``evict``/``admit``/``retire``/``reset_lane`` are
in-place copies into one lane, so sibling lanes are never disturbed.

With ``ServeSpec.block_size > 0`` the engine runs block-paged: the
attention caches live in shared pools behind a
:class:`~repro_torch.core.kv_blocks.BlockAllocator`, lanes grow block by
block as their streams lengthen, and ``retire``/``reset_lane`` return
blocks to the free list for the next admission. Pools and the device
copy of the block tables have fixed shapes and are updated in place, so
churn never reallocates them. Recurrent state (rwkv6, mamba2) stays a
per-lane dense carry, so a paged rwkv6 engine has no pools and decodes
as the dense one does; a paged zamba2 engine pages only its shared
block's rings. Prefill fills no recurrent state (neither does the
reference's), which is why the engine teacher-forces prompts.

CLI (reduced config):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b --block-size 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --device cpu --block-size 16
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import LoRAConfig, ModelConfig, ServeSpec
from repro_torch.core import kv_blocks as kvb
from repro_torch.interop import tree_map
from repro_torch.launch.adapter_cache import PagedAdapter
from repro_torch.models import transformer as T
from repro_torch.models.runmode import resolve_device


def make_prefill_step(cfg: ModelConfig, lora: LoRAConfig, *,
                      device="cuda", sliding_window=None):
    """prefill(params, adapters, batch) -> logits (B, P + S, V); batch:
    tokens (B, S) [, prefix_embeds (B, P, d), a VLM's stubbed frontend]."""
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill(params, adapters, batch):
        inputs = {"tokens": torch.as_tensor(batch["tokens"],
                                            device=dev).long()}
        if batch.get("prefix_embeds") is not None:
            inputs["prefix_embeds"] = torch.as_tensor(
                batch["prefix_embeds"], device=dev)
        logits, _ = T.forward(params, adapters, cfg, lora, inputs,
                              sliding_window=sliding_window)
        return logits

    return prefill


def make_decode_step(cfg: ModelConfig, lora: LoRAConfig, *,
                     device="cuda", sliding_window=None):
    """decode(params, adapters, token, caches, position, scale=None) ->
    (logits (B, 1, V), caches). ``scale`` (scalar or per-lane (B,)) lets
    one step serve adapters of any rank; None uses ``lora.scale``."""
    dev = resolve_device(device)

    @torch.no_grad()
    def decode(params, adapters, token, caches, position, scale=None):
        token = torch.as_tensor(token, device=dev).long()
        return T.decode_step(params, adapters, cfg, lora, token, caches,
                             position, sliding_window=sliding_window,
                             scale=scale)

    return decode


def _zip_apply(full, one, fn) -> None:
    """fn(full_leaf, one_leaf) over two trees of the same structure."""
    if isinstance(full, dict):
        for k in full:
            _zip_apply(full[k], one[k], fn)
    elif isinstance(full, (list, tuple)):
        for f, o in zip(full, one):
            _zip_apply(f, o, fn)
    else:
        fn(full, one)


# ---------------------------------------------------------------------------
# Multi-tenant serving engine
# ---------------------------------------------------------------------------

class ServeEngine:
    """Batched multi-tenant decode over rank-padded adapter slots.

    Each of the ``spec.max_batch`` lanes serves one tenant: a
    :class:`PagedAdapter` (any rank ≤ the slot width) plus its own cache
    slice and position counter. Unassigned lanes hold zero adapters at
    zero scale — exact base-model decode.

    Adapter leaves are stored (n_layers, max_batch, ...), so each layer's
    lane batch is one contiguous operand of the ``lora_matmul`` kernel;
    zamba2's shared block's (unstacked) leaves are stored (max_batch,
    ...).
    Decode sends the per-lane scales and an all-ones rank mask as kernel
    operands (the slots' zero tails already make padding exact).

    With ``spec.block_size > 0`` the attention caches are block-paged
    (see the module docstring); :meth:`lane_cache` gives a lane's
    dense-equivalent view and :meth:`allocator_stats` the allocator's
    counters.
    """

    def __init__(self, params, cfg: ModelConfig, lora: LoRAConfig,
                 spec: Optional[ServeSpec] = None, *,
                 dtype=torch.float32, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.lora = lora
        self.spec = spec or ServeSpec()
        self.params = params
        self.slot_rank = self.spec.resolve_max_rank(lora)
        self.dtype = dtype
        B = self.spec.max_batch
        self._slot_lora = dataclasses.replace(lora, rank=self.slot_rank,
                                              max_rank=self.slot_rank)
        zero = tree_map(torch.zeros_like, T.init_adapters(
            cfg, self._slot_lora, device=self.device))
        self._zero_adapter = zero
        self._adapters = {"segments": tree_map(lambda x: torch.zeros(
            x.shape[:1] + (B,) + x.shape[1:], dtype=x.dtype,
            device=x.device), zero["segments"])}
        if "shared_attn" in zero:
            self._adapters["shared_attn"] = tree_map(lambda x: torch.zeros(
                (B,) + x.shape, dtype=x.dtype, device=x.device),
                zero["shared_attn"])
        self._scales = torch.zeros(B, dtype=torch.float32, device=self.device)
        self._mask = torch.ones((B, self.slot_rank), dtype=torch.float32,
                                device=self.device)
        self._cache0 = T.init_caches(cfg, 1, self.spec.cache_len,
                                     dtype=dtype, device=self.device)
        self.paged = self.spec.paged
        self.allocator: Optional[kvb.BlockAllocator] = None
        if self.paged:
            bs = self.spec.block_size
            num_blocks = self.spec.resolve_max_blocks()
            self.allocator = kvb.BlockAllocator(
                num_blocks, B, self.spec.cache_len // bs)
            self._tables = torch.zeros(self.allocator.tables.shape,
                                       dtype=torch.long, device=self.device)
            state0, paged0 = kvb.split_cache_tree(cfg, self._cache0)
            self._cache0 = state0
            self._pools = tuple(kvb.make_pool(c, num_blocks, bs)
                                for c in paged0)
            self._caches = kvb.strip_paged(cfg, T.init_caches(
                cfg, B, 1, dtype=dtype, device=self.device))
        else:
            self._caches = T.init_caches(cfg, B, self.spec.cache_len,
                                         dtype=dtype, device=self.device)
        self._positions = np.zeros(B, np.int64)
        self.assigned: Dict[int, Optional[PagedAdapter]] = \
            {i: None for i in range(B)}
        self.swaps = 0
        self.admits = 0
        self.retires = 0
        self._admit_order: list = []     # lanes, oldest admission first

    # -- tenancy --------------------------------------------------------
    @property
    def max_batch(self) -> int:
        return self.spec.max_batch

    def _write_lane(self, lane: int, tree) -> None:
        def put(full, one):
            full[:, lane].copy_(one)
        _zip_apply(self._adapters["segments"], tree["segments"], put)
        if "shared_attn" in self._adapters:
            _zip_apply(self._adapters["shared_attn"], tree["shared_attn"],
                       lambda full, one: full[lane].copy_(one))

    def assign(self, lane: int, paged: PagedAdapter, *,
               reset: bool = True) -> None:
        """Hot-swap ``paged`` into ``lane``: an in-place copy into that
        lane's slot; no shape changes, nothing is rebuilt."""
        if paged.slot_rank != self.slot_rank:
            raise ValueError(
                f"adapter paged for slot width {paged.slot_rank}, engine "
                f"slot width is {self.slot_rank}")
        self._write_lane(lane, paged.adapters)
        self._scales[lane] = paged.scale
        self.assigned[lane] = paged
        self.swaps += 1
        if lane in self._admit_order:
            self._admit_order.remove(lane)
        self._admit_order.append(lane)
        if reset:
            self.reset_lane(lane)

    def evict(self, lane: int, *, reset: bool = True) -> None:
        """Return ``lane`` to base-model decode (zero adapter and scale)."""
        self._write_lane(lane, self._zero_adapter)
        self._scales[lane] = 0.0
        self.assigned[lane] = None
        if lane in self._admit_order:
            self._admit_order.remove(lane)
        if reset:
            self.reset_lane(lane)

    def admit(self, paged: PagedAdapter, *,
              lane: Optional[int] = None) -> int:
        """Admit a tenant mid-stream: a free lane first; when full,
        ``spec.admission="evict_oldest"`` retires the longest-admitted
        tenant and ``"strict"`` raises. Returns the lane."""
        if lane is None:
            free = [i for i in range(self.max_batch)
                    if self.assigned[i] is None]
            if free:
                lane = free[0]
            elif self.spec.admission == "evict_oldest":
                lane = self.retire(self._admit_order[0])
            else:
                raise RuntimeError(
                    f"no free lane for tenant {paged.key} (all "
                    f"{self.max_batch} lanes occupied; ServeSpec."
                    "admission='strict' refuses to evict)")
        self.assign(lane, paged, reset=True)
        self.admits += 1
        return lane

    def retire(self, lane: int) -> int:
        """Retire ``lane``'s tenant: back to base-model decode with a
        reset stream. Returns the freed lane."""
        self.evict(lane, reset=True)
        self.retires += 1
        return lane

    def reset_lane(self, lane: int) -> None:
        """Fresh cache (every leaf back to its init value: empty KV
        slots, zero recurrent state) and position 0 for ``lane``. Paged,
        the lane's blocks go back to the free list with their pool
        positions stamped -1, and only the recurrent carry is reset."""
        if self.paged:
            freed = self.allocator.free_lane(lane)
            for pool in self._pools:
                kvb.release_blocks(pool, freed)

        def put(full, one):
            full[:, lane].copy_(one[:, 0])
        _zip_apply(self._caches, self._cache0, put)
        self._positions[lane] = 0

    def lane_cache(self, lane: int) -> Dict[str, Any]:
        """The lane's dense-equivalent cache tree, leaves ``(L, 1, Sc,
        ...)`` (a copy; paged, its blocks gathered through its table).
        Test and debug surface — decode never builds it."""
        state = tree_map(lambda c: c[:, lane:lane + 1].clone(), self._caches)
        if not self.paged:
            return state
        row = torch.as_tensor(self.allocator.tables[lane],
                              device=self.device)
        return kvb.merge_lane_caches(
            self.cfg, state, [kvb.gather_lane(p, row) for p in self._pools])

    def allocator_stats(self) -> Dict[str, Any]:
        """Block-allocator counters (empty dict when dense)."""
        return self.allocator.stats() if self.paged else {}

    # -- decode ---------------------------------------------------------
    def _ensure_blocks(self) -> None:
        """Back every lane's write slot for this step with a physical
        block. Streams grow one block at a time; a wrapped ring reuses
        the lane's own blocks (already mapped). Raises
        :class:`~repro_torch.core.kv_blocks.BlockPoolExhausted` when the
        pool is out — loudly, never by taking a sibling's block."""
        Sc, bs = self.spec.cache_len, self.spec.block_size
        for lane in range(self.max_batch):
            self.allocator.ensure(lane,
                                  (int(self._positions[lane]) % Sc) // bs)

    @torch.no_grad()
    def step(self, tokens: Sequence[int]) -> torch.Tensor:
        """Decode one token on every lane. tokens: (max_batch,) ints.
        Returns per-lane next-token logits, shape (max_batch, vocab)."""
        B = self.max_batch
        toks = torch.as_tensor(np.asarray(tokens, np.int64).reshape(B, 1),
                               device=self.device)
        # a copy on the device before the host counter moves on (the
        # reference's step reads a host array it then increments)
        pos = torch.as_tensor(self._positions, device=self.device)
        scale = (self._scales, self._mask)
        window = self.spec.sliding_window
        if self.paged:
            self._ensure_blocks()
            self._tables.copy_(torch.from_numpy(self.allocator.tables))
            logits, _, _ = T.decode_step_paged(
                self.params, self._adapters, self.cfg, self._slot_lora,
                toks, self._caches, self._pools, self._tables, pos,
                sliding_window=window, scale=scale)
        else:
            logits, _ = T.decode_step(
                self.params, self._adapters, self.cfg, self._slot_lora,
                toks, self._caches, pos, sliding_window=window, scale=scale)
        self._positions += 1
        return logits[:, 0]

    def generate(self, prompts: np.ndarray, num_tokens: int) -> np.ndarray:
        """Greedy-decode ``num_tokens`` per lane after teacher-forcing the
        prompts. prompts: (max_batch, P) ints. Returns (max_batch,
        num_tokens) generated ids."""
        prompts = np.asarray(prompts)
        if prompts.shape[0] != self.max_batch:
            raise ValueError(f"prompts for {prompts.shape[0]} lanes, engine "
                             f"has {self.max_batch}")
        tok = prompts[:, 0]
        out = []
        for i in range(prompts.shape[1] + num_tokens - 1):
            logits = self.step(tok)
            if i + 1 < prompts.shape[1]:
                tok = prompts[:, i + 1]
            else:
                tok = torch.argmax(logits, dim=-1).cpu().numpy()
                out.append(tok)
        return np.stack(out, axis=1)


# ---------------------------------------------------------------------------
# Demo CLI: batched request serving with the reduced config
# ---------------------------------------------------------------------------

def main():
    import argparse
    import importlib
    import time

    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", default="qwen2-0.5b")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--prompt-len", type=int, default=16)
    parser.add_argument("--tokens", type=int, default=32)
    parser.add_argument("--block-size", type=int, default=0,
                        help="paged KV block size (0: dense caches)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    mod = importlib.import_module(
        "repro_torch.configs." + args.arch.replace("-", "_").replace(".", "_"))
    cfg = mod.reduced()
    lora = LoRAConfig(rank=4)
    params = T.init_params(cfg, seed=0, dtype=torch.float32,
                           device=args.device)

    B = args.batch
    clen = args.prompt_len + args.tokens
    if args.block_size:        # the lane ring is a whole number of blocks
        clen = -(-clen // args.block_size) * args.block_size
    eng = ServeEngine(params, cfg, lora,
                      ServeSpec(max_batch=B, cache_len=clen,
                                block_size=args.block_size),
                      device=args.device)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (B, args.prompt_len))

    # prompt through the decode step, then greedy generation, every lane
    # on the base model
    t0 = time.perf_counter()
    gen = eng.generate(prompt, args.tokens)
    dt = time.perf_counter() - t0
    print(f"served {B} requests x {gen.shape[1]} tokens in {dt:.2f}s "
          f"({B * gen.shape[1] / dt:.1f} tok/s on {args.device})")
    if eng.paged:
        print("blocks:", eng.allocator_stats())
    print("sample:", gen[0][:16])


if __name__ == "__main__":
    main()
