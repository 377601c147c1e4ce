"""RSU-side server, port of ``repro/federated/server.py``: per-method
global adapter state, distribution and aggregation (list and grouped
paths), RSU tiers and semi-synchronous participation.

Ours (paper §III-B): the server state is the merged global delta tree
Δθ per LoRA target; distribution ships truncated-SVD factors at each
vehicle's chosen rank; aggregation is the data-weighted sum of the
clients' scale·A·B products, or with ``residual=True`` (``ours_residual``)
the retained Δθ plus the clients' increments over what they were sent.
HomoLoRA, HetLoRA and FedRA keep a global adapter tree and apply the
baselines' rules of §V-A. :meth:`RSUServer.aggregate_grouped` takes the
batched engine's stacked groups; :meth:`RSUServer.fresh_padded` stages
the fused engine's first-round adapters and :meth:`RSUServer.load_merged`
adopts its merged deltas.

A non-trivial :class:`~repro_torch.config.RSUTierSpec` (``ours`` and
``hetlora``) routes each upload into the partial of the RSU it is
associated with; every ``sync_period`` rounds the partials merge, with
staleness-discounted weights, into the global state, and only then does
the task have one. ``semi_sync`` participation (``ours``) parks a missed
upload's merged delta in an in-flight buffer, which lands it up to
``max_delay`` rounds late at a discounted weight
(:meth:`RSUServer.release_buffered`, :meth:`RSUServer.admit_buffered`).
The trivial tier and ``sync`` never enter either.

Three draws come from ``jax.random`` in the reference: the fresh
adapters, FedRA's layer permutations (both from the server's one key)
and the SVD sketch Ω. All are injectable here (``draw_adapters``,
``draw_layer_mask``, ``draw_omega``), so that a test can hand the port
the reference's draws. By default fresh adapters and layer masks come
from one CPU ``torch.Generator(seed)`` and Ω from
:func:`repro_torch.core.svd.default_omega`, moved to the device
afterwards, so one seed gives the same run on the card and on the CPU.
A checkpoint stores that generator's state where the reference stores
its key (:meth:`RSUServer.key_state`, :meth:`RSUServer.load_key`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import (LoRAConfig, ModelConfig, ParticipationSpec,
                                RSUTierSpec)
from repro_torch.core import aggregation as agg
from repro_torch.federated.batched_client import stack_trees
from repro_torch.interop import tree_map
from repro_torch.models import transformer as T
from repro_torch.models.runmode import resolve_device

SERVER_METHODS = ("ours", "homolora", "hetlora", "fedra")
TIER_METHODS = ("ours", "hetlora")


class RSUServer:
    def __init__(self, cfg: ModelConfig, lora: LoRAConfig, method: str,
                 seed: int = 0, residual: bool = False,
                 tier: Optional[RSUTierSpec] = None,
                 participation: Optional[ParticipationSpec] = None,
                 device="cuda",
                 draw_adapters: Optional[Callable[[], Any]] = None,
                 draw_omega: Optional[agg.OmegaFn] = None,
                 draw_layer_mask: Optional[Callable[[], Any]] = None):
        """method: the aggregation rule, one of SERVER_METHODS. residual:
        accumulate the clients' increments (B̂Â − B⁰A⁰) onto the retained
        Δθ instead of replacing it (read by ``ours`` only).

        draw_adapters: called once per fresh adapter, returns a tree at
        ``lora.max_rank`` (tensors on any device); it replaces the
        server's own generator stream. draw_layer_mask: called once per
        FedRA vehicle and round, returns its (L,) layer mask; it replaces
        :func:`~repro_torch.core.aggregation.fedra_layer_mask` on the
        server's stream. draw_omega: ``(seed, d2, r) -> (d2, r)`` sketch
        for every SVD (see :func:`repro_torch.core.aggregation.
        redistribute`)."""
        if method not in SERVER_METHODS:
            raise ValueError(f"unknown server method {method!r}; have "
                             f"{SERVER_METHODS}")
        self.tier = tier or RSUTierSpec()
        self.participation = participation or ParticipationSpec()
        if not self.tier.trivial:
            if method not in TIER_METHODS:
                raise ValueError(
                    f"multi-RSU tiers support methods {TIER_METHODS}; "
                    f"got {method!r} with {self.tier}")
            if residual:
                raise ValueError(
                    "residual aggregation is incompatible with multi-RSU "
                    "tiers (increments would double-count across partials)")
        if not self.participation.trivial:
            if method != "ours":
                raise ValueError(
                    "semi_sync participation buffers MERGED DELTAS, which "
                    "only the 'ours' aggregation consumes; got "
                    f"{method!r} with {self.participation}")
            if residual:
                raise ValueError(
                    "residual aggregation is incompatible with semi_sync "
                    "participation (a late increment would be applied "
                    "against the wrong base)")
        self.cfg = cfg
        self.lora = lora
        self.method = method
        self.residual = bool(residual)
        self.device = resolve_device(device)
        self._gen = torch.Generator().manual_seed(seed)
        self.draw_adapters = draw_adapters
        self.draw_omega = draw_omega
        self.draw_layer_mask = draw_layer_mask
        self.round = 0
        self.merged = None            # ours: tree of {"delta"}
        self.global_adapters = None   # baselines: adapter tree
        # the tier's state: per-RSU partials (trees of the global state's
        # kind, None before a segment's first upload), the data weight of
        # each one's last refresh and the rounds since
        K = self.tier.num_rsus_per_task
        self.partials: Optional[List[Any]] = None
        self.partial_w = np.zeros(K, np.float64)
        self.partial_age = np.zeros(K, np.int64)
        # semi_sync's in-flight uploads: vehicle → {"delta" (merged-delta
        # tree), "w" (data weight), "age" (rounds waited), "dest" (RSU)}
        self.buffer: Dict[int, Dict[str, Any]] = {}
        self.fedra_fraction = 0.6
        self._masks: List[torch.Tensor] = []
        self._distributed: List[Any] = []

    # ------------------------------------------------------------------
    def _fresh(self, rank: int):
        """Fresh adapter tree at ``rank``: drawn at max_rank, then
        truncated, so the values do not depend on the rank (the first η
        columns of the max_rank draw)."""
        if self.draw_adapters is not None:
            full = self.draw_adapters()
        else:
            full = T.init_adapters(self.cfg, self.lora,
                                   rank=self.lora.max_rank,
                                   generator=self._gen)
        full = tree_map(lambda t: torch.as_tensor(t, dtype=torch.float32)
                        .to(self.device), full)
        if rank == self.lora.max_rank:
            return full
        return agg.hetlora_truncate(full, rank)

    def _layer_mask(self) -> torch.Tensor:
        """One FedRA vehicle's (L,) layer mask, f32 on the CPU."""
        if self.draw_layer_mask is not None:
            return torch.tensor(np.asarray(self.draw_layer_mask(),
                                           np.float32))
        return agg.fedra_layer_mask(self.cfg.num_layers,
                                    self.fedra_fraction,
                                    generator=self._gen)

    def fresh_padded(self, n: int):
        """Draw ``n`` max_rank adapter trees from the fresh-adapter
        stream exactly as ``n`` :meth:`_fresh` calls would (the injected
        ``draw_adapters`` too), stacked on the lane axis (L, n, ...), on
        the server's device. The fused engine scatters them into its
        fleet and rank-masks them in its round program."""
        return stack_trees([self._fresh(self.lora.max_rank)
                            for _ in range(n)])

    # ------------------------------------------------------------------
    # The stream cursor (the checkpoint's ``servers/<t>/key`` leaf)
    # ------------------------------------------------------------------
    def key_state(self) -> np.ndarray:
        """The server's fresh-draw stream as a checkpoint leaf: the CPU
        generator's state bytes (uint8), where the reference stores its
        ``jax.random`` key."""
        return self._gen.get_state().numpy().copy()

    def load_key(self, key) -> None:
        """Resume the fresh-draw stream from :meth:`key_state`'s bytes. A
        reference-written key (two uint32 words of a ``jax.random`` key)
        cannot continue JAX's stream here: the generator is re-seeded
        deterministically from its two words, and the port's fresh draws
        from there are its own (as in any run without injected draws;
        ``draw_adapters`` / ``draw_layer_mask`` hand it the reference's)."""
        key = np.asarray(key)
        if key.dtype == np.uint32 and key.shape == (2,):
            self._gen = torch.Generator().manual_seed(
                (int(key[0]) << 32) | int(key[1]))
        else:
            self._gen.set_state(torch.from_numpy(
                np.ascontiguousarray(key, np.uint8)))

    def load_merged(self, merged, round_: int) -> None:
        """Adopt server state computed off-host (the fused engine's
        carry), so that eval_adapters and distribute stay coherent."""
        self.merged = merged
        self.round = int(round_)

    def distribute(self, ranks: Sequence[int]) -> List[Any]:
        """One adapter tree per participating vehicle."""
        if self.method == "ours":
            if self.merged is None:
                out = [self._fresh(r) for r in ranks]
            else:
                uniq = {}
                for r in sorted(set(ranks)):
                    uniq[r] = agg.redistribute(self.merged, rank=r,
                                               scale=self.lora.scale,
                                               max_rank=self.lora.max_rank,
                                               seed=self.round,
                                               draw_omega=self.draw_omega)
                out = [uniq[r] for r in ranks]
            self._distributed = out
            return out
        if self.method == "homolora":
            if self.global_adapters is None:
                self.global_adapters = self._fresh(self.lora.rank)
            return [self.global_adapters for _ in ranks]
        if self.method == "hetlora":
            if self.global_adapters is None:
                self.global_adapters = self._fresh(self.lora.max_rank)
            uniq = {r: agg.hetlora_truncate(self.global_adapters, r)
                    for r in sorted(set(ranks))}
            return [uniq[r] for r in ranks]
        # fedra: one shared tree, one fresh layer mask per vehicle
        if self.global_adapters is None:
            self.global_adapters = self._fresh(self.lora.rank)
        self._masks = [self._layer_mask() for _ in ranks]
        return [self.global_adapters for _ in ranks]

    @property
    def masks(self) -> List[torch.Tensor]:
        """FedRA: the (L,) layer masks of the last distribution (or, after
        an aggregation, of the clients it kept)."""
        return self._masks

    # ------------------------------------------------------------------
    def aggregate(self, client_adapters: Sequence[Any],
                  weights: Sequence[float],
                  masks: Optional[Sequence] = None,
                  indices: Optional[Sequence[int]] = None,
                  assoc: Optional[Sequence[int]] = None,
                  released: Optional[Sequence] = None) -> None:
        """Aggregate the kept clients' adapters (none kept and nothing
        released: the state stays). masks: FedRA's layer masks of the kept
        clients, aligned with ``client_adapters`` (departures drop some of
        the distributed ones); indices: the kept clients' positions in the
        distributed list (residual aggregation); assoc: each kept client's
        RSU within the task's tier (a non-trivial tier needs it);
        released: the late uploads landing this round, (delta, weight,
        dest) triples from :meth:`release_buffered`."""
        if masks is not None:
            self._masks = list(masks)
        if not self.tier.trivial:
            self._tier_aggregate_list(client_adapters, weights, assoc,
                                      released)
            return
        if not client_adapters and not released:
            self.round += 1
            return
        if self.method == "ours":
            new = (agg.aggregate_merged(client_adapters, weights,
                                        self.lora.scale)
                   if client_adapters else None)
            if self.residual and self.merged is not None and indices:
                old = agg.aggregate_merged(
                    [self._distributed[i] for i in indices], weights,
                    self.lora.scale)
                self.merged = tree_map(lambda g, n, o: g + (n - o),
                                       self.merged, new, old)
            else:
                self.merged = self._fold_released(
                    new, float(np.sum(np.asarray(weights, np.float64))),
                    released)
        elif self.method == "homolora":
            w = np.asarray(weights, np.float64)
            w = w / w.sum()
            self.global_adapters = tree_map(
                lambda *xs: sum(float(wi) * x for wi, x in zip(w, xs)),
                *client_adapters)
        elif self.method == "hetlora":
            self.global_adapters = agg.aggregate_hetlora(
                client_adapters, weights, self.lora.max_rank)
        else:
            self.global_adapters = agg.aggregate_fedra(
                client_adapters, weights, self._masks)
        self.round += 1

    def _fold_released(self, new, live_w: float, released) -> Any:
        """``ours`` on the trivial tier: the live merge ``new`` (None when
        no upload was kept) with this round's releases folded in."""
        if not released:
            return new
        raw, tot = self._released_raw(released)
        if new is None:
            return tree_map(lambda r: r / max(tot, 1e-12), raw)
        return agg.combine_with_released(new, live_w, raw, tot)

    def aggregate_grouped(self, groups: Sequence[Dict[str, Any]],
                          released: Optional[Sequence] = None) -> None:
        """Batched-engine aggregation over stacked per-rank groups, equal
        to :meth:`aggregate` over the concatenated clients.

        groups: dicts with ``adapters`` (a tree stacked on the lane axis,
        (L, n_g, ...)), ``weights`` (n_g,) data sizes, ``masks`` ((n_g, L)
        FedRA layer masks, else None), ``indices`` (the lanes' positions
        in the distributed list, for residual aggregation) and ``assoc``
        ((n_g,) RSU per lane, for a non-trivial tier). A zero-weight lane
        is an exact no-op. released: as in :meth:`aggregate`. No group
        and nothing released keeps the state."""
        if not self.tier.trivial:
            self._tier_aggregate_grouped(groups, released)
            return
        if not groups and not released:
            self.round += 1
            return
        pairs = [(g["adapters"], g["weights"]) for g in groups]
        if self.method == "ours":
            new = (agg.aggregate_merged_grouped(pairs, self.lora.scale)
                   if pairs else None)
            if (self.residual and self.merged is not None and pairs
                    and all(g.get("indices") is not None for g in groups)):
                old = agg.aggregate_merged_grouped(
                    [(stack_trees([self._distributed[i]
                                   for i in g["indices"]]), g["weights"])
                     for g in groups], self.lora.scale)
                self.merged = tree_map(lambda g, n, o: g + (n - o),
                                       self.merged, new, old)
            else:
                self.merged = self._fold_released(
                    new, float(sum(np.sum(np.asarray(w, np.float64))
                                   for _, w in pairs)), released)
        elif self.method == "homolora":
            self.global_adapters = agg.average_stacked_grouped(pairs)
        elif self.method == "hetlora":
            self.global_adapters = agg.aggregate_hetlora_grouped(
                pairs, self.lora.max_rank)
        else:
            # FedRA trains one rank: its groups concatenate on the lanes
            stacked = (pairs[0][0] if len(pairs) == 1 else tree_map(
                lambda *xs: torch.cat(xs, dim=-3), *[p[0] for p in pairs]))
            weights = np.concatenate([np.asarray(w, np.float32)
                                      for _, w in pairs])
            masks = np.concatenate([np.asarray(g["masks"], np.float32)
                                    for g in groups])
            self._masks = [torch.from_numpy(m) for m in masks]
            self.global_adapters = agg.aggregate_fedra_stacked(
                stacked, weights, masks)
        self.round += 1

    # ------------------------------------------------------------------
    # The multi-RSU tier: per-RSU partials and the periodic
    # staleness-weighted sync (a non-trivial RSUTierSpec only)
    # ------------------------------------------------------------------
    def _tier_aggregate_list(self, client_adapters, weights, assoc,
                             released=None) -> None:
        """The serial engine's path: each RSU's clients into its
        partial."""
        if client_adapters and assoc is None:
            raise ValueError("non-trivial tier aggregation needs assoc")
        refreshed = {}
        for k in range(self.tier.num_rsus_per_task):
            sel = [i for i, a in enumerate([] if assoc is None else assoc)
                   if int(a) == k]
            if not sel:
                continue
            subset = [client_adapters[i] for i in sel]
            w = [float(weights[i]) for i in sel]
            if self.method == "ours":
                part = agg.aggregate_merged(subset, w, self.lora.scale)
            else:   # hetlora: a factor partial zero-padded to max_rank
                part = agg.aggregate_hetlora(subset, w, self.lora.max_rank)
            refreshed[k] = (part, sum(w))
        self._tier_fold_released(refreshed, released)
        self._tier_commit(refreshed)

    def _tier_fold_released(self, refreshed, released) -> None:
        """Fold late uploads into their destination RSUs' refreshes: a
        segment with live uploads combines at raw weights, one without is
        refreshed by the releases alone."""
        if not released:
            return
        by_dest: Dict[int, List] = {}
        for entry in released:
            if int(entry[2]) >= 0:
                by_dest.setdefault(int(entry[2]), []).append(entry)
        for k, entries in by_dest.items():
            raw, tot = self._released_raw(entries)
            if k in refreshed:
                norm, live_w = refreshed[k]
                refreshed[k] = (agg.combine_with_released(norm, live_w,
                                                          raw, tot),
                                live_w + tot)
            else:
                refreshed[k] = (tree_map(lambda r: r / max(tot, 1e-12),
                                         raw), tot)

    def _tier_aggregate_grouped(self, groups, released=None) -> None:
        """The batched engine's path: segment sums of every rank group,
        combined across groups at their raw segment weights."""
        K = self.tier.num_rsus_per_task
        acc, tot = None, torch.zeros(K, dtype=torch.float32)
        for g in groups:
            if g.get("assoc") is None:
                raise ValueError("non-trivial tier aggregation needs assoc "
                                 "on every group")
            if self.method == "ours":
                part, seg_w = agg.aggregate_merged_padded_segmented(
                    g["adapters"], g["weights"], g["assoc"], K,
                    self.lora.scale)
            else:
                part, seg_w = agg.aggregate_hetlora_segmented(
                    g["adapters"], g["weights"], g["assoc"], K,
                    self.lora.max_rank)
            raw = tree_map(lambda x: x * agg._seg_w(seg_w, x), part)
            acc = raw if acc is None else tree_map(torch.add, acc, raw)
            tot = tot + seg_w
        refreshed = {}
        if acc is not None:
            den = torch.clamp(tot, min=1e-12)
            norm = tree_map(lambda x: x / agg._seg_w(den, x), acc)
            for k in range(K):
                if float(tot[k]) > 0.0:
                    refreshed[k] = (tree_map(lambda x: x.select(-3, k),
                                             norm), float(tot[k]))
        self._tier_fold_released(refreshed, released)
        self._tier_commit(refreshed)

    def _tier_commit(self, refreshed) -> None:
        """Take this round's refreshes into the partials, then merge them
        into the global state every ``sync_period`` rounds."""
        K = self.tier.num_rsus_per_task
        if self.partials is None:
            self.partials = [None] * K
        for k in range(K):
            if k in refreshed:
                self.partials[k], self.partial_w[k] = refreshed[k]
                self.partial_age[k] = 0
            elif self.partial_w[k] > 0:
                self.partial_age[k] += 1
        if (self.round + 1) % self.tier.sync_period == 0:
            live = [k for k in range(K) if self.partial_w[k] > 0]
            if live:
                merged, alive = agg.merge_partials(
                    agg.stack_partials([self.partials[k] for k in live]),
                    self.partial_w[live], self.partial_age[live],
                    self.tier.staleness_decay)
                # every live discount underflowed to 0.0: keep the
                # previous global instead of merging to zeros
                if bool(alive):
                    if self.method == "ours":
                        self.merged = merged
                    else:
                        self.global_adapters = merged
            # a new window: only new uploads count toward the next sync
            self.partial_w[:] = 0.0
            self.partial_age[:] = 0
        self.round += 1

    def load_partials(self, partials: Sequence[Any], weights, ages) -> None:
        """Adopt per-RSU partial state computed off-host (the fused
        engine's carry)."""
        self.partials = list(partials)
        self.partial_w = np.asarray(weights, np.float64).copy()
        self.partial_age = np.asarray(ages, np.int64).copy()

    # ------------------------------------------------------------------
    # Semi-synchronous participation: the in-flight upload buffer
    # (semi_sync only). A round ages, releases, drops, then admits, in
    # the fused program's order.
    # ------------------------------------------------------------------
    def release_buffered(self, active, assoc=None) -> List:
        """Age every buffered upload one round and return those landing
        now, as (delta, weight, dest): the vehicle is back in coverage
        (``active``) within ``max_delay``, at weight ``w·decay**age``;
        ``dest`` is its current RSU (``assoc``) with ``buffer_handoffs``,
        else the RSU it trained under. An overdue entry is dropped."""
        part = self.participation
        if part.trivial or not self.buffer:
            return []
        released = []
        for lane in sorted(self.buffer):     # deterministic lane order
            ent = self.buffer[lane]
            age1 = ent["age"] + 1
            within = age1 <= part.max_delay
            if bool(active[lane]) and within:
                relw = ent["w"] * float(agg.staleness_weights(
                    age1, part.vehicle_staleness_decay))
                dest = ent["dest"]
                if part.buffer_handoffs and assoc is not None:
                    dest = int(assoc[lane])
                released.append((ent["delta"], relw, dest))
                del self.buffer[lane]
            elif within:
                ent["age"] = age1
            else:                              # overdue: drop
                del self.buffer[lane]
        return released

    def admit_buffered(self, entries) -> None:
        """Park this round's missed uploads: (vehicle, delta, weight,
        dest) enter at age 0; a vehicle's new entry replaces its old
        one (it trained again)."""
        if self.participation.trivial:
            return
        for lane, delta, w, dest in entries:
            self.buffer[int(lane)] = {"delta": delta, "w": float(w),
                                      "age": 0, "dest": int(dest)}

    def load_buffer(self, deltas, weights, ages, dests) -> None:
        """Adopt the in-flight buffer computed off-host (the fused
        engine's carry): ``deltas`` has the vehicles on the lane axis,
        weights, ages and dests are (V,); weight 0 marks an empty lane.
        Each entry is a copy."""
        w = np.asarray(weights, np.float64)
        age = np.asarray(ages, np.int64)
        dest = np.asarray(dests, np.int64)
        self.buffer = {}
        for v in np.flatnonzero(w > 0.0):
            self.buffer[int(v)] = {
                "delta": tree_map(lambda x: x.select(-3, int(v)).clone(),
                                  deltas),
                "w": float(w[v]), "age": int(age[v]), "dest": int(dest[v])}

    @staticmethod
    def _released_raw(released):
        """Σ relw·δ over released entries and the total weight, the raw
        sums :func:`~repro_torch.core.aggregation.combine_with_released`
        takes."""
        raw, tot = None, 0.0
        for delta, w, _ in released:
            term = tree_map(lambda x: float(np.float32(w)) * x.float(),
                            delta)
            raw = term if raw is None else tree_map(torch.add, raw, term)
            tot += float(w)
        return raw, tot

    # ------------------------------------------------------------------
    def eval_adapters(self) -> Optional[Any]:
        """Global adapter view for server-side evaluation: for ``ours``
        the merged deltas at max_rank (Ω of seed 0, as the reference's),
        for the baselines their global adapters as they stand."""
        if self.method == "ours":
            if self.merged is None:
                return None
            return agg.redistribute(self.merged, rank=self.lora.max_rank,
                                    scale=self.lora.scale,
                                    max_rank=self.lora.max_rank,
                                    draw_omega=self.draw_omega)
        return self.global_adapters

    def comm_params_per_round(self, ranks: Sequence[int]) -> int:
        """Uplink parameter volume (Table I "Comm." column)."""
        from repro_torch.core.cost_model import (adapter_payload_params,
                                                 target_dims_of)
        dims = target_dims_of(self.cfg, self.lora)
        if self.method == "fedra":
            return int(sum(adapter_payload_params(dims, self.lora.rank)
                           * self.fedra_fraction for _ in ranks))
        if self.method == "homolora":
            return sum(adapter_payload_params(dims, self.lora.rank)
                       for _ in ranks)
        return sum(adapter_payload_params(dims, r) for r in ranks)
