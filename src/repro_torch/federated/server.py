"""RSU-side server, port of ``repro/federated/server.py``: per-method
global adapter state, distribution and aggregation (list and grouped
paths) on the trivial RSU tier with sync participation.

Ours (paper §III-B): the server state is the merged global delta tree
Δθ per LoRA target; distribution ships truncated-SVD factors at each
vehicle's chosen rank; aggregation is the data-weighted sum of the
clients' scale·A·B products, or with ``residual=True`` (``ours_residual``)
the retained Δθ plus the clients' increments over what they were sent.
HomoLoRA, HetLoRA and FedRA keep a global adapter tree and apply the
baselines' rules of §V-A. Non-trivial RSU tiers and semi-synchronous
participation raise ``NotImplementedError`` (ROADMAP Queue 1, item 6).
:meth:`RSUServer.aggregate_grouped` takes the batched engine's stacked
groups; :meth:`RSUServer.fresh_padded` stages the fused engine's
first-round adapters and :meth:`RSUServer.load_merged` adopts its merged
deltas.

Three draws come from ``jax.random`` in the reference: the fresh
adapters, FedRA's layer permutations (both from the server's one key)
and the SVD sketch Ω. All are injectable here (``draw_adapters``,
``draw_layer_mask``, ``draw_omega``), so that a test can hand the port
the reference's draws. By default fresh adapters and layer masks come
from one CPU ``torch.Generator(seed)`` and Ω from
:func:`repro_torch.core.svd.default_omega`, moved to the device
afterwards, so one seed gives the same run on the card and on the CPU.
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

MISSING = "ROADMAP Queue 1, item 6"
SERVER_METHODS = ("ours", "homolora", "hetlora", "fedra")


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
            raise NotImplementedError(
                f"multi-RSU tiers ({self.tier}) are not ported yet "
                f"({MISSING})")
        if not self.participation.trivial:
            raise NotImplementedError(
                f"semi_sync participation ({self.participation}) is not "
                f"ported yet ({MISSING})")
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
                  indices: Optional[Sequence[int]] = None) -> None:
        """Aggregate the kept clients' adapters (none kept: the state
        stays). masks: FedRA's layer masks of the kept clients, aligned
        with ``client_adapters`` (departures drop some of the distributed
        ones); indices: the kept clients' positions in the distributed
        list (residual aggregation)."""
        if masks is not None:
            self._masks = list(masks)
        if not client_adapters:
            self.round += 1
            return
        if self.method == "ours":
            new = agg.aggregate_merged(client_adapters, weights,
                                       self.lora.scale)
            if self.residual and self.merged is not None and indices:
                old = agg.aggregate_merged(
                    [self._distributed[i] for i in indices], weights,
                    self.lora.scale)
                self.merged = tree_map(lambda g, n, o: g + (n - o),
                                       self.merged, new, old)
            else:
                self.merged = new
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

    def aggregate_grouped(self, groups: Sequence[Dict[str, Any]]) -> None:
        """Batched-engine aggregation over stacked per-rank groups, equal
        to :meth:`aggregate` over the concatenated clients.

        groups: dicts with ``adapters`` (a tree stacked on the lane axis,
        (L, n_g, ...)), ``weights`` (n_g,) data sizes, ``masks`` ((n_g, L)
        FedRA layer masks, else None) and ``indices`` (the lanes'
        positions in the distributed list, for residual aggregation). A
        zero-weight lane is an exact no-op. No group keeps the state."""
        if not groups:
            self.round += 1
            return
        pairs = [(g["adapters"], g["weights"]) for g in groups]
        if self.method == "ours":
            new = agg.aggregate_merged_grouped(pairs, self.lora.scale)
            if (self.residual and self.merged is not None
                    and all(g.get("indices") is not None for g in groups)):
                old = agg.aggregate_merged_grouped(
                    [(stack_trees([self._distributed[i]
                                   for i in g["indices"]]), g["weights"])
                     for g in groups], self.lora.scale)
                self.merged = tree_map(lambda g, n, o: g + (n - o),
                                       self.merged, new, old)
            else:
                self.merged = new
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
