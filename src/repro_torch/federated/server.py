"""RSU-side server for the paper's method, port of
``repro/federated/server.py`` (``method="ours"``, list and grouped paths).

The server state is the merged global delta tree Δθ per LoRA target;
distribution ships truncated-SVD factors at each vehicle's chosen rank;
aggregation is the data-weighted sum of the clients' scale·A·B products
(paper §III-B). HomoLoRA, HetLoRA and FedRA, non-trivial RSU tiers and
semi-synchronous participation raise ``NotImplementedError``; residual
aggregation has no parameter here yet. ROADMAP Queue 1, item 6 lists
them. :meth:`RSUServer.aggregate_grouped` takes the batched engine's
stacked groups; :meth:`RSUServer.fresh_padded` stages the fused
engine's first-round adapters and :meth:`RSUServer.load_merged` adopts
its merged deltas.

Two draws come from ``jax.random`` in the reference: the fresh adapters
of the first round and the SVD sketch Ω. Both are injectable here
(``draw_adapters``, ``draw_omega``), so that a test can hand the port the
reference's draws. By default fresh adapters come from a CPU
``torch.Generator(seed)`` and Ω from :func:`repro_torch.core.svd.
default_omega`, both moved to the device afterwards, so one seed gives
the same run on the card and on the CPU.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.config import (LoRAConfig, ModelConfig, ParticipationSpec,
                                RSUTierSpec)
from repro_torch.core import aggregation as agg
from repro_torch.interop import tree_map
from repro_torch.models import transformer as T
from repro_torch.models.runmode import resolve_device

MISSING = "ROADMAP Queue 1, item 6"


class RSUServer:
    def __init__(self, cfg: ModelConfig, lora: LoRAConfig, method: str,
                 seed: int = 0,
                 tier: Optional[RSUTierSpec] = None,
                 participation: Optional[ParticipationSpec] = None,
                 device="cuda",
                 draw_adapters: Optional[Callable[[], Any]] = None,
                 draw_omega: Optional[agg.OmegaFn] = None):
        """draw_adapters: called once per fresh adapter, returns a tree at
        ``lora.max_rank`` (tensors on any device); it replaces the
        server's own generator stream. draw_omega: ``(seed, d2, r) ->
        (d2, r)`` sketch for every SVD (see
        :func:`repro_torch.core.aggregation.redistribute`)."""
        if method != "ours":
            raise NotImplementedError(
                f"the port's RSUServer runs method 'ours' only, not "
                f"{method!r} ({MISSING})")
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
        self.device = resolve_device(device)
        self._gen = torch.Generator().manual_seed(seed)
        self.draw_adapters = draw_adapters
        self.draw_omega = draw_omega
        self.round = 0
        self.merged = None            # tree of {"delta"}

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

    def fresh_padded(self, n: int):
        """Draw ``n`` max_rank adapter trees from the fresh-adapter
        stream exactly as ``n`` :meth:`_fresh` calls would (the injected
        ``draw_adapters`` too), stacked on the lane axis (L, n, ...), on
        the server's device. The fused engine scatters them into its
        fleet and rank-masks them in its round program."""
        from repro_torch.federated.batched_client import stack_trees
        return stack_trees([self._fresh(self.lora.max_rank)
                            for _ in range(n)])

    def load_merged(self, merged, round_: int) -> None:
        """Adopt server state computed off-host (the fused engine's
        carry), so that eval_adapters and distribute stay coherent."""
        self.merged = merged
        self.round = int(round_)

    def distribute(self, ranks: Sequence[int]) -> List[Any]:
        """One adapter tree per participating vehicle."""
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
        return out

    # ------------------------------------------------------------------
    def aggregate(self, client_adapters: Sequence[Any],
                  weights: Sequence[float]) -> None:
        """Replace the global state with the weighted merged deltas of the
        kept clients (none kept: the state stays)."""
        if client_adapters:
            self.merged = agg.aggregate_merged(client_adapters, weights,
                                               self.lora.scale)
        self.round += 1

    def aggregate_grouped(self, groups: Sequence[Dict[str, Any]]) -> None:
        """Batched-engine aggregation over stacked per-rank groups, equal
        to :meth:`aggregate` over the concatenated clients.

        groups: dicts with ``adapters`` (a tree stacked on the lane axis,
        (L, n_g, ...)) and ``weights`` (n_g,) data sizes; other keys
        (``indices``, ``masks``, ``assoc``) are not read by ``ours`` on
        the trivial tier. No group keeps the state."""
        pairs = [(g["adapters"], g["weights"]) for g in groups]
        if pairs:
            self.merged = agg.aggregate_merged_grouped(pairs,
                                                       self.lora.scale)
        self.round += 1

    # ------------------------------------------------------------------
    def eval_adapters(self) -> Optional[Any]:
        """Global adapter view for server-side evaluation: the merged
        deltas at max_rank (Ω of seed 0, as the reference's)."""
        if self.merged is None:
            return None
        return agg.redistribute(self.merged, rank=self.lora.max_rank,
                                scale=self.lora.scale,
                                max_rank=self.lora.max_rank,
                                draw_omega=self.draw_omega)

    def comm_params_per_round(self, ranks: Sequence[int]) -> int:
        """Uplink parameter volume (Table I "Comm." column)."""
        from repro_torch.core.cost_model import (adapter_payload_params,
                                                 target_dims_of)
        dims = target_dims_of(self.cfg, self.lora)
        return sum(adapter_payload_params(dims, r) for r in ranks)
