"""Adapter paging for the multi-tenant serving tier, port of
``repro/launch/adapter_cache.py``.

The fleet trains per-task LoRA state on the RSU hierarchy; serving needs a
deployable adapter per (task, RSU) at some rank r of the candidate set.
This module is the bridge:

:class:`AdapterStore`
    Reads the trained server state — a live
    :class:`~repro_torch.sim.simulator.IoVSimulator` (``from_sim``) or a
    checkpoint (``from_checkpoint``, the reference's file format) — and
    materializes adapters on demand. For the paper's method the store
    runs the SAME truncated-SVD redistribution a vehicle would receive
    (``aggregation.redistribute`` with ``seed = version``, the server
    round), ONCE at max_rank per ``(task, rsu, version)``, and caches it:
    SVD truncation nests, so the rank-r factors are the first r columns of
    the max_rank ones — one SVD serves every rank.

:class:`AdapterCache`
    The bounded host-side cache behind the store, keyed
    ``(task, rsu, version)`` on :class:`~repro_torch.core.cache.LRUCache`.
    The version is part of the key, so a stale hit is impossible.

:class:`PagedAdapter`
    What the store hands the serve engine: the rank-r tree zero-padded
    into a ``slot_rank``-wide slot (pad tails are exact no-ops under
    x·A·B) plus the LoRA scale it decodes with.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import LoRAConfig, ModelConfig, ServeSpec
from repro_torch.core import aggregation as agg
from repro_torch.core import lora as lora_lib
from repro_torch.core.cache import LRUCache
from repro_torch.interop import tree_map
from repro_torch.models.runmode import resolve_device

# rsu index meaning "the task's global (synced) state, not a partial"
GLOBAL_RSU = -1


@dataclasses.dataclass(frozen=True)
class PagedAdapter:
    """A rank-r adapter paged into a slot_rank-wide slot (zero tail) plus
    the LoRA scale it decodes with."""
    task: int
    rsu: int
    version: int
    rank: int
    slot_rank: int
    scale: float
    adapters: Any          # padded tree: every 'a' leaf (..., slot_rank)

    @property
    def key(self) -> Tuple[int, int, int]:
        return (self.task, self.rsu, self.version)


class AdapterCache:
    """``(task, rsu, version)``-keyed cache of max_rank adapter trees (the
    expensive artifact: one SVD per key for the paper's method), from
    which any rank pages for free."""

    def __init__(self, capacity: int):
        self._lru = LRUCache(capacity)

    def __len__(self) -> int:
        return len(self._lru)

    @property
    def hits(self) -> int:
        return self._lru.hits

    @property
    def misses(self) -> int:
        return self._lru.misses

    def get_or_load(self, task: int, rsu: int, version: int, loader):
        return self._lru.get_or_load((task, rsu, version), loader)


def _resolve_model_cfg(sim_cfg) -> ModelConfig:
    if sim_cfg.train_arch is not None:
        return sim_cfg.train_arch
    from repro_torch.configs import vit_base_paper
    return vit_base_paper.reduced()


class AdapterStore:
    """Trained federated state → servable, rank-paged adapters.

    ``servers`` is a list (one per task) of dicts with the RSUServer
    fields the store reads: ``round``, ``merged``, ``global_adapters``,
    ``partials``, ``partial_w`` (tensor trees on one device), the fields
    a checkpoint stores, so a live simulator and a checkpoint feed the
    same code. ``draw_omega`` is the SVD sketch, passed on to
    :func:`~repro_torch.core.aggregation.redistribute` as
    :class:`~repro_torch.federated.server.RSUServer` passes its own
    (None: the port's seeded draw).
    """

    def __init__(self, model_cfg: ModelConfig, lora: LoRAConfig,
                 method: str, servers: List[dict],
                 spec: Optional[ServeSpec] = None, *,
                 draw_omega: Optional[agg.OmegaFn] = None):
        self.model_cfg = model_cfg
        self.lora = lora
        self.method = method
        self.servers = servers
        self.spec = spec or ServeSpec()
        self.slot_rank = self.spec.resolve_max_rank(lora)
        self.cache = AdapterCache(self.spec.cache_capacity)
        self.draw_omega = draw_omega

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_sim(cls, sim, spec: Optional[ServeSpec] = None, *,
                 draw_omega: Optional[agg.OmegaFn] = None
                 ) -> "AdapterStore":
        from repro_torch.federated.baselines import server_method
        servers = [{
            "round": srv.round,
            "merged": srv.merged,
            "global_adapters": srv.global_adapters,
            "partials": srv.partials,
            "partial_w": np.asarray(srv.partial_w),
        } for srv in sim.servers]
        return cls(sim.model_cfg, sim.cfg.lora,
                   server_method(sim.cfg.method), servers, spec,
                   draw_omega=draw_omega)

    @classmethod
    def from_checkpoint(cls, sim_cfg, ckpt_dir: str,
                        round_idx: Optional[int] = None,
                        spec: Optional[ServeSpec] = None, *,
                        draw_omega: Optional[agg.OmegaFn] = None,
                        device="cuda") -> "AdapterStore":
        """Load server state straight from a checkpoint (no simulator
        rebuild) onto ``device``. The stored config fingerprint must
        match ``sim_cfg``: a checkpoint written by another config would
        pair adapters with the wrong backbone."""
        from repro_torch.checkpoint.carry import config_fingerprint
        from repro_torch.checkpoint.io import restore_round
        from repro_torch.federated.baselines import server_method
        dev = resolve_device(device)
        _, state = restore_round(ckpt_dir, round_idx, numpy=True)
        meta = json.loads(bytes(state["meta"]).decode())
        want = config_fingerprint(sim_cfg)
        if meta["fingerprint"] != want:
            raise ValueError(
                "checkpoint was written by a DIFFERENT SimConfig "
                f"(fingerprint {meta['fingerprint'][:12]}… != "
                f"{want[:12]}…) — refusing to serve its adapters")

        def on_dev(tree):
            return tree_map(lambda x: torch.as_tensor(x).to(dev), tree)

        servers = [{
            "round": int(sd["round"]),
            "merged": on_dev(sd["merged"]),
            "global_adapters": on_dev(sd["global_adapters"]),
            "partials": (None if sd["partials"] is None
                         else [on_dev(p) for p in sd["partials"]]),
            "partial_w": np.asarray(sd["partial_w"]),
        } for sd in state["servers"]]
        return cls(_resolve_model_cfg(sim_cfg), sim_cfg.lora,
                   server_method(sim_cfg.method), servers, spec,
                   draw_omega=draw_omega)

    # -- queries --------------------------------------------------------
    @property
    def num_tasks(self) -> int:
        return len(self.servers)

    def version(self, task: int) -> int:
        """Current version of a task's servable state = its server round."""
        return int(self.servers[task]["round"])

    def rsus(self, task: int) -> List[int]:
        """Servable RSU ids for a task: GLOBAL_RSU plus every RSU whose
        partial holds un-synced uploads."""
        out = [GLOBAL_RSU]
        srv = self.servers[task]
        if srv["partials"] is not None:
            for k, p in enumerate(srv["partials"]):
                if p is not None and float(srv["partial_w"][k]) > 0.0:
                    out.append(k)
        return out

    def _full_rank_tree(self, task: int, rsu: int, version: int) -> Any:
        """The max_rank adapter tree for one cache key (the cached value)."""
        srv = self.servers[task]
        state = srv["merged"] if rsu == GLOBAL_RSU else None
        if rsu != GLOBAL_RSU:
            partials = srv["partials"]
            if (partials is None or rsu >= len(partials)
                    or partials[rsu] is None):
                raise KeyError(f"task {task} has no partial for RSU {rsu}")
            state = partials[rsu]
        if self.method == "ours":
            if state is None:
                raise KeyError(f"task {task} has no trained merged state "
                               "yet (run at least one round)")
            # the SAME factors a vehicle at rank max_rank would receive
            # this round (seed = version = server round); lower ranks are
            # prefixes of these factors, so one SVD serves every rank.
            # Contiguous first: a live tier partial is a strided view of
            # the segment stack, and a card's GEMMs sum a strided batch
            # in another order than the checkpoint's contiguous copy
            state = tree_map(lambda x: x.contiguous(), state)
            return agg.redistribute(state, rank=self.lora.max_rank,
                                    scale=self.lora.scale,
                                    max_rank=self.lora.max_rank,
                                    seed=version,
                                    draw_omega=self.draw_omega)
        ga = srv["global_adapters"] if rsu == GLOBAL_RSU else state
        if ga is None:
            raise KeyError(f"task {task} has no trained global adapters "
                           "yet (run at least one round)")
        return ga

    def get(self, task: int, rsu: int = GLOBAL_RSU,
            rank: Optional[int] = None,
            version: Optional[int] = None) -> PagedAdapter:
        """A rank-``rank`` adapter paged into the store's slot width.

        ``version=None`` serves the current state; an older version only
        *hits* if that entry is still cached (the store keeps no history)
        — it can never return newer state, because the version is part of
        the cache key.
        """
        rank = self.lora.rank if rank is None else int(rank)
        if not 1 <= rank <= self.slot_rank:
            raise ValueError(f"rank {rank} outside slot [1, {self.slot_rank}]")
        cur = self.version(task)
        if version is None:
            version = cur
        elif version != cur:
            probe = object()
            hit = self.cache._lru.get((task, rsu, version), probe)
            if hit is probe:
                raise KeyError(
                    f"version {version} of (task {task}, rsu {rsu}) is "
                    f"no longer available (current is {cur})")
        full = self.cache.get_or_load(
            task, rsu, version,
            lambda: self._full_rank_tree(task, rsu, version))
        full_rank = lora_lib.tree_rank(full)
        tree = (lora_lib.truncate_adapter_tree(full, rank)
                if rank < full_rank else full)
        tree = lora_lib.pad_adapter_tree(tree, self.slot_rank)
        return PagedAdapter(task=task, rsu=rsu, version=int(version),
                            rank=rank, slot_rank=self.slot_rank,
                            scale=self.lora.scale, adapters=tree)

    def admit(self, engine, task: int, rsu: int = GLOBAL_RSU,
              rank: Optional[int] = None,
              version: Optional[int] = None,
              lane: Optional[int] = None) -> int:
        """Page the adapter for ``(task, rsu, rank, version)`` out of the
        store and admit it into ``engine`` mid-stream (lane choice and
        eviction are the engine's). Returns the lane the tenant landed
        on."""
        return engine.admit(self.get(task, rsu, rank, version), lane=lane)
