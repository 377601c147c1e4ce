"""Adapter paging for the multi-tenant serving tier.

Port of :class:`PagedAdapter` from ``repro/launch/adapter_cache.py``. The
reference's ``AdapterStore`` and ``AdapterCache`` (which need the
server-side SVD and the federated simulator) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

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
