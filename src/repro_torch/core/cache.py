"""Bounded LRU caches shared by the batched trainer and the serving tier,
after ``repro/core/cache.py``.

Two flavours over one eviction machinery:

- :class:`LRUCache` — hashable-key bounded LRU (thread-safe). The serving
  tier's adapter cache keys on ``(task, rsu, version)`` tuples
  (:mod:`repro_torch.launch.adapter_cache`), so a hit can never be stale:
  the version is part of the identity being asked for.
- :class:`IdentityLRU` — identity-keyed variant for *unhashable* host
  objects (trees). The batched trainer keeps each task's local-eval batch
  on the device with it, keyed on the host dict.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable, Optional, Tuple


class LRUCache:
    """Bounded thread-safe LRU over hashable keys.

    ``get`` refreshes recency; ``put`` inserts or overwrites and evicts the
    least-recently-used entries down to ``maxsize``. ``hits``/``misses``
    are informational counters, never consulted for eviction.
    """

    def __init__(self, maxsize: int):
        if int(maxsize) < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = int(maxsize)
        self._d: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._d

    def keys(self):
        """Current keys, least- to most-recently-used (snapshot)."""
        with self._lock:
            return list(self._d.keys())

    def get(self, key: Hashable, default: Any = None) -> Any:
        with self._lock:
            if key not in self._d:
                self.misses += 1
                return default
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]

    def put(self, key: Hashable, value: Any) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.maxsize:
                self._d.popitem(last=False)

    def get_or_load(self, key: Hashable, loader: Callable[[], Any]) -> Any:
        """Hit, or compute-and-insert via ``loader()`` on a miss.

        The loader runs OUTSIDE the lock (it may be expensive, e.g. a
        truncated SVD redistribution); a concurrent insert of the same key
        simply wins by last write.
        """
        sentinel = object()
        hit = self.get(key, sentinel)
        if hit is not sentinel:
            return hit
        value = loader()
        self.put(key, value)
        return value


class IdentityLRU(LRUCache):
    """Bounded identity-keyed cache for unhashable host objects (trees).

    Keys on ``(id(obj), extra)`` but stores the key object and verifies
    identity on lookup — a bare ``id()`` key could be recycled by a later
    allocation and silently serve another object's data. Evicts least-
    recently-used entries at ``maxsize``, so long-lived trainers hold at
    most ``maxsize`` strong references to key/value trees no matter how
    many rounds (or simulators) pass through them.
    """

    def get(self, obj: Any, extra: Any = None) -> Optional[Any]:
        key: Tuple[int, Any] = (id(obj), extra)
        hit = super().get(key)
        if hit is None or hit[0] is not obj:
            return None
        return hit[1]

    def put(self, obj: Any, value: Any, extra: Any = None) -> None:
        super().put((id(obj), extra), (obj, value))
