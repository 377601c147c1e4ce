"""Bounded identity-keyed LRU cache, after ``repro/core/cache.py``.

The batched trainer keeps each task's local-eval batch on the device with
:class:`IdentityLRU`, keyed on the host dict. The reference's hashable-key
``LRUCache`` (thread-safe, with hit and miss counters and
``get_or_load``) comes with the serving item that needs it.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Optional, Tuple


class IdentityLRU:
    """Bounded identity-keyed cache for unhashable host objects (trees).

    Keys on ``(id(obj), extra)`` but stores the key object and verifies
    identity on lookup — a bare ``id()`` key could be recycled by a later
    allocation and silently serve another object's data. Evicts least-
    recently-used entries at ``maxsize``, so long-lived trainers hold at
    most ``maxsize`` strong references to key/value trees no matter how
    many rounds (or simulators) pass through them.
    """

    def __init__(self, maxsize: int):
        if int(maxsize) < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = int(maxsize)
        self._d: "OrderedDict[Tuple[int, Any], Tuple[Any, Any]]" = (
            OrderedDict())

    def __len__(self) -> int:
        return len(self._d)

    def get(self, obj: Any, extra: Any = None) -> Optional[Any]:
        key = (id(obj), extra)
        hit = self._d.get(key)
        if hit is None or hit[0] is not obj:
            return None
        self._d.move_to_end(key)
        return hit[1]

    def put(self, obj: Any, value: Any, extra: Any = None) -> None:
        key = (id(obj), extra)
        self._d[key] = (obj, value)
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)
