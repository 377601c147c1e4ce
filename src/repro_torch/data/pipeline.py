"""Client-side batching pipeline: shuffled, infinitely repeating batches.
Port of ``repro/data/pipeline.py`` (numpy, unchanged)."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class ClientDataset:
    """Holds one vehicle's local shard; yields numpy batches."""

    def __init__(self, tokens: np.ndarray, labels: np.ndarray,
                 batch_size: int, seed: int = 0):
        if len(tokens) != len(labels) or len(tokens) == 0:
            raise ValueError("a shard needs as many labels as token rows, "
                             "and at least one")
        self.tokens = tokens
        self.labels = labels
        # fixed batch size; small shards sample
        # with replacement
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)
        self._order = self._rng.permutation(len(tokens))
        self._pos = 0

    def __len__(self) -> int:
        return len(self.tokens)

    def next_batch(self) -> Dict[str, np.ndarray]:
        bs = self.batch_size
        if bs > len(self.tokens):
            idx = self._rng.choice(len(self.tokens), bs, replace=True)
        else:
            if self._pos + bs > len(self._order):
                self._order = self._rng.permutation(len(self.tokens))
                self._pos = 0
            idx = self._order[self._pos:self._pos + bs]
            self._pos += bs
        return {"tokens": self.tokens[idx], "labels": self.labels[idx]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
