"""Port of ``repro/data/partition.py`` (numpy, unchanged). Non-iid
federated partitioning (paper §V-A: "unequal, randomly sampled
portions of task-specific datasets with non-i.i.d. distributions")."""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(labels: np.ndarray, num_clients: int,
                        alpha: float = 0.5, seed: int = 0,
                        min_per_client: int = 4) -> List[np.ndarray]:
    """Label-Dirichlet split: per class, proportions ~ Dir(alpha) over
    clients. Returns per-client index arrays (unequal sizes — matching the
    paper's unequal portions)."""
    rng = np.random.default_rng(seed)
    num_classes = int(labels.max()) + 1
    client_idx: List[List[int]] = [[] for _ in range(num_clients)]
    for c in range(num_classes):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * num_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for ci, part in enumerate(np.split(idx, cuts)):
            client_idx[ci].extend(part.tolist())
    # guarantee a floor so every vehicle can form a batch
    all_idx = np.arange(len(labels))
    out = []
    for ci in range(num_clients):
        idx = np.array(sorted(client_idx[ci]), dtype=np.int64)
        if len(idx) < min_per_client:
            extra = rng.choice(all_idx, min_per_client - len(idx),
                               replace=False)
            idx = np.unique(np.concatenate([idx, extra]))
        out.append(idx)
    return out
