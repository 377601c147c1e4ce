"""Carry weights between the reference's trees and the port's.

The port keeps the reference's tree layout (segments with a stacked
leading layer axis, the same key names), so the mapping is one to one.
The reference's side is handed over as numpy arrays — for a JAX tree,
``jax.tree_util.tree_map(np.asarray, tree)`` — so this module needs no
JAX. bfloat16 arrays (numpy's ``bfloat16`` extension type) go through
float32, which holds every bf16 value exactly.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.runmode import resolve_device


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of a tree of dicts, lists and tuples (None
    leaves stay None); with ``rest``, over the matching leaves of trees
    of the same structure, matched by key (dict order may differ)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *rs)
                          for v, *rs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def _to_numpy(leaf) -> np.ndarray:
    a = np.asarray(leaf)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def _leaf_to_torch(leaf, device, dtype) -> torch.Tensor:
    # always a copy: np.asarray of a JAX array can be a view of a buffer
    # that JAX may free or reuse (donation), which must not alias ours
    t = torch.from_numpy(np.array(_to_numpy(leaf), order="C", copy=True))
    if t.is_floating_point() and dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: Any, device="cuda", dtype=None) -> Any:
    """Reference param tree (numpy leaves) → port params on ``device``.
    Float leaves are cast to ``dtype`` (None keeps their own)."""
    dev = resolve_device(device)
    return tree_map(lambda x: _leaf_to_torch(x, dev, dtype), tree)


def adapters_from_jax(tree: Any, device="cuda") -> Any:
    """Reference adapter tree → port adapters (float32, as trained)."""
    dev = resolve_device(device)
    return tree_map(lambda x: _leaf_to_torch(x, dev, torch.float32), tree)


def to_numpy(tree: Any) -> Any:
    """Port params or adapters → numpy tree (float leaves as float32),
    the inverse of the two functions above, for comparing trees."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()
    return tree_map(leaf, tree)
