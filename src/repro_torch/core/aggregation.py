"""Federated aggregation of heterogeneous-rank LoRA updates (paper
§III-B), port of the list path of ``repro/core/aggregation.py``.

All operations act on adapter trees whose leaves are
{"a": (..., d_in, r_v), "b": (..., r_v, d_out)} with client-dependent
r_v. The server keeps the global adapter as merged deltas Δθ
(..., d_in, d_out) per target linear, which it SVDs and redistributes.
The batched engine's groups arrive stacked on the lane axis
((L, V, d_in, r), see ``federated/batched_client.py``). The padded and
segmented aggregators, the RSU partials, the upload buffer, HetLoRA's
and FedRA's aggregators wait for later slices of the port.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import lora as lora_lib
from repro_torch.core.svd import default_omega, randomized_svd, sketch_width
from repro_torch.interop import tree_map


def _paths(tree: Any, leaf_key: Tuple[str, ...]) -> List[Tuple]:
    paths = []

    def rec(node, path):
        if isinstance(node, dict) and all(k in node for k in leaf_key):
            paths.append(tuple(path))
            return
        if isinstance(node, dict):
            for k2, v in node.items():
                rec(v, path + [k2])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, path + [i])
    rec(tree, [])
    return paths


def tree_paths(tree: Any) -> List[Tuple]:
    """Paths to adapter dicts (nodes holding 'a' and 'b')."""
    return _paths(tree, ("a", "b"))


def tree_paths_delta(tree: Any) -> List[Tuple]:
    """Paths to merged-delta dicts (nodes holding 'delta')."""
    return _paths(tree, ("delta",))


def tree_get(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return node


def tree_set(tree, path, value):
    """Functional set (shallow-copies along the path)."""
    if not path:
        return value
    out = dict(tree) if isinstance(tree, dict) else list(tree)
    out[path[0]] = tree_set(tree[path[0]], path[1:], value)
    return out if isinstance(tree, dict) else type(tree)(out)


# ---------------------------------------------------------------------------
# Ours: merged-delta weighted aggregation + truncated-SVD redistribution
# ---------------------------------------------------------------------------

def aggregate_merged(client_adapters: Sequence[Any], weights: Sequence[float],
                     scale: float) -> Any:
    """Δθ̂ = Σ_v (|D_v|/|D|)·scale·A_v·B_v per adapter (paper §III-B).

    Clients may have different ranks; merging to full deltas first makes
    the aggregation rank-agnostic. Returns a tree of {"delta"} with the
    adapters' structure. Weights are normalized in f32, as the
    reference's."""
    first = tree_get(client_adapters[0], tree_paths(client_adapters[0])[0])
    w = torch.tensor(list(weights), dtype=torch.float32)
    w = w / torch.clamp(torch.sum(w), min=1e-12)
    w = w.to(first["a"].device)
    out = client_adapters[0]
    for path in tree_paths(client_adapters[0]):
        delta = None
        for ci, ad_tree in enumerate(client_adapters):
            ad = tree_get(ad_tree, path)
            d = lora_lib.merge_delta({"a": ad["a"].float(),
                                      "b": ad["b"].float()}, scale) * w[ci]
            delta = d if delta is None else delta + d
        out = tree_set(out, path, {"delta": delta})
    return out


# ---------------------------------------------------------------------------
# Stacked (lane-axis) aggregation, for the batched round engine: each
# group holds the adapters of its same-rank clients stacked on the lane
# axis, so the server merges a whole group with one contraction per
# LoRA target instead of a loop over clients.
# ---------------------------------------------------------------------------

def _skeleton(stacked: Any) -> Any:
    """Lane-0 view of a stacked tree (structure donor for tree_set)."""
    return tree_map(lambda x: x.select(-3, 0), stacked)


def _wvec(w) -> torch.Tensor:
    """A group's weights as an f32 vector on the CPU."""
    return torch.as_tensor(w, dtype=torch.float32).reshape(-1).cpu()


def _group_weight_norm(groups: Sequence[Tuple[Any, Any]]) -> torch.Tensor:
    return torch.clamp(sum(torch.sum(_wvec(w)) for _, w in groups),
                       min=1e-12)


def aggregate_merged_grouped(groups: Sequence[Tuple[Any, Any]],
                             scale: float) -> Any:
    """Merged-delta aggregation over stacked per-rank groups.

    groups: [(stacked_adapters, weights)]; stacked leaves carry the lane
    axis third from the end ((L, n_g, d_in, r)), weights are (n_g,). The
    weights are normalised in f32 over all groups. Equal to
    :func:`aggregate_merged` over the concatenated clients up to float
    reassociation; each group contracts its lanes in one einsum per
    leaf."""
    if not groups:
        raise ValueError("aggregate_merged_grouped needs a group")
    wsum = _group_weight_norm(groups)
    out = _skeleton(groups[0][0])
    device = tree_get(out, tree_paths(out)[0])["a"].device
    # each group's normalised weights, on the device once
    wls = [(_wvec(w) / wsum).to(device).reshape(-1, 1, 1)
           for _, w in groups]
    for path in tree_paths(out):
        delta = None
        for (stacked, _), wl in zip(groups, wls):
            ad = tree_get(stacked, path)
            a = ad["a"].float() * wl
            d = scale * torch.einsum("...vir,...vro->...io", a,
                                     ad["b"].float())
            delta = d if delta is None else delta + d
        out = tree_set(out, path, {"delta": delta})
    return out


OmegaFn = Callable[[int, int, int], torch.Tensor]


def _delta_svd(delta: torch.Tensor, max_rank: int, seed: int,
               draw_omega: Optional[OmegaFn] = None):
    """Truncated SVD of one (possibly layer-stacked) merged delta at
    mr = min(max_rank, d1, d2). Every matrix of the stack shares one Ω,
    ``draw_omega(seed, d2, r)`` (default :func:`default_omega`)."""
    d1, d2 = delta.shape[-2:]
    mr = min(max_rank, d1, d2)
    omega = (draw_omega or default_omega)(seed, d2, sketch_width(mr, d1, d2))
    return randomized_svd(delta, mr, omega=omega)


def redistribute(merged: Any, rank: int, scale: float, max_rank: int,
                 seed: int = 0, draw_omega: Optional[OmegaFn] = None) -> Any:
    """Paper Fig. 3: truncated SVD of each Δθ, personalized rank-η factors
    a = UΣ/scale, b = Vᵀ. The SVD runs to max_rank and is then sliced to
    ``rank``. ``draw_omega`` gives the sketch (see :func:`_delta_svd`)."""
    out = merged
    for path in tree_paths_delta(merged):
        u, s, vt = _delta_svd(tree_get(merged, path)["delta"], max_rank,
                              seed, draw_omega)
        out = tree_set(out, path,
                       lora_lib.factors_from_svd(u, s, vt, rank, scale))
    return out


def hetlora_truncate(adapters: Any, rank: int) -> Any:
    """Slice a max-rank adapter tree down to ``rank``."""
    out = adapters
    for path in tree_paths(adapters):
        ad = tree_get(out, path)
        out = tree_set(out, path, {"a": ad["a"][..., :rank],
                                   "b": ad["b"][..., :rank, :]})
    return out
