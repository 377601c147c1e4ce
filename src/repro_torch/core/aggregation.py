"""Federated aggregation of heterogeneous-rank LoRA updates (paper
§III-B), port of the list path of ``repro/core/aggregation.py``.

All operations act on adapter trees whose leaves are
{"a": (..., d_in, r_v), "b": (..., r_v, d_out)} with client-dependent
r_v. The server keeps the global adapter as merged deltas Δθ
(..., d_in, d_out) per target linear, which it SVDs and redistributes.
The batched engine's groups arrive stacked on the lane axis
((L, V, d_in, r), see ``federated/batched_client.py``); the fused
engine's whole fleet too, every adapter zero-padded to max_rank (the
rank-padded functions at the end). The baselines' reductions (HomoLoRA's
mean, HetLoRA's zero-padding average and self-pruning, FedRA's layer
masks and per-layer average) are plain tensor code, as the reference's
are plain ``jnp``: no Pallas kernel there, none here. So is the algebra
of the round's modes at the end: the per-RSU partials of a multi-RSU
tier (segment sums over the fleet, their staleness-discounted merge) and
semi-synchronous participation's upload buffer (per-lane merged deltas,
their discounted release sums), shared by the host server and the fused
engine's program. A tree with an RSU segment axis or a buffer lane axis
carries it where a stacked tree carries its lanes, third from the end
((L, K, d_in, d_out)).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
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


# ---------------------------------------------------------------------------
# HetLoRA (Cho et al., 2024): zero-padding aggregation + self-pruning
# ---------------------------------------------------------------------------

def aggregate_hetlora(client_adapters: Sequence[Any],
                      weights: Sequence[float], max_rank: int) -> Any:
    """Zero-pad every client's (a, b) to max_rank and average factor-wise
    (the baseline's cross-terms included). Returns an adapter tree at
    max_rank."""
    first = tree_get(client_adapters[0], tree_paths(client_adapters[0])[0])
    w = torch.tensor(list(weights), dtype=torch.float32)
    w = (w / torch.clamp(torch.sum(w), min=1e-12)).to(first["a"].device)
    out = client_adapters[0]
    for path in tree_paths(out):
        acc_a = acc_b = None
        for ci, tree in enumerate(client_adapters):
            a, b = _pad_rank(tree_get(tree, path), max_rank)
            a, b = a * w[ci], b * w[ci]
            acc_a = a if acc_a is None else acc_a + a
            acc_b = b if acc_b is None else acc_b + b
        out = tree_set(out, path, {"a": acc_a, "b": acc_b})
    return out


def hetlora_truncate(adapters: Any, rank: int) -> Any:
    """Slice a max-rank adapter tree down to ``rank`` (HetLoRA's
    distribution rule)."""
    out = adapters
    for path in tree_paths(adapters):
        ad = tree_get(out, path)
        out = tree_set(out, path, {"a": ad["a"][..., :rank],
                                   "b": ad["b"][..., :rank, :]})
    return out


def hetlora_prune_rank(adapters: Any, gamma: float = 0.99) -> int:
    """Gradient-free self-pruning: the smallest r that keeps ``gamma`` of
    the squared Frobenius mass of the stacked factor columns."""
    norms = None
    for path in tree_paths(adapters):
        ad = tree_get(adapters, path)
        a, b = ad["a"].float(), ad["b"].float()
        col = torch.sum(torch.square(a), dim=tuple(range(a.dim() - 1)))
        col = col + torch.sum(torch.square(b), dim=tuple(
            i for i in range(b.dim()) if i != b.dim() - 2))
        norms = col if norms is None else norms + col
    c = torch.cumsum(norms, 0) / torch.clamp(torch.sum(norms), min=1e-12)
    return int(torch.searchsorted(c, torch.tensor(gamma, dtype=c.dtype,
                                                   device=c.device))) + 1


# ---------------------------------------------------------------------------
# FedRA (Su et al., 2024): random layer allocation
# ---------------------------------------------------------------------------

def fedra_layer_mask(num_layers: int, fraction: float, *,
                     perm: Optional[Any] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """(L,) f32 mask on the CPU of the layers a client trains this round:
    the first round(fraction·L) (at least 1) of ``perm``, a permutation
    of the layers (default: ``torch.randperm`` from ``generator``)."""
    n_active = max(1, int(round(fraction * num_layers)))
    if perm is None:
        perm = torch.randperm(num_layers, generator=generator)
    idx = torch.tensor(np.asarray(perm), dtype=torch.int64).reshape(-1)[
        :n_active]
    mask = torch.zeros((num_layers,), dtype=torch.float32)
    mask[idx] = 1.0
    return mask


def apply_layer_mask(adapter_updates: Any, base_adapters: Any,
                     mask: Any) -> Any:
    """Keep the updates on the active layers (each leaf's leading layer
    axis) and the base elsewhere."""
    mask = torch.as_tensor(mask, dtype=torch.float32)

    def mix(new, old):
        m = mask.to(new.device).reshape((-1,) + (1,) * (new.dim() - 1))
        return new * m + old * (1 - m)
    return tree_map(mix, adapter_updates, base_adapters)


def aggregate_fedra(client_adapters: Sequence[Any], weights: Sequence[float],
                    masks: Sequence[Any]) -> Any:
    """Per-layer weighted average over the clients that trained that
    layer. masks: one (L,) multiplier vector per client."""
    first = tree_get(client_adapters[0], tree_paths(client_adapters[0])[0])
    dev = first["a"].device
    w = torch.tensor(list(weights), dtype=torch.float32).to(dev)
    ms = [torch.as_tensor(m, dtype=torch.float32).to(dev) for m in masks]
    out = client_adapters[0]
    for path in tree_paths(out):
        num_a = num_b = den = None
        for ci, tree in enumerate(client_adapters):
            ad = tree_get(tree, path)
            mm = ms[ci].reshape((-1,) + (1,) * (ad["a"].dim() - 1))
            wa = ad["a"].float() * mm * w[ci]
            wb = ad["b"].float() * mm * w[ci]
            d = ms[ci] * w[ci]
            num_a = wa if num_a is None else num_a + wa
            num_b = wb if num_b is None else num_b + wb
            den = d if den is None else den + d
        den = torch.clamp(den, min=1e-12)
        da = den.reshape((-1,) + (1,) * (num_a.dim() - 1))
        out = tree_set(out, path, {"a": num_a / da, "b": num_b / da})
    return out


# ---------------------------------------------------------------------------
# The baselines' stacked reductions (lanes third from the end, as above)
# ---------------------------------------------------------------------------

def _lanes_w(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(V,) lane weights shaped to multiply a stacked leaf x (..., V, m,
    n), on x's device."""
    return w.to(x.device).reshape(-1, 1, 1)


def average_stacked_grouped(groups: Sequence[Tuple[Any, Any]]) -> Any:
    """Data-weighted mean of stacked adapter trees (HomoLoRA's rule):
    every client holds one rank, so the mean is one lane sum per leaf."""
    if not groups:
        raise ValueError("average_stacked_grouped needs a group")
    wsum = _group_weight_norm(groups)
    acc = None
    for stacked, w in groups:
        wn = _wvec(w) / wsum
        part = tree_map(lambda x: torch.sum(
            x.float() * _lanes_w(wn, x), dim=-3), stacked)
        acc = part if acc is None else tree_map(torch.add, acc, part)
    return acc


def _pad_rank(ad: Dict[str, torch.Tensor], max_rank: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) in f32 with the rank zero-padded to ``max_rank``."""
    r = ad["a"].shape[-1]
    pad = torch.nn.functional.pad
    return (pad(ad["a"].float(), (0, max_rank - r)),
            pad(ad["b"].float(), (0, 0, 0, max_rank - r)))


def aggregate_hetlora_grouped(groups: Sequence[Tuple[Any, Any]],
                              max_rank: int) -> Any:
    """HetLoRA's zero-padding aggregation over stacked per-rank groups,
    equal to :func:`aggregate_hetlora` over the concatenated clients."""
    if not groups:
        raise ValueError("aggregate_hetlora_grouped needs a group")
    wsum = _group_weight_norm(groups)
    out = _skeleton(groups[0][0])
    for path in tree_paths(out):
        acc_a = acc_b = None
        for stacked, w in groups:
            a, b = _pad_rank(tree_get(stacked, path), max_rank)
            wn = _wvec(w) / wsum
            a = torch.sum(a * _lanes_w(wn, a), dim=-3)
            b = torch.sum(b * _lanes_w(wn, b), dim=-3)
            acc_a = a if acc_a is None else acc_a + a
            acc_b = b if acc_b is None else acc_b + b
        out = tree_set(out, path, {"a": acc_a, "b": acc_b})
    return out


def aggregate_fedra_stacked(stacked: Any, weights: Any, masks: Any) -> Any:
    """FedRA's per-layer weighted average over the lanes, equal to
    :func:`aggregate_fedra` over the per-client list.

    stacked: adapter tree with lanes third from the end ((L, V, d, r));
    weights: (V,); masks: (V, L) layer multipliers, the reference's
    layout."""
    w = _wvec(weights)
    m = torch.as_tensor(masks, dtype=torch.float32).cpu()
    den = torch.clamp(torch.sum(m * w[:, None], dim=0), min=1e-12)  # (L,)
    out = _skeleton(stacked)
    for path in tree_paths(out):
        ad = tree_get(stacked, path)
        dev = ad["a"].device
        mw = (m * w[:, None]).t().to(dev)                          # (L, V)
        mw = mw.reshape(mw.shape + (1,) * (ad["a"].dim() - 2))
        d = den.to(dev).reshape((-1,) + (1,) * (ad["a"].dim() - 2))
        out = tree_set(out, path, {
            "a": torch.sum(ad["a"].float() * mw, dim=-3) / d,
            "b": torch.sum(ad["b"].float() * mw, dim=-3) / d})
    return out


# ---------------------------------------------------------------------------
# Rank-padded fleet aggregation and redistribution, for the fused round
# engine: every adapter of the fleet sits in a max_rank-wide slot whose
# tail is zero (core.lora's rank-padding invariant), so the fleet is one
# stacked tree and no shape depends on the round's ranks. Nothing here
# reads a tensor on the host, so a CUDA graph can capture it.
# ---------------------------------------------------------------------------

def aggregate_merged_padded(stacked: Any, weights: torch.Tensor,
                            scale: float) -> Any:
    """Merged-delta aggregation over a rank-padded fleet-stacked tree.

    stacked: adapter tree with the fleet on the lane axis ((L, V, d_in,
    R), zero rank tails contribute nothing to A·B); weights: (V,) f32 on
    the tree's device, 0 for a lane that does not contribute, which makes
    it an exact no-op. Normalised in f32 as :func:`aggregate_merged`
    does, which this equals over the per-client list up to summation
    order (a sharded fleet adds :func:`merged_padded_sums` instead)."""
    w = weights.to(torch.float32)
    wn = (w / torch.clamp(torch.sum(w), min=1e-12)).reshape(-1, 1, 1)
    out = _skeleton(stacked)
    for path in tree_paths(out):
        ad = tree_get(stacked, path)
        delta = scale * torch.einsum("...vir,...vro->...io",
                                     ad["a"].float() * wn, ad["b"].float())
        out = tree_set(out, path, {"delta": delta})
    return out


def svd_omega_shapes(merged: Any, max_rank: int) -> List[Tuple]:
    """(path, d2, r) of the sketch Ω that :func:`merged_svd` takes for
    each merged delta of the tree (r from :func:`sketch_width` at
    min(max_rank, d1, d2))."""
    out = []
    for path in tree_paths_delta(merged):
        d1, d2 = tree_get(merged, path)["delta"].shape[-2:]
        out.append((path, d2, sketch_width(min(max_rank, d1, d2), d1, d2)))
    return out


def draw_omegas(merged: Any, max_rank: int, seed: int,
                draw_omega: Optional[OmegaFn] = None) -> Any:
    """The sketches of one :func:`merged_svd` call, drawn on the host as
    :func:`redistribute` draws them at ``seed``: a tree of {"omega"} with
    the merged tree's structure. Drawing is a pure function of the seed."""
    out = merged
    for path, d2, r in svd_omega_shapes(merged, max_rank):
        out = tree_set(out, path,
                       {"omega": (draw_omega or default_omega)(seed, d2, r)})
    return out


def merged_svd(merged: Any, max_rank: int, omegas: Any) -> Any:
    """Shared truncated SVD of every merged delta (one per target, for
    the whole fleet). omegas: :func:`draw_omegas`'s tree, as tensors on
    the delta's device (the reference takes a seed and draws in-program).
    Returns a tree of {"u", "s", "vt"} zero-padded to ``max_rank`` where
    min(d1, d2) < max_rank, so no later shape depends on the width."""
    out = merged
    for path in tree_paths_delta(merged):
        delta = tree_get(merged, path)["delta"]
        d1, d2 = delta.shape[-2:]
        mr = min(max_rank, d1, d2)
        u, s, vt = randomized_svd(delta, mr,
                                  omega=tree_get(omegas, path)["omega"])
        pad = max_rank - mr
        if pad:
            u = torch.nn.functional.pad(u, (0, pad))
            s = torch.nn.functional.pad(s, (0, pad))
            vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
        out = tree_set(out, path, {"u": u, "s": s, "vt": vt})
    return out


def tree_paths_svd(tree: Any) -> List[Tuple]:
    """Paths to SVD-factor dicts (nodes holding 'u' and 'vt')."""
    return _paths(tree, ("u", "vt"))


def factors_for_ranks(svd_tree: Any, rank_mask: torch.Tensor,
                      scale: float) -> Any:
    """Per-lane rank-padded factors from one shared SVD.

    rank_mask: (V, max_rank) 0/1, each lane's rank as a column mask.
    Returns a fleet-stacked adapter tree (lanes on the lane axis): a_v =
    (U·Σ)/scale with columns ≥ η_v zeroed, b_v = Vᵀ with rows ≥ η_v
    zeroed, each lane equal to :func:`redistribute` at its rank, padded
    to max_rank."""
    m = rank_mask.to(torch.float32)
    V, R = m.shape
    out = svd_tree
    for path in tree_paths_svd(svd_tree):
        f = tree_get(svd_tree, path)
        a1 = (f["u"] * f["s"][..., None, :]) / scale        # (..., d1, R)
        a = a1.unsqueeze(-3) * m.reshape(V, 1, R)           # (..., V, d1, R)
        b = f["vt"].unsqueeze(-3) * m.reshape(V, R, 1)      # (..., V, R, d2)
        out = tree_set(out, path, {"a": a, "b": b})
    return out


def factors_full(svd_tree: Any, scale: float) -> Any:
    """One full-rank adapter from a :func:`merged_svd` result (a = U·Σ /
    scale, b = Vᵀ at max_rank): the fused engine's in-program
    ``RSUServer.eval_adapters``."""
    out = svd_tree
    for path in tree_paths_svd(svd_tree):
        f = tree_get(svd_tree, path)
        out = tree_set(out, path, {"a": (f["u"] * f["s"][..., None, :])
                                   / scale, "b": f["vt"]})
    return out


# ---------------------------------------------------------------------------
# Two-tier RSU hierarchy: per-RSU segment-sum partials and their
# staleness-weighted periodic merge into the global tree. The host server
# keeps a list of per-RSU trees, the fused engine one tree with the
# segment axis third from the end; both merge through the functions here.
# ---------------------------------------------------------------------------

def _f32(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` (a number, numpy array or tensor) as f32, on ``like``'s
    device if given, else where it is (numbers and numpy: the CPU)."""
    t = torch.as_tensor(x)
    if like is not None:
        t = t.to(like.device)
    return t.to(torch.float32)


def _seg_w(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A scalar weight, or a (K,) vector shaped to multiply x's segment
    axis (third from the end), on x's device."""
    w = w.to(x.device)
    return w if w.dim() == 0 else w.reshape(-1, 1, 1)


def staleness_weights(ages, decay: float) -> torch.Tensor:
    """Per-partial staleness discount ``decay**age``, an f32 power as the
    reference's ``jnp.power``: exactly 1.0 at age 0 (the trivial-tier
    equivalence), strictly decreasing in age for 0 < decay < 1. The host
    server's float64 ages and the fused program's f32 ones give the same
    discount."""
    return torch.pow(decay, _f32(ages))


def sync_weights(data_w, ages, decay: float) -> torch.Tensor:
    """Normalised sync weights ω̂_k = ω_k / Σω, ω_k = data_w_k ·
    decay**age_k. A segment without uploads (data_w 0) is an exact
    no-op."""
    w = _f32(data_w) * staleness_weights(_f32(ages, _f32(data_w)), decay)
    return w / torch.clamp(torch.sum(w), min=1e-12)


def merge_partials(partials_stacked: Any, data_w, ages, decay: float
                   ) -> Tuple[Any, torch.Tensor]:
    """The ω̂-weighted sum of per-RSU partials over their segment axis
    (merged-delta trees of ``ours`` and factor trees of HetLoRA alike),
    and whether it is a merge: Σω > 0. With one partial the normalised
    weight is exactly 1.0 (x/x).

    When every ω_k underflows to zero (all partials stale past the float
    range) the sum is the zero tree and the flag is false: the caller
    keeps its previous global instead (the reference's ``fallback=``;
    the host server and the fused program both gate on this flag)."""
    wn = sync_weights(data_w, ages, decay)
    merged = tree_map(lambda x: torch.sum(x.float() * _lanes_w(wn, x),
                                          dim=-3), partials_stacked)
    return merged, torch.sum(wn) > 0


def _seg_onehot(assoc, w: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(V, K) raw per-segment weights: w_v where lane v is in segment k."""
    assoc = torch.as_tensor(assoc).to(w.device)
    return w.reshape(-1, 1) * (assoc.reshape(-1, 1) == torch.arange(
        num_segments, device=w.device)).to(torch.float32)


def segment_weight_matrix(assoc, weights, num_segments: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(V, K) per-segment normalised weights and the (K,) raw sums.

    assoc: (V,) segment of each lane, -1 for a lane in no segment (its
    row is zero, an exact no-op); weights: (V,) data sizes (0 for a lane
    that does not contribute). Column k sums to 1 where segment k has
    weight."""
    w_vk = _seg_onehot(assoc, _f32(weights), num_segments)
    seg_w = torch.sum(w_vk, dim=0)
    return w_vk / torch.clamp(seg_w, min=1e-12), seg_w


def aggregate_merged_padded_segmented(stacked: Any, weights, assoc,
                                      num_segments: int, scale: float, *,
                                      constrain: Optional[Callable] = None
                                      ) -> Tuple[Any, torch.Tensor]:
    """Per-RSU merged-delta partials of a stacked adapter tree (a rank
    group, or the fused engine's rank-padded fleet; lanes third from the
    end). Returns (partials, seg_w): each leaf (..., K, d_in, d_out), slot
    k equal to :func:`aggregate_merged` over segment k's lanes, and the
    (K,) raw weight sums (0: the slot is zero and the caller keeps its
    previous partial). constrain: see :func:`split_fleet`."""
    parts = split_fleet(constrain, stacked, weights, assoc)
    if parts is not None:
        raw, seg_w = add_partials([merged_segment_sums(
            s, w, a, num_segments, scale) for s, w, a in parts])
        return normalise(raw, seg_w), seg_w
    wn_vk, seg_w = segment_weight_matrix(assoc, weights, num_segments)
    out = _skeleton(stacked)
    for path in tree_paths(out):
        ad = tree_get(stacked, path)
        a, b = ad["a"].float(), ad["b"].float()
        wk = wn_vk.to(a.device)
        delta = torch.stack([scale * torch.einsum(
            "...vir,...vro->...io", a * wk[:, k].reshape(-1, 1, 1), b)
            for k in range(num_segments)], dim=-3)
        out = tree_set(out, path, {"delta": delta})
    return out, seg_w


def aggregate_hetlora_segmented(stacked: Any, weights, assoc,
                                num_segments: int, max_rank: int, *,
                                constrain: Optional[Callable] = None
                                ) -> Tuple[Any, torch.Tensor]:
    """Per-RSU HetLoRA partials: factors zero-padded to max_rank and
    averaged per segment. Returns a factor tree with the segment axis
    third from the end (slot k equal to :func:`aggregate_hetlora` over
    segment k's lanes) and the (K,) raw weight sums. constrain: see
    :func:`split_fleet`."""
    parts = split_fleet(constrain, stacked, weights, assoc)
    if parts is not None:
        raw, seg_w = add_partials([hetlora_segment_sums(
            s, w, a, num_segments, max_rank) for s, w, a in parts])
        return normalise(raw, seg_w), seg_w
    wn_vk, seg_w = segment_weight_matrix(assoc, weights, num_segments)
    out = _skeleton(stacked)
    for path in tree_paths(out):
        a, b = _pad_rank(tree_get(stacked, path), max_rank)
        wk = wn_vk.to(a.device)
        out = tree_set(out, path, {
            "a": torch.einsum("vk,...vir->...kir", wk, a),
            "b": torch.einsum("vk,...vro->...kro", wk, b)})
    return out, seg_w


def stack_partials(partials: Sequence[Any]) -> Any:
    """K per-RSU trees → one tree with the segment axis third from the
    end."""
    return tree_map(lambda *xs: torch.stack(xs, dim=-3), *partials)


def unstack_partials(stacked: Any, num_segments: int) -> List[Any]:
    """Inverse of :func:`stack_partials` (copies, not views)."""
    return [tree_map(lambda x: x.select(-3, k).clone(), stacked)
            for k in range(num_segments)]


# ---------------------------------------------------------------------------
# Semi-synchronous participation: the upload buffer. A vehicle whose
# upload misses its round parks its trained merged delta; it lands up to
# max_delay rounds late at weight w·decay**k. The host server's buffer
# (one tree per vehicle) and the fused program's (one tree with the fleet
# on the lane axis) fold their releases in through the same functions.
# ---------------------------------------------------------------------------

def merge_delta_lanes(ad: Dict[str, torch.Tensor], scale: float
                      ) -> torch.Tensor:
    """Per-lane merged deltas of one stacked target, no reduction over
    the lanes: (..., V, d_in, d_out) = scale·A_v·B_v (the reference's
    ``merge_delta_fleet``, one target at a time). Zero rank tails add
    exact zeros."""
    return scale * torch.einsum("...vir,...vro->...vio", ad["a"].float(),
                                ad["b"].float())


def _lane_sum(w_kv: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Σ_v w_kv[k, v]·x[..., v, i, o] for a buffer leaf x: (..., K, i,
    o), one matrix product over the flattened (i, o) plane."""
    lead, (V, i, o) = x.shape[:-3], x.shape[-3:]
    y = torch.matmul(w_kv.to(x.device), x.float().reshape(lead + (V, i * o)))
    return y.reshape(lead + (w_kv.shape[0], i, o))


def buffer_release_sum(buf_stacked: Any, rel_w) -> Tuple[Any, torch.Tensor]:
    """Raw weighted sum of released buffer lanes (trivial-tier landing).
    rel_w: (V,) discounted release weights, 0 for a lane not releasing
    this round (an exact no-op). Returns (Σ relw_v·δ_v, Σ relw_v), the
    raw sums :func:`combine_with_released` takes."""
    w = _f32(rel_w)
    raw = tree_map(lambda x: _lane_sum(w.reshape(1, -1), x).select(-3, 0),
                   buf_stacked)
    return raw, torch.sum(w)


def segment_buffer_release(buf_stacked: Any, rel_w, dest,
                           num_segments: int) -> Tuple[Any, torch.Tensor]:
    """Per-RSU raw sums of released buffer lanes (tier landing). dest:
    (V,) destination segment per lane (-1: a no-op row). Returns the raw
    sums with the segment axis third from the end and the (K,) weight
    sums."""
    w_vk = _seg_onehot(dest, _f32(rel_w), num_segments)
    raw = tree_map(lambda x: _lane_sum(w_vk.t(), x), buf_stacked)
    return raw, torch.sum(w_vk, dim=0)


def combine_with_released(merged: Any, live_w, released_raw: Any,
                          released_w) -> Any:
    """Fold late uploads into a normalised live merge: (merged·W_live +
    raw) / max(W_live + W_rel, eps), the normalised aggregate over live ∪
    released. live_w / released_w: scalars, or (K,) per segment of a
    segmented merge."""
    def one(m, r):
        lw, rw = _f32(live_w, m), _f32(released_w, m)
        tot = torch.clamp(lw + rw, min=1e-12)
        return ((m.float() * _seg_w(lw, m) + r.float())
                / _seg_w(tot, m))
    return tree_map(one, merged, released_raw)


# ---------------------------------------------------------------------------
# The fleet split over devices (the sharded fused engine, and the
# primitives above given a ``constrain``): each shard reduces its own
# lanes to raw weighted sums, and the sums are added on the first
# shard's (home) device in shard order, so a run repeats bit for bit; the
# normalisation follows the sum. Equal to the one-device result up to
# summation order.
# ---------------------------------------------------------------------------

def split_fleet(constrain: Optional[Callable], *args) -> Optional[List]:
    """``args`` split by a fleet constraint
    (``launch.sharding.fleet_constrainer``): None without one, or where
    it is the identity (one device holds every lane); else one tuple of
    ``args`` per shard, each holding that shard's lanes on its device."""
    if constrain is None:
        return None
    args = tuple(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                 for a in args)
    out = constrain(args)
    return None if out is args else list(out)


def add_partials(parts: Sequence[Any]) -> Any:
    """Σ of per-shard trees (tuples of trees alike), added leaf by leaf on
    the first part's devices in the order given."""
    out = parts[0]
    for p in parts[1:]:
        out = tree_map(lambda a, b: a + b.to(a.device), out, p)
    return out


def normalise(raw: Any, w) -> Any:
    """A raw weighted sum over its weights: a scalar total, or (K,)
    totals per segment (third from the end), clamped as the one-device
    functions clamp."""
    def one(x):
        tot = torch.clamp(_f32(w, x), min=1e-12)
        return x / _seg_w(tot, x)
    return tree_map(one, raw)


def merged_padded_sums(stacked: Any, weights, scale: float
                       ) -> Tuple[Any, torch.Tensor]:
    """One shard's part of :func:`aggregate_merged_padded`: (Σ_v w_v ·
    scale·A_v·B_v, Σ_v w_v), unnormalised."""
    w = _f32(weights)
    out = _skeleton(stacked)
    for path in tree_paths(out):
        ad = tree_get(stacked, path)
        a = ad["a"].float() * w.to(ad["a"].device).reshape(-1, 1, 1)
        out = tree_set(out, path, {"delta": scale * torch.einsum(
            "...vir,...vro->...io", a, ad["b"].float())})
    return out, torch.sum(w)


def merged_segment_sums(stacked: Any, weights, assoc, num_segments: int,
                        scale: float) -> Tuple[Any, torch.Tensor]:
    """One shard's part of :func:`aggregate_merged_padded_segmented`:
    per-segment raw sums (segment axis third from the end) and the (K,)
    weight sums."""
    w_vk = _seg_onehot(assoc, _f32(weights), num_segments)
    out = _skeleton(stacked)
    for path in tree_paths(out):
        ad = tree_get(stacked, path)
        a, b = ad["a"].float(), ad["b"].float()
        wk = w_vk.to(a.device)
        out = tree_set(out, path, {"delta": torch.stack([
            scale * torch.einsum("...vir,...vro->...io",
                                 a * wk[:, k].reshape(-1, 1, 1), b)
            for k in range(num_segments)], dim=-3)})
    return out, torch.sum(w_vk, dim=0)


def hetlora_segment_sums(stacked: Any, weights, assoc, num_segments: int,
                         max_rank: int) -> Tuple[Any, torch.Tensor]:
    """One shard's part of :func:`aggregate_hetlora_segmented`: raw
    per-segment factor sums and the (K,) weight sums."""
    w_vk = _seg_onehot(assoc, _f32(weights), num_segments)
    out = _skeleton(stacked)
    for path in tree_paths(out):
        a, b = _pad_rank(tree_get(stacked, path), max_rank)
        wk = w_vk.to(a.device)
        out = tree_set(out, path, {
            "a": torch.einsum("vk,...vir->...kir", wk, a),
            "b": torch.einsum("vk,...vro->...kro", wk, b)})
    return out, torch.sum(w_vk, dim=0)
