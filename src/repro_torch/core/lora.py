"""Adaptive-rank LoRA adapters (paper §III-B), port of ``repro/core/lora.py``.

An adapter for a linear ``W: (d_in, d_out)`` is a pair
``{"a": (d_in, r), "b": (r, d_out)}`` applied as
``y = x @ W + scale · (x @ a) @ b`` with ``scale = alpha / r``.
Adapters of a layer stack carry a leading layer axis: (L, d_in, r).

The reference serves many tenants by ``vmap`` over lanes; the port writes
that lane axis out. A lane-batched adapter per layer is
``{"a": (B, d_in, r), "b": (B, r, d_out)}`` against activations
(B, S, d_in), with a per-lane scale (B,) and rank mask (B, r).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Adapter = Dict[str, torch.Tensor]


def init_adapter(gen: torch.Generator, d_in: int, d_out: int, rank: int,
                 dtype=torch.float32, layers: Optional[int] = None) -> Adapter:
    """Kaiming-init A, zero-init B (standard LoRA init: Δθ starts at 0)."""
    sa = (d_in, rank) if layers is None else (layers, d_in, rank)
    sb = (rank, d_out) if layers is None else (layers, rank, d_out)
    a = torch.randn(sa, generator=gen, device=gen.device) / d_in ** 0.5
    return {"a": a.to(dtype),
            "b": torch.zeros(sb, dtype=dtype, device=gen.device)}


def split_scale(scale) -> Tuple[Any, Any]:
    """Normalize the opaque LoRA scale argument: a scalar (or a (B,)
    tensor of per-lane scales), or a ``(scale, rank_mask)`` pair. Returns
    ``(scale, rank_mask_or_None)``."""
    if isinstance(scale, tuple):
        return scale[0], scale[1]
    return scale, None


def _kernel_route_ok(base: Dict[str, torch.Tensor], adapter: Adapter) -> bool:
    # Bias excluded, as in the reference: the plain path computes
    # (x·W + bias) + adapter while the kernel epilogue would give
    # (x·W + adapter) + bias — different rounding. The adapter is one
    # layer's (2-D) or one layer's lane batch (3-D).
    return ("b" not in base and base["w"].dim() == 2
            and adapter["a"].dim() in (2, 3))


def _lane_operand(v, lanes: int, tail: Tuple[int, ...], device):
    """scale/mask as the kernel's contiguous f32 (lanes, *tail) operand.
    A Python scalar is filled on the device (no host to device copy)."""
    if not isinstance(v, torch.Tensor):
        return torch.full((lanes,) + tail, float(v), dtype=torch.float32,
                          device=device)
    t = v.to(device=device, dtype=torch.float32)
    if t.dim() == len(tail):                 # shared by every lane
        t = t.reshape((1,) + tail)
    return t.expand((lanes,) + tail).contiguous()


def _kernel_linear(w, adapter, x, scale, rank_mask):
    from repro_torch.kernels.lora_matmul import lora_matmul
    a, b = adapter["a"], adapter["b"]
    K, N = w.shape
    r = a.shape[-1]
    lanes = 1 if a.dim() == 2 else a.shape[0]
    if a.dim() == 2:
        a, b = a[None], b[None]
    if rank_mask is None:
        rank_mask = torch.ones((r,), dtype=torch.float32, device=x.device)
    y = lora_matmul(x.reshape(lanes, -1, K).contiguous(), w, a,
                    b.contiguous(),
                    _lane_operand(scale, lanes, (), x.device),
                    _lane_operand(rank_mask, lanes, (r,), x.device))
    return y.reshape(x.shape[:-1] + (N,))


def _per_lane(v, like: torch.Tensor, tail: int):
    """Broadcast a per-lane scale (B,) (tail 0) or mask (B, r) (tail 1)
    against (B, S, ·); a shared scalar or (r,) mask broadcasts as is."""
    if isinstance(v, torch.Tensor) and v.dim() == tail + 1:
        return v.reshape(v.shape[:1] + (1,) * (like.dim() - 1 - tail)
                         + v.shape[1:])
    return v


def apply_lora_linear(base: Dict[str, torch.Tensor],
                      adapter: Optional[Adapter], x: torch.Tensor,
                      scale) -> torch.Tensor:
    """y = x·W (+bias) + scale·(x·A)·B.  adapter=None → plain linear.

    scale: scalar, (B,) per-lane tensor, or ``(scale, rank_mask)``.
    Unbiased 2-D linears go through the fused ``lora_matmul`` (the CUDA
    kernel on a card, its plain version on the CPU); biased ones take
    the plain expression below, on every device, as in the reference.
    """
    scale, rank_mask = split_scale(scale)
    if adapter is not None and _kernel_route_ok(base, adapter):
        return _kernel_linear(base["w"], adapter, x, scale, rank_mask)
    y = x @ base["w"]
    if "b" in base:
        y = y + base["b"]
    if adapter is not None:
        # adapters are kept in f32 (they are trained); compute the
        # low-rank path in f32 and cast back to the base compute dtype.
        # Lane-batched adapters (3-D) take x's rows lane-major, as
        # _kernel_linear does: one row per lane in decode, B·S in the
        # batched trainer
        xl = x.to(adapter["a"].dtype)
        if adapter["a"].dim() == 3:
            xl = xl.reshape(adapter["a"].shape[0], -1, x.shape[-1])
        lo1 = xl @ adapter["a"]
        if rank_mask is not None:
            lo1 = lo1 * _per_lane(rank_mask, lo1, 1)
        lo = lo1 @ adapter["b"]
        lo = (_per_lane(scale, lo, 0) * lo).reshape(y.shape)
        y = y + lo.to(y.dtype)
    return y


def merge_delta(adapter: Adapter, scale: float) -> torch.Tensor:
    """Δθ = scale · A·B, shape (d_in, d_out) (or (L, d_in, d_out))."""
    return scale * (adapter["a"] @ adapter["b"])


def factors_from_svd(u: torch.Tensor, s: torch.Tensor, vt: torch.Tensor,
                     rank: int, scale: float) -> Adapter:
    """Truncated-SVD factors for client redistribution, the paper's split
    (Fig. 3): a = UΣ/scale, b = Vᵀ, so that scale·a·b is the
    rank-``rank`` truncation. Leading axes (a layer stack) pass through.
    """
    a = (u[..., :, :rank] * s[..., None, :rank]) / scale
    return {"a": a, "b": vt[..., :rank, :]}


def adapter_num_params(d_in: int, d_out: int, rank: int) -> int:
    return rank * (d_in + d_out)


def count_params(adapters: Any) -> int:
    """Elements over every tensor leaf of a tree."""
    if isinstance(adapters, dict):
        return sum(count_params(v) for v in adapters.values())
    if isinstance(adapters, (list, tuple)):
        return sum(count_params(v) for v in adapters)
    return int(adapters.numel())


# ---------------------------------------------------------------------------
# Rank padding: a rank-r adapter zero-padded to max_rank behaves exactly
# like the rank-r adapter (the tail contributes 0 to (x·A)·B), which is
# what lets one decode program serve every rank.
# ---------------------------------------------------------------------------

def _tree_paths(tree: Any) -> List[Tuple]:
    """Paths to adapter dicts (nodes holding 'a' and 'b')."""
    paths = []

    def rec(node, path):
        if isinstance(node, dict) and "a" in node and "b" in node:
            paths.append(tuple(path))
            return
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, path + [k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, path + [i])
    rec(tree, [])
    return paths


def _tree_get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _tree_set(tree, path, value):
    """Functional set (shallow-copies along the path)."""
    if not path:
        return value
    out = dict(tree) if isinstance(tree, dict) else list(tree)
    out[path[0]] = _tree_set(tree[path[0]], path[1:], value)
    return out if isinstance(tree, dict) else type(tree)(out)


def _map_adapters(adapters: Any, fn) -> Any:
    out = adapters
    for path in _tree_paths(adapters):
        out = _tree_set(out, path, fn(_tree_get(out, path)))
    return out


def rank_arange_mask(ranks, max_rank: int) -> torch.Tensor:
    """(..., max_rank) float mask: 1 where the rank index < ranks[...]."""
    ranks = torch.as_tensor(ranks)
    idx = torch.arange(max_rank, device=ranks.device)
    return (idx < ranks[..., None]).to(torch.float32)


def mask_adapter_tree(adapters: Any, mask: torch.Tensor) -> Any:
    """Zero the padded rank tail of every adapter in a tree.

    mask: (max_rank,) or (V, max_rank); with a leading axis the tree must
    carry a matching leading (V, ...) axis on every leaf. A-leaves are
    masked over their last axis, B-leaves over axis -2.
    """
    lead = mask.dim() - 1

    def mask_ad(ad):
        r = mask.shape[-1]
        ma = mask.reshape(mask.shape[:lead] + (1,) * (ad["a"].dim() - 1 - lead)
                          + (r,))
        mb = mask.reshape(mask.shape[:lead] + (1,) * (ad["b"].dim() - 2 - lead)
                          + (r, 1))
        return {"a": ad["a"] * ma.to(ad["a"].dtype),
                "b": ad["b"] * mb.to(ad["b"].dtype)}

    return _map_adapters(adapters, mask_ad)


def truncate_adapter_tree(adapters: Any, rank: int) -> Any:
    """Slice a (possibly padded) adapter tree down to ``rank``."""
    return _map_adapters(adapters, lambda ad: {"a": ad["a"][..., :rank],
                                               "b": ad["b"][..., :rank, :]})


def pad_adapter_tree(adapters: Any, max_rank: int) -> Any:
    """Zero-pad a rank-r adapter tree out to ``max_rank`` — the exact
    inverse of :func:`truncate_adapter_tree`."""
    rank = tree_rank(adapters)
    if rank > max_rank:
        raise ValueError(
            f"adapter rank {rank} exceeds slot width max_rank={max_rank}")
    if rank == max_rank:
        return adapters
    pad = max_rank - rank
    return _map_adapters(adapters, lambda ad: {
        "a": F.pad(ad["a"], (0, pad)),
        "b": F.pad(ad["b"], (0, 0, 0, pad))})


def tree_rank(adapters: Any) -> int:
    """Rank of an adapter tree: the last axis of its first 'a' leaf."""
    paths = _tree_paths(adapters)
    if not paths:
        raise ValueError("no adapter 'a' leaf found")
    return int(_tree_get(adapters, paths[0])["a"].shape[-1])
