"""Mixture-of-Experts with sort-based capacity dispatch, port of
``repro/models/moe.py``.

  1. router: logits (T, E) in f32 → softmax → top-k probs / ids,
     renormalized (1e-9 floor).
  2. sort the T·k assignments by expert id (stable); a slot is the rank
     within its expert; assignments past the capacity
     C = max(ceil(T·k/E · capacity_factor), 8) are dropped (they scatter
     zero into slot C−1 and gather zero).
  3. scatter into an (E, C, d) buffer; every expert runs over its whole
     capacity buffer, as in the reference (the expert GEMMs and their
     per-expert LoRA are plain batched products here, as they are
     ``einsum`` outside any Pallas kernel there).
  4. gather back to assignment order, weight by the router's probability,
     combine per token; shared experts run as a dense MLP for every token
     (``apply_mlp``, so through ``lora_matmul``).

Aux loss: switch-style load balance, ``router_aux_loss · E · Σ mean(probs)
· frac(top-1)``.

Lanes. The reference's serving engine and batched trainer ``vmap`` one
lane of this function, so each lane routes its own tokens against its own
capacity, with its own adapters. The port writes the lane axis out: when
the adapters are lane-batched (a per-expert leaf (V, E, d, r), or a
shared-expert leaf (V, d, r)), the rows of ``x`` are V lanes, lane-major,
and each lane is dispatched on its own, with its own adapters, scale and
rank mask; the aux loss then comes back per lane, (V,). A lane's tokens
never share a buffer with another lane's.

Precision: the per-expert low-rank term runs in f32 (the adapters' dtype)
and is cast to the expert GEMM's dtype before it is added, as
``apply_lora_linear`` does for a linear; under bf16 weights the reference
promotes the expert's output to f32 instead. In f32 the two agree.

Combining: each token's k weighted outputs are put back in assignment
order (a permutation, no collisions) and summed over k, so the result is
deterministic on the card (an atomic scatter-add would not be).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.lora import split_scale
from repro_torch.models.common import activation_fn, fan_in_init, is_glu
from repro_torch.models.mlp import apply_mlp, init_mlp

_ROUTED = ("w_up", "w_gate", "w_down")


def _stacked_init(gen: torch.Generator, layers, shape, dtype):
    """``fan_in_init`` of a stacked expert weight, one layer at a time: a
    whole stack's f32 draw would be the init's largest transient (grok-1's
    w_up is 6.4 GB of f32 a layer)."""
    if layers is None:
        return fan_in_init(gen, shape, dtype)
    out = torch.empty((layers,) + shape, dtype=dtype, device=gen.device)
    for i in range(layers):
        out[i] = fan_in_init(gen, shape, dtype)
    return out


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             layers: Optional[int] = None) -> Dict:
    m = cfg.moe
    d = cfg.d_model
    f = m.expert_d_ff or cfg.d_ff
    E = m.num_experts
    L = () if layers is None else (layers,)
    p = {
        "router": {"w": fan_in_init(gen, L + (d, E), dtype)},
        "w_up": _stacked_init(gen, layers, (E, d, f), dtype),
        "w_down": _stacked_init(gen, layers, (E, f, d), dtype),
    }
    if is_glu(cfg.activation):
        p["w_gate"] = _stacked_init(gen, layers, (E, d, f), dtype)
    if m.num_shared_experts:
        p["shared"] = init_mlp(gen, d, f * m.num_shared_experts,
                               cfg.activation, dtype, layers=layers)
    return p


def _dispatch_indices(top_ids: torch.Tensor, num_experts: int,
                      capacity: int, top_k: int) -> Tuple[torch.Tensor, ...]:
    """Sort-based dispatch bookkeeping.

    top_ids: (T, k) expert ids. Returns (token_idx, expert_idx, slot_idx,
    keep, order), each (T·k,), in sorted-by-expert order."""
    T = top_ids.shape[0]
    eid = top_ids.reshape(-1)
    order = torch.argsort(eid, stable=True)
    sorted_eid = eid[order]
    token_idx = order // top_k
    first = torch.searchsorted(sorted_eid, sorted_eid, side="left")
    slot = torch.arange(T * top_k, device=top_ids.device) - first
    keep = slot < capacity
    return token_idx, sorted_eid, slot, keep, order


def _lanes_of(ad: Dict) -> Optional[int]:
    """Lane count of lane-batched adapters, None when they (or their
    absence) are shared by every row."""
    for name in _ROUTED:
        a = ad.get(name)
        if a is not None:
            return a["a"].shape[0] if a["a"].dim() == 4 else None
    shared = ad.get("shared")
    if shared:
        a = next(iter(shared.values()))["a"]
        return a.shape[0] if a.dim() == 3 else None
    return None


def _lane(v, lane: int, lead: int):
    """Lane ``lane`` of a per-lane scale (lead 1) or mask (lead 2)."""
    if isinstance(v, torch.Tensor) and v.dim() == lead:
        return v[lane]
    return v


def _route(p, ad, xf, cfg: ModelConfig, scale, rank_mask):
    """The routed experts over one lane's tokens xf (T, d). Returns
    ((T, d) output, aux scalar)."""
    m = cfg.moe
    T, d = xf.shape
    E, k = m.num_experts, m.top_k
    act = activation_fn(cfg.activation)

    logits = (xf @ p["router"]["w"]).float()                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)                # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    capacity = max(int(math.ceil(T * k / E * m.capacity_factor)), 8)
    tok, eid, slot, keep, order = _dispatch_indices(top_i, E, capacity, k)

    keep_x = keep[:, None].to(xf.dtype)
    buf = torch.zeros((E, capacity, d), dtype=xf.dtype, device=xf.device)
    buf = buf.index_put((eid, torch.where(keep, slot, capacity - 1)),
                        xf[tok] * keep_x, accumulate=True)

    def lowrank(h, a):
        lo = torch.bmm(h.to(a["a"].dtype), a["a"])
        if rank_mask is not None:
            lo = lo * rank_mask
        return scale * torch.bmm(lo, a["b"])

    def expert_lin(w, name, h):
        y = torch.bmm(h, w)
        a = ad.get(name)
        if a is not None:
            y = y + lowrank(h, a).to(y.dtype)
        return y

    up = expert_lin(p["w_up"], "w_up", buf)
    if "w_gate" in p:
        h = act(expert_lin(p["w_gate"], "w_gate", buf)) * up
    else:
        h = act(up)
    out_e = expert_lin(p["w_down"], "w_down", h)               # (E, C, d)

    back = out_e[eid, torch.where(keep, slot, 0)] * keep_x     # (T·k, d)
    back = back * top_p.reshape(-1)[order].to(xf.dtype)[:, None]
    per_assign = torch.empty_like(back).index_put((order,), back)
    out = per_assign.reshape(T, k, d).sum(dim=1)

    me = probs.mean(dim=0)                                     # (E,)
    ce = torch.nn.functional.one_hot(top_i[:, 0], E).float().mean(dim=0)
    aux = m.router_aux_loss * E * torch.sum(me * ce)
    return out, aux


def apply_moe(p, adapters, x, cfg: ModelConfig, lora_scale
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (output (B, S, d), aux loss: a scalar, or (V,) for V
    lane-batched lanes; see the module docstring)."""
    B, S, d = x.shape
    ad = adapters or {}
    # MoE multiplies the scale numerically (unlike the linear stack, which
    # hands it on), so a (scale, rank_mask) pair is unpacked here
    scale, rank_mask = split_scale(lora_scale)
    xf = x.reshape(B * S, d)
    lanes = _lanes_of(ad)
    if lanes is None:
        out, aux = _route(p, ad, xf, cfg, scale, rank_mask)
    else:
        outs, auxes = [], []
        for v, xv in enumerate(xf.reshape(lanes, -1, d)):
            adv = {n: {"a": ad[n]["a"][v], "b": ad[n]["b"][v]}
                   for n in _ROUTED if ad.get(n) is not None}
            o, a = _route(p, adv, xv, cfg, _lane(scale, v, 1),
                          _lane(rank_mask, v, 2))
            outs.append(o)
            auxes.append(a)
        out, aux = torch.cat(outs), torch.stack(auxes)
    if "shared" in p:
        out = out + apply_mlp(p["shared"], ad.get("shared"), xf,
                              cfg.activation, lora_scale)
    return out.reshape(B, S, d), aux
