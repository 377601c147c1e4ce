"""MLP blocks: SwiGLU / GeGLU / plain GELU / relu² — with LoRA hooks."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.lora import apply_lora_linear
from repro_torch.models.common import activation_fn, fan_in_init, is_glu


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype=torch.float32, layers: Optional[int] = None) -> Dict:
    L = () if layers is None else (layers,)
    p = {"up": {"w": fan_in_init(gen, L + (d_model, d_ff), dtype)}}
    if is_glu(activation):
        p["gate"] = {"w": fan_in_init(gen, L + (d_model, d_ff), dtype)}
    p["down"] = {"w": fan_in_init(gen, L + (d_ff, d_model), dtype)}
    return p


def apply_mlp(p, adapters, x, activation: str, lora_scale):
    ad = adapters or {}
    act = activation_fn(activation)
    up = apply_lora_linear(p["up"], ad.get("up"), x, lora_scale)
    if "gate" in p:
        gate = apply_lora_linear(p["gate"], ad.get("gate"), x, lora_scale)
        h = act(gate) * up
    else:
        h = act(up)
    return apply_lora_linear(p["down"], ad.get("down"), h, lora_scale)
