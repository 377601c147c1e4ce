"""Plain PyTorch version of flash attention.

Op for op the reference's ``repro/kernels/flash_attention/ref.py::
attention_ref``: dense softmax attention with a GQA head-group broadcast,
q rows aligned to the end of the kv axis. On rows where every key is
masked (only possible when Sq > Sk) this averages v, where the kernel
returns 0; the flash route only runs with Sq == Sk, where no row is.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sliding_window: Optional[int] = None,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, Hkv, Sk, D). Returns (B, H, Sq, D)."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    rep = H // Hkv
    kf = torch.repeat_interleave(k.float(), rep, dim=1)
    vf = torch.repeat_interleave(v.float(), rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * sm_scale
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if sliding_window is not None:
        mask &= kpos > qpos - sliding_window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return out.to(q.dtype)
