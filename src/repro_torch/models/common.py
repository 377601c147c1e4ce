"""Shared model building blocks: norms, RoPE, initializers, activations.

Plain functions on tensors and plain dicts of tensors, as in the reference
(``repro/models/common.py``). Inits draw from an explicit
``torch.Generator``; they do not reproduce ``jax.random`` draws, so tests
carry weights across with :mod:`repro_torch.interop` instead.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# dtype helpers
# ---------------------------------------------------------------------------


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def normal_init(gen: torch.Generator, shape, scale=0.02,
                dtype=torch.float32) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device)
    return (scale * x).to(dtype)


def fan_in_init(gen: torch.Generator, shape,
                dtype=torch.float32) -> torch.Tensor:
    """LeCun-normal on the penultimate axis (in-features)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    x = torch.randn(shape, generator=gen, device=gen.device)
    # in place: one f32 draw of the leaf lives at a time (starcoder2-15b's
    # stacked up-projection is 24 GB of it)
    return x.div_(math.sqrt(fan_in)).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(kind: str, dim: int, dtype=torch.float32, device="cpu"):
    if kind == "rmsnorm":
        return {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((dim,), dtype=dtype, device=device),
                "bias": torch.zeros((dim,), dtype=dtype, device=device)}
    raise ValueError(kind)


def apply_norm(p, x: torch.Tensor, kind: str, eps: float = 1e-6):
    """Computed in f32 and cast back to x's dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = ((xf - mu) * torch.rsqrt(var + eps) * p["scale"].float()
             + p["bias"].float())
    else:
        raise ValueError(kind)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    # theta stays a Python scalar: a tensor made from it would be a host
    # to device copy, which stalls the host until the device catches up
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-halves RoPE. x: (..., S, H, hd); positions: (..., S), one
    position per query row (so each decode lane rotates by its own)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., :, None].float() * freqs            # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def activation_fn(name: str):
    if name in ("swiglu",):
        return F.silu
    if name in ("geglu", "gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu_sq":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


def is_glu(name: str) -> bool:
    return name in ("swiglu", "geglu")


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
    return x
