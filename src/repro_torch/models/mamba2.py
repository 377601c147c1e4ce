"""Mamba2 (SSD) block — chunked state-space dual form (arXiv:2405.21060).
Port of ``repro/models/mamba2.py``.

The chunked SSD form turns the recurrence into dense intra-chunk einsums
plus an O(S/chunk) recurrence over chunk states; one B/C group is shared
across heads. The reference computes the SSD in jnp, outside any Pallas
kernel, so it stays plain PyTorch here (einsums in f32); only
``in_proj`` and ``out_proj`` go through
:func:`~repro_torch.core.lora.apply_lora_linear` (the ``lora_matmul``
kernel on a card). The reference's ``lax.scan`` over chunks is a Python
loop.

A prefill (``state=None``) returns no state, as the reference's does:
serving teacher-forces prompts through decode steps. Decode (S == 1)
keeps a constant-size state, ssm (B, H, P, N) in f32 and the conv tail
(B, W-1, conv_channels), and returns the new one; the caller
(``transformer._block_apply``) writes it into the cache in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, SSMConfig
from repro_torch.core.lora import apply_lora_linear
from repro_torch.models.common import fan_in_init


def _dims(cfg: ModelConfig):
    s: SSMConfig = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.state_dim
    return s, d_in, nheads, conv_ch


def _per_head(values: np.ndarray, L, dtype, device) -> torch.Tensor:
    """A deterministic (H,) leaf, broadcast over the layer stack: computed
    in float64 and rounded once to f32, then cast to ``dtype``."""
    t = torch.from_numpy(values.astype(np.float32)).to(device=device)
    return t.expand(L + t.shape).clone().to(dtype)


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                layers: Optional[int] = None) -> Dict:
    s, d_in, nheads, conv_ch = _dims(cfg)
    d = cfg.d_model
    dev = gen.device
    L = () if layers is None else (layers,)
    proj_out = 2 * d_in + 2 * s.state_dim + nheads   # z, x, B, C, dt
    in_w = fan_in_init(gen, L + (d, proj_out), dtype)
    conv_w = torch.randn(L + (s.conv_width, conv_ch), generator=gen,
                         device=dev)
    return {
        "in_proj": {"w": in_w},
        "conv_w": conv_w.mul_(0.1).to(dtype),
        "conv_b": torch.zeros(L + (conv_ch,), dtype=dtype, device=dev),
        "a_log": _per_head(np.log(np.linspace(1.0, 16.0, nheads)), L, dtype,
                           dev),
        "d_skip": torch.ones(L + (nheads,), dtype=dtype, device=dev),
        "dt_bias": _per_head(np.log(np.expm1(np.linspace(1e-3, 0.1,
                                                         nheads))),
                             L, dtype, dev),
        "out_proj": {"w": fan_in_init(gen, L + (d_in, d), dtype)},
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """log-space segment sums: out[..., i, j] = sum_{s=j+1..i} a[..., s].

    a: (..., Q). Returns (..., Q, Q) lower-triangular (−inf above diag).
    """
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(Q, device=a.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, seg, float("-inf"))


def _ssd_chunked(x, dt, a_log, B, C, chunk: int):
    """Chunked SSD. x: (b,S,H,P); dt: (b,S,H); B,C: (b,S,N).

    Returns y (b,S,H,P) and final state (b,H,P,N), both f32.
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    nc = S // chunk
    if nc * chunk != S:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    A = -torch.exp(a_log.float())                            # (H,) negative
    dtf = dt.float()
    da = dtf * A[None, None, :]                    # (b,S,H) log-decay
    xb = (x * dtf[..., None]).float()                        # fold dt into x

    xc = xb.reshape(b, nc, chunk, H, P)
    dac = da.reshape(b, nc, chunk, H)
    Bc = B.float().reshape(b, nc, chunk, N)
    Cc = C.float().reshape(b, nc, chunk, N)

    # intra-chunk (diagonal blocks):
    # y_intra[t] = Σ_{j<=t} exp(seg) C_t·B_j x_j
    Ld = torch.exp(_segsum(dac.permute(0, 1, 3, 2)))         # (b,nc,H,Q,Q)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)         # (b,nc,Q,Q)
    y_intra = torch.einsum("bcls,bchls,bcshp->bclhp", scores, Ld, xc)

    # chunk-final states: S_c = Σ_j exp(Σ_{s>j} da) B_j x_j
    cum = torch.cumsum(dac, dim=2)                           # (b,nc,Q,H)
    tail = cum[:, :, -1:, :] - cum                 # decay j→chunk end
    st = torch.einsum("bcsn,bcsh,bcshp->bchpn", Bc, torch.exp(tail), xc)

    # inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (b,nc,H)
    prev = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    prevs = []
    for c in range(nc):
        prevs.append(prev)
        prev = prev * chunk_decay[:, c, :, None, None] + st[:, c]
    prev_states = torch.stack(prevs, dim=1)                  # (b,nc,H,P,N)

    # inter-chunk contribution: y_off[t] = exp(cum[t]) C_t · S_prev
    y_off = torch.einsum("bcln,bclh,bchpn->bclhp", Cc, torch.exp(cum),
                         prev_states)
    return (y_intra + y_off).reshape(b, S, H, P), prev


def _causal_conv(xBC, w, bias, conv_state=None):
    """Depthwise causal conv. xBC: (b,S,C); w: (W,C). Returns the SiLU of
    the conv and the new tail (the last W-1 inputs, or None at W 1)."""
    W = w.shape[0]
    S = xBC.shape[1]
    if conv_state is None:
        pad = torch.zeros((xBC.shape[0], W - 1, xBC.shape[2]),
                          dtype=xBC.dtype, device=xBC.device)
    else:
        pad = conv_state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)
    new_state = xp[:, -(W - 1):, :] if W > 1 else None
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    return F.silu(out + bias[None, None, :]), new_state


def apply_mamba2(p, adapters, x, cfg: ModelConfig, lora_scale,
                 state=None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (b,S,d). state: {"ssm": (b,H,P,N), "conv": (b,W-1,C)} for a
    decode step (S == 1). LoRA targets in_proj and out_proj."""
    s, d_in, nheads, conv_ch = _dims(cfg)
    b, S, d = x.shape
    N = s.state_dim
    ad = adapters or {}
    zxbcdt = apply_lora_linear(p["in_proj"], ad.get("in_proj"), x, lora_scale)
    z, xr, B, C, dt = torch.split(zxbcdt, [d_in, d_in, N, N, nheads], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())

    xBC = torch.cat([xr, B, C], dim=-1)
    conv_state = None if state is None else state["conv"]
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    xr, B, C = torch.split(xBC, [d_in, N, N], dim=-1)
    xh = xr.reshape(b, S, nheads, s.head_dim)

    if state is None:
        # the reference's rule: whole chunks when S divides, else one
        # chunk of S (the decays are negative, so nothing overflows)
        chunk = s.chunk if S % s.chunk == 0 and S >= s.chunk else S
        y, _ = _ssd_chunked(xh, dt, p["a_log"], B, C, chunk)
        new_state = None
    else:
        # single-step decode: S == 1
        A = -torch.exp(p["a_log"].float())
        da = torch.exp(dt[:, 0] * A[None, :])                # (b,H)
        xb = xh[:, 0].float() * dt[:, 0][..., None]
        new_ssm = (state["ssm"] * da[..., None, None]
                   + torch.einsum("bn,bhp->bhpn", B[:, 0].float(), xb))
        y = torch.einsum("bn,bhpn->bhp", C[:, 0].float(), new_ssm)[:, None]
        new_state = {"ssm": new_ssm, "conv": new_conv}

    y = y + xh.float() * p["d_skip"].float()[None, None, :, None]
    y = (y.reshape(b, S, d_in) * F.silu(z.float())).to(x.dtype)
    out = apply_lora_linear(p["out_proj"], ad.get("out_proj"), y, lora_scale)
    return out, new_state


def init_mamba2_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                      device="cpu") -> Dict:
    s, d_in, nheads, conv_ch = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, nheads, s.head_dim, s.state_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
    }
