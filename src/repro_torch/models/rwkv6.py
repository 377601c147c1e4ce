"""RWKV6 ("Finch") block — data-dependent decay linear attention
(arXiv:2404.05892). Port of ``repro/models/rwkv6.py``.

Per head (k-dim = v-dim = hd):
    S_t = diag(w_t)·S_{t-1} + k_t v_tᵀ
    y_t = r_tᵀ·(S_{t-1} + diag(u)·k_t v_tᵀ)
with w_t = exp(-exp(w0 + lora_w(x'_t))) data-dependent per channel.

Prefill runs the WKV recurrence through
:func:`repro_torch.kernels.wkv6.ops.wkv6`: the Hopper kernel on a card,
the chunked plain version on the CPU. The reference runs a sequence whose
length is not a multiple of 128 as ONE chunk of S, where ``k·e^{−cum}``
overflows f32 once the decay summed over the sequence passes about −88
(NaN outputs from S ≈ 250 at the init decays); the port chunks as the
reference's Pallas wrapper does (``min(128, S)``, padded), so its output
matches the reference wherever the reference is finite. Decode keeps the
(B, H, K, V) state and steps it with plain tensor code.

The functions return new state as the reference does; the caller
(``transformer._block_apply``) writes it into the cache in place.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, RWKVConfig
from repro_torch.core.lora import apply_lora_linear
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.models.common import apply_norm, fan_in_init, init_norm


def _dims(cfg: ModelConfig):
    r: RWKVConfig = cfg.rwkv
    nheads = cfg.d_model // r.head_dim
    return r, nheads


def init_rwkv6(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               layers: Optional[int] = None) -> Dict:
    r, _ = _dims(cfg)
    d, f = cfg.d_model, cfg.d_ff
    L = () if layers is None else (layers,)
    dev = gen.device

    def lin(di, do):
        return {"w": fan_in_init(gen, L + (di, do), dtype)}

    def mu():
        n = torch.randn(L + (d,), generator=gen, device=dev)
        return (0.5 + 0.1 * n).to(dtype)

    def stack(t):
        return t.expand(L + t.shape).clone()

    p = {
        # time-mix
        "mu_r": mu(), "mu_k": mu(), "mu_v": mu(), "mu_w": mu(), "mu_g": mu(),
        "w_r": lin(d, d), "w_k": lin(d, d), "w_v": lin(d, d),
        "w_o": lin(d, d),
        "gate_a": fan_in_init(gen, L + (d, r.gate_lora), dtype),
        "gate_b": fan_in_init(gen, L + (r.gate_lora, d), dtype),
        "w0": stack(torch.linspace(-6.0, -1.0, d, device=dev)).to(dtype),
        "decay_a": fan_in_init(gen, L + (d, r.decay_lora), dtype),
        "decay_b": torch.zeros(L + (r.decay_lora, d), dtype=dtype,
                               device=dev),
        "u_bonus": (0.1 * torch.randn(L + (d,), generator=gen, device=dev)
                    ).to(dtype),
        "ln_x": {k: stack(v) for k, v in
                 init_norm("layernorm", d, dtype, dev).items()},
        # channel-mix
        "mu_ck": mu(), "mu_cr": mu(),
        "ck": lin(d, f), "cv": lin(f, d), "cr": lin(d, d),
    }
    return p


def _token_shift(x, mu, last=None):
    """lerp(x_{t-1}, x_t, mu). last: (b, d) previous token for decode."""
    if last is None:
        prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    else:
        prev = torch.cat([last[:, None, :], x[:, :-1]], dim=1)
    return prev + mu * (x - prev)


def _wkv_step(r, k, v, logw, u, state):
    """Single decode step. r,k,v,logw: (b,H,K); state: (b,H,K,V)."""
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    y = torch.einsum("bhk,bhkv->bhv", r, state + u[None, ..., None] * kv)
    new_state = state * torch.exp(logw)[..., None] + kv
    return y, new_state


def apply_rwkv6_timemix(p, adapters, x, cfg: ModelConfig, lora_scale,
                        state=None):
    """state: {"wkv": (b,H,K,K), "last": (b,d)} or None for prefill.
    Returns (out, new_state) with new_state {"wkv", "last"} or None."""
    r_cfg, H = _dims(cfg)
    b, S, d = x.shape
    K = r_cfg.head_dim
    ad = adapters or {}
    last = None if state is None else state["last"]

    def mix(mu):
        return _token_shift(x, mu, last)

    xr, xk, xv, xw, xg = (mix(p["mu_r"]), mix(p["mu_k"]), mix(p["mu_v"]),
                          mix(p["mu_w"]), mix(p["mu_g"]))
    r = apply_lora_linear(p["w_r"], ad.get("w_r"), xr, lora_scale)
    k = apply_lora_linear(p["w_k"], ad.get("w_k"), xk, lora_scale)
    v = apply_lora_linear(p["w_v"], ad.get("w_v"), xv, lora_scale)
    g = F.silu(xg @ p["gate_a"]) @ p["gate_b"]
    logw = -torch.exp(
        (p["w0"] + torch.tanh(xw @ p["decay_a"]) @ p["decay_b"]
         ).float())                                    # (b,S,d), ≤ 0

    # r, k, v in the activations' dtype and logw in f32, not copied: the
    # kernel widens them to f32 itself and rounds y to r's dtype once
    rh, kh, vh, wh = (t.reshape(b, S, H, K).contiguous()
                      for t in (r, k, v, logw))
    u = p["u_bonus"].float().reshape(H, K)

    if state is None:
        y, _ = wkv6(rh, kh, vh, wh, u)         # chunks of min(128, S)
        new_state = None
    else:
        y, wkv = _wkv_step(rh[:, 0].float(), kh[:, 0].float(),
                           vh[:, 0].float(), wh[:, 0], u, state["wkv"])
        y = y[:, None]
        new_state = {"wkv": wkv, "last": x[:, -1, :]}

    y = y.reshape(b, S, d).to(x.dtype)
    y = apply_norm(p["ln_x"], y, "layernorm")
    y = y * F.silu(g)
    out = apply_lora_linear(p["w_o"], ad.get("w_o"), y, lora_scale)
    return out, new_state


def apply_rwkv6_channelmix(p, adapters, x, cfg: ModelConfig, lora_scale,
                           state=None):
    """Returns (out, new_last) with new_last (b, d), or None for prefill."""
    ad = adapters or {}
    last = None if state is None else state.get("last_cm")
    xk = _token_shift(x, p["mu_ck"], last)
    xr = _token_shift(x, p["mu_cr"], last)
    kk = apply_lora_linear(p["ck"], ad.get("ck"), xk, lora_scale)
    kk = torch.square(F.relu(kk))
    vv = apply_lora_linear(p["cv"], ad.get("cv"), kk, lora_scale)
    rr = torch.sigmoid(
        apply_lora_linear(p["cr"], ad.get("cr"), xr, lora_scale))
    new_last = None if state is None else x[:, -1, :]
    return rr * vv, new_last


def init_rwkv6_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cpu") -> Dict[str, torch.Tensor]:
    r, H = _dims(cfg)
    return {
        "wkv": torch.zeros((batch, H, r.head_dim, r.head_dim),
                           dtype=torch.float32, device=device),
        "last": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        "last_cm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                               device=device),
    }
