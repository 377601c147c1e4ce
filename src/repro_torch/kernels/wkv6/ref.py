"""Plain PyTorch versions of the WKV6 recurrence.

    S_t = diag(e^{logw_t})·S_{t-1} + k_t·v_tᵀ
    y_t = r_tᵀ·(S_{t-1} + diag(u)·k_t·v_tᵀ)

:func:`wkv6_chunked` is op for op the reference's
``repro/models/rwkv6.py::_wkv_chunked`` (the chunked form the Pallas
kernel also computes; its ``lax.scan`` over chunks is a loop here). It is
the CPU path of :func:`repro_torch.kernels.wkv6.ops.wkv6` and the
yardstick the CUDA kernel is held to on the card. Within a chunk it
divides by the cumulative decay (``k·e^{−cum}``), which overflows f32
once the decay summed over the chunk passes about −88: for a chunk of
128, a per-step log-decay below about −0.7.

:func:`wkv6_ref` is the reference's per-step scan
(``repro/kernels/wkv6/ref.py``): the test oracle, and the only yardstick
where the chunked form is not finite.
"""
from __future__ import annotations

from typing import Tuple

import torch


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logw: torch.Tensor, u: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6 from a zero state. r,k,v: (b,S,H,K); logw: (b,S,H,K)
    (≤0); u: (H,K); S a multiple of ``chunk``.

    Returns y (b,S,H,K) and final state (b,H,K,K) [K index, V index].
    """
    b, S, H, K = r.shape
    nc = S // chunk
    if nc * chunk != S:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    rs = lambda t: t.reshape(b, nc, chunk, H, K)
    rc, kc, vc, wc = rs(r), rs(k), rs(v), rs(logw)
    cum = torch.cumsum(wc, dim=2)                      # inclusive (b,nc,Q,H,K)
    cum_excl = cum - wc                                # exclusive

    # intra-chunk: y_t += Σ_{j<t} (r_t ⊙ exp(cum_excl_t - cum_j))·k_j · v_j
    #              + (r_t ⊙ u ⊙ k_t)·v_t (diagonal bonus)
    q_dec = rc * torch.exp(cum_excl)                   # r_t ⊙ W_{t-1}
    k_dec = kc * torch.exp(-cum)                       # k_j / W_j
    scores = torch.einsum("bcihk,bcjhk->bchij", q_dec, k_dec)
    i = torch.arange(chunk, device=r.device)
    mask = (i[:, None] > i[None, :]).to(scores.dtype)
    y_intra = torch.einsum("bchij,bcjhv->bcihv", scores * mask, vc)
    diag = torch.einsum("bcihk,bcihk->bcih", rc * u[None, None, None], kc)
    y_intra = y_intra + diag[..., None] * vc

    # chunk-final states: S_c = diag(exp(cum_Q)) S0 + Σ_j diag(exp(cum_Q-cum_j)) k_j v_jᵀ
    tail = cum[:, :, -1:, :, :] - cum                  # (b,nc,Q,H,K)
    st = torch.einsum("bcjhk,bcjhv->bchkv", kc * torch.exp(tail), vc)
    chunk_decay = torch.exp(cum[:, :, -1])             # (b,nc,H,K)

    prev = torch.zeros((b, H, K, K), dtype=torch.float32, device=r.device)
    prev_states = []
    for c in range(nc):
        prev_states.append(prev)
        prev = prev * chunk_decay[:, c, ..., None] + st[:, c]
    prev_states = torch.stack(prev_states, dim=1)      # (b,nc,H,K,K)

    # inter-chunk: y_t += (r_t ⊙ exp(cum_excl_t))ᵀ · S_prev
    y_off = torch.einsum("bcihk,bchkv->bcihv", q_dec, prev_states)
    y = (y_intra + y_off).reshape(b, S, H, K)
    return y, prev


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step scan from a zero state. r,k,v,logw: (B, S, H, K);
    u: (H, K). Returns (y (B,S,H,K), final state (B,H,K,K)), both f32."""
    B, S, H, K = r.shape
    rt, kt, vt, wt = (t.transpose(0, 1).float() for t in (r, k, v, logw))
    u = u.float()
    state = torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(S):
        kv = torch.einsum("bhk,bhv->bhkv", kt[t], vt[t])
        ys.append(torch.einsum("bhk,bhkv->bhv", rt[t],
                               state + u[None, ..., None] * kv))
        state = state * torch.exp(wt[t])[..., None] + kv
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((B, 0, H, K), dtype=torch.float32, device=r.device))
    return y, state
