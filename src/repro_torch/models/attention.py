"""Attention with LoRA hooks and a ring-buffer KV cache: GQA/MQA and
DeepSeek-V2's multi-head latent attention (MLA).

Port of ``repro/models/attention.py``. Routes (:func:`attention_path`), in precedence order:

  'decode' — one query token against the cache: one grouped product, no
             GQA head repeat (plain tensor code, as in the reference)
  'flash'  — the causal, aligned full-sequence case (prefill): the
             ``flash_attention`` kernel on a card, its plain version on
             the CPU
  'direct' — other short sequences: materialized (Sq, Sk) scores
  'blocked'— everything else (Sq != Sk past ``DIRECT_ATTN_MAX_SEQ``, a
             logits softcap, hd_k != hd_v, decode with ``FAST_DECODE``
             off): the reference's blocked online-softmax route over
             ``KV_BLOCK``-key blocks, plain tensor code on every device
             (the reference computes it in jnp, outside any kernel)

Decode lanes carry their own positions: q_positions is (B, Sq), and each
lane writes its new keys at its own ring slot ``position % Sc`` and
rotates them by its own angle. The cache is updated in place.

MLA's q/k head dim (nope + rope, 192 at full width) differs from its v
head dim (128), so it never takes the flash route: a prefill goes
``direct`` or ``blocked`` and decode goes ``decode``, as in the reference.
It caches the latent ``(c_kv, k_rope, pos)`` and up-projects the whole
cache to per-head keys and values at every step, as the reference does.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.config import MLAConfig, ModelConfig
from repro_torch.core.lora import apply_lora_linear
from repro_torch.models import runmode
from repro_torch.models.common import apply_rope, fan_in_init

KV_BLOCK = 512

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32, layers: Optional[int] = None) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    L = () if layers is None else (layers,)

    def lin(di, do, bias):
        p = {"w": fan_in_init(gen, L + (di, do), dtype)}
        if bias:
            p["b"] = torch.zeros(L + (do,), dtype=dtype, device=gen.device)
        return p

    return {
        "q": lin(d, nq * hd, cfg.qkv_bias),
        "k": lin(d, nkv * hd, cfg.qkv_bias),
        "v": lin(d, nkv * hd, cfg.qkv_bias),
        "o": lin(nq * hd, d, False),
    }


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def _direct_attend(q, k, v, *, causal, q_positions, kv_positions,
                   sliding_window, sm_scale, cap=0.0):
    """Unblocked attention: one grouped score product, masked softmax,
    one value product. Empty ring slots carry position -1."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    hd_v = v.shape[-1]
    rep = H // Hkv
    qg = q.reshape(B, Sq, Hkv, rep, hd).float()
    s = torch.einsum("bqhrd,bkhd->bqhrk", qg, k.float()) * sm_scale
    if cap:
        s = cap * torch.tanh(s / cap)
    kvp = kv_positions[:, None, :]
    qp = q_positions[:, :, None]
    mask = kvp >= 0
    if causal:
        mask = mask & (kvp <= qp)
    if sliding_window is not None:
        mask = mask & (kvp > qp - sliding_window)
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhrk,bkhd->bqhrd", p, v.float())
    return out.reshape(B, Sq, H, hd_v).to(q.dtype)


def _flash_body(q, k, v, mask_fn, sm_scale, cap=0.0):
    """Blockwise online-softmax attention, the reference's ``_flash_body``.

    q: (B, Sq, H, hd_k); k: (B, Sk, Hkv, hd_k); v: (B, Sk, Hkv, hd_v).
    ``mask_fn(kv_pos)`` gives the (B, Sq, KV_BLOCK) visibility of the
    block's keys at kv-axis indices ``kv_pos``. The kv axis is zero-padded
    to whole blocks and the (acc, m, l) state runs over the blocks in
    order. Masked scores are the finite ``NEG_INF``, as in the reference,
    so a row whose every key is masked averages its values over all the
    padded slots instead of giving NaN. Returns (B, Sq, H, hd_v).
    """
    B, Sq, H, hd_k = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    rep = H // Hkv
    nblk = max(1, (Sk + KV_BLOCK - 1) // KV_BLOCK)
    pad = nblk * KV_BLOCK - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qf = q.float()
    acc = torch.zeros((B, Sq, H, hd_v), dtype=torch.float32, device=q.device)
    m = torch.full((B, Sq, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, H), dtype=torch.float32, device=q.device)
    for blk in range(nblk):
        k0 = blk * KV_BLOCK
        kf = k[:, k0:k0 + KV_BLOCK].float()
        vf = v[:, k0:k0 + KV_BLOCK].float()
        if rep > 1:
            kf = kf.repeat_interleave(rep, dim=2)
            vf = vf.repeat_interleave(rep, dim=2)
        s = torch.einsum("bqhd,bkhd->bqhk", qf, kf) * sm_scale
        if cap:
            s = cap * torch.tanh(s / cap)
        kv_pos = k0 + torch.arange(KV_BLOCK, device=q.device)
        msk = mask_fn(kv_pos) & (kv_pos < Sk)[None, None, :]
        s = torch.where(msk[:, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        acc = acc * corr[..., None] + torch.einsum("bqhk,bkhd->bqhd", p, vf)
        l = l * corr + p.sum(dim=-1)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype)


def attention_path(*, causal: bool, Sq: int, Sk: int, cap: float = 0.0,
                   hd_k: Optional[int] = None,
                   hd_v: Optional[int] = None) -> str:
    """Which route :func:`attend` takes (see the module docstring)."""
    if Sq == 1 and causal and runmode.FAST_DECODE:
        return "decode"
    if causal and Sq == Sk and cap == 0.0 and (hd_k is None or hd_k == hd_v):
        return "flash"
    if Sq > 1 and max(Sq, Sk) <= runmode.DIRECT_ATTN_MAX_SEQ:
        return "direct"
    return "blocked"


def attend(q, k, v, *, causal: bool, q_positions, kv_positions=None,
           sliding_window: Optional[int] = None, sm_scale=None, cap=0.0):
    """Generic attention. q: (B,Sq,H,hd), k/v: (B,Sk,Hkv,hd).

    q_positions: (B, Sq) absolute positions of queries.
    kv_positions: (B, Sk) absolute positions of keys (default arange).
    The flash route takes positions as aranges with q aligned to the kv
    end, as the reference's kernel route does.
    """
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    if kv_positions is None:
        kv_positions = torch.arange(Sk, device=q.device)[None].expand(B, Sk)
    path = attention_path(causal=causal, Sq=Sq, Sk=Sk, cap=cap,
                          hd_k=k.shape[-1], hd_v=v.shape[-1])
    if path == "flash":
        from repro_torch.kernels.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=True,
                               sliding_window=sliding_window,
                               sm_scale=sm_scale)
    if path in ("decode", "direct"):
        return _direct_attend(q, k, v, causal=causal,
                              q_positions=q_positions,
                              kv_positions=kv_positions,
                              sliding_window=sliding_window,
                              sm_scale=sm_scale, cap=cap)

    def mask_fn(kv_pos):
        # kv_pos: (KV_BLOCK,) indices into the kv axis; the padded tail
        # reads the last key's position and is masked by the caller
        kp = kv_positions[:, kv_pos.clamp(0, Sk - 1)][:, None, :]
        msk = (kp >= 0).expand(B, Sq, kv_pos.shape[0])   # empty slots: -1
        if causal:
            msk = msk & (kp <= q_positions[:, :, None])
        if sliding_window is not None:
            msk = msk & (kp > q_positions[:, :, None] - sliding_window)
        return msk

    return _flash_body(q, k, v, mask_fn, sm_scale, cap)


def apply_attention(p, adapters, x, cfg: ModelConfig, lora_scale,
                    positions, cache=None, cache_index=None,
                    sliding_window=None):
    """Self-attention with optional LoRA adapters and KV cache.

    positions: (B, S). cache: dict(k=(B,Sc,Hkv,hd), v=..., pos=(B,Sc)),
    written IN PLACE at slots ``(cache_index[b] + s) % Sc``; cache_index
    is (B,), one ring slot per lane. Returns (out, cache_or_None).
    """
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    ad = adapters or {}
    q = apply_lora_linear(p["q"], ad.get("q"), x, lora_scale)
    k = apply_lora_linear(p["k"], ad.get("k"), x, lora_scale)
    v = apply_lora_linear(p["v"], ad.get("v"), x, lora_scale)
    q = apply_rope(_split_heads(q, nq, hd), positions, cfg.rope_theta)
    k = apply_rope(_split_heads(k, nkv, hd), positions, cfg.rope_theta)
    v = _split_heads(v, nkv, hd)

    if cache is not None:
        Sc = cache["k"].shape[1]
        idx = (cache_index[:, None]
               + torch.arange(S, device=x.device)[None]) % Sc      # (B, S)
        lanes = torch.arange(B, device=x.device)[:, None]
        cache["k"][lanes, idx] = k.to(cache["k"].dtype)
        cache["v"][lanes, idx] = v.to(cache["v"].dtype)
        cache["pos"][lanes, idx] = positions.to(cache["pos"].dtype)
        out = attend(q, cache["k"], cache["v"], causal=True,
                     q_positions=positions, kv_positions=cache["pos"],
                     sliding_window=sliding_window)
    else:
        out = attend(q, k, v, causal=True, q_positions=positions,
                     sliding_window=sliding_window)
    out = out.reshape(B, S, nq * hd)
    out = apply_lora_linear(p["o"], ad.get("o"), out, lora_scale)
    return out, cache


def init_cache(cfg: ModelConfig, batch: int, length: int,
               dtype=torch.bfloat16, device="cpu"):
    hd = cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, length, cfg.num_kv_heads, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, length, cfg.num_kv_heads, hd), dtype=dtype,
                         device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32,
                          device=device),
    }


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V2 multi-head latent attention
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             layers: Optional[int] = None) -> Dict:
    m: MLAConfig = cfg.mla
    d, nq = cfg.d_model, cfg.num_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    L = () if layers is None else (layers,)

    def lin(di, do):
        return {"w": fan_in_init(gen, L + (di, do), dtype)}

    p = {
        "kv_down": lin(d, m.kv_lora_rank + m.qk_rope_head_dim),
        "kv_up": lin(m.kv_lora_rank,
                     nq * (m.qk_nope_head_dim + m.v_head_dim)),
        "o": lin(nq * m.v_head_dim, d),
    }
    if m.q_lora_rank:
        p["q_down"] = lin(d, m.q_lora_rank)
        p["q_up"] = lin(m.q_lora_rank, nq * qk_dim)
    else:
        p["q"] = lin(d, nq * qk_dim)
    return p


def apply_mla(p, adapters, x, cfg: ModelConfig, lora_scale, positions,
              cache=None, cache_index=None, sliding_window=None):
    """MLA forward. The latent KV (c_kv, k_rope) is what gets cached —
    rank-compressed (kv_lora_rank), the low-rank structure the paper's
    method exploits. cache: dict(c_kv=(B, Sc, kv_lora_rank),
    k_rope=(B, Sc, rope), pos=(B, Sc)), written IN PLACE at slots
    ``(cache_index[b] + s) % Sc``. Returns (out, cache_or_None)."""
    m: MLAConfig = cfg.mla
    B, S, _ = x.shape
    nq = cfg.num_heads
    ad = adapters or {}

    if "q" in p:
        q = apply_lora_linear(p["q"], ad.get("q"), x, lora_scale)
    else:
        qd = apply_lora_linear(p["q_down"], ad.get("q_down"), x, lora_scale)
        q = apply_lora_linear(p["q_up"], ad.get("q_up"), qd, lora_scale)
    q = q.reshape(B, S, nq, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = torch.split(
        q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kvd = apply_lora_linear(p["kv_down"], ad.get("kv_down"), x, lora_scale)
    c_kv, k_rope = torch.split(
        kvd, [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]              # (B, S, rope)

    if cache is not None:
        Sc = cache["c_kv"].shape[1]
        idx = (cache_index[:, None]
               + torch.arange(S, device=x.device)[None]) % Sc      # (B, S)
        lanes = torch.arange(B, device=x.device)[:, None]
        cache["c_kv"][lanes, idx] = c_kv.to(cache["c_kv"].dtype)
        cache["k_rope"][lanes, idx] = k_rope.to(cache["k_rope"].dtype)
        cache["pos"][lanes, idx] = positions.to(cache["pos"].dtype)
        c_kv_all, k_rope_all, kv_pos = (cache["c_kv"], cache["k_rope"],
                                        cache["pos"])
    else:
        c_kv_all, k_rope_all, kv_pos = c_kv, k_rope, None

    # up-project the latent to per-head K (nope) and V
    kv = apply_lora_linear(p["kv_up"], ad.get("kv_up"),
                           c_kv_all.to(x.dtype), lora_scale)
    kv = kv.reshape(B, -1, nq, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = torch.split(kv, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k_rope_b = k_rope_all[:, :, None, :].to(x.dtype).expand(
        B, k_nope.shape[1], nq, m.qk_rope_head_dim)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1)

    sm_scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    out = attend(qq, k, v, causal=True, q_positions=positions,
                 kv_positions=kv_pos, sliding_window=sliding_window,
                 sm_scale=sm_scale)
    out = out.reshape(B, S, nq * m.v_head_dim)
    out = apply_lora_linear(p["o"], ad.get("o"), out, lora_scale)
    return out, cache


def init_mla_cache(cfg: ModelConfig, batch: int, length: int,
                   dtype=torch.bfloat16, device="cpu"):
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, length, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, length, m.qk_rope_head_dim),
                              dtype=dtype, device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32,
                          device=device),
    }
