"""Decoder model of the port: ``attn``, ``mla``, ``mamba2`` and ``rwkv6``
segments, with a dense MLP or a mixture of experts, and zamba2's shared
attention block.

Port of ``repro/models/transformer.py`` for GQA/MQA decoders (dense or
MoE, grok-style), DeepSeek-V2's MLA + MoE blocks, RWKV6 stacks and
zamba2's Mamba2 stack, whose one shared transformer block (unstacked
params and adapters, ``params["shared_attn"]``) runs after every
``shared_attn_every`` mamba layers and not after the remainder. A VLM's
or an audio model's frontend is a stub, as in the reference: the caller
hands ``prefix_embeds`` (B, P, d) to :func:`forward` / :func:`loss_fn`,
and they are prepended to the token embeddings. The tree layout is the
reference's: consecutive blocks of one
kind form a segment whose parameters are stacked on a leading layer axis,
under the same key names, so weights carry across one to one
(:mod:`repro_torch.interop`). The reference's ``lax.scan`` over layers is
a Python loop here.

Public API:
    init_params(cfg, *, seed, dtype, device)          -> params tree
    init_adapters(cfg, lora, *, seed, rank, device)   -> LoRA adapter tree
    forward(params, adapters, cfg, lora, batch)       -> (logits, aux)
    decode_step(params, adapters, cfg, lora, token, caches, position)
    decode_step_paged(params, adapters, cfg, lora, token, state_caches,
                      pools, tables, position)
    init_caches(cfg, batch, cache_len, dtype, device)
    loss_fn(params, adapters, cfg, lora, batch)       -> (loss, metrics)
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import (BLOCK_ATTN, BLOCK_MAMBA2, BLOCK_MLA,
                                BLOCK_RWKV6, LoRAConfig, ModelConfig)
from repro_torch.core import lora as lora_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models.common import (apply_norm, dtype_of, init_norm,
                                       is_glu, normal_init, softcap)
from repro_torch.models.runmode import resolve_device


# ---------------------------------------------------------------------------
# Segments
# ---------------------------------------------------------------------------

def segments_of(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """[(kind, n_layers), ...] — consecutive runs of the same block kind."""
    segs: List[Tuple[str, int]] = []
    for kind in cfg.blocks():
        if segs and segs[-1][0] == kind:
            segs[-1] = (kind, segs[-1][1] + 1)
        else:
            segs.append((kind, 1))
    return segs


def _layer(tree: Any, i: int) -> Any:
    """Layer i of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _stack_norm(kind, dim, dtype, layers, device):
    return {k: v.expand((layers,) + v.shape).clone()
            for k, v in init_norm(kind, dim, dtype, device).items()}


def _init_block(gen, kind: str, cfg: ModelConfig, dtype, layers: int
                ) -> Dict:
    if kind == BLOCK_RWKV6:
        return {
            "norm1": _stack_norm("layernorm", cfg.d_model, dtype, layers,
                                 gen.device),
            "norm2": _stack_norm("layernorm", cfg.d_model, dtype, layers,
                                 gen.device),
            "rwkv": rwkv_lib.init_rwkv6(gen, cfg, dtype, layers=layers),
        }
    if kind == BLOCK_MAMBA2:
        return {
            "norm": _stack_norm(cfg.norm, cfg.d_model, dtype, layers,
                                gen.device),
            "mamba": mamba_lib.init_mamba2(gen, cfg, dtype, layers=layers),
        }
    if kind not in (BLOCK_ATTN, BLOCK_MLA):
        raise ValueError(kind)
    p = {"norm1": _stack_norm(cfg.norm, cfg.d_model, dtype, layers,
                              gen.device)}
    if kind == BLOCK_MLA:
        p["mla"] = attn_lib.init_mla(gen, cfg, dtype, layers=layers)
    else:
        p["attn"] = attn_lib.init_attention(gen, cfg, dtype, layers=layers)
    p["norm2"] = _stack_norm(cfg.norm, cfg.d_model, dtype, layers, gen.device)
    if cfg.moe is not None:
        p["moe"] = moe_lib.init_moe(gen, cfg, dtype, layers=layers)
    else:
        p["mlp"] = mlp_lib.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                    cfg.activation, dtype, layers=layers)
    return p


def init_params(cfg: ModelConfig, *, seed: int = 0, dtype=None,
                device="cuda") -> Dict:
    """Seeded random weights in the reference's tree layout."""
    dev = resolve_device(device)
    dtype = dtype or dtype_of(cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: Dict[str, Any] = {
        "embed": normal_init(gen, (cfg.vocab_size, cfg.d_model), dtype=dtype),
        "final_norm": init_norm(cfg.norm, cfg.d_model, dtype, dev),
        "segments": [_init_block(gen, kind, cfg, dtype, n)
                     for kind, n in segments_of(cfg)],
    }
    if cfg.shared_attn_every:
        # zamba2: one shared transformer block (unstacked), reused
        params["shared_attn"] = {
            "norm1": init_norm(cfg.norm, cfg.d_model, dtype, dev),
            "attn": attn_lib.init_attention(gen, cfg, dtype),
            "norm2": init_norm(cfg.norm, cfg.d_model, dtype, dev),
            "mlp": mlp_lib.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                    cfg.activation, dtype),
        }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": normal_init(
            gen, (cfg.d_model, cfg.vocab_size), dtype=dtype)}
    return params


# ---------------------------------------------------------------------------
# LoRA adapters
# ---------------------------------------------------------------------------

def _lora_targets(kind: str, cfg: ModelConfig, lora: LoRAConfig):
    """(path, d_in, d_out) of the LoRA-targeted linears of a block; a
    routed expert's d_in / d_out are (E, d) pairs (per-expert adapters)."""
    d = cfg.d_model
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    t = []
    if kind == BLOCK_RWKV6:
        t += [(("rwkv", "w_r"), d, d), (("rwkv", "w_k"), d, d),
              (("rwkv", "w_v"), d, d), (("rwkv", "w_o"), d, d)]
        if lora.target_mlp:
            t += [(("rwkv", "ck"), d, cfg.d_ff), (("rwkv", "cv"), cfg.d_ff, d)]
    elif kind == BLOCK_ATTN:
        hd = cfg.resolved_head_dim
        if lora.target_attn:
            t += [(("attn", "q"), d, nq * hd), (("attn", "k"), d, nkv * hd),
                  (("attn", "v"), d, nkv * hd), (("attn", "o"), nq * hd, d)]
        if lora.target_mlp and cfg.moe is None:
            t += _mlp_targets(("mlp",), cfg)
        elif lora.target_mlp and cfg.moe.num_shared_experts:
            t += _mlp_targets(("moe", "shared"), cfg, shared_moe=True)
        elif lora.target_mlp:
            # routed experts: per-expert adapters (E, d, r), grok's path
            f = cfg.moe.expert_d_ff or cfg.d_ff
            E = cfg.moe.num_experts
            t += [(("moe", "w_up"), (E, d), (E, f)),
                  (("moe", "w_down"), (E, f), (E, d))]
    elif kind == BLOCK_MLA:
        m = cfg.mla
        if lora.target_attn:
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            if m.q_lora_rank:
                t += [(("mla", "q_down"), d, m.q_lora_rank),
                      (("mla", "q_up"), m.q_lora_rank, nq * qk)]
            else:
                t += [(("mla", "q"), d, nq * qk)]
            t += [(("mla", "kv_down"), d,
                   m.kv_lora_rank + m.qk_rope_head_dim),
                  (("mla", "o"), nq * m.v_head_dim, d)]
        if (lora.target_mlp and cfg.moe is not None
                and cfg.moe.num_shared_experts):
            t += _mlp_targets(("moe", "shared"), cfg, shared_moe=True)
    elif kind == BLOCK_MAMBA2:
        s = cfg.ssm
        d_in = s.expand * d
        proj_out = 2 * d_in + 2 * s.state_dim + d_in // s.head_dim
        t += [(("mamba", "in_proj"), d, proj_out),
              (("mamba", "out_proj"), d_in, d)]
    return t


def _shared_targets(cfg: ModelConfig):
    """(path, d_in, d_out) of zamba2's shared block's adapters, whatever
    the LoRAConfig's targets, as in the reference (a gate adapter even
    without a gated MLP)."""
    d, hd, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    return [(("attn", "q"), d, nq * hd), (("attn", "k"), d, nkv * hd),
            (("attn", "v"), d, nkv * hd), (("attn", "o"), nq * hd, d),
            (("mlp", "up"), d, f), (("mlp", "gate"), d, f),
            (("mlp", "down"), f, d)]


def _mlp_targets(prefix, cfg: ModelConfig, shared_moe=False):
    d = cfg.d_model
    f = cfg.d_ff
    if shared_moe:
        f = (cfg.moe.expert_d_ff or cfg.d_ff) * cfg.moe.num_shared_experts
    t = [(prefix + ("up",), d, f), (prefix + ("down",), f, d)]
    if is_glu(cfg.activation):
        t.append((prefix + ("gate",), d, f))
    return t


def init_adapters(cfg: ModelConfig, lora: LoRAConfig, *, seed: int = 0,
                  dtype=torch.float32, rank: Optional[int] = None,
                  device="cuda",
                  generator: Optional[torch.Generator] = None) -> Dict:
    """Adapter tree mirroring the (stacked) param structure, drawn from
    ``generator`` (which then fixes the device) or from a fresh one
    seeded with ``seed`` on ``device``. zamba2's shared block gets one
    unstacked adapter per linear under ``"shared_attn"``."""
    rank = rank or lora.rank
    gen = generator
    if gen is None:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    out: Dict[str, Any] = {"segments": []}
    for kind, n in segments_of(cfg):
        seg_ad: Dict[str, Any] = {}
        for path, din, dout in _lora_targets(kind, cfg, lora):
            node = seg_ad
            for part in path[:-1]:
                node = node.setdefault(part, {})
            if isinstance(din, tuple):      # per-expert adapters (E, ·, r)
                (E, di), (_, do) = din, dout
                a = torch.randn((n, E, di, rank), generator=gen,
                                device=gen.device) / di ** 0.5
                node[path[-1]] = {
                    "a": a.to(dtype),
                    "b": torch.zeros((n, E, rank, do), dtype=dtype,
                                     device=gen.device)}
            else:
                node[path[-1]] = lora_lib.init_adapter(gen, din, dout, rank,
                                                       dtype, layers=n)
        out["segments"].append(seg_ad)
    if cfg.shared_attn_every:
        sa: Dict[str, Any] = {"attn": {}, "mlp": {}}
        for (group, name), din, dout in _shared_targets(cfg):
            sa[group][name] = lora_lib.init_adapter(gen, din, dout, rank,
                                                    dtype)
        out["shared_attn"] = sa
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _block_apply(kind, p, ad, x, cfg: ModelConfig, scale, positions,
                 cache=None, cache_index=None, sliding_window=None):
    """One block. Returns (x, cache, aux); a cache is updated in place;
    aux is the MoE's load-balance loss (0 without one; per lane with
    lane-batched adapters, see ``models/moe.py``)."""
    ad = ad or {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == BLOCK_RWKV6:
        h = apply_norm(p["norm1"], x, "layernorm")
        o, ns = rwkv_lib.apply_rwkv6_timemix(p["rwkv"], ad.get("rwkv"), h,
                                             cfg, scale, state=cache)
        x = x + o
        h = apply_norm(p["norm2"], x, "layernorm")
        o, new_last = rwkv_lib.apply_rwkv6_channelmix(
            p["rwkv"], ad.get("rwkv"), h, cfg, scale, state=cache)
        if cache is not None:
            cache["wkv"].copy_(ns["wkv"])
            cache["last"].copy_(ns["last"])
            cache["last_cm"].copy_(new_last)
        return x + o, cache, aux
    if kind == BLOCK_MAMBA2:
        h = apply_norm(p["norm"], x, cfg.norm)
        o, ns = mamba_lib.apply_mamba2(p["mamba"], ad.get("mamba"), h, cfg,
                                       scale, state=cache)
        if cache is not None:
            cache["ssm"].copy_(ns["ssm"])
            cache["conv"].copy_(ns["conv"])
        return x + o, cache, aux
    h = apply_norm(p["norm1"], x, cfg.norm)
    if kind == BLOCK_MLA:
        name, attention = "mla", attn_lib.apply_mla
    else:
        name, attention = "attn", attn_lib.apply_attention
    o, nc = attention(p[name], ad.get(name), h, cfg, scale, positions,
                      cache=cache, cache_index=cache_index,
                      sliding_window=sliding_window)
    x = x + o
    h = apply_norm(p["norm2"], x, cfg.norm)
    if "moe" in p:
        o, aux = moe_lib.apply_moe(p["moe"], ad.get("moe"), h, cfg, scale)
    else:
        o = mlp_lib.apply_mlp(p["mlp"], ad.get("mlp"), h, cfg.activation,
                              scale)
    return x + o, nc, aux


def _shared_attn_apply(p, ad, x, cfg: ModelConfig, scale, positions,
                       cache=None, cache_index=None, sliding_window=None):
    """zamba2's shared transformer block: attention and MLP with one set
    of (unstacked) params and adapters at every application."""
    ad = ad or {}
    h = apply_norm(p["norm1"], x, cfg.norm)
    o, _ = attn_lib.apply_attention(p["attn"], ad.get("attn"), h, cfg, scale,
                                    positions, cache=cache,
                                    cache_index=cache_index,
                                    sliding_window=sliding_window)
    x = x + o
    h = apply_norm(p["norm2"], x, cfg.norm)
    return x + mlp_lib.apply_mlp(p["mlp"], ad.get("mlp"), h, cfg.activation,
                                 scale)


def _cache_len(kind, seg_cache) -> int:
    if kind == BLOCK_ATTN:
        return seg_cache["k"].shape[2]       # (L, B, Sc, ...)
    if kind == BLOCK_MLA:
        return seg_cache["c_kv"].shape[2]
    return 1  # recurrent state has no positional ring buffer


def _run_layers(params, adapters, x, cfg, scale, positions, window,
                caches=None, remat=False):
    """Every segment's layers, then the final norm. Returns (x, aux
    summed over the layers).

    zamba2: in a mamba2 segment the shared block runs after each group
    of ``shared_attn_every`` layers, and not after the remainder layers
    (reference ``_scan_mamba_with_shared``); application j reads and
    writes shared cache j.

    remat: each block, and the shared block at each application, runs
    under ``torch.utils.checkpoint`` (non-reentrant): nothing inside it
    is kept for the backward pass, which recomputes it (the reference's
    ``nothing_saveable`` policy); the kernels' Functions launch again
    in the recompute."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    adapters = adapters or {}
    seg_ads = adapters.get("segments", [None] * len(params["segments"]))
    shared_c = None if caches is None else caches.get("shared_attn")
    checkpointed = remat and caches is None and torch.is_grad_enabled()

    def run(fn, *args):
        if not checkpointed:
            return fn(*args)
        from torch.utils.checkpoint import checkpoint
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)   # blocks draw nothing

    def block(kind, p, ad, h, cache, cache_index):
        h, _, aux = _block_apply(kind, p, ad, h, cfg, scale, positions,
                                 cache=cache, cache_index=cache_index,
                                 sliding_window=window)
        return h, aux

    def shared_block(h, sc):
        return _shared_attn_apply(
            params["shared_attn"], adapters.get("shared_attn"), h, cfg,
            scale, positions, cache=sc,
            cache_index=(None if sc is None else
                         positions[:, 0] % sc["k"].shape[1]),
            sliding_window=window)

    applied = 0
    for s, (kind, n) in enumerate(segments_of(cfg)):
        seg_p, seg_ad = params["segments"][s], seg_ads[s]
        seg_c = None if caches is None else caches["segments"][s]
        cache_index = (None if seg_c is None
                       else positions[:, 0] % _cache_len(kind, seg_c))
        every = cfg.shared_attn_every if kind == BLOCK_MAMBA2 else 0
        for i in range(n):
            x, aux = run(
                block, kind, _layer(seg_p, i),
                None if seg_ad is None else _layer(seg_ad, i), x,
                None if seg_c is None else _layer(seg_c, i), cache_index)
            aux_total = aux_total + aux
            if every and (i + 1) % every == 0:
                sc = None if shared_c is None else _layer(shared_c, applied)
                x = run(shared_block, x, sc)
                applied += 1
    return apply_norm(params["final_norm"], x, cfg.norm), aux_total


def forward_hidden(params, adapters, cfg: ModelConfig, lora: LoRAConfig,
                   batch: Dict, *, sliding_window=None, remat: bool = False,
                   scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone forward: final-norm hidden states (B, P + S, d) and the
    MoE aux loss summed over layers (0 without MoE).

    batch: tokens (B, S) [, prefix_embeds (B, P, d)]: the prefix (a VLM's
    patch embeddings, stubbed as in the reference) is prepended to the
    token embeddings, and positions run over P + S.
    remat: checkpoint each block (recomputed in the backward pass).
    The reference's ``constrain`` (a sharding constraint on the residual
    stream) and ``scan_unroll`` are not taken: on one device the first
    is the identity, and the layers run as a plain Python loop, so there
    is nothing to unroll (ROADMAP Queue 1, item 12b).
    scale: optional override of lora.scale — a scalar, or a
    ``(scale, rank_mask)`` pair (see :func:`core.lora.split_scale`)."""
    scale = lora.scale if scale is None else scale
    x = F.embedding(batch["tokens"], params["embed"])
    prefix = batch.get("prefix_embeds")
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    window = sliding_window or cfg.sliding_window
    return _run_layers(params, adapters, x, cfg, scale, positions, window,
                       remat=remat)


def forward(params, adapters, cfg: ModelConfig, lora: LoRAConfig,
            batch: Dict, *, sliding_window=None, scale=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward (prefill).

    batch: {"tokens": (B, S) int64 [, "prefix_embeds": (B, P, d)]} on
    the params' device. Returns (logits (B, P + S, V), aux_loss)."""
    x, aux = forward_hidden(params, adapters, cfg, lora, batch,
                            sliding_window=sliding_window, scale=scale)
    return _lm_head(params, cfg, x), aux


def _lm_head(params, cfg, x):
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]["w"]
    return softcap(logits, cfg.logits_softcap)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                dtype=torch.bfloat16, device="cuda") -> Dict:
    """Per-segment cache stacks with a leading layer axis: attn k/v
    (L, B, Sc, Hkv, hd) and pos (L, B, Sc) int32 (-1 = empty); mla c_kv
    (L, B, Sc, kv_lora_rank), k_rope (L, B, Sc, rope) and pos; rwkv6
    wkv (L, B, H, K, K) f32 and last/last_cm (L, B, d); mamba2 ssm
    (L, B, H, P, N) f32 and conv (L, B, W-1, conv_channels). zamba2 adds
    ``"shared_attn"``: one attention ring per application of the shared
    block, ``num_layers // shared_attn_every`` of them, stacked."""
    dev = resolve_device(device)
    caches: Dict[str, Any] = {"segments": []}

    def stacked(c, n):
        return {k: v.expand((n,) + v.shape).clone() for k, v in c.items()}

    for kind, n in segments_of(cfg):
        if kind == BLOCK_RWKV6:
            c = rwkv_lib.init_rwkv6_state(cfg, batch, dtype, dev)
        elif kind == BLOCK_MAMBA2:
            c = mamba_lib.init_mamba2_state(cfg, batch, dtype, dev)
        elif kind == BLOCK_MLA:
            c = attn_lib.init_mla_cache(cfg, batch, cache_len, dtype, dev)
        elif kind == BLOCK_ATTN:
            c = attn_lib.init_cache(cfg, batch, cache_len, dtype, dev)
        else:
            raise ValueError(kind)
        caches["segments"].append(stacked(c, n))
    if cfg.shared_attn_every:
        caches["shared_attn"] = stacked(
            attn_lib.init_cache(cfg, batch, cache_len, dtype, dev),
            cfg.num_layers // cfg.shared_attn_every)
    return caches


def decode_step(params, adapters, cfg: ModelConfig, lora: LoRAConfig,
                token: torch.Tensor, caches, position, *,
                sliding_window=None, scale=None
                ) -> Tuple[torch.Tensor, Any]:
    """One-token decode. token: (B, 1); position: int or (B,) — the
    absolute position of each lane's new token. On attn and mla segments each
    lane writes its ring slot ``position[b] % cache_len`` and attends
    with its own position, so lanes at different points of their streams
    share one step (zamba2's shared block too); rwkv6 and mamba2
    segments step each lane's recurrent state.

    ``scale`` (scalar, (B,) per-lane tensor, or ``(scale, rank_mask)``)
    overrides ``lora.scale``; with lane-batched adapters (leaves
    (L, B, ...)) each lane runs its own adapter. Caches are updated in
    place and returned. Returns (logits (B, 1, V), caches).
    """
    scale = lora.scale if scale is None else scale
    x = F.embedding(token, params["embed"])
    B = x.shape[0]
    pos = torch.as_tensor(position, device=x.device).reshape(-1)
    positions = pos.expand(B).reshape(B, 1).long()
    window = sliding_window or cfg.sliding_window
    x, _ = _run_layers(params, adapters, x, cfg, scale, positions, window,
                       caches=caches)
    return _lm_head(params, cfg, x), caches


def decode_step_paged(params, adapters, cfg: ModelConfig, lora: LoRAConfig,
                      token: torch.Tensor, state_caches, pools, tables,
                      position, *, sliding_window=None, scale=None
                      ) -> Tuple[torch.Tensor, Any, Tuple]:
    """One-token decode of every lane against block-paged KV pools.

    The ring-buffer caches live in shared pools (``core/kv_blocks.py``)
    and each lane reads them through its row of ``tables`` (B, T). Every
    layer's lanes are gathered once into the dense ``(L, B, Sc, ...)``
    view (``Sc = T * block_size``), the UNCHANGED :func:`decode_step`
    runs on it — so paged decode gives dense decode's bits by
    construction — and each lane's just-written ring slot
    ``position[b] % Sc`` goes back to the pool at ``(tables[b, ring //
    block_size], ring % block_size)``. The reference vmaps one lane of
    this; here all lanes run in one step, as the dense engine's do.

    state_caches: the cache tree with the paged slots emptied
    (``kv_blocks.split_cache_tree``): only recurrent state remains, and
    is updated in place. pools: tuple in ``kv_blocks.paged_slots(cfg)``
    order, updated in place. position: (B,) absolute positions.
    Returns (logits (B, 1, V), state_caches, pools).
    """
    from repro_torch.core import kv_blocks as kvb
    gathered = [kvb.gather_lanes(pool, tables) for pool in pools]
    caches = kvb.merge_lane_caches(cfg, state_caches, gathered)
    logits, caches = decode_step(params, adapters, cfg, lora, token, caches,
                                 position, sliding_window=sliding_window,
                                 scale=scale)
    if pools:
        bs = kvb.pool_block_size(pools[0])
        pos = torch.as_tensor(position, device=logits.device).reshape(-1)
        pos = pos.expand(token.shape[0]).long()
        idx = pos % (tables.shape[1] * bs)
        for slot, pool in zip(kvb.paged_slots(cfg), pools):
            written = kvb.written_slots(kvb.get_slot(caches, slot), idx)
            kvb.scatter_written(pool, written, tables, pos, bs)
    return logits, state_caches, pools


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _ce_of(params, cfg, h_blk, lab_blk, mask_blk):
    logits = _lm_head(params, cfg, h_blk)
    lp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(lp, -1, lab_blk[..., None])[..., 0]
    hit = (torch.argmax(logits, -1) == lab_blk).float()
    return -torch.sum(ll * mask_blk), torch.sum(hit * mask_blk)


def loss_fn(params, adapters, cfg: ModelConfig, lora: LoRAConfig,
            batch: Dict, *, remat: bool = False, ce_chunk: int = 0,
            scale=None,
            lanes: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE, or classification CE when ``labels`` has rank 1.

    batch: tokens (B, S) int32 or int64 [, prefix_embeds (B, P, d), whose
    P hidden rows are dropped before the CE]; labels (B, S) shifted targets
    with -100 = masked, or (B,) class labels (ViT-style classification on
    the last position, the paper's tasks). remat: as
    :func:`forward_hidden`. ce_chunk > 0: the lm head and CE run
    over sequence chunks of that size, each recomputed in the backward
    pass (torch.utils.checkpoint), so at most B x chunk x V logits live at
    once. Returns (loss + aux, {"loss", "aux", "accuracy"}).

    lanes=V: the batch holds V lanes of equal size, lane-major (rows
    v·B/V … (v+1)·B/V − 1 are lane v), against lane-batched adapters
    (leaves (L, V, ...)). Each lane's loss and accuracy are over its own
    rows, and the metrics come back as (V,) tensors. The returned scalar
    is the SUM of the lanes' losses, so lane v's adapters get the
    gradient of lane v's loss alone (a mean over all rows would scale
    every gradient by 1/V, which Adam's ε makes visible). ce_chunk does
    not apply with lanes.
    """
    hidden, aux = forward_hidden(params, adapters, cfg, lora, batch,
                                 remat=remat, scale=scale)
    labels = batch["labels"].long()
    if lanes is not None:
        return _lane_loss(params, cfg, hidden, labels, aux, lanes)
    if labels.dim() == 1:
        cls_logits = _lm_head(params, cfg, hidden[:, -1, :])
        lp = torch.log_softmax(cls_logits.float(), dim=-1)
        ll = torch.gather(lp, -1, labels[:, None])[:, 0]
        loss = -torch.mean(ll)
        acc = torch.mean((torch.argmax(cls_logits, -1) == labels).float())
        return loss + aux, {"loss": loss, "aux": aux, "accuracy": acc}
    npref = hidden.shape[1] - labels.shape[1]
    hidden = hidden[:, npref:, :]
    mask = (labels >= 0).float()
    lab = torch.clamp(labels, min=0)
    S = hidden.shape[1]
    if ce_chunk and S % ce_chunk == 0 and S > ce_chunk:
        from torch.utils.checkpoint import checkpoint
        loss_sum = hit_sum = torch.zeros((), dtype=torch.float32,
                                         device=hidden.device)
        for c0 in range(0, S, ce_chunk):
            sl = slice(c0, c0 + ce_chunk)
            l, h = checkpoint(_ce_of, params, cfg, hidden[:, sl],
                              lab[:, sl], mask[:, sl], use_reentrant=False)
            loss_sum = loss_sum + l
            hit_sum = hit_sum + h
    else:
        loss_sum, hit_sum = _ce_of(params, cfg, hidden, lab, mask)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = loss_sum / denom
    acc = hit_sum / denom
    return loss + aux, {"loss": loss, "aux": aux, "accuracy": acc}


def _lane_loss(params, cfg, hidden, labels, aux, lanes: int):
    """:func:`loss_fn`'s per-lane reduction (see its ``lanes``)."""
    if labels.dim() == 1:
        logits = _lm_head(params, cfg, hidden[:, -1, :])
        lp = torch.log_softmax(logits.float(), dim=-1)
        ll = torch.gather(lp, -1, labels[:, None])[:, 0]
        loss = -torch.mean(ll.reshape(lanes, -1), dim=1)
        acc = torch.mean((torch.argmax(logits, -1) == labels).float()
                         .reshape(lanes, -1), dim=1)
    else:
        hidden = hidden[:, hidden.shape[1] - labels.shape[1]:, :]
        mask = (labels >= 0).float()
        logits = _lm_head(params, cfg, hidden)
        lp = torch.log_softmax(logits.float(), dim=-1)
        ll = torch.gather(lp, -1, torch.clamp(labels, min=0)[..., None]
                          )[..., 0]
        hit = (torch.argmax(logits, -1) == labels).float()
        denom = torch.clamp(torch.sum(mask.reshape(lanes, -1), dim=1),
                            min=1.0)
        loss = -torch.sum((ll * mask).reshape(lanes, -1), dim=1) / denom
        acc = torch.sum((hit * mask).reshape(lanes, -1), dim=1) / denom
    aux = aux.expand(lanes)
    return torch.sum(loss + aux), {"loss": loss, "aux": aux,
                                   "accuracy": acc}
