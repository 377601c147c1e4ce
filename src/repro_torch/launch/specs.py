"""input_specs(): stand-ins for every model input, port of
``repro/launch/specs.py``.

A ``jax.ShapeDtypeStruct`` becomes a tensor on the ``meta`` device: it
has a shape and a dtype and allocates nothing, ``long_500k``'s caches
included. :func:`abstract` is the counterpart of ``jax.eval_shape``: it
runs an init function of the port on the CPU under torch's fake-tensor
mode, where nothing is allocated and nothing is drawn, and returns its
tree on the meta device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.config import (BLOCK_ATTN, BLOCK_MLA, InputShape,
                                ModelConfig)
from repro_torch.interop import tree_map

# long-context window for full-attention archs at long_500k
LONG_CONTEXT_WINDOW = 8192


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


def abstract(fn: Callable[..., Any], *args, **kwargs) -> Any:
    """``fn(*args, device="cpu", **kwargs)``'s tree as meta tensors,
    without allocating or drawing its leaves."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = fn(*args, device="cpu", **kwargs)
    return tree_map(lambda t: sds(t.shape, t.dtype), tree)


def has_attention_cache(cfg: ModelConfig) -> bool:
    kinds = set(cfg.blocks())
    return bool(kinds & {BLOCK_ATTN, BLOCK_MLA}) or bool(cfg.shared_attn_every)


def needs_window(cfg: ModelConfig, shape: InputShape) -> bool:
    """long_500k decode on archs with attention caches → sliding window."""
    return (shape.name == "long_500k" and has_attention_cache(cfg))


def cache_len_for(cfg: ModelConfig, shape: InputShape) -> int:
    if needs_window(cfg, shape):
        return LONG_CONTEXT_WINDOW
    return shape.seq_len


def input_specs(cfg: ModelConfig, shape: InputShape,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Keyword arguments of the step function, as meta tensors.

    train/prefill: batch={"tokens", "labels"[, "prefix_embeds"]}
    decode:        token, caches, position
    Token ids are int32, as the reference's (the port's steps take int32
    or int64 ids).
    """
    B, S = shape.global_batch, shape.seq_len
    npref = cfg.num_prefix_embeds if cfg.frontend else 0
    if shape.mode in ("train", "prefill"):
        batch: Dict[str, Any] = {}
        s_txt = S - npref
        assert s_txt > 0
        batch["tokens"] = sds((B, s_txt), torch.int32)
        if npref:
            batch["prefix_embeds"] = sds((B, npref, cfg.d_model), dtype)
        if shape.mode == "train":
            batch["labels"] = sds((B, s_txt), torch.int32)
        return {"batch": batch}
    # decode
    from repro_torch.models import transformer as T
    caches = abstract(T.init_caches, cfg, B, cache_len_for(cfg, shape),
                      dtype=dtype)
    return {
        "token": sds((B, 1), torch.int32),
        "caches": caches,
        "position": sds((), torch.int32),
    }
