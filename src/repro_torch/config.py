"""Configuration for the PyTorch port: the serving slice's own copies.

The port imports nothing from ``repro``, so it keeps its own copies of
the pieces of ``repro/config.py`` the serving slices read: the block-kind
constants, :class:`RWKVConfig`, :class:`ModelConfig`, :class:`LoRAConfig`,
:class:`ServeSpec` and the ``--arch`` registry. Each keeps the reference's
names, defaults and validation for the fields it has; fields only the
unported parts read (MoE/MLA/SSM sub-configs, modality frontends,
candidate ranks, buffer donation, adapter-cache and block-pool sizes) are
left out until a slice needs them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

# Block kinds understood by models/transformer.py (BLOCK_ATTN and
# BLOCK_RWKV6 are ported)
BLOCK_ATTN = "attn"          # full (GQA/MQA) attention + MLP
BLOCK_MLA = "mla"            # DeepSeek-style multi-head latent attention + MLP/MoE
BLOCK_MAMBA2 = "mamba2"      # Mamba2 (SSD) block
BLOCK_RWKV6 = "rwkv6"        # RWKV6 time-mix + channel-mix
BLOCK_SHARED_ATTN = "shared_attn"  # Zamba2 shared transformer block


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64     # rank of the data-dependent decay MLP (w_lora)
    gate_lora: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | vlm | ssm | audio
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attn-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    activation: str = "swiglu"       # swiglu | geglu | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    logits_softcap: float = 0.0
    block_pattern: Optional[Tuple[str, ...]] = None   # None -> all BLOCK_ATTN
    rwkv: Optional[RWKVConfig] = None
    sliding_window: Optional[int] = None
    source: str = ""
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        if self.num_heads <= 0:
            raise ValueError(f"{self.name}: no heads, no head_dim")
        return self.d_model // self.num_heads

    def blocks(self) -> Tuple[str, ...]:
        if self.block_pattern is not None:
            if len(self.block_pattern) != self.num_layers:
                raise ValueError(
                    f"{self.name}: block pattern len {len(self.block_pattern)}"
                    f" != num_layers {self.num_layers}")
            return self.block_pattern
        return tuple([BLOCK_ATTN] * self.num_layers)

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8                      # current rank (per-client, adaptive)
    max_rank: int = 64                 # server-side truncated-SVD depth
    alpha: float = 16.0                # scaling: s = alpha / rank
    target_attn: bool = True
    target_mlp: bool = True

    @property
    def scale(self) -> float:
        return self.alpha / max(self.rank, 1)


@dataclass(frozen=True)
class ServeSpec:
    """Multi-tenant serving tier configuration.

    ``max_batch`` lanes decode together; each holds its own KV cache slice
    of ``cache_len`` tokens and a rank-padded adapter slot ``max_rank``
    columns wide (0 resolves to ``LoRAConfig.max_rank``).
    ``block_size > 0`` asks for paged KV, which the port does not run yet:
    the serve engine refuses it.
    """
    max_batch: int = 4
    cache_len: int = 128
    max_rank: int = 0
    sliding_window: Optional[int] = None
    block_size: int = 0
    admission: str = "strict"    # admit() lane policy: strict|evict_oldest

    def resolve_max_rank(self, lora: LoRAConfig) -> int:
        return self.max_rank if self.max_rank > 0 else lora.max_rank

    @property
    def paged(self) -> bool:
        return self.block_size > 0

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.cache_len < 1:
            raise ValueError("cache_len must be >= 1")
        if self.max_rank < 0:
            raise ValueError("max_rank must be >= 0 (0 = lora.max_rank)")
        if self.sliding_window is not None and self.sliding_window < 1:
            raise ValueError("sliding_window must be >= 1 or None")
        if self.block_size < 0:
            raise ValueError("block_size must be >= 0 (0 = dense caches)")
        if self.admission not in ("strict", "evict_oldest"):
            raise ValueError(
                f"admission must be 'strict' or 'evict_oldest', "
                f"got {self.admission!r}")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register_arch(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_arch(arch_id: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates registry)
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs() -> List[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
