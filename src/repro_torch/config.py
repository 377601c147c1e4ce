"""Configuration for the PyTorch port: its own copies of the reference's.

The port imports nothing from ``repro``, so it keeps its own copies of
the pieces of ``repro/config.py`` the ported slices read: the block-kind
constants, :class:`MoEConfig`, :class:`MLAConfig`, :class:`SSMConfig`,
:class:`RWKVConfig`, :class:`ModelConfig`, :class:`LoRAConfig`,
:class:`ServeSpec`, the federated round's configs (:class:`UCBDualConfig`,
:class:`EnergyAllocConfig`, :class:`MobilityConfig`) and scenario specs
(:class:`TraceSpec`, :class:`OutageSpec`, :class:`RSUTierSpec`,
:class:`ParticipationSpec`, :class:`ShardSpec`, :class:`CheckpointSpec`),
the launch layer's :class:`InputShape` table and :class:`MeshConfig`,
and the ``--arch`` registry. Each keeps the reference's names, defaults
and validation for the fields it has. :class:`ModelConfig` has all of the
reference's fields, so that a config's checkpoint fingerprint is the
reference's.
:class:`ServeSpec` leaves out the reference's ``donate`` (JAX buffer
donation), which has no torch counterpart. The simulator refuses the
shardings it does not run yet. The reference's ``HardwareConfig`` /
``HW_V5E`` (TPU v5e roofline constants) have no copy here: the port
states no TPU figure.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# Block kinds understood by models/transformer.py
BLOCK_ATTN = "attn"          # full (GQA/MQA) attention + MLP
BLOCK_MLA = "mla"            # DeepSeek-style multi-head latent attention + MLP/MoE
BLOCK_MAMBA2 = "mamba2"      # Mamba2 (SSD) block
BLOCK_RWKV6 = "rwkv6"        # RWKV6 time-mix + channel-mix
BLOCK_SHARED_ATTN = "shared_attn"  # Zamba2 shared transformer block


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    expert_d_ff: Optional[int] = None    # if None, use model d_ff
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 => full-rank q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) configuration."""
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128


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
    shared_attn_every: int = 0       # zamba2: shared attn every k mamba blocks
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # modality frontends are stubs, as in the reference: the caller
    # hands num_prefix_embeds embeddings of width d_model to forward
    frontend: Optional[str] = None   # None | "vision" | "audio"
    num_prefix_embeds: int = 0
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

    def param_counts(self) -> Dict[str, float]:
        """Approximate parameter counts, total and active per token: the
        reference's, line for line, faults included (ROADMAP Queue 3,
        fault 5: grok-1-314b's non-gated ``gelu`` experts count two
        matrices each, so its total comes out at 213 B, not 314 B;
        fault 7: zamba2's shared attention block is not counted, so
        zamba2-2.7b's total comes out at 2,315,960,320 where its tree
        holds 2,422,393,760)."""
        d, f = self.d_model, self.d_ff
        hd = self.resolved_head_dim if self.num_heads > 0 else 0
        nq, nkv = self.num_heads, self.num_kv_heads
        glu = self.activation in ("swiglu", "geglu")
        per_mlp = d * f * (3 if glu else 2)
        counts = {"embed": self.d_model * self.vocab_size *
                  (1 if self.tie_embeddings else 2)}
        total = active = 0.0
        for kind in self.blocks():
            if kind in (BLOCK_ATTN, BLOCK_SHARED_ATTN):
                attn = d * hd * (nq + 2 * nkv) + nq * hd * d
                blk = attn + per_mlp
                total += blk
                active += blk
            elif kind == BLOCK_MLA:
                m = self.mla
                attn = (d * m.kv_lora_rank                       # kv down
                        + m.kv_lora_rank * nq * (m.qk_nope_head_dim
                                                 + m.v_head_dim)
                        + d * m.qk_rope_head_dim                  # rope k
                        + d * nq * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                        + nq * m.v_head_dim * d)
                if self.moe is not None:
                    ef = self.moe.expert_d_ff or f
                    e_p = d * ef * (3 if glu else 2)
                    routed = self.moe.num_experts * e_p
                    shared = self.moe.num_shared_experts * e_p
                    router = d * self.moe.num_experts
                    total += attn + routed + shared + router
                    active += attn + shared + router + self.moe.top_k * e_p
                else:
                    total += attn + per_mlp
                    active += attn + per_mlp
            elif kind == BLOCK_MAMBA2:
                s = self.ssm
                d_in = s.expand * d
                # in_proj: d -> 2*d_in + 2*state + heads ; out_proj: d_in -> d
                nheads = d_in // s.head_dim
                blk = d * (2 * d_in + 2 * s.state_dim + nheads) + d_in * d
                total += blk
                active += blk
            elif kind == BLOCK_RWKV6:
                r = self.rwkv
                tm = d * d * 4 + d * r.gate_lora * 2 + d * r.decay_lora * 2
                cm = d * int(3.5 * d) * 2 if f == 0 else d * f * 2
                total += tm + cm
                active += tm + cm
            else:
                raise ValueError(kind)
            if kind == BLOCK_ATTN and self.moe is not None:
                # MoE replaces the dense MLP (grok-style): undo + add experts
                total -= per_mlp
                active -= per_mlp
                ef = self.moe.expert_d_ff or f
                e_p = d * ef * (3 if glu else 2)
                total += self.moe.num_experts * e_p + d * self.moe.num_experts
                active += self.moe.top_k * e_p + d * self.moe.num_experts
        counts["blocks_total"] = total
        counts["blocks_active"] = active
        counts["total"] = total + counts["embed"]
        counts["active"] = active + counts["embed"]
        return counts


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str            # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8                      # current rank (per-client, adaptive)
    max_rank: int = 64                 # η_max: server-side truncated-SVD depth
    alpha: float = 16.0                # scaling: s = alpha / rank
    candidate_ranks: Tuple[int, ...] = (2, 4, 8, 16, 32, 64)   # φ_η
    target_attn: bool = True
    target_mlp: bool = True
    dropout: float = 0.0

    @property
    def scale(self) -> float:
        return self.alpha / max(self.rank, 1)


# ---------------------------------------------------------------------------
# The federated round (the paper's method)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class UCBDualConfig:
    """Algorithm 2 (UCB-DUAL) hyper-parameters — paper §V-A values."""
    alpha: float = 0.5        # latency weight in reward
    gamma: float = 2.0        # accuracy weight in reward
    epsilon: float = 1.4142135623730951   # exploration factor √2
    omega: float = 0.05       # dual learning rate
    lambda_init: float = 0.0
    # reward latency normalization τ/τ_ref (raw 50–80 s latencies with
    # α = 0.5 would make rewards hugely negative)
    latency_ref: float = 60.0


@dataclass(frozen=True)
class EnergyAllocConfig:
    """Algorithm 1 (inter-task budget allocation) hyper-parameters."""
    e_total: float = 4000.0   # global per-round energy budget (J)
    warmup_q: int = 6         # reallocation period Q
    xi: float = 0.7           # EMA smoothing ξ
    zeta: float = 1.5         # difficulty amplification ζ > 1
    task_cap_frac: float = 0.7


@dataclass(frozen=True)
class MobilityConfig:
    beta: float = 1.0          # energy weight in fallback costs
    accuracy_threshold: float = 0.6   # q*_v
    migration_latency: float = 2.0    # τ^mig baseline (s)
    migration_energy: float = 30.0    # e^mig baseline (J)


@dataclass(frozen=True)
class TraceSpec:
    """Declarative trajectory source for the mobility model: pre-staged
    per-round positions and presence instead of online Gauss-Markov
    dynamics (``sim/trajectories.py`` builds it)."""
    kind: str = "synthetic"      # "synthetic" | "tdrive"
    length: int = 64             # staged round ticks; replay wraps modulo
    path: Optional[str] = None   # tdrive: path to a T-Drive format file
    max_gap_s: float = 600.0     # tdrive: gaps beyond this mark absence
    mean_speed: float = 10.0     # m/s
    speed_std: float = 3.0
    gm_alpha: float = 0.85       # velocity memory
    hotspot_pull: float = 0.35   # attraction toward the nearest RSU center
    corridor_frac: float = 0.0   # >0: motion confined to a corridor
    arrivals: str = "all"        # "all" | "staggered" | "waves"
    min_dwell: int = 6           # minimum rounds a vehicle stays present
    seed: int = 0


@dataclass(frozen=True)
class RSUTierSpec:
    """Two-tier RSU hierarchy: ``num_rsus_per_task`` RSUs per task, each
    aggregating into a partial, merged every ``sync_period`` rounds with
    staleness-discounted weights; a handoff between two RSUs of a task
    charges the migration penalty. The trivial tier (one RSU, sync every
    round) never enters the partials."""
    num_rsus_per_task: int = 1
    sync_period: int = 1
    staleness_decay: float = 0.6
    handoff_energy: float = 0.0    # J
    handoff_latency: float = 0.0   # s

    @property
    def trivial(self) -> bool:
        return self.num_rsus_per_task == 1 and self.sync_period == 1

    def __post_init__(self):
        if self.num_rsus_per_task < 1:
            raise ValueError("num_rsus_per_task must be >= 1")
        if self.sync_period < 1:
            raise ValueError("sync_period must be >= 1")
        if not 0.0 < self.staleness_decay <= 1.0:
            raise ValueError("staleness_decay must be in (0, 1]")
        if self.handoff_energy < 0.0 or self.handoff_latency < 0.0:
            raise ValueError("handoff penalties must be >= 0 (a negative "
                             "penalty would subsidize re-associations)")


@dataclass(frozen=True)
class ParticipationSpec:
    """When a vehicle's upload lands: ``"sync"`` drops a missed upload;
    ``"semi_sync"`` buffers it and lands it up to ``max_delay`` rounds
    late at weight ``w · vehicle_staleness_decay**k``; with
    ``buffer_handoffs`` it lands at the vehicle's current RSU."""
    mode: str = "sync"
    max_delay: int = 3
    vehicle_staleness_decay: float = 0.6
    buffer_handoffs: bool = True

    @property
    def trivial(self) -> bool:
        return self.mode == "sync"

    def __post_init__(self):
        if self.mode not in ("sync", "semi_sync"):
            raise ValueError("mode must be 'sync' or 'semi_sync', got "
                             f"{self.mode!r}")
        if self.max_delay < 0:
            raise ValueError("max_delay must be >= 0")
        if not 0.0 < self.vehicle_staleness_decay <= 1.0:
            raise ValueError("vehicle_staleness_decay must be in (0, 1]")

    @classmethod
    def of(cls, value) -> "ParticipationSpec":
        """A spec passes through; ``"sync"`` / ``"semi-sync"`` /
        ``"semi_sync"`` build one with the default knobs."""
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            name = value.replace("-", "_")
            if name == "sync":
                return cls()
            if name == "semi_sync":
                return cls(mode="semi_sync")
            raise ValueError(f"unknown participation mode {value!r} "
                             "(want 'sync' or 'semi-sync')")
        raise TypeError("participation must be a ParticipationSpec or a "
                        f"mode string, got {type(value).__name__}")


@dataclass(frozen=True)
class ShardSpec:
    """Fleet-axis device sharding of the fused round engine;
    ``num_shards=1`` is the trivial spec, 0 means every device the engine
    can use. ``placement`` maps real lanes to shards: ``"roundrobin"``
    deals lane v to shard v % N, ``"block"`` keeps lanes in order (all
    padding on the last shard)."""
    num_shards: int = 1
    axis_name: str = "fleet"
    placement: str = "roundrobin"   # "roundrobin" | "block"

    @property
    def trivial(self) -> bool:
        return self.num_shards == 1

    def resolve(self, devices: Optional[Sequence[Any]] = None) -> int:
        """Concrete shard count. 0 ⇒ every device the engine will use:
        the explicit ``devices`` list if given, else the visible cards,
        else one CPU (as JAX's unforced CPU backend shows one device)."""
        if self.num_shards == 0:
            if devices is not None:
                return len(devices)
            import torch
            return max(torch.cuda.device_count(), 1)
        return self.num_shards

    def __post_init__(self):
        if self.num_shards < 0:
            raise ValueError("num_shards must be >= 0 (0 = all devices)")
        if self.placement not in ("roundrobin", "block"):
            raise ValueError(
                f"placement must be 'roundrobin' or 'block', "
                f"not {self.placement!r}")
        if not self.axis_name:
            raise ValueError("axis_name must be non-empty")


@dataclass(frozen=True)
class CheckpointSpec:
    """Checkpoint every ``interval`` completed rounds into ``dir``, keeping
    the newest ``keep_last`` (0 keeps all); ``interval=0`` is off."""
    interval: int = 0
    dir: Optional[str] = None
    keep_last: int = 0

    @property
    def enabled(self) -> bool:
        return self.interval > 0

    def __post_init__(self):
        if self.interval < 0:
            raise ValueError("checkpoint interval must be >= 0 (0 = off)")
        if self.keep_last < 0:
            raise ValueError("keep_last must be >= 0 (0 = keep all)")
        if self.interval > 0 and not self.dir:
            raise ValueError(
                "an enabled CheckpointSpec (interval > 0) needs a dir")


@dataclass(frozen=True)
class OutageSpec:
    """RSU ``rsu_id`` has zero effective radius for rounds
    ``start <= round < end`` (0-based)."""
    rsu_id: int
    start: int
    end: int


@dataclass(frozen=True)
class ServeSpec:
    """Multi-tenant serving tier configuration.

    ``max_batch`` lanes decode together; each holds its own KV cache slice
    of ``cache_len`` tokens and a rank-padded adapter slot ``max_rank``
    columns wide (0 resolves to ``LoRAConfig.max_rank``).
    ``cache_capacity`` bounds the host-side adapter cache (entries keyed
    ``(task, rsu, version)``), not device memory.

    ``block_size > 0`` switches the ring-buffer caches to block-paged KV
    (``core/kv_blocks.py``): attention caches live in a shared pool of
    ``max_blocks`` fixed-size blocks behind per-lane block tables.
    ``max_blocks=0`` sizes the pool for full occupancy (every lane at full
    cache length, plus the null block). ``admission`` picks the lane for
    ``ServeEngine.admit`` when the caller names none: ``"strict"`` refuses
    when every lane is occupied, ``"evict_oldest"`` retires the
    longest-admitted tenant. The reference's ``donate`` (JAX buffer
    donation) has no counterpart: the port updates its caches in place.
    """
    max_batch: int = 4           # concurrent decode lanes (tenants)
    cache_len: int = 128         # per-lane KV/state cache length (tokens)
    max_rank: int = 0            # adapter slot width; 0 => lora.max_rank
    cache_capacity: int = 32     # host adapter-cache entries (LRU-bounded)
    sliding_window: Optional[int] = None   # cap attention window at decode
    block_size: int = 0          # paged-KV block size (tokens); 0 => dense
    max_blocks: int = 0          # pool size incl. null block; 0 => auto
    admission: str = "strict"    # admit() lane policy: strict|evict_oldest

    def resolve_max_rank(self, lora: LoRAConfig) -> int:
        return self.max_rank if self.max_rank > 0 else lora.max_rank

    @property
    def paged(self) -> bool:
        return self.block_size > 0

    def resolve_max_blocks(self) -> int:
        """Pool size: explicit, or full occupancy (+1 for the null block)."""
        if not self.paged:
            return 0
        if self.max_blocks:
            return self.max_blocks
        return self.max_batch * (self.cache_len // self.block_size) + 1

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.cache_len < 1:
            raise ValueError("cache_len must be >= 1")
        if self.max_rank < 0:
            raise ValueError("max_rank must be >= 0 (0 = lora.max_rank)")
        if self.cache_capacity < 1:
            raise ValueError("cache_capacity must be >= 1")
        if self.sliding_window is not None and self.sliding_window < 1:
            raise ValueError("sliding_window must be >= 1 or None")
        if self.block_size < 0:
            raise ValueError("block_size must be >= 0 (0 = dense caches)")
        if self.block_size and self.cache_len % self.block_size:
            raise ValueError(
                f"cache_len ({self.cache_len}) must be a multiple of "
                f"block_size ({self.block_size}) — the lane ring is a "
                "whole number of blocks")
        if self.max_blocks < 0:
            raise ValueError("max_blocks must be >= 0 (0 = auto-size)")
        if self.max_blocks and self.max_blocks < 2:
            raise ValueError("max_blocks must be >= 2 (null block + at "
                             "least one usable block)")
        if self.admission not in ("strict", "evict_oldest"):
            raise ValueError(
                f"admission must be 'strict' or 'evict_oldest', "
                f"got {self.admission!r}")


# ---------------------------------------------------------------------------
# Mesh / launch
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False
    # single pod: (data=16, model=16) = 256 devices; multi-pod adds pod=2
    data: int = 16
    model: int = 16
    pods: int = 2

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.pods, self.data, self.model) if self.multi_pod else (
            self.data, self.model)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def num_chips(self) -> int:
        n = self.data * self.model
        return n * self.pods if self.multi_pod else n


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


def get_input_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown input shape {name!r}; have {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]
