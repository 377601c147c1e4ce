"""RWKV6-7B ("Finch") — attention-free RNN with data-dependent decay.

[arXiv:2404.05892] 32L, d_model=4096, head_dim=64 (64 wkv heads),
channel-mix d_ff=14336, vocab=65536, data-dependent decay via low-rank
(decay_lora) MLPs, token-shift mixing.
"""
from repro_torch.config import (BLOCK_RWKV6, ModelConfig, RWKVConfig,
                                register_arch)


@register_arch("rwkv6-7b")
def rwkv6_7b() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        num_layers=32,
        d_model=4096,
        num_heads=0,           # attention-free
        num_kv_heads=0,
        d_ff=14336,
        vocab_size=65536,
        norm="layernorm",
        activation="relu_sq",  # rwkv channel-mix uses relu^2
        block_pattern=tuple([BLOCK_RWKV6] * 32),
        rwkv=RWKVConfig(head_dim=64, decay_lora=64, gate_lora=128),
        source="arXiv:2404.05892",
    )


def reduced() -> ModelConfig:
    return rwkv6_7b().with_overrides(
        name="rwkv6-7b-reduced", num_layers=2, d_model=128, d_ff=256,
        vocab_size=512, block_pattern=tuple([BLOCK_RWKV6] * 2),
        rwkv=RWKVConfig(head_dim=32, decay_lora=16, gate_lora=32))
