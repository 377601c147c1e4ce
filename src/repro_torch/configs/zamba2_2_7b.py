"""Zamba2-2.7B — hybrid Mamba2 backbone with shared attention blocks.

[arXiv:2411.15242] 54 Mamba2 layers, d_model=2560, ssm_state=64; a *shared*
transformer block (32 heads of 80, d_ff=10240) is interleaved periodically
(every 6 Mamba blocks here) and reuses the same parameters at each
application, vocab=32000. ``param_counts`` leaves the shared block out,
as the reference's does (ROADMAP Queue 3, fault 7).
"""
from repro_torch.config import (BLOCK_MAMBA2, ModelConfig, SSMConfig,
                                register_arch)


@register_arch("zamba2-2.7b")
def zamba2_2_7b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=10240,
        vocab_size=32000,
        head_dim=80,
        norm="rmsnorm",
        activation="swiglu",
        block_pattern=tuple([BLOCK_MAMBA2] * 54),
        shared_attn_every=6,
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4),
        source="arXiv:2411.15242",
    )


def reduced() -> ModelConfig:
    return zamba2_2_7b().with_overrides(
        name="zamba2-2.7b-reduced", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        block_pattern=tuple([BLOCK_MAMBA2] * 2), shared_attn_every=2,
        ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, conv_width=4))
