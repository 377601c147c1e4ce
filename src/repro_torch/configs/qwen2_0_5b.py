"""Qwen2-0.5B — dense GQA with QKV bias.

[arXiv:2407.10671] 24L, d_model=896, 14 heads (GQA kv=2), d_ff=4864,
vocab=151936, RoPE theta 1e6, RMSNorm, SwiGLU, QKV bias, tied embeddings.
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("qwen2-0.5b")
def qwen2_0_5b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b",
        family="dense",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        d_ff=4864,
        vocab_size=151936,
        head_dim=64,
        rope_theta=1e6,
        norm="rmsnorm",
        activation="swiglu",
        qkv_bias=True,
        tie_embeddings=True,
        source="arXiv:2407.10671",
    )


def reduced() -> ModelConfig:
    return qwen2_0_5b().with_overrides(
        name="qwen2-0.5b-reduced", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512)
