"""StarCoder2-15B — dense GQA code model.

[arXiv:2402.19173] 40L, d_model=6144, 48 heads (GQA kv=4), d_ff=24576,
vocab=49152, RoPE, LayerNorm, GELU MLP (non-GLU), QKV bias.
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("starcoder2-15b")
def starcoder2_15b() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        family="dense",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=4,
        d_ff=24576,
        vocab_size=49152,
        head_dim=128,
        rope_theta=100000.0,
        norm="layernorm",
        activation="gelu",
        qkv_bias=True,
        source="arXiv:2402.19173",
    )


def reduced() -> ModelConfig:
    return starcoder2_15b().with_overrides(
        name="starcoder2-15b-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512)
