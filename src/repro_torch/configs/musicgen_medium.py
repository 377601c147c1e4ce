"""MusicGen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284] 48L, d_model=1536, 24 heads (kv=24), d_ff=6144,
vocab=2048 (EnCodec codebook size), LayerNorm, GELU MLP. The EnCodec
conv-codec frontend is a stub, as in the reference: the model takes token
ids over the 2048-entry codebook, and no prefix embeddings.
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("musicgen-medium")
def musicgen_medium() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        head_dim=64,
        norm="layernorm",
        activation="gelu",
        frontend="audio",
        source="arXiv:2306.05284",
    )


def reduced() -> ModelConfig:
    return musicgen_medium().with_overrides(
        name="musicgen-medium-reduced", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512)
