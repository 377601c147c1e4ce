"""SmolLM-135M — llama-architecture small dense model.

[hf:HuggingFaceTB/SmolLM-135M] 30L, d_model=576, 9 heads (GQA kv=3),
d_ff=1536, vocab=49152, RoPE, RMSNorm, SwiGLU, tied embeddings.
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("smollm-135m")
def smollm_135m() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        family="dense",
        num_layers=30,
        d_model=576,
        num_heads=9,
        num_kv_heads=3,
        d_ff=1536,
        vocab_size=49152,
        head_dim=64,
        rope_theta=10000.0,
        norm="rmsnorm",
        activation="swiglu",
        tie_embeddings=True,
        source="hf:HuggingFaceTB/SmolLM-135M",
    )


def reduced() -> ModelConfig:
    return smollm_135m().with_overrides(
        name="smollm-135m-reduced", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512)
