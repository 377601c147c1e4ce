"""PaliGemma-3B — VLM: SigLIP vision encoder (STUB) + Gemma-2B decoder.

[arXiv:2407.07726] decoder: 18L, d_model=2048, 8 heads (MQA kv=1),
head_dim=256, d_ff=16384, GeGLU, RMSNorm, vocab=257216. The SigLIP frontend
is a stub, as in the reference: the caller passes 256 precomputed patch
embeddings of width d_model (post-projector) as ``prefix_embeds``.
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("paligemma-3b")
def paligemma_3b() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b",
        family="vlm",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        d_ff=16384,
        vocab_size=257216,
        head_dim=256,
        norm="rmsnorm",
        activation="geglu",
        tie_embeddings=True,
        frontend="vision",
        num_prefix_embeds=256,
        source="arXiv:2407.07726",
    )


def reduced() -> ModelConfig:
    return paligemma_3b().with_overrides(
        name="paligemma-3b-reduced", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=1, head_dim=32, d_ff=256, vocab_size=512,
        num_prefix_embeds=8)
