"""Gemma-7B — dense, GeGLU, head_dim=256.

[arXiv:2403.08295] 28L, d_model=3072, 16 heads (kv=16; the 2B variant uses
MQA), head_dim=256, d_ff=24576, vocab=256000, GeGLU, RMSNorm, tied
embeddings. The paper scales the embeddings by sqrt(d_model); the
reference's model (``repro/models/transformer.py::_embed``) does not, and
neither does the port, which copies the code (ROADMAP Queue 3).
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("gemma-7b")
def gemma_7b() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=16,
        num_kv_heads=16,
        d_ff=24576,
        vocab_size=256000,
        head_dim=256,
        norm="rmsnorm",
        activation="geglu",
        tie_embeddings=True,
        source="arXiv:2403.08295",
    )


def reduced() -> ModelConfig:
    return gemma_7b().with_overrides(
        name="gemma-7b-reduced", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512)
