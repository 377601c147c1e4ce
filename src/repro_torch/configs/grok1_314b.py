"""Grok-1-314B — MoE, 8 experts top-2.

[hf:xai-org/grok-1] 64L, d_model=6144, 48 heads (GQA kv=8), head_dim=128,
expert d_ff=32768, 8 experts top-2, vocab=131072, GELU experts, RMSNorm,
attention/final logit softcap 30 (the model applies the final one, as the
reference's does).
"""
from repro_torch.config import MoEConfig, ModelConfig, register_arch


@register_arch("grok-1-314b")
def grok1_314b() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=32768,
        vocab_size=131072,
        head_dim=128,
        norm="rmsnorm",
        activation="gelu",
        logits_softcap=30.0,
        moe=MoEConfig(num_experts=8, top_k=2, num_shared_experts=0,
                      expert_d_ff=32768),
        source="hf:xai-org/grok-1",
    )


def reduced() -> ModelConfig:
    return grok1_314b().with_overrides(
        name="grok-1-314b-reduced", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=0,
                      expert_d_ff=512))
