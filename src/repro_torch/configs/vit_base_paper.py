"""ViT-Base — the paper's own backbone for federated fine-tuning.

[arXiv:2010.11929, used by the paper §V-A] 12L encoder, d_model=768,
12 heads, d_ff=3072, LayerNorm, GELU. LoRA adapters on the attention and
FF linears, classification head per perception task. The simulator's
default training model is the reduced variant; the cost model always
reads the full one.
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("vit-base-paper")
def vit_base_paper() -> ModelConfig:
    return ModelConfig(
        name="vit-base-paper",
        family="dense",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=1000,      # classification head width (max classes)
        head_dim=64,
        norm="layernorm",
        activation="gelu",
        source="arXiv:2010.11929 (paper §V-A backbone)",
    )


def reduced() -> ModelConfig:
    return vit_base_paper().with_overrides(
        name="vit-tiny-paper", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=64)


def fleet() -> ModelConfig:
    """Fleet-scale variant: the per-vehicle workload for simulations of
    very large fleets."""
    return vit_base_paper().with_overrides(
        name="vit-fleet-paper", num_layers=2, d_model=32, num_heads=2,
        num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64)
