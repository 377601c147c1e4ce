"""DeepSeek-V2-236B — MoE with Multi-head Latent Attention (MLA).

[arXiv:2405.04434] 60L, d_model=5120, 128 heads, MLA kv_lora_rank=512,
q_lora_rank=1536, qk_nope=128/qk_rope=64/v=128 head dims; MoE with 2 shared +
160 routed experts, top-6, expert d_ff=1536; vocab=102400.
"""
from repro_torch.config import (BLOCK_MLA, MLAConfig, MoEConfig,
                                ModelConfig, register_arch)


@register_arch("deepseek-v2-236b")
def deepseek_v2_236b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,     # MLA: per-head KV reconstructed from latent
        d_ff=1536,            # expert intermediate size (assigned spec)
        vocab_size=102400,
        head_dim=128,
        norm="rmsnorm",
        activation="swiglu",
        block_pattern=tuple([BLOCK_MLA] * 60),
        moe=MoEConfig(num_experts=160, top_k=6, num_shared_experts=2,
                      expert_d_ff=1536),
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        source="arXiv:2405.04434",
    )


def reduced() -> ModelConfig:
    return deepseek_v2_236b().with_overrides(
        name="deepseek-v2-236b-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=4, head_dim=32, d_ff=128, vocab_size=512,
        block_pattern=tuple([BLOCK_MLA] * 2),
        moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=1,
                      expert_d_ff=128),
        mla=MLAConfig(kv_lora_rank=64, q_lora_rank=0, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32))
