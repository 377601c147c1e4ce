"""Architecture registry of the port: importing this package populates
repro_torch.config._REGISTRY with every arch the reference defines."""
from repro_torch.configs import (  # noqa: F401
    deepseek_v2_236b,
    gemma_7b,
    grok1_314b,
    musicgen_medium,
    paligemma_3b,
    qwen2_0_5b,
    rwkv6_7b,
    smollm_135m,
    starcoder2_15b,
    vit_base_paper,
    zamba2_2_7b,
)
