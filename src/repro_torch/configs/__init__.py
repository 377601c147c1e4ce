"""Architecture registry of the port: importing this package populates
repro_torch.config._REGISTRY. Only the archs whose block kinds the port
runs are here (zamba2-2.7b is not, ROADMAP Queue 1, item 11)."""
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
)
