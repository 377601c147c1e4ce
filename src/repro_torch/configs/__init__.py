"""Architecture registry of the port: importing this package populates
repro_torch.config._REGISTRY. Only the archs whose block kinds the port
runs are here."""
from repro_torch.configs import (  # noqa: F401
    qwen2_0_5b,
    rwkv6_7b,
    smollm_135m,
    starcoder2_15b,
    vit_base_paper,
)
