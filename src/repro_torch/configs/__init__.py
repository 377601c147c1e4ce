"""Architecture registry of the port: importing this package populates
repro_torch.config._REGISTRY. Only the archs whose block kinds the port
runs are here."""
from repro_torch.configs import qwen2_0_5b, rwkv6_7b, vit_base_paper  # noqa: F401
