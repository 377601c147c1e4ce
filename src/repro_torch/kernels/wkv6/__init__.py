from repro_torch.kernels.wkv6.ops import wkv6  # noqa: F401
