from repro_torch.kernels.lora_matmul.ops import lora_matmul  # noqa: F401
