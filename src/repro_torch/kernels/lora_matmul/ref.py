"""Plain PyTorch version of the fused LoRA GEMM, with a lane axis.

Op for op the reference's ``repro/kernels/lora_matmul/ops.py::_ref``
(the expression the reference differentiates, and the plain path of
``core/lora.apply_lora_linear``): the base product is cast to the model
dtype first and the adapter term is added after. The CUDA kernel adds the
adapter to its f32 accumulator before it casts, so in bf16 the two differ
by rounding; in f32 they agree to reassociation.
"""
from __future__ import annotations

import torch


def lora_matmul_ref(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, scale: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """y = x·W + scale·((x·A)⊙mask)·B per lane.

    x (L, M, K), w (K, N), a (L, K, r), b (L, r, N), scale (L,),
    mask (L, r) → (L, M, N) in x.dtype.
    """
    return lora_matmul_ref_t(x, w, x.to(a.dtype) @ a, b, scale, mask)


def lora_matmul_ref_t(x, w, t, b, scale, mask) -> torch.Tensor:
    """:func:`lora_matmul_ref` given t = x·A (the same operations after
    it), for callers that keep t."""
    t = t * mask[:, None, :]
    y = x @ w
    return y + (scale[:, None, None] * (t @ b)).to(y.dtype)
