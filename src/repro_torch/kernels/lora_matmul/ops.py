"""Wrapper for the fused LoRA GEMM kernel (``csrc/lora_matmul.cu``).

``lora_matmul(x, w, a, b, scale, mask)`` with a lane axis: x (L, M, K) and
W (K, N) in the model dtype (f32 or bf16), a (L, K, r), b (L, r, N),
scale (L,) and mask (L, r) in f32. W is shared by the lanes; everything
else is per lane. Prefill calls it with L = 1; multi-tenant decode with
L = max_batch and M = 1, so one launch serves every tenant.

``t = x·A`` is computed here with ``torch.matmul`` (the reference also
computes it outside its Pallas kernel); the kernel does ``x·W`` and the
adapter epilogue. On a CUDA tensor the kernel launches (or the call
raises); on a CPU tensor the plain version in :mod:`.ref` runs. There is
no fallback from one to the other.

``launches`` counts kernel launches, and nothing else.

Gradients: an ``autograd.Function`` whose backward differentiates the
plain version, as the reference's ``custom_vjp`` does. Serving needs no
gradients; the Function is only entered when one is asked for.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lora_matmul.ref import lora_matmul_ref

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("lora_matmul")
        lib.lora_matmul_launch.restype = ctypes.c_int
        lib.lora_matmul_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
            + [ctypes.c_void_p])
        _lib = lib
    return _lib


def _check(x, w, a, b, scale, mask):
    if x.dim() != 3 or w.dim() != 2 or a.dim() != 3 or b.dim() != 3:
        raise ValueError(
            "lora_matmul wants x (L,M,K), w (K,N), a (L,K,r), b (L,r,N); got "
            f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(a.shape)}, "
            f"{tuple(b.shape)}")
    L, _, K = x.shape
    N = w.shape[1]
    r = a.shape[-1]
    if (w.shape[0] != K or a.shape != (L, K, r) or b.shape != (L, r, N)
            or scale.shape != (L,) or mask.shape != (L, r)):
        raise ValueError(
            f"lora_matmul shape mismatch: x {tuple(x.shape)}, w "
            f"{tuple(w.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)}, "
            f"scale {tuple(scale.shape)}, mask {tuple(mask.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must share float32 or bfloat16, got "
                        f"{x.dtype} and {w.dtype}")
    for name, t in (("a", a), ("b", b), ("scale", scale), ("mask", mask)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    devs = {t.device for t in (x, w, a, b, scale, mask)}
    if len(devs) != 1:
        raise ValueError(f"lora_matmul operands on several devices: {devs}")


def _launch(x, w, t, b, scale, mask) -> torch.Tensor:
    global launches
    for name, v in (("x", x), ("w", w), ("t", t), ("b", b),
                    ("scale", scale), ("mask", mask)):
        if not v.is_contiguous():
            raise ValueError(f"lora_matmul kernel needs a contiguous {name}")
    L, M, K = x.shape
    N = w.shape[1]
    r = t.shape[-1]
    y = torch.empty((L, M, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel_lib().lora_matmul_launch(
        _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), t.data_ptr(),
        b.data_ptr(), scale.data_ptr(), mask.data_ptr(), y.data_ptr(),
        L * M, M, K, N, r, stream)
    _build.check("lora_matmul", rc)
    launches += 1
    return y


def _forward(x, w, a, b, scale, mask) -> torch.Tensor:
    if x.device.type == "cpu":
        return lora_matmul_ref(x, w, a, b, scale, mask)
    if x.device.type != "cuda":
        raise ValueError(f"lora_matmul runs on cuda or cpu, not {x.device}")
    t = x.to(a.dtype) @ a
    return _launch(x, w, t, b, scale, mask)


class _LoraMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, a, b, scale, mask):
        ctx.save_for_backward(x, w, a, b, scale, mask)
        return _forward(x, w, a, b, scale, mask)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need) for t, need
                  in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = lora_matmul_ref(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, g, allow_unused=True))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs)


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """y = x·W + scale·((x·A)⊙mask)·B per lane → (L, M, N) in x.dtype."""
    _check(x, w, a, b, scale, mask)
    operands = (x, w, a, b, scale, mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return _LoraMatmul.apply(*operands)
    return _forward(*operands)
