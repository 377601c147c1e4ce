"""Wrapper for the flash attention kernel (``csrc/flash_attention.cu``).

Takes the models' layout, q (B, Sq, H, D) and k/v (B, Sk, Hkv, D), and
returns (B, Sq, H, D) in q's dtype. The kernel reads that layout in place:
no transposes and no padding (it masks the ragged Sq/Sk edges itself).

On a CUDA tensor a kernel launches (or the call raises); on a CPU
tensor the plain version (:func:`.ref.attention_ref`, on transposed
views) runs. The source holds two kernels behind one launch function;
:func:`variant` picks one from dtype and head dim (``mma``, the
tensor-core kernel, for bf16; ``simt`` for f32), and :func:`plan` sizes
the mma kernel's blocks. Both are plain Python, so the CPU tests check
them. The kernels load 16-byte units: an operand that starts off a
16-byte boundary is copied to a fresh allocation first. ``launches``
counts kernel launches, and nothing else; ``launches_by_variant`` splits
the same count by kernel.

Gradients: an ``autograd.Function`` whose backward recomputes through
the plain version, as the reference's ``custom_vjp`` does.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

launches = 0
launches_by_variant = {"mma": 0, "simt": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_VARIANTS = {"simt": 0, "mma": 1}
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
_lib = None


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel a call takes: ``"mma"`` or ``"simt"``.

    bf16 goes to the tensor cores (``mma.sync``, f32 accumulation); f32
    stays on the SIMT kernel, since the tensor cores take f32 only as
    TF32, which breaks the f32 tolerance. Both take the head dims in
    :data:`HEAD_DIMS`, and no other."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {head_dim}")
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel takes {_DTYPES}, got "
                        f"{dtype}")
    return "mma" if dtype == torch.bfloat16 else "simt"


def plan(Sq: int) -> int:
    """16-row q tiles (one warp each) per block of the mma kernel, one
    query head per block: 64-row blocks, fewer tiles where the prompt is
    shorter. On an NVIDIA H100 80GB HBM3 at 700 W this was the fastest
    block at every length timed, S 100 to 2048, ahead of 16-, 32- and
    128-row blocks and of whole GQA groups that share K and V (PERF.md,
    Findings)."""
    return min(4, -(-Sq // 16))


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        _lib = lib
    return _lib


def _check(q, k, v, sliding_window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            "flash_attention wants q (B,Sq,H,D) and k, v (B,Sk,Hkv,D); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv < 1 or H % Hkv:
        raise ValueError(
            f"flash_attention shape mismatch: q {tuple(q.shape)}, "
            f"k/v {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention operands on several devices")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError("sliding_window must be >= 1 or None")


def _plain(q, k, v, causal, sliding_window, sm_scale):
    return attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, sliding_window=sliding_window,
        sm_scale=sm_scale).transpose(1, 2)


def _launch(q, k, v, causal, sliding_window, sm_scale) -> torch.Tensor:
    global launches
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    kind = variant(q.dtype, D)
    operands = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel needs a contiguous "
                             f"{name}")
        operands.append(t if t.data_ptr() % 16 == 0 else t.clone())
    q, k, v = operands
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel_lib().flash_attention_launch(
        _VARIANTS[kind], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), B, Sq, Sk, H, Hkv, D, float(sm_scale), int(causal),
        int(sliding_window or 0), plan(Sq), stream)
    _build.check("flash_attention", rc)
    launches += 1
    launches_by_variant[kind] += 1
    return o


def _forward(q, k, v, causal, sliding_window, sm_scale):
    if q.device.type == "cpu":
        return _plain(q, k, v, causal, sliding_window, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k, v, causal, sliding_window, sm_scale)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window, sm_scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, sliding_window, sm_scale)
        return _forward(q, k, v, causal, sliding_window, sm_scale)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need) for t, need
                  in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            out = _plain(*inputs, *ctx.args)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g, allow_unused=True))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs) + (None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sliding_window: Optional[int] = None,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D) → (B, Sq, H, D)."""
    _check(q, k, v, sliding_window)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, sliding_window,
                                     sm_scale)
    return _forward(q, k, v, causal, sliding_window, sm_scale)
