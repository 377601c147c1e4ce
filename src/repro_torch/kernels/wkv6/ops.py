"""Wrapper for the WKV6 kernel (``csrc/wkv6.cu``).

``wkv6(r, k, v, logw, u)`` takes the models' layout, r, k, v and logw
(B, S, H, K) and u (H, K), and returns y (B, S, H, K) in r's dtype and
the final state (B, H, K, K) in f32, from a zero state. r, k and v share
one dtype, f32 or bf16; logw is f32 or that same dtype (the model hands
over its bf16 activations and its f32 log-decays as they are).

On a CUDA tensor the kernel launches (or the call raises). It reads the
(B, S, H, K) tensors in place, widens them to f32 on load and runs its
own 16-row chunks, one block per (b, h, slice of value columns); the
slice width comes from :func:`plan`, plain Python the CPU tests check.
On a CPU tensor the plain version runs as the reference's Pallas wrapper
(``repro/kernels/wkv6/ops.py``) runs its kernel: in f32, S padded to a
multiple of ``c = min(CHUNK, S)`` with k = 0, v = 0, r = 0 and logw = 0
steps (which neither write nor decay the state), then
:func:`.ref.wkv6_chunked` at chunk c. There is no fallback from one to
the other.

``launches`` counts kernel launches, and nothing else.

Gradients: an ``autograd.Function`` whose backward differentiates the
plain version. The reference has no backward kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.wkv6.ref import wkv6_chunked

launches = 0

CHUNK = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64)
# (VS, VT) the kernel is built for, by head dim: VS value columns per
# block, VT per consumer thread
SLICES = {16: ((16, 1),), 32: ((32, 1),), 64: ((32, 1), (64, 2))}
_lib = None


def plan(B: int, H: int, K: int, sms: int = 132) -> tuple:
    """(VS, VT, grid) of the kernel: VS value columns per block, VT per
    consumer thread, and the grid (H·K/VS, B). At K 64 a block takes the
    whole head (64 columns, two per consumer lane) once the H·B heads
    cover more than half of the ``sms`` SMs, and half of it (32 columns,
    twice the blocks) below that: on an NVIDIA H100 80GB HBM3 at 700 W
    the whole head was the faster at rwkv6-7b's B 4 (0.0368 against
    0.0586 ms at S 128) and B 2 (0.0297 against 0.0321), the half at B 1
    (0.0250 against 0.0273; PERF.md, Findings). K 16 and 32
    have one built case each. The plan depends on neither S nor the
    dtypes."""
    if K == 64:
        vs, vt = (64, 2) if 2 * H * B > sms else (32, 1)
    else:
        vs, vt = SLICES[K][0]
    return vs, vt, (H * (K // vs), B)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("wkv6")
        lib.wkv6_launch.restype = ctypes.c_int
        lib.wkv6_launch.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.c_void_p])
        _lib = lib
    return _lib


def _check(r, k, v, logw, u):
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(
            "wkv6 wants r, k, v, logw of one shape (B,S,H,K); got "
            f"{tuple(r.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
            f"{tuple(logw.shape)}")
    _, S, H, K = r.shape
    if u.shape != (H, K):
        raise ValueError(f"wkv6 wants u (H,K) = {(H, K)}, got "
                         f"{tuple(u.shape)}")
    if S < 1:
        raise ValueError(f"wkv6 needs S >= 1, got S={S}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError("r, k, v must share float32 or bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if logw.dtype not in (torch.float32, r.dtype):
        raise TypeError(f"logw must be float32 or r's dtype {r.dtype}, got "
                        f"{logw.dtype}")
    if len({t.device for t in (r, k, v, logw, u)}) != 1:
        raise ValueError("wkv6 operands on several devices")


def _plain(r, k, v, logw, u, chunk=CHUNK):
    S = r.shape[1]
    c = min(chunk, S)
    pad = (-S) % c
    args = [t.float() for t in (r, k, v, logw)]
    if pad:
        # k = 0 (no state writes) and logw = 0 (no decay) steps
        args = [F.pad(t, (0, 0, 0, 0, 0, pad)) for t in args]
    y, state = wkv6_chunked(*args, u.float(), c)
    return y[:, :S].to(r.dtype), state


def _launch(r, k, v, logw, u):
    global launches
    B, S, H, K = r.shape
    if K not in HEAD_DIMS:
        raise ValueError(f"wkv6 kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {K}")
    vs, vt, _ = plan(B, H, K, _sm_count(r.device))
    operands = []
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        if not t.is_contiguous():
            raise ValueError(f"wkv6 kernel needs a contiguous {name}")
        # the kernel loads 16-byte units: a view that starts off a
        # 16-byte boundary is copied to a fresh allocation
        operands.append(t if t.data_ptr() % 16 == 0 else t.clone())
    r, k, v, logw = operands
    u = u.to(torch.float32).contiguous()
    y = torch.empty_like(r)
    state = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = _kernel_lib().wkv6_launch(
        _DTYPES[r.dtype], _DTYPES[logw.dtype], r.data_ptr(), k.data_ptr(),
        v.data_ptr(), logw.data_ptr(), u.data_ptr(), y.data_ptr(),
        state.data_ptr(), B, S, H, K, vs, vt, stream)
    _build.check("wkv6", rc)
    launches += 1
    return y, state


def _forward(r, k, v, logw, u):
    if r.device.type == "cpu":
        return _plain(r, k, v, logw, u)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on cuda or cpu, not {r.device}")
    return _launch(r, k, v, logw, u)


class _WKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, logw, u):
        ctx.save_for_backward(r, k, v, logw, u)
        return _forward(r, k, v, logw, u)

    @staticmethod
    def backward(ctx, gy, gstate):
        inputs = [t.detach().requires_grad_(need) for t, need
                  in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            outs = _plain(*inputs)
        pairs = [(o, g) for o, g in zip(outs, (gy, gstate)) if g is not None]
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                         [g for _, g in pairs],
                                         allow_unused=True))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor):
    """r,k,v (B, S, H, K) in one dtype, logw (B, S, H, K) in f32 or that
    dtype; u (H, K) → (y (B,S,H,K) in r.dtype, final state (B,H,K,K)
    f32)."""
    _check(r, k, v, logw, u)
    operands = (r, k, v, logw, u)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return _WKV6.apply(*operands)
    return _forward(*operands)
