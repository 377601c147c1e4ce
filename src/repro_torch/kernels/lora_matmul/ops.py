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

The source holds three kernels behind one launch function; :func:`variant`
picks one from shape, dtype and alignment alone (``wgmma`` for bf16
prefill, ``splitk`` for few rows, ``simt`` for the rest), and
:func:`wgmma_tile` / :func:`splitk_plan` size its grid. These are plain
Python, so the CPU tests check them. Each call is one launch.

``launches`` counts kernel launches, and nothing else;
``launches_by_variant`` splits the same count by kernel.

Gradients: an ``autograd.Function`` with a closed-form backward in plain
PyTorch (the reference has no backward kernel either; its ``custom_vjp``
differentiates its plain version). With u = (g·Bᵀ)⊙mask:
dx = g·Wᵀ + scale·u·Aᵀ, dA = scale·xᵀ·u, dB = scale·((x·A)⊙mask)ᵀ·g, and
dW = xᵀ·g only when W asks for a grad (a frozen base never does). The
forward saves t = x·A, so the backward recomputes neither t nor the base
product x·W. Serving needs no gradients; the Function is only entered
when one is asked for.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lora_matmul.ref import lora_matmul_ref_t

launches = 0
launches_by_variant = {"wgmma": 0, "splitk": 0, "simt": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"simt": 0, "splitk": 1, "wgmma": 2}
# at most this many rows (L·M) go to the split-K kernel
SPLITK_MAX_ROWS = 16
# split-K: threads along N, the granule of a block's K chunk, and the
# floats of x's chunk (48 KB)
_SK_THREADS_N = 32
_SK_K_STEP = 32
_SK_X_FLOATS = 12288
_lib = None
# per device: split-K's column-strip tickets, zero between launches (the
# last block of a strip resets its own). Shared by every stream of the
# device, so two split-K launches must not run at once on two streams.
_tickets = {}


def variant(rows: int, K: int, N: int, dtype: torch.dtype,
            aligned: bool) -> str:
    """Which kernel a call takes: ``"wgmma"``, ``"splitk"`` or ``"simt"``.

    ``aligned``: x, W and B start on 16-byte boundaries and t's rows are
    whole 16-byte units (r % 4 == 0), as TMA and the 16-byte vector loads
    need. Split-K streams W in 16-byte vectors, so N must hold whole
    vectors; wgmma takes bf16 with K and N multiples of 8 (TMA's 16-byte
    strides)."""
    if not aligned or K == 0:
        return "simt"
    vec = 16 // dtype.itemsize
    if rows <= SPLITK_MAX_ROWS and N % vec == 0:
        return "splitk"
    if (rows > SPLITK_MAX_ROWS and dtype == torch.bfloat16
            and K % 8 == 0 and N % 8 == 0):
        return "wgmma"
    return "simt"


def wgmma_tile(rows: int, N: int, sms: int) -> tuple:
    """(BM, BN) of the wgmma kernel: 128 x 128 when its blocks keep at
    least 3/4 of the SMs busy over their waves (one 128 x 128 block fits
    an SM), else 64 x 64, four times the blocks."""
    blocks = -(-rows // 128) * -(-N // 128)
    if blocks >= 0.75 * sms * -(-blocks // sms):
        return 128, 128
    return 64, 64


def splitk_plan(rows: int, K: int, N: int, itemsize: int,
                sms: int) -> tuple:
    """(strips, chunk, splits) of the split-K kernel: column strips of
    32 threads x 16 bytes, and K cut into chunks (multiples of 32 rows) so
    that strips x splits fills the SMs once: two blocks per SM up to 4
    rows (the kernel's launch bounds make two fit), one above. A second,
    partial wave would double the time."""
    cols = _SK_THREADS_N * (16 // itemsize)
    strips = -(-N // cols)
    slots = sms * (2 if rows <= 4 else 1)
    splits = max(1, slots // strips)
    chunk = -(-(-(-K // splits)) // _SK_K_STEP) * _SK_K_STEP
    cap = max(_SK_K_STEP, _SK_X_FLOATS // rows // _SK_K_STEP * _SK_K_STEP)
    chunk = min(chunk, cap)
    return strips, chunk, -(-K // chunk)


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("lora_matmul")
        lib.lora_matmul_launch.restype = ctypes.c_int
        lib.lora_matmul_launch.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
            + [ctypes.c_void_p])
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ticket_buffer(device, strips: int) -> torch.Tensor:
    buf = _tickets.get(device)
    if buf is None or buf.numel() < strips:
        buf = torch.zeros(max(strips, 1024), dtype=torch.int32, device=device)
        _tickets[device] = buf
    return buf


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
    rows = L * M
    y = torch.empty((L, M, N), dtype=x.dtype, device=x.device)
    aligned = r % 4 == 0 and all(v.data_ptr() % 16 == 0 for v in (x, w, b))
    kind = variant(rows, K, N, x.dtype, aligned)
    part = tickets = None
    p0 = p1 = 0
    if kind == "splitk":
        strips, p0, p1 = splitk_plan(rows, K, N, x.element_size(),
                                     _sm_count(x.device))
        part = torch.empty((p1, rows, N), dtype=torch.float32,
                           device=x.device)
        tickets = _ticket_buffer(x.device, strips)
    elif kind == "wgmma":
        p0, p1 = wgmma_tile(rows, N, _sm_count(x.device))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel_lib().lora_matmul_launch(
        _VARIANTS[kind], _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
        t.data_ptr(), b.data_ptr(), scale.data_ptr(), mask.data_ptr(),
        y.data_ptr(), None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        rows, M, K, N, r, p0, p1, stream)
    _build.check("lora_matmul", rc)
    launches += 1
    launches_by_variant[kind] += 1
    return y


def _forward(x, w, a, b, scale, mask):
    """(y, t): the result and t = x·A, which the backward reuses."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lora_matmul runs on cuda or cpu, not {x.device}")
    t = x.to(a.dtype) @ a
    if x.device.type == "cpu":
        return lora_matmul_ref_t(x, w, t, b, scale, mask), t
    return _launch(x, w, t, b, scale, mask), t


def lora_matmul_backward(g, x, w, a, b, scale, mask, t, needs):
    """Closed-form gradients of y = x·W + scale·((x·A)⊙mask)·B per lane,
    for the operands flagged in ``needs`` (x, w, a, b, scale, mask);
    None for the rest. g (L, M, N) is dL/dy; t = x·A from the forward.
    The adapter terms run in f32 (the adapters' dtype); dx and dW come
    back in x's dtype."""
    need_x, need_w, need_a, need_b, need_s, need_m = needs
    gf = g.to(a.dtype)
    s3 = scale[:, None, None]
    gb = gf @ b.transpose(1, 2)                        # (L, M, r)
    u = gb * mask[:, None, :]
    dx = dw = da = db = ds = dm = None
    if need_x:
        dx = g @ w.T + (s3 * (u @ a.transpose(1, 2))).to(x.dtype)
    if need_w:       # one product over every lane's rows
        dw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
    if need_a:
        da = s3 * (x.to(a.dtype).transpose(1, 2) @ u)
    if need_b:
        db = s3 * ((t * mask[:, None, :]).transpose(1, 2) @ gf)
    if need_s:
        ds = (gf * ((t * mask[:, None, :]) @ b)).sum((1, 2))
    if need_m:
        dm = (s3 * gb * t).sum(1)
    return dx, dw, da, db, ds, dm


class _LoraMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, a, b, scale, mask):
        y, t = _forward(x, w, a, b, scale, mask)
        ctx.save_for_backward(x, w, a, b, scale, mask, t)
        return y

    @staticmethod
    def backward(ctx, g):
        return lora_matmul_backward(g.contiguous(), *ctx.saved_tensors,
                                    ctx.needs_input_grad)


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, scale: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """y = x·W + scale·((x·A)⊙mask)·B per lane → (L, M, N) in x.dtype."""
    _check(x, w, a, b, scale, mask)
    operands = (x, w, a, b, scale, mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return _LoraMatmul.apply(*operands)
    return _forward(*operands)[0]
