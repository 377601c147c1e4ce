"""Run-mode constants and the device rule of the port.

Kernel dispatch is by device, not by a knob: on a kernel route a CUDA
tensor launches the hand-written kernel and a CPU tensor takes the
kernel's plain PyTorch version. The reference's ``USE_PALLAS_*`` and
``PALLAS_INTERPRET`` switches have no counterpart, so on the card the
kernel routes always launch the kernel.
"""
from __future__ import annotations

import torch

# FAST_DECODE: single-token decode attends directly over the cache with
# one grouped product (no blocked path, no materialized GQA repeat); off,
# decode takes the blocked route.
FAST_DECODE = True

# DIRECT_ATTN_MAX_SEQ: full-sequence attention off the flash route with
# Sq, Sk at or below this materializes the (Sq, Sk) scores directly;
# longer sequences take the blocked online-softmax route.
DIRECT_ATTN_MAX_SEQ = 64


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU. Asking for CUDA without a card raises; nothing drops to
    the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (want cuda or cpu)")
    return dev
