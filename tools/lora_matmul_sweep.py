#!/usr/bin/env python3
"""Where a lora_matmul launch spends its time, on an NVIDIA card.

    python3 tools/lora_matmul_sweep.py

Times the kernel alone (``ops._launch`` with t = x·A given), each call
after a 1 GiB L2 flush, median of 15, as ``chip_smoke.py`` does: the
wgmma kernel at 512 rows and N 4096 over K (its per-k-tile slope and its
fixed cost), with and without the adapter (r 64 and r 0); the split-K
kernel at 4 lanes over K and N; beside each, cuBLAS's x·W alone
(``x @ w``, no adapter) as a yardstick; both wgmma tiles (128 x 128 and
64 x 64) at every served prefill shape, against the one
``ops.wgmma_tile`` picks; and a 4 MB fill, the cost of any launch under
this timing. Prints one line per case and the card's name and power
limit; needs a card, builds the kernels from the checkout.
"""
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.lora_matmul import ops as lm  # noqa: E402

CASES = [  # (L, M, K, N, r)
    (1, 512, 64, 4096, 64), (1, 512, 1024, 4096, 64),
    (1, 512, 4096, 4096, 64), (1, 512, 4096, 4096, 0),
    (1, 512, 8192, 4096, 64), (1, 512, 14336, 4096, 64),
    (1, 512, 896, 896, 64), (1, 512, 896, 896, 0),
    (4, 1, 64, 4096, 64), (4, 1, 896, 896, 64), (4, 1, 4096, 4096, 64),
    (4, 1, 4096, 4096, 0), (4, 1, 4096, 14336, 64), (4, 1, 14336, 4096, 64),
]


def timed_ms(fn, flush, reps=15):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("lora_matmul_sweep: needs an NVIDIA card", file=sys.stderr)
        return 2
    _build.build(["lora_matmul"])
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    for L, M, K, N, r in CASES:
        x = torch.randn((L, M, K), generator=g, device="cuda").bfloat16()
        w = (torch.randn((K, N), generator=g, device="cuda")
             / K ** 0.5).bfloat16()
        t = torch.randn((L, M, r), generator=g, device="cuda")
        b = torch.randn((L, r, N), generator=g, device="cuda")
        scale = torch.ones(L, device="cuda")
        mask = torch.ones((L, r), device="cuda")
        kind = lm.variant(L * M, K, N, x.dtype, True)
        ms = timed_ms(lambda: lm._launch(x, w, t, b, scale, mask), flush)
        xw = timed_ms(lambda: x @ w, flush)
        print(f"{kind} L={L} M={M} K={K} N={N} r={r}: {ms:.4f} ms "
              f"(cuBLAS x·W alone {xw:.4f} ms)", flush=True)
    # the wgmma tile rule against both tiles, at the served prefill shapes
    stream = torch.cuda.current_stream().cuda_stream
    for K, N in ((896, 896), (896, 4864), (4864, 896), (4096, 4096),
                 (4096, 14336), (14336, 4096)):
        rows, r = 512, 64
        x = torch.randn((1, rows, K), generator=g, device="cuda").bfloat16()
        w = (torch.randn((K, N), generator=g, device="cuda")
             / K ** 0.5).bfloat16()
        t = torch.randn((1, rows, r), generator=g, device="cuda")
        b = torch.randn((1, r, N), generator=g, device="cuda")
        scale = torch.ones(1, device="cuda")
        mask = torch.ones((1, r), device="cuda")
        y = torch.empty((1, rows, N), dtype=x.dtype, device="cuda")
        times = []
        for bm, bn in ((128, 128), (64, 64)):
            def launch():
                rc = lm._kernel_lib().lora_matmul_launch(
                    2, 1, x.data_ptr(), w.data_ptr(), t.data_ptr(),
                    b.data_ptr(), scale.data_ptr(), mask.data_ptr(),
                    y.data_ptr(), None, None, rows, rows, K, N, r, bm, bn,
                    stream)
                _build.check("lora_matmul", rc)
            blocks = -(-rows // bm) * -(-N // bn)
            times.append(f"{bm}x{bn} {timed_ms(launch, flush):.4f} ms "
                         f"({blocks} blocks)")
        print(f"wgmma tiles at {rows}x{K}->{N}: {', '.join(times)}; the "
              f"rule picks {lm.wgmma_tile(rows, N, lm._sm_count(x.device))}",
              flush=True)
    fill = torch.empty(1 << 20, device="cuda")
    print(f"4 MB fill: {timed_ms(fill.zero_, flush):.4f} ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
