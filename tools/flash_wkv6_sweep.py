#!/usr/bin/env python3
"""Where the flash_attention and wkv6 kernels spend their time, on an
NVIDIA card.

    python3 tools/flash_wkv6_sweep.py [flash] [wkv6]

(both when neither is named)
Times each call after a 1 GiB L2 flush, median of 15, as
``chip_smoke.py`` does, and prints one line per case:

- flash_attention, bf16 (the tensor-core kernel, at the block
  ``ops.plan`` picks), at qwen2-0.5b's heads (14/2, head dim 64), batch
  4, S 100 / 128 / 512 / 2048, with its TFLOP/s and SDPA beside each S
  as the yardstick, and the f32 SIMT kernel at S 128.
- wkv6 at rwkv6-7b's heads (64 of 64) in the model's dtypes (bf16 r, k,
  v; f32 logw), at the (value slice, columns per thread) ``ops.plan``
  picks: B 1, 2, 4 at S 128 and 1024; then S over 16 .. 1024 at B 1 (a
  quarter of the served grid, so an SM holds at most one block and the
  time per chunk is close to the latency of one chunk step) and at B 4
  (the served grid, where the time per chunk is what the SMs get
  through). The per-chunk slopes of the two tell a chunk step bound by
  its latency from one bound by the SM's issue and shared-memory
  traffic.
- A 4 MB fill, the cost of any launch under this timing.

Needs a card; builds the two kernels from the checkout and prints
ptxas's registers, shared memory and spills for each kernel.
"""
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.wkv6 import ops as wkv  # noqa: E402

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


def flash(flush, g):
    H, Hkv, D, B = 14, 2, 64, 4
    for S in (100, 128, 512, 2048):
        q = torch.randn((B, S, H, D), generator=g, device="cuda").bfloat16()
        k, v = (torch.randn((B, S, Hkv, D), generator=g, device="cuda"
                            ).bfloat16() for _ in range(2))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), flush)
        flops = 4.0 * B * H * D * S * (S + 1) / 2
        ms = timed_ms(lambda: fa.flash_attention(q, k, v), flush)
        print(f"flash mma B={B} S={S} H={H}/{Hkv} D={D} "
              f"{16 * fa.plan(S)}-row blocks: {ms:.4f} ms, "
              f"{flops / ms / 1e9:.1f} TFLOP/s (SDPA {sdpa:.4f} ms)",
              flush=True)
        if S == 128:
            qf, kf, vf = (t.float() for t in (q, k, v))
            ms = timed_ms(lambda: fa.flash_attention(qf, kf, vf), flush)
            print(f"flash simt f32 B={B} S={S}: {ms:.4f} ms", flush=True)


def wkv_args(B, S, H, K, g):
    r, k, v = (torch.randn((B, S, H, K), generator=g, device="cuda"
                           ).bfloat16() for _ in range(3))
    logw = -torch.exp(torch.rand((B, S, H, K), generator=g, device="cuda")
                      * 5.0 - 6.0)
    u = 0.1 * torch.randn((H, K), generator=g, device="cuda")
    return r, k, v, logw, u


def wkv6(flush, g):
    H, K = 64, 64
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B in (1, 2, 4):
        vs, vt, grid = wkv.plan(B, H, K, sms)
        for S in (128, 1024):
            args = wkv_args(B, S, H, K, g)
            ms = timed_ms(lambda: wkv.wkv6(*args), flush)
            print(f"wkv6 bf16/f32logw B={B} S={S} H={H} K={K} VS={vs} "
                  f"VT={vt} grid {grid}: {ms:.4f} ms", flush=True)
    for B in (1, 4):
        pts = []
        for S in (16, 64, 128, 300, 512, 1024):
            args = wkv_args(B, S, H, K, g)
            ms = timed_ms(lambda: wkv.wkv6(*args), flush)
            pts.append((-(-S // 16), ms))
            print(f"wkv6 plan {wkv.plan(B, H, K, sms)[:2]} B={B} S={S} "
                  f"({pts[-1][0]} chunks): {ms:.4f} ms", flush=True)
        (c0, t0), (c1, t1) = pts[1], pts[-1]
        print(f"wkv6 plan {wkv.plan(B, H, K, sms)[:2]} B={B}: "
              f"{(t1 - t0) / (c1 - c0) * 1e3:.3f} us per chunk step "
              f"(S 64 -> 1024), grid {wkv.plan(B, H, K, sms)[2]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_wkv6_sweep: needs an NVIDIA card", file=sys.stderr)
        return 2
    _build.build(["flash_attention", "wkv6"])
    for name, log in _build.build_logs.items():
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif entry and ("registers" in line or "spill" in line):
                print(f"ptxas {name} {entry}: {line.split(':', 1)[-1].strip()}")
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    fill = torch.empty(1 << 22, dtype=torch.uint8, device="cuda")
    print(f"4 MB fill: {timed_ms(lambda: fill.zero_(), flush):.4f} ms")
    which = sys.argv[1:] or ["flash", "wkv6"]
    if "flash" in which:
        flash(flush, g)
    if "wkv6" in which:
        wkv6(flush, g)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
