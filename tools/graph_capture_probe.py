#!/usr/bin/env python3
"""Two facts behind the fused engine's CUDA graphs, measured on the card.

    python3 tools/graph_capture_probe.py [--windows N]

1. The profiler and graph replays: a fused round of the reduced ViT is
   captured once, then each replayed round is profiled in its own
   torch.profiler window, N windows with no pause around the round and N
   with 0.5 s pauses before and after it (``chip_smoke.py``'s SETTLE_S).
   Prints the ``lora_matmul`` and flash kernel records each window saw,
   against the 180 and 30 a round launches.
2. Which steps of ``merged_svd`` a capture takes: ``torch.linalg.qr`` at
   the shapes of vit-base-paper's merged deltas (12 layers, d 768 and
   3072, sketch width 40), then ``torch.linalg.svd`` of the small matrix.
   A failed capture leaves the context unusable, so the SVD comes last.

Needs one NVIDIA card; prints the card's name and power limit first.
"""
import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.sim.simulator import IoVSimulator, SimConfig  # noqa: E402

KERNELS = ("lora_mm_kernel", "fa_kernel")


def records(sim, pause):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pause)
        sim.run_round()
        torch.cuda.synchronize()
        time.sleep(pause)
    seen = dict.fromkeys(KERNELS, 0)
    for e in prof.key_averages():
        for k in KERNELS:
            if f"::{k}<" in e.key:
                seen[k] += e.count
    return seen


def capture(name, fn, *args):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            fn(*args)
        g.replay()
        torch.cuda.synchronize()
        print(f"[2] capture {name}: ok", flush=True)
        return True
    except Exception as e:  # the probe reports what refuses a capture
        print(f"[2] capture {name}: refused ({type(e).__name__}: "
              f"{str(e).splitlines()[0][:160]})", flush=True)
        return False


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("graph_capture_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    sim = IoVSimulator(SimConfig(engine="fused"), device="cuda")
    sim.run_round()   # warm-up, capture, first replay
    for pause in (0.0, 0.5):
        seen = [records(sim, pause) for _ in range(args.windows)]
        print(f"[1] pause {pause} s, {args.windows} replayed rounds, kernel "
              f"records of (lora_mm_kernel, fa_kernel), 180 and 30 "
              f"launched: {[tuple(s.values()) for s in seen]}", flush=True)
    del sim
    torch.cuda.empty_cache()
    for d2 in (768, 3072):
        y = torch.randn(12, d2, 40, device="cuda")
        capture(f"torch.linalg.qr (12, {d2}, 40)", torch.linalg.qr, y)
    b = torch.randn(12, 40, 3072, device="cuda")
    capture("torch.linalg.svd (12, 40, 3072)",
            lambda t: torch.linalg.svd(t, full_matrices=False), b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
