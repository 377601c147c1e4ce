#!/usr/bin/env python3
"""What each phase of the wkv6 kernel costs, on an NVIDIA card.

    python3 tools/wkv6_phase_probe.py

Builds copies of ``src/repro_torch/kernels/wkv6/csrc/wkv6.cu`` in which
one phase or more is switched off by a macro (a loop bound set to 0 at
compile time; the results are wrong and are not checked), and times each
copy at rwkv6-7b's heads (64 of 64) in the model's dtypes (bf16 r, k, v;
f32 logw) at the plan's (value slice, columns per thread), each call
after a 1 GiB L2 flush, median of 15:

- ``all``: the kernel as it is;
- ``no_scores``: the producers skip the Q x Q scores;
- ``no_producer``: the producers skip the decays and the scores (the
  consumers' path and the skeleton remain);
- ``no_consumer``: the consumers skip the state products (the
  producers' path and the skeleton remain);
- ``nothing``: both, and no tile loads or y stores: launch, barriers and
  the chunk loop alone.

At B 1 (an SM holds at most one block) a copy's time is the longer of
its paths' latencies; at the served B 4 the paths share the SMs' issue
slots and shared-memory bandwidth. Needs a card and nvcc; writes the
copies under the git-ignored kernels/.build/.
"""
import ctypes
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.wkv6 import ops as wkv  # noqa: E402

SWITCHES = ("P_PREP", "P_SCORES", "P_YI", "P_ST", "P_AV", "P_LD", "P_STY")
# the loop or statement each switch guards, as it reads in the source
GUARDS = [
    ("for (int x = tid; x < 2 * K; x += NP) {",
     "for (int x = tid; P_PREP && x < 2 * K; x += NP) {"),
    ("if (tid < 8 * G) {", "if (P_SCORES && tid < 8 * G) {"),
    ("for (int c = 0; c < CQ; c += 4) {\n#pragma unroll\n"
     "          for (int i = 0; i < 8; ++i) {",
     "for (int c = 0; P_YI && c < CQ; c += 4) {\n#pragma unroll\n"
     "          for (int i = 0; i < 8; ++i) {"),
    ("for (int j = 0; j < Q; ++j) {\n#pragma unroll\n"
     "        for (int c = 0; c < CQ; c += 4) {",
     "for (int j = 0; P_ST && j < Q; ++j) {\n#pragma unroll\n"
     "        for (int c = 0; c < CQ; c += 4) {"),
    ("for (int j = 0; j < Q; j += 4) {\n          const float4 aa",
     "for (int j = 0; P_AV && j < Q; j += 4) {\n          const float4 aa"),
    ("          cp_async16(dst + (buf", "          if (P_LD) cp_async16(dst + (buf"),
    ("if (cols && t0 + i < S) store_row", "if (P_STY && cols && t0 + i < S) store_row"),
]
COPIES = {
    "all": (),
    "no_scores": ("P_SCORES",),
    "no_producer": ("P_PREP", "P_SCORES"),
    "no_consumer": ("P_YI", "P_ST", "P_AV"),
    "nothing": SWITCHES,
}


def probe_source() -> str:
    src = _build.source_of("wkv6").read_text()
    for old, new in GUARDS:
        if old not in src:
            raise SystemExit(f"wkv6_phase_probe: the source no longer has "
                             f"{old!r}; update GUARDS")
        src = src.replace(old, new, 1)
    head = "".join(f"#ifndef {m}\n#define {m} 1\n#endif\n" for m in SWITCHES)
    return src.replace("namespace {\n", head + "namespace {\n", 1)


def build_copies():
    out_dir = _build.BUILD_DIR / "wkv6_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "wkv6_probe.cu"
    src.write_text(probe_source())
    nvcc = _build._nvcc()
    procs = {}
    for name, off in COPIES.items():
        lib = out_dir / f"libwkv6_{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, *[f"-D{m}=0" for m in off],
               "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"wkv6_phase_probe: build of {name} failed:\n"
                             f"{log}")
        handle = ctypes.CDLL(str(lib))
        handle.wkv6_launch.restype = ctypes.c_int
        handle.wkv6_launch.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.c_void_p])
        libs[name] = handle
    return libs


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
        print("wkv6_phase_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    libs = build_copies()
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    H = K = 64
    stream = torch.cuda.current_stream().cuda_stream
    for B, S in ((4, 128), (1, 1024), (4, 1024)):
        r, k, v = (torch.randn((B, S, H, K), generator=g, device="cuda")
                   .bfloat16() for _ in range(3))
        logw = -torch.exp(torch.rand((B, S, H, K), generator=g,
                                     device="cuda") * 5.0 - 6.0)
        u = 0.1 * torch.randn((H, K), generator=g, device="cuda")
        y = torch.empty_like(r)
        state = torch.empty((B, H, K, K), device="cuda")
        vs, vt, grid = wkv.plan(B, H, K, sms)
        times = []
        for name, lib in libs.items():
            def call():
                return lib.wkv6_launch(
                    1, 0, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                    logw.data_ptr(), u.data_ptr(), y.data_ptr(),
                    state.data_ptr(), B, S, H, K, vs, vt, stream)
            if call() != 0:
                raise SystemExit(f"wkv6_phase_probe: {name} did not launch")
            times.append(f"{name} {timed_ms(call, flush):.4f}")
        print(f"wkv6 phases B={B} S={S} VS={vs} VT={vt} grid {grid} (ms): "
              + ", ".join(times), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
