"""Builds the port's CUDA sources with ``nvcc`` at first use and loads them.

Each ``kernels/<name>/csrc/<name>.cu`` has a plain C interface and becomes
its own shared library, loaded with ``ctypes``: no PyTorch headers are
compiled, so a build takes seconds. The libraries land in
``kernels/.build/`` (git-ignored), named by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing here runs at import time; :func:`load` builds on first call, and
:func:`build` compiles several sources at once (one ``nvcc`` each, all
started together).

Every launch function returns ``cudaGetLastError()``; :func:`check` turns
a non-zero code into an exception, because a refused launch never runs and
a later synchronize does not report it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / ".build"
NAMES = ("lora_matmul", "flash_attention", "wkv6")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> nvcc's output of the last build in this process (ptxas reports
# registers, shared memory and spills per kernel)
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def source_of(name: str) -> Path:
    return KERNELS_DIR / name / "csrc" / f"{name}.cu"


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(source_of(name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = NAMES) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together. Returns the wall
    seconds each build took (0.0 for one already on disk)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            build_seconds.setdefault(name, 0.0)
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_of(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return {n: build_seconds[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
            getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def check(name: str, code: int, what: Optional[str] = None) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg = getattr(load(name), f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{what or name} launch failed: CUDA error "
                           f"{code} ({msg})")
