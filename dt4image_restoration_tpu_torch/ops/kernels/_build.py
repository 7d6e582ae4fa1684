"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C function and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``build/kernels/`` at the root of the checkout, named by a hash of the
source and the flags, so a library is rebuilt only when its source changes.
The library is loaded with ``ctypes``; no PyTorch headers are compiled, which
keeps a build to seconds. Nothing here runs at import time: the first CUDA
call of a kernel wrapper builds what it needs, and :func:`build` starts one
``nvcc`` per missing source, all together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
KERNEL_SOURCES = ("kspace", "conv_block", "dt_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build in this
# process, by source name.
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are compiled on first use")
    return found


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile every missing library of ``names`` (default: all kernels)
    with one ``nvcc`` each, started together. Returns the wall seconds."""
    names = list(KERNEL_SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device`` as a ctypes pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
