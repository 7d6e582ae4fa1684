"""Build and load the port's hand-written native code.

Each ``csrc/<name>.cu`` exports a plain C function and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``build/kernels/`` at the root of the checkout, named by a hash of the
source and the flags, so a library is rebuilt only when its source changes.
A host source, ``csrc/<name>.cpp`` (``HOST_SOURCES``: the training input
pipeline's batch gather), is built the same way by ``g++`` into the same
directory. The library is loaded with ``ctypes``; no PyTorch headers are
compiled, which keeps a build to seconds. Nothing here runs at import time:
the first call of a wrapper builds what it needs, and :func:`build` starts
one compiler per missing source, all together.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Iterator, Mapping, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
KERNEL_SOURCES = ("kspace", "conv_block", "conv_block_bf16", "dt_decode",
                  "attention", "layernorm", "upsample_concat", "mdta_gram")
HOST_SOURCES = ("gather_scale",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_libs: Dict[tuple, ctypes.CDLL] = {}
# Host threads of one process (one per device of a mesh) may load and
# launch at once: loads, and the builds they start, are serialised (a
# build's temporary files are named by the process), and so are the
# wrappers' launch counts.
_BUILD_LOCK = threading.Lock()
LAUNCH_LOCK = threading.Lock()
# The launches a thread makes inside `tally_launches`, by wrapper module.
_tally = threading.local()


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


def _source(name: str) -> Path:
    return CSRC_DIR / (f"{name}.cpp" if name in HOST_SOURCES
                       else f"{name}.cu")


def _flags(name: str, defines: Sequence[str]) -> tuple:
    """The compiler flags of ``name``: ``g++``'s for a host source,
    ``nvcc``'s for a kernel."""
    base = GXX_FLAGS if name in HOST_SOURCES else NVCC_FLAGS
    return base + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    """The library of ``csrc/<name>.cu`` (or ``.cpp``, for a host source)
    built with the macros ``defines`` (``-D`` flags; none for the port's
    own build)."""
    src = _source(name).read_bytes()
    flags = " ".join(_flags(name, defines))
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_log(name: str, defines: Sequence[str] = ()) -> str:
    """The compiler's report (ptxas registers, shared memory, spills) of the
    current library of ``csrc/<name>.cu``, kept beside it; empty before the
    first build."""
    log = library_path(name, defines).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Optional[Iterable] = None) -> float:
    """Compile every missing library of ``names`` (default: all CUDA
    kernels) with one compiler each, started together. A name may also be
    a ``(name, defines)`` pair, a build with ``-D`` macros. A failed build
    raises with the compiler's output. Returns the wall seconds."""
    names = [(n, ()) if isinstance(n, str) else (n[0], tuple(n[1]))
             for n in (KERNEL_SOURCES if names is None else names)]
    todo = [n for n in names if not library_path(*n).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, defines in todo:
        out = library_path(name, defines)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        compiler = "g++" if name in HOST_SOURCES else _nvcc()
        cmd = [compiler, *_flags(name, defines), "-o", str(tmp),
               str(_source(name))]
        procs[(name, defines)] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    failed = []
    for (name, _), (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: {Path(proc.args[0]).name} exit "
                          f"{proc.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.cpp`` (built with the
    macros ``defines``), built on first use."""
    key = (name, tuple(defines))
    lib = _libs.get(key)
    if lib is None:
        with _BUILD_LOCK:
            lib = _libs.get(key)
            if lib is None:
                build([key])
                lib = ctypes.CDLL(str(library_path(name, defines)))
                _libs[key] = lib
    return lib


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device`` (a ``torch.device``, an
    index, or None for the current device) as an integer handle. Read it
    for every launch, never cache it: a CUDA graph is captured on a stream
    of its own. It asks PyTorch for the raw handle, as PyTorch's own
    generated kernels do: building a ``torch.cuda.Stream`` for
    ``current_stream().cuda_stream`` costs more host time than the launch
    of a small kernel."""
    index = getattr(device, "index", device)
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


_ALREADY_CURRENT = contextlib.nullcontext()


def on_device(index: int):
    """A context in which CUDA device ``index`` is current: nothing to
    enter where it already is, as in a single-card process."""
    if index == torch.cuda.current_device():
        return _ALREADY_CURRENT
    return torch.cuda.device(index)


def count_launch(module: str) -> None:
    """Count one launch of the kernel of the wrapper module named
    ``module`` in its ``launches``; inside :func:`tally_launches`, in this
    thread's tally instead."""
    tally = getattr(_tally, "counts", None)
    if tally is not None:
        tally[module] = tally.get(module, 0) + 1
        return
    mod = sys.modules[module]
    with LAUNCH_LOCK:
        mod.launches += 1


@contextlib.contextmanager
def tally_launches() -> Iterator[Dict[str, int]]:
    """Within, this thread's launches are counted in the dict it yields (by
    wrapper module) and not in the wrappers' ``launches``: a CUDA graph's
    capture records launches and makes none. Each replay of the graph then
    counts them with :func:`add_launches`."""
    _tally.counts = counts = {}
    try:
        yield counts
    finally:
        _tally.counts = None


def add_launches(counts: Mapping[str, int]) -> None:
    """Count the launches a :func:`tally_launches` tallied, once more."""
    with LAUNCH_LOCK:
        for module, n in counts.items():
            sys.modules[module].launches += n


def check(rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
