"""Native (C++) batch-state assembly for the training input pipeline (the
port's counterpart of the JAX package's ``data/native_loader.py``).

:func:`gather_scale_u8` assembles a batch's state windows with one call
into ``csrc/gather_scale.cpp``: it gathers the image rows out of the
preloaded (n_images, img_elems) uint8 state array, converts them to float32
through a LUT built in double precision (bit-exact with numpy's
``np.float32(u8 / 255)``), fills the pad rows (index -1) with zeros, and
splits the rows over ``std::thread`` workers. ctypes releases the GIL for
the whole call, so the batch assembly thread does not hold up the step
loop's dispatch.

The library is built by ``g++`` on first use into ``build/kernels/``
(``ops/kernels/_build.py``, named by a hash of the source); a failed build
raises with the compiler's output. :func:`_gather_numpy` is the plain twin,
bit for bit the same; it runs only where the caller asks for it, with
``DT4IR_NATIVE_DISABLE=1`` (the JAX package's switch).
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from ..ops.kernels import _build

# lut[v] = float32(float64(v) / 255): the C++ LUT's values.
_LUT = (np.arange(256, dtype=np.float64) / 255.0).astype(np.float32)


def _disabled() -> bool:
    return os.environ.get("DT4IR_NATIVE_DISABLE") == "1"


def _library() -> ctypes.CDLL:
    """The loaded gather library (built on first use), its signature
    declared."""
    lib = _build.load("gather_scale")
    fn = lib.dt4ir_gather_scale
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                       ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                       ctypes.POINTER(ctypes.c_float), ctypes.c_int32]
        fn.restype = None
    return lib


def native_available() -> bool:
    """Whether :func:`gather_scale_u8` runs the C++ gather: true unless
    ``DT4IR_NATIVE_DISABLE=1``. Builds the library if it is missing (and
    raises if that fails)."""
    if _disabled():
        return False
    _library()
    return True


def default_threads() -> int:
    return min(os.cpu_count() or 1, 8)


def _gather_numpy(src: np.ndarray, flat_rows: np.ndarray) -> np.ndarray:
    """The plain twin of the C++ gather, on (n, img_elems) uint8 ``src``
    and 1-D ``flat_rows``."""
    out = np.zeros((flat_rows.size, src.shape[1]), np.float32)
    valid = flat_rows >= 0
    out[valid] = _LUT[src[flat_rows[valid]]]
    return out


def gather_scale_u8(src: np.ndarray, rows: np.ndarray,
                    n_threads: Optional[int] = None) -> np.ndarray:
    """``out[i] = float32(src[rows[i]] / 255)``; ``rows[i] < 0`` gives
    zeros. ``src`` is the preloaded (n_images, img_elems) uint8 state
    array, ``rows`` any-shape int64 indices; the result is float32 of shape
    ``rows.shape + (img_elems,)``. Runs the C++ gather on ``n_threads``
    threads (default :func:`default_threads`) with the GIL released, or
    the numpy twin under ``DT4IR_NATIVE_DISABLE=1``."""
    src = np.ascontiguousarray(src)
    if src.dtype != np.uint8 or src.ndim != 2:
        raise ValueError(f"src must be (n, img_elems) uint8, got "
                         f"{src.dtype} {src.shape}")
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    out_shape = rows.shape + (src.shape[1],)
    flat_rows = rows.reshape(-1)
    if flat_rows.size and flat_rows.max() >= src.shape[0]:
        raise IndexError(f"row index {int(flat_rows.max())} out of range "
                         f"for {src.shape[0]} images")
    if _disabled():
        return _gather_numpy(src, flat_rows).reshape(out_shape)
    out = np.empty((flat_rows.size, src.shape[1]), np.float32)
    _library().dt4ir_gather_scale(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(src.shape[1]),
        flat_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(flat_rows.size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int32(default_threads() if n_threads is None
                       else n_threads))
    return out.reshape(out_shape)
