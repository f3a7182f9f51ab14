"""ctypes bindings to the native C++ components (native/).

The reference's runtime is entirely native (C/C++, SURVEY.md §2); this
renderer keeps the compute path in XLA but implements the host-side hot loops
natively too:

- uniform-grid scene compile (pt_grid_count / pt_grid_fill), the
  GenerateAccelerationStructure role (win32_main.cpp:1188-1447);
- image comparison kernels (pt_percentage_similarity / pt_rmse), the
  ImageCompare.exe role (src/image_compare.c), plus a standalone
  native/build/image_compare executable.

Build with ``make -C native``. Every entry point has a pure-numpy fallback
so the framework works unbuilt; tests assert native == numpy.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "build", "libptnative.so")
_EXE_PATH = os.path.join(_REPO_ROOT, "native", "build", "image_compare")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        if lib.pt_native_abi_version() != 1:
            return None
        lib.pt_grid_count.restype = ctypes.c_int64
        lib.pt_grid_count.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p,
        ]
        lib.pt_grid_fill.restype = ctypes.c_int
        lib.pt_grid_fill.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.pt_percentage_similarity.restype = ctypes.c_double
        lib.pt_percentage_similarity.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ]
        lib.pt_rmse.restype = ctypes.c_double
        lib.pt_rmse.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def compare_exe_path() -> Optional[str]:
    return _EXE_PATH if os.path.exists(_EXE_PATH) else None


def grid_build_native(tris: np.ndarray, res: int, cell: float):
    """Native two-pass CSR grid build; returns (starts, counts, refs) numpy
    arrays or None if the library is unavailable. Raises ValueError on
    out-of-bounds geometry (the reference's assert)."""
    lib = _load()
    if lib is None:
        return None
    tris = np.ascontiguousarray(tris, np.float32)
    n = len(tris)
    ncells = res ** 3
    counts = np.zeros(ncells, np.int32)
    total = lib.pt_grid_count(
        tris.ctypes.data, n, res, ctypes.c_float(cell), counts.ctypes.data)
    if total < 0:
        raise ValueError(
            "triangle is out of the world bounds! either extend the world "
            "bounds or move the triangle (cf. win32_main.cpp:1284-1286)")
    starts = np.zeros(ncells + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    refs = np.zeros(max(int(total), 1), np.int32)
    cursors = starts[:-1].copy()
    rc = lib.pt_grid_fill(
        tris.ctypes.data, n, res, ctypes.c_float(cell),
        cursors.ctypes.data, refs.ctypes.data)
    if rc != 0:
        raise ValueError("grid fill failed")
    return starts[:-1].astype(np.int32), counts, refs


def percentage_similarity_native(a: np.ndarray, b: np.ndarray,
                                 legacy: bool = False) -> Optional[float]:
    """Similarity on packed BGRA uint32 buffers via the native kernel."""
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, np.uint32).ravel()
    b = np.ascontiguousarray(b, np.uint32).ravel()
    assert a.size == b.size
    return float(lib.pt_percentage_similarity(
        a.ctypes.data, b.ctypes.data, a.size, int(legacy)))


def rmse_native(a: np.ndarray, b: np.ndarray) -> Optional[float]:
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, np.uint32).ravel()
    b = np.ascontiguousarray(b, np.uint32).ravel()
    assert a.size == b.size
    return float(lib.pt_rmse(a.ctypes.data, b.ctypes.data, a.size))
