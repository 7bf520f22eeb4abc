"""Native (C++) components, loaded via ctypes.

The reference implements its runtime around native code (BVH build in
src/runtime/bvh/, loaders, ...). Here the hot host-side pieces are C++
too: compiled on first use with g++ into a cached shared library
(no pybind11 in this environment — plain C ABI + ctypes). Everything has
a pure-python fallback, so a missing toolchain only costs load-time speed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

_LIB = None
_TRIED = False


def _cache_dir() -> Path:
    from ..utils.cache import checkout_dir
    return checkout_dir("native")


def get_lib():
    """Compile-on-demand native library; None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    src = Path(__file__).parent / "bvh_builder.cpp"
    try:
        tag = hashlib.sha1(src.read_bytes()).hexdigest()[:16]
        so = _cache_dir() / f"ignis_native_{tag}.so"
        if not so.exists():
            tmp = so.with_suffix(f".so.{os.getpid()}.tmp")
            subprocess.run(
                ["g++", "-O3", "-march=native", "-fPIC", "-shared",
                 "-std=c++17", str(src), "-o", str(tmp)],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.ig_build_bvh8.restype = ctypes.c_int
        lib.ig_build_bvh8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def build_bvh8_native(v0, e1, e2):
    """C++ binned-SAH BVH8 build; returns bvh/builder.py-compatible BVH8
    or None if the native library is unavailable."""
    import numpy as np

    from ..bvh.builder import BVH8, WIDTH

    lib = get_lib()
    if lib is None:
        return None
    n = len(v0)
    if n == 0:
        return None
    p1 = v0 + e1
    p2 = v0 + e2
    bb_min = np.ascontiguousarray(np.minimum(np.minimum(v0, p1), p2),
                                  np.float32)
    bb_max = np.ascontiguousarray(np.maximum(np.maximum(v0, p1), p2),
                                  np.float32)
    cap = max(2 * n // 4 + 8, 8)
    cmin = [np.empty(cap * WIDTH, np.float32) for _ in range(3)]
    cmax = [np.empty(cap * WIDTH, np.float32) for _ in range(3)]
    child = np.empty(cap * WIDTH, np.int32)
    order = np.empty(n, np.int32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    n_nodes = lib.ig_build_bvh8(ptr(bb_min), ptr(bb_max), n,
                                ptr(cmin[0]), ptr(cmin[1]), ptr(cmin[2]),
                                ptr(cmax[0]), ptr(cmax[1]), ptr(cmax[2]),
                                ptr(child), ptr(order), cap)
    if n_nodes <= 0:
        return None
    s = n_nodes * WIDTH
    return BVH8(cmin[0][:s].reshape(n_nodes, WIDTH),
                cmin[1][:s].reshape(n_nodes, WIDTH),
                cmin[2][:s].reshape(n_nodes, WIDTH),
                cmax[0][:s].reshape(n_nodes, WIDTH),
                cmax[1][:s].reshape(n_nodes, WIDTH),
                cmax[2][:s].reshape(n_nodes, WIDTH),
                child[:s].reshape(n_nodes, WIDTH), order)
