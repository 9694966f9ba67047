"""Native (C++) host kernels with build-on-first-use and numpy fallback.

`load()` compiles `geometry.cpp` into a shared library with g++ (into the
port's git-ignored build directory) and binds it via ctypes. Every call site
keeps its numpy fallback; set RADARGNN_NO_NATIVE=1 to force pure numpy.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from radargnn_tpu_torch.build import compile_shared, source_path

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def load() -> Optional[ctypes.CDLL]:
    """Returns the bound library, building it if needed; None on failure."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("RADARGNN_NO_NATIVE"):
        return None
    try:
        so_path, _ = compile_shared(
            ["g++", "-O3", "-march=native", "-funroll-loops", "-shared",
             "-fPIC", "-std=c++17"],
            source_path("native", "geometry.cpp"), "libradargnn_native.so")
        lib = ctypes.CDLL(so_path)
    except (OSError, RuntimeError):
        return None

    lib.knn_edges.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.knn_edges.restype = None
    lib.nearest_neighbor.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.nearest_neighbor.restype = None
    lib.min_area_rect.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double)]
    lib.min_area_rect.restype = ctypes.c_int
    lib.point_pair_features_2d.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double)]
    lib.point_pair_features_2d.restype = None
    lib.radius_edges_count.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double]
    lib.radius_edges_count.restype = ctypes.c_int64
    lib.radius_edges_fill.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.POINTER(ctypes.c_int64)]
    lib.radius_edges_fill.restype = None
    _LIB = lib
    return _LIB


def _as_c_double(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _as_c_int64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def knn_edges(pts: np.ndarray, k: int) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    n, d = pts.shape
    kk = min(k, n - 1)
    out = np.empty((n * kk, 2), dtype=np.int64)
    lib.knn_edges(_as_c_double(pts), n, d, kk, _as_c_int64(out))
    return out


def nearest_neighbor(pts: np.ndarray) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    n, d = pts.shape
    out = np.empty((n,), dtype=np.int64)
    lib.nearest_neighbor(_as_c_double(pts), n, d, _as_c_int64(out))
    return out


def point_pair_features_2d(pos: np.ndarray, vel: np.ndarray,
                           edges: np.ndarray,
                           directed: bool) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    vel = np.ascontiguousarray(vel, dtype=np.float64)
    edges = np.ascontiguousarray(edges, dtype=np.int64)
    e = edges.shape[0]
    out = np.empty((e, 4), dtype=np.float64)
    lib.point_pair_features_2d(_as_c_double(pos), _as_c_double(vel),
                               _as_c_int64(edges), e, int(directed),
                               _as_c_double(out))
    return out


def radius_edges(pts: np.ndarray, r: float) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    n, d = pts.shape
    cnt = lib.radius_edges_count(_as_c_double(pts), n, d, float(r) ** 2)
    out = np.empty((cnt, 2), dtype=np.int64)
    if cnt:
        lib.radius_edges_fill(_as_c_double(pts), n, d, float(r) ** 2,
                              _as_c_int64(out))
    return out


def min_area_rect(pts: np.ndarray) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    out = np.empty((4, 2), dtype=np.float64)
    rc = lib.min_area_rect(_as_c_double(pts), pts.shape[0], _as_c_double(out))
    return out if rc == 0 else None
