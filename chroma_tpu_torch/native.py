"""ctypes bindings for the native host geometry kit (csrc/geometry_kit.cpp).

Builds the shared library on first use with the host C++ compiler, into
<repo>/build/ (never into the source tree); callers fall back to the numpy
implementations when it is not available. This is the native runtime
layer for host-side hot spots (vertex dedupe, Morton coding, key sorting)
of the geometry build; the device compute path is torch and CUDA."""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from chroma_tpu_torch.log import logger

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, 'csrc', 'geometry_kit.cpp')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build')
# -march=native output is not portable: the library is built on the machine
# that runs it and never committed
CXXFLAGS = ('-O3', '-march=native', '-fPIC', '-std=c++17', '-Wall',
            '-shared')

_lib = None
_tried = False


def _build():
    """Compile geometry_kit.cpp once per source content and flags; returns
    the library path. Concurrent builders each write their own temporary
    file and rename it into place."""
    with open(SOURCE, 'rb') as fh:
        digest = hashlib.sha256(fh.read() + ' '.join(CXXFLAGS).encode()
                                ).hexdigest()[:12]
    lib_path = os.path.join(BUILD_DIR, 'libgeometry_kit_%s.so' % digest)
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = '%s.%d.tmp' % (lib_path, os.getpid())
        cxx = os.environ.get('CXX', 'g++')
        subprocess.run([cxx, *CXXFLAGS, '-o', tmp, SOURCE], check=True,
                       capture_output=True)
        os.replace(tmp, lib_path)
    return lib_path


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib_path = _build()
    except Exception as e:  # no compiler: numpy fallback
        logger.info('native geometry kit unavailable (%s)' % e)
        return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError as e:
        logger.info('native geometry kit failed to load (%s)' % e)
        return None

    i64 = ctypes.c_int64
    lib.chroma_dedupe_vertices.restype = i64
    lib.chroma_dedupe_vertices.argtypes = [
        ctypes.c_void_p, i64, ctypes.c_void_p, ctypes.c_void_p]
    lib.chroma_morton_codes.restype = None
    lib.chroma_morton_codes.argtypes = [
        ctypes.c_void_p, i64, ctypes.c_void_p, ctypes.c_float,
        ctypes.c_void_p]
    lib.chroma_argsort_u64.restype = None
    lib.chroma_argsort_u64.argtypes = [ctypes.c_void_p, i64,
                                       ctypes.c_void_p]
    lib.chroma_group_bounds.restype = None
    lib.chroma_group_bounds.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, i64, ctypes.c_void_p, i64,
        ctypes.c_void_p, ctypes.c_void_p]
    if hasattr(lib, 'chroma_collapse_dp'):
        lib.chroma_collapse_dp.restype = None
        lib.chroma_collapse_dp.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, i64, i64,
            ctypes.c_void_p, ctypes.c_void_p]
    _lib = lib
    return _lib


def available():
    return _load() is not None


def dedupe_vertices(vertices):
    """Exact (bit-pattern) row dedupe of (n,3) float32 vertices.
    Returns (unique (m,3), inverse (n,)) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(vertices, dtype=np.float32)
    n = len(v)
    inverse = np.empty(n, dtype=np.int64)
    unique = np.empty((n, 3), dtype=np.float32)
    m = lib.chroma_dedupe_vertices(v.ctypes.data, n, inverse.ctypes.data,
                                   unique.ctypes.data)
    return unique[:m].copy(), inverse


def morton_codes(tri_verts, origin, scale):
    "48-bit Morton codes of (n,3,3) triangle vertices, or None."
    lib = _load()
    if lib is None:
        return None
    t = np.ascontiguousarray(tri_verts, dtype=np.float32).reshape(-1, 9)
    origin = np.ascontiguousarray(origin, dtype=np.float32)
    codes = np.empty(len(t), dtype=np.uint64)
    lib.chroma_morton_codes(t.ctypes.data, len(t), origin.ctypes.data,
                            ctypes.c_float(scale), codes.ctypes.data)
    return codes


def argsort_u64(keys):
    "Stable argsort of uint64 keys, or None."
    lib = _load()
    if lib is None:
        return None
    k = np.ascontiguousarray(keys, dtype=np.uint64)
    order = np.empty(len(k), dtype=np.int64)
    lib.chroma_argsort_u64(k.ctypes.data, len(k), order.ctypes.data)
    return order


def group_bounds(child_lo, child_hi, first):
    "Per-group AABB reduction, or None."
    lib = _load()
    if lib is None:
        return None
    lo = np.ascontiguousarray(child_lo, dtype=np.float32)
    hi = np.ascontiguousarray(child_hi, dtype=np.float32)
    f = np.ascontiguousarray(first, dtype=np.int64)
    g_lo = np.empty((len(f), 3), dtype=np.float32)
    g_hi = np.empty((len(f), 3), dtype=np.float32)
    lib.chroma_group_bounds(lo.ctypes.data, hi.ctypes.data, len(lo),
                            f.ctypes.data, len(f), g_lo.ctypes.data,
                            g_hi.ctypes.data)
    return g_lo, g_hi


def collapse_dp(left, right, area, fanout):
    """Optimal BVH2->wide collapse DP tables (see csrc/geometry_kit.cpp
    chroma_collapse_dp). Returns (forcost (n,F+1) f64, jch (n,F+1) u8)
    or None when the native kit is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, 'chroma_collapse_dp'):
        return None
    ln = np.ascontiguousarray(left, dtype=np.int64)
    rn = np.ascontiguousarray(right, dtype=np.int64)
    ar = np.ascontiguousarray(area, dtype=np.float64)
    n = len(ln)
    forcost = np.empty((n, fanout + 1), dtype=np.float64)
    jch = np.empty((n, fanout + 1), dtype=np.uint8)
    lib.chroma_collapse_dp(ln.ctypes.data, rn.ctypes.data, ar.ctypes.data,
                           n, fanout, forcost.ctypes.data,
                           jch.ctypes.data)
    return forcost, jch
