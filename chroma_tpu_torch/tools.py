"""Misc host utilities: timing, CSV/profile readers, ray-film projection,
Morton direction sorting (reference: chroma/tools.py)."""
from __future__ import annotations

import datetime
import math
import sys
import time

import numpy as np

from chroma_tpu_torch.transform import normalize


def count_nonzero(array):
    return int((array != 0).sum())


def filled_array(value, shape, dtype):
    return np.full(shape, value, dtype=dtype)


def progress(seq, width=32, stream=sys.stderr):
    "Iterate over `seq` drawing an in-place progress bar on `stream`."
    total = len(seq)
    shown = -1
    for done, item in enumerate(seq, start=1):
        filled = width * done // max(total, 1)
        if filled != shown:
            shown = filled
            bar = '#' * filled + '-' * (width - filled)
            stream.write('\r|%s| %d/%d' % (bar, done, total))
            stream.flush()
        yield item
    stream.write('\n')
    stream.flush()


def debugger_hook(type, value, tb):
    if hasattr(sys, 'ps1') or not sys.stderr.isatty():
        sys.__excepthook__(type, value, tb)
    else:
        import traceback
        import pdb
        traceback.print_exception(type, value, tb)
        print()
        pdb.pm()


def enable_debug_on_crash():
    "Drop into PDB when an uncaught exception reaches the top level."
    sys.excepthook = debugger_hook


# no-op unless running under kernprof
try:
    profile_if_possible = profile  # noqa: F821
except NameError:
    def profile_if_possible(x):
        return x


def timeit(func):
    "Decorator printing the wall time of each call."
    def wrapper(*args, **kwargs):
        t0 = time.time()
        retval = func(*args, **kwargs)
        elapsed = time.time() - t0
        print('%s elapsed in %s().'
              % (datetime.timedelta(seconds=elapsed), func.__name__))
        return retval
    return wrapper


def ufloat_to_str(x):
    msd = -int(math.floor(math.log10(x.std_dev())))
    return '%.*f +/- %.*f' % (msd, round(x.nominal_value, msd),
                              msd, round(x.std_dev(), msd))


def read_csv(filename):
    """Array of comma-separated float rows from `filename` (non-numeric
    lines skipped)."""
    points = []
    with open(filename) as f:
        for line in f:
            try:
                points.append([float(s) for s in line.split(',')])
            except ValueError:
                pass
    return np.array(points)


def offset(points, x, tol=1e-9):
    """Offset the open 2-D profile `points` perpendicular to its path by
    distance `x` (positive = path direction rotated 90 deg clockwise),
    fully vectorized: each output vertex is the intersection of its two
    adjacent offset segments (miter join), falling back to the segment
    endpoint where they are parallel. Consecutive duplicates within
    `tol` are dropped first."""
    pts = np.asarray(points, dtype=float)
    dedup = np.r_[True, np.linalg.norm(np.diff(pts, axis=0), axis=1) > tol]
    pts = pts[dedup]

    # per-segment unit tangents and clockwise normals (2-D)
    tang = np.diff(pts, axis=0)
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    norm = np.column_stack([tang[:, 1], -tang[:, 0]]) * x

    # offset segments: seg i runs a[i] -> b[i]
    a = pts[:-1] + norm
    b = pts[1:] + norm

    # interior joins: solve a[i] + s*t[i] == a[i+1] + u*t[i+1] by Cramer
    t0, t1 = tang[:-1], tang[1:]
    det = t0[:, 0] * t1[:, 1] - t0[:, 1] * t1[:, 0]
    rhs = a[1:] - b[:-1]
    parallel = np.abs(det) < 1e-12
    s = np.where(parallel, 0.0,
                 (rhs[:, 0] * t1[:, 1] - rhs[:, 1] * t1[:, 0])
                 / np.where(parallel, 1.0, det))
    joins = b[:-1] + s[:, None] * t0

    return np.vstack([a[:1], joins, b[-1:]])


def memoize_method_with_dictionary_arg(func):
    """Memoize a two-argument method whose second argument is a dict
    (made hashable by sorting its items). One cache per decorated
    function, held here rather than on the function object."""
    cache = {}

    def wrapper(self, dict_arg):
        key = (self, tuple(sorted(dict_arg.items())))
        if key not in cache:
            cache[key] = func(self, dict_arg)
        return cache[key]
    return wrapper


def _spread_bits_2(v):
    """Insert two zero bits between each of the low 21 bits of `v`
    (uint64 vector), the standard mask-shift expansion."""
    v = v.astype(np.uint64) & np.uint64(0x1fffff)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1f00000000ffff)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1f0000ff0000ff)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100f00f00f00f00f)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10c30c30c30c30c3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def _spread_bits_1(v):
    "Insert one zero bit between each of the low 32 bits of `v`."
    v = v.astype(np.uint64) & np.uint64(0xffffffff)
    v = (v | (v << np.uint64(16))) & np.uint64(0x0000ffff0000ffff)
    v = (v | (v << np.uint64(8))) & np.uint64(0x00ff00ff00ff00ff)
    v = (v | (v << np.uint64(4))) & np.uint64(0x0f0f0f0f0f0f0f0f)
    v = (v | (v << np.uint64(2))) & np.uint64(0x3333333333333333)
    v = (v | (v << np.uint64(1))) & np.uint64(0x5555555555555555)
    return v


def interleave3d(arr, bits):
    """Morton codes of quantized 3-D integer points (x in the highest bit
    position), via vectorized mask-shift bit spreading — O(1) passes
    instead of a per-bit loop."""
    arr = np.asarray(arr)
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise Exception('shape mismatch')
    mask = np.uint64((1 << bits) - 1)
    x, y, z = (arr[:, i].astype(np.uint64) & mask for i in range(3))
    return ((_spread_bits_2(x) << np.uint64(2))
            | (_spread_bits_2(y) << np.uint64(1))
            | _spread_bits_2(z))


def argsort_direction(dir):
    """argsort of direction vectors by Morton order of their spherical
    coordinates; groups coherent rays for better memory locality in the
    traversal kernels."""
    maxint = np.uint32(0xffff)
    theta = np.uint64(np.arccos(np.clip(dir[:, 2], -1, 1))
                      / np.pi * maxint)
    phi = np.uint64((np.arctan2(dir[:, 1], dir[:, 0])
                     / (2 * np.pi) + 0.5) * maxint)
    code = (_spread_bits_1(phi) << np.uint64(1)) | _spread_bits_1(theta)
    return np.argsort(code)


def from_film(position=(0, 0, 0), axis1=(0, 0, 1), axis2=(1, 0, 0),
              size=(800, 600), width=35.0, focal_length=18.0):
    """Pinhole-camera ray bundle: rays from a film plane through a focal
    point at `position`. Returns (origins (n,3), directions (n,3))."""
    height = width * (size[1] / float(size[0]))
    axis1 = normalize(axis1)
    axis2 = normalize(axis2)
    dx0 = width / size[0]
    dx1 = height / size[1]

    x = np.arange(size[0])
    y = np.arange(size[1])
    yy, xx = np.meshgrid(y, x)
    n = size[0] * size[1]

    grid = (-np.tile(axis2, (n, 1)) * xx.ravel()[:, np.newaxis] * dx0
            + np.tile(axis1, (n, 1)) * yy.ravel()[:, np.newaxis] * dx1)
    grid += axis2 * width / 2 - axis1 * height / 2
    grid -= np.cross(axis1, axis2) * focal_length

    return np.tile(position, (n, 1)), normalize(-grid)
