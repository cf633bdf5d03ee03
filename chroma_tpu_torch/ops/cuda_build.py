"""Build, load, check, launch and count the port's hand-written CUDA
kernels (csrc/*.cu), and keep per-geometry device tables for them.

Each kernel source is compiled with nvcc at first use into <repo>/build/
as a shared library with a plain C interface (a `Library`), loaded by
ctypes and launched through `launch` on torch's current stream (so a CUDA
graph capture records it). `launch` counts every launch in `launches` by
kernel: k1 (the visit kernel), k2_pre, k2_post, k3 (the wire walk), k4
(the DAQ readout); inside `recording()` the counts go to the recording's
own Counter instead (a graph capture's launches run only when replayed).
The flags are the same for every kernel: sm_90a, -O3, and --fmad=false,
because the plain PyTorch versions round every `a * b + c` twice except
where they call linalg.fma, and the kernels write fmaf exactly there. No
--use_fast_math: torch's CUDA logf/expf/sinf/sqrtf are the precise
libdevice functions, and so are the kernels'. A failed build raises.
`pointer` checks a tensor argument and `mask_bytes` hands a kernel a bool
lane mask as its bytes without a copy.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import weakref

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '--fmad=false', '-Xptxas', '-v', '-shared',
              '-Xcompiler', '-fPIC')


def nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    return os.path.join(home, 'bin', 'nvcc')


def build(source):
    """Compile `source` (a path under csrc/), once per source content and
    flags, and load it. Returns (ctypes library, nvcc's output: ptxas's
    registers and spills, '' when the library was built before); raises
    RuntimeError if nvcc fails. Concurrent builders each write their own
    temporary file and rename it into place."""
    with open(source, 'rb') as fh:
        digest = hashlib.sha256(fh.read() + ' '.join(NVCC_FLAGS).encode()
                                ).hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = os.path.splitext(os.path.basename(source))[0]
    lib_path = os.path.join(BUILD_DIR, 'lib%s_%s.so' % (stem, digest))
    log = ''
    if not os.path.exists(lib_path):
        tmp = '%s.%d.tmp' % (lib_path, os.getpid())
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, '-o', tmp, source],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed on %s (%d):\n%s'
                               % (source, proc.returncode, log))
        os.replace(tmp, lib_path)
    return ctypes.CDLL(lib_path), log


class Library:
    """A kernel source's library, built (`build`) and loaded at the first
    `load()`: `bind(lib)` sets its entry points' argument types, and the
    entry point named `load_fn`, where given, loads its kernels' modules
    then rather than at their first launch (which may be inside a graph
    capture). `build_log` keeps nvcc's output."""

    def __init__(self, source, bind, load_fn=None):
        self.source, self.bind, self.load_fn = source, bind, load_fn
        self.lib = None
        self.build_log = ''

    def load(self):
        "The loaded ctypes library; raises RuntimeError if the build fails."
        if self.lib is None:
            lib, self.build_log = build(self.source)
            self.bind(lib)
            if self.load_fn is not None:
                check_launch(getattr(lib, self.load_fn)(), self.load_fn)
            self.lib = lib
        return self.lib


_TABLES = {}    # (id(geometry), name) -> (weakref to it, tables)


def geometry_tables(geometry, name, make):
    """`make(geometry)`, computed once per geometry object and kept while
    it lives: the device tables a kernel reads. Built outside any graph
    capture (the step's first, eager, run makes them), so a replay reads
    memory that no graph owns."""
    key = (id(geometry), name)
    ent = _TABLES.get(key)
    if ent is not None and ent[0]() is geometry:
        return ent[1]
    tables = make(geometry)
    _TABLES[key] = (weakref.ref(geometry), tables)
    weakref.finalize(geometry, _TABLES.pop, key, None)
    return tables


def check_launch(err, what):
    "Raise on a non-zero CUDA error code returned by a C entry point."
    if err != 0:
        raise RuntimeError('%s launch failed: CUDA error %d' % (what, err))


launches = collections.Counter()    # kernel launches by name
_sink = launches                    # where `launch` counts them now


@contextlib.contextmanager
def recording():
    """Within the block, launches count in the fresh Counter it yields,
    not in `launches`: a graph capture records launches that run only
    when the graph is replayed."""
    global _sink
    saved, _sink = _sink, collections.Counter()
    try:
        yield _sink
    finally:
        _sink = saved


@contextlib.contextmanager
def stream(dev):
    "`dev` selected, with the handle of its current stream."
    with torch.cuda.device(dev):
        yield torch.cuda.current_stream(dev).cuda_stream


def launch(kernel, fn, dev, *args):
    """fn(*args, stream): a C entry point of `kernel` called with `dev`
    selected and its current stream; raises RuntimeError on a CUDA error,
    and counts one launch of `kernel`."""
    with stream(dev) as handle:
        err = fn(*args, handle)
    check_launch(err, kernel)
    _sink[kernel] += 1


def pointer(name, t, dtype, shape, dev):
    """The data pointer of `t` (None for None), a contiguous `dtype`
    tensor of `shape` on `dev`; raises ValueError on anything else."""
    if t is None:
        return None
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != dev or not t.is_contiguous():
        raise ValueError('%s: want contiguous %s %s on %s, got %s %s on %s'
                         % (name, dtype, tuple(shape), dev, t.dtype,
                            tuple(t.shape), t.device))
    return t.data_ptr()


def mask_bytes(mask, n, dev, name='active'):
    """A bool (or u8) lane mask as the u8 bytes a kernel reads: a view of
    the bool tensor's storage, which launches nothing. Raises on another
    dtype, shape, device or a non-contiguous mask."""
    if mask.dtype == torch.bool:
        mask = mask.view(torch.uint8)
    if mask.dtype != torch.uint8 or tuple(mask.shape) != (n,) \
            or mask.device != dev or not mask.is_contiguous():
        raise ValueError('%s: want a contiguous bool or u8 (%d,) mask on %s, '
                         'got %s %s on %s' % (name, n, dev, mask.dtype,
                                              tuple(mask.shape), mask.device))
    return mask
