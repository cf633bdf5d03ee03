"""Wrapper of the CUDA instanced-traversal kernel (csrc/visit_kernel.cu).

Replaces the TPU kernel chroma_tpu/ops/visit_kernel.py::_visit_kernel_inst,
which ran ONE traversal visit per launch over (TB, 128) lane tiles while
XLA gathered the rows between launches (Mosaic has no per-lane gather).
On Hopper one thread per ray runs the whole walk in a single launch: it
loads its own row every visit and keeps the (base, pending-mask) stack in
registers and local memory. The walk is bound by the latency of those
data-dependent row loads (the quick detector's 6.8 MB table sits in the
50 MB L2) and by divergence within a warp; it computes the same function,
bit for bit, as the plain traversal in chroma_tpu_torch.ops.mesh_wide.

`traverse` takes the kernel for CUDA tensors and the plain version for CPU
tensors. On a CUDA tensor there is no fallback: a failed build or launch
raises. The kernel is compiled with nvcc at first use into <repo>/build/,
and `launches` counts its launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

from chroma_tpu_torch.bvh.wide import INST_B0, bounds_cols, fmt_of
from chroma_tpu_torch.ops import mesh_wide

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, 'csrc', 'visit_kernel.cu')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '--fmad=false', '-Xptxas', '-v', '-shared',
              '-Xcompiler', '-fPIC')
MAX_DEPTH = 32                       # MAX_D in the kernel
_FMT_CODE = {'f32': 0, 'bf16': 1, 'q8': 2}

# kernel launches made through `traverse` (reset freely by callers)
launches = 0

_lib = None
build_log = ''


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    return os.path.join(home, 'bin', 'nvcc')


def build():
    """Compile csrc/visit_kernel.cu (once per source content) and load it.
    Returns the ctypes library; raises RuntimeError if nvcc fails."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    with open(SOURCE, 'rb') as fh:
        digest = hashlib.sha256(fh.read() + ' '.join(NVCC_FLAGS).encode()
                                ).hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, 'libvisit_kernel_%s.so' % digest)
    if not os.path.exists(lib_path):
        tmp = '%s.%d.tmp' % (lib_path, os.getpid())
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, SOURCE]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed (%d):\n%s'
                               % (proc.returncode, build_log))
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    fn = lib.chroma_visit_inst
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, i, i, i, i, i, p, p, p, p, p, i,
                   p, p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError('%s: want contiguous %s %s on %s, got %s %s on %s'
                         % (name, dtype, shape, device, t.dtype,
                            tuple(t.shape), t.device))


def traverse(inst, origin, direction, last_hit=None, mask=None,
             best_limit=None):
    """Instanced-BVH query: (tri, dist, code, normal, iid, visits), the
    contract of chroma_tpu_torch.ops.mesh_wide.traverse. CPU tensors run
    the plain version; CUDA tensors launch the kernel."""
    global launches
    if not origin.is_cuda:
        return mesh_wide.traverse(inst, origin, direction, last_hit, mask,
                                  best_limit)
    dev = origin.device
    n = origin.shape[0]
    rows = inst.rows
    fmt = fmt_of(inst)
    if inst.fanout not in (16, 32) or fmt not in _FMT_CODE:
        raise ValueError('visit kernel supports fanout 16/32 and f32/bf16/'
                         'q8 bounds, got %d/%s' % (inst.fanout, fmt))
    if inst.max_depth > MAX_DEPTH:
        raise ValueError('table depth %d exceeds the kernel stack (%d)'
                         % (inst.max_depth, MAX_DEPTH))
    _check('rows', rows, torch.float32, tuple(rows.shape), dev)
    _check('origin', origin, torch.float32, (n, 3), dev)
    _check('direction', direction, torch.float32, (n, 3), dev)
    if last_hit is not None:
        _check('last_hit', last_hit, torch.int32, (n,), dev)
    if mask is not None:
        mask = mask.to(torch.uint8)
        _check('mask', mask, torch.uint8, (n,), dev)
    if best_limit is not None:
        _check('best_limit', best_limit, torch.float32, (n,), dev)

    tri = torch.empty(n, dtype=torch.int32, device=dev)
    dist = torch.empty(n, dtype=torch.float32, device=dev)
    code = torch.empty(n, dtype=torch.int32, device=dev)
    normal = torch.empty((n, 3), dtype=torch.float32, device=dev)
    iid = torch.empty(n, dtype=torch.int32, device=dev)
    visits = torch.empty(n, dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = build()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.chroma_visit_inst(
            rows.data_ptr(), rows.shape[1], inst.fanout, inst.leaf_size,
            inst.max_depth, _FMT_CODE[fmt],
            INST_B0 + bounds_cols(fmt, inst.fanout),
            origin.data_ptr(), direction.data_ptr(), ptr(last_hit),
            ptr(mask), ptr(best_limit), n, tri.data_ptr(), dist.data_ptr(),
            code.data_ptr(), normal.data_ptr(), iid.data_ptr(),
            visits.data_ptr(), stream)
    if err != 0:
        raise RuntimeError('visit kernel launch failed: CUDA error %d' % err)
    launches += 1
    return tri, dist, code, normal, iid, visits
