"""Wrapper of the CUDA instanced-traversal kernel (csrc/visit_kernel.cu).

Replaces the TPU kernel chroma_tpu/ops/visit_kernel.py::_visit_kernel_inst,
which ran ONE traversal visit per launch over (TB, 128) lane tiles while
XLA gathered the rows between launches (Mosaic has no per-lane gather).
On Hopper the whole walk runs in one launch, and a group of lanes walks
one ray: 16 lanes (two rays a warp) or 32. Lane c tests child c (and
c + 16 of a fanout-32 row on 16 lanes; coalesced row loads), lane k
triangle slot k, and lane d holds stack level d; ballots and shuffles
reduce in the plain version's order, so it computes the same function,
bit for bit, as the plain traversal in chroma_tpu_torch.ops.mesh_wide.

`traverse` takes the kernel for CUDA tensors and the plain version for CPU
tensors. On a CUDA tensor there is no fallback: a failed build or launch
raises. The kernel is compiled with nvcc at first use into <repo>/build/
(ops.cuda_build), and `launches` counts its launches. `traverse_thread` launches the first
design of this kernel (one thread per ray), kept as the yardstick that the
warp-cooperative walk is timed against; it counts in `thread_launches`.
"""
from __future__ import annotations

import ctypes
import os

import torch

from chroma_tpu_torch.bvh.wide import INST_B0, bounds_cols, fmt_of
from chroma_tpu_torch.ops import cuda_build, mesh_wide

SOURCE = os.path.join(cuda_build.CSRC, 'visit_kernel.cu')
WARP = 32               # lanes of a warp: the largest group, depth, leaf
THREAD_MAX_DEPTH = 32   # MAX_D of the one-thread-per-ray design
_FMT_CODE = {'f32': 0, 'bf16': 1, 'q8': 2}

# How `traverse` launches the walk, chosen by the H100 measurements of
# chip_smoke.py phase 4 (PERF.md): lanes per ray (16 puts two rays in a
# warp, where the table's depth and leaf size fit in 16 lanes; 32
# otherwise), and from how many rays persistent groups take rays from a
# counter instead of a grid of one group per ray: the grid was faster up
# to 2^15 rays and persistent groups from 2^19 in every run; between them
# the runs disagreed, and their pooled medians cross at 2^18.
GROUP = 16
PERSISTENT_MIN_RAYS = 1 << 18

# kernel launches made through `traverse` and `traverse_thread` (reset
# freely by callers)
launches = 0
thread_launches = 0

_lib = None
build_log = ''      # nvcc's output (ptxas registers and spills)


def build():
    """Compile csrc/visit_kernel.cu (ops.cuda_build) and load it. Returns
    the ctypes library; raises RuntimeError if nvcc fails."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = cuda_build.build(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    query = [p, i, i, i, i, i, i, p, p, p, p, p, i, p, p, p, p, p, p]
    lib.chroma_visit_inst.argtypes = query + [i, i, p, p]
    lib.chroma_visit_inst.restype = ctypes.c_int
    lib.chroma_visit_inst_thread.argtypes = query + [p]
    lib.chroma_visit_inst_thread.restype = ctypes.c_int
    _lib = lib
    return lib


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError('%s: want contiguous %s %s on %s, got %s %s on %s'
                         % (name, dtype, shape, device, t.dtype,
                            tuple(t.shape), t.device))


def _query(inst, origin, direction, last_hit, mask, best_limit, by_kind,
           max_depth):
    """Checked arguments and fresh outputs of one launch: (ctypes
    arguments up to out_visits, outputs, the u8 mask they point to, which
    the caller holds until the launch)."""
    dev = origin.device
    n = origin.shape[0]
    rows = inst.rows
    fmt = fmt_of(inst)
    if inst.fanout not in (16, 32) or fmt not in _FMT_CODE:
        raise ValueError('visit kernel supports fanout 16/32 and f32/bf16/'
                         'q8 bounds, got %d/%s' % (inst.fanout, fmt))
    if inst.max_depth > max_depth:
        raise ValueError('table depth %d exceeds the kernel stack (%d)'
                         % (inst.max_depth, max_depth))
    _check('rows', rows, torch.float32, tuple(rows.shape), dev)
    _check('origin', origin, torch.float32, (n, 3), dev)
    _check('direction', direction, torch.float32, (n, 3), dev)
    if last_hit is not None:
        _check('last_hit', last_hit, torch.int32, (n,), dev)
    if mask is not None:
        mask = cuda_build.mask_bytes(mask, n, dev, 'mask')
    if best_limit is not None:
        _check('best_limit', best_limit, torch.float32, (n,), dev)

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)
    out = (empty(n, torch.int32), empty(n, torch.float32),
           empty(n, torch.int32), empty((n, 3), torch.float32),
           empty(n, torch.int32),
           empty((n, 3) if by_kind else n, torch.int32))

    def ptr(t):
        return None if t is None else t.data_ptr()
    args = [rows.data_ptr(), rows.shape[1], inst.fanout, inst.leaf_size,
            inst.max_depth, _FMT_CODE[fmt],
            INST_B0 + bounds_cols(fmt, inst.fanout), origin.data_ptr(),
            direction.data_ptr(), ptr(last_hit), ptr(mask), ptr(best_limit),
            n] + [t.data_ptr() for t in out]
    return args, out, mask


def _run(fn, dev, *args):
    "Call a C entry point on dev's current stream; raise on a CUDA error."
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(err, 'visit kernel')


def launch(inst, origin, direction, last_hit=None, mask=None,
           best_limit=None, by_kind=False, group=None, persistent=None):
    """One launch of the warp-cooperative walk on CUDA tensors, with the
    lanes per ray (`group`, 16 or 32) and the schedule (`persistent`)
    given or left to GROUP / PERSISTENT_MIN_RAYS. Returns the outputs of
    `traverse`; counts in `launches`."""
    global launches
    if group is None:
        group = GROUP if max(inst.max_depth, inst.leaf_size) <= GROUP \
            else WARP
    if persistent is None:
        persistent = origin.shape[0] >= PERSISTENT_MIN_RAYS
    if group not in (16, WARP) or inst.leaf_size > group \
            or inst.fanout > 2 * group:
        raise ValueError('leaf size %d / fanout %d do not fit a group of %d '
                         'lanes' % (inst.leaf_size, inst.fanout, group))
    args, out, mask = _query(inst, origin, direction, last_hit, mask,
                             best_limit, by_kind, group)
    dev = origin.device
    counter = torch.zeros(1, dtype=torch.int32, device=dev) \
        if persistent else None
    _run(build().chroma_visit_inst, dev, *args, int(by_kind), group,
         None if counter is None else counter.data_ptr())
    launches += 1
    return out


def traverse(inst, origin, direction, last_hit=None, mask=None,
             best_limit=None, by_kind=False):
    """Instanced-BVH query: (tri, dist, code, normal, iid, visits), the
    contract of chroma_tpu_torch.ops.mesh_wide.traverse. CPU tensors run
    the plain version; CUDA tensors launch the kernel."""
    if not origin.is_cuda:
        return mesh_wide.traverse(inst, origin, direction, last_hit, mask,
                                  best_limit, by_kind)
    return launch(inst, origin, direction, last_hit, mask, best_limit,
                  by_kind)


def traverse_thread(inst, origin, direction, last_hit=None, mask=None,
                    best_limit=None):
    """The same query by the one-thread-per-ray design, on CUDA tensors
    only: the yardstick of the warp-cooperative walk, never on a main
    path. Counts in `thread_launches`."""
    global thread_launches
    if not origin.is_cuda:
        raise ValueError('traverse_thread takes CUDA tensors')
    args, out, mask = _query(inst, origin, direction, last_hit, mask,
                             best_limit, False, THREAD_MAX_DEPTH)
    _run(build().chroma_visit_inst_thread, origin.device, *args)
    thread_launches += 1
    return out
