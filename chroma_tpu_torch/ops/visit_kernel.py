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
and its launches count as `k1` (ops.cuda_build).
"""
from __future__ import annotations

import ctypes
import os

import torch

from chroma_tpu_torch.bvh.wide import INST_B0, bounds_cols, fmt_of
from chroma_tpu_torch.ops import cuda_build, mesh_wide

SOURCE = os.path.join(cuda_build.CSRC, 'visit_kernel.cu')
WARP = 32               # lanes of a warp: the largest group, depth, leaf
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


def bind(lib):
    "Set the C entry point's argument types on `lib`, a build of SOURCE."
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.chroma_visit_inst.argtypes = [p, i, i, i, i, i, i, p, p, p, p, p, i,
                                      p, p, p, p, p, p, i, i, p, p]
    lib.chroma_visit_inst.restype = ctypes.c_int


library = cuda_build.Library(SOURCE, bind)


def launch(inst, origin, direction, last_hit=None, mask=None,
           best_limit=None, by_kind=False, group=None, persistent=None):
    """One launch of the warp-cooperative walk on CUDA tensors, with the
    lanes per ray (`group`, 16 or 32) and the schedule (`persistent`)
    given or left to GROUP / PERSISTENT_MIN_RAYS. Returns the outputs of
    `traverse`."""
    if group is None:
        group = GROUP if max(inst.max_depth, inst.leaf_size) <= GROUP \
            else WARP
    if persistent is None:
        persistent = origin.shape[0] >= PERSISTENT_MIN_RAYS
    if group not in (16, WARP) or inst.leaf_size > group \
            or inst.fanout > 2 * group:
        raise ValueError('leaf size %d / fanout %d do not fit a group of %d '
                         'lanes' % (inst.leaf_size, inst.fanout, group))
    dev = origin.device
    n = origin.shape[0]
    rows = inst.rows
    fmt = fmt_of(inst)
    if inst.fanout not in (16, 32) or fmt not in _FMT_CODE:
        raise ValueError('visit kernel supports fanout 16/32 and f32/bf16/'
                         'q8 bounds, got %d/%s' % (inst.fanout, fmt))
    if inst.max_depth > group:
        raise ValueError('table depth %d exceeds the kernel stack (%d)'
                         % (inst.max_depth, group))
    f32, i32 = torch.float32, torch.int32
    ptr = cuda_build.pointer
    args = [ptr('rows', rows, f32, rows.shape, dev), rows.shape[1],
            inst.fanout, inst.leaf_size, inst.max_depth, _FMT_CODE[fmt],
            INST_B0 + bounds_cols(fmt, inst.fanout),
            ptr('origin', origin, f32, (n, 3), dev),
            ptr('direction', direction, f32, (n, 3), dev),
            ptr('last_hit', last_hit, i32, (n,), dev),
            None if mask is None else
            cuda_build.mask_bytes(mask, n, dev, 'mask').data_ptr(),
            ptr('best_limit', best_limit, f32, (n,), dev), n]

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)
    out = (empty(n, i32), empty(n, f32), empty(n, i32), empty((n, 3), f32),
           empty(n, i32), empty((n, 3) if by_kind else n, i32))
    counter = torch.zeros(1, dtype=i32, device=dev) if persistent else None
    cuda_build.launch('k1', library.load().chroma_visit_inst, dev, *args,
                      *(t.data_ptr() for t in out), int(by_kind), group,
                      None if counter is None else counter.data_ptr())
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

