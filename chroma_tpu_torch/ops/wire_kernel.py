"""Wrapper of K3, the per-lane wire walk (csrc/wire_walk.cu).

Replaces the device lax.while_loop of chroma_tpu/ops/wireplane.py
(`_intersect_one_plane`, :118-174, called per plane by
`intersect_wireplanes`, :177-197), which XLA runs on the device in
lockstep over the batch's widest candidate-wire window. Here one thread a
lane walks every plane, and within a plane its own window [k_lo, k_hi]
(capped at MAX_WINDOW wires beyond the first), keeping the nearest hit
with the same strict `t < best` test in ascending k and plane order, so
ties resolve as the lockstep loop resolves them. The window set-up
(wireplane._plane_window) is in the kernel too, with fmaf exactly where
the plain code calls linalg.fma. Nothing is read on the host, so a CUDA
graph captures the step of a wire-plane geometry.

`walk` launches K3 for CUDA tensors and runs the plain twin
(wireplane.walk_plain) for CPU tensors; on a CUDA tensor a failed build
or launch raises. `launches` counts K3's launches.
"""
from __future__ import annotations

import ctypes
import os

import torch

from chroma_tpu_torch.ops import cuda_build, wireplane

SOURCE = os.path.join(cuda_build.CSRC, 'wire_walk.cu')
PLANE_WORDS = 19    # origin, u, v, w (3 each), pitch, radius, umin, umax,
                    # vmin, vmax, v0

launches = 0
build_log = ''
_lib = None


def build():
    """Compile csrc/wire_walk.cu (ops.cuda_build) and load it, with the
    kernel's module loaded now rather than at its first launch (which may
    be inside a graph capture). Raises RuntimeError if nvcc fails."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = cuda_build.build(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.chroma_wire_walk.argtypes = [p, p, p, p, i, i, p, p, p, p, p]
    lib.chroma_wire_walk.restype = ctypes.c_int
    lib.chroma_wire_walk_load.argtypes = []
    lib.chroma_wire_walk_load.restype = ctypes.c_int
    cuda_build.check_launch(lib.chroma_wire_walk_load(), 'wire walk load')
    _lib = lib
    return lib


def _pack_planes(geometry):
    wp = geometry.wireplanes
    cols = [wp.origin, wp.u, wp.v, wp.w] + [
        getattr(wp, name)[:, None] for name in (
            'pitch', 'radius', 'umin', 'umax', 'vmin', 'vmax', 'v0')]
    return torch.cat(cols, dim=1).to(torch.float32).contiguous()


def planes(geometry):
    "The geometry's wire planes as K3 reads them: (P, PLANE_WORDS) f32."
    return cuda_build.geometry_tables(geometry, 'wire_planes', _pack_planes)


def walk(pos, direction, geometry, active):
    """Nearest wire hit over all planes: (t, plane i32, vn, nn), the
    contract of wireplane.walk_plain. CPU tensors run the plain twin; CUDA
    tensors launch K3."""
    if not pos.is_cuda:
        return wireplane.walk_plain(pos, direction, geometry, active)
    return launch(pos, direction, planes(geometry), active)


def launch(pos, direction, plane_table, active):
    """One launch of K3 on CUDA tensors (pos, direction (N, 3) f32,
    active (N,) bool or None); counts in `launches`."""
    global launches
    n = pos.shape[0]
    dev = pos.device
    for name, t, shape in (('pos', pos, (n, 3)),
                           ('direction', direction, (n, 3))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or t.device != dev or not t.is_contiguous():
            raise ValueError('%s: want contiguous f32 %s on %s' % (
                name, shape, dev))
    if plane_table.device != dev or plane_table.shape[1] != PLANE_WORDS:
        raise ValueError('plane table must be (P, %d) on %s'
                         % (PLANE_WORDS, dev))
    mask = None
    if active is not None:
        mask = active.to(torch.uint8).contiguous()
        if tuple(mask.shape) != (n,) or mask.device != dev:
            raise ValueError('active: want (%d,) on %s' % (n, dev))
    best_t = torch.empty(n, dtype=torch.float32, device=dev)
    best_plane = torch.empty(n, dtype=torch.int32, device=dev)
    best_vn = torch.empty(n, dtype=torch.float32, device=dev)
    best_nn = torch.empty(n, dtype=torch.float32, device=dev)
    lib = build()
    with torch.cuda.device(dev):
        err = lib.chroma_wire_walk(
            pos.data_ptr(), direction.data_ptr(),
            None if mask is None else mask.data_ptr(),
            plane_table.data_ptr(), plane_table.shape[0], n,
            best_t.data_ptr(), best_plane.data_ptr(), best_vn.data_ptr(),
            best_nn.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(err, 'wire walk')
    launches += 1
    return best_t, best_plane, best_vn, best_nn
