"""Wrapper of K3, the wire walk (csrc/wire_walk.cu).

Replaces the device lax.while_loop of chroma_tpu/ops/wireplane.py
(`_intersect_one_plane`, :118-174, called per plane by
`intersect_wireplanes`, :177-197), which XLA runs on the device in
lockstep over the batch's widest candidate-wire window. Here a warp takes
32 rays: each lane sets up its own ray's window [k_lo, k_hi] on every
plane (capped at MAX_WINDOW wires beyond the first), and the warp walks
the 32 rays' candidate wires together, 32 at a time, keeping each (ray,
plane)'s nearest hit with the plain loop's tie rule (the smallest k wins
a tie) and then each ray's nearest plane in plane order, so the result is
walk_plain's bit for bit. The window set-up (wireplane._plane_window) is
in the kernel too, with fmaf exactly where the plain code calls
linalg.fma. Nothing is read on the host, so a CUDA graph captures the
step of a wire-plane geometry.

`walk` launches K3 for CUDA tensors and runs the plain twin
(wireplane.walk_plain) for CPU tensors; on a CUDA tensor a failed build
or launch raises. K3's launches count as `k3` (ops.cuda_build).
"""
from __future__ import annotations

import ctypes
import os

import torch

from chroma_tpu_torch.ops import cuda_build, wireplane

SOURCE = os.path.join(cuda_build.CSRC, 'wire_walk.cu')
PLANE_WORDS = 19    # origin, u, v, w (3 each), pitch, radius, umin, umax,
                    # vmin, vmax, v0


def bind(lib):
    "Set the C entry points' argument types on `lib`, a build of SOURCE."
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.chroma_wire_walk.argtypes = [p, p, p, p, i, i, p, p, p, p, p]
    lib.chroma_wire_walk.restype = i
    for fn in (lib.chroma_wire_walk_load, lib.chroma_wire_walk_max_planes):
        fn.argtypes = []
        fn.restype = i


library = cuda_build.Library(SOURCE, bind, 'chroma_wire_walk_load')


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
    active (N,) bool or None)."""
    n = pos.shape[0]
    dev = pos.device
    f32 = torch.float32
    args = [cuda_build.pointer('pos', pos, f32, (n, 3), dev),
            cuda_build.pointer('direction', direction, f32, (n, 3), dev)]
    if plane_table.device != dev or plane_table.shape[1] != PLANE_WORDS:
        raise ValueError('plane table must be (P, %d) on %s'
                         % (PLANE_WORDS, dev))
    lib = library.load()
    if plane_table.shape[0] > lib.chroma_wire_walk_max_planes():
        raise ValueError('%d wire planes: the warp walk takes at most %d'
                         % (plane_table.shape[0],
                            lib.chroma_wire_walk_max_planes()))
    mask = None if active is None else cuda_build.mask_bytes(active, n,
                                                              dev)
    best_t = torch.empty(n, dtype=torch.float32, device=dev)
    best_plane = torch.empty(n, dtype=torch.int32, device=dev)
    best_vn = torch.empty(n, dtype=torch.float32, device=dev)
    best_nn = torch.empty(n, dtype=torch.float32, device=dev)
    cuda_build.launch(
        'k3', lib.chroma_wire_walk, dev, *args,
        None if mask is None else mask.data_ptr(), plane_table.data_ptr(),
        plane_table.shape[0], n, best_t.data_ptr(), best_plane.data_ptr(),
        best_vn.data_ptr(), best_nn.data_ptr())
    return best_t, best_plane, best_vn, best_nn
