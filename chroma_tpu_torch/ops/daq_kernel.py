"""Wrapper of K4, the DAQ readout (csrc/daq_kernel.cu).

Replaces the JAX package's readout (chroma_tpu/ops/daq.py::_daq_block,
XLA's segment_min / segment_sum / per-bit segment_max over every
(replica, photon) pair, a block of DAQ_BLOCK replicas at a time) with
one pass of Chroma's own design (chroma/cuda/daq.cu): a thread takes a
photon and a group of replicas and maps the photon's last triangle to
its channel, an undetected photon reads no draw, and a kept (replica,
photon) pair does an atomicMin on a sortable int of its time, a 64-bit
atomicAdd of its charge count and an atomicOr of its history on its
replica's row of channels. All `ndaq` replicas are read
out in one launch, between an init and a finish launch of the same
source, and the result is ops.daq.readout_plain's bit for bit.

`readout` launches the three on CUDA tensors (ops.daq.run_daq calls it
for every CUDA readout; a failed build or launch raises, and the CPU runs
readout_plain instead). K4's launches count as `k4` (ops.cuda_build).
"""
from __future__ import annotations

import ctypes
import os

import torch

from chroma_tpu_torch.event import SURFACE_DETECT
from chroma_tpu_torch.ops import cuda_build
from chroma_tpu_torch.ops.photon import i32

SOURCE = os.path.join(cuda_build.CSRC, 'daq_kernel.cu')


def bind(lib):
    "Set the C entry points' argument types on `lib`, a build of SOURCE."
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.chroma_daq.argtypes = [p, p, p, p, p, i, p, p, i, i, p, p, i, i, f,
                               i, i, i, i, p, p, p, p, p]
    lib.chroma_daq.restype = i
    lib.chroma_daq_load.argtypes = []
    lib.chroma_daq_load.restype = i


library = cuda_build.Library(SOURCE, bind, 'chroma_daq_load')


def _pack_tables(geometry):
    det = geometry.detector
    return torch.cat([det.time_cdf_x, det.time_cdf_y, det.charge_cdf_x,
                      det.charge_cdf_y, det.charge_unit.reshape(1)]).to(
        torch.float32).contiguous()


def tables(geometry):
    """The detector's time and charge CDFs and its charge unit as K4 reads
    them: one f32 vector (time x, time cdf, charge x, charge cdf, unit),
    made on the device without a host read."""
    return cuda_build.geometry_tables(geometry, 'daq_tables', _pack_tables)


def readout(photons, geometry, draws, ndaq, global_weight=1.0,
            detection_state=SURFACE_DETECT):
    """K4 over all `ndaq` replicas of the PhotonState `photons` on
    `geometry`: (earliest time f32, charge f32, histories i32), each
    (ndaq * C,) replica-major, MAX_TIME where no photon was kept. A photon
    counts when it ended on a channel's triangle with a `detection_state`
    flag bit (K4 maps the triangle to its channel as
    ops.daq.photon_channels_device does); `draws` are the (blocks, 3,
    rows, N) f32 U[0, 1) draws of ops.daq.daq_draws."""
    det = geometry.detector
    n = len(photons)
    dev = photons.t.device
    ptr = cuda_build.pointer
    names = ('last_hit_triangle', 'flags', 't', 'weight')
    fields = [getattr(photons, name).contiguous() for name in names]
    field_ptrs = [ptr(name, field, dtype, (n,), dev) for name, field, dtype
                  in zip(names, fields, (torch.int32, torch.int32,
                                         torch.float32, torch.float32))]
    if draws.dim() != 4:
        raise ValueError('draws: want (blocks, 3, rows, N), got %s'
                         % (tuple(draws.shape),))
    blocks, _, rows, _ = draws.shape
    draws_ptr = ptr('draws', draws, torch.float32, (blocks, 3, rows, n), dev)
    if ndaq < 1 or blocks * rows < ndaq or (blocks - 1) * rows >= ndaq:
        raise ValueError('%d replicas do not fill %d blocks of %d draws'
                         % (ndaq, blocks, rows))
    n_time = det.time_cdf_x.shape[0]
    n_charge = det.charge_cdf_x.shape[0]
    if det.time_cdf_y.shape[0] != n_time or \
            det.charge_cdf_y.shape[0] != n_charge or min(n_time,
                                                         n_charge) < 2:
        raise ValueError('the time and charge CDFs need two or more '
                         'points, x and cdf alike')
    table = ptr('tables', tables(geometry), torch.float32,
                (2 * (n_time + n_charge) + 1,), dev)
    solid_channel = det.solid_id_to_channel_index
    channel_ptr = ptr('solid_id_to_channel_index', solid_channel,
                      torch.int32, solid_channel.shape[:1], dev)
    if geometry.inst is not None:
        tri_base = geometry.inst.tri_base
        by_triangle = (ptr('tri_base', tri_base, torch.int32,
                           tri_base.shape[:1], dev), tri_base.shape[0], None)
    else:
        solid_id = geometry.solid_id
        by_triangle = (None, 0, ptr('solid_id', solid_id, torch.int32,
                                    solid_id.shape[:1], dev))
    c = det.nchannels
    lib = library.load()
    earliest = torch.empty(ndaq * c, dtype=torch.int32, device=dev)
    count = torch.empty(ndaq * c, dtype=torch.int64, device=dev)
    histories = torch.empty(ndaq * c, dtype=torch.int32, device=dev)
    charge = torch.empty(ndaq * c, dtype=torch.float32, device=dev)
    cuda_build.launch(
        'k4', lib.chroma_daq, dev, *field_ptrs, *by_triangle, channel_ptr,
        solid_channel.shape[0], i32(detection_state), draws_ptr, table,
        n_time, n_charge, float(global_weight), ndaq, rows, n, c,
        earliest.data_ptr(), count.data_ptr(), histories.data_ptr(),
        charge.data_ptr())
    # the finish launch left the earliest times' f32 bits in place
    return earliest.view(torch.float32), charge, histories
