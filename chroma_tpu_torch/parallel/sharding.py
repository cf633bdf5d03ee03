"""Multi-GPU photon sharding (counterpart of chroma_tpu.parallel.sharding).

Photons are data-parallel over the ranks of a torch.distributed process
group, one process a device, and the geometry is replicated: every rank
builds or loads it itself. Rank r propagates its contiguous slice of the
batch with the port's own driver and its own random streams, compacting
on its own, with no collective inside the step loop:
ops.propagate.propagate with tune=False, so that on the fused route a
rank runs schedule_for's schedule for its slice and never probes. Then
the slices are gathered, bit for bit, into the full batch in input lane
order on every rank, as the JAX package returns one global array. The
DAQ runs on each rank's slice and its channel readouts are reduced
across the ranks with the reference's atomic semantics (daq.cu:73-75):

  earliest hit time  -> all_reduce MIN
  channel charge     -> all_reduce SUM
  channel history OR -> all_reduce SUM of the 32 bit columns, recombined

The JAX package's cached SPMD programs and its uniform power-of-two bucket
of the worst shard exist for static shapes and compiled-program caching
and have no counterpart here. The gloo backend reduces tensors on the host:
a rank's tensors are staged through the CPU for it (several ranks may then
share one card); NCCL needs one card a rank. Start the ranks with torchrun,
or from one process with chroma_tpu_torch.parallel.run_ranks.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from chroma_tpu_torch.event import NO_HIT
from chroma_tpu_torch.log import logger
from chroma_tpu_torch.ops import daq as daq_ops
from chroma_tpu_torch.ops.photon import PhotonState, i32
from chroma_tpu_torch.ops.propagate import propagate
from chroma_tpu_torch.ops.sample import make_generator
from chroma_tpu_torch.profiler import profiler

SHARD_SITE = 0x5A4D   # rank r's streams: (seed, SHARD_SITE, r)
DAQ_SITE = 0x7FFFFFFF  # the DAQ's seed: (seed, DAQ_SITE), as JAX folds it


@dataclasses.dataclass(frozen=True)
class PhotonMesh:
    """The ranks that share a photon batch: a process group (None for the
    default group), its size, this process's rank in it and its device."""
    group: object
    size: int
    rank: int
    device: torch.device


def photon_mesh(n_devices=None, group=None, device=None):
    """The photon mesh of this process: the initialised default process
    group, or `group`. n_devices smaller than the group's size makes a
    subgroup of its first n_devices ranks (every rank of the group must
    call this; a rank outside the subgroup then raises). The device is
    cuda:(LOCAL_RANK or rank) % the visible cards unless given; ranks past
    the number of cards share a card. A CUDA device becomes the process's
    current device, which NCCL's communicators and every CUDA call that
    names no device use. Raises without an initialised group, and never
    falls back to one device."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError('photon_mesh needs an initialised '
                           'torch.distributed process group: start the ranks '
                           'with torchrun or chroma_tpu_torch.parallel.'
                           'run_ranks')
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if n_devices is not None and n_devices > size:
        raise ValueError('n_devices=%d but the process group has %d ranks'
                         % (n_devices, size))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('photon_mesh: CUDA is not available; pass '
                               "device='cpu' to shard on the CPU")
        cards = torch.cuda.device_count()
        local = int(os.environ.get('LOCAL_RANK', rank))
        device = torch.device('cuda', local % cards)
        if (n_devices or size) > cards:
            logger.info('photon_mesh: %d ranks share %d card(s); rank %d '
                        'runs on %s', n_devices or size, cards, rank, device)
    device = torch.device(device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    if n_devices is not None and n_devices != size:
        ranks = dist.get_process_group_ranks(group) if group is not None \
            else list(range(size))
        group = dist.new_group(ranks[:n_devices])
        if rank >= n_devices:
            raise ValueError('rank %d is outside the first %d ranks of the '
                             'group' % (rank, n_devices))
        size = n_devices
    return PhotonMesh(group=group, size=size, rank=rank, device=device)


def shard_seed(seed, mesh):
    """Rank `mesh.rank`'s seed, (seed, SHARD_SITE, rank), for
    ops.sample.make_generator and the propagation driver: no two ranks
    share a draw (counterpart of JAX's _shard_key)."""
    return (seed, SHARD_SITE, mesh.rank)


def _mesh_size(mesh):
    return mesh if isinstance(mesh, int) else mesh.size


def pad_to_mesh(state, mesh):
    """Pad a PhotonState to a multiple of the mesh size (a PhotonMesh or an
    int) with terminated lanes: zeros, flags NO_HIT, last-hit triangle and
    medium -1, so they are dead and never detected. Returns (padded, n)."""
    n = len(state)
    pad = (-n) % _mesh_size(mesh)
    if pad == 0:
        return state, n

    def _pad(a):
        return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
    padded = state.map(_pad)
    padded.flags[n:] = i32(NO_HIT)
    padded.last_hit_triangle[n:] = -1
    padded.cur_mat[n:] = -1
    return padded, n


def _staged(mesh):
    "Whether the group's backend reduces on the host (gloo): stage there."
    return dist.get_backend(mesh.group) == 'gloo'


def _all_reduce(tensor, op, mesh):
    "all_reduce of a copy of `tensor`, staged on the host for gloo."
    work = tensor.to('cpu', copy=True) if _staged(mesh) else tensor.clone()
    dist.all_reduce(work, op=op, group=mesh.group)
    return work.to(tensor.device)


def _all_gather(tensor, mesh):
    """Every rank's `tensor` (same shape on each) concatenated in rank
    order, on every rank: a copy, bit for bit, no arithmetic."""
    work = tensor.cpu() if _staged(mesh) else tensor
    parts = [torch.empty_like(work) for _ in range(mesh.size)]
    dist.all_gather(parts, work.contiguous(), group=mesh.group)
    return torch.cat(parts).to(tensor.device)


def _columns(a):
    "A contiguous (N, m) view of an (N, ...) tensor."
    return (a.flatten(1) if a.dim() > 1 else a[:, None]).contiguous()


def _gather_state(local, mesh):
    """The full PhotonState from every rank's slice, in rank order, on
    every rank: each field is reinterpreted as int32 words and the words
    of all fields travel in one all_gather."""
    fields = [f.name for f in dataclasses.fields(local)]
    words = [_columns(getattr(local, name)).view(torch.int32)
             for name in fields]
    widths = [w.shape[1] for w in words]
    full = _all_gather(torch.cat(words, dim=1), mesh)
    out, col = {}, 0
    for name, width in zip(fields, widths):
        like = getattr(local, name)
        out[name] = full[:, col:col + width].contiguous() \
            .view(like.dtype).reshape((full.shape[0],) + like.shape[1:])
        col += width
    return PhotonState(**out)


def reduce_channel_arrays(local, mesh):
    """Combine every rank's ChannelArrays with the reference's atomic
    semantics (cuda/daq.cu:73-75): earliest time MIN, charge SUM, history
    OR, the OR as a SUM of the 32 bit columns recombined (no backend has a
    bitwise-OR reduction on every device). Every rank gets the result."""
    earliest = _all_reduce(local.earliest_time, dist.ReduceOp.MIN, mesh)
    charge = _all_reduce(local.charge, dist.ReduceOp.SUM, mesh)
    shifts = torch.arange(32, dtype=torch.int64,
                          device=local.histories.device)
    bits = ((local.histories.to(torch.int64)[:, None] & 0xFFFFFFFF)
            >> shifts) & 1
    bit_any = _all_reduce(bits.to(torch.int32), dist.ReduceOp.SUM,
                          mesh) > 0
    word = (bit_any.to(torch.int64) << shifts).sum(dim=1)
    histories = torch.where(word >= 2 ** 31, word - 2 ** 32,
                            word).to(torch.int32)
    return daq_ops.ChannelArrays(earliest_time=earliest, charge=charge,
                                 histories=histories)


def _local_slice(photons, mesh):
    "This rank's contiguous slice of the batch, on its device."
    n = len(photons)
    if n % mesh.size:
        raise ValueError('batch length %d does not divide the %d-device '
                         'mesh; pad first (see pad_to_mesh)'
                         % (n, mesh.size))
    per = n // mesh.size
    lo = mesh.rank * per
    return photons.map(lambda a: a[lo:lo + per].to(mesh.device))


def _propagate_local(photons, geometry, seed, max_steps, mesh, use_weights,
                     scatter_first, compact=True, step_chunk='auto'):
    """Propagate this rank's slice alone; returns it. On the fused route
    a rank runs schedule_for's schedule for its slice (the single-card
    tuned entry, or the probe schedule) and never probes, as
    chroma_tpu's sharded bomb never does."""
    local = _local_slice(photons, mesh)
    rseed = shard_seed(seed, mesh)
    with profiler.region('sharded.propagate[n=%d]' % len(local)):
        return propagate(local, geometry, rseed, max_steps=max_steps,
                         step_chunk=step_chunk, use_weights=use_weights,
                         scatter_first=scatter_first, compact=compact,
                         tune=False)


def propagate_sharded(photons, geometry, seed, max_steps=100, mesh=None,
                      use_weights=False, scatter_first=0, compact=True,
                      step_chunk='auto'):
    """Propagate a photon batch sharded over the mesh: every rank passes
    the same batch (any device) and its own copy of the geometry on
    mesh.device; rank r propagates lanes [r*n/k, (r+1)*n/k) with
    shard_seed(seed, mesh), compacting on its own (compact=False: one
    chunk of max_steps, no compaction). The batch length must divide the
    mesh size. Returns the full final PhotonState on every rank's device,
    in input lane order."""
    mesh = photon_mesh() if mesh is None else mesh
    local = _propagate_local(photons, geometry, seed, max_steps, mesh,
                             use_weights, scatter_first, compact, step_chunk)
    with profiler.region('sharded.gather'):
        return _gather_state(local, mesh)


def propagate_and_daq_sharded(photons, geometry, seed, max_steps=100,
                              mesh=None, use_weights=False, scatter_first=0,
                              ndaq=1, uniforms=None, **driver_kwargs):
    """propagate_sharded, then the DAQ: each rank runs ops.daq.run_daq on
    its own propagated slice with a generator seeded by
    shard_seed((seed, DAQ_SITE), mesh) -- or with `uniforms`, the draws
    run_daq would take, injected for that slice (tests) -- and the channel
    readouts are reduced across the ranks (reduce_channel_arrays). Returns
    (photons, ChannelArrays), both on every rank."""
    mesh = photon_mesh() if mesh is None else mesh
    local = _propagate_local(photons, geometry, seed, max_steps, mesh,
                             use_weights, scatter_first, **driver_kwargs)
    with profiler.region('sharded.daq'):
        gen = None if uniforms is not None else make_generator(
            mesh.device, *shard_seed((seed, DAQ_SITE), mesh))
        channels = reduce_channel_arrays(
            daq_ops.run_daq(local, geometry, gen, ndaq=ndaq,
                            uniforms=uniforms), mesh)
    with profiler.region('sharded.gather'):
        return _gather_state(local, mesh), channels


def photon_channels_sharded(photons, geometry, mesh=None):
    """Per-photon channel ids (-1 undetected) of the whole batch, each
    rank computing its slice's, gathered on every rank."""
    mesh = photon_mesh() if mesh is None else mesh
    local = _local_slice(photons, mesh)
    return _all_gather(daq_ops.photon_channels_device(local, geometry), mesh)
