"""PMT DAQ and flat-hit extraction for the torch port (counterpart of
chroma_tpu.ops.daq).

A readout's draws are made first, all of them, into one (blocks, 3,
rows, N) buffer in the order the replica blocks always drew them
(daq_draws). On a CUDA tensor K4 (ops.daq_kernel, csrc/daq_kernel.cu)
then reads out every replica in one launch; on the CPU its plain twin,
readout_plain, reduces block by block: per channel the earliest hit time
is a scatter_reduce 'amin', the charge a scatter_add of integer counts of
charge_unit (so the order in which the device adds them cannot change
the sum), and the history an OR built from a per-bit 'amax'. Flat hits
are counted and packed on the device and stay there, in a LazyHits,
until a field is read.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chroma_tpu_torch import event
from chroma_tpu_torch.event import SURFACE_DETECT
from chroma_tpu_torch.ops import daq_kernel
from chroma_tpu_torch.ops.photon import i32
from chroma_tpu_torch.ops.sample import sample_cdf_pairs, uniform
from chroma_tpu_torch.profiler import profiler

MAX_TIME = 1e9      # "no hit" earliest-time sentinel
HIT_TIME_CUT = 1e8  # a channel is hit if its earliest time is below this
DAQ_BLOCK = 8       # replica rows a block of draws


@dataclasses.dataclass
class ChannelArrays:
    """Per-channel readout: (C,) or (ndaq*C,) tensors."""
    earliest_time: torch.Tensor  # f32, MAX_TIME when not hit
    charge: torch.Tensor         # f32, quantized to charge_unit
    histories: torch.Tensor      # i32 OR of contributing flags (u32 bits)


def tri_solid(geometry, tri):
    """Owning solid of each hit triangle: a binary search over the instance
    triangle ranges (instance i is solid i), else the per-triangle map."""
    safe = torch.clamp(tri, min=0)
    if geometry.inst is not None:
        return (torch.searchsorted(geometry.inst.tri_base, safe, right=True)
                .to(torch.int32) - 1)
    return geometry.solid_id[safe.to(torch.int64)]


def _segment_or(values, segment_ids, num_segments):
    "Bitwise OR of int32 words per segment via a per-bit amax."
    shifts = torch.arange(32, dtype=torch.int64, device=values.device)
    bits = ((values.to(torch.int64)[:, None] & 0xFFFFFFFF) >> shifts) & 1
    per_bit = torch.zeros((num_segments, 32), dtype=torch.int64,
                          device=values.device)
    per_bit.scatter_reduce_(0, segment_ids[:, None].expand(-1, 32), bits,
                            reduce='amax')
    word = (per_bit << shifts).sum(dim=1)
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def _daq_block(photons, det, u_keep, u_time, u_charge, rep0, ndaq,
               global_weight, channel, detected):
    """One replica block: (nrep, N) U[0, 1) draws -> (nrep*C,)
    reductions. Replicas rep0..rep0+nrep-1; rows past ndaq contribute
    nothing. A photon is kept with probability weight * global_weight."""
    nrep = u_keep.shape[0]
    c = det.nchannels
    dev = photons.t.device
    u_keep, u_time, u_charge = uniform(u_keep), uniform(u_time), \
        uniform(u_charge)

    rep = rep0 + torch.arange(nrep, dtype=torch.int32, device=dev)
    keep = (detected[None, :] & (rep < ndaq)[:, None]
            & (u_keep < photons.weight[None, :] * global_weight))

    time = photons.t[None, :] + sample_cdf_pairs(u_time, det.time_cdf_x,
                                                 det.time_cdf_y)
    charge = sample_cdf_pairs(u_charge, det.charge_cdf_x, det.charge_cdf_y)
    charge_int = torch.round(charge / det.charge_unit)

    seg = (torch.clamp(channel, min=0)[None, :]
           + torch.arange(nrep, dtype=torch.int32, device=dev)[:, None] * c)
    # photons that don't contribute go to an overflow segment
    seg = torch.where(keep, seg, nrep * c).reshape(-1).to(torch.int64)
    nseg = nrep * c + 1

    time_flat = torch.where(keep, time, MAX_TIME).reshape(-1)
    earliest = torch.full((nseg,), MAX_TIME, dtype=torch.float32,
                          device=dev)
    earliest.scatter_reduce_(0, seg, time_flat, reduce='amin')

    counts = torch.where(keep, charge_int, 0.0).reshape(-1).to(torch.int64)
    q = torch.zeros(nseg, dtype=torch.int64, device=dev)
    q.scatter_add_(0, seg, counts)
    q = q[:-1].to(torch.float32) * det.charge_unit

    flags_flat = torch.where(keep.reshape(-1), photons.flags.repeat(nrep), 0)
    histories = _segment_or(flags_flat, seg, nseg)[:-1]
    return earliest[:-1], q, histories


def daq_draws(n, ndaq, device, generator=None, uniforms=None):
    """A readout's U[0, 1) draws as one (blocks, 3, rows, N) f32 tensor:
    ceil(ndaq / DAQ_BLOCK) blocks of rows = min(ndaq, DAQ_BLOCK) replicas,
    sites keep, time, charge; the last block is drawn whole. A generator
    fills the (rows, N) views block by block, site by site, each with the
    numbers torch.rand of that shape would give next (the stream of one
    torch.rand a block and site); `uniforms(block, site, shape)` arrays
    are copied in instead."""
    rows = min(ndaq, DAQ_BLOCK)
    out = torch.empty((-(-ndaq // DAQ_BLOCK), 3, rows, n),
                      dtype=torch.float32, device=device)
    for k, view in enumerate(out.view(-1, rows, n).unbind()):
        if uniforms is None:
            view.uniform_(0.0, 1.0, generator=generator)
        else:
            view.copy_(torch.from_numpy(np.array(
                uniforms(*divmod(k, 3), (rows, n)), np.float32)))
    return out


def readout_plain(photons, geometry, draws, ndaq, global_weight=1.0,
                  detection_state=SURFACE_DETECT):
    """K4's plain twin: the readout of `draws` (daq_draws) block by block
    with scatters, on any device. Returns ChannelArrays (ndaq*C,)."""
    det = geometry.detector
    c = det.nchannels
    channel = photon_channels_device(photons, geometry, detection_state)
    detected = channel >= 0
    parts = [_daq_block(photons, det, *block, b * DAQ_BLOCK, ndaq,
                        global_weight, channel, detected)
             for b, block in enumerate(draws)]
    return ChannelArrays(
        earliest_time=torch.cat([p[0] for p in parts])[:ndaq * c],
        charge=torch.cat([p[1] for p in parts])[:ndaq * c],
        histories=torch.cat([p[2] for p in parts])[:ndaq * c])


def run_daq(photons, geometry, generator=None, ndaq=1, uniforms=None,
            global_weight=1.0, detection_state=SURFACE_DETECT):
    """One DAQ readout (or `ndaq` replicas) of a propagated PhotonState
    (reference: daq.cu run_daq / run_daq_many). A photon counts when it
    ended on a triangle of a channel with a `detection_state` flag bit,
    and is kept with probability weight * global_weight. Draws come from
    `generator`, or from `uniforms(block, site, shape)` -- U[0, 1) arrays,
    site 0 keep, 1 time, 2 charge -- when injected (daq_draws). CUDA
    tensors are read out by K4 in one launch, CPU tensors by its plain
    twin. Returns ChannelArrays with leading dimension ndaq*C,
    replica-major."""
    with profiler.region('daq.run'):
        dev = photons.t.device
        with profiler.region('daq.draws'):
            draws = daq_draws(len(photons), ndaq, dev, generator, uniforms)
        with profiler.region('daq.reduce'):
            if dev.type != 'cuda':
                return readout_plain(photons, geometry, draws, ndaq,
                                     global_weight, detection_state)
            out = ChannelArrays(*daq_kernel.readout(
                photons, geometry, draws, ndaq, global_weight,
                detection_state))
            profiler.count('daq.kernel_calls')
            return out


def channels_to_host(channel_arrays, evidx=None):
    "ChannelArrays -> event.Channels."
    with profiler.region('daq.to_host'):
        t = channel_arrays.earliest_time.cpu().numpy()
        q = channel_arrays.charge.cpu().numpy()
        flags = channel_arrays.histories.cpu().numpy().view(np.uint32)
    return event.Channels(hit=t < HIT_TIME_CUT, t=t, q=q, flags=flags,
                          evidx=evidx)


def photon_channels_device(state, geometry, detection_state=SURFACE_DETECT):
    """Channel index of each photon that ended on a channel's triangle with
    a `detection_state` flag bit, -1 otherwise (the count half of the
    reference's flat-hit kernels, propagate.cu:172-251). Wire hits
    (last_hit_triangle -2) and misses (-1) are no triangle."""
    tri = state.last_hit_triangle
    solid = tri_solid(geometry, tri)
    channel = geometry.detector.solid_id_to_channel_index[
        solid.to(torch.int64)]
    detected = ((tri > -1) & (channel >= 0)
                & ((state.flags & i32(detection_state)) != 0))
    return torch.where(detected, channel, -1).to(torch.int32)


def flat_hit_pack(state, geometry):
    """Front-pack detected lanes: (channel (N,), perm (N,) with detected
    lanes first, n_detected 0-d tensor)."""
    channel = photon_channels_device(state, geometry)
    det = channel >= 0
    deti = det.to(torch.int64)
    n_det = deti.sum()
    fwd = torch.cumsum(deti, 0) - 1
    bwd = n_det + torch.cumsum(1 - deti, 0) - 1
    dest = torch.where(det, fwd, bwd)
    perm = torch.empty_like(dest)
    perm[dest] = torch.arange(dest.shape[0], device=dest.device)
    return channel, perm, n_det


def gather_hits(state, channel, perm, m):
    """The first `m` lanes of the front-pack `perm` (flat_hit_pack): (an
    m-lane PhotonState, their channels); lanes past the detected count
    are undetected filler with channel -1."""
    sel = perm[:m]
    return state.map(lambda a: a[sel]), channel[sel]


def flat_hit_gather(state, geometry, m):
    """Pack and gather at once: (the m-lane state of gather_hits, its
    channels (m,), the detected count as a 0-d tensor)."""
    channel, perm, n_det = flat_hit_pack(state, geometry)
    sub, ch = gather_hits(state, channel, perm, m)
    return sub, ch, n_det


class LazyHits(event.Photons):
    """Flat hits that stay on the device until a field is read.

    Holds the packed detected lanes (a PhotonState and their channels) on
    the device; len() is free, and the first read of a photon field copies
    every field to the host in one pass, after which the object is an
    ordinary Photons. Pickling ships a plain Photons. (The counterpart of
    chroma_tpu.ops.daq.LazyHits; the port gathers exactly the detected
    lanes, so no gather width is learned.)"""

    _FIELDS = ('pos', 'dir', 'pol', 'wavelengths', 't',
               'last_hit_triangles', 'flags', 'weights', 'evidx',
               'channel')

    def __init__(self, sub_state, channel_dev, n_det):
        # Photons.__init__ is not called: the fields stay unset, so
        # __getattr__ sees their first read
        self._dev = (sub_state, channel_dev)
        self._n = int(n_det)

    def device_state(self):
        """(PhotonState, channel) of the packed hits on the device, or None
        once they were copied to the host."""
        return self._dev

    def _materialize(self):
        from chroma_tpu_torch.ops.propagate import photon_state_to_host
        sub, ch = self._dev
        host = photon_state_to_host(sub, channel=ch)[:self._n]
        for f in self._FIELDS:
            setattr(self, f, getattr(host, f))
        self._dev = None

    def __getattr__(self, name):
        # reached only when normal lookup fails: a field's first read
        if name in LazyHits._FIELDS and \
                self.__dict__.get('_dev') is not None:
            self._materialize()
            return getattr(self, name)
        raise AttributeError(name)

    def __len__(self):
        return self._n

    def __reduce__(self):
        if self.__dict__.get('_dev') is not None:
            self._materialize()
        return (event.Photons,
                tuple(getattr(self, f) for f in LazyHits._FIELDS))


def extract_flat_hits(state, geometry):
    """Detected photons as flat hits with channels: a count and front-pack
    on the device (one sync for the count), the detected lanes gathered
    there and kept there in a LazyHits until a field is read
    (reference: gpu/photon.py:141-209, count -> alloc -> copy)."""
    with profiler.region('daq.hits'):
        channel, perm, n_det = flat_hit_pack(state, geometry)
        n = int(n_det)
        sub, ch = gather_hits(state, channel, perm, n)
        return LazyHits(sub, ch, n)


def propagate_with_hits(state, geometry, seed, max_steps=100,
                        step_chunk='auto'):
    """Propagate a PhotonState (ops.propagate.propagate with `seed`) and
    extract its flat hits: (final PhotonState, LazyHits)."""
    from chroma_tpu_torch.ops.propagate import propagate
    result = propagate(state, geometry, seed, max_steps=max_steps,
                       step_chunk=step_chunk)
    return result, extract_flat_hits(result, geometry)


def photon_channels(photons_host, solid_id, solid_id_to_channel_index):
    """Channel index of each detected photon, -1 otherwise, on the host
    (host helper of flat-hit extraction; reference:
    propagate.cu:172-251)."""
    tri = photons_host.last_hit_triangles
    valid = tri > -1
    solid = solid_id[np.maximum(tri, 0)]
    channel = solid_id_to_channel_index[solid]
    detected = (valid & (channel >= 0)
                & ((photons_host.flags & np.uint32(SURFACE_DETECT)) != 0))
    return np.where(detected, channel, -1).astype(np.int32)
