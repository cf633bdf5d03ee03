"""PMT DAQ and flat-hit extraction for the torch port (counterpart of
chroma_tpu.ops.daq).

Per channel: the earliest hit time is a scatter_reduce 'amin', the charge
a scatter_add of integer counts of charge_unit (so the order in which the
device adds them cannot change the sum), and the history an OR built from
a per-bit 'amax'.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chroma_tpu import event
from chroma_tpu.event import SURFACE_DETECT
from chroma_tpu_torch.ops.photon import i32
from chroma_tpu_torch.ops.sample import sample_cdf_pairs, uniform

MAX_TIME = 1e9      # "no hit" earliest-time sentinel
HIT_TIME_CUT = 1e8  # a channel is hit if its earliest time is below this
DAQ_BLOCK = 8       # replica rows materialised per block


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


def run_daq(photons, geometry, generator=None, ndaq=1, uniforms=None,
            global_weight=1.0, detection_state=SURFACE_DETECT):
    """One DAQ readout (or `ndaq` replicas) of a propagated PhotonState
    (reference: daq.cu run_daq / run_daq_many). A photon counts when it
    ended on a triangle of a channel with a `detection_state` flag bit,
    and is kept with probability weight * global_weight. Draws come from
    `generator`, or from `uniforms(block, site, shape)` -- U[0, 1) arrays,
    site 0 keep, 1 time, 2 charge -- when injected. Returns ChannelArrays
    with leading dimension ndaq*C, replica-major."""
    det = geometry.detector
    dev = photons.t.device
    n = len(photons)

    channel = photon_channels_device(photons, geometry, detection_state)
    detected = channel >= 0

    def draw(block, site, nrep):
        if uniforms is not None:
            return torch.from_numpy(np.array(
                uniforms(block, site, (nrep, n)), np.float32)).to(dev)
        return torch.rand((nrep, n), generator=generator, device=dev,
                          dtype=torch.float32)

    nrep = min(ndaq, DAQ_BLOCK)
    parts = []
    for b in range(-(-ndaq // DAQ_BLOCK)):
        u = [draw(b, s, nrep) for s in range(3)]
        parts.append(_daq_block(photons, det, *u, b * DAQ_BLOCK, ndaq,
                                global_weight, channel, detected))
    c = det.nchannels
    return ChannelArrays(
        earliest_time=torch.cat([p[0] for p in parts])[:ndaq * c],
        charge=torch.cat([p[1] for p in parts])[:ndaq * c],
        histories=torch.cat([p[2] for p in parts])[:ndaq * c])


def channels_to_host(channel_arrays, evidx=None):
    "ChannelArrays -> event.Channels."
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


def extract_flat_hits(state, geometry):
    """Detected photons as a host event.Photons with channels: device count
    and front-pack, then one transfer of the detected minority."""
    from chroma_tpu_torch.ops.propagate import photon_state_to_host
    channel, perm, n_det = flat_hit_pack(state, geometry)
    sel = perm[:int(n_det)]
    sub = state.map(lambda a: a[sel])
    return photon_state_to_host(
        sub, channel=channel[sel].cpu().numpy().astype(np.uint32))
