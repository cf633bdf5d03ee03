"""The reference's PMT readout, worked out from a propagated event.

Chroma's DAQ: every photon that ended with SURFACE_DETECT on a channel's
triangle is kept with probability equal to its weight, its time smeared
by a draw from the detector's time distribution, its charge drawn from
the charge distribution and quantised; a channel reads its earliest time
and its summed charge. `ndaq` replicas read the same photons with draws
of their own. The draws are the program's: torch's generator seeded as
the program seeds event i of propagation batch b, (seed, b, 7000 + i)
through numpy's SeedSequence; the replicas in blocks of up to DAQ_BLOCK,
three (block, N) draws a block in the order keep, time, charge. The
distributions are Chroma's demo detector's truncated Gaussians, made
here again.
"""
from __future__ import annotations

import numpy as np
import torch

from bench_h100.reference.physics import SURFACE_DETECT

DAQ_SITE = 7000
DAQ_BLOCK = 8
MAX_TIME = 1e9
HIT_TIME_CUT = 1e8


def mix_seed(*parts):
    "A 63-bit generator seed from non-negative ints (SeedSequence)."
    state = np.random.SeedSequence([int(p) for p in parts]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def gaussian_cdf(mean, rms, lo, hi, nsamples=50):
    "(x, cdf) f32 of a Gaussian binned on [lo, hi], as Chroma bins it."
    x = np.linspace(lo, hi, nsamples + 1, endpoint=True)
    y = np.exp(-0.5 * ((x[1:] - mean) / rms) ** 2)
    cdf = np.concatenate([[0.0], np.cumsum(y)])
    cdf /= cdf[-1]
    return x.astype(np.float32), cdf.astype(np.float32)


def inverse_cdf(u, x, cdf):
    """Linear interpolation of u against the cdf, flat beyond its ends;
    the lerp rounded once from float64."""
    n = cdf.shape[0]
    i = torch.clamp(torch.searchsorted(cdf, u, right=True), 1, n - 1)
    x_lo, c_lo = x[i - 1], cdf[i - 1]
    dc = cdf[i] - c_lo
    tiny = float(np.spacing(np.finfo(np.float32).eps))
    flat = dc.abs() <= tiny
    q = (u - c_lo) / torch.where(flat, torch.ones_like(dc), dc)
    lerp = (x_lo.double() + q.double() * (x[i] - x_lo).double()).float()
    f = torch.where(flat, x_lo, lerp)
    f = torch.where(u < cdf[0], x[0], f)
    return torch.where(u > cdf[-1], x[-1], f)


def readout(channel, t, flags, n_channels, seed, batch, time_cdf,
            charge_cdf, dtype=torch.float32, ndaq=None):
    """(hit, time, charge) of one event, each (C,), or (ndaq, C) for
    `ndaq` replicas, and the charge unit. `channel` is each photon's
    channel (-1: none) as the reference works it out from the photon's
    last triangle; `t`, `flags` the photons' end states. `dtype` is the
    precision of the time and charge arithmetic."""
    dev = t.device
    n = t.shape[0]
    reps = 1 if ndaq is None else ndaq
    gen = torch.Generator(device=dev)
    gen.manual_seed(mix_seed(seed, batch, DAQ_SITE))
    nrep = min(reps, DAQ_BLOCK)
    blocks = [[1.0 - torch.rand((nrep, n), generator=gen, device=dev)
               for _ in range(3)] for _ in range(-(-reps // DAQ_BLOCK))]
    u_keep, u_time, u_charge = (torch.cat([b[k] for b in blocks])[:reps]
                                for k in range(3))
    detected = (channel >= 0) & ((flags & SURFACE_DETECT) != 0)
    keep = detected[None, :] & (u_keep < 1.0)
    tx, tc = (torch.as_tensor(a, device=dev) for a in time_cdf)
    qx, qc = (torch.as_tensor(a, device=dev) for a in charge_cdf)
    # the unit lives on the device, as the program's does: a division by
    # a host scalar rounds otherwise (it multiplies by the reciprocal)
    unit = torch.tensor(float(qx.max()) / 2 ** 16, dtype=torch.float32,
                        device=dev)
    jitter = inverse_cdf(u_time, tx, tc)
    time = (t.to(dtype)[None, :] + jitter.to(dtype)).float()
    charge = inverse_cdf(u_charge, qx, qc).to(dtype)
    counts = torch.round(charge / unit.to(dtype)).float()
    rows = torch.arange(reps, device=dev)[:, None] * (n_channels + 1)
    seg = (torch.where(keep, channel[None, :], n_channels) + rows).reshape(-1)
    size = reps * (n_channels + 1)
    earliest = torch.full((size,), MAX_TIME, device=dev)
    earliest.scatter_reduce_(0, seg, torch.where(keep, time, MAX_TIME)
                             .reshape(-1), reduce='amin')
    q = torch.zeros(size, dtype=torch.float64, device=dev)
    q.scatter_add_(0, seg, torch.where(keep, counts, 0.0).double()
                   .reshape(-1))
    earliest = earliest.reshape(reps, -1)[:, :-1]
    q = q.reshape(reps, -1)[:, :-1].float() * unit
    if ndaq is None:
        earliest, q = earliest[0], q[0]
    return earliest < HIT_TIME_CUT, earliest, q, float(unit)
