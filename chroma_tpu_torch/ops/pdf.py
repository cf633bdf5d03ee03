"""PDF estimation for hybrid-MC likelihood evaluation in the torch port
(counterpart of chroma_tpu.ops.pdf), on tensors on the simulation's device:

  * PDFAccumulator -- binned (channel, t, q) histogram;
  * PDFEval -- per-channel PDF value at the observed hit with adaptive bin
    widening, from the K nearest MC times (a top-K merge: a sort of the
    concatenation, as in the JAX package);
  * KernelPDF -- Gaussian KDE with per-channel bandwidths from accumulated
    moments.

Counts accumulate in int64: CUDA torch has no u32 scatter-add; get()
returns the reference's u32 arrays. The host-side get* stay numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from chroma_tpu_torch.ops.daq import MAX_TIME

INV_ROOT2 = 0.70710678118654746
ROOT_PI_BY_2 = 1.2533141373155001


def _per_replica(channel_arrays, nchannels):
    "View ChannelArrays fields as (ndaq, C)."
    t = channel_arrays.earliest_time.reshape(-1, nchannels)
    q = channel_arrays.charge.reshape(-1, nchannels)
    return t, q


def _device_of(geometry):
    return geometry.detector.solid_id_to_channel_index.device


class PDFAccumulator:
    """Binned 3D (channel, t, q) PDF (reference: pdf.cu bin_hits,
    gpu/pdf.py:182-227)."""

    def __init__(self, geometry, tbins, trange, qbins, qrange):
        self.nchannels = geometry.detector.nchannels
        self.tbins, self.trange = tbins, trange
        self.qbins, self.qrange = qbins, qrange
        dev = _device_of(geometry)
        self.hitcount = torch.zeros(self.nchannels, dtype=torch.int64,
                                    device=dev)
        self.pdf = torch.zeros(self.nchannels * tbins * qbins,
                               dtype=torch.int64, device=dev)
        self.events_in_histogram = 0

    def clear(self):
        self.hitcount.zero_()
        self.pdf.zero_()
        self.events_in_histogram = 0

    def add(self, channel_arrays, ndaq=1):
        t, q = _per_replica(channel_arrays, self.nchannels)
        tmin, tmax = self.trange
        qmin, qmax = self.qrange
        ok = ((t < 1e8) & (t >= tmin) & (t < tmax)
              & (q >= qmin) & (q < qmax))
        self.hitcount += ok.sum(dim=0)

        tbin = ((t - tmin) / (tmax - tmin) * self.tbins).to(torch.int32)
        qbin = ((q - qmin) / (qmax - qmin) * self.qbins).to(torch.int32)
        chan = torch.arange(self.nchannels, dtype=torch.int32,
                            device=t.device)[None, :]
        flat_bin = (chan * (self.tbins * self.qbins)
                    + tbin * self.qbins + qbin)
        flat_bin = torch.where(ok, flat_bin, 0).reshape(-1)
        self.pdf.scatter_add_(0, flat_bin.to(torch.int64),
                              ok.reshape(-1).to(torch.int64))
        self.events_in_histogram += ndaq

    def get(self):
        "(hitcount (C,), pdf (C, tbins, qbins)) as u32 numpy arrays."
        return (self.hitcount.cpu().numpy().astype(np.uint32),
                self.pdf.cpu().numpy().astype(np.uint32).reshape(
                    self.nchannels, self.tbins, self.qbins))


class PDFEval:
    """Adaptive-bin PDF value at each channel's observed hit (reference:
    gpu/pdf.py:229-372); the time-PDF mode, like the reference."""

    def __init__(self, geometry, event_channels, min_twidth, trange,
                 min_qwidth, qrange, min_bin_content=100, time_only=True):
        if not time_only:
            raise ValueError('only the time-PDF mode is implemented')
        self.nchannels = geometry.detector.nchannels
        self.event_hit = np.asarray(event_channels.hit).astype(bool)
        self.event_time = np.asarray(event_channels.t, dtype=np.float32)
        self.min_twidth = min_twidth
        self.trange = trange
        self.min_bin_content = min_bin_content
        self.time_only = time_only

        self.hit_channels = np.flatnonzero(self.event_hit)
        self.event_nhit = len(self.hit_channels)

        dev = _device_of(geometry)
        self.hitcount = torch.zeros(self.nchannels, dtype=torch.int32,
                                    device=dev)
        self.bincount = torch.zeros(self.nchannels, dtype=torch.int32,
                                    device=dev)
        # K smallest |t_mc - t_obs| per observed-hit channel, ascending
        self.nearest_mc = torch.full((self.event_nhit, min_bin_content),
                                     MAX_TIME, dtype=torch.float32,
                                     device=dev)
        self._obs_t = torch.from_numpy(self.event_time).to(dev)
        self._hit_idx = torch.from_numpy(
            self.hit_channels.astype(np.int64)).to(dev)
        self._hit_mask = torch.from_numpy(self.event_hit).to(dev)

    def clear(self):
        self.hitcount.zero_()
        self.bincount.zero_()
        self.nearest_mc.fill_(MAX_TIME)

    def accumulate(self, channel_arrays, ndaq=1):
        t, _ = _per_replica(channel_arrays, self.nchannels)
        tmin, tmax = self.trange

        in_pdf = (t < 1e8) & (t >= tmin) & (t <= tmax)   # (ndaq, C)
        self.hitcount += in_pdf.sum(dim=0, dtype=torch.int32)

        dist = torch.abs(t - self._obs_t[None, :])
        close = in_pdf & (dist < self.min_twidth / 2.0) \
            & self._hit_mask[None, :]
        self.bincount += close.sum(dim=0, dtype=torch.int32)

        # merge the new distances into the per-hit-channel top-K tables
        d_hit = torch.where(in_pdf[:, self._hit_idx],
                            dist[:, self._hit_idx], MAX_TIME).T
        merged = torch.cat([self.nearest_mc, d_hit], dim=1)
        self.nearest_mc = torch.sort(merged, dim=1).values[
            :, :self.min_bin_content].contiguous()

    def get(self):
        """(hitcount, pdf_value, pdf_uncertainty) per channel (reference:
        gpu/pdf.py get_pdf_eval)."""
        hitcount = self.hitcount.cpu().numpy()
        bincount = self.bincount.cpu().numpy()
        nearest_dev = self.nearest_mc.cpu().numpy()
        evhit = self.event_hit

        pdf_value = np.zeros(len(hitcount), dtype=float)
        pdf_frac_uncert = np.zeros_like(pdf_value)

        high_stats = bincount >= self.min_bin_content
        if high_stats.any():
            pdf_value[high_stats] = (bincount[high_stats].astype(float)
                                     / hitcount[high_stats]
                                     / self.min_twidth)
            pdf_frac_uncert[high_stats] = 1.0 / np.sqrt(bincount[high_stats])

        low_stats = ~high_stats & (hitcount > 0) & evhit

        nearest_mc = np.full((len(hitcount), self.min_bin_content), 1e9,
                             dtype=np.float32)
        nearest_mc[self.hit_channels, :] = nearest_dev

        last_valid = np.maximum(
            0, (nearest_mc < 1e9).astype(int).sum(axis=1) - 1)
        distance = nearest_mc[np.arange(len(last_valid)), last_valid]
        if low_stats.any():
            pdf_value[low_stats] = ((last_valid[low_stats] + 1).astype(float)
                                    / hitcount[low_stats]
                                    / distance[low_stats] / 2.0)
            pdf_frac_uncert[low_stats] = 1.0 / np.sqrt(
                last_valid[low_stats] + 1)

        return hitcount, pdf_value, pdf_value * pdf_frac_uncert


class KernelPDF:
    """Gaussian kernel density PDF with per-channel bandwidths estimated
    from accumulated MC moments (reference: gpu/pdf.py:7-175)."""

    def __init__(self, geometry, trange, qrange, time_only=True):
        self.nchannels = geometry.detector.nchannels
        self.device = _device_of(geometry)
        self.trange, self.qrange = trange, qrange
        self.time_only = time_only
        self.clear_moments()

    def _zeros(self, dtype=torch.float32):
        return torch.zeros(self.nchannels, dtype=dtype, device=self.device)

    def clear_moments(self):
        self.mom0 = self._zeros(torch.int32)
        self.t_mom1 = self._zeros()
        self.t_mom2 = self._zeros()
        self.q_mom1 = self._zeros()
        self.q_mom2 = self._zeros()

    def _in_window(self, t, q):
        tmin, tmax = self.trange
        ok = (t >= tmin) & (t <= tmax)
        if not self.time_only:
            qmin, qmax = self.qrange
            ok &= (q >= qmin) & (q <= qmax)
        return ok

    def accumulate_moments(self, channel_arrays):
        t, q = _per_replica(channel_arrays, self.nchannels)
        ok = self._in_window(t, q)
        self.mom0 += ok.sum(dim=0, dtype=torch.int32)
        tt = torch.where(ok, t, 0.0)
        self.t_mom1 += tt.sum(dim=0)
        self.t_mom2 += (tt * tt).sum(dim=0)
        qq = torch.where(ok, q, 0.0)
        self.q_mom1 += qq.sum(dim=0)
        self.q_mom2 += (qq * qq).sum(dim=0)

    def compute_bandwidth(self, event_hit, event_time, event_charge,
                          scale_factor=1.0):
        """Per-channel KDE bandwidths via the localized Silverman-style
        rule of the reference (gpu/pdf.py:61-112), on the host."""
        rho = 1.0
        mom0 = np.maximum(self.mom0.cpu().numpy(), 1)
        tmean = self.t_mom1.cpu().numpy() / mom0
        tvar = np.maximum(self.t_mom2.cpu().numpy() / mom0 - tmean ** 2, 0.0)
        trms = np.sqrt(tvar)

        d = 1 if self.time_only else 2
        dim_factor = ((4.0 / (d + 2)) / (mom0 / scale_factor)) \
            ** (-1.0 / (d + 4))
        with np.errstate(divide='ignore', invalid='ignore'):
            gaussian_density = np.minimum(
                1.0 / trms,
                (1.0 / np.sqrt(2.0 * np.pi))
                * np.exp(-0.5 * ((event_time - tmean) / trms)) / trms)
            time_bandwidths = dim_factor / gaussian_density * rho
        inv_tb = np.zeros_like(time_bandwidths)
        good = time_bandwidths > 0
        inv_tb[good] = 1.0 / time_bandwidths[good]
        inv_tb[~np.isfinite(inv_tb)] = 0.0
        self.inv_time_bandwidths = torch.from_numpy(
            inv_tb.astype(np.float32)).to(self.device)

        if self.time_only:
            self.inv_charge_bandwidths = torch.zeros_like(
                self.inv_time_bandwidths)
        else:
            qmean = self.q_mom1.cpu().numpy() / mom0
            qrms = np.sqrt(np.maximum(
                self.q_mom2.cpu().numpy() / mom0 - qmean ** 2, 0.0))
            with np.errstate(divide='ignore', invalid='ignore'):
                gaussian_density = np.minimum(
                    1.0 / qrms,
                    (1.0 / np.sqrt(2.0 * np.pi))
                    * np.exp(-0.5 * ((event_charge - qmean) / qrms)) / qrms)
                charge_bandwidths = dim_factor / gaussian_density * rho
                inv_qb = 1.0 / charge_bandwidths
            inv_qb[~np.isfinite(inv_qb)] = 0.0
            self.inv_charge_bandwidths = torch.from_numpy(
                inv_qb.astype(np.float32)).to(self.device)

    def clear_kernel(self):
        self.hitcount = self._zeros(torch.int32)
        self.time_pdf_values = self._zeros()
        self.charge_pdf_values = self._zeros()

    def setup_kernel(self, event_hit, event_time, event_charge):
        def t(a, dtype):
            return torch.from_numpy(np.asarray(a).astype(dtype)).to(
                self.device)
        self.event_hit = t(event_hit, bool)
        self.event_time = t(event_time, np.float32)
        self.event_charge = t(event_charge, np.float32)
        self.clear_kernel()

    def _kde_term(self, mc, obs, inv_bw, vmin, vmax):
        inv_bw = inv_bw[None, :]
        arg = (mc - obs[None, :]) * inv_bw
        term = torch.exp(-0.5 * arg * arg) * inv_bw
        # normalize the Gaussian within the PDF window
        loarg = (vmin - mc) * inv_bw * INV_ROOT2
        hiarg = (vmax - mc) * inv_bw * INV_ROOT2
        erf_norm = (torch.special.erf(hiarg)
                    - torch.special.erf(loarg)) * ROOT_PI_BY_2
        norm = torch.where(inv_bw > 0.0, erf_norm, vmax - vmin)
        return term / norm

    def accumulate_kernel(self, channel_arrays):
        t, q = _per_replica(channel_arrays, self.nchannels)
        ok = self._in_window(t, q)
        self.hitcount += ok.sum(dim=0, dtype=torch.int32)

        contrib = ok & self.event_hit[None, :]
        tmin, tmax = self.trange
        t_term = self._kde_term(t, self.event_time,
                                self.inv_time_bandwidths, tmin, tmax)
        self.time_pdf_values += torch.where(contrib, t_term, 0.0).sum(dim=0)
        if not self.time_only:
            qmin, qmax = self.qrange
            q_term = self._kde_term(q, self.event_charge,
                                    self.inv_charge_bandwidths, qmin, qmax)
            self.charge_pdf_values += torch.where(contrib, q_term,
                                                  0.0).sum(dim=0)

    def get_kernel_eval(self):
        hitcount = self.hitcount.cpu().numpy()
        denom = np.maximum(1, hitcount)
        time_pdf_values = self.time_pdf_values.cpu().numpy() / denom
        charge_pdf_values = self.charge_pdf_values.cpu().numpy() / denom
        if self.time_only:
            pdf_values = time_pdf_values
        else:
            pdf_values = time_pdf_values * charge_pdf_values
        return hitcount, pdf_values, np.zeros_like(pdf_values)
