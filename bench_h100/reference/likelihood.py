"""The reference's likelihood of an observed event: Chroma's hybrid
Monte Carlo with the variable-bin-window PDF, worked out again from the
DAQ samples of the simulated events.

For each channel: the share of samples with a time inside the PDF's
range (its hit probability), and at the observed hit time the PDF's
value: the samples within half of `min_twidth` of it over the hit count
and the window, or, with fewer than `min_bin_content` of them, the
window widened to the `min_bin_content`-th nearest sample. A PDF value
that is not positive reads as a flat one over the range. The negative
log likelihood sums log hit probabilities (of no hit where the observed
channel has none, floored at half a sample) and log PDF values of the
hit channels.
"""
from __future__ import annotations

import math

import torch

HIT_TIME_CUT = 1e8


def nll(obs_hit, obs_t, samples_t, ntotal, min_twidth, trange,
        min_bin_content, dtype=torch.float64):
    """The negative log likelihood of the observed event (obs_hit (C,)
    bool, obs_t (C,)) under the DAQ samples `samples_t` (S, C) of earliest
    times (float32); `ntotal` samples expected. `dtype` is the precision
    of the arithmetic after the samples are counted."""
    tmin, tmax = trange
    t = samples_t
    obs_t = obs_t.to(t.dtype)
    in_pdf = (t < HIT_TIME_CUT) & (t >= tmin) & (t <= tmax)
    hitcount = in_pdf.sum(0)
    dist = (t - obs_t[None, :]).abs()
    close = in_pdf & (dist < min_twidth / 2.0) & obs_hit[None, :]
    bincount = close.sum(0)
    pdf = torch.zeros(t.shape[1], dtype=dtype, device=t.device)
    high = bincount >= min_bin_content
    pdf[high] = (bincount[high].to(dtype) / hitcount[high].to(dtype)
                 / min_twidth)
    hit_idx = torch.nonzero(obs_hit)[:, 0]
    d_hit = torch.where(in_pdf[:, hit_idx], dist[:, hit_idx].to(dtype),
                        math.inf).T
    k = min(min_bin_content, d_hit.shape[1])
    nearest = torch.sort(d_hit, dim=1).values[:, :k]
    found = torch.isfinite(nearest).sum(1)
    widest = nearest.gather(1, torch.clamp(found - 1, min=0)[:, None])[:, 0]
    low = ~high[hit_idx] & (hitcount[hit_idx] > 0)
    pdf_low = found.to(dtype) / hitcount[hit_idx].to(dtype) / widest / 2.0
    pdf[hit_idx[low]] = pdf_low[low]
    floor = 1.0 / (tmax - tmin)
    pdf = torch.where((pdf <= 0) | torch.isnan(pdf), floor, pdf)
    hit_prob = hitcount.to(dtype) / ntotal
    hit_prob = torch.where(obs_hit, hit_prob, 1.0 - hit_prob)
    hit_prob = torch.clamp(hit_prob, min=0.5 / ntotal)
    return -float(torch.log(hit_prob).sum().double()
                  + torch.log(pdf[obs_hit]).sum().double())
