"""Hybrid-MC likelihood evaluation for event reconstruction
(reference: chroma/likelihood.py).

This restores a *working* likelihood path: the reference fork calls
Simulation.eval_pdf / setup_kernel / eval_kernel methods that no longer
exist there (SURVEY §4 drift); here chroma_tpu_torch.sim.Simulation
implements them against the device PDF estimators
(chroma_tpu_torch.ops.pdf)."""
from __future__ import annotations

from itertools import islice
from math import sqrt

import numpy as np

from chroma_tpu_torch.ufloat import ufloat
from chroma_tpu_torch.tools import count_nonzero  # noqa: F401 (API parity)


class Likelihood(object):
    "Evaluate event likelihoods against simulated PDFs."

    def __init__(self, sim, event=None, tbins=100, trange=(-0.5, 999.5),
                 qbins=10, qrange=(-0.5, 49.5), time_only=True):
        """
        sim: chroma_tpu_torch.sim.Simulation used to generate PDFs.
        event: the detector event being reconstructed (or use set_event).
        tbins/trange, qbins/qrange: PDF binning.
        time_only: use only hit times (not charge) in the PDF.
        """
        self.sim = sim
        self.tbins = tbins
        self.trange = trange
        self.qbins = qbins
        self.qrange = qrange
        self.time_only = time_only
        if event is not None:
            self.set_event(event)

    def set_event(self, event):
        "Set the detector event being reconstructed."
        self.event = event

    def eval_channel_vbin(self, vertex_generator, nevals, nreps=16,
                          ndaq=50):
        """Hit probability and PDF value (+uncertainty) per channel with
        the variable-bin-window method."""
        ntotal = nevals * nreps * ndaq
        vertex_generator = islice(vertex_generator, nevals)

        hitcount, pdf_prob, pdf_prob_uncert = self.sim.eval_pdf(
            self.event.channels, vertex_generator, 0.2, self.trange,
            1, self.qrange, nreps=nreps, ndaq=ndaq,
            time_only=self.time_only, min_bin_content=320)

        hit_prob = hitcount.astype(np.float32) / ntotal

        # zero/NaN PDF values get the uniform floor
        bad_value = (pdf_prob <= 0.0) | np.isnan(pdf_prob)
        pdf_floor = 1.0 / (self.trange[1] - self.trange[0])
        if not self.time_only:
            pdf_floor /= (self.qrange[1] - self.qrange[0])
        pdf_prob[bad_value] = pdf_floor
        pdf_prob_uncert[bad_value] = pdf_floor

        return hit_prob, pdf_prob, pdf_prob_uncert

    def eval(self, vertex_generator, nevals, nreps=16, ndaq=50):
        """Negative log likelihood that the event came from the given
        vertex generator. The returned ufloat carries the statistical
        uncertainty of the PDF term (sigma(log p) = sigma_p / p summed in
        quadrature over hit channels) — the reference computes
        pdf_prob_uncert but then discards it in its own eval
        (reference: likelihood.py:92-111, ufloat((..., 0.0)))."""
        ntotal = nevals * nreps * ndaq
        hit_prob, pdf_prob, pdf_prob_uncert = self.eval_channel_vbin(
            vertex_generator, nevals, nreps, ndaq)

        hit = self.event.channels.hit
        hit_prob = hit_prob.copy()
        hit_prob[~hit] = 1.0 - hit_prob[~hit]
        hit_prob = np.maximum(hit_prob, 0.5 / ntotal)

        log_likelihood = ufloat(np.log(hit_prob).sum(), 0.0)
        rel = pdf_prob_uncert[hit] / pdf_prob[hit]
        log_likelihood = log_likelihood + ufloat(
            np.log(pdf_prob[hit]).sum(),
            float(np.sqrt(np.sum(rel * rel))))
        return -log_likelihood

    def setup_kernel(self, vertex_generator, nevals, nreps, ndaq,
                     oversample_factor):
        "Accumulate KDE bandwidth statistics from an oversampled MC run."
        bandwidth_generator = islice(vertex_generator,
                                     nevals * oversample_factor)
        self.sim.setup_kernel(self.event.channels, bandwidth_generator,
                              self.trange, self.qrange, nreps=nreps,
                              ndaq=ndaq, time_only=self.time_only,
                              scale_factor=oversample_factor)

    def eval_kernel(self, vertex_generator, nevals, nreps=16, ndaq=50,
                    navg=10):
        "Negative log likelihood via the Gaussian-kernel PDF estimate."
        ntotal = nevals * nreps * ndaq
        mom0 = 0
        mom1 = 0.0
        mom2 = 0.0
        for _ in range(navg):
            kernel_generator = islice(vertex_generator, nevals)
            hitcount, pdf_prob, _ = self.sim.eval_kernel(
                self.event.channels, kernel_generator, self.trange,
                self.qrange, nreps=nreps, ndaq=ndaq,
                time_only=self.time_only)

            hit = self.event.channels.hit
            hit_prob = hitcount.astype(np.float32) / ntotal
            hit_prob[hit] = np.maximum(hit_prob[hit], 0.5 / ntotal)

            bad_value = (pdf_prob <= 0.0) | np.isnan(pdf_prob)
            pdf_floor = 1.0 / (self.trange[1] - self.trange[0])
            if not self.time_only:
                pdf_floor /= (self.qrange[1] - self.qrange[0])
            pdf_prob[bad_value] = pdf_floor

            log_likelihood = (np.log(hit_prob[hit]).sum()
                              + np.log(1.0 - hit_prob[~hit]).sum()
                              + np.log(pdf_prob[hit]).sum())
            if np.isfinite(log_likelihood):
                mom0 += 1
                mom1 += log_likelihood
                mom2 += log_likelihood ** 2

        avg_like = mom1 / mom0
        rms_like = sqrt(max(mom2 / mom0 - avg_like ** 2, 0.0))
        return ufloat(-avg_like, rms_like / sqrt(mom0))
