"""Simulation: the top-level facade of the torch port (counterpart of
chroma_tpu.sim.Simulation).

Owns the device geometry, batches incoming events to photons_per_batch,
propagates each batch, extracts flat hits with channels and runs the DAQ,
and yields the shared chroma_tpu.event.Event objects. It also serves the
PDF API that chroma_tpu.likelihood.Likelihood drives (create_pdf,
eval_pdf, setup_kernel, eval_kernel). Every random stream comes from a
torch.Generator seeded from (seed, propagation counter, ...): each
simulate batch and each PDF-path propagation takes the next count.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from chroma_tpu import event, itertoolset
from chroma_tpu.detector import Detector
from chroma_tpu.geometry import Geometry, Mesh, Solid, vacuum
from chroma_tpu_torch.ops import daq as daq_ops
from chroma_tpu_torch.ops import pdf as pdf_ops
from chroma_tpu_torch.ops.photon import PhotonState
from chroma_tpu_torch.ops.propagate import (propagate,
                                            photon_state_from_host,
                                            photon_state_to_host)
from chroma_tpu_torch.ops.sample import make_generator
from chroma_tpu_torch.ops.types import build_geometry_arrays

DAQ_SITE = 7000  # generator id of event i's DAQ draws: (seed, batch, 7000+i)
PDF_MAX_STEPS = 100  # steps of each PDF-path propagation, as in chroma_tpu


def pick_seed():
    "Seed from a mix of current time and process ID (reference: sim.py)."
    return (int(time.time()) ^ (os.getpid() << 16)) & (2 ** 32 - 1)


def _as_geometry(obj):
    """A flattened Geometry from a Detector/Geometry/Solid/Mesh or a
    callable returning one (chroma_tpu.loader.create_geometry_from_obj
    without the classic BVH, which the port does not use)."""
    if callable(obj):
        obj = obj()
    if isinstance(obj, (Detector, Geometry)):
        geometry = obj
    elif isinstance(obj, Solid):
        geometry = Geometry()
        geometry.add_solid(obj)
    elif isinstance(obj, Mesh):
        geometry = Geometry()
        geometry.add_solid(Solid(obj, vacuum, vacuum, color=0x33ffffff))
    else:
        raise TypeError('cannot build type %s' % type(obj))
    if not hasattr(geometry, 'mesh'):
        geometry.flatten()
    return geometry


class Simulation:
    def __init__(self, detector, seed=None, device='cuda', wavelengths=None,
                 times=None, step_chunk='auto', geometry_arrays=None):
        """Create a simulation around a Geometry/Detector on `device`.

        geometry_arrays: prebuilt chroma_tpu_torch GeometryArrays (e.g.
        ops.types.from_jax_arrays of a JAX build), which skips the host
        build. Raises RuntimeError for a CUDA device when none is
        present."""
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('device %r requested but CUDA is not '
                               'available' % str(device))
        if geometry_arrays is None:
            self.detector = _as_geometry(detector)
            geometry_arrays = build_geometry_arrays(self.detector,
                                                    wavelengths, times)
        else:
            self.detector = detector
        self.gpu_geometry = geometry_arrays.to(self.device)
        self.seed = pick_seed() if seed is None else int(seed)
        self.step_chunk = step_chunk
        self._batch = 0
        self._kernel = None
        self._pdf = None

    def _next_seed(self):
        "(seed, counter) of the next propagation's random streams."
        batch_seed = (self.seed, self._batch)
        self._batch += 1
        return batch_seed

    @property
    def has_channels(self):
        return self.gpu_geometry.detector is not None

    def simulate(self, iterable, keep_photons_beg=False,
                 keep_photons_end=False, keep_hits=True, keep_flat_hits=True,
                 run_daq=False, max_steps=1000, photons_per_batch=1000000):
        """Simulate an iterable of Photons, Events or Vertices, yielding
        finished Events. Events are grouped into >= photons_per_batch
        batches (reference: sim.py:225-278)."""
        if isinstance(iterable, event.Photons):
            first_element, iterable = iterable, [iterable]
        else:
            first_element, iterable = itertoolset.peek(iterable)

        if isinstance(first_element, event.Photons):
            iterable = (event.Event(photons_beg=x) for x in iterable)
        elif isinstance(first_element, event.Vertex):
            from chroma_tpu.generator import vertex_gun_to_events
            iterable = vertex_gun_to_events(iterable)

        opts = dict(keep_photons_beg=keep_photons_beg,
                    keep_photons_end=keep_photons_end, keep_hits=keep_hits,
                    keep_flat_hits=keep_flat_hits, run_daq=run_daq,
                    max_steps=max_steps)
        nphotons = 0
        batch_events = []
        for ev in iterable:
            ev.nphotons = len(ev.photons_beg)
            ev.photons_beg.evidx[:] = np.uint32(len(batch_events))
            nphotons += ev.nphotons
            batch_events.append(ev)
            if nphotons >= photons_per_batch:
                yield from self._simulate_batch(batch_events, **opts)
                nphotons = 0
                batch_events = []
        if batch_events:
            yield from self._simulate_batch(batch_events, **opts)

    def _simulate_batch(self, batch_events, keep_photons_beg, keep_photons_end,
                        keep_hits, keep_flat_hits, run_daq, max_steps):
        "Propagate one batch of events and attach results."
        sources = [ev.photons_beg for ev in batch_events]
        bounds = np.cumsum([0] + [len(src) for src in sources])
        batch = event.Photons.join(sources) if len(sources) > 1 \
            else sources[0]
        state = photon_state_from_host(batch, self.device)
        batch_seed = self._next_seed()

        result = propagate(state, self.gpu_geometry, batch_seed,
                           max_steps=max_steps, step_chunk=self.step_chunk)

        want_hits = self.has_channels and (keep_hits or keep_flat_hits)
        batch_hits = daq_ops.extract_flat_hits(result, self.gpu_geometry) \
            if want_hits else None
        photons_end = None
        if keep_photons_end:
            channel = None
            if self.has_channels:
                channel = np.maximum(daq_ops.photon_channels_device(
                    result, self.gpu_geometry).cpu().numpy(),
                    0).astype(np.uint32)
            photons_end = photon_state_to_host(result, channel=channel)

        for i, ev in enumerate(batch_events):
            start, end = int(bounds[i]), int(bounds[i + 1])
            if not keep_photons_beg:
                ev.photons_beg = None
            if keep_photons_end:
                ev.photons_end = photons_end[start:end]
            if want_hits:
                ev_hits = batch_hits if len(batch_events) == 1 \
                    else batch_hits[batch_hits.evidx == i]
                if keep_hits:
                    order = np.argsort(ev_hits.channel, kind='stable')
                    sh = ev_hits[order]
                    chans, starts = np.unique(sh.channel, return_index=True)
                    ends = np.r_[starts[1:], len(sh.channel)]
                    ev.hits = {int(c): sh[s:e]
                               for c, s, e in zip(chans, starts, ends)}
                if keep_flat_hits:
                    ev.flat_hits = ev_hits
            if self.has_channels and run_daq:
                ev_state = result.map(lambda a: a[start:end])
                gen = make_generator(self.device, *batch_seed,
                                     DAQ_SITE + i)
                arrays = daq_ops.run_daq(ev_state, self.gpu_geometry, gen)
                ev.channels = daq_ops.channels_to_host(arrays)
            yield ev

    # ------------------------------------------------------------------
    # PDF evaluation API (used by chroma_tpu.likelihood)
    # ------------------------------------------------------------------

    def create_pdf(self, iterable, tbins, trange, qbins, qrange,
                   nreps=1, ndaq=1):
        """Histogram the DAQ response of many events into a binned
        (channel, t, q) PDF. Returns (hitcount, pdf) u32 numpy arrays."""
        accum = pdf_ops.PDFAccumulator(self.gpu_geometry, tbins, trange,
                                       qbins, qrange)
        for ev in iterable:
            state0 = self._source_state(ev.photons_beg)
            for _ in range(nreps):
                accum.add(self._propagate_daq(state0, ndaq), ndaq=ndaq)
        return accum.get()

    def setup_pdf_eval(self, event_hits, min_twidth, trange, min_qwidth,
                       qrange, min_bin_content=100, time_only=True):
        """Prepare likelihood PDF evaluation against an observed event
        (reference API: gpu/pdf.py:229-283)."""
        self._pdf = pdf_ops.PDFEval(self.gpu_geometry, event_hits,
                                    min_twidth, trange, min_qwidth, qrange,
                                    min_bin_content, time_only)

    def eval_pdf(self, event_channels, iterable, min_twidth, trange,
                 min_qwidth, qrange, min_bin_content=100, nreps=1, ndaq=1,
                 time_only=True):
        """Probability of each channel's observed hit given simulated
        events: (hitcount, pdf_value, pdf_uncertainty) per channel."""
        self.setup_pdf_eval(event_channels, min_twidth, trange, min_qwidth,
                            qrange, min_bin_content=min_bin_content,
                            time_only=time_only)
        for ev in iterable:
            state0 = self._source_state(ev.photons_beg)
            for _ in range(nreps):
                self._pdf.accumulate(self._propagate_daq(state0, ndaq),
                                     ndaq=ndaq)
        return self._pdf.get()

    def setup_kernel(self, event_channels, bandwidth_iterable, trange,
                     qrange, nreps=1, ndaq=1, time_only=True,
                     scale_factor=1.0):
        """Accumulate moments from an oversampled MC run and derive the
        per-channel KDE bandwidths (reference API: gpu/pdf.py:13-112)."""
        self._kernel = pdf_ops.KernelPDF(self.gpu_geometry, trange, qrange,
                                         time_only=time_only)
        for ev in bandwidth_iterable:
            for _ in range(nreps):
                self._kernel.accumulate_moments(self._run_daq_once(ev,
                                                                   ndaq))
        hit = np.asarray(event_channels.hit).astype(bool)
        t = np.asarray(event_channels.t, dtype=np.float32)
        q = np.asarray(event_channels.q, dtype=np.float32)
        self._kernel.compute_bandwidth(hit, t, q, scale_factor=scale_factor)
        self._kernel.setup_kernel(hit, t, q)

    def eval_kernel(self, event_channels, kernel_iterable, trange, qrange,
                    nreps=1, ndaq=1, time_only=True):
        """Per-channel KDE PDF values at the observed hits; needs a prior
        setup_kernel() call."""
        if self._kernel is None:
            raise RuntimeError('call setup_kernel() first')
        self._kernel.clear_kernel()
        for ev in kernel_iterable:
            for _ in range(nreps):
                self._kernel.accumulate_kernel(self._run_daq_once(ev, ndaq))
        return self._kernel.get_kernel_eval()

    def _source_state(self, photons):
        """An event's photons on the device: uploaded once, so the nreps
        propagations of a likelihood loop reuse them (a PhotonState passes
        through)."""
        if isinstance(photons, PhotonState):
            return photons
        return photon_state_from_host(photons, self.device)

    def _propagate_daq(self, state, ndaq):
        """Propagate a device PhotonState (not modified) with the next
        seed, then run the DAQ (ndaq replicas) on its own generator."""
        seed = self._next_seed()
        result = propagate(state, self.gpu_geometry, seed,
                           max_steps=PDF_MAX_STEPS,
                           step_chunk=self.step_chunk)
        gen = make_generator(self.device, *seed, DAQ_SITE)
        return daq_ops.run_daq(result, self.gpu_geometry, gen, ndaq=ndaq)

    def _run_daq_once(self, ev, ndaq):
        "Propagate one event's photons and run the DAQ (ndaq replicas)."
        return self._propagate_daq(self._source_state(ev.photons_beg), ndaq)
