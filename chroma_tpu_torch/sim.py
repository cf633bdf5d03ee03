"""Simulation: the top-level facade of the torch port (counterpart of
chroma_tpu.sim.Simulation).

Owns the device geometry, batches incoming events to photons_per_batch,
propagates each batch, extracts flat hits with channels and runs the DAQ,
and yields the port's own chroma_tpu_torch.event.Event objects. Sources
are host Photons, Vertices, Events, or device-resident PhotonStates, which
stay on the device from start to end. With photon_tracking=True every
step is a chunk and each event gets its photons' tracks. It also serves
the PDF API that chroma_tpu_torch.likelihood.Likelihood drives
(create_pdf, eval_pdf, setup_kernel, eval_kernel). Every random stream
comes from a torch.Generator seeded from (seed, propagation counter, ...):
each simulate batch and each PDF-path propagation takes the next count.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from chroma_tpu_torch import event, itertoolset
from chroma_tpu_torch.loader import as_flat_geometry, create_geometry_from_obj
from chroma_tpu_torch.log import logger
from chroma_tpu_torch.ops import daq as daq_ops
from chroma_tpu_torch.ops import pdf as pdf_ops
from chroma_tpu_torch.ops.photon import PhotonState
from chroma_tpu_torch.ops.propagate import (propagate,
                                            photon_state_from_host,
                                            photon_state_to_host)
from chroma_tpu_torch.ops.sample import make_generator
from chroma_tpu_torch.ops.types import build_geometry_arrays
from chroma_tpu_torch.profiler import profiler

DAQ_SITE = 7000  # generator id of event i's DAQ draws: (seed, batch, 7000+i)
PDF_MAX_STEPS = 100  # steps of each PDF-path propagation, as in chroma_tpu


def pick_seed():
    "Seed from a mix of current time and process ID (reference: sim.py)."
    return (int(time.time()) ^ (os.getpid() << 16)) & (2 ** 32 - 1)


class Simulation:
    def __init__(self, detector, seed=None, photon_tracking=False,
                 wavelengths=None, times=None, mesh=None, n_devices=None,
                 device=None, gpu_geometry=None, geometry_arrays=None,
                 step_chunk='auto', **compat_kwargs):
        """Create a simulation around a Geometry/Detector on `device`
        (default 'cuda', or the mesh's device).

        gpu_geometry (chroma_tpu.Simulation's name) or geometry_arrays:
        prebuilt chroma_tpu_torch GeometryArrays (from the geocache, or
        ops.types.from_jax_arrays of a JAX build), which skips the host
        build. Without them, `detector` (a Detector, Geometry, Solid, Mesh
        or a callable returning one) is flattened, and if it has no classic
        BVH it gets the one loader.create_geometry_from_obj loads or builds
        (through the port's cache), when `Simulation.detector` is first
        read: the device path never reads it. step_chunk: steps per chunk
        between compactions ('auto' or an int) of the chunked driver,
        which tracking takes (ops.propagate: other propagations take the
        fused route unless CHROMA_FUSED=0). photon_tracking: record
        every photon's state after every step in Event.photon_tracks. The
        reference-only options (cuda_device, nthreads_per_block,
        max_blocks) are absorbed in compat_kwargs so call sites port
        unchanged.

        mesh (a parallel.PhotonMesh) / n_devices (parallel.photon_mesh's
        argument): propagate sharded over the ranks of a torch.distributed
        process group (chroma_tpu_torch.parallel), the geometry replicated;
        every rank makes the Simulation and calls simulate with the same
        events, and gets the same events back. Batches that do not divide
        the mesh are padded with dead lanes. Outside a process group this
        raises. Raises RuntimeError for a CUDA device when none is
        present."""
        if mesh is None and n_devices is not None:
            from chroma_tpu_torch.parallel import photon_mesh
            mesh = photon_mesh(n_devices, device=device)
        if mesh is not None and device is not None:
            want = torch.device(device)
            if want.type != mesh.device.type or \
                    want.index not in (None, mesh.device.index):
                raise ValueError('device %r is not the mesh\'s device %s'
                                 % (str(device), mesh.device))
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else torch.device(device or 'cuda')
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('device %r requested but CUDA is not '
                               'available' % str(self.device))
        if geometry_arrays is None:
            geometry_arrays = gpu_geometry
        self.step_chunk = step_chunk
        self._bvh_wanted = geometry_arrays is None
        if geometry_arrays is None:
            detector = as_flat_geometry(detector)
            geometry_arrays = build_geometry_arrays(detector, wavelengths,
                                                    times)
        self._detector = detector
        self.gpu_geometry = geometry_arrays.to(self.device)
        self.photon_tracking = photon_tracking
        self.seed = pick_seed() if seed is None else int(seed)
        np.random.seed(self.seed)
        self._batch = 0
        self._kernel = None
        self._pdf = None

    @property
    def detector(self):
        "The geometry simulated, with its classic BVH (see __init__)."
        if self._bvh_wanted:
            self._bvh_wanted = False
            self._detector = create_geometry_from_obj(self._detector)
        return self._detector

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
        """Simulate an iterable of Photons, PhotonStates, Events or
        Vertices, yielding finished Events. Events are grouped into >=
        photons_per_batch batches (reference: sim.py:225-278)."""
        if isinstance(iterable, (event.Photons, PhotonState)):
            first_element, iterable = iterable, [iterable]
        else:
            first_element, iterable = itertoolset.peek(iterable)

        if isinstance(first_element, (event.Photons, PhotonState)):
            # PhotonState inputs stay device-resident end to end
            iterable = (event.Event(photons_beg=x) for x in iterable)
        elif isinstance(first_element, event.Vertex):
            from chroma_tpu_torch.generator import vertex_gun_to_events
            iterable = vertex_gun_to_events(iterable)

        opts = dict(keep_photons_beg=keep_photons_beg,
                    keep_photons_end=keep_photons_end, keep_hits=keep_hits,
                    keep_flat_hits=keep_flat_hits, run_daq=run_daq,
                    max_steps=max_steps)
        nphotons = 0
        batch_events = []
        for ev in iterable:
            ev.nphotons = len(ev.photons_beg)
            if isinstance(ev.photons_beg, event.Photons):
                ev.photons_beg.evidx[:] = np.uint32(len(batch_events))
            nphotons += ev.nphotons
            batch_events.append(ev)
            if nphotons >= photons_per_batch:
                yield from self._simulate_batch(batch_events, **opts)
                nphotons = 0
                batch_events = []
        if batch_events:
            yield from self._simulate_batch(batch_events, **opts)

    def _batch_state(self, sources):
        """One device PhotonState of a batch's sources. Host Photons are
        joined on the host and uploaded once; when any source is a
        PhotonState, each source's lanes get its event index and the batch
        is joined on the device (a single source keeps its evidx)."""
        if not any(isinstance(src, PhotonState) for src in sources):
            batch = event.Photons.join(sources) if len(sources) > 1 \
                else sources[0]
            return photon_state_from_host(batch, self.device)
        from chroma_tpu_torch.gpu import join_states
        states = [self._source_state(src) for src in sources]
        if len(states) > 1:
            return join_states([st.replace(evidx=torch.full_like(st.evidx, i))
                                for i, st in enumerate(states)])
        return states[0]

    def _simulate_batch(self, batch_events, keep_photons_beg, keep_photons_end,
                        keep_hits, keep_flat_hits, run_daq, max_steps):
        "Propagate one batch of events and attach results."
        sources = [ev.photons_beg for ev in batch_events]
        bounds = np.cumsum([0] + [len(src) for src in sources])
        with profiler.region('sim.upload'):
            state = self._batch_state(sources)
        batch_seed = self._next_seed()

        tracking = None
        if self.mesh is not None and self.photon_tracking:
            # tracking snapshots every chunk by lane; the sharded driver
            # has no such boundary, so tracking runs on this rank alone
            logger.warning('photon_tracking=True: ignoring mesh=%s and '
                           'propagating single-device', self.mesh)
        with profiler.region('sim.propagate'):
            if self.mesh is not None and not self.photon_tracking:
                from chroma_tpu_torch.parallel import (pad_to_mesh,
                                                       propagate_sharded)
                padded, true_n = pad_to_mesh(state, self.mesh)
                result = propagate_sharded(padded, self.gpu_geometry,
                                           batch_seed, max_steps=max_steps,
                                           mesh=self.mesh,
                                           step_chunk=self.step_chunk)
                if len(result) != true_n:
                    result = result.map(lambda a: a[:true_n])
            else:
                result = propagate(state, self.gpu_geometry, batch_seed,
                                   max_steps=max_steps,
                                   step_chunk=1 if self.photon_tracking
                                   else self.step_chunk,
                                   track_steps=self.photon_tracking)
                if self.photon_tracking:
                    result, tracking = result

        want_hits = self.has_channels and (keep_hits or keep_flat_hits)
        batch_hits = None
        if want_hits:
            with profiler.region('sim.hit_extraction'):
                batch_hits = daq_ops.extract_flat_hits(result,
                                                       self.gpu_geometry)
        photons_end = None
        if keep_photons_end:
            with profiler.region('sim.readback'):
                channel = None
                if want_hits:
                    with profiler.region('sim.channels'):
                        channel = np.maximum(
                            daq_ops.photon_channels_device(
                                result, self.gpu_geometry).cpu().numpy(),
                            0).astype(np.uint32)
                photons_end = photon_state_to_host(result, channel=channel)

        for i, ev in enumerate(batch_events):
            with profiler.region('sim.event'):
                start, end = int(bounds[i]), int(bounds[i + 1])
                if not keep_photons_beg:
                    ev.photons_beg = None
                if tracking is not None:
                    with profiler.region('sim.tracks'):
                        ev.photon_tracks = self._regroup_tracks(
                            tracking, start, end)
                if keep_photons_end:
                    ev.photons_end = photons_end[start:end]
                if want_hits:
                    ev_hits = batch_hits if len(batch_events) == 1 \
                        else batch_hits[batch_hits.evidx == i]
                    if keep_hits:
                        order = np.argsort(ev_hits.channel, kind='stable')
                        sh = ev_hits[order]
                        chans, starts = np.unique(sh.channel,
                                                  return_index=True)
                        ends = np.r_[starts[1:], len(sh.channel)]
                        ev.hits = {int(c): sh[s:e]
                                   for c, s, e in zip(chans, starts, ends)}
                    if keep_flat_hits:
                        ev.flat_hits = ev_hits
                if self.has_channels and run_daq:
                    with profiler.region('sim.daq'):
                        ev_state = result.map(lambda a: a[start:end])
                        gen = make_generator(self.device, *batch_seed,
                                             DAQ_SITE + i)
                        arrays = daq_ops.run_daq(ev_state,
                                                 self.gpu_geometry, gen)
                        ev.channels = daq_ops.channels_to_host(arrays)
            yield ev

    @staticmethod
    def _regroup_tracks(tracking, start, end):
        """Per-photon tracks of lanes [start, end) from the driver's chunk
        snapshots: photon j's track holds, in chunk order, its state in
        every snapshot that has it (chroma_tpu/sim.py:294-308, grouped
        with one stable sort)."""
        ids, parts = [], []
        for orig_idx, snapshot in tracking:
            mask = (orig_idx >= start) & (orig_idx < end)
            if mask.any():
                ids.append(orig_idx[mask] - start)
                keep = torch.from_numpy(mask)
                parts.append(photon_state_to_host(
                    snapshot.map(lambda a: a[keep])))
        tracks = [event.Photons() for _ in range(end - start)]
        if not parts:
            return tracks
        ids = np.concatenate(ids)
        order = np.argsort(ids, kind='stable')
        points = event.Photons.join(parts)[order]
        bounds = np.r_[0, np.cumsum(np.bincount(ids, minlength=end - start))]
        for pid in np.flatnonzero(bounds[1:] > bounds[:-1]):
            tracks[pid] = points[bounds[pid]:bounds[pid + 1]]
        return tracks

    # ------------------------------------------------------------------
    # PDF evaluation API (used by chroma_tpu_torch.likelihood)
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
        propagations of a likelihood loop reuse them. A PhotonState passes
        through, with its medium set to unknown if it has none."""
        with profiler.region('sim.source'):
            if isinstance(photons, PhotonState):
                from chroma_tpu_torch.gpu import _with_cur_mat
                return _with_cur_mat(photons)
            return photon_state_from_host(photons, self.device)

    def _propagate_daq(self, state, ndaq):
        """Propagate a device PhotonState (not modified) with the next
        seed, then run the DAQ (ndaq replicas) on its own generator."""
        seed = self._next_seed()
        with profiler.region('sim.propagate'):
            result = propagate(state, self.gpu_geometry, seed,
                               max_steps=PDF_MAX_STEPS,
                               step_chunk=self.step_chunk)
        gen = make_generator(self.device, *seed, DAQ_SITE)
        return daq_ops.run_daq(result, self.gpu_geometry, gen, ndaq=ndaq)

    def _run_daq_once(self, ev, ndaq):
        "Propagate one event's photons and run the DAQ (ndaq replicas)."
        return self._propagate_daq(self._source_state(ev.photons_beg), ndaq)
