"""Drop-in naming compatibility with the reference's chroma.gpu layer, for
the torch port (counterpart of chroma_tpu.gpu).

The reference exposes device runtime classes as chroma.gpu.GPUGeometry,
GPUPhotons, GPUDaq, GPUPDF... (reference: chroma/gpu/__init__.py). The
port's equivalents live in chroma_tpu_torch.ops as functional modules;
this facade wraps them in the familiar object API so reference call sites
port with an import change. Random state is the port's (seed, counter)
pair, the one Simulation feeds its propagation and DAQ generators, where
the JAX facade hands out keys.
"""
from __future__ import annotations

import torch

from chroma_tpu_torch import event
from chroma_tpu_torch.camera import Rays
from chroma_tpu_torch.ops import daq as daq_ops
from chroma_tpu_torch.ops import pdf as pdf_ops
from chroma_tpu_torch.ops.photon import PhotonState, i32
from chroma_tpu_torch.ops.propagate import (_ps_compact_perm, propagate,
                                            photon_state_from_host,
                                            photon_state_to_host)
from chroma_tpu_torch.ops.render import pixels_to_host
from chroma_tpu_torch.ops.sample import make_generator
from chroma_tpu_torch.ops.types import build_geometry_arrays
from chroma_tpu_torch.sim import DAQ_SITE


def _with_cur_mat(state):
    "The state with an unknown medium (-1) where it has none."
    if state.cur_mat is not None:
        return state
    return state.replace(cur_mat=torch.full(
        (len(state),), -1, dtype=torch.int32, device=state.pos.device))


def join_states(states):
    """Concatenate device PhotonStates along the photon axis on the device,
    without a host round trip (the analog of the reference's device-side
    source stacking, reference: chroma/sim.py:156-223
    _stack_gpu_photon_sources + gpu/photon.py:66-95 dtod copies)."""
    states = [_with_cur_mat(st) for st in states]
    return PhotonState(**{
        name: torch.cat([getattr(st, name) for st in states])
        for name in PhotonState.__dataclass_fields__})


def create_cuda_context(device=None):
    "No-op placeholder: torch owns the device. Returns a dummy context."
    class _Ctx(object):
        def pop(self):
            pass
    return _Ctx()


def get_rng_states(n, seed=1):
    """The port's generator state for `seed`: the (seed, counter) pair from
    which propagation and DAQ seed their torch.Generators (the counter of
    Simulation's first batch)."""
    return (int(seed), 0)


class GPUGeometry(object):
    """Device geometry (reference: chroma/gpu/geometry.py GPUGeometry).
    `arrays` takes prebuilt GeometryArrays (e.g. from the geocache) in
    place of a host build."""

    def __init__(self, geometry, wavelengths=None, times=None,
                 print_usage=False, device='cuda', arrays=None, **_compat):
        self.geometry = geometry
        if arrays is None:
            arrays = build_geometry_arrays(geometry, wavelengths, times)
        self.arrays = arrays.to(device)
        if print_usage:
            self.print_device_usage()

    def print_device_usage(self):
        rows = self.arrays.wide.rows
        ntri = int(self.arrays.inst.tri_base[-1]) \
            if self.arrays.inst is not None else len(self.arrays.triangles)
        print('device geometry: %d triangles, %.1f MB acceleration rows'
              % (ntri, rows.numel() * 4 / 1e6))


class GPUDetector(GPUGeometry):
    "Detector geometry with channel map (reference: gpu/detector.py)."


class GPUPhotons(object):
    "Device photon batch (reference: chroma/gpu/photon.py GPUPhotons)."

    def __init__(self, photons, ncopies=1, device='cuda', **_compat):
        self.true_nphotons = len(photons)
        if isinstance(photons, PhotonState):
            # device-resident input: used in place, duplicated on its
            # device when ncopies > 1 (reference: gpu/photon.py:66-111)
            state = _with_cur_mat(photons)
            if ncopies > 1:
                state = join_states([state] * ncopies)
        else:
            if ncopies > 1:
                photons = event.Photons.join([photons] * ncopies)
            state = photon_state_from_host(photons, device)
        self.state = state

    def __len__(self):
        return len(self.state)

    def propagate(self, gpu_geometry, rng_states, max_steps=100,
                  use_weights=False, scatter_first=0, track=False,
                  **_compat):
        """Propagate in place with the (seed, counter) `rng_states`; with
        track=True returns the driver's per-chunk snapshots."""
        result = propagate(self.state, gpu_geometry.arrays, rng_states,
                           max_steps=max_steps, use_weights=use_weights,
                           scatter_first=scatter_first, track_steps=track)
        if track:
            self.state, tracking = result
            return tracking
        self.state = result
        return None

    def get(self):
        return photon_state_to_host(self.state)

    def get_flat_hits(self, gpu_geometry):
        """Photons detected by channels: counted and front-packed on the
        device, where they stay (a LazyHits) until a field is read, then
        one transfer of the detected minority (reference:
        gpu/photon.py:141-209)."""
        return daq_ops.extract_flat_hits(self.state, gpu_geometry.arrays)

    def select(self, target_flag):
        """Photons whose history matches target_flag, in lane order:
        device-side count and front-pack, host transfer of the selection
        only."""
        match = (self.state.flags & i32(int(target_flag))) != 0
        _, perm = _ps_compact_perm(match)
        sel = perm[:int(match.sum())]
        return photon_state_to_host(self.state.map(lambda a: a[sel]))


class GPUDaq(object):
    "DAQ runner (reference: chroma/gpu/daq.py GPUDaq)."

    def __init__(self, gpu_detector, ndaq=1):
        self.gpu_detector = gpu_detector
        self.ndaq = ndaq
        self._pending = None

    def begin_acquire(self, nthreads_per_block=None):
        self._pending = None

    def acquire(self, gpu_photons, rng_states, start_photon=0,
                nphotons=None, **_compat):
        """Read out the photons (or lanes [start_photon, start_photon +
        nphotons)) with draws seeded from (rng_states, DAQ_SITE), the
        generator Simulation gives event 0 of a batch; a slice draws from
        (rng_states, DAQ_SITE, start_photon)."""
        state = gpu_photons.state
        site = (DAQ_SITE,)
        if nphotons is not None:
            state = state.map(
                lambda a: a[start_photon:start_photon + nphotons])
            site = (DAQ_SITE, start_photon)
        gen = make_generator(state.pos.device, *rng_states, *site)
        batch = daq_ops.run_daq(state, self.gpu_detector.arrays, gen,
                                ndaq=self.ndaq)
        # accumulate across acquire() calls within one begin/end cycle,
        # like the reference's persistent atomicMin/Add/Or device arrays
        # (reference: chroma/gpu/daq.py:61-79, cuda/daq.cu:73-75)
        if self._pending is None:
            self._pending = batch
        else:
            prev = self._pending
            self._pending = daq_ops.ChannelArrays(
                earliest_time=torch.minimum(prev.earliest_time,
                                            batch.earliest_time),
                charge=prev.charge + batch.charge,
                histories=prev.histories | batch.histories)
        return self._pending

    def end_acquire(self):
        return GPUChannels(self._pending, self.ndaq)


class GPUChannels(object):
    "Channel readout container (reference: chroma/gpu/daq.py GPUChannels)."

    def __init__(self, arrays, ndaq=1):
        self.arrays = arrays
        self.ndaq = ndaq
        self.t = arrays.earliest_time
        self.q = arrays.charge
        self.flags = arrays.histories

    def get(self):
        return daq_ops.channels_to_host(self.arrays)


class GPUPDF(object):
    "Binned + variable-bin PDF estimation (reference: chroma/gpu/pdf.py)."

    def __init__(self):
        self._accum = None
        self._eval = None

    def setup_pdf(self, gpu_geometry, tbins, trange, qbins, qrange):
        self._accum = pdf_ops.PDFAccumulator(gpu_geometry.arrays, tbins,
                                             trange, qbins, qrange)

    def clear_pdf(self):
        self._accum.clear()

    def add_hits_to_pdf(self, gpu_channels, **_compat):
        self._accum.add(gpu_channels.arrays, ndaq=gpu_channels.ndaq)

    def get_pdfs(self):
        return self._accum.get()

    def setup_pdf_eval(self, gpu_geometry, event_channels, min_twidth,
                       trange, min_qwidth, qrange, min_bin_content=10,
                       time_only=True):
        self._eval = pdf_ops.PDFEval(gpu_geometry.arrays, event_channels,
                                     min_twidth, trange, min_qwidth,
                                     qrange, min_bin_content, time_only)

    def clear_pdf_eval(self):
        self._eval.clear()

    def accumulate_pdf_eval(self, gpu_channels, **_compat):
        self._eval.accumulate(gpu_channels.arrays, ndaq=gpu_channels.ndaq)

    def get_pdf_eval(self):
        return self._eval.get()


class GPUKernelPDF(object):
    "Gaussian KDE PDF estimation (reference: chroma/gpu/pdf.py:7-175)."

    def __init__(self):
        self._kernel = None

    def setup_moments(self, gpu_geometry, trange, qrange, time_only=True):
        self._kernel = pdf_ops.KernelPDF(gpu_geometry.arrays, trange,
                                         qrange, time_only=time_only)

    def clear_moments(self):
        self._kernel.clear_moments()

    def accumulate_moments(self, gpu_channels, **_compat):
        self._kernel.accumulate_moments(gpu_channels.arrays)

    def compute_bandwidth(self, event_hit, event_time, event_charge,
                          scale_factor=1.0):
        self._kernel.compute_bandwidth(event_hit, event_time,
                                       event_charge, scale_factor)

    def setup_kernel(self, event_hit, event_time, event_charge):
        self._kernel.setup_kernel(event_hit, event_time, event_charge)

    def clear_kernel(self):
        self._kernel.clear_kernel()

    def accumulate_kernel(self, gpu_channels, **_compat):
        self._kernel.accumulate_kernel(gpu_channels.arrays)

    def get_kernel_eval(self):
        return self._kernel.get_kernel_eval()


class GPURays(object):
    "Ray bundle for rendering (reference: chroma/gpu/render.py GPURays)."

    def __init__(self, pos, dir, max_alpha_depth=10, device='cuda',
                 **_compat):
        self._rays = Rays(pos, dir, device)
        self.max_alpha_depth = max_alpha_depth

    @property
    def pos(self):
        return self._rays.pos

    @property
    def dir(self):
        return self._rays.dir

    def rotate(self, phi, n):
        self._rays.rotate(phi, n)

    def rotate_around_point(self, phi, n, point):
        self._rays.rotate_around_point(phi, n, point)

    def translate(self, v):
        self._rays.translate(v)

    def render(self, gpu_geometry, pixels=None, alpha_depth=10,
               keep_last_render=False):
        """(N,) int32 ARGB pixels (u32 bit patterns) on the rays' device;
        a host uint32 array `pixels` is filled with them too."""
        out = self._rays.render(gpu_geometry.arrays, alpha_depth)
        if pixels is not None:
            pixels[:] = pixels_to_host(out)
        return out
