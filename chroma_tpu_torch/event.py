"""Event data model: photons, vertices, channels, events.

API-compatible with the reference event layer (reference: chroma/event.py),
but the photon container here is a thin SoA numpy view that converts to/from
the device-resident photon state used by the propagation engine
(chroma_tpu_torch.ops.photon.PhotonState).

Photon history flags match chroma/cuda/photon.h:53-68 bit-for-bit so that
persisted events and analysis cuts are portable between the two frameworks.
"""
from __future__ import annotations

import numpy as np

# Photon history bits (reference: chroma/cuda/photon.h:53-68)
NO_HIT           = 0x1 << 0
BULK_ABSORB      = 0x1 << 1
SURFACE_DETECT   = 0x1 << 2
SURFACE_ABSORB   = 0x1 << 3
RAYLEIGH_SCATTER = 0x1 << 4
REFLECT_DIFFUSE  = 0x1 << 5
REFLECT_SPECULAR = 0x1 << 6
SURFACE_REEMIT   = 0x1 << 7
SURFACE_TRANSMIT = 0x1 << 8
BULK_REEMIT      = 0x1 << 9
CHERENKOV        = 0x1 << 10
SCINTILLATION    = 0x1 << 11
NAN_ABORT        = 0x1 << 31

# A photon whose history contains any of these bits is finished propagating
# (reference: chroma/cuda/propagate.cu:295-296).
TERMINAL_FLAGS = (NO_HIT | BULK_ABSORB | SURFACE_DETECT | SURFACE_ABSORB
                  | NAN_ABORT)

PROCESS_NAMES = {
    NO_HIT: 'NO_HIT',
    BULK_ABSORB: 'BULK_ABSORB',
    SURFACE_DETECT: 'SURFACE_DETECT',
    SURFACE_ABSORB: 'SURFACE_ABSORB',
    RAYLEIGH_SCATTER: 'RAYLEIGH_SCATTER',
    REFLECT_DIFFUSE: 'REFLECT_DIFFUSE',
    REFLECT_SPECULAR: 'REFLECT_SPECULAR',
    SURFACE_REEMIT: 'SURFACE_REEMIT',
    SURFACE_TRANSMIT: 'SURFACE_TRANSMIT',
    BULK_REEMIT: 'BULK_REEMIT',
    CHERENKOV: 'CHERENKOV',
    SCINTILLATION: 'SCINTILLATION',
    NAN_ABORT: 'NAN_ABORT',
}


class Steps(object):
    """Charged-particle step record (positions, directions, energies)."""

    def __init__(self, x, y, z, t, dx, dy, dz, ke, edep, qedep):
        self.x, self.y, self.z, self.t = x, y, z, t
        self.dx, self.dy, self.dz = dx, dy, dz
        self.ke = ke
        self.edep = edep
        self.qedep = qedep


class Vertex(object):
    """A particle vertex: name, position (mm), direction, kinetic energy (MeV)."""

    def __init__(self, particle_name, pos, dir, ke, t0=0.0, pol=None,
                 steps=None, children=None, trackid=-1, pdgcode=-1):
        self.particle_name = particle_name
        self.pos = pos
        self.dir = dir
        self.pol = pol
        self.ke = ke
        self.t0 = t0
        self.steps = steps
        self.children = children
        self.trackid = trackid
        self.pdgcode = pdgcode

    def __str__(self):
        return ('Vertex(%s,ke=%s,steps=%s)'
                % (self.particle_name, self.ke, bool(self.steps)))

    __repr__ = __str__


# SoA field spec: (name, dtype, per-photon shape)
_PHOTON_FIELDS = (
    ('pos', np.float32, (3,)),
    ('dir', np.float32, (3,)),
    ('pol', np.float32, (3,)),
    ('wavelengths', np.float32, ()),
    ('t', np.float32, ()),
    ('last_hit_triangles', np.int32, ()),
    ('flags', np.uint32, ()),
    ('weights', np.float32, ()),
    ('evidx', np.uint32, ()),
    ('channel', np.uint32, ()),
)


class Photons(object):
    """A structure-of-arrays batch of photons.

    Fields (all numpy arrays of length n):
      pos(n,3) mm, dir(n,3), pol(n,3), wavelengths(n) nm, t(n) ns,
      last_hit_triangles(n) int32 (-1 = none), flags(n) uint32 history bits,
      weights(n) survival weight, evidx(n) uint32 batch event index,
      channel(n) uint32 channel id for detected photons.
    """

    def __init__(self, pos=None, dir=None, pol=None, wavelengths=None, t=None,
                 last_hit_triangles=None, flags=None, weights=None, evidx=None,
                 channel=None):
        if pos is None:
            pos = np.empty((0, 3))
        self.pos = np.asarray(pos, dtype=np.float32)
        n = len(self.pos)
        self.dir = self._field(dir, n, (3,), np.float32)
        self.pol = self._field(pol, n, (3,), np.float32)
        self.wavelengths = self._field(wavelengths, n, (), np.float32)
        self.t = self._field(t, n, (), np.float32, fill=0.0)
        self.last_hit_triangles = self._field(last_hit_triangles, n, (),
                                              np.int32, fill=-1)
        self.flags = self._field(flags, n, (), np.uint32, fill=0)
        self.weights = self._field(weights, n, (), np.float32, fill=1.0)
        self.evidx = self._field(evidx, n, (), np.uint32, fill=0)
        self.channel = self._field(channel, n, (), np.uint32, fill=0)

    @staticmethod
    def _field(value, n, shape, dtype, fill=None):
        if value is None:
            if fill is None:
                return np.empty((n,) + shape, dtype=dtype)
            return np.full((n,) + shape, fill, dtype=dtype)
        return np.asarray(value, dtype=dtype)

    @staticmethod
    def join(photon_list, concatenate=True):
        """Concatenate an iterable of Photons into one batch.

        With ``concatenate=False`` the inputs are treated as single-photon
        records and stacked instead (used when regrouping photon tracks).
        """
        combine = np.concatenate if concatenate else np.asarray
        kwargs = {}
        for name, _, _ in _PHOTON_FIELDS:
            kwargs[name] = combine([getattr(p, name) for p in photon_list])
        return Photons(**kwargs)

    def __add__(self, other):
        return Photons.join([self, other])

    def __len__(self):
        return len(self.pos)

    def __getitem__(self, key):
        return Photons(*[getattr(self, name)[key]
                         for name, _, _ in _PHOTON_FIELDS])

    def __str__(self):
        if len(self) == 1:
            parts = ['%s=%s' % (name, getattr(self, name)[0])
                     for name, _, _ in _PHOTON_FIELDS]
            return 'Photon(' + ','.join(parts) + ')'
        return 'Photons[%d]' % len(self)

    __repr__ = __str__

    def reduced(self, reduction_factor=1.0):
        """Randomly keep ~len(self)*reduction_factor photons."""
        n = len(self)
        choice = np.random.permutation(n)[:int(n * reduction_factor)]
        return self[choice]


class Channels(object):
    """DAQ readout for every channel in the detector (hit or not).

    hit(n) bool, t(n) float32 ns earliest hit time, q(n) float32 charge,
    flags(n) uint32 OR of contributing photon histories.
    """

    def __init__(self, hit, t, q, flags=None, evidx=None):
        self.hit = hit
        self.t = t
        self.q = q
        self.flags = flags
        self.evidx = evidx

    def hit_channels(self, return_flags=False):
        """Return (ids, t, q[, flags]) restricted to hit channels."""
        ids = self.hit.nonzero()[0]
        if return_flags:
            return ids, self.t[self.hit], self.q[self.hit], self.flags[self.hit]
        return ids, self.t[self.hit], self.q[self.hit]


class Event(object):
    """One simulated event: source vertices, photons, hits, channels."""

    def __init__(self, id=0, vertices=None, photons_beg=None, photons_end=None,
                 photon_tracks=None, photon_parent_trackids=None, hits=None,
                 flat_hits=None, channels=None):
        self.id = id
        self.nphotons = None
        if vertices is not None:
            self.vertices = list(vertices) if np.iterable(vertices) else [vertices]
        else:
            self.vertices = []
        self.photons_beg = photons_beg
        self.photons_end = photons_end
        self.photon_tracks = photon_tracks
        self.photon_parent_trackids = photon_parent_trackids
        self.hits = hits
        self.flat_hits = flat_hits
        self.channels = channels
