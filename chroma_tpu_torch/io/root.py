"""PyROOT event bridge in the REFERENCE on-disk schema (the torch port's
copy of chroma_tpu.io.root; reference: chroma/io/root.py + root.C).

Files use a TTree 'T' with a single 'ev' branch of class Event (plus an
optional 'CH' channel-info tree), with the same class layout as the
reference's root.C — so events written here load in ROOT analysis chains
built for the reference, and vice versa. The schema lives in
root_schema.C (compiled via ACLiC on first use).

The native, dependency-free event format is chroma_tpu_torch.io.npz; this
module raises a clear ImportError when PyROOT is absent.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

try:
    import ROOT
    HAS_ROOT = True
except ImportError:
    HAS_ROOT = False

_LOADED = False


def _require_root():
    if not HAS_ROOT:
        raise ImportError(
            'PyROOT is not available; use chroma_tpu_torch.io.npz.EventWriter '
            '/ EventReader for the portable event format')
    _load_schema()


def _load_schema():
    "Compile the event schema with ACLiC once per process."
    global _LOADED
    if _LOADED or hasattr(ROOT, 'Event'):
        _LOADED = True
        return
    cache_dir = os.environ.get('CHROMA_CACHE_DIR',
                               os.path.expanduser('~/.chroma'))
    os.makedirs(cache_dir, exist_ok=True)
    src = os.path.join(os.path.dirname(__file__), 'root_schema.C')
    dst = os.path.join(cache_dir, 'root_schema.C')
    if not os.path.exists(dst) or \
            os.stat(src).st_mtime > os.stat(dst).st_mtime:
        shutil.copy2(src, dst)
    ROOT.gROOT.ProcessLine('.L %s+' % dst)
    _LOADED = True


def _photons_to_root(photons, vec):
    n = len(photons.pos)
    channels = getattr(photons, 'channel', None)
    ch = np.ascontiguousarray(channels, dtype=np.int32) \
        if channels is not None else np.full(n, -1, np.int32)
    ROOT.chroma_store_photons(
        vec, n,
        np.ascontiguousarray(photons.pos, np.float32).ravel(),
        np.ascontiguousarray(photons.dir, np.float32).ravel(),
        np.ascontiguousarray(photons.pol, np.float32).ravel(),
        np.ascontiguousarray(photons.wavelengths, np.float32),
        np.ascontiguousarray(photons.t, np.float32),
        np.ascontiguousarray(photons.flags, np.uint32),
        np.ascontiguousarray(photons.last_hit_triangles, np.int32), ch)


def _photons_from_root(vec):
    from chroma_tpu_torch import event
    n = vec.size()
    pos = np.empty((n, 3), np.float32)
    dirs = np.empty((n, 3), np.float32)
    pol = np.empty((n, 3), np.float32)
    wavelengths = np.empty(n, np.float32)
    t = np.empty(n, np.float32)
    flags = np.empty(n, np.uint32)
    last = np.empty(n, np.int32)
    ch = np.empty(n, np.int32)
    ROOT.chroma_load_photons(vec, pos.ravel(), dirs.ravel(), pol.ravel(),
                             wavelengths, t, flags, last, ch)
    channel = ch.astype(np.uint32) if (ch >= 0).any() else None
    return event.Photons(pos=pos, dir=dirs, pol=pol,
                         wavelengths=wavelengths, t=t, flags=flags,
                         last_hit_triangles=last, channel=channel)


class RootWriter(object):
    """Write chroma events to a ROOT file in the reference schema
    (reference: chroma/io/root.py RootWriter)."""

    def __init__(self, filename, detector=None):
        _require_root()
        self.file = ROOT.TFile(filename, 'RECREATE')

        if detector is not None:
            import array
            ch_info = ROOT.TTree('CH', 'Chroma channel info')
            ch_pos = ROOT.TVector3()
            ch_type = array.array('i', [0])
            ch_info.Branch('pos', ch_pos)
            ch_info.Branch('type', ch_type, 'type/I')
            for pos, chtype in zip(detector.channel_index_to_position,
                                   detector.channel_index_to_channel_type):
                ch_pos.SetXYZ(*pos)
                ch_type[0] = int(chtype)
                ch_info.Fill()
            ch_info.Write()

        self.T = ROOT.TTree('T', 'Chroma events')
        self.ev = ROOT.Event()
        self.T.Branch('ev', self.ev)

    def write_event(self, pyev):
        ev = self.ev
        ev.id = int(pyev.id or 0)
        ev.photons_beg.clear()
        ev.photons_end.clear()
        ev.flat_hits.clear()
        ev.channels.clear()
        ev.hits.clear()

        if pyev.photons_beg is not None and len(pyev.photons_beg):
            _photons_to_root(pyev.photons_beg, ev.photons_beg)
        if pyev.photons_end is not None and len(pyev.photons_end):
            _photons_to_root(pyev.photons_end, ev.photons_end)
        if pyev.flat_hits is not None and len(pyev.flat_hits):
            _photons_to_root(pyev.flat_hits, ev.flat_hits)

        if pyev.channels is not None:
            hit = np.ascontiguousarray(pyev.channels.hit, np.int32)
            ROOT.chroma_store_channels(
                ev.channels, len(hit), hit,
                np.ascontiguousarray(pyev.channels.t, np.float32),
                np.ascontiguousarray(pyev.channels.q, np.float32),
                np.ascontiguousarray(pyev.channels.flags, np.uint32))
            ev.nhit = int(np.count_nonzero(hit))
            ev.nchannels = len(hit)
        else:
            ev.nhit = 0
            ev.nchannels = 0

        self.T.Fill()

    def close(self):
        self.T.Write()
        self.file.Close()


class RootReader(object):
    """Iterate events back out of a reference-schema ROOT file
    (reference: chroma/io/root.py RootReader: next/prev/jump_to)."""

    def __init__(self, filename):
        _require_root()
        self.file = ROOT.TFile(filename)
        self.T = self.file.Get('T')
        self.i = -1

    def __len__(self):
        return int(self.T.GetEntries())

    def __iter__(self):
        self.i = -1
        return self

    def _event(self):
        from chroma_tpu_torch import event
        rev = self.T.ev
        ev = event.Event(id=int(rev.id))
        if rev.photons_beg.size():
            ev.photons_beg = _photons_from_root(rev.photons_beg)
        if rev.photons_end.size():
            ev.photons_end = _photons_from_root(rev.photons_end)
        if rev.flat_hits.size():
            ev.flat_hits = _photons_from_root(rev.flat_hits)
        nch = int(rev.nchannels)
        if nch:
            hit = np.zeros(nch, bool)
            t = np.zeros(nch, np.float32)
            q = np.zeros(nch, np.float32)
            flags = np.zeros(nch, np.uint32)
            for c in rev.channels:
                if 0 <= c.id < nch:
                    hit[c.id] = True
                    t[c.id] = c.t
                    q[c.id] = c.q
                    flags[c.id] = c.flag
            ev.channels = event.Channels(hit, t, q, flags)
        return ev

    def __next__(self):
        if self.i + 1 >= len(self):
            raise StopIteration
        self.i += 1
        self.T.GetEntry(self.i)
        return self._event()

    def next(self):
        return self.__next__()

    def jump_to(self, i):
        if not 0 <= i < len(self):
            return None
        self.i = i
        self.T.GetEntry(i)
        return self._event()

    def prev(self):
        return self.jump_to(self.i - 1)

    def index(self):
        return self.i

    def close(self):
        self.file.Close()
