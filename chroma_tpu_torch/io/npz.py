"""Portable event persistence: one zip archive, one .npz per event (the
torch port's copy of chroma_tpu.io.npz, in the same file format: a
.chroma file written by either package reads back in the other).

Replaces the reference's ROOT TTree format (reference: chroma/io/root.py,
root.C) with a dependency-free container that stores the same content:
start/end photons, flat hits, channel readout (sparse, hit channels only,
like the reference writer) and vertices. The reader supports forward
iteration, indexing and jumping, mirroring RootReader's API.
"""
from __future__ import annotations

import io as _io
import json
import zipfile

import numpy as np

from chroma_tpu_torch import event

_PHOTON_FIELDS = ('pos', 'dir', 'pol', 'wavelengths', 't',
                  'last_hit_triangles', 'flags', 'weights', 'evidx',
                  'channel')


def _photons_to_arrays(prefix, photons, out):
    for name in _PHOTON_FIELDS:
        out[prefix + name] = getattr(photons, name)


def _photons_from_arrays(prefix, data):
    kwargs = {name: data[prefix + name] for name in _PHOTON_FIELDS
              if prefix + name in data}
    if not kwargs:
        return None
    return event.Photons(**kwargs)


class EventWriter(object):
    "Write Events to a .chroma zip archive."

    def __init__(self, filename):
        self.zip = zipfile.ZipFile(filename, 'w', zipfile.ZIP_DEFLATED)
        self.count = 0

    def write_event(self, ev):
        arrays = {}
        meta = {'id': int(ev.id), 'nphotons': ev.nphotons}

        if ev.photons_beg is not None:
            _photons_to_arrays('photons_beg/', ev.photons_beg, arrays)
        if ev.photons_end is not None:
            _photons_to_arrays('photons_end/', ev.photons_end, arrays)
        if ev.flat_hits is not None:
            _photons_to_arrays('flat_hits/', ev.flat_hits, arrays)

        if ev.channels is not None:
            # store only hit channels, like the reference writer
            hit = np.asarray(ev.channels.hit)
            ids = np.flatnonzero(hit)
            arrays['channels/nchannels'] = np.int64(len(hit))
            arrays['channels/ids'] = ids
            arrays['channels/t'] = np.asarray(ev.channels.t)[ids]
            arrays['channels/q'] = np.asarray(ev.channels.q)[ids]
            if ev.channels.flags is not None:
                arrays['channels/flags'] = \
                    np.asarray(ev.channels.flags)[ids]

        meta['vertices'] = [
            {'particle_name': v.particle_name,
             'pos': np.asarray(v.pos).tolist(),
             'dir': np.asarray(v.dir).tolist(),
             'ke': float(v.ke), 't0': float(v.t0),
             'trackid': int(v.trackid), 'pdgcode': int(v.pdgcode)}
            for v in (ev.vertices or [])]

        buf = _io.BytesIO()
        np.savez_compressed(buf, **arrays)
        name = 'events/%08d' % self.count
        self.zip.writestr(name + '.npz', buf.getvalue())
        self.zip.writestr(name + '.json', json.dumps(meta))
        self.count += 1

    def close(self):
        self.zip.writestr('meta.json', json.dumps({'nevents': self.count}))
        self.zip.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class EventReader(object):
    "Read Events from a .chroma archive; iterable with jump/prev."

    def __init__(self, filename):
        self.zip = zipfile.ZipFile(filename, 'r')
        meta = json.loads(self.zip.read('meta.json'))
        self.nevents = meta['nevents']
        self.i = -1

    def __len__(self):
        return self.nevents

    def index(self):
        return self.i

    def _load(self, i):
        name = 'events/%08d' % i
        data = np.load(_io.BytesIO(self.zip.read(name + '.npz')),
                       allow_pickle=False)
        meta = json.loads(self.zip.read(name + '.json'))

        ev = event.Event(id=meta['id'])
        ev.nphotons = meta.get('nphotons')
        ev.photons_beg = _photons_from_arrays('photons_beg/', data)
        ev.photons_end = _photons_from_arrays('photons_end/', data)
        ev.flat_hits = _photons_from_arrays('flat_hits/', data)

        if 'channels/nchannels' in data:
            n = int(data['channels/nchannels'])
            hit = np.zeros(n, dtype=bool)
            t = np.full(n, 1e9, dtype=np.float32)
            q = np.zeros(n, dtype=np.float32)
            flags = np.zeros(n, dtype=np.uint32)
            ids = data['channels/ids']
            hit[ids] = True
            t[ids] = data['channels/t']
            q[ids] = data['channels/q']
            if 'channels/flags' in data:
                flags[ids] = data['channels/flags']
            ev.channels = event.Channels(hit, t, q, flags)

        ev.vertices = [event.Vertex(v['particle_name'], np.array(v['pos']),
                                    np.array(v['dir']), v['ke'], t0=v['t0'],
                                    trackid=v['trackid'],
                                    pdgcode=v['pdgcode'])
                       for v in meta.get('vertices', [])]
        return ev

    def current(self):
        return self._load(max(self.i, 0))

    def jump_to(self, i):
        "Load event at index i; returns it or None if out of range."
        if 0 <= i < self.nevents:
            self.i = i
            return self._load(i)
        return None

    def prev(self):
        return self.jump_to(self.i - 1)

    def next(self):
        return self.__next__()

    def __iter__(self):
        self.i = -1
        return self

    def __next__(self):
        if self.i + 1 >= self.nevents:
            raise StopIteration
        self.i += 1
        return self._load(self.i)

    def close(self):
        self.zip.close()
