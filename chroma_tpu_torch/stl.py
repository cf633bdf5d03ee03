"""STL mesh loader, ASCII and binary, with .bz2 support (the torch port's
copy of chroma_tpu.stl; reference: chroma/stl.py). The binary path is
fully vectorized."""
from __future__ import annotations

import bz2

import numpy as np

from chroma_tpu_torch.geometry import Mesh


def _open(filename, mode='rb'):
    if filename.endswith('.bz2'):
        return bz2.BZ2File(filename)
    return open(filename, mode)


def mesh_from_stl(filename):
    "Return a Mesh from an STL file (auto-detects ASCII vs binary)."
    with _open(filename) as f:
        header = f.read(512)
    try:
        text = header.decode('ascii')
        if text.lstrip().lower().startswith('solid') and 'facet' in text:
            return mesh_from_ascii_stl(filename)
    except UnicodeDecodeError:
        pass
    return mesh_from_binary_stl(filename)


def _dedupe_vertices(flat_vertices):
    """Map (3T,3) per-corner vertices to a unique vertex array + (T,3)
    triangle indices."""
    unique, inverse = np.unique(flat_vertices, axis=0, return_inverse=True)
    return Mesh(unique, inverse.reshape(-1, 3).astype(np.int32))


def mesh_from_ascii_stl(filename):
    "Return a Mesh from an ASCII STL file."
    vertices = []
    with _open(filename) as f:
        for raw in f:
            line = raw.decode('ascii') if isinstance(raw, bytes) else raw
            parts = line.split()
            if parts and parts[0] == 'vertex':
                vertices.append([float(s) for s in parts[1:4]])
    flat = np.asarray(vertices, dtype=np.float32)
    if len(flat) % 3 != 0:
        raise ValueError('ASCII STL vertex count not a multiple of 3')
    return _dedupe_vertices(flat)


# binary STL record: 12B normal + 3*12B vertices + 2B attribute
_RECORD = np.dtype([('normal', '<f4', (3,)),
                    ('vertices', '<f4', (3, 3)),
                    ('attr', '<u2')])


def mesh_from_binary_stl(filename):
    "Return a Mesh from a binary STL file."
    with _open(filename) as f:
        f.read(80)  # header
        ntriangles = int(np.frombuffer(f.read(4), dtype='<u4')[0])
        records = np.frombuffer(f.read(ntriangles * _RECORD.itemsize),
                                dtype=_RECORD, count=ntriangles)
    flat = records['vertices'].reshape(-1, 3).astype(np.float32)
    return _dedupe_vertices(flat)
