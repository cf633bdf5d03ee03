"""Meshes of the benchmark's detectors, worked out again in numpy.

Frozen copies of the mesh arithmetic the detectors are built from
(Chroma's `make.rotate_extrude`, `make.sphere`, `tools.offset`, the PMT
profiles and the spiral placement of `demo.detector`), so that the
reference's triangles are the program's triangles, in the program's
order, without importing the program. The raw profiles and optics tables
are copies in `data/`.
"""
from __future__ import annotations

import os
from math import cos, sin, sqrt

import numpy as np

DATA = os.path.join(os.path.dirname(__file__), 'data')


def read_csv(name):
    "Rows of comma-separated floats of a data file (other lines skipped)."
    rows = []
    with open(os.path.join(DATA, name)) as f:
        for line in f:
            try:
                rows.append([float(s) for s in line.split(',')])
            except ValueError:
                pass
    return np.array(rows)


def loop_faces(n_loops, loop_len):
    """Triangles stitching `n_loops` closed loops of `loop_len` vertices,
    ids seam-major (loop * loop_len + position), two per lattice cell with
    the diagonal from (pos, loop) to (pos - 1, loop + 1)."""
    pos = np.arange(loop_len - 1, 0, -1)
    loop = np.arange(n_loops)
    a = loop[:, None] * loop_len + pos
    b = a - 1
    nxt = ((loop + 1) % n_loops)[:, None] * loop_len
    c = nxt + pos - 1
    d = nxt + pos
    upper = np.stack([a, b, c], axis=-1)
    lower = np.stack([a, c, d], axis=-1)
    return np.concatenate([upper, lower]).reshape(-1, 3)


def clean(vertices, triangles):
    """The mesh as the program stores it: vertices rounded to float32,
    triangles with two equal corners dropped (the rest keep their
    order)."""
    v = np.asarray(vertices, np.float32).round(decimals=12)
    c = v[triangles]
    null = ((c[:, 0] == c[:, 1]).all(-1) | (c[:, 1] == c[:, 2]).all(-1)
            | (c[:, 0] == c[:, 2]).all(-1))
    return v.astype(np.float64), triangles[~null]


def rotate_extrude(x, y, nsteps):
    """(vertices (V, 3), triangles (T, 3)) of the profile (x, y) revolved
    about the y axis: step s puts (x, y) at (x cos s, y, -x sin s);
    cleaned as the program cleans a mesh.
    """
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    theta = np.linspace(0, 2 * np.pi, nsteps, endpoint=False)
    v = np.stack(np.broadcast_arrays(np.cos(theta)[:, None] * x, y[None, :],
                                     -np.sin(theta)[:, None] * x),
                 axis=-1).reshape(-1, 3)
    return clean(v, loop_faces(nsteps, len(x)))


def sphere(radius, nsteps):
    lat = np.linspace(-np.pi / 2, np.pi / 2, nsteps)
    return rotate_extrude(radius * np.cos(lat), radius * np.sin(lat), nsteps)


def box(dx, dy, dz):
    """An axis-aligned box about the origin: 12 triangles wound
    counter-clockwise seen from outside."""
    hx, hy, hz = dx / 2.0, dy / 2.0, dz / 2.0
    v = np.array([[sx * hx, sy * hy, sz * hz] for sx in (-1, 1)
                  for sy in (-1, 1) for sz in (-1, 1)])

    def vid(sx, sy, sz):
        return ((sx > 0) * 4) + ((sy > 0) * 2) + (sz > 0)
    faces = []
    for axis in range(3):
        for side in (-1, 1):
            corners = []
            for a, b in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                s = [0, 0, 0]
                s[axis] = side
                s[(axis + 1) % 3] = a
                s[(axis + 2) % 3] = b
                corners.append(vid(*s))
            if side < 0:
                corners = corners[::-1]
            faces += [[corners[0], corners[1], corners[2]],
                      [corners[0], corners[2], corners[3]]]
    return v, np.array(faces)


def offset(points, x, tol=1e-9):
    """The open 2-D profile `points` moved perpendicular to its path by `x`
    (positive: the path direction turned 90 degrees clockwise), joints
    mitred."""
    pts = np.asarray(points, dtype=float)
    keep = np.r_[True, np.linalg.norm(np.diff(pts, axis=0), axis=1) > tol]
    pts = pts[keep]
    tang = np.diff(pts, axis=0)
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    norm = np.column_stack([tang[:, 1], -tang[:, 0]]) * x
    a = pts[:-1] + norm
    b = pts[1:] + norm
    t0, t1 = tang[:-1], tang[1:]
    det = t0[:, 0] * t1[:, 1] - t0[:, 1] * t1[:, 0]
    rhs = a[1:] - b[:-1]
    parallel = np.abs(det) < 1e-12
    s = np.where(parallel, 0.0,
                 (rhs[:, 0] * t1[:, 1] - rhs[:, 1] * t1[:, 0])
                 / np.where(parallel, 1.0, det))
    joins = b[:-1] + s[:, None] * t0
    return np.vstack([a[:1], joins, b[-1:]])


def half_profile(name):
    """A measured PMT outline reduced to the half that is revolved: the
    x < 0 side mirrored, ordered by y, ends pinched onto the axis."""
    pts = read_csv(name)
    half = pts[pts[:, 0] < 0] * np.array([-1.0, 1.0])
    half = half[half[:, 1].argsort()]
    half[[0, -1], 0] = 0.0
    return half


def spherical_spiral(radius, spacing):
    "Points about `spacing` apart along a spiral wrapping a sphere."
    dl = spacing / radius
    t = 0.0
    a = np.pi / dl
    while t < np.pi:
        yield np.array([sin(t) * sin(a * t), sin(t) * cos(a * t),
                        cos(t)]) * radius
        t += dl / sqrt(1 + a ** 2 * sin(t) ** 2)


def rotation_to(direction):
    """The rotation about an axis perpendicular to +y and `direction` that
    turns +y onto `direction` (how the demo detector aims its PMTs)."""
    y = np.array([0.0, 1.0, 0.0])
    axis = np.cross(direction, y)
    axis = axis / np.linalg.norm(axis)
    angle = np.arccos(np.dot(y, direction))
    k = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                  [-axis[1], axis[0], 0.0]])
    for a in (angle, -angle):
        r = np.identity(3) + sin(a) * k + (1 - cos(a)) * (k @ k)
        if np.allclose(r @ y, direction, atol=1e-9):
            return r
    raise ValueError('no rotation found')
