"""Procedural mesh primitives.

Same builder surface as the reference module (reference: chroma/make.py);
the lattice triangulation is generated directly from closed-loop index
arithmetic (``_loop_faces``) instead of assembling and rolling an index
grid, and surfaces of revolution are evaluated in closed form rather than
by repeatedly rotating the profile. All builders return
chroma_tpu_torch.geometry.Mesh objects with counter-clockwise outward-facing
winding.
"""
from __future__ import annotations

import numpy as np

from chroma_tpu_torch.geometry import Mesh


def _loop_faces(n_loops, loop_len):
    """Triangles stitching a lattice of `n_loops` closed loops (the loop
    axis wraps around), where vertex ids run seam-major: id = loop *
    loop_len + position. Each lattice cell becomes two CCW triangles whose
    shared diagonal runs from (pos, loop) to (pos-1, loop+1).

    Returns an (ntri, 3) int index array.
    """
    pos = np.arange(loop_len - 1, 0, -1)               # seam positions, top-down
    loop = np.arange(n_loops)
    a = loop[:, None] * loop_len + pos                 # (L, P-1) this loop, pos
    b = a - 1                                          # this loop, next pos
    nxt = ((loop + 1) % n_loops)[:, None] * loop_len
    c = nxt + pos - 1                                  # next loop, next pos
    d = nxt + pos                                      # next loop, this pos
    upper = np.stack([a, b, c], axis=-1)
    lower = np.stack([a, c, d], axis=-1)
    return np.concatenate([upper, lower]).reshape(-1, 3)


def mesh_grid(grid):
    """Triangulate a (rows, cols) grid of vertex indices into a closed
    strip: each cell becomes two triangles, columns wrap around."""
    top, bottom = grid[:-1], grid[1:]
    quads = np.stack([top, bottom,
                      np.roll(bottom, -1, axis=1),
                      np.roll(top, -1, axis=1)], axis=-1).reshape(-1, 4)
    return np.concatenate([quads[:, :3], quads[:, [0, 2, 3]]])


def linear_extrude(x1, y1, height, x2=None, y2=None, center=None,
                   endcaps=True):
    """Extrude the polygon (x1,y1) along z by `height`. If (x2,y2) is
    given, connect (x1,y1) at -height/2 to (x2,y2) at +height/2 (tapered
    solid). With endcaps=False the ends are left open.

    The polygon path should run counter-clockwise, otherwise the mesh is
    inside out.
    """
    x2 = x1 if x2 is None else x2
    y2 = y1 if y2 is None else y2
    if not len(x1) == len(y1) == len(x2) == len(y2):
        raise Exception('`x` and `y` arrays must have the same length.')
    bottom = np.column_stack([x1, y1]).astype(float)
    top = np.column_stack([x2, y2]).astype(float)

    n = len(bottom)
    z = height / 2.0
    # seam-major lattice: for each polygon point, its chain of rings
    # [axis(-z)?, bottom, top, axis(+z)?]
    chain = [np.c_[bottom, np.full(n, -z)], np.c_[top, np.full(n, z)]]
    if endcaps:
        pinch = np.zeros((n, 2))
        chain = [np.c_[pinch, np.full(n, -z)]] + chain \
            + [np.c_[pinch, np.full(n, z)]]
    vertices = np.stack(chain, axis=1).reshape(-1, 3)
    if center is not None:
        vertices = vertices + np.asarray(center, dtype=float)

    return Mesh(vertices, _loop_faces(n, len(chain)),
                remove_duplicate_vertices=True)


def rotate_extrude(x, y, nsteps=64):
    """Revolve the profile (x,y) about the y axis in `nsteps` angular
    steps, evaluating the surface of revolution in closed form:
    step s places profile point (x, y) at (x cos(s), y, -x sin(s)).

    The profile path should run counter-clockwise, otherwise the mesh is
    inside out.
    """
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    if len(x) != len(y):
        raise Exception('`x` and `y` arrays must have the same length.')

    theta = np.linspace(0, 2 * np.pi, nsteps, endpoint=False)
    # (steps, profile, xyz), step-major like the traversal of _loop_faces
    vertices = np.stack(
        np.broadcast_arrays(np.cos(theta)[:, None] * x,
                            y[None, :],
                            -np.sin(theta)[:, None] * x),
        axis=-1).reshape(-1, 3)
    return Mesh(vertices, _loop_faces(nsteps, len(x)),
                remove_duplicate_vertices=True)


def box(dx, dy, dz, center=(0, 0, 0)):
    "Axis-aligned box with side lengths dx, dy, dz."
    rx, ry = dx / 2.0, dy / 2.0
    return linear_extrude([-rx, rx, rx, -rx], [-ry, -ry, ry, ry],
                          height=dz, center=center)


def cube(size, height=None, center=(0, 0, 0)):
    "Cube with side length `size` (or a square prism of given `height`)."
    return box(size, size, size if height is None else height,
               center=center)


def cylinder_along_z(radius, height, points=100):
    "Cylinder about the z axis (polygonal cross-section of `points` sides)."
    angles = np.linspace(0, 2 * np.pi, points, endpoint=False)
    return linear_extrude(radius * np.cos(angles), radius * np.sin(angles),
                          height)


def cylinder(radius, height, radius2=None, nsteps=64):
    """Cylinder of given radius/height about the y axis; with `radius2`, a
    conical frustum from bottom radius `radius` to top radius `radius2`."""
    if radius2 is None:
        radius2 = radius
    return rotate_extrude([0, radius, radius2, 0],
                          [-height / 2.0, -height / 2.0,
                           height / 2.0, height / 2.0], nsteps)


def segmented_cylinder(radius, height, nsteps=64, nsegments=100):
    "Cylinder whose profile is subdivided into ~`nsegments` points."
    nseg_r = int((nsegments * radius / (2 * radius + height)) / 2)
    nseg_h = int((nsegments * height / (2 * radius + height)) / 2)
    x = np.concatenate([np.linspace(0, radius, nseg_r, endpoint=False),
                        [radius] * nseg_h,
                        np.linspace(radius, 0, nseg_r, endpoint=False),
                        [0]])
    y = np.concatenate([[-height / 2.0] * nseg_r,
                        np.linspace(-height / 2.0, height / 2.0, nseg_h,
                                    endpoint=False),
                        [height / 2.0] * (nseg_r + 1)])
    return rotate_extrude(x, y, nsteps)


def sphere(radius, nsteps=64):
    "Sphere of given radius."
    lat = np.linspace(-np.pi / 2, np.pi / 2, nsteps)
    return rotate_extrude(radius * np.cos(lat), radius * np.sin(lat),
                          nsteps)


def torus(radius, offset, nsteps=64, circle_steps=None):
    """Torus with barrel radius `radius` whose barrel centerline is at
    distance `offset` from the axis."""
    if circle_steps is None:
        circle_steps = nsteps
    barrel = np.linspace(0, 2 * np.pi, circle_steps)
    return rotate_extrude(radius * np.cos(barrel) + offset,
                          radius * np.sin(barrel), nsteps)


def convex_polygon(x, y):
    """Fan-triangulated polygon in the x-y plane; requires a convex
    outline with points in order."""
    vertices = np.column_stack((x, y, np.zeros_like(x)))
    fan = np.arange(1, len(vertices) - 1)
    triangles = np.column_stack(
        [np.zeros_like(fan), fan, fan + 1]).astype(np.int32)
    return Mesh(vertices=vertices, triangles=triangles)
