"""Tessellation of GDML primitive solids into triangle meshes.

The reference meshes GDML solids through gmsh/OpenCASCADE
(reference: chroma/gdml/gen_mesh.py); this module tessellates the common
primitives directly in numpy so GDML import works without native CAD
dependencies. Lengths are mm, angles radians (converted by the loader).

Supported: box, tube (incl. rmin/partial phi), eltube, orb, sphere
(incl. shells/partial), polycone, polyhedra, torus, trd.
CSG booleans (union/subtraction/intersection) are meshed by the loader
through the built-in BSP engine (chroma_tpu_torch.csg, no gmsh needed — see
chroma_tpu_torch.gdml.loader); only unknown solid TYPES raise.
"""
from __future__ import annotations

import numpy as np

from chroma_tpu_torch.geometry import Mesh

DEFAULT_NSTEPS = 32


def _revolve_profile(r, z, startphi=0.0, deltaphi=2 * np.pi,
                     nsteps=DEFAULT_NSTEPS):
    """Revolve an (r, z) profile polyline about the z axis through
    `deltaphi` starting at `startphi`. The profile should trace the solid's
    cross-section boundary counter-clockwise (in the r-z plane) and be a
    closed loop (first point == last point is NOT required; closure is
    implied). Partial sweeps get planar end caps."""
    r = np.asarray(r, dtype=float)
    z = np.asarray(z, dtype=float)
    full = abs(deltaphi - 2 * np.pi) < 1e-9
    nph = max(3, int(round(nsteps * deltaphi / (2 * np.pi))))
    if full:
        phis = startphi + np.arange(nph) * (deltaphi / nph)
    else:
        phis = startphi + np.linspace(0, deltaphi, nph + 1)

    npro = len(r)
    rings = np.empty((len(phis), npro, 3))
    rings[:, :, 0] = np.outer(np.cos(phis), r)
    rings[:, :, 1] = np.outer(np.sin(phis), r)
    rings[:, :, 2] = np.broadcast_to(z, (len(phis), npro))
    vertices = rings.reshape(-1, 3)

    tris = []
    nphi_faces = len(phis) if full else len(phis) - 1
    for i in range(nphi_faces):
        j = (i + 1) % len(phis)
        base_i, base_j = i * npro, j * npro
        for k in range(npro):
            k2 = (k + 1) % npro
            tris.append([base_i + k, base_j + k, base_j + k2])
            tris.append([base_i + k, base_j + k2, base_i + k2])

    if not full:
        # planar caps: triangle fan around the profile centroid
        for ring, flip in ((0, True), (len(phis) - 1, False)):
            base = ring * npro
            center = len(vertices)
            vertices = np.vstack([vertices,
                                  vertices[base:base + npro].mean(
                                      axis=0, keepdims=True)])
            for k in range(npro):
                k2 = (k + 1) % npro
                tri = [center, base + k, base + k2]
                if flip:
                    tri = tri[::-1]
                tris.append(tri)

    return Mesh(vertices, np.asarray(tris, dtype=np.int64),
                remove_duplicate_vertices=True)


def box(dx, dy, dz):
    "GDML box: FULL side lengths dx, dy, dz."
    from chroma_tpu_torch.make import box as _box
    return _box(dx, dy, dz)


def tube(rmin, rmax, z, startphi=0.0, deltaphi=2 * np.pi,
         nsteps=DEFAULT_NSTEPS):
    "GDML tube: z is the FULL height (GDML convention: attribute is 2*z/2)."
    hz = z / 2.0
    if rmin > 0:
        r = [rmin, rmax, rmax, rmin]
        zz = [-hz, -hz, hz, hz]
    else:
        r = [0, rmax, rmax, 0]
        zz = [-hz, -hz, hz, hz]
    return _revolve_profile(r, zz, startphi, deltaphi, nsteps)


def eltube(dx, dy, dz, nsteps=DEFAULT_NSTEPS):
    "Elliptical tube with semi-axes dx, dy and half-height dz."
    from chroma_tpu_torch.make import linear_extrude
    angles = np.linspace(0, 2 * np.pi, nsteps, endpoint=False)
    return linear_extrude(dx * np.cos(angles), dy * np.sin(angles),
                          2 * dz)


def orb(r, nsteps=DEFAULT_NSTEPS):
    from chroma_tpu_torch.make import sphere as _sphere
    return _sphere(r, nsteps=nsteps)


def sphere(rmin, rmax, startphi=0.0, deltaphi=2 * np.pi, starttheta=0.0,
           deltatheta=np.pi, nsteps=DEFAULT_NSTEPS):
    "GDML sphere (shell/wedge supported via the revolve profile)."
    thetas = np.linspace(starttheta, starttheta + deltatheta, nsteps)
    r_outer = rmax * np.sin(thetas)
    z_outer = rmax * np.cos(thetas)
    if rmin > 0:
        r_inner = (rmin * np.sin(thetas))[::-1]
        z_inner = (rmin * np.cos(thetas))[::-1]
        r = np.concatenate([r_outer, r_inner])
        z = np.concatenate([z_outer, z_inner])
    else:
        r = np.concatenate([r_outer, [0.0]])
        z = np.concatenate([z_outer, [z_outer[-1]]])
    return _revolve_profile(r, z, startphi, deltaphi, nsteps)


def polycone(startphi, deltaphi, zplanes, nsteps=DEFAULT_NSTEPS):
    """zplanes: list of (rmin, rmax, z). Profile walks up the outer wall
    and back down the inner wall."""
    zplanes = sorted(zplanes, key=lambda p: p[2])
    r_out = [p[1] for p in zplanes]
    z_out = [p[2] for p in zplanes]
    r_in = [p[0] for p in zplanes][::-1]
    z_in = [p[2] for p in zplanes][::-1]
    r = np.concatenate([r_out, r_in])
    z = np.concatenate([z_out, z_in])
    return _revolve_profile(r, z, startphi, deltaphi, nsteps)


def polyhedra(startphi, deltaphi, numsides, zplanes):
    """Like polycone but with flat sides: GDML radii are apothems
    (inradius), so scale to circumradius for the revolve."""
    scale = 1.0 / np.cos(np.pi / numsides)
    zp = [(rmin * scale, rmax * scale, z) for rmin, rmax, z in zplanes]
    return polycone(startphi, deltaphi, zp, nsteps=numsides)


def torus(rmin, rmax, rtor, startphi=0.0, deltaphi=2 * np.pi,
          nsteps=DEFAULT_NSTEPS):
    alphas = np.linspace(0, 2 * np.pi, nsteps, endpoint=False)
    r = rtor + rmax * np.cos(alphas)
    z = rmax * np.sin(alphas)
    return _revolve_profile(r, z, startphi, deltaphi, nsteps)


def trd(dx1, dx2, dy1, dy2, dz):
    "Trapezoid: half-lengths dx1/dy1 at -dz, dx2/dy2 at +dz."
    from chroma_tpu_torch.make import linear_extrude
    x1 = np.array([-dx1, dx1, dx1, -dx1])
    y1 = np.array([-dy1, -dy1, dy1, dy1])
    x2 = np.array([-dx2, dx2, dx2, -dx2])
    y2 = np.array([-dy2, -dy2, dy2, dy2])
    return linear_extrude(x1, y1, 2 * dz, x2=x2, y2=y2)
