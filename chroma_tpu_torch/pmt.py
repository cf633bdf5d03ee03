"""PMT solid builders.

A PMT is modeled as a measured half-profile revolved about its symmetry
axis: a glass envelope enclosing an inset vacuum envelope whose front
(+y) half carries the photocathode surface (reference behavior:
chroma/pmt.py; the display colors below match the reference viewer's).
"""
from __future__ import annotations

import numpy as np

from chroma_tpu_torch.geometry import Solid
from chroma_tpu_torch.make import rotate_extrude
from chroma_tpu_torch.tools import read_csv, offset

# viewer display colors (kept bit-identical to the reference so saved
# geometries render the same): photocathode green, back surface red
PHOTOCATHODE_COLOR = 0x00ff00
BACK_COLOR = 0xff0000


def get_lc_profile(radii, a, b, d, rmin, rmax):
    """Height of an elliptical light-collector profile at `radii`: the
    (a, b) ellipse centered at x=d, shifted so the profile is zero at
    rmin."""
    on_ellipse = b * np.sqrt(1.0 - (radii - d) ** 2 / a ** 2)
    at_rmin = b * np.sqrt(1.0 - (rmin - d) ** 2 / a ** 2)
    return at_rmin - on_ellipse


def _half_profile(filename):
    """Load a PMT profile CSV and reduce it to a revolvable half: take the
    measured x<0 side mirrored into x>=0, order the points base->face by
    y, and pinch the first and last points onto the axis so the revolved
    mesh closes."""
    pts = read_csv(filename)
    half = pts[pts[:, 0] < 0] * np.array([-1.0, 1.0])
    half = half[half[:, 1].argsort()]
    half[[0, -1], 0] = 0.0
    return half


def _front_half_mask(mesh):
    "Per-triangle mask: centroid lies in the +y (face) half."
    centroids = mesh.vertices[mesh.triangles].mean(axis=1)
    return centroids[:, 1] > 0


def build_pmt_shell(filename, outer_material, glass, nsteps=16):
    "Just the glass envelope of a PMT (no inner vacuum)."
    rz = _half_profile(filename)
    return Solid(rotate_extrude(rz[:, 0], rz[:, 1], nsteps),
                 glass, outer_material, color=0xeeffffff)


def build_pmt(filename, glass_thickness, outer_material, glass, vacuum,
              photocathode_surface, back_surface, nsteps=16):
    """Full PMT: a glass shell of thickness `glass_thickness` around an
    inner vacuum; the vacuum envelope's front (+y) half is the
    photocathode, the rest is `back_surface`."""
    shell_rz = _half_profile(filename)
    # the vacuum envelope is the same profile drawn inward by the glass
    # thickness
    cavity_rz = offset(shell_rz, -glass_thickness)

    shell_mesh = rotate_extrude(shell_rz[:, 0], shell_rz[:, 1], nsteps)
    cavity_mesh = rotate_extrude(cavity_rz[:, 0], cavity_rz[:, 1], nsteps)

    front = _front_half_mask(cavity_mesh)
    pmt = (Solid(shell_mesh, glass, outer_material)
           + Solid(cavity_mesh, vacuum, glass,
                   surface=np.where(front, photocathode_surface,
                                    back_surface),
                   color=np.where(front, PHOTOCATHODE_COLOR, BACK_COLOR)))

    # stashed so a matching light collector can be sized to this PMT
    pmt.profile = shell_rz
    pmt.outer_material = outer_material
    pmt.nsteps = nsteps
    return pmt


def build_light_collector(pmt, a, b, d, rmin, rmax, surface, npoints=10):
    """Elliptical light collector revolved to match `pmt` (a Solid from
    build_pmt), seated at the PMT face height at radius rmin."""
    if not isinstance(pmt, Solid):
        raise Exception('`pmt` must be an instance of %s' % Solid)

    radii = np.linspace(rmin, rmax, npoints)
    heights = get_lc_profile(radii, a, b, d, rmin, rmax)

    # seat the cone on the PMT face: interpolate the face height at rmin
    # from the (decreasing-radius) face portion of the PMT profile
    face = pmt.profile[pmt.profile[:, 1] > -1e-3][::-1]
    seat = np.interp(rmin, face[:, 0], face[:, 1])

    mesh = rotate_extrude(radii, heights + seat, pmt.nsteps)
    return Solid(mesh, pmt.outer_material, pmt.outer_material,
                 surface=surface)


def build_light_collector_from_file(filename, outer_material, surface,
                                    nsteps=48):
    "Light collector revolved from a measured profile CSV."
    rz = read_csv(filename)
    return Solid(rotate_extrude(rz[:, 0], rz[:, 1], nsteps),
                 outer_material, outer_material, surface=surface)
