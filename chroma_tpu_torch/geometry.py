"""Host-side geometry model: meshes, solids, optical materials and surfaces.

API-compatible with the reference host geometry layer (reference:
chroma/geometry.py), feeding the flat-array device representation built by
chroma_tpu_torch.ops.types. All optical properties are stored as
(wavelength, value) pair tables and resampled onto the uniform standard
wavelength grid before upload, so that device-side lookup is a single fused
multiply-add.
"""
from __future__ import annotations

from hashlib import md5

import numpy as np

from chroma_tpu_torch.log import logger

# All material/surface properties are interpolated at these wavelengths (nm)
# when marshaled for the device (reference: chroma/geometry.py:17).
standard_wavelengths = np.arange(60, 1000, 5).astype(np.float32)

# Uniform time grid (ns) for reemission-time CDFs
# (reference: chroma/gpu/geometry.py:23-30).
standard_times = np.arange(0, 1000, 0.05).astype(np.float32)

# Surface model identifiers (reference: chroma/cuda/geometry_types.h:22)
SURFACE_DEFAULT = 0
SURFACE_COMPLEX = 1
SURFACE_WLS = 2
SURFACE_DICHROIC = 3
SURFACE_ANGULAR = 4


class Mesh(object):
    """Triangle mesh: float32 vertices (V,3) and int32 triangles (T,3)."""

    def __init__(self, vertices, triangles, remove_duplicate_vertices=False,
                 round=True, remove_null_triangles=True):
        vertices = np.asarray(vertices, dtype=np.float32)
        triangles = np.asarray(triangles, dtype=np.int32)

        if vertices.ndim != 2 or vertices.shape[1] != 3:
            raise ValueError('shape mismatch')
        if triangles.ndim != 2 or triangles.shape[1] != 3:
            raise ValueError('shape mismatch')
        if (triangles < 0).any():
            raise ValueError('indices in `triangles` must be positive.')
        if (triangles >= len(vertices)).any():
            raise ValueError('indices in `triangles` must be less than the '
                             'length of the vertex array.')

        self.vertices = vertices
        self.triangles = triangles
        if len(self.vertices) == 0:
            logger.warning('Generated mesh has no vertices.')
        if len(self.triangles) == 0:
            logger.warning('Generated mesh has no triangles.')
        if round:
            self.vertices = self.vertices.round(decimals=12)
        if remove_duplicate_vertices:
            self.remove_duplicate_vertices()
        if remove_null_triangles:
            self.remove_null_triangles()

    def get_triangle_centers(self):
        "Centroid of each triangle, shape (T,3)."
        return np.mean(self.assemble(), axis=1)

    def get_bounds(self):
        "Return (lower, upper) bounds of the mesh."
        return np.min(self.vertices, axis=0), np.max(self.vertices, axis=0)

    def remove_duplicate_vertices(self):
        "Merge identical vertices and remap triangles."
        from chroma_tpu_torch import native
        result = native.dedupe_vertices(self.vertices) \
            if len(self.vertices) > 100000 else None
        if result is not None:
            unique_vertices, inverse = result
        else:
            unique_vertices, inverse = np.unique(
                self.vertices.view([('', self.vertices.dtype)] * 3),
                return_inverse=True)
            unique_vertices = unique_vertices.view(
                self.vertices.dtype).reshape(-1, 3)
        self.vertices = unique_vertices
        self.triangles = inverse.reshape(-1)[self.triangles.reshape(-1)] \
            .reshape(self.triangles.shape).astype(np.int32)

    def remove_null_triangles(self):
        """Drop degenerate triangles (repeated vertex index).

        Returns the retained-triangle mask, for filtering any associated
        per-triangle arrays in a Solid.
        """
        if len(self.triangles) == 0:
            return
        t = self.triangles
        mask = (t[:, 0] != t[:, 1]) & (t[:, 1] != t[:, 2]) & (t[:, 0] != t[:, 2])
        self.triangles = t[mask]
        return mask

    def assemble(self, key=slice(None), group=True):
        """Per-triangle vertex positions: (T,3,3) if group else (3T,3)."""
        if group:
            vertex_indices = self.triangles[key]
        else:
            vertex_indices = self.triangles[key].flatten()
        return self.vertices[vertex_indices]

    def __add__(self, other):
        return Mesh(np.concatenate((self.vertices, other.vertices)),
                    np.concatenate((self.triangles,
                                    other.triangles + len(self.vertices))))

    def __len__(self):
        return len(self.triangles)

    def md5(self):
        "MD5 hash of vertices + triangles (hex string); keys the BVH cache."
        checksum = md5(self.vertices)
        checksum.update(self.triangles)
        return checksum.hexdigest()


def _unique_objects(seq):
    "Order-stable unique() over arbitrary hashable objects."
    seen = {}
    for item in seq:
        if id(item) not in seen:
            seen[id(item)] = item
    return list(seen.values())


def _per_triangle(value, n, dtype=object):
    "Broadcast a scalar or validate an iterable to one entry per triangle."
    if np.iterable(value) and not isinstance(value, (str, bytes)):
        value = np.asarray(value, dtype=dtype) if dtype is not object \
            else np.array(list(value), dtype=object)
        if len(value) != n:
            raise ValueError('shape mismatch')
        return value
    if dtype is object:
        arr = np.empty(n, dtype=object)
        arr[:] = value
        return arr
    return np.full(n, value, dtype=dtype)


class Solid(object):
    """A Mesh with per-triangle inner/outer materials, surface, and color."""

    def __init__(self, mesh, material1=None, material2=None, surface=None,
                 color=0x33ffffff):
        self.mesh = mesh
        n = len(mesh.triangles)
        self.material1 = _per_triangle(material1, n)
        self.material2 = _per_triangle(material2, n)
        self.surface = _per_triangle(surface, n)
        self.color = _per_triangle(color, n, dtype=np.uint32)

        self.unique_materials = _unique_objects(
            list(self.material1) + list(self.material2))
        self.unique_surfaces = _unique_objects(self.surface)

    def __add__(self, other):
        return Solid(self.mesh + other.mesh,
                     np.concatenate((self.material1, other.material1)),
                     np.concatenate((self.material2, other.material2)),
                     np.concatenate((self.surface, other.surface)),
                     np.concatenate((self.color, other.color)))

    def weld(self, other, shared_triangle_surface=None,
             shared_triangle_color=None):
        """Merge `other` into this solid, deduplicating triangles that appear
        in both (as vertex-position sets). Shared triangles keep this solid's
        surface/color unless overridden. Not a boolean union."""
        def tri_keys(solid):
            pts = solid.mesh.vertices[solid.mesh.triangles]  # (T,3,3)
            return [frozenset(map(tuple, tri)) for tri in pts]

        keys_self = tri_keys(self)
        keys_other = tri_keys(other)
        other_index = {}
        for i, k in enumerate(keys_other):
            other_index.setdefault(k, []).append(i)

        mask = np.array([k in other_index for k in keys_self])
        if mask.sum() == 0:
            raise Exception('cannot weld solids with no shared triangles')

        duplicates = sorted({i for k in keys_self for i in other_index.get(k, [])})

        mesh = Mesh(other.mesh.vertices,
                    np.delete(other.mesh.triangles, duplicates, 0))
        self.mesh = self.mesh + mesh
        self.material1 = np.concatenate(
            (self.material1, np.delete(other.material1, duplicates, 0)))
        self.material2 = np.concatenate(
            (self.material2, np.delete(other.material2, duplicates, 0)))
        self.surface = np.concatenate(
            (self.surface, np.delete(other.surface, duplicates, 0)))
        self.color = np.concatenate(
            (self.color, np.delete(other.color, duplicates, 0)))

        # properties at the shared interface
        self.material2[mask] = other.material1[0]
        if shared_triangle_surface is not None:
            self.surface[mask] = shared_triangle_surface
        if shared_triangle_color is not None:
            self.color[mask] = shared_triangle_color

    def material1_indices(self, material_lookup):
        return np.fromiter((material_lookup[id(m)] for m in self.material1),
                           dtype=np.int32, count=len(self.material1))

    def material2_indices(self, material_lookup):
        return np.fromiter((material_lookup[id(m)] for m in self.material2),
                           dtype=np.int32, count=len(self.material2))

    def surface_indices(self, surface_lookup):
        return np.fromiter((surface_lookup[id(s)] for s in self.surface),
                           dtype=np.int32, count=len(self.surface))


class Material(object):
    """Material optical properties.

    Wavelength-dependent properties are (n,2) float32 arrays of
    (wavelength nm, value) pairs, set via .set(). Bulk reemission is
    described by per-component lists (reference: chroma/geometry.py:213-247,
    chroma/cuda/geometry_types.h:4-20).
    """

    def __init__(self, name='none'):
        self.name = name
        self.refractive_index = None
        self.absorption_length = None
        self.scattering_length = None
        self.scintillation_spectrum = None
        self.scintillation_light_yield = None
        self.scintillation_rise_time = None
        self.scintillation_waveform = None
        self.scintillation_mod = None
        self.comp_reemission_prob = []
        self.comp_reemission_wvl_cdf = []
        self.comp_reemission_times = []
        self.comp_reemission_time_cdf = []
        self.comp_absorption_length = []
        self.density = 0.0  # g/cm^3
        self.composition = {}  # by mass

    def set(self, name, value, wavelengths=standard_wavelengths):
        if np.iterable(value):
            if len(value) != len(wavelengths):
                raise ValueError('shape mismatch')
        else:
            value = np.tile(value, len(wavelengths))
        self.__dict__[name] = np.array(list(zip(wavelengths, value)),
                                       dtype=np.float32)

    def __repr__(self):
        return '<Material %s>' % self.name


# Empty material
vacuum = Material('vacuum')
vacuum.set('refractive_index', 1.0)
vacuum.set('absorption_length', 1e6)
vacuum.set('scattering_length', 1e6)


class DichroicProps(object):
    """Angle x wavelength reflect/transmit tables for dichroic surfaces
    (reference: chroma/geometry.py:249-253)."""

    def __init__(self, angles, reflect, transmit):
        self.angles = np.asarray(angles)               # [angle] radians
        self.dichroic_reflect = np.asarray(reflect)    # [angle][(wvl,val)]
        self.dichroic_transmit = np.asarray(transmit)  # [angle][(wvl,val)]


class AngularProps(object):
    """Angle-dependent transmit/reflect tables for angular surfaces
    (reference: chroma/geometry.py:255-260)."""

    def __init__(self, angles, transmit, reflect_specular=None,
                 reflect_diffuse=None):
        self.angles = np.asarray(angles)
        self.transmit = np.asarray(transmit)
        self.reflect_specular = (np.asarray(reflect_specular)
                                 if reflect_specular is not None
                                 else np.zeros_like(self.transmit))
        self.reflect_diffuse = (np.asarray(reflect_diffuse)
                                if reflect_diffuse is not None
                                else np.zeros_like(self.transmit))


class WirePlane(object):
    """Analytic wire-plane primitive: a periodic array of parallel cylinders
    (wires) lying in a plane, intersected analytically instead of via mesh
    triangles (reference: chroma/cuda/geometry_types.h:42-58).

      origin: a point on the plane
      u: unit vector along the wire axes
      v: in-plane unit vector perpendicular to the wires
      pitch: center-to-center wire spacing along v
      radius: wire radius
      umin/umax, vmin/vmax: finite extent in local (u,v) coordinates
      v0: offset of wire centers along v
      material_inner: wire bulk medium; material_outer: surrounding medium
      surface: optional Surface at the wire boundary
    """

    def __init__(self, origin, u, v, pitch, radius, umin, umax, vmin, vmax,
                 v0=0.0, surface=None, material_inner=None,
                 material_outer=None, color=0x33ffffff):
        self.origin = np.asarray(origin, dtype=np.float64)
        self.u = np.asarray(u, dtype=np.float64)
        self.v = np.asarray(v, dtype=np.float64)
        self.pitch = float(pitch)
        self.radius = float(radius)
        self.umin, self.umax = float(umin), float(umax)
        self.vmin, self.vmax = float(vmin), float(vmax)
        self.v0 = float(v0)
        self.surface = surface
        self.material_inner = material_inner
        self.material_outer = material_outer
        self.color = color


class Surface(object):
    """Surface optical properties (reference: chroma/geometry.py:262-295).

    model selects among SURFACE_DEFAULT/COMPLEX/WLS/DICHROIC/ANGULAR.
    """

    def __init__(self, name='none', model=SURFACE_DEFAULT):
        self.name = name
        self.model = model

        self.set('detect', 0)
        self.set('absorb', 0)
        self.set('reemit', 0)
        self.set('reflect_diffuse', 0)
        self.set('reflect_specular', 0)
        self.set('eta', 0)
        self.set('k', 0)
        self.set('reemission_cdf', 0)

        self.dichroic_props = None
        self.angular_props = None

        self.thickness = 0.0
        self.transmissive = 0

    def set(self, name, value, wavelengths=standard_wavelengths):
        if np.iterable(value):
            if len(value) != len(wavelengths):
                raise ValueError('shape mismatch')
        else:
            value = np.tile(value, len(wavelengths))
        if (np.asarray(value) < 0.0).any():
            raise Exception('all probabilities must be >= 0.0')
        self.__dict__[name] = np.array(list(zip(wavelengths, value)),
                                       dtype=np.float32)

    def __repr__(self):
        return '<Surface %s>' % self.name


class Geometry(object):
    """A collection of placed solids, flattened to one triangle soup with
    per-triangle material/surface index arrays (reference:
    chroma/geometry.py:297-391)."""

    def __init__(self, detector_material=None):
        self.detector_material = detector_material
        self.solids = []
        self.solid_rotations = []
        self.solid_displacements = []
        self.wireplanes = []
        self.bvh = None

    def add_solid(self, solid, rotation=None, displacement=None):
        """Add `solid`, to be placed with `rotation` (3x3) then displaced by
        `displacement` (3,) when the geometry is flattened. Returns the
        solid id."""
        if rotation is None:
            rotation = np.identity(3)
        rotation = np.asarray(rotation, dtype=np.float32)
        if rotation.shape != (3, 3):
            raise ValueError('rotation matrix has the wrong shape.')
        self.solid_rotations.append(rotation)

        if displacement is None:
            displacement = np.zeros(3)
        displacement = np.asarray(displacement, dtype=np.float32)
        if displacement.shape != (3,):
            raise ValueError('displacement vector has the wrong shape.')
        self.solid_displacements.append(displacement)

        self.solids.append(solid)
        return len(self.solids) - 1

    def add_wireplane(self, wireplane):
        """Register an analytic WirePlane primitive."""
        self.wireplanes.append(wireplane)
        return len(self.wireplanes) - 1

    def flatten(self):
        """Build the flat triangle-soup arrays: mesh, colors, solid_id,
        material1_index, material2_index, surface_index, unique_materials,
        unique_surfaces. Idempotent."""
        if hasattr(self, 'mesh'):
            return

        nv = np.cumsum([0] + [len(s.mesh.vertices) for s in self.solids])
        nt = np.cumsum([0] + [len(s.mesh.triangles) for s in self.solids])

        vertices = np.empty((nv[-1], 3), dtype=np.float32)
        triangles = np.empty((nt[-1], 3), dtype=np.uint32)

        logger.info('Flattening detector mesh...')
        logger.info('  triangles: %d' % len(triangles))
        logger.info('  vertices:  %d' % len(vertices))

        for i, solid in enumerate(self.solids):
            vertices[nv[i]:nv[i + 1]] = (
                np.inner(solid.mesh.vertices, self.solid_rotations[i])
                + self.solid_displacements[i])
            triangles[nt[i]:nt[i + 1]] = solid.mesh.triangles + nv[i]

        # Distinct solids rarely share vertices, so dedupe once at the end.
        self.mesh = Mesh(vertices, triangles, remove_duplicate_vertices=True,
                         remove_null_triangles=False)

        self.colors = np.concatenate([s.color for s in self.solids])
        self.solid_id = np.concatenate(
            [np.full(len(s.mesh.triangles), i, dtype=np.uint32)
             for i, s in enumerate(self.solids)])

        self.unique_materials = _unique_objects(
            [m for s in self.solids for m in s.unique_materials]
            + [m for wp in self.wireplanes
               for m in (wp.material_inner, wp.material_outer)
               if m is not None])

        material_lookup = {id(m): i
                           for i, m in enumerate(self.unique_materials)}
        self.material1_index = np.concatenate(
            [s.material1_indices(material_lookup) for s in self.solids])
        self.material2_index = np.concatenate(
            [s.material2_indices(material_lookup) for s in self.solids])

        self.unique_surfaces = _unique_objects(
            [surf for s in self.solids for surf in s.unique_surfaces]
            + [wp.surface for wp in self.wireplanes
               if wp.surface is not None])

        surface_lookup = {id(s): i for i, s in enumerate(self.unique_surfaces)}
        self.surface_index = np.concatenate(
            [s.surface_indices(surface_lookup) for s in self.solids])

        # A surface of None means "plain dielectric boundary" -> index -1.
        if None in self.unique_surfaces:
            none_index = surface_lookup[id(None)]
            self.surface_index[self.surface_index == none_index] = -1
