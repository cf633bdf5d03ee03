"""Device geometry for the torch port: dataclasses of tensors.

Counterparts of the flax.struct containers in chroma_tpu.ops.types, built
by the same host code, so every array is bit-for-bit the JAX builder's.
Differences:

  * u32 arrays (packed material codes, colors) are carried as int32 bit
    patterns, since torch's uint32 supports few ops;
  * only the instanced wide BVH is built (no DFS / classic BVH arrays, no
    monolithic wide table): every geometry goes through the instanced
    table, as in chroma_tpu, where flattened meshes become one identity
    instance;
  * the analytic wire planes' (u, v, w) frame is orthonormalised on the
    host, as in chroma_tpu.ops.types.

Every container has `.to(device)`.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from chroma_tpu.geometry import standard_wavelengths, standard_times
from chroma_tpu_torch.bvh.wide import build_instanced_bvh, InstancedBVH

MAT_REFRACTIVE_INDEX = 0
MAT_ABSORPTION_LENGTH = 1
MAT_SCATTERING_LENGTH = 2

SURF_DETECT = 0
SURF_ABSORB = 1
SURF_REEMIT = 2
SURF_REFLECT_DIFFUSE = 3
SURF_REFLECT_SPECULAR = 4
SURF_ETA = 5
SURF_K = 6
SURF_REEMISSION_CDF = 7


def _to(obj, device):
    "Copy every tensor field of a dataclass (recursively) to `device`."
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = v.to(device)
    return dataclasses.replace(obj, **changes)


def _t(a, dtype=None):
    "Host array -> CPU tensor; u32 becomes its int32 bit pattern."
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if dtype is not None:
        a = a.astype(dtype)
    return torch.from_numpy(np.array(a, order='C'))


@dataclasses.dataclass
class MaterialTables:
    props: torch.Tensor      # (n_materials, 3, n_wavelength) f32
    props_wl: torch.Tensor   # (n_wavelength, n_materials, 3) f32
    num_comp: torch.Tensor   # (n_materials,) i32
    comp_absorption_length: torch.Tensor
    comp_reemission_prob: torch.Tensor
    comp_reemission_wvl_cdf: torch.Tensor
    comp_reemission_time_cdf: torch.Tensor
    wavelength0: float
    wavelength_step: float
    n_wavelength: int
    time0: float
    time_step: float
    n_time: int
    max_comp: int
    has_reemission: bool

    to = _to


@dataclasses.dataclass
class SurfaceTables:
    models_present: tuple
    props: torch.Tensor      # (n_surfaces, 8, n_wavelength) f32
    props_wl: torch.Tensor   # (n_wavelength, n_surfaces, 8) f32
    model: torch.Tensor
    transmissive: torch.Tensor
    thickness: torch.Tensor
    dichroic_index: torch.Tensor
    dichroic_angles: torch.Tensor
    dichroic_nangles: torch.Tensor
    dichroic_reflect: torch.Tensor
    dichroic_transmit: torch.Tensor
    angular_index: torch.Tensor
    angular_angles: torch.Tensor
    angular_nangles: torch.Tensor
    angular_transmit: torch.Tensor
    angular_reflect_specular: torch.Tensor
    angular_reflect_diffuse: torch.Tensor

    to = _to


@dataclasses.dataclass
class WirePlaneArrays:
    """Analytic wire-plane parameters, SoA over planes; the (u, v, w)
    frame is orthonormalised on the host so the device math stays in f32
    (see chroma_tpu.ops.types.WirePlaneArrays)."""
    origin: torch.Tensor  # (P,3) f32
    u: torch.Tensor       # (P,3) f32 unit wire axis
    v: torch.Tensor       # (P,3) f32 unit in-plane normal to the wires
    w: torch.Tensor       # (P,3) f32 plane normal (u x v)
    pitch: torch.Tensor   # (P,) f32
    radius: torch.Tensor
    umin: torch.Tensor
    umax: torch.Tensor
    vmin: torch.Tensor
    vmax: torch.Tensor
    v0: torch.Tensor
    surface_index: torch.Tensor         # (P,) i32, -1 = no surface
    material_inner_index: torch.Tensor  # (P,) i32
    material_outer_index: torch.Tensor  # (P,) i32

    to = _to


@dataclasses.dataclass
class DetectorArrays:
    solid_id_to_channel_index: torch.Tensor  # (n_solids,) i32
    time_cdf_x: torch.Tensor
    time_cdf_y: torch.Tensor
    charge_cdf_x: torch.Tensor
    charge_cdf_y: torch.Tensor
    charge_unit: torch.Tensor   # () f32
    nchannels: int

    to = _to


@dataclasses.dataclass
class InstanceArrays:
    """Per-instance lean geometry (see chroma_tpu.ops.types.InstanceArrays):
    instance i owns triangles [tri_base[i], tri_base[i+1]) and IS solid i."""
    tri_base: torch.Tensor   # (n_inst+1,) i32
    soup_off: torch.Tensor   # (n_inst,) i32
    rot_n: torch.Tensor      # (n_inst, 9) f32 det(R) * R_local->world
    codes_u: torch.Tensor    # (U,) i32 (u32 bit patterns)
    normals_u: torch.Tensor  # (U, 3) f32
    n_instances: int

    to = _to


@dataclasses.dataclass
class GeometryArrays:
    """The device geometry. The per-triangle world-frame arrays are None
    for lean instanced geometries; `inst` is None for flattened-only
    geometries (one identity instance over the whole soup)."""
    vertices: torch.Tensor | None        # (V,3) f32
    triangles: torch.Tensor | None       # (T,3) i32
    tri_normals: torch.Tensor | None     # (T,3) f32
    material_codes: torch.Tensor | None  # (T,) i32 (u32 bit patterns)
    colors: torch.Tensor | None          # (T,) i32 (u32 bit patterns)
    solid_id: torch.Tensor | None        # (T,) i32
    wide: InstancedBVH
    inst: InstanceArrays | None
    materials: MaterialTables
    surfaces: SurfaceTables
    wireplanes: WirePlaneArrays | None
    detector: DetectorArrays | None

    to = _to

    @property
    def has_wireplanes(self):
        return self.wireplanes is not None


def _interp_property(prop, grid):
    "Resample a (wavelength, value) pair table onto a uniform grid."
    if prop is None:
        raise ValueError('material/surface property must not be None')
    return np.interp(grid, prop[:, 0], prop[:, 1]).astype(np.float32)


def build_material_tables(materials, wavelengths=None, times=None):
    if wavelengths is None:
        wavelengths = standard_wavelengths
    if times is None:
        times = standard_times
    n_wl = len(wavelengths)
    n_t = len(times)
    n_mat = len(materials)
    max_comp = max([len(m.comp_reemission_prob) for m in materials] + [1])

    props = np.zeros((n_mat, 3, n_wl), dtype=np.float32)
    num_comp = np.zeros(n_mat, dtype=np.int32)
    comp_abs = np.full((n_mat, max_comp, n_wl), np.inf, dtype=np.float32)
    comp_prob = np.zeros((n_mat, max_comp, n_wl), dtype=np.float32)
    comp_wvl = np.zeros((n_mat, max_comp, n_wl), dtype=np.float32)
    comp_time = np.zeros((n_mat, max_comp, n_t), dtype=np.float32)

    for i, m in enumerate(materials):
        if m is None:
            raise ValueError('one or more triangles is missing a material.')
        props[i, MAT_REFRACTIVE_INDEX] = _interp_property(
            m.refractive_index, wavelengths)
        props[i, MAT_ABSORPTION_LENGTH] = _interp_property(
            m.absorption_length, wavelengths)
        props[i, MAT_SCATTERING_LENGTH] = _interp_property(
            m.scattering_length, wavelengths)
        nc = len(m.comp_reemission_prob)
        num_comp[i] = nc
        for c in range(nc):
            comp_prob[i, c] = _interp_property(m.comp_reemission_prob[c],
                                               wavelengths)
            comp_wvl[i, c] = _interp_property(m.comp_reemission_wvl_cdf[c],
                                              wavelengths)
            comp_time[i, c] = _interp_property(m.comp_reemission_time_cdf[c],
                                               times)
            comp_abs[i, c] = _interp_property(m.comp_absorption_length[c],
                                              wavelengths)

    return MaterialTables(
        props=_t(props),
        props_wl=_t(props.transpose(2, 0, 1)),
        num_comp=_t(num_comp),
        comp_absorption_length=_t(comp_abs),
        comp_reemission_prob=_t(comp_prob),
        comp_reemission_wvl_cdf=_t(comp_wvl),
        comp_reemission_time_cdf=_t(comp_time),
        wavelength0=float(wavelengths[0]),
        wavelength_step=float(wavelengths[1] - wavelengths[0]),
        n_wavelength=n_wl,
        time0=float(times[0]),
        time_step=float(times[1] - times[0]),
        n_time=n_t,
        max_comp=max_comp,
        has_reemission=bool((num_comp > 0).any()),
    )


def build_surface_tables(surfaces, wavelengths=None):
    if wavelengths is None:
        wavelengths = standard_wavelengths
    n_wl = len(wavelengths)
    n_surf = max(len(surfaces), 1)

    props = np.zeros((n_surf, 8, n_wl), dtype=np.float32)
    model = np.zeros(n_surf, dtype=np.int32)
    transmissive = np.zeros(n_surf, dtype=np.int32)
    thickness = np.zeros(n_surf, dtype=np.float32)
    dichroic_index = np.full(n_surf, -1, dtype=np.int32)
    angular_index = np.full(n_surf, -1, dtype=np.int32)

    dichroics = []
    angulars = []

    prop_names = ['detect', 'absorb', 'reemit', 'reflect_diffuse',
                  'reflect_specular', 'eta', 'k', 'reemission_cdf']

    for i, s in enumerate(surfaces):
        if s is None:
            continue
        for j, name in enumerate(prop_names):
            props[i, j] = _interp_property(getattr(s, name), wavelengths)
        model[i] = s.model
        transmissive[i] = int(bool(getattr(s, 'transmissive', 0)))
        thickness[i] = float(getattr(s, 'thickness', 0.0))
        if s.dichroic_props is not None:
            dichroic_index[i] = len(dichroics)
            dichroics.append(s.dichroic_props)
        if s.angular_props is not None:
            angular_index[i] = len(angulars)
            angulars.append(s.angular_props)

    def pad_dichroic():
        n = max(len(dichroics), 1)
        max_ang = max([len(d.angles) for d in dichroics] + [2])
        angles = np.full((n, max_ang), np.inf, dtype=np.float32)
        nang = np.full(n, 2, dtype=np.int32)
        refl = np.zeros((n, max_ang, n_wl), dtype=np.float32)
        trans = np.zeros((n, max_ang, n_wl), dtype=np.float32)
        for k, d in enumerate(dichroics):
            na = len(d.angles)
            nang[k] = na
            angles[k, :na] = d.angles
            for a in range(na):
                refl[k, a] = _interp_property(
                    np.asarray(d.dichroic_reflect[a]), wavelengths)
                trans[k, a] = _interp_property(
                    np.asarray(d.dichroic_transmit[a]), wavelengths)
        return angles, nang, refl, trans

    def pad_angular():
        n = max(len(angulars), 1)
        max_ang = max([len(a.angles) for a in angulars] + [2])
        angles = np.full((n, max_ang), np.inf, dtype=np.float32)
        nang = np.full(n, 2, dtype=np.int32)
        trans = np.zeros((n, max_ang), dtype=np.float32)
        rspec = np.zeros((n, max_ang), dtype=np.float32)
        rdiff = np.zeros((n, max_ang), dtype=np.float32)
        for k, a in enumerate(angulars):
            na = len(a.angles)
            nang[k] = na
            angles[k, :na] = a.angles
            trans[k, :na] = a.transmit
            rspec[k, :na] = a.reflect_specular
            rdiff[k, :na] = a.reflect_diffuse
        return angles, nang, trans, rspec, rdiff

    d_ang, d_n, d_refl, d_trans = pad_dichroic()
    a_ang, a_n, a_trans, a_rspec, a_rdiff = pad_angular()

    return SurfaceTables(
        models_present=tuple(sorted(set(int(m) for m in model))),
        props=_t(props),
        props_wl=_t(props.transpose(2, 0, 1)),
        model=_t(model),
        transmissive=_t(transmissive),
        thickness=_t(thickness),
        dichroic_index=_t(dichroic_index),
        dichroic_angles=_t(d_ang),
        dichroic_nangles=_t(d_n),
        dichroic_reflect=_t(d_refl),
        dichroic_transmit=_t(d_trans),
        angular_index=_t(angular_index),
        angular_angles=_t(a_ang),
        angular_nangles=_t(a_n),
        angular_transmit=_t(a_trans),
        angular_reflect_specular=_t(a_rspec),
        angular_reflect_diffuse=_t(a_rdiff),
    )


def pack_material_codes(material1_index, material2_index, surface_index):
    """The reference's packed per-triangle code word (u32, host numpy):
    (material1 << 24) | (material2 << 16) | (surface << 8)."""
    return (((material1_index.astype(np.uint32) & 0xff) << 24)
            | ((material2_index.astype(np.uint32) & 0xff) << 16)
            | ((surface_index.astype(np.uint32) & 0xff) << 8))


def _orthonormal_frame(u, v):
    "Gram-Schmidt (u, v) -> orthonormal (u, v, w=u x v), in f64."
    u = np.asarray(u, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    u = u / np.linalg.norm(u)
    v = v - np.dot(v, u) * u
    v = v / np.linalg.norm(v)
    return u, v, np.cross(u, v)


def build_wireplane_arrays(wireplanes, material_lookup, surface_lookup):
    """The wire planes of a geometry as WirePlaneArrays (None without
    any); `*_lookup` map id(material or surface) to its table index."""
    if not wireplanes:
        return None
    P = len(wireplanes)
    scalars = ('pitch', 'radius', 'umin', 'umax', 'vmin', 'vmax', 'v0')
    fields = {name: np.zeros(P, dtype=np.float32) for name in scalars}
    frame = {name: np.zeros((P, 3), dtype=np.float32)
             for name in ('origin', 'u', 'v', 'w')}
    surface_index = np.full(P, -1, dtype=np.int32)
    mat_inner = np.zeros(P, dtype=np.int32)
    mat_outer = np.zeros(P, dtype=np.int32)

    for i, wp in enumerate(wireplanes):
        frame['origin'][i] = wp.origin
        frame['u'][i], frame['v'][i], frame['w'][i] = \
            _orthonormal_frame(wp.u, wp.v)
        for name in scalars:
            fields[name][i] = getattr(wp, name)
        if wp.surface is not None:
            surface_index[i] = surface_lookup[id(wp.surface)]
        mat_inner[i] = material_lookup[id(wp.material_inner)]
        mat_outer[i] = material_lookup[id(wp.material_outer)]

    return WirePlaneArrays(
        **{k: _t(v) for k, v in frame.items()},
        **{k: _t(v) for k, v in fields.items()},
        surface_index=_t(surface_index),
        material_inner_index=_t(mat_inner),
        material_outer_index=_t(mat_outer))


def build_detector_arrays(detector):
    """Channel map + time/charge CDFs; charge_unit quantizes summed charge
    to 16 bits like the reference DAQ."""
    if not hasattr(detector, 'num_channels') or detector.num_channels() == 0:
        return None
    time_cdf_x, time_cdf_y = detector.time_cdf
    charge_cdf_x, charge_cdf_y = detector.charge_cdf
    charge_unit = float(np.max(charge_cdf_x)) / (2 ** 16)
    return DetectorArrays(
        solid_id_to_channel_index=_t(detector.solid_id_to_channel_index,
                                     np.int32),
        time_cdf_x=_t(time_cdf_x, np.float32),
        time_cdf_y=_t(time_cdf_y, np.float32),
        charge_cdf_x=_t(charge_cdf_x, np.float32),
        charge_cdf_y=_t(charge_cdf_y, np.float32),
        charge_unit=torch.tensor(charge_unit, dtype=torch.float32),
        nchannels=int(detector.num_channels()),
    )


def build_instance_arrays(meta, material_codes):
    """Lean per-instance arrays from build_instanced_bvh metadata: instances
    grouped into a deduplicated soup keyed by (unique mesh, codes)."""
    mesh_index = meta['mesh_index']
    rot_l2w = meta['rot_l2w']
    tri_base = meta['tri_base']
    unique_meshes = meta['unique_meshes']
    n_inst = len(mesh_index)

    counts = np.asarray(
        [len(unique_meshes[mi].triangles) for mi in mesh_index], np.int64)

    group_of = np.empty(n_inst, np.int64)
    group_key = {}
    group_rep = []
    for i in range(n_inst):
        codes = material_codes[tri_base[i]:tri_base[i] + counts[i]]
        key = (int(mesh_index[i]), codes.tobytes())
        g = group_key.setdefault(key, len(group_rep))
        if g == len(group_rep):
            group_rep.append(i)
        group_of[i] = g

    ubase = np.cumsum([0] + [counts[r] for r in group_rep])
    codes_u = np.empty(ubase[-1], np.uint32)
    normals_u = np.empty((ubase[-1], 3), np.float32)
    for g, r in enumerate(group_rep):
        s = slice(ubase[g], ubase[g + 1])
        codes_u[s] = material_codes[tri_base[r]:tri_base[r] + counts[r]]
        mesh = unique_meshes[mesh_index[r]]
        pts = mesh.vertices[mesh.triangles.astype(np.int64)]
        raw = np.cross(pts[:, 1] - pts[:, 0], pts[:, 2] - pts[:, 1])
        ln = np.linalg.norm(raw, axis=1, keepdims=True)
        normals_u[s] = (raw / np.where(ln > 0, ln, 1.0)).astype(np.float32)

    det = np.linalg.det(rot_l2w.astype(np.float64)).astype(np.float32)
    rot_n = (rot_l2w * det[:, None, None]).reshape(n_inst, 9)

    soup_off = (ubase[group_of] - tri_base).astype(np.int32)
    bases = np.concatenate(
        [tri_base, [tri_base[-1] + counts[-1]]]).astype(np.int32)

    return InstanceArrays(
        tri_base=_t(bases),
        soup_off=_t(soup_off),
        rot_n=_t(rot_n.astype(np.float32)),
        codes_u=_t(codes_u),
        normals_u=_t(normals_u),
        n_instances=n_inst,
    )


def build_geometry_arrays(geometry, wavelengths=None, times=None):
    """Marshal a host Geometry/Detector into the port's device arrays (on
    the CPU; move them with `.to(device)`). Same choices as
    chroma_tpu.ops.types.build_geometry_arrays: placed solids sharing a
    mesh share one BLAS; a flattened-only geometry becomes one identity
    instance; lean (no per-triangle arrays) by default from 5M triangles.
    No BVH needs to be attached to `geometry`."""
    if not hasattr(geometry, 'mesh'):
        geometry.flatten()

    materials = list(geometry.unique_materials)
    surfaces = list(geometry.unique_surfaces)
    material_lookup = {id(m): i for i, m in enumerate(materials)}
    surface_lookup = {id(s): i for i, s in enumerate(surfaces)}

    material_codes = pack_material_codes(geometry.material1_index,
                                         geometry.material2_index,
                                         geometry.surface_index)

    solids = getattr(geometry, 'solids', None) or []
    n_solid_tris = sum(len(s.mesh.triangles) for s in solids)
    inst_arrays = None
    if (solids and not os.environ.get('CHROMA_NO_INSTANCING')
            and n_solid_tris == len(geometry.mesh.triangles)):
        tri_base = np.cumsum([0] + [len(s.mesh.triangles) for s in solids])
        instances = [
            (s.mesh, geometry.solid_rotations[i],
             geometry.solid_displacements[i], int(tri_base[i]))
            for i, s in enumerate(solids)]
        wide, inst_meta = build_instanced_bvh(
            instances, want_meta=True, material_codes=material_codes)
        inst_arrays = build_instance_arrays(inst_meta, material_codes)
    else:
        wide = build_instanced_bvh([(geometry.mesh, None, None, 0)],
                                   material_codes=material_codes)

    env = os.environ.get('CHROMA_LEAN')
    if env is not None:
        lean = env != '0'
    else:
        lean = len(geometry.mesh.triangles) >= 5_000_000
    lean = lean and inst_arrays is not None

    if lean:
        vertices = triangles = tri_normals = codes = colors = None
        solid_id = None
    else:
        tri_pts = geometry.mesh.vertices[geometry.mesh.triangles]
        raw_normals = np.cross(tri_pts[:, 1] - tri_pts[:, 0],
                               tri_pts[:, 2] - tri_pts[:, 1])
        lengths = np.linalg.norm(raw_normals, axis=1, keepdims=True)
        tri_normals = _t((raw_normals / np.where(lengths > 0, lengths, 1.0))
                         .astype(np.float32))
        vertices = _t(geometry.mesh.vertices, np.float32)
        triangles = _t(geometry.mesh.triangles, np.int32)
        codes = _t(material_codes)
        colors = _t(geometry.colors.astype(np.uint32))
        solid_id = _t(geometry.solid_id, np.int32)

    return GeometryArrays(
        vertices=vertices,
        triangles=triangles,
        tri_normals=tri_normals,
        material_codes=codes,
        colors=colors,
        solid_id=solid_id,
        wide=wide,
        inst=inst_arrays,
        materials=build_material_tables(materials, wavelengths, times),
        surfaces=build_surface_tables(surfaces, wavelengths),
        wireplanes=build_wireplane_arrays(
            getattr(geometry, 'wireplanes', None), material_lookup,
            surface_lookup),
        detector=build_detector_arrays(geometry),
    )


def _from_jax_struct(cls, src, **override):
    "Build port dataclass `cls` from a JAX struct's same-named fields."
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in override:
            kw[f.name] = override[f.name]
            continue
        v = getattr(src, f.name)
        if isinstance(v, (bool, int, float, str, tuple)) or v is None:
            kw[f.name] = v
        else:
            kw[f.name] = _t(v)
    return cls(**kw)


def from_jax_arrays(ga):
    """The port's GeometryArrays from a chroma_tpu GeometryArrays (the JAX
    device arrays are read with np.asarray, field by field). Carries a
    geometry built once by the JAX package across to the port; the DFS
    arrays are dropped, as in build_geometry_arrays. Needs no jax import
    of its own."""
    if ga.wide is None or not hasattr(ga.wide, 'n_instances'):
        raise NotImplementedError('the torch port traverses instanced wide '
                                  'BVHs only')
    w = ga.wide
    wide = InstancedBVH(rows=_t(w.rows), max_depth=w.max_depth,
                        fanout=w.fanout, leaf_size=w.leaf_size,
                        n_instances=w.n_instances, packed=w.packed,
                        bounds_fmt=w.bounds_fmt)
    inst = None if ga.inst is None else \
        _from_jax_struct(InstanceArrays, ga.inst)
    det = None if ga.detector is None else \
        _from_jax_struct(DetectorArrays, ga.detector)
    wires = None if ga.wireplanes is None else \
        _from_jax_struct(WirePlaneArrays, ga.wireplanes)

    def arr(name):
        v = getattr(ga, name)
        return None if v is None else _t(v)

    return GeometryArrays(
        vertices=arr('vertices'), triangles=arr('triangles'),
        tri_normals=arr('tri_normals'), material_codes=arr('material_codes'),
        colors=arr('colors'), solid_id=arr('solid_id'),
        wide=wide, inst=inst,
        materials=_from_jax_struct(MaterialTables, ga.materials),
        surfaces=_from_jax_struct(SurfaceTables, ga.surfaces),
        wireplanes=wires, detector=det)
