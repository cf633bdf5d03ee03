"""The port's GDML import (gdml/, csg.py): the cases of tests/test_gdml.py
run on the port, and each copy held bit for bit to its original -- every
primitive of mesh_gen, the BSP booleans, a boolean solid of a GDML file,
and the GeometryArrays of the detector that GDMLLoader builds, each side
from its own package. The GDML detector also simulates on the port."""
import importlib

import numpy as np
import pytest
import torch

from chroma_tpu.ops import types as jtypes
import chroma_tpu_torch
from chroma_tpu_torch.ops import types as ttypes

from test_gdml import BOOL_GDML, GDML
from test_torch_host import (J, T, _assert_struct,  # noqa: F401
                             fresh_perf_cache, same_native_kit)

torch.set_num_threads(2)

PKGS = ['chroma_tpu', 'chroma_tpu_torch']


def mod(pkg, name):
    return importlib.import_module(pkg + '.' + name)


def _closed(mesh):
    "Every edge shared by exactly two triangles."
    tris = np.sort(
        np.stack([mesh.triangles[:, [0, 1]], mesh.triangles[:, [1, 2]],
                  mesh.triangles[:, [2, 0]]]).reshape(-1, 2), axis=1)
    _, counts = np.unique(tris, axis=0, return_counts=True)
    return (counts == 2).all()


def _same_mesh(a, b):
    for field in ('vertices', 'triangles'):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.shape == y.shape, field
        assert x.tobytes() == y.tobytes(), field


PRIMITIVES = {
    'box': lambda g: g.box(20.0, 30.0, 40.0),
    'tube': lambda g: g.tube(0, 10, 20),
    'tube_hollow': lambda g: g.tube(5, 10, 20),
    'tube_section': lambda g: g.tube(5, 10, 20, 0.3, 2.0),
    'eltube': lambda g: g.eltube(3, 5, 10),
    'orb': lambda g: g.orb(10.0, nsteps=16),
    'sphere': lambda g: g.sphere(0, 10),
    'sphere_shell': lambda g: g.sphere(5, 10),
    'polycone': lambda g: g.polycone(
        0, 2 * np.pi, [(0, 5, -10), (0, 8, 0), (0, 3, 10)]),
    'polyhedra': lambda g: g.polyhedra(
        0, 2 * np.pi, 6, [(0, 5, -10), (0, 8, 0), (0, 3, 10)]),
    'torus': lambda g: g.torus(0, 2, 10),
    'trd': lambda g: g.trd(5, 3, 4, 2, 6),
}
CLOSED = ('tube', 'tube_hollow', 'sphere', 'sphere_shell', 'polycone',
          'torus', 'eltube', 'trd')


@pytest.mark.parametrize('name', sorted(PRIMITIVES))
def test_primitive_meshes(name):
    """Every mesh_gen primitive: the port's mesh equals the original's,
    is the port's own Mesh, and (test_gdml's list) is a closed surface."""
    mesh = PRIMITIVES[name](mod(PKGS[1], 'gdml.mesh_gen'))
    assert type(mesh).__module__ == 'chroma_tpu_torch.geometry'
    assert len(mesh.triangles) > 0
    if name in CLOSED:
        assert _closed(mesh), name
    _same_mesh(PRIMITIVES[name](mod(PKGS[0], 'gdml.mesh_gen')), mesh)


def test_tube_dimensions():
    mesh = mod(PKGS[1], 'gdml.mesh_gen').tube(0, 1000, 2000)
    lo, hi = mesh.get_bounds()
    np.testing.assert_allclose(hi[2] - lo[2], 2000, rtol=1e-6)
    assert abs(hi[0] - 1000) < 1e-3


def _classifier(pkg, surfaces=False):
    """test_gdml's classifier; with `surfaces`, the ball is a photocathode
    and the tank's wall black, so a bomb in the tank is read out."""
    optics = mod(pkg, 'demo.optics')
    pmt_surface = optics.r7081hqe_photocathode if surfaces else None
    wall = optics.black_surface if surfaces else None

    def classifier(volume_ref, material_ref, parent_material_ref):
        if volume_ref == 'pmt_log':
            return 'pmt', dict(material1=optics.vacuum,
                               material2=optics.water, surface=pmt_surface,
                               channel_type=0)
        if volume_ref == 'world_log':
            return 'omit', dict()
        return 'solid', dict(material1=optics.water,
                             material2=optics.vacuum, surface=wall)
    return classifier


def _gdml_detector(pkg, path, surfaces=False):
    loader = mod(pkg, 'gdml').GDMLLoader(path)
    assert loader.world.name == 'world_log'
    det = loader.build_detector(
        volume_classifier=_classifier(pkg, surfaces))
    det.flatten()
    return det


@pytest.fixture
def gdml_file(tmp_path):
    path = tmp_path / 'detector.gdml'
    path.write_text(GDML)
    return str(path)


def test_gdml_loader_builds_detector(gdml_file):
    det = _gdml_detector(PKGS[1], gdml_file)
    assert type(det).__module__ == 'chroma_tpu_torch.detector'
    assert det.num_channels() == 1
    assert len(det.mesh.triangles) > 100
    # the PMT was displaced to z=400 and sits inside the tank
    pmt_tris = det.solid_id == det.channel_index_to_solid_id[0]
    pmt_verts = det.mesh.vertices[np.unique(det.mesh.triangles[pmt_tris])]
    np.testing.assert_allclose(pmt_verts.mean(axis=0), [0, 0, 400], atol=1.0)


def test_gdml_detector_bitwise_and_simulates(gdml_file):
    """The detector each package's loader builds from one file marshals to
    the same bits, and a bomb inside the port's tank reaches its PMT."""
    det_j = _gdml_detector(PKGS[0], gdml_file, surfaces=True)
    det_t = _gdml_detector(PKGS[1], gdml_file, surfaces=True)
    _same_mesh(det_j.mesh, det_t.mesh)
    for det in (det_j, det_t):
        det.set_time_dist_gaussian(1.2, -6.0, 6.0)
        det.set_charge_dist_gaussian(1.0, 0.1, 0.5, 1.5)
    _assert_struct(jtypes.build_geometry_arrays(det_j),
                   ttypes.build_geometry_arrays(det_t), 'ga')
    sim = chroma_tpu_torch.Simulation(det_t, seed=2, device='cpu')
    np.random.seed(2)
    ev = next(sim.simulate(T.photon_bomb(5000, 400.0, (0, 0, 0)),
                           keep_photons_end=True, run_daq=True,
                           max_steps=20))
    flags = ev.photons_end.flags
    assert (flags & T.event.NAN_ABORT).sum() == 0
    # the wall absorbs most photons; the ball (1% of the solid angle,
    # ~30% efficient) detects some, and its channel reads out
    assert ((flags & T.event.SURFACE_ABSORB) != 0).mean() > 0.8
    detected = (flags & T.event.SURFACE_DETECT) != 0
    assert 3 <= detected.sum() <= 100
    last = ev.photons_end.last_hit_triangles[detected]
    assert (det_t.solid_id[last] == det_t.channel_index_to_solid_id[0]).all()
    assert ev.channels.hit.tolist() == [True]


def _overlapping_boxes(pkg):
    gen = mod(pkg, 'gdml.mesh_gen')
    a = gen.box(20.0, 20.0, 20.0)              # [-10, 10]^3
    b_raw = gen.box(20.0, 20.0, 20.0)
    b = mod(pkg, 'geometry').Mesh(
        b_raw.vertices + np.array([10.0, 0, 0], dtype=np.float32),
        b_raw.triangles)                        # [0, 20] x [-10,10]^2
    return a, b


@pytest.mark.parametrize('op,volume', [('union', 12000.0),
                                       ('subtraction', 4000.0),
                                       ('intersection', 4000.0)])
def test_csg_boolean_volumes(op, volume):
    """BSP mesh booleans against analytic volumes of overlapping boxes,
    and against the original's output."""
    out = []
    for pkg in PKGS:
        csg = mod(pkg, 'csg')
        out.append(csg.mesh_boolean(op, *_overlapping_boxes(pkg)))
    assert abs(mod(PKGS[1], 'csg').mesh_volume(out[1]) - volume) < 1.0
    assert type(out[1]).__module__ == 'chroma_tpu_torch.geometry'
    _same_mesh(*out)


def test_csg_named_operations_match_mesh_boolean():
    csg = mod(PKGS[1], 'csg')
    a, b = _overlapping_boxes(PKGS[1])
    for op, fn in (('union', csg.mesh_union),
                   ('subtraction', csg.mesh_subtract),
                   ('intersection', csg.mesh_intersect)):
        _same_mesh(fn(a, b), csg.mesh_boolean(op, a, b))
    with pytest.raises(Exception):
        csg.mesh_boolean('xor', a, b)


def test_gdml_boolean_solid(tmp_path):
    "A subtraction solid loads, meshes, and has the drilled volume."
    path = tmp_path / 'bool.gdml'
    path.write_text(BOOL_GDML)
    meshes = [mod(pkg, 'gdml').GDMLLoader(str(path)).get_mesh('holey_slab')
              for pkg in PKGS]
    expect = 300.0 * 300 * 100 - np.pi * 50 ** 2 * 100
    vol = mod(PKGS[1], 'csg').mesh_volume(meshes[1])
    # the tessellated drill (32-gon) removes slightly less than a true
    # cylinder
    assert abs(vol - expect) / expect < 0.02
    _same_mesh(*meshes)


def test_unknown_solid_raises(tmp_path):
    path = tmp_path / 'bad.gdml'
    path.write_text(GDML.replace('<orb name="pmt_ball" lunit="mm" r="100"/>',
                                 '<hype name="pmt_ball" lunit="mm"/>'))
    loader = mod(PKGS[1], 'gdml').GDMLLoader(str(path))
    with pytest.raises(NotImplementedError):
        loader.get_mesh('pmt_ball')
