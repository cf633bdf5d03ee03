"""The torch port's host builders against the JAX package's.

The port copies the instanced-table builder and the geometry-array
builders (the JAX modules import jax at their top), and the host modules
they read (geometry, make, demo, native), so their output must be
bit-for-bit the JAX output: the instanced rows in every bounds format, and
every GeometryArrays field, directly and through from_jax_arrays. Each
side builds the geometry from its own package, with the same function and
arguments."""
from importlib import import_module

import numpy as np
import pytest
import torch

from chroma_tpu.bvh import wide as jwide
from chroma_tpu.ops import types as jtypes
from chroma_tpu_torch.bvh import wide as twide
from chroma_tpu_torch.ops import types as ttypes

from test_torch_host import (_assert_bitwise, _assert_struct,  # noqa: F401
                             same_native_kit)

torch.set_num_threads(2)

FORMATS = {'f32': (0, 'f32'), 'bf16': (32, 'bf16'), 'q8': (32, 'q8')}


def _fixture_instances(pkg, types):
    "The visit-kernel fixture geometry by package `pkg`, as instances."
    geometry = import_module(pkg + '.geometry')
    optics = import_module(pkg + '.demo.optics')
    make = import_module(pkg + '.make')
    water, glass = optics.water, optics.glass
    geo = geometry.Geometry(water)
    geo.add_solid(geometry.Solid(make.box(100.0, 80.0, 60.0), glass, water))
    geo.add_solid(geometry.Solid(make.sphere(30.0, nsteps=24), glass, water),
                  displacement=(120.0, 0.0, 0.0))
    geo.add_solid(geometry.Solid(make.box(40.0, 40.0, 40.0), glass, water),
                  displacement=(-120.0, 30.0, 0.0))
    geo.flatten()
    codes = types.pack_material_codes(geo.material1_index,
                                      geo.material2_index,
                                      geo.surface_index)
    tri_base = np.cumsum([0] + [len(s.mesh.triangles) for s in geo.solids])
    return [(s.mesh, geo.solid_rotations[i], geo.solid_displacements[i],
             int(tri_base[i])) for i, s in enumerate(geo.solids)], codes


@pytest.fixture(scope='module')
def fixture_instances():
    "(JAX-built, port-built) instances and codes of the same geometry."
    return (_fixture_instances('chroma_tpu', jtypes),
            _fixture_instances('chroma_tpu_torch', ttypes))


@pytest.mark.parametrize('fmt', ['f32', 'bf16', 'q8'])
def test_instanced_rows_bitwise(fixture_instances, fmt):
    (j_inst, j_codes), (t_inst, t_codes) = fixture_instances
    _assert_bitwise(j_codes, torch.from_numpy(t_codes.view(np.int32)),
                    'codes')
    pf, bf = FORMATS[fmt]
    jw, jmeta = jwide.build_instanced_bvh(j_inst, material_codes=j_codes,
                                          packed_fanout=pf, bounds_fmt=bf,
                                          want_meta=True)
    tw, tmeta = twide.build_instanced_bvh(t_inst, material_codes=t_codes,
                                          packed_fanout=pf, bounds_fmt=bf,
                                          want_meta=True)
    _assert_bitwise(jw.rows, tw.rows, 'rows')
    for name in ('max_depth', 'fanout', 'leaf_size', 'n_instances',
                 'packed', 'bounds_fmt'):
        assert getattr(tw, name) == getattr(jw, name), name
    for name in ('mesh_index', 'rot_l2w', 'tri_base'):
        np.testing.assert_array_equal(tmeta[name], jmeta[name])
    assert twide.table_stats(tw.rows.numpy(), tw.fanout, tw.leaf_size,
                             fmt) == jwide.table_stats(
        np.asarray(jw.rows), jw.fanout, jw.leaf_size, fmt)


def test_flattened_mesh_is_one_identity_instance():
    "A geometry with no live solids builds one instance over its soup."
    def soup(pkg):
        geometry = import_module(pkg + '.geometry')
        optics = import_module(pkg + '.demo.optics')
        make = import_module(pkg + '.make')
        geo = geometry.Geometry(optics.water)
        geo.add_solid(geometry.Solid(make.sphere(50.0, nsteps=16),
                                     optics.glass, optics.water))
        geo.flatten()
        geo.solids = []
        return geo
    ga_j = jtypes.build_geometry_arrays(soup('chroma_tpu'))
    ga_t = ttypes.build_geometry_arrays(soup('chroma_tpu_torch'))
    assert ga_t.inst is None and ga_t.wide.n_instances == 1
    _assert_bitwise(ga_j.wide.rows, ga_t.wide.rows, 'rows')


@pytest.fixture(scope='module')
def tiny_arrays():
    "demo.tiny() built and marshalled by each package."
    out = []
    for pkg, types in (('chroma_tpu', jtypes), ('chroma_tpu_torch', ttypes)):
        geo = import_module(pkg + '.demo').tiny()
        geo.flatten()
        out.append(types.build_geometry_arrays(geo))
    return tuple(out)


def test_tiny_geometry_arrays_bitwise(tiny_arrays):
    ga_j, ga_t = tiny_arrays
    assert ga_t.inst is not None and ga_t.wide.bounds_fmt == 'bf16'
    _assert_struct(ga_j, ga_t, 'ga')


def test_from_jax_arrays_bitwise(tiny_arrays):
    ga_j, ga_t = tiny_arrays
    _assert_struct(ga_t, ttypes.from_jax_arrays(ga_j), 'ga')
