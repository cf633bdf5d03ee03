"""The torch port's host builders against the JAX package's.

The port copies the instanced-table builder and the geometry-array
builders (the JAX modules import jax at their top), so their output must
be bit-for-bit the JAX output: the instanced rows in every bounds format,
and every GeometryArrays field, directly and through from_jax_arrays."""
import dataclasses

import numpy as np
import pytest
import torch

from chroma_tpu import demo
from chroma_tpu.geometry import Geometry, Solid
from chroma_tpu.demo.optics import water, glass
from chroma_tpu.make import box, sphere
from chroma_tpu.bvh import wide as jwide
from chroma_tpu.ops import types as jtypes
from chroma_tpu_torch.bvh import wide as twide
from chroma_tpu_torch.ops import types as ttypes

torch.set_num_threads(2)

FORMATS = {'f32': (0, 'f32'), 'bf16': (32, 'bf16'), 'q8': (32, 'q8')}


def _bits(a):
    "Host array with u32 read as its int32 bit pattern."
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _assert_bitwise(jax_value, torch_value, name):
    a = _bits(jax_value)
    b = torch_value.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, \
        '%s: %s%s vs %s%s' % (name, a.dtype, a.shape, b.dtype, b.shape)
    assert a.tobytes() == b.tobytes(), '%s differs' % name


def _assert_struct(jax_struct, torch_struct, prefix):
    for f in dataclasses.fields(torch_struct):
        tv = getattr(torch_struct, f.name)
        jv = getattr(jax_struct, f.name)
        name = prefix + '.' + f.name
        if isinstance(tv, torch.Tensor):
            _assert_bitwise(jv, tv, name)
        elif dataclasses.is_dataclass(tv):
            _assert_struct(jv, tv, name)
        else:
            assert tv == jv, name


@pytest.fixture(scope='module')
def fixture_instances():
    geo = Geometry(water)
    geo.add_solid(Solid(box(100.0, 80.0, 60.0), glass, water))
    geo.add_solid(Solid(sphere(30.0, nsteps=24), glass, water),
                  displacement=(120.0, 0.0, 0.0))
    geo.add_solid(Solid(box(40.0, 40.0, 40.0), glass, water),
                  displacement=(-120.0, 30.0, 0.0))
    geo.flatten()
    codes = jtypes.pack_material_codes(geo.material1_index,
                                       geo.material2_index,
                                       geo.surface_index)
    tri_base = np.cumsum([0] + [len(s.mesh.triangles) for s in geo.solids])
    return [(s.mesh, geo.solid_rotations[i], geo.solid_displacements[i],
             int(tri_base[i])) for i, s in enumerate(geo.solids)], codes


@pytest.mark.parametrize('fmt', ['f32', 'bf16', 'q8'])
def test_instanced_rows_bitwise(fixture_instances, fmt):
    instances, codes = fixture_instances
    pf, bf = FORMATS[fmt]
    jw, jmeta = jwide.build_instanced_bvh(instances, material_codes=codes,
                                          packed_fanout=pf, bounds_fmt=bf,
                                          want_meta=True)
    tw, tmeta = twide.build_instanced_bvh(instances, material_codes=codes,
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
    geo = Geometry(water)
    geo.add_solid(Solid(sphere(50.0, nsteps=16), glass, water))
    geo.flatten()
    geo.solids = []
    ga_j = jtypes.build_geometry_arrays(geo)
    ga_t = ttypes.build_geometry_arrays(geo)
    assert ga_t.inst is None and ga_t.wide.n_instances == 1
    _assert_bitwise(ga_j.wide.rows, ga_t.wide.rows, 'rows')


@pytest.fixture(scope='module')
def tiny_arrays():
    geo = demo.tiny()
    geo.flatten()
    return jtypes.build_geometry_arrays(geo), \
        ttypes.build_geometry_arrays(geo)


def test_tiny_geometry_arrays_bitwise(tiny_arrays):
    ga_j, ga_t = tiny_arrays
    assert ga_t.inst is not None and ga_t.wide.bounds_fmt == 'bf16'
    _assert_struct(ga_j, ga_t, 'ga')


def test_from_jax_arrays_bitwise(tiny_arrays):
    ga_j, ga_t = tiny_arrays
    _assert_struct(ga_t, ttypes.from_jax_arrays(ga_j), 'ga')
