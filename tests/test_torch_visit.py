"""The torch port's instanced traversal against the JAX one.

The plain PyTorch traversal (chroma_tpu_torch.ops.mesh_wide) must return
the JAX query's triangles, instance ids, material codes and visit counts
exactly, and its distances and normals to rtol 1e-5 (the FMA allowance of
tests/test_visit_kernel.py), in all three bounds formats, with masks,
distance limits and last-hit exclusions. The CUDA kernel is held to this
plain version on the card by tests/test_torch_cuda.py, which imports no
JAX."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chroma_tpu.geometry import Geometry, Solid
from chroma_tpu.demo.optics import water, glass
from chroma_tpu.make import box, sphere
from chroma_tpu.ops.types import pack_material_codes
from chroma_tpu.bvh.wide import build_instanced_bvh
from chroma_tpu.ops import mesh_wide as jmesh
from chroma_tpu_torch.bvh.wide import InstancedBVH
from chroma_tpu_torch.ops import mesh_wide, visit_kernel

torch.set_num_threads(2)

# (packed_fanout, bounds_fmt) per format: f32 tables use the fanout-16 base
FORMATS = {'f32': (0, 'f32'), 'bf16': (32, 'bf16'), 'q8': (32, 'q8')}


@pytest.fixture(scope='module')
def placed():
    "The tests/test_visit_kernel.py fixture geometry, flattened."
    geo = Geometry(water)
    geo.add_solid(Solid(box(100.0, 80.0, 60.0), glass, water))
    geo.add_solid(Solid(sphere(30.0, nsteps=24), glass, water),
                  displacement=(120.0, 0.0, 0.0))
    geo.add_solid(Solid(box(40.0, 40.0, 40.0), glass, water),
                  displacement=(-120.0, 30.0, 0.0))
    geo.flatten()
    codes = pack_material_codes(geo.material1_index, geo.material2_index,
                                geo.surface_index)
    tri_base = np.cumsum([0] + [len(s.mesh.triangles) for s in geo.solids])
    instances = [(s.mesh, geo.solid_rotations[i], geo.solid_displacements[i],
                  int(tri_base[i])) for i, s in enumerate(geo.solids)]
    return instances, codes


def _tables(placed, fmt):
    "(JAX InstancedBVH, the port's copy of the same rows)."
    instances, codes = placed
    pf, bf = FORMATS[fmt]
    jw = build_instanced_bvh(instances, material_codes=codes,
                             packed_fanout=pf, bounds_fmt=bf)
    tw = InstancedBVH(rows=torch.from_numpy(np.array(jw.rows)),
                      max_depth=jw.max_depth, fanout=jw.fanout,
                      leaf_size=jw.leaf_size, n_instances=jw.n_instances,
                      packed=jw.packed, bounds_fmt=jw.bounds_fmt)
    return jw, tw


def _rays(n, seed, first_tri=None):
    """Random rays around the fixture: 10% masked, 25% with a distance
    limit, some exactly axis-aligned, and (given a first pass) half with
    last_hit set to the first-pass hit."""
    rs = np.random.RandomState(seed)
    origin = rs.uniform(-200, 200, (n, 3)).astype(np.float32)
    # aimed at the solids' neighbourhood, so most rays hit something
    target = rs.uniform((-150, -50, -40), (150, 50, 40), (n, 3))
    d = (target - origin).astype(np.float32)
    d[:16, 1:] = 0.0                     # exact zero components
    d[16:32, 0] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mask = rs.uniform(size=n) >= 0.1
    limit = np.where(rs.uniform(size=n) < 0.25,
                     rs.uniform(10.0, 300.0, n), np.inf).astype(np.float32)
    last = np.full(n, -1, np.int32)
    if first_tri is not None:
        half = rs.uniform(size=n) < 0.5
        last = np.where(half, first_tri, -1).astype(np.int32)
    return origin, d, mask, limit, last


def _jax_query(jw, origin, d, mask, limit, last):
    q = jax.jit(lambda o, dd, m, bl, lh: jmesh.intersect_mesh_instanced(
        o, dd, jw, lh, m, bl, two_phase=False, want_context=True))
    v = jax.jit(lambda o, dd, m, bl, lh: jmesh.traversal_visits(
        o, dd, jw, lh, m, bl))
    args = (jnp.asarray(origin), jnp.asarray(d), jnp.asarray(mask),
            jnp.asarray(limit), jnp.asarray(last))
    tri, dist, code, normal, iid = [np.asarray(x) for x in q(*args)]
    visits = np.asarray(v(*args)[0])
    return tri, dist, code.view(np.int32), normal, iid, visits


def _torch_query(tw, origin, d, mask, limit, last, fn=mesh_wide.traverse):
    out = fn(tw, torch.from_numpy(origin), torch.from_numpy(d),
             torch.from_numpy(last), torch.from_numpy(mask),
             torch.from_numpy(limit))
    return [x.cpu().numpy() for x in out]


def _assert_same(ref, got):
    tri, dist, code, normal, iid, visits = ref
    t_tri, t_dist, t_code, t_normal, t_iid, t_visits = got
    np.testing.assert_array_equal(t_tri, tri)
    np.testing.assert_array_equal(t_iid, iid)
    np.testing.assert_array_equal(t_code, code)
    np.testing.assert_array_equal(t_visits, visits)
    hit = tri >= 0
    # misses keep their limit (or +inf) exactly
    np.testing.assert_array_equal(t_dist[~hit], dist[~hit])
    np.testing.assert_allclose(t_dist[hit], dist[hit], rtol=1e-5)
    np.testing.assert_allclose(t_normal[hit], normal[hit], rtol=1e-5,
                               atol=1e-5 * np.abs(normal[hit]).max())


@pytest.mark.parametrize('fmt', ['f32', 'bf16', 'q8'])
def test_plain_traversal_matches_jax(placed, fmt):
    jw, tw = _tables(placed, fmt)
    n = 1024
    o, d, mask, limit, _ = _rays(n, 3)
    first = _jax_query(jw, o, d, mask, np.full(n, np.inf, np.float32),
                       np.full(n, -1, np.int32))[0]
    o, d, mask, limit, last = _rays(n, 3, first)
    ref = _jax_query(jw, o, d, mask, limit, last)
    assert (ref[0] >= 0).sum() > n // 4          # the rays do hit things
    assert ((ref[0] >= 0) & (ref[4] > 0)).any()  # ... in several instances
    _assert_same(ref, _torch_query(tw, o, d, mask, limit, last))

    # the public wrappers agree with the traversal they wrap
    tri, dist, code, normal, iid = mesh_wide.intersect_mesh_instanced(
        torch.from_numpy(o), torch.from_numpy(d), tw,
        torch.from_numpy(last), torch.from_numpy(mask),
        torch.from_numpy(limit), want_context=True)
    np.testing.assert_array_equal(tri.numpy(), ref[0])
    visits, tri2, _ = mesh_wide.traversal_visits(
        torch.from_numpy(o), torch.from_numpy(d), tw,
        torch.from_numpy(last), torch.from_numpy(mask),
        torch.from_numpy(limit))
    np.testing.assert_array_equal(visits.numpy(), ref[5])


def test_wrapper_takes_plain_version_on_cpu(placed):
    "On CPU tensors the kernel wrapper runs the plain version, no launch."
    _, tw = _tables(placed, 'bf16')
    o, d, mask, limit, last = _rays(256, 5)
    before = visit_kernel.launches
    got = _torch_query(tw, o, d, mask, limit, last, visit_kernel.traverse)
    ref = _torch_query(tw, o, d, mask, limit, last)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert visit_kernel.launches == before
