"""The port's second traversal, the stackless escape-pointer walk over the
classic BVH in DFS order (ops/mesh.py, ops/intersect.py, bvh/dfs.py),
against the JAX package's and against the port's wide walk.

The DFS re-layout is held bit for bit to the original. The walk reads the
classic layered BVH and the triangle soup, the wide walk its own instanced
table: they share no table and no code, so agreement of the two is an
independent check of the traversal that the CUDA kernel reproduces. Hit or
miss and the triangle must agree for every ray, the distances to rtol 1e-4
(the two walks test a triangle in different frames). Against JAX's
escape-pointer walk and its compiled primitives, the same algorithm on the
same arrays: hits, triangles and distances bit for bit, since both round
`a*b + c` as one fused multiply-add, as XLA's CPU code does."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chroma_tpu import loader as jloader
from chroma_tpu.bvh import dfs as jdfs
from chroma_tpu.ops import intersect as jintersect
from chroma_tpu.ops import mesh as jmesh
from chroma_tpu.ops import types as jtypes
from chroma_tpu_torch import loader as tloader
from chroma_tpu_torch.bvh import dfs as tdfs, flatten_to_dfs, validate_dfs
from chroma_tpu_torch.ops import intersect, mesh, mesh_wide
from chroma_tpu_torch.ops import types as ttypes

from test_torch_host import J, T, same_native_kit  # noqa: F401

torch.set_num_threads(2)

LOADER = {id(J): jloader, id(T): tloader}


def _t(a):
    return torch.from_numpy(np.array(a))


def scene(h):
    "A sphere, a turned box and a small box beside them, with a BVH."
    geo = h.Geometry()
    geo.add_solid(h.Solid(h.sphere(10.0, nsteps=12), h.vacuum, h.vacuum))
    geo.add_solid(h.Solid(h.box(6.0, 8.0, 5.0), h.vacuum, h.vacuum),
                  rotation=h.make_rotation_matrix(0.5, (1.0, 1.0, 0.2)),
                  displacement=(18.0, 3.0, -2.0))
    geo.add_solid(h.Solid(h.box(3.0, 3.0, 3.0), h.vacuum, h.vacuum),
                  displacement=(-14.0, -9.0, 6.0))
    return LOADER[id(h)].create_geometry_from_obj(geo, update_bvh_cache=False)


def rays(n, seed=42):
    "Half the rays aimed near the scene, half random."
    rng = np.random.RandomState(seed)
    origin = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    target = rng.uniform(-12, 12, (n, 3))
    direction = np.where(np.arange(n)[:, None] % 2 == 0,
                         target - origin, rng.normal(size=(n, 3)))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    return origin, direction.astype(np.float32)


@pytest.fixture(scope='module')
def built():
    gj, gt = scene(J), scene(T)
    return (gj, gt, jtypes.build_geometry_arrays(gj),
            ttypes.build_geometry_arrays(gt), mesh.build_dfs_arrays(gt))


def test_dfs_layout_bitwise(built):
    gj, gt, gaj, gat, dfs = built
    (nj, ej), (nt, et) = jdfs.flatten_to_dfs(gj.bvh), flatten_to_dfs(gt.bvh)
    assert nj.dtype == nt.dtype and nj.tobytes() == nt.tobytes()
    assert ej.dtype == et.dtype and ej.tobytes() == et.tobytes()
    validate_dfs(nt, et)
    assert tdfs.CHILD_MASK == jdfs.CHILD_MASK
    # the arrays the port's walk reads are the JAX GeometryArrays' fields
    for name in ('nodes', 'escape', 'world_origin', 'world_scale',
                 'vertices', 'triangles'):
        a = np.asarray(getattr(gaj, name))
        a = a.view(np.int32) if a.dtype == np.uint32 else a
        b = getattr(dfs, name).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert dfs.n_nodes == gaj.n_nodes == len(nt)
    assert dfs.to('cpu').nodes is dfs.nodes


def test_triangle_and_box_tests():
    "The cases of tests/test_intersect.py on the port's primitives."
    v0 = _t([[0., 0., 1.], [0., 0., 1.], [0., 0., 1.]])
    v1 = _t([[1., 0., 1.], [1., 0., 1.], [1., 0., 1.]])
    v2 = _t([[0., 1., 1.], [0., 1., 1.], [0., 1., 1.]])
    origin = _t([[0.2, 0.2, 0.], [5., 5., 0.], [0., 0., 0.]])
    direction = _t([[0., 0., 1.], [0., 0., 1.], [1., 0., 0.]])
    hit, t = intersect.intersect_triangle(origin, direction, v0, v1, v2)
    assert hit.tolist() == [True, False, False]     # hit, miss, parallel
    np.testing.assert_allclose(float(t[0]), 1.0, rtol=1e-6)

    lower, upper = _t([[-1., -1., -1.]]), _t([[1., 1., 1.]])

    def box(origin, direction):
        origin, direction = _t([origin]), _t([direction])
        inv = 1.0 / direction
        hit, d = intersect.intersect_box(origin, -origin * inv, inv, lower,
                                         upper)
        return bool(hit[0]), float(d[0])

    hit, d = box([0., 0., -5.], [0., 0., 1.])
    assert hit and abs(d - 4.0) < 1e-6
    assert not box([0., 0., -5.], [0., 0., -1.])[0]
    assert box([0., 0., 0.], [0., 0., 1.]) == (True, 0.0)      # inside
    # zero direction components: an exact containment test on their axis
    assert not box([5., 0., -5.], [0., 0., 1.])[0]
    hit, d = box([-0., 0., -5.], [-0., -0., 1.])               # -0.0
    assert hit and abs(d - 4.0) < 1e-6
    assert not box([5., 0., -5.], [0.001, 0.001, 1.])[0]
    hit, d = box([0.5, 0.5, -3.], [0., 0., 1.])
    assert hit and abs(d - 2.0) < 1e-6


def test_primitives_match_jax():
    rng = np.random.default_rng(0)
    n = 20000
    o = rng.normal(size=(n, 3)).astype(np.float32) * 3
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::50, 0] = 0.0                                 # axis-aligned rays
    v = rng.normal(size=(3, n, 3)).astype(np.float32) * 2
    hj, tj = jax.jit(jintersect.intersect_triangle)(
        jnp.asarray(o), jnp.asarray(d), *[jnp.asarray(x) for x in v])
    ht, tt = intersect.intersect_triangle(_t(o), _t(d), *[_t(x) for x in v])
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    assert ht.sum() > 100
    hit = ht.numpy()
    np.testing.assert_array_equal(tt.numpy()[hit], np.asarray(tj)[hit])
    lo = np.minimum(v[0], v[1])
    hi = np.maximum(v[0], v[1])
    with np.errstate(divide='ignore'):
        inv = 1.0 / d
    bj, dj = jax.jit(jintersect.intersect_box)(
        jnp.asarray(o), jnp.asarray(-o * inv), jnp.asarray(inv),
        jnp.asarray(lo), jnp.asarray(hi))
    bt, dt = intersect.intersect_box(_t(o), _t(-o * inv), _t(inv), _t(lo),
                                     _t(hi))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    assert bt.sum() > 100
    hit = bt.numpy()
    np.testing.assert_array_equal(dt.numpy()[hit], np.asarray(dj)[hit])


def test_fma_rounds_once_at_halfway_points():
    """linalg.fma equals XLA's compiled `a*b + c` (one rounding) where the
    exact sum lies a hair off the midpoint of c and a neighbour, closer
    than f64 resolves, so that the f64 sum is the midpoint and rounding it
    again to f32 ties: a*b is half of c's ulp times 1 - 2^-30 or times
    1 + 4688 * 2^-46, each a product of two f32 values."""
    from chroma_tpu_torch.ops.linalg import fma
    rng = np.random.default_rng(1)
    n = 1000
    c = rng.uniform(1, 2, n).astype(np.float32) * np.exp2(
        rng.integers(-20, 20, n)).astype(np.float32)
    c = c * rng.choice([-1, 1], n).astype(np.float32)
    half = np.abs(np.nextafter(c, np.float32(np.inf)) - c) / 2
    below = rng.random(n) < 0.5
    a = np.where(below, 1 + 2.0 ** -15, 1 + 2896 * 2.0 ** -23)
    b = np.where(below, 1 - 2.0 ** -15, 1 - 2895 * 2.0 ** -23)
    a = (a * half * np.sign(c) * rng.choice([-1, 1], n)).astype(np.float32)
    b = b.astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    got = fma(_t(a), _t(b), _t(c)).numpy()
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice.view(np.int32) != want.view(np.int32)).sum() > n // 4
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    a, b, c = rng.normal(size=(3, 100000)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    np.testing.assert_array_equal(fma(_t(a), _t(b), _t(c)).numpy(), want)


def test_dfs_walk_matches_jax(built):
    gj, gt, gaj, gat, dfs = built
    o, d = rays(4096)
    tj, dj = jmesh.intersect_mesh(jnp.asarray(o), jnp.asarray(d), gaj)
    tt, dt = mesh.intersect_mesh(_t(o), _t(d), dfs)
    tj, dj = np.asarray(tj), np.asarray(dj)
    bad = np.flatnonzero(tj != tt.numpy())
    for k in bad[:20]:
        print('ray %d: jax %d at %r, torch %d at %r'
              % (k, tj[k], dj[k], tt[k], float(dt[k])))
    assert len(bad) == 0
    hit = tj >= 0
    assert hit.sum() > 1000 and (tj < 0).sum() > 500
    np.testing.assert_array_equal(dt.numpy()[hit], dj[hit])
    assert np.isinf(dt.numpy()[tt.numpy() < 0]).all()


def test_dfs_walk_matches_wide_walk(built):
    gj, gt, gaj, gat, dfs = built
    o, d = rays(4096, seed=7)
    tw, dw, _, _, _, _ = mesh_wide.traverse(gat.wide, _t(o), _t(d))
    tt, dt = mesh.intersect_mesh(_t(o), _t(d), dfs)
    tw, dw, tt, dt = tw.numpy(), dw.numpy(), tt.numpy(), dt.numpy()
    assert ((tw >= 0) == (tt >= 0)).all()
    hit = tw >= 0
    assert hit.sum() > 1000
    np.testing.assert_allclose(dt[hit], dw[hit], rtol=1e-4)
    np.testing.assert_array_equal(tt, tw)
    # the walk against every triangle, tested one by one
    tri = _t(gt.mesh.vertices[gt.mesh.triangles].astype(np.float32))
    pick = np.arange(0, len(o), 16)
    bh, bt = intersect.intersect_triangle(
        _t(o[pick])[:, None, :], _t(d[pick])[:, None, :], tri[None, :, 0],
        tri[None, :, 1], tri[None, :, 2])
    best = torch.where(bh, bt, torch.inf).min(dim=1).values.numpy()
    assert (np.isfinite(best) == hit[pick]).all()
    np.testing.assert_allclose(dt[pick][hit[pick]], best[hit[pick]],
                               rtol=1e-5)


def test_dfs_walk_last_hit_and_mask(built):
    gj, gt, gaj, gat, dfs = built
    o, d = rays(1024, seed=9)
    o, d = _t(o), _t(d)
    tri, dist = mesh.intersect_mesh(o, d, dfs)
    hit = tri >= 0
    # re-tracing from the hit point with last_hit set never returns it
    on = torch.where(hit[:, None], o + dist[:, None] * d, o)
    tri2, dist2 = mesh.intersect_mesh(on, d, dfs, last_hit_triangle=tri)
    assert (tri2[hit] != tri[hit]).all()
    want, _, _, _, _, _ = mesh_wide.traverse(gat.wide, on, d, tri)
    assert ((want >= 0) == (tri2 >= 0)).float().mean() >= 0.99
    # masked lanes are not traced
    mask = torch.arange(len(o)) % 3 == 0
    tri3, dist3 = mesh.intersect_mesh(o, d, dfs, mask=mask)
    assert (tri3[~mask] == -1).all() and torch.isinf(dist3[~mask]).all()
    assert torch.equal(tri3[mask], tri[mask])
    assert torch.equal(dist3[mask], dist[mask])


def test_distance_to_mesh_matches_jax(built):
    "distance_to_mesh takes the wide walk in both packages."
    gj, gt, gaj, gat, dfs = built
    o, d = rays(2048, seed=3)
    d = d * np.float32(2.5)                     # it normalizes itself
    want = np.asarray(jmesh.distance_to_mesh(jnp.asarray(o), jnp.asarray(d),
                                             gaj))
    got = mesh.distance_to_mesh(_t(o), _t(d), gat).numpy()
    assert np.array_equal(np.isfinite(want), np.isfinite(got))
    hit = np.isfinite(want)
    assert hit.sum() > 500
    np.testing.assert_allclose(got[hit], want[hit], rtol=1e-5)
    # tests/test_intersect.py::test_distance_to_mesh_film on the port
    from chroma_tpu_torch.tools import from_film
    cube = tloader.create_geometry_from_obj(T.cube(2.0),
                                            update_bvh_cache=False)
    fo, fd = from_film(position=(0, -10, 0), size=(16, 12), width=4.0)
    dist = mesh.distance_to_mesh(
        _t(fo.astype(np.float32)), _t(fd.astype(np.float32)),
        ttypes.build_geometry_arrays(cube)).numpy()
    assert np.isfinite(dist).sum() > 10
    assert abs(dist[np.isfinite(dist)].min() - 9.0) < 0.2
