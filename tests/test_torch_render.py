"""The torch port's renderer against the JAX renderer, on the CPU.

Each side builds its scene from its own package and gets the same
numpy-made rays. Tolerances: the hit triangle of every depth layer equal
exactly and its distance to rtol 1e-5 (of the path from the camera, for
a layer that starts on the last hit); each ARGB channel within 1 count
and at least 99.9% of the pixels equal exactly (the pixels that differ are
printed); a miss gives the background word exactly. The photon map
(`to_diffuse`, the scatter-add, the tone map, `hybrid_render`) is held in
tests/test_torch_hybrid.py.

demo.tiny() is looked at twice: from a camera off the detector's symmetry
planes, and head-on from the camera's default pose, where every ray of the
middle rows runs along edges shared by two triangles that tie to the ulp.
The port rounds the traversal as XLA's CPU code does (fused multiply-adds,
ops/mesh_wide.py), so there too every triangle id is JAX's."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chroma_tpu.ops import render as jrender
from chroma_tpu.ops import transform as jtransform
from chroma_tpu.ops import types as jtypes
from chroma_tpu.ops.mesh_wide import intersect_mesh_wide
from chroma_tpu_torch import gpu
from chroma_tpu_torch.camera import Rays
from chroma_tpu_torch.ops import render, transform
from chroma_tpu_torch.ops import types as ttypes

from test_torch_host import (J, T, fresh_perf_cache,  # noqa: F401
                             same_native_kit)

torch.set_num_threads(2)

SIZE = (64, 48)


def _t(a):
    return torch.from_numpy(np.array(a))


def cube_scene(h):
    "A semi-transparent red cube with a greenish sphere inside."
    from importlib import import_module
    loader = import_module(h.Geometry.__module__.split('.')[0] + '.loader')
    geo = h.Geometry()
    geo.add_solid(h.Solid(h.cube(2.0), h.vacuum, h.vacuum,
                          color=0x80FF0000))
    geo.add_solid(h.Solid(h.sphere(0.6, 16), h.vacuum, h.vacuum,
                          color=0x4000FF40))
    return loader.create_geometry_from_obj(geo, update_bvh_cache=False)


def tiny_scene(h):
    geo = h.demo.tiny()
    geo.flatten()
    return geo


def _film(h, geo, scene):
    "Camera rays (origin, direction) as f32 numpy, made by package h."
    from importlib import import_module
    pkg = h.Geometry.__module__.split('.')[0]
    if scene == 'cube':
        o, d = import_module(pkg + '.tools').from_film(
            position=(0.3, -10.0, 0.2), size=SIZE, width=10.0)
    elif scene == 'tiny_head_on':
        pose, _, _ = import_module(pkg + '.camera')._scene_pose(geo)
        o, d = import_module(pkg + '.tools').from_film(
            pose.position, axis1=pose.axis1, axis2=pose.axis2, size=SIZE,
            width=35.0, focal_length=18.0)
    else:
        lower, upper = geo.mesh.get_bounds()
        scale = float(np.linalg.norm(upper - lower))
        o, d = import_module(pkg + '.tools').from_film(
            position=(upper + lower) / 2.0
            + np.array([137.3, -scale, 71.9]), size=SIZE, width=35.0,
            focal_length=18.0)
    return o.astype(np.float32), d.astype(np.float32)


_scenes = {}


def get_scene(name):
    """(JAX arrays, port arrays, origin, direction): scene `name` built by
    each package, and the rays (equal from both packages' from_film)."""
    if name not in _scenes:
        build = {'cube': cube_scene, 'tiny': tiny_scene,
                 'tiny_head_on': tiny_scene}[name]
        gj, gt = build(J), build(T)
        oj, dj = _film(J, gj, name)
        ot, dt = _film(T, gt, name)
        assert oj.tobytes() == ot.tobytes() and dj.tobytes() == dt.tobytes()
        _scenes[name] = (jtypes.build_geometry_arrays(gj),
                         ttypes.build_geometry_arrays(gt), oj, dj)
    return _scenes[name]


@pytest.fixture(params=['cube', 'tiny', 'tiny_head_on'])
def scene(request):
    return get_scene(request.param)


def assert_pixels_match(pj, pt, min_equal=0.999):
    pj = np.asarray(pj, np.uint32)
    bad = np.flatnonzero(pj != pt)
    for k in bad[:20]:
        print('pixel %d differs: jax %08x torch %08x' % (k, pj[k], pt[k]))
    assert 1.0 - len(bad) / len(pj) >= min_equal, \
        '%d of %d pixels differ' % (len(bad), len(pj))
    for shift in (24, 16, 8, 0):
        a = ((pj >> shift) & 0xFF).astype(int)
        b = ((pt >> shift) & 0xFF).astype(int)
        assert np.abs(a - b).max() <= 1, 'channel at bit %d' % shift


# --- transforms and shading ------------------------------------------------

def test_transforms_match_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(1000, 3)).astype(np.float32) * 100
    axis = np.array([0.3, -1.2, 0.5], np.float32)
    center = np.array([10.0, -3.0, 7.5], np.float32)
    delta = np.array([1.5, 2.5, -3.5], np.float32)
    phi = 0.7
    for jf, tf, args in (
            (jtransform.rotate_points, transform.rotate_points,
             (phi, axis)),
            (jtransform.rotate_around_point, transform.rotate_around_point,
             (phi, axis, center)),
            (jtransform.translate_points, transform.translate_points,
             (delta,))):
        want = np.asarray(jf(jnp.asarray(pts), *[jnp.asarray(a)
                                                 for a in args]))
        got = tf(_t(pts), *args).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    # an identity rotation leaves the points where they are
    np.testing.assert_allclose(
        transform.rotate_points(_t(pts), 0.0, axis).numpy(), pts,
        rtol=1e-6, atol=1e-4)


def test_shade_matches_jax():
    rng = np.random.default_rng(1)
    n = 5000
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    rgba = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    want = jrender._shade(jnp.asarray(d), jnp.asarray(nrm),
                          jnp.asarray(rgba))
    got = render._shade(_t(d), _t(nrm), _t(rgba.view(np.int32)))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)
    # alpha comes from the top byte, also when the int32 word is negative
    assert float(got[3][rgba >= 2 ** 31].min()) >= 0.0


# --- depth peeling and compositing ------------------------------------------

@pytest.mark.parametrize('name,alpha_depth', [
    ('cube', 1), ('cube', 3), ('cube', 10), ('tiny', 3),
    ('tiny_head_on', 3)])
def test_render_matches_jax(name, alpha_depth):
    """Depth 10 on the cube scene only: the JAX renderer compiles one
    traversal a layer."""
    gaj, gat, o, d = get_scene(name)
    want = jrender.render(jnp.asarray(o), jnp.asarray(d), gaj,
                          alpha_depth=alpha_depth)
    got = render.pixels_to_host(render.render(_t(o), _t(d), gat,
                                              alpha_depth=alpha_depth))
    assert got.dtype == np.uint32 and got.shape == (len(o),)
    assert (got != 0xFFFFFFFF).sum() > 100
    assert_pixels_match(want, got)


def test_layers_match_jax(scene):
    """Every depth layer's triangle equal, its distance to 1e-5 of the
    path from the camera. The JAX side normalises the directions and moves
    to each hit compiled, as its renderer does."""
    gaj, gat, o, d = scene
    depth = 4
    dn = jax.jit(lambda x: x / jnp.linalg.norm(x, axis=-1, keepdims=True))(
        jnp.asarray(d))
    advance = jax.jit(lambda p, dist, hit: jnp.where(
        hit[:, None], p + dist[:, None] * dn, p))
    layers = list(render.peel(_t(o), render._unit(_t(d)), gat, depth))
    assert len(layers) == depth
    trace = jax.jit(lambda p, last, act: intersect_mesh_wide(
        p, dn, gaj.wide, last_hit_triangle=last, mask=act))
    pos = jnp.asarray(o)
    last = jnp.full(len(o), -1, jnp.int32)
    active = jnp.ones(len(o), bool)
    hits = []
    for tri_t, dist_t in layers:
        tri, dist = trace(pos, last, active)
        hit = np.asarray(tri) >= 0
        hits.append(int(hit.sum()))
        bad = np.flatnonzero(np.asarray(tri) != tri_t.numpy())
        for k in bad[:20]:
            print('ray %d: jax %d at %r, torch %d at %r' % (
                k, tri[k], float(dist[k]), tri_t[k], float(dist_t[k])))
        assert len(bad) == 0
        # a layer starts on the last hit, far from the camera: its
        # distance is held to 1e-5 of the whole path from the camera
        path = np.linalg.norm(np.asarray(pos) - o, axis=1) \
            + np.where(hit, np.asarray(dist), 0.0)
        assert (np.abs(dist_t.numpy()[hit] - np.asarray(dist)[hit])
                <= 1e-5 * path[hit]).all()
        pos = advance(pos, dist, hit)
        last = jnp.where(hit, tri, last)
        active = active & hit
    # the layers thin out: rays leave the scene
    assert hits[0] > hits[-1] > 0


def test_peel_stops_when_no_ray_is_left():
    "Two layers of a cube, then nothing: the peel ends after the third."
    geo = T.Geometry()
    geo.add_solid(T.Solid(T.cube(2.0), T.vacuum, T.vacuum))
    geo.flatten()
    ga = ttypes.build_geometry_arrays(geo)
    o = _t(np.array([[0.1, -10, 0.2], [0.1, -10, 50.0]], np.float32))
    d = _t(np.array([[0, 1, 0], [0, 1, 0]], np.float32))
    layers = list(render.peel(o, d, ga, 10))
    assert [int((tri >= 0).sum()) for tri, _ in layers] == [1, 1, 0]


def test_distances_match_jax(scene):
    gaj, gat, o, d = scene
    want = np.asarray(jrender.distances(jnp.asarray(o), jnp.asarray(d), gaj))
    got = render.distances(_t(o), _t(d), gat).numpy()
    assert np.isfinite(want).sum() > 100
    assert np.array_equal(np.isfinite(want), np.isfinite(got))
    hit = np.isfinite(want)
    np.testing.assert_allclose(got[hit], want[hit], rtol=1e-5)


def test_render_hits_and_misses():
    "tests/test_render.py::test_render_hits_and_misses on the port."
    import chroma_tpu_torch.loader as loader
    geo = T.Geometry()
    geo.add_solid(T.Solid(T.cube(2.0), T.vacuum, T.vacuum,
                          color=0x80FF0000))
    geo = loader.create_geometry_from_obj(geo, update_bvh_cache=False)
    ga = ttypes.build_geometry_arrays(geo)
    origin = _t(np.array([[0, -10, 0], [0, -10, 100]], np.float32))
    direction = _t(np.array([[0, 1, 0], [0, 1, 0]], np.float32))
    pixels = render.pixels_to_host(render.render(origin, direction, ga,
                                                 bg_color=0xFF101010))
    assert ((pixels[0] >> 16) & 0xFF) > (pixels[0] & 0xFF)
    assert pixels[1] == 0xFF101010
    # the default background comes back exact too
    pixels = render.render(origin, direction, ga)
    assert pixels.dtype == torch.int32 and int(pixels[1]) == -1
    assert render.pixels_to_host(pixels)[1] == 0xFFFFFFFF
    # distances: tests/test_render.py::test_distances
    from chroma_tpu_torch.tools import from_film
    o, d = from_film(position=(0, -10, 0), size=(8, 6), width=2.0)
    dist = render.distances(_t(o.astype(np.float32)),
                            _t(d.astype(np.float32)), ga).numpy()
    assert np.isfinite(dist).any()
    assert abs(dist[np.isfinite(dist)].min() - 9.0) < 0.1


@pytest.mark.parametrize('bg_color', [0x80102030, 0x00FFFFFF])
def test_background_composite_matches_jax(bg_color):
    gaj, gat, o, d = get_scene('cube')
    want = jrender.render(jnp.asarray(o), jnp.asarray(d), gaj,
                          alpha_depth=3, bg_color=bg_color)
    got = render.pixels_to_host(render.render(_t(o), _t(d), gat,
                                              alpha_depth=3,
                                              bg_color=bg_color))
    assert_pixels_match(want, got)
    assert (got == bg_color).sum() > 100


def test_lean_geometry_raises(monkeypatch):
    """A lean geometry has no per-triangle normals and colors: render and
    hybrid_render say so instead of rebuilding them."""
    monkeypatch.setenv('CHROMA_LEAN', '1')
    ga = ttypes.build_geometry_arrays(cube_scene(T))
    assert ga.tri_normals is None and ga.colors is None
    o = torch.zeros((4, 3))
    d = torch.ones((4, 3))
    with pytest.raises(ValueError, match='lean'):
        render.render(o, d, ga)
    with pytest.raises(ValueError, match='lean'):
        render.hybrid_render(o, d, ga, (0, 0), nphotons=10, nbatches=1)
    # distances need only the table
    assert render.distances(o, d, ga).shape == (4,)


# --- the ray bundles ---------------------------------------------------------

def test_gpu_rays_render_and_move():
    gaj, gat, o, d = get_scene('cube')
    geometry = gpu.GPUGeometry(None, arrays=gat, device='cpu')
    rays = gpu.GPURays(o, d, device='cpu')
    plain = Rays(o, d, device='cpu')
    host = np.zeros(len(o), np.uint32)
    out = rays.render(geometry, pixels=host, alpha_depth=3)
    want = plain.render(gat, alpha_depth=3)
    assert torch.equal(out, want)
    assert (host == render.pixels_to_host(want)).all()
    # the rigid motions are the JAX Rays'
    from chroma_tpu.camera import Rays as JRays
    jr = JRays(o, d)
    for r in (rays, jr):
        r.rotate(0.3, (0.0, 0.0, 1.0))
        r.rotate_around_point(-0.2, (1.0, 0.0, 0.0), (0.0, 1.0, 0.5))
        r.translate((0.5, -0.25, 1.0))
    np.testing.assert_allclose(rays.pos.numpy(), np.asarray(jr.pos),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rays.dir.numpy(), np.asarray(jr.dir),
                               rtol=1e-5, atol=1e-6)
    assert not torch.equal(rays.render(geometry, alpha_depth=3), want)


def test_rays_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    o = np.zeros((2, 3), np.float32)
    with pytest.raises(RuntimeError, match='CUDA'):
        Rays(o, o)
    with pytest.raises(RuntimeError, match='CUDA'):
        gpu.GPURays(o, o)
