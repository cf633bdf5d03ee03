"""The torch port's photon-map render against the JAX package's, on the
CPU: `to_diffuse` step for step under injected draws (integer fields equal
on at least 99.9% of the lanes, floats to rtol 1e-5), the scatter-add of
`update_xyz_lookup` and `update_xyz_image` to rtol 1e-5, the tone map
within 1 count a channel, and the whole `hybrid_render`, whose random
streams the two packages do not share, statistically."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chroma_tpu.ops import propagate as jprop
from chroma_tpu.ops import render as jrender
from chroma_tpu.ops import types as jtypes
from chroma_tpu.ops.sample import make_key
from chroma_tpu_torch.event import REFLECT_DIFFUSE
from chroma_tpu_torch.ops import render
from chroma_tpu_torch.ops import types as ttypes

from test_torch_host import (J, T, fresh_perf_cache,  # noqa: F401
                             same_native_kit)
from test_torch_photon import (assert_states_match, jax_blocks,
                               torch_state)
from test_torch_render import _t, assert_pixels_match, get_scene

torch.set_num_threads(2)


def diffuse_box(h):
    """A 2 m water box whose walls reflect diffusely (70%) or absorb, with
    a glass block inside."""
    water = h.Material('water')
    water.set('refractive_index', 1.33)
    water.set('absorption_length', 1e4)
    water.set('scattering_length', 5e3)
    glass = h.Material('glass')
    glass.set('refractive_index', 1.49)
    glass.set('absorption_length', 1e3)
    glass.set('scattering_length', 1e6)
    wall = h.Surface('wall')
    wall.set('reflect_diffuse', 0.7)
    wall.set('absorb', 0.3)
    geo = h.Geometry(water)
    geo.add_solid(h.Solid(h.box(2000.0, 2000.0, 2000.0), water, h.vacuum,
                          surface=wall, color=0x00AAAAFF))
    geo.add_solid(h.Solid(h.box(300.0, 300.0, 300.0), glass, water,
                          color=0x8000FF00), displacement=(400.0, 300, -200))
    geo.flatten()
    return geo


@pytest.fixture(scope='module')
def box():
    return (jtypes.build_geometry_arrays(diffuse_box(J)),
            ttypes.build_geometry_arrays(diffuse_box(T)))


N = 2048


def _bomb_state():
    np.random.seed(23)
    bomb = J.photon_bomb(N, 450.0, (100.0, -50.0, 30.0))
    bomb.wavelengths[:] = np.random.uniform(380.0, 680.0, N)
    return jprop.photon_state_from_host(bomb)


def test_to_diffuse_matches_jax(box):
    """to_diffuse, both sides stepping the same photons with the same
    uniforms: the port's pools are fed the blocks that JAX's DrawPool draws
    from fold_in(fold_in(key, i), b)."""
    gaj, gat = box
    js = _bomb_state()
    key = make_key(9)
    max_steps = 6
    ts = render.to_diffuse(
        torch_state(js), gat, None, max_steps=max_steps,
        blocks=lambda i, b: jax_blocks(jax.random.fold_in(key, i), N)(b))
    js = jax.jit(jrender.to_diffuse, static_argnames='max_steps')(
        js, gaj, key, max_steps=max_steps)
    assert_states_match(js, ts, min_equal=0.999, scaled=True)
    landed = (ts.flags.numpy() & REFLECT_DIFFUSE) != 0
    assert 0.5 < landed.mean() < 0.95
    # parked photons sit on the wall that reflected them
    assert (ts.last_hit_triangle.numpy()[landed] >= 0).all()


def _parked_state(n_tri, seed=3):
    "A PhotonState of photons parked on random triangles, some not landed."
    rng = np.random.default_rng(seed)
    n = 5000
    flags = np.where(rng.random(n) < 0.7, REFLECT_DIFFUSE, 2).astype(
        np.uint32)
    last = rng.integers(-1, n_tri, n).astype(np.int32)
    js = _bomb_state()
    fields = dict(
        pos=np.zeros((n, 3), np.float32), dir=np.zeros((n, 3), np.float32),
        pol=np.zeros((n, 3), np.float32),
        wavelength=rng.uniform(380, 680, n).astype(np.float32),
        t=np.zeros(n, np.float32),
        weight=rng.uniform(0.5, 1.5, n).astype(np.float32), flags=flags,
        last_hit_triangle=last, evidx=np.zeros(n, np.uint32),
        cur_mat=np.full(n, -1, np.int32))
    return js.replace(**{k: jnp.asarray(v) for k, v in fields.items()})


def test_update_xyz_lookup_matches_jax(box):
    gaj, gat = box
    n_tri = gat.triangles.shape[0]
    js = _parked_state(n_tri)
    rng = np.random.default_rng(4)
    start = rng.random((n_tri, 3)).astype(np.float32)
    want = np.asarray(jrender.update_xyz_lookup(js, gaj, jnp.asarray(start)))
    got = render.update_xyz_lookup(torch_state(js), gat, _t(start)).numpy()
    assert got.shape == (n_tri, 3) and (got != start).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the input lookup is left as it was
    before = _t(start)
    render.update_xyz_lookup(torch_state(js), gat, before)
    assert before.numpy().tobytes() == start.tobytes()


def test_update_xyz_image_and_process_image_match_jax():
    gaj, gat, o, d = get_scene('cube')
    n_tri = gat.triangles.shape[0]
    rng = np.random.default_rng(5)
    lookup = rng.random((n_tri, 3)).astype(np.float32)
    image = rng.random((len(o), 3)).astype(np.float32) * 0.1
    want = np.asarray(jrender.update_xyz_image(
        jnp.asarray(o), jnp.asarray(d), gaj, jnp.asarray(lookup),
        jnp.asarray(image)))
    got = render.update_xyz_image(_t(o), _t(d), gat, _t(lookup), _t(image))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert (got.numpy() != image).any()
    pj = np.asarray(jrender.process_image(jnp.asarray(want)))
    pt = render.pixels_to_host(render.process_image(_t(want)))
    assert (pt >> 24 == 0xFF).all()
    assert_pixels_match(pj, pt)


def test_process_image_of_zeros_is_black():
    pt = render.pixels_to_host(render.process_image(torch.zeros((7, 3))))
    assert (pt == 0xFF000000).all()


def test_hybrid_render_statistics(box):
    """The whole photon-map render, each side from its own random stream:
    the share of photons that come to rest on a diffuse wall agrees within
    5 sigma, and both images are opaque, lit and of similar brightness."""
    gaj, gat = box
    n = N
    cam = np.array([100.0, -600.0, 30.0], np.float32)
    from chroma_tpu_torch.tools import from_film
    o, d = from_film(position=cam, size=(32, 24), width=35.0,
                     focal_length=18.0)
    o, d = o.astype(np.float32), d.astype(np.float32)

    ph = render.camera_photons(_t(cam), n, torch.Generator().manual_seed(1))
    assert np.allclose(np.linalg.norm(ph.dir.numpy(), axis=1), 1, atol=1e-5)
    assert np.abs((ph.dir * ph.pol).sum(1).numpy()).max() < 1e-4
    wl = ph.wavelength.numpy()
    assert 380.0 <= wl.min() and wl.max() <= 680.0 and wl.std() > 50
    parked = render.to_diffuse(ph, gat, (1, 0))
    frac_t = ((parked.flags.numpy() & REFLECT_DIFFUSE) != 0).mean()

    from chroma_tpu.ops.photon import PhotonState
    from chroma_tpu.ops.sample import uniform_sphere
    key = make_key(2)
    dirs = uniform_sphere(jax.random.fold_in(key, 0), (n,))
    pols = jnp.cross(uniform_sphere(jax.random.fold_in(key, 1), (n,)), dirs)
    pols = pols / jnp.linalg.norm(pols, axis=1, keepdims=True)
    js = PhotonState(
        pos=jnp.tile(jnp.asarray(cam)[None, :], (n, 1)), dir=dirs,
        pol=pols, wavelength=jax.random.uniform(
            jax.random.fold_in(key, 2), (n,), minval=380.0, maxval=680.0),
        t=jnp.zeros(n), weight=jnp.ones(n),
        flags=jnp.zeros(n, jnp.uint32),
        last_hit_triangle=jnp.full(n, -1, jnp.int32),
        evidx=jnp.zeros(n, jnp.uint32))
    js = jax.jit(jrender.to_diffuse)(js, gaj, key)
    frac_j = ((np.asarray(js.flags) & REFLECT_DIFFUSE) != 0).mean()
    sigma = np.sqrt(2 * frac_j * (1 - frac_j) / n)
    assert abs(frac_t - frac_j) < 5 * sigma, (frac_t, frac_j, sigma)

    images = []
    for pix in (
            np.asarray(jrender.hybrid_render(
                jnp.asarray(o), jnp.asarray(d), gaj, key, nphotons=n,
                nbatches=1)),
            render.pixels_to_host(render.hybrid_render(
                _t(o), _t(d), gat, (5, 0), nphotons=n, nbatches=1))):
        assert pix.shape == (len(o),) and (pix >> 24 == 0xFF).all()
        rgb = np.stack([(pix >> s) & 0xFF for s in (16, 8, 0)], 1)
        assert (rgb.sum(1) > 0).mean() > 0.9
        images.append(rgb.astype(float))
    # tone-mapped to each image's own peak: the medians agree loosely
    mj, mt = (np.median(im.sum(1)) for im in images)
    assert 0.5 < mt / mj < 2.0, (mj, mt)
    # a torch.Generator seeds the render as well, reproducibly
    a, b = (render.pixels_to_host(render.hybrid_render(
        _t(o), _t(d), gat, torch.Generator().manual_seed(8), nphotons=500,
        nbatches=1)) for _ in range(2))
    assert (a == b).all() and (a != 0xFF000000).any()
