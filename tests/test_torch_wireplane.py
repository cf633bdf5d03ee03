"""The torch port's analytic wire planes against the JAX package's.

On the tests/test_wireplane.py geometry (wires along x at 3 mm pitch,
0.15 mm radius, in a 2 m liquid-argon box) and on a three-plane U/V/Y
anode (wires at 0 and +-60 degrees, 3 mm apart): build_wireplane_arrays
gives the JAX package's arrays bit for bit, and intersect_wireplanes gives
the same hits, distances (rtol 1e-5), normals, media and surfaces. The port
also absorbs photons aimed at wires and lets those aimed between them
through, as the JAX package's slow propagation test checks."""
import numpy as np
import pytest
import torch
import jax

from chroma_tpu import event
from chroma_tpu.geometry import (Geometry, Solid, Material, Surface,
                                 WirePlane, vacuum)
from chroma_tpu.make import box
from chroma_tpu.ops import types as jtypes
from chroma_tpu.ops.wireplane import intersect_wireplanes as jax_wires
from chroma_tpu_torch.ops import types as ttypes
from chroma_tpu_torch.ops.propagate import photon_state_from_host, propagate
from chroma_tpu_torch.ops.wireplane import (candidate_windows,
                                            intersect_wireplanes)

torch.set_num_threads(2)


def lartpc(angles_deg=(0.0,), gap=3.0, radius=0.15):
    """Liquid argon in a 2 m box with absorbing wire planes at z = 0, gap,
    2*gap, ...: 3 mm pitch, 1 m x 1 m, wires at `angles_deg` to x."""
    lar = Material('lar')
    lar.set('refractive_index', 1.38)
    lar.set('absorption_length', 1e6)
    lar.set('scattering_length', 1e6)
    metal = Material('metal')
    metal.set('refractive_index', 1.5)
    metal.set('absorption_length', 1e-3)
    metal.set('scattering_length', 1e6)
    wire_surface = Surface('wire')
    wire_surface.set('absorb', 1)

    geo = Geometry(vacuum)
    geo.add_solid(Solid(box(2000, 2000, 2000), lar, vacuum))
    for i, deg in enumerate(angles_deg):
        a = np.radians(deg)
        geo.add_wireplane(WirePlane(
            origin=(0, 0, i * gap), u=(np.cos(a), np.sin(a), 0),
            v=(-np.sin(a), np.cos(a), 0), pitch=3.0, radius=radius,
            umin=-500, umax=500, vmin=-500, vmax=500,
            surface=wire_surface, material_inner=metal, material_outer=lar))
    geo.flatten()
    return geo


@pytest.fixture(scope='module', params=['single', 'uvy'])
def planes(request):
    geo = lartpc((0.0,)) if request.param == 'single' else \
        lartpc((0.0, 60.0, -60.0))
    ga = jtypes.build_geometry_arrays(geo)
    return request.param, geo, ga, ttypes.build_geometry_arrays(geo)


def test_wireplane_arrays_match_jax(planes):
    _, _, ga, ta = planes
    assert ta.has_wireplanes
    for name in ('origin', 'u', 'v', 'w', 'pitch', 'radius', 'umin', 'umax',
                 'vmin', 'vmax', 'v0', 'surface_index',
                 'material_inner_index', 'material_outer_index'):
        np.testing.assert_array_equal(
            getattr(ta.wireplanes, name).numpy(),
            np.asarray(getattr(ga.wireplanes, name)), err_msg=name)
    carried = ttypes.from_jax_arrays(ga).wireplanes
    np.testing.assert_array_equal(carried.w.numpy(), ta.wireplanes.w.numpy())


def _rays(kind, n=4096):
    "The test_wireplane.py ray sets, and random rays near the planes."
    rs = np.random.RandomState(7)
    if kind == 'head_on':
        pos = np.array([[0.0, 0.0, 100.0], [0.0, 1.5, 100.0],
                        [600.0, 0.0, 100.0]])
        d = np.tile([0.0, 0.0, -1.0], (3, 1))
    elif kind == 'oblique':
        pos = np.column_stack([rs.uniform(-50, 50, n), rs.uniform(-30, 30, n),
                               np.full(n, 30.0)])
        d = np.column_stack([rs.uniform(-0.3, 0.3, n), rs.uniform(-1, 1, n),
                             -np.ones(n)])
    else:   # isotropic, from within 60 mm of the planes
        pos = np.column_stack([rs.uniform(-600, 600, (n, 2)),
                               rs.uniform(-60, 60, n)])
        d = rs.randn(n, 3)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return pos.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize('kind', ['head_on', 'oblique', 'isotropic'])
def test_intersect_matches_jax(planes, kind):
    name, _, ga, ta = planes
    pos, d = _rays(kind)
    n = len(pos)
    active = np.ones(n, bool)
    if kind != 'head_on':
        active[::11] = False
    ref = jax.jit(lambda p, q, a: jax_wires(p, q, ga, a))(pos, d, active)
    got = intersect_wireplanes(torch.from_numpy(pos), torch.from_numpy(d),
                               ta, torch.from_numpy(active))
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    assert hit.sum() > 0 and not hit[~active].any()
    np.testing.assert_allclose(got.distance.numpy()[hit],
                               np.asarray(ref.distance)[hit], rtol=1e-5)
    np.testing.assert_allclose(got.normal.numpy()[hit],
                               np.asarray(ref.normal)[hit], rtol=1e-5,
                               atol=1e-6)
    for field in ('material1', 'material2', 'surface', 'inside_to_outside'):
        np.testing.assert_array_equal(getattr(got, field).numpy()[hit],
                                      np.asarray(getattr(ref, field))[hit],
                                      err_msg=field)
    if (name, kind) == ('single', 'head_on'):
        np.testing.assert_allclose(got.distance[0].item(), 100.0 - 0.15,
                                   rtol=1e-4)
        assert hit.tolist() == [True, False, False]
    windows = candidate_windows(torch.from_numpy(pos), torch.from_numpy(d),
                                ta, torch.from_numpy(active))
    assert len(windows) == (1 if name == 'single' else 3)
    assert all(int(w.max()) >= 1 for w in windows)


def test_propagation_absorbs_on_wires():
    "Photons aimed at wires terminate there; mid-gap photons pass."
    ta = ttypes.build_geometry_arrays(lartpc((0.0,)))
    n = 64
    ys = np.linspace(-1.5, 1.5, n)
    ph = event.Photons(np.column_stack([np.zeros(n), ys, np.full(n, 100.0)]),
                       np.tile([0.0, 0.0, -1.0], (n, 1)),
                       np.tile([1.0, 0.0, 0.0], (n, 1)), np.full(n, 400.0),
                       np.zeros(n))
    out = propagate(photon_state_from_host(ph, 'cpu'), ta, seed=3,
                    max_steps=10)
    flags = out.flags.numpy()
    absorbed = (flags & event.SURFACE_ABSORB) != 0
    on_wire = np.abs(np.abs(ys) % 3.0) < 0.15
    assert absorbed[on_wire].all()
    assert (out.last_hit_triangle.numpy()[on_wire] == -2).all()
    mid_gap = np.abs(np.abs(ys) - 1.5) < 0.1
    assert not absorbed[mid_gap].any()
