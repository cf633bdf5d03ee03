"""The torch port's analytic wire planes against the JAX package's.

On the tests/test_wireplane.py geometry (wires along x at 3 mm pitch,
0.15 mm radius, in a 2 m liquid-argon box) and on a three-plane U/V/Y
anode (wires at 0 and +-60 degrees, 3 mm apart): build_wireplane_arrays
gives the JAX package's arrays bit for bit, and intersect_wireplanes gives
a float64 solve's hits of every wire (tests/wire_cases.py), and the JAX
package's hits, distances, normals, media and surfaces wherever those are
the float64 solve's too: the port's wire test departs from JAX's f32
quadratic on purpose. The port
also absorbs photons aimed at wires and lets those aimed between them
through, as the JAX package's slow propagation test checks."""
import numpy as np
import pytest
import torch
import jax

from chroma_tpu.ops import types as jtypes
from chroma_tpu.ops.wireplane import intersect_wireplanes as jax_wires
from chroma_tpu_torch.ops import types as ttypes
from chroma_tpu_torch.ops.propagate import photon_state_from_host, propagate
from chroma_tpu_torch.ops.wireplane import (candidate_windows, classify,
                                            intersect_wireplanes)

from test_torch_host import (J, T, fresh_perf_cache,  # noqa: F401
                             same_native_kit)
from wire_cases import f64_walk

torch.set_num_threads(2)


def lartpc(h, angles_deg=(0.0,), gap=3.0, radius=0.15):
    """Liquid argon in a 2 m box with absorbing wire planes at z = 0, gap,
    2*gap, ...: 3 mm pitch, 1 m x 1 m, wires at `angles_deg` to x; from
    host namespace h (test_torch_host.host)."""
    lar = h.Material('lar')
    lar.set('refractive_index', 1.38)
    lar.set('absorption_length', 1e6)
    lar.set('scattering_length', 1e6)
    metal = h.Material('metal')
    metal.set('refractive_index', 1.5)
    metal.set('absorption_length', 1e-3)
    metal.set('scattering_length', 1e6)
    wire_surface = h.Surface('wire')
    wire_surface.set('absorb', 1)

    geo = h.Geometry(h.vacuum)
    geo.add_solid(h.Solid(h.box(2000, 2000, 2000), lar, h.vacuum))
    for i, deg in enumerate(angles_deg):
        a = np.radians(deg)
        geo.add_wireplane(h.WirePlane(
            origin=(0, 0, i * gap), u=(np.cos(a), np.sin(a), 0),
            v=(-np.sin(a), np.cos(a), 0), pitch=3.0, radius=radius,
            umin=-500, umax=500, vmin=-500, vmax=500,
            surface=wire_surface, material_inner=metal, material_outer=lar))
    geo.flatten()
    return geo


@pytest.fixture(scope='module', params=['single', 'uvy'])
def planes(request):
    "The planes as each package builds them: (name, JAX, port arrays)."
    angles = (0.0,) if request.param == 'single' else (0.0, 60.0, -60.0)
    return (request.param, jtypes.build_geometry_arrays(lartpc(J, angles)),
            ttypes.build_geometry_arrays(lartpc(T, angles)))


def test_wireplane_arrays_match_jax(planes):
    _, ga, ta = planes
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
    """float64 decides: the port's hits are a float64 solve's of every
    wire (hit or miss; distance within 1e-4 mm, the rounding of the rays'
    f32 plane coordinates; normal within 1e-3), classified; and on the
    rays where the JAX package's hit is the float64 solve's too (the same
    hit or miss, the distance within 1e-4 mm), the port's is JAX's: the
    same hit, distance and normal within twice that, media, surface and
    side equal. JAX's f32 quadratic from the ray's origin is off on the
    others."""
    name, ga, ta = planes
    pos, d = _rays(kind)
    n = len(pos)
    active = np.ones(n, bool)
    if kind != 'head_on':
        active[::11] = False
    jref = jax.jit(lambda p, q, a: jax_wires(p, q, ga, a))(pos, d, active)
    got = intersect_wireplanes(torch.from_numpy(pos), torch.from_numpy(d),
                               ta, torch.from_numpy(active))
    t64, plane64, vn, nn, _ = f64_walk(pos, d, ta.wireplanes, active)
    f64 = classify((torch.from_numpy(t64.astype(np.float32)),
                    torch.from_numpy(plane64.astype(np.int32)),
                    torch.from_numpy(vn.astype(np.float32)),
                    torch.from_numpy(nn.astype(np.float32))),
                   torch.from_numpy(d), ta.wireplanes)
    f64.distance = torch.from_numpy(t64)
    jhit = np.asarray(jref.hit)
    right = (jhit == (plane64 >= 0)) & (np.abs(np.where(
        jhit, np.asarray(jref.distance) - t64, 0.0)) <= 1e-4)
    assert right.mean() > 0.5
    for ref, lanes, atol in ((f64, np.ones(n, bool), (1e-4, 1e-3)),
                             (jref, right, (2e-4, 2e-3))):
        hit = np.asarray(ref.hit)
        np.testing.assert_array_equal(got.hit.numpy()[lanes], hit[lanes])
        hit = hit & lanes
        np.testing.assert_allclose(got.distance.numpy()[hit],
                                   np.asarray(ref.distance)[hit], rtol=0,
                                   atol=atol[0])
        np.testing.assert_allclose(got.normal.numpy()[hit],
                                   np.asarray(ref.normal)[hit], rtol=0,
                                   atol=atol[1])
        for field in ('material1', 'material2', 'surface',
                      'inside_to_outside'):
            np.testing.assert_array_equal(
                getattr(got, field).numpy()[hit],
                np.asarray(getattr(ref, field))[hit], err_msg=field)
    hit = got.hit.numpy()
    assert hit.sum() > 0 and not hit[~active].any()
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
    ta = ttypes.build_geometry_arrays(lartpc(T, (0.0,)))
    event = T.event
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
