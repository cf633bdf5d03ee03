"""K3's plain twin and what K3 is given, on the CPU.

K3 (chroma_tpu_torch/csrc/wire_walk.cu) runs only on the card; here its
plain twin wireplane.walk_plain is held against the JAX package's wire
walk: per lane the nearest plane and, on it, the nearest wire's distance
and transverse coordinates, as chroma_tpu.ops.wireplane's per-plane
while_loop (_intersect_one_plane, compiled) gives them and
intersect_wireplanes reduces them over the planes, wherever those are a
float64 solve's of every wire (tests/wire_cases.py); float64 decides, and
the port is the float64 solve's on every lane (the plane index exactly,
the floats within 1e-4 mm): it solves about the closest approach on
purpose, where JAX's f32 quadratic from the ray's origin loses the
wire's radius to rounding. On rays 0.5 m to 3 m from
three MicroBooNE-pitch planes walk_plain and intersect_wireplanes are
the float64 solve's, and walk_plain is bit for bit a walk of every wire
(its window, the ray's slab chord, shuts out no wire that can be hit).
The plane table K3 reads holds the planes' fields in its documented
columns, `walk` dispatches to the plain twin on the CPU without counting
a launch, and intersect_wireplanes is the classification of the walk."""
import numpy as np
import pytest
import torch
import jax

from chroma_tpu.ops import types as jtypes
from chroma_tpu.ops import wireplane as jwire
from chroma_tpu_torch.ops import types as ttypes
from chroma_tpu_torch.ops import cuda_build, wire_kernel, wireplane
from chroma_tpu_torch.ops.linalg import fma

from test_torch_host import J, T, same_native_kit  # noqa: F401
from test_torch_wireplane import _rays, lartpc
from wire_cases import f64_walk, far_rays, microboone_planes

torch.set_num_threads(2)


@pytest.fixture(scope='module', params=['single', 'uvy'])
def planes(request):
    "The planes as each package builds them: (JAX, port arrays)."
    angles = (0.0,) if request.param == 'single' else (0.0, 60.0, -60.0)
    return (jtypes.build_geometry_arrays(lartpc(J, angles)),
            ttypes.build_geometry_arrays(lartpc(T, angles)))


def _jax_walk(ga, pos, d, active):
    "JAX's per-plane walks reduced over the planes as intersect_wireplanes."
    wp = ga.wireplanes
    n = len(pos)
    best_t = np.full(n, np.inf, np.float32)
    best_plane = np.full(n, -1, np.int32)
    best_vn = np.zeros(n, np.float32)
    best_nn = np.zeros(n, np.float32)
    for ip in range(wp.pitch.shape[0]):
        t, vn, nn = (np.asarray(x) for x in jax.jit(
            lambda p, q, a, ip=ip: jwire._intersect_one_plane(
                p, q, wp, ip, a))(pos, d, active))
        closer = t < best_t
        best_t = np.where(closer, t, best_t)
        best_plane = np.where(closer, ip, best_plane)
        best_vn = np.where(closer, vn, best_vn)
        best_nn = np.where(closer, nn, best_nn)
    return best_t, best_plane, best_vn, best_nn


F64_ATOL = 1e-4   # mm: the rounding of the rays' f32 plane coordinates


def jax_right(want, f64):
    """Lanes where JAX's walk is the float64 solve's: the same plane and,
    on a hit, distance and offsets within F64_ATOL."""
    same = want[1] == f64[1]
    close = np.ones_like(same)
    for i in (0, 2, 3):
        close &= np.abs(np.where(f64[1] >= 0, want[i] - f64[i], 0.0)) \
            <= F64_ATOL
    return same & close


@pytest.mark.parametrize('kind', ['oblique', 'isotropic'])
def test_walk_plain_matches_jax(planes, kind):
    """float64 decides: on every lane the port's walk is the float64
    solve's (the same plane; distance and offsets within 1e-4 mm), and
    on the lanes where JAX's is too, the port's is JAX's (the same plane,
    floats within twice that). JAX's f32 quadratic from the ray's origin
    is off on the others (a wrong plane on up to 9 lanes in 4096,
    distances by up to 9 mm)."""
    ga, ta = planes
    pos, d = _rays(kind)
    active = np.ones(len(pos), bool)
    active[::11] = False
    want = _jax_walk(ga, pos, d, active)
    got = [x.numpy() for x in wireplane.walk_plain(
        torch.from_numpy(pos), torch.from_numpy(d), ta,
        torch.from_numpy(active))]
    f64 = f64_walk(pos, d, ta.wireplanes, active)
    right = jax_right(want, f64)
    assert right.mean() > 0.5
    assert got[1].dtype == np.int32
    for ref, lanes, atol in ((f64, np.ones_like(right), F64_ATOL),
                             (want, right, 2 * F64_ATOL)):
        np.testing.assert_array_equal(got[1][lanes], ref[1][lanes])
        hit = lanes & (ref[1] >= 0)
        assert np.isinf(got[0][lanes & ~hit]).all()
        for name, a, b in zip(('t', 'vn', 'nn'), (got[0], got[2], got[3]),
                              (ref[0], ref[2], ref[3])):
            np.testing.assert_allclose(a[hit], b[hit], rtol=0, atol=atol,
                                       err_msg=name)
    hit = got[1] >= 0
    assert hit.sum() > 0 and not hit[~active].any()


@pytest.fixture(scope='module')
def microboone():
    "Three planes at MicroBooNE's pitch and wire size, as the port has them."
    return ttypes.build_geometry_arrays(microboone_planes())


def test_walk_plain_is_exact_on_far_rays(microboone):
    """Seeded rays 0.5 m to 3 m from three MicroBooNE-pitch planes:
    walk_plain's hits, planes and distances are the float64 solve's
    (JAX's f32 quadratic from the ray's origin finds wires there that the
    rays miss)."""
    pos, d = far_rays(4096)
    got = wireplane.walk_plain(torch.from_numpy(pos), torch.from_numpy(d),
                               microboone, torch.ones(4096, dtype=torch.bool))
    t64, plane64, _, _, clear = f64_walk(pos, d, microboone.wireplanes)
    sure = clear > 1e-3      # no wire grazed within 1e-3 mm of its surface
    assert sure.mean() > 0.98
    np.testing.assert_array_equal(got[1].numpy()[sure], plane64[sure])
    hit = sure & (plane64 >= 0)
    assert hit.sum() > 200 and (sure & (plane64 < 0)).sum() > 200
    np.testing.assert_allclose(got[0].numpy()[hit], t64[hit], rtol=0,
                               atol=1e-3)


def _every_wire_walk(pos, direction, geometry, active):
    """walk_plain's wire test and tie rule with no window: each plane's
    wires kmin..kmax in ascending order, in f32 with the same roundings,
    a hit kept only when strictly nearer; the planes combined in order."""
    wp = geometry.wireplanes
    n = pos.shape[0]
    best = (torch.full((n,), torch.inf),
            torch.full((n,), -1, dtype=torch.int32), torch.zeros(n),
            torch.zeros(n))
    for ip in range(wp.pitch.shape[0]):
        (_, _, _, t_in, t_out, du, dv, dn, wu, wv0, wn0, pitch, radius, umin,
         umax) = wireplane._plane_window(pos, direction, wp, ip, active)
        kmin = int(torch.ceil((wp.vmin[ip] - wp.v0[ip]) / pitch))
        kmax = int(torch.floor((wp.vmax[ip] - wp.v0[ip]) / pitch))
        a_coef = fma(dv, dv, dn * dn)
        r2 = radius * radius
        eps0 = torch.clamp(1e-6 * r2, min=1e-12)
        inv_a = 1.0 / torch.where(a_coef > 0.0, a_coef, 1.0)
        t_best = torch.full((n,), torch.inf)
        vn_best, nn_best = torch.zeros(n), torch.zeros(n)
        for k in range(kmin, kmax + 1):
            wv = fma(torch.full((n,), -float(k)), pitch, wv0)
            t0 = -fma(wv, dv, wn0 * dn) * inv_a
            ev = fma(dv, t0, wv)
            en = fma(dn, t0, wn0)
            h2 = (r2 - fma(ev, ev, en * en)) * inv_a
            half = torch.sqrt(torch.clamp(h2, min=0.0))
            r2_0 = fma(wv, wv, wn0 * wn0)
            outside, inside = r2_0 > r2 + eps0, r2_0 < r2 - eps0
            t = torch.where(outside, t0 - half,
                            torch.where(inside, t0 + half, wireplane.T_MIN))
            uc = fma(du, t, wu)
            ok = active & (h2 >= 0.0) & (a_coef > 0.0) \
                & (t > wireplane.T_MIN) & (uc >= umin) & (uc <= umax) \
                & (t >= t_in) & (t <= t_out) & (t < t_best)
            t_best = torch.where(ok, t, t_best)
            vn_best = torch.where(ok, fma(dv, t, wv), vn_best)
            nn_best = torch.where(ok, fma(dn, t, wn0), nn_best)
        closer = t_best < best[0]
        best = (torch.where(closer, t_best, best[0]),
                torch.where(closer, ip, best[1]),
                torch.where(closer, vn_best, best[2]),
                torch.where(closer, nn_best, best[3]))
    return best


def test_window_is_the_slab_chord(microboone):
    """On rays 0.5 m to 3 m from three MicroBooNE-pitch planes, walk_plain
    equals bit for bit a walk of every wire of every plane with the same
    wire test and tie rule: no wire outside the window -- the ray's chord
    through the slab |n| <= radius, one wire more on each side -- can be
    hit. And the window holds a few wires a plane, not the hundreds
    between the chord and the ray's origin."""
    pos, d = (torch.from_numpy(x) for x in far_rays(4096))
    active = torch.ones(4096, dtype=torch.bool)
    got = wireplane.walk_plain(pos, d, microboone, active)
    want = _every_wire_walk(pos, d, microboone, active)
    assert int((want[1] >= 0).sum()) > 200
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    windows = torch.stack(wireplane.candidate_windows(pos, d, microboone,
                                                      active))
    valid = windows > 0
    assert int(valid.sum()) > 4096
    assert float(windows.sum()) / int(valid.sum()) <= 6.0


def test_intersect_wireplanes_is_exact_on_far_rays(microboone):
    """intersect_wireplanes on the far rays: hit or miss, distance and the
    normal (the float64 solve's outward normal at the hit, facing the
    photon: it tells the planes apart) as the float64 solve gives them."""
    pos, d = far_rays(4096, seed=8)
    got = wireplane.intersect_wireplanes(
        torch.from_numpy(pos), torch.from_numpy(d), microboone,
        torch.ones(4096, dtype=torch.bool))
    t64, plane64, vn, nn, clear = f64_walk(pos, d, microboone.wireplanes)
    sure = clear > 1e-3
    assert sure.mean() > 0.98
    np.testing.assert_array_equal(got.hit.numpy()[sure], plane64[sure] >= 0)
    hit = sure & (plane64 >= 0)
    assert hit.sum() > 200 and (sure & ~hit).sum() > 200
    np.testing.assert_allclose(got.distance.numpy()[hit], t64[hit], rtol=0,
                               atol=1e-3)
    wp = microboone.wireplanes
    ip = np.clip(plane64, 0, None)
    out = vn[:, None] * wp.v.numpy()[ip] + nn[:, None] * wp.w.numpy()[ip]
    out /= np.linalg.norm(out, axis=1, keepdims=True)
    facing = np.where(((out * -d).sum(1) > 0)[:, None], out, -out)
    # the hit point's f32 distance carries about 2e-4 mm at 3 m, which
    # turns the normal by that over the wire's 0.075 mm radius
    np.testing.assert_allclose(got.normal.numpy()[hit], facing[hit],
                               atol=1e-2)


def test_plane_table_holds_the_planes(planes):
    """K3's plane table: origin, u, v, w, pitch, radius, umin, umax, vmin,
    vmax, v0 in that column order, one row a plane."""
    _, ta = planes
    wp = ta.wireplanes
    table = wire_kernel.planes(ta)
    assert table is wire_kernel.planes(ta)       # packed once
    assert table.shape == (wp.pitch.shape[0], wire_kernel.PLANE_WORDS)
    cols = [wp.origin, wp.u, wp.v, wp.w] + [
        getattr(wp, f)[:, None] for f in ('pitch', 'radius', 'umin', 'umax',
                                          'vmin', 'vmax', 'v0')]
    assert torch.equal(table, torch.cat(cols, dim=1))


def test_walk_on_the_cpu_is_the_plain_twin(planes):
    """`walk` on CPU tensors runs walk_plain and launches nothing, and
    intersect_wireplanes classifies the walk."""
    _, ta = planes
    pos, d = (torch.from_numpy(x) for x in _rays('isotropic', 1024))
    active = torch.ones(1024, dtype=torch.bool)
    before = cuda_build.launches['k3']
    got = wire_kernel.walk(pos, d, ta, active)
    want = wireplane.walk_plain(pos, d, ta, active)
    assert cuda_build.launches['k3'] == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    hit = wireplane.intersect_wireplanes(pos, d, ta, active)
    ref = wireplane.classify(want, d, ta.wireplanes)
    for name in ('hit', 'distance', 'normal', 'material1', 'material2',
                 'surface', 'inside_to_outside'):
        assert torch.equal(getattr(hit, name), getattr(ref, name)), name
    with pytest.raises(ValueError):
        wire_kernel.launch(pos[:, :2].contiguous(), d, wire_kernel.planes(ta),
                           active)
