"""The reference's wire planes (reference/wires.py) against the program on
the CPU, at a small size: its wire query finds what the program's plain
wire walk finds on rays near the planes and what a float64 solve of every
wire finds on rays metres away; its transport agrees with the program's
in every history class on a scaled-down `lartpc`; and a planted fault,
the program's wire test put back to the JAX package's f32 quadratic from
the ray's origin, raises path_faults over the cell's limit."""
from __future__ import annotations

import math
import os

import numpy as np
import pytest
import torch

from bench_h100.harness import cell
from bench_h100.reference import wires
from bench_h100.tests.bench_fixtures import small_judge  # noqa: F401

PHOTONS = 1 << 14
SMALL_TPC = dict(active_mm=[400.0, 400.0, 800.0], pmt_grid=[1, 2],
                 vertex_region={'box_half_mm': [200.0, 200.0, 400.0]})


def lartpc(overrides=None):
    return cell.config('lartpc', overrides)


@pytest.fixture(scope='module')
def tpc():
    "(sizes, module, the reference's scene, the program's arrays)."
    from chroma_tpu_torch.ops.types import build_geometry_arrays
    cfg, mod = lartpc()
    scene = mod.reference_scene(cfg, 128.0).to('cpu')
    return cfg, mod, scene, build_geometry_arrays(mod.detector(cfg))


def _rays(cfg, n, seed, near):
    """Rays from within 60 mm of the anode face (near) or 0.5 m to 2.5 m
    from it, aimed at the planes' slab from all sides."""
    gen = torch.Generator().manual_seed(seed)
    ax, ay, az = cfg['active_mm']
    x_face = ax / 2.0

    def u(lo, hi, m=n):
        return lo + (hi - lo) * torch.rand(m, generator=gen,
                                           dtype=torch.float64)
    depth = u(-60.0, 66.0) if near else -u(500.0, 2500.0)
    o = torch.stack([x_face + depth, u(-0.45 * ay, 0.45 * ay),
                     u(-0.45 * az, 0.45 * az)], 1)
    aim = torch.stack([x_face + u(-1.0, 7.0), o[:, 1] + u(-400.0, 400.0),
                       o[:, 2] + u(-400.0, 400.0)], 1)
    d = torch.nn.functional.normalize(aim - o, dim=1)
    if near:
        d = torch.nn.functional.normalize(
            torch.randn((n, 3), generator=gen, dtype=torch.float64), dim=1)
    return o.float(), d.float()


def _brute_force(scene, o, d):
    """The nearest wire hit over every wire of every plane, float64, no
    window: (t, plane)."""
    n = o.shape[0]
    best = torch.full((n,), math.inf, dtype=torch.float64)
    plane = torch.full((n,), -1, dtype=torch.int64)
    for ip, p in enumerate(scene.planes):
        frame = wires._frame(scene, p, o, d)
        for ks in torch.split(torch.arange(p.kmin, p.kmax + 1), 512):
            k = ks.repeat(n)
            f = [x.repeat_interleave(len(ks)) for x in frame]
            t, _, _ = wires._wire_test(p, f, k, 1e-4,
                                       torch.full((len(k),), math.inf),
                                       torch.float64)
            t = t.view(n, len(ks)).min(1).values
            closer = t < best
            best = torch.where(closer, t, best)
            plane = torch.where(closer, ip, plane)
    return best, plane


def test_wire_query_near_rays_is_the_programs_walk(tpc):
    """Rays within 60 mm of the planes, every direction: the reference's
    float64 query and the program's plain walk (K3's twin) meet the same
    plane at the same distance (0.01 mm) on all but grazing rays."""
    from chroma_tpu_torch.ops import wireplane
    cfg, _, scene, arrays = tpc
    o, d = _rays(cfg, 4096, 3, near=True)
    t, plane, _ = wires.wire_query(scene, o, d)
    got_t, got_plane = wireplane.walk_plain(
        o, d, arrays, torch.ones(len(o), dtype=torch.bool))[:2]
    same = (got_plane.long() == plane) & (
        (plane < 0) | ((got_t - t).abs() < 0.01))
    assert int((plane >= 0).sum()) > 100
    assert float(same.double().mean()) > 0.998


def test_wire_query_far_rays_is_the_float64_solve(tpc):
    """Rays 0.5 m to 2.5 m from the planes: the reference's query, which
    tests the wires of each ray's slab chord, finds what a float64 solve of
    every wire of every plane finds."""
    cfg, _, scene, _ = tpc
    o, d = _rays(cfg, 256, 4, near=False)
    t, plane, normal = wires.wire_query(scene, o, d)
    want_t, want_plane = _brute_force(scene, o, d)
    assert torch.equal(plane, want_plane)
    hit = plane >= 0
    assert int(hit.sum()) > 10 and int((~hit).sum()) > 10
    # the query returns distances in f32, as the scene's queries do
    assert torch.allclose(t[hit].double(), want_t[hit], rtol=1e-7,
                          atol=1e-6)
    assert torch.allclose(normal[hit].norm(dim=1), torch.ones(int(hit.sum())))


def test_reference_scene_is_the_programs(tpc):
    """The reference's triangles are the program's, in its order, with its
    channels; its planes hold the program's planes."""
    from chroma_tpu_torch.loader import as_flat_geometry
    cfg, mod, scene, arrays = tpc
    geo = as_flat_geometry(mod.detector(cfg))
    ids = torch.arange(scene.n_triangles)
    v0, e1, e2 = scene.triangle_world(ids)
    ref = torch.stack([v0, v0 + e1, v0 + e2], 1).numpy()
    prog = geo.mesh.vertices[geo.mesh.triangles]
    assert ref.shape == prog.shape and np.abs(ref - prog).max() < 1e-2
    assert (scene.t_channel.numpy()
            == np.asarray(geo.solid_id_to_channel_index)).all()
    wp = arrays.wireplanes
    assert len(scene.planes) == wp.pitch.shape[0] == 3
    for i, p in enumerate(scene.planes):
        assert np.allclose(p.origin, wp.origin[i].numpy())
        assert np.allclose(p.u, wp.u[i].numpy(), atol=1e-7)
        assert np.allclose(p.v, wp.v[i].numpy(), atol=1e-7)
        assert p.kmax - p.kmin + 1 == {0: 2399, 1: 2399, 2: 3457}[i]


def _entry_numbers(seed, tmp_path):
    "The judge's numbers and facts of three small lartpc events."
    ctx = cell.context('lartpc.bomb', seed, 'cpu', cache_dir=str(tmp_path),
                       overrides={'config': dict(SMALL_TPC),
                                  'traffic': {'photons': PHOTONS,
                                              'photons_per_batch':
                                              PHOTONS - 1}})
    mod = cell.load_module(os.path.join(cell.BENCH, 'entries',
                                        'simulate_wires.py'),
                           'bench_h100.entries.simulate_wires')
    entry = mod.Entry(ctx, keep_one_in=1)
    entry.setup()
    for index in entry.warm_indices():
        entry.call(index, window=False)
    for index in range(3):
        entry.call(index, window=True)
    entry.release()
    return entry.judge(entry.reference_scene())


def test_transport_agrees_with_the_program(small_judge, tmp_path):  # noqa: F811
    """The program's small bombs against the reference's transport of the
    same photons: every number within the cell's limits, photons ended on
    the wires on both sides, the wire walk's counts read."""
    numbers, facts = _entry_numbers(77, tmp_path)
    lim = cell.limits('lartpc.bomb')
    assert all(v <= lim[k] for k, v in numbers.items()), numbers
    assert sum(c['on_wire'] for c in facts['path_counts']) > 100
    assert facts['steps_per_photon'] > 1
    assert 0 < facts['wire_steps_per_photon'] < facts['steps_per_photon']
    assert facts['k3_wires_per_photon'] > facts['wire_steps_per_photon']


def _from_origin(pos, direction, wp, ip, active):
    """The JAX package's wire test: each wire's quadratic solved from the
    ray's origin in f32 (c = |w|^2 - r^2), which loses the radius to
    rounding a metre from the wire."""
    from chroma_tpu_torch.ops import wireplane
    from chroma_tpu_torch.ops.linalg import fma
    n = pos.shape[0]
    (valid, k_lo, k_hi, t_in, t_out, du, dv, dn, wu, wv0, wn0, pitch,
     radius, umin, umax) = wireplane._plane_window(pos, direction, wp, ip,
                                                   active)
    a = fma(dv, dv, dn * dn)
    r2 = radius * radius
    eps0 = torch.clamp(1e-6 * r2, min=1e-12)
    inv_a = 1.0 / torch.where(a > 0.0, a, 1.0)
    best_t = torch.full((n,), torch.inf)
    best_vn, best_nn = torch.zeros(n), torch.zeros(n)
    iters = int(torch.where(valid, k_hi - k_lo + 1.0, 0.0).max()) if n else 0
    k = torch.where(valid, k_lo, k_hi + 1.0)
    for _ in range(iters):
        live = valid & (k <= k_hi)
        wv = fma(-k, pitch, wv0)
        b = fma(wv, dv, wn0 * dn)
        r2_0 = fma(wv, wv, wn0 * wn0)
        disc = fma(b, b, -(a * (r2_0 - r2)))
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t_small, t_large = (-b - sq) * inv_a, (-b + sq) * inv_a
        outside, inside = r2_0 > r2 + eps0, r2_0 < r2 - eps0
        t = torch.where(outside, t_small,
                        torch.where(inside, t_large, wireplane.T_MIN))
        ok = live & (disc >= 0.0) & (a > 0.0) & torch.where(
            outside, t_small > wireplane.T_MIN,
            torch.where(inside, t_large > wireplane.T_MIN, True))
        uc = fma(du, t, wu)
        ok = ok & (uc >= umin) & (uc <= umax) & (t >= t_in) & (t <= t_out) \
            & (t < best_t)
        best_t = torch.where(ok, t, best_t)
        best_vn = torch.where(ok, fma(dv, t, wv), best_vn)
        best_nn = torch.where(ok, fma(dn, t, wn0), best_nn)
        k = k + 1.0
    return best_t, best_vn, best_nn


def test_the_origin_quadratic_is_caught(small_judge, tmp_path,  # noqa: F811
                                        monkeypatch):
    """The program's wire test put back to the f32 quadratic from the ray's
    origin: the configuration's check of the walk refuses it, and with the
    check taken out the judge's path_faults exceed the cell's limit
    (photons absorbed on wires their path does not meet)."""
    from chroma_tpu_torch.ops import wireplane
    monkeypatch.setattr(wireplane, '_intersect_one_plane', _from_origin)
    cfg, mod = lartpc(dict(SMALL_TPC))
    from chroma_tpu_torch.ops.types import build_geometry_arrays
    with pytest.raises(RuntimeError, match='exact metres from the wires'):
        mod.check_wire_walk(cfg, build_geometry_arrays(mod.detector(cfg)))
    monkeypatch.setattr(mod, 'check_wire_walk', lambda cfg, arrays: None)
    numbers, _ = _entry_numbers(5, tmp_path)
    assert numbers['path_faults'] > cell.limits('lartpc.bomb')['path_faults']
