"""CUDA kernels of the torch port against their plain PyTorch versions.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one:
a CUDA kernel has no CPU mode. The file imports neither JAX nor
chroma_tpu, so it runs on a machine that has only the port's dependencies
(--noconftest: tests/conftest.py sets up JAX for the other files):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

import chroma_tpu_torch
from chroma_tpu_torch import event, gpu
from chroma_tpu_torch.detector import Detector
from chroma_tpu_torch.geometry import Geometry, Material, Solid, Surface
from chroma_tpu_torch.geometry import vacuum
from chroma_tpu_torch.demo.optics import water, glass
from chroma_tpu_torch.make import box, sphere
from chroma_tpu_torch.bvh.wide import build_instanced_bvh
from chroma_tpu_torch.ops import mesh_wide, visit_kernel
from chroma_tpu_torch.ops.photon import PhotonState
from chroma_tpu_torch.ops.types import (build_geometry_arrays,
                                        pack_material_codes)

from daq_cases import (DAQ_CASES, channel_arrays_equal, daq_case,
                       daq_geometries, daq_photons, daq_uniforms)
from wire_cases import f64_walk, far_rays, microboone_planes

torch.set_num_threads(2)

FORMATS = {'f32': (0, 'f32'), 'bf16': (32, 'bf16'), 'q8': (32, 'q8')}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


@pytest.fixture
def prof_counters(monkeypatch):
    "The profiler's counters, fresh and counting for the test."
    from chroma_tpu_torch.profiler import profiler
    monkeypatch.setattr(profiler, 'enabled', True)
    monkeypatch.setattr(profiler, 'regions', type(profiler.regions)(
        profiler.regions.default_factory))
    monkeypatch.setattr(profiler, 'counters', type(profiler.counters)(int))
    return profiler.counters


def _table(fmt):
    "The tests/test_visit_kernel.py fixture geometry, as a port table."
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
    pf, bf = FORMATS[fmt]
    return build_instanced_bvh(instances, material_codes=codes,
                               packed_fanout=pf, bounds_fmt=bf)


def _rays(n, seed, masked, limited, device):
    """n rays at the fixture from random points: a share `masked` of the
    lanes masked out and a share `limited` with a distance limit; half of
    the rest exclude their first hit."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(-200, 200, (n, 3)).astype(np.float32)
    d = (rs.uniform((-150, -50, -40), (150, 50, 40), (n, 3)) - o)
    d[:16, 1:] = 0.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    mask = rs.uniform(size=n) >= masked
    limit = np.where(rs.uniform(size=n) < limited, rs.uniform(10, 300, n),
                     np.inf).astype(np.float32)
    relast = rs.uniform(size=n) < 0.5
    return ([torch.from_numpy(x).to(device) for x in (o, d)],
            torch.from_numpy(mask).to(device),
            torch.from_numpy(limit).to(device),
            torch.from_numpy(relast).to(device))


def _assert_same(got, ref, n_hit_min):
    tri, dist, code, normal, iid, visits = ref
    assert (tri >= 0).sum() >= n_hit_min
    for name, a, b in (('tri', got[0], tri), ('code', got[2], code),
                       ('iid', got[4], iid), ('visits', got[5], visits)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    hit = tri >= 0
    np.testing.assert_array_equal(got[1][~hit], dist[~hit])
    np.testing.assert_allclose(got[1][hit], dist[hit], rtol=1e-5)
    np.testing.assert_allclose(got[3][hit], normal[hit], rtol=1e-5,
                               atol=1e-5 * np.abs(normal[hit]).max())


def _query(tw, n, seed, masked, limited, device):
    "(args with last_hit, mask and limit; the plain version's outputs)."
    args, mask, limit, relast = _rays(n, seed, masked, limited, device)
    first = mesh_wide.traverse(tw, *args)[0]
    last = torch.where(relast, first, -1).to(torch.int32)
    full = (*args, last, mask, limit)
    return full, [x.cpu().numpy() for x in mesh_wide.traverse(tw, *full)]


@pytest.mark.cuda
@pytest.mark.parametrize('n', [8192, 10000])
@pytest.mark.parametrize('fmt', ['f32', 'bf16', 'q8'])
def test_visit_kernel_matches_plain(cuda, fmt, n):
    tw = _table(fmt).to(cuda)
    full, ref = _query(tw, n, 7, 0.1, 0.25, cuda)
    before = visit_kernel.launches
    got = [x.cpu().numpy() for x in visit_kernel.traverse(tw, *full)]
    torch.cuda.synchronize()
    assert visit_kernel.launches == before + 1
    _assert_same(got, ref, n // 4)


@pytest.mark.cuda
@pytest.mark.parametrize('persistent', [False, True])
@pytest.mark.parametrize('group', [16, 32])
@pytest.mark.parametrize('fmt', ['f32', 'bf16', 'q8'])
def test_visit_kernel_schedules_match_plain(cuda, fmt, group, persistent):
    """Each launch of the walk -- a grid of one group per ray or persistent
    groups taking rays from a counter, 16 or 32 lanes a ray (16 lanes give
    each lane two children of a fanout-32 row) -- on a ray set
    with many masked lanes (60%) and many distance limits (60%), where
    groups finish at very different times. Visits by node kind too."""
    tw = _table(fmt).to(cuda)
    full, ref = _query(tw, 10000, 8, 0.6, 0.6, cuda)
    got = [x.cpu().numpy() for x in visit_kernel.launch(
        tw, *full, group=group, persistent=persistent)]
    _assert_same(got, ref, 1000)
    kinds = visit_kernel.launch(tw, *full, by_kind=True, group=group,
                                persistent=persistent)[5].cpu().numpy()
    np.testing.assert_array_equal(kinds, mesh_wide.traverse(
        tw, *full, by_kind=True)[5].cpu().numpy())
    np.testing.assert_array_equal(kinds.sum(axis=1), ref[5])


@pytest.mark.cuda
def test_thread_design_matches_plain(cuda):
    "The one-thread-per-ray yardstick computes the same function."
    tw = _table('bf16').to(cuda)
    full, ref = _query(tw, 8192, 9, 0.1, 0.25, cuda)
    got = [x.cpu().numpy() for x in visit_kernel.traverse_thread(tw, *full)]
    _assert_same(got, ref, 2048)


@pytest.mark.cuda
def test_visit_kernel_rejects_bad_input(cuda):
    tw = _table('bf16').to(cuda)
    o = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError):
        visit_kernel.traverse(tw, o, o.double())
    with pytest.raises(ValueError):     # no 8-lane groups
        visit_kernel.launch(tw, o, o, group=8)


def _device_bomb(n, seed, device):
    """An isotropic 400 nm bomb at the origin made on `device` from an
    explicit generator: a PhotonState that never was host Photons."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d = torch.randn((n, 3), generator=gen, device=device)
    d = d / d.norm(dim=1, keepdim=True)
    pol = torch.linalg.cross(torch.randn((n, 3), generator=gen,
                                         device=device), d)
    pol = pol / pol.norm(dim=1, keepdim=True)
    return PhotonState(
        pos=torch.zeros((n, 3), device=device), dir=d, pol=pol,
        wavelength=torch.full((n,), 400.0, device=device),
        t=torch.zeros(n, device=device), weight=torch.ones(n, device=device),
        flags=torch.zeros(n, dtype=torch.int32, device=device),
        last_hit_triangle=torch.full((n,), -1, dtype=torch.int32,
                                     device=device),
        evidx=torch.zeros(n, dtype=torch.int32, device=device),
        cur_mat=torch.full((n,), -1, dtype=torch.int32, device=device))


def _box_detector():
    "A 1 m water box whose photocathode detects half the photons."
    mat = Material('water')
    for name, value in (('refractive_index', 1.33),
                        ('absorption_length', 1e5),
                        ('scattering_length', 1e5)):
        mat.set(name, value)
    pc = Surface('pc')
    pc.set('detect', 0.5)
    pc.set('absorb', 0.5)
    det = Detector(vacuum)
    det.add_pmt(Solid(box(1000.0, 1000, 1000), mat, vacuum, surface=pc))
    det.set_time_dist_gaussian(1.2, -6.0, 6.0)
    det.set_charge_dist_gaussian(1.0, 0.1, 0.5, 1.5)
    return det


@pytest.mark.cuda
def test_device_source_simulation_and_facade(cuda, monkeypatch):
    """A PhotonState made on the card goes through Simulation and through
    GPUPhotons.propagate + GPUDaq with the same seed: equal end states,
    hits and channels, and both launch the visit kernel. Both take the
    fused route by one schedule (the first bomb of a batch size would
    otherwise probe and the second run the tuned schedule)."""
    monkeypatch.setenv('CHROMA_FUSED_SCHEDULE', '1:2,2:2')
    det = _box_detector()
    state = _device_bomb(20000, 3, cuda)

    before = visit_kernel.launches
    ev = next(chroma_tpu_torch.Simulation(det, seed=5, device=cuda)
              .simulate(state, keep_photons_end=True, run_daq=True,
                        max_steps=100))
    assert visit_kernel.launches > before
    before = visit_kernel.launches
    gg = gpu.GPUDetector(det, device=cuda)
    gp = gpu.GPUPhotons(state)
    rng = gpu.get_rng_states(len(state), seed=5)
    gp.propagate(gg, rng, max_steps=100)
    assert visit_kernel.launches > before
    end = gp.get()
    for name in ('pos', 'dir', 'pol', 't', 'flags', 'last_hit_triangles'):
        np.testing.assert_array_equal(getattr(end, name),
                                      getattr(ev.photons_end, name),
                                      err_msg=name)
    hits = gp.get_flat_hits(gg)
    assert 0 < len(hits) == len(ev.flat_hits)
    np.testing.assert_array_equal(hits.channel, ev.flat_hits.channel)
    daq = gpu.GPUDaq(gg)
    daq.begin_acquire()
    daq.acquire(gp, rng)
    channels = daq.end_acquire().get()
    for name in ('hit', 't', 'q', 'flags'):
        np.testing.assert_array_equal(getattr(channels, name),
                                      getattr(ev.channels, name),
                                      err_msg=name)
    assert (ev.flat_hits.flags & event.SURFACE_DETECT).all()


N_SHARDED = 1 << 16


def nccl_rank(n, seed):
    """One rank of test_nccl_ranks_match_one_process: the sharded
    propagation and DAQ of a bomb on the box detector, on the rank's
    card; returns numpy results."""
    from chroma_tpu_torch.parallel import (photon_mesh,
                                           propagate_and_daq_sharded)
    mesh = photon_mesh()
    ga = build_geometry_arrays(_box_detector()).to(mesh.device)
    state = _device_bomb(n, 3, torch.device('cpu'))
    before = visit_kernel.launches
    photons, channels = propagate_and_daq_sharded(
        state.map(lambda a: a.to(mesh.device)), ga, seed, max_steps=100,
        mesh=mesh)
    return dict(device=str(mesh.device), current=torch.cuda.current_device(),
                launches=visit_kernel.launches - before,
                state={k: v.cpu().numpy() for k, v in vars(photons).items()},
                daq=[x.cpu().numpy() for x in (channels.earliest_time,
                                               channels.charge,
                                               channels.histories)])


@pytest.mark.cuda
def test_nccl_ranks_match_one_process(cuda, monkeypatch):
    """propagate_and_daq_sharded over NCCL, one rank a card: each rank on
    its own card (and that card current), K1 launched in each, every rank
    the same result; the gathered state equals each slice propagated
    alone here with the rank's seed, bit for bit, and the reduced readout
    equals each slice's run_daq reduced by numpy min / sum / OR (times and
    histories bit for bit, charge at the charge unit)."""
    from chroma_tpu_torch.ops import daq
    from chroma_tpu_torch.ops.propagate import propagate
    from chroma_tpu_torch.ops.sample import make_generator
    from chroma_tpu_torch.parallel import PhotonMesh, run_ranks, shard_seed
    from chroma_tpu_torch.parallel.sharding import DAQ_SITE
    k = torch.cuda.device_count()
    if k < 2:
        pytest.skip('needs two or more cards: NCCL takes one rank a card')
    # one fused schedule in the ranks (which inherit it) and here, where
    # the first slice alone would otherwise probe and the next be tuned
    monkeypatch.setenv('CHROMA_FUSED_SCHEDULE', '1:2,2:2')
    seed = 13
    res = run_ranks(nccl_rank, k, args=(N_SHARDED, seed), backend='nccl',
                    timeout=600)
    assert [r['device'] for r in res] == ['cuda:%d' % i for i in range(k)]
    assert [r['current'] for r in res] == list(range(k))
    assert min(r['launches'] for r in res) > 0
    for r in res[1:]:
        for name, field in r['state'].items():
            assert field.tobytes() == res[0]['state'][name].tobytes(), name
        for a, b in zip(r['daq'], res[0]['daq']):
            assert a.tobytes() == b.tobytes()
    ga = build_geometry_arrays(_box_detector()).to(cuda)
    state = _device_bomb(N_SHARDED, 3, cuda)
    per = N_SHARDED // k
    parts = []
    for rank in range(k):
        mesh = PhotonMesh(group=None, size=k, rank=rank, device=cuda)
        alone = propagate(state.map(lambda a: a[rank * per:
                                                (rank + 1) * per]),
                          ga, shard_seed(seed, mesh), max_steps=100)
        for name, field in vars(alone).items():
            assert field.cpu().numpy().tobytes() == \
                res[0]['state'][name][rank * per:(rank + 1) * per] \
                .tobytes(), name
        gen = make_generator(cuda, *shard_seed((seed, DAQ_SITE), mesh))
        arr = daq.run_daq(alone, ga, gen)
        parts.append([x.cpu().numpy() for x in (
            arr.earliest_time, arr.charge, arr.histories)])
    t, q, h = res[0]['daq']
    assert t.tobytes() == np.min([p[0] for p in parts], axis=0).tobytes()
    assert h.view(np.uint32).tobytes() == np.bitwise_or.reduce(
        [p[2].view(np.uint32) for p in parts], axis=0).tobytes()
    unit = float(ga.detector.charge_unit)
    np.testing.assert_array_equal(
        np.round(q / unit), np.round(np.sum([p[1] for p in parts], axis=0)
                                     / unit))
    assert (t < 1e8).sum() == 1


def _camera_scene():
    "The fixture solids, colored and half transparent, as a geometry."
    geo = Geometry(water)
    geo.add_solid(Solid(box(100.0, 80.0, 60.0), glass, water,
                        color=0x80FF3366))
    geo.add_solid(Solid(sphere(30.0, nsteps=24), glass, water,
                        color=0x4000FF40), displacement=(120.0, 0.0, 0.0))
    geo.add_solid(Solid(box(40.0, 40.0, 40.0), glass, water,
                        color=0x002060FF), displacement=(-120.0, 30.0, 0.0))
    geo.flatten()
    return geo


@pytest.mark.cuda
def test_camera_rays_match_plain(cuda):
    """The kernel on camera rays from outside the scene, first layer (no
    mask) and second layer (last hits excluded, the rays still active):
    all six outputs against the plain version."""
    from chroma_tpu_torch.camera import _scene_pose
    from chroma_tpu_torch.ops.render import _unit, peel
    from chroma_tpu_torch.ops.types import build_geometry_arrays
    geo = _camera_scene()
    ga = build_geometry_arrays(geo).to(cuda)
    rays = _scene_pose(geo)[0].rays((160, 120), device=cuda)
    o, d = rays.pos.contiguous(), _unit(rays.dir)
    ref = [x.cpu().numpy() for x in mesh_wide.traverse(ga.wide, o, d)]
    got = [x.cpu().numpy() for x in visit_kernel.traverse(ga.wide, o, d)]
    _assert_same(got, ref, 500)
    pos, last = o, torch.full((len(o),), -1, dtype=torch.int32, device=cuda)
    active = torch.ones(len(o), dtype=torch.bool, device=cuda)
    for tri, dist in peel(o, d, ga, 1):
        hit = tri >= 0
        pos = torch.where(hit[:, None], pos + dist[:, None] * d, pos)
        last = torch.where(hit, tri, last)
        active = active & hit
    full = (pos, d, last, active)
    ref = [x.cpu().numpy() for x in mesh_wide.traverse(ga.wide, *full)]
    got = [x.cpu().numpy() for x in visit_kernel.traverse(ga.wide, *full)]
    _assert_same(got, ref, 100)
    assert (ref[0][~active.cpu().numpy()] == -1).all()


@pytest.mark.cuda
def test_render_card_against_cpu(cuda):
    """render, distances and snapshot on the card (kernel) and on the CPU
    (plain version) from the same rays: at least 99.9% of the pixels equal,
    every channel within 1 count, distances to rtol 1e-5; the card's
    frames launch the kernel, one launch a layer."""
    from chroma_tpu_torch.camera import _scene_pose, snapshot
    from chroma_tpu_torch.ops import render
    from chroma_tpu_torch.ops.types import build_geometry_arrays
    geo = _camera_scene()
    ga = build_geometry_arrays(geo)
    pose = _scene_pose(geo)[0]
    out = {}
    for dev in ('cpu', cuda):
        rays = pose.rays((160, 120), device=dev)
        before = visit_kernel.launches
        pix = rays.render(ga.to(dev), alpha_depth=6)
        out[str(dev)] = (render.pixels_to_host(pix),
                         render.distances(rays.pos, rays.dir,
                                          ga.to(dev)).cpu().numpy(),
                         visit_kernel.launches - before)
    (cp, cd, cl), (gp, gd, gl) = out['cpu'], out[str(cuda)]
    assert cl == 0 and 2 <= gl <= 7
    assert (cp != gp).mean() <= 1e-3 and (cp != 0xFFFFFFFF).sum() > 500
    for shift in (24, 16, 8, 0):
        assert np.abs(((cp >> shift) & 0xFF).astype(int)
                      - ((gp >> shift) & 0xFF).astype(int)).max() <= 1
    hit = np.isfinite(cd)
    np.testing.assert_array_equal(hit, np.isfinite(gd))
    np.testing.assert_allclose(gd[hit], cd[hit], rtol=1e-5)
    image = snapshot(geo, size=(160, 120), alpha_depth=6, device=cuda)
    assert image.tobytes() == snapshot(geo, size=(160, 120), alpha_depth=6,
                                       device='cpu').tobytes()


@pytest.mark.cuda
def test_photon_map_card_against_cpu(cuda):
    """update_xyz_lookup's index_add on the card against the CPU's to rtol
    1e-4 (the card adds in no fixed order), and hybrid_render on the card
    lights the matte walls a camera sees."""
    from chroma_tpu_torch.camera import CameraPose
    from chroma_tpu_torch.ops import render
    from chroma_tpu_torch.ops.types import build_geometry_arrays
    matte = Surface('matte')
    matte.set('reflect_diffuse', 0.8)
    matte.set('absorb', 0.2)
    geo = Geometry(vacuum)
    geo.add_solid(Solid(box(2000.0, 2000.0, 2000.0), water, vacuum,
                        surface=matte))
    geo.flatten()
    ga = build_geometry_arrays(geo)
    n = 50000
    rs = np.random.RandomState(4)
    state = _device_bomb(n, 6, 'cpu')
    state.flags[:] = torch.from_numpy(np.where(
        rs.uniform(size=n) < 0.7, event.REFLECT_DIFFUSE, 2).astype(np.int32))
    state.last_hit_triangle[:] = torch.from_numpy(
        rs.randint(-1, 12, n).astype(np.int32))
    state.wavelength[:] = torch.from_numpy(
        rs.uniform(380, 680, n).astype(np.float32))
    zero = torch.zeros((12, 3))
    want = render.update_xyz_lookup(state, ga, zero).numpy()
    got = render.update_xyz_lookup(state.to(cuda), ga.to(cuda),
                                   zero.to(cuda)).cpu().numpy()
    assert want.sum() > 1000
    np.testing.assert_allclose(got, want, rtol=1e-4)
    rays = CameraPose((0.0, -900.0, 0.0)).rays((64, 48), device=cuda)
    before = visit_kernel.launches
    pix = render.pixels_to_host(render.hybrid_render(
        rays.pos, rays.dir, ga.to(cuda), (3, 0), nphotons=20000, nbatches=2))
    assert visit_kernel.launches > before
    assert (pix >> 24 == 0xFF).all() and ((pix & 0xFFFFFF) != 0).mean() > 0.9


def _tiny_on(cuda):
    from chroma_tpu_torch import demo
    geo = demo.tiny()
    geo.flatten()
    return build_geometry_arrays(geo).to(cuda)


FUSED_FIELDS = ('pos', 'dir', 'pol', 'wavelength', 't', 'weight', 'flags',
                'last_hit_triangle', 'evidx', 'cur_mat')


@pytest.mark.cuda
def test_graph_replay_matches_eager_fused_route(cuda, prof_counters):
    """The fused bomb on demo.tiny(), one schedule and seed: with every
    step a CUDA graph replay (after the first step at each width, which
    runs eagerly and is captured) and with every step eager, every
    PhotonState field equal bit for bit; K1 launched once a step either
    way (a stage stops a few no-op steps after its last lane died, as many
    as its poll lags behind the card)."""
    from chroma_tpu_torch.ops import propagate as P
    ga = _tiny_on(cuda)
    state = _device_bomb(1 << 15, 7, cuda)
    sched = ((1, 2), (2, 2), (4, 2))
    out = {}
    for use_graphs in (False, True, True):
        launches = visit_kernel.launches
        replays = prof_counters['graphs.replays']
        res, _, abort = P._fused_bomb(state, ga, (9, 2), sched, 100,
                                      use_graphs=use_graphs)
        torch.cuda.synchronize()
        assert not abort
        out.setdefault(use_graphs, []).append(
            (res, visit_kernel.launches - launches,
             prof_counters['graphs.replays'] - replays))
    (eager, k_eager, r_eager), = out[False]
    assert r_eager == 0 and k_eager > 0
    for res, k, r in out[True]:
        for name in FUSED_FIELDS:
            assert torch.equal(getattr(res, name), getattr(eager, name)), \
                name
    (_, k_cold, r_cold), (_, k_warm, r_warm) = out[True]
    assert 0 < r_cold < k_cold          # the eager steps before captures
    assert k_warm == r_warm > 0         # warm: every step a replay


@pytest.mark.cuda
def test_replay_adds_the_captured_k1_launches(cuda, prof_counters):
    """A replay moves visit_kernel.launches by the K1 launches its capture
    recorded (one), and the capture itself by none; a replay counts
    nothing in the profiler (the driver counts once a stage)."""
    from chroma_tpu_torch.ops import graphs
    ga = _tiny_on(cuda)
    state = _device_bomb(4096, 8, cuda)
    from chroma_tpu_torch.ops import step_kernel
    before = visit_kernel.launches
    before2 = step_kernel.launches
    before_pre = step_kernel.pre_launches
    g = graphs.StepGraph(ga, state, False, 0, True)
    assert visit_kernel.launches == before and g.k1 == 1
    assert step_kernel.launches == before2 and g.k2 == 1 and g.k3 == 0
    assert step_kernel.pre_launches == before_pre and g.k2_pre == 1
    for step in range(3):
        g.replay(4, step)
        assert visit_kernel.launches == before + g.k1 * (step + 1)
        assert step_kernel.launches == before2 + g.k2 * (step + 1)
        assert step_kernel.pre_launches == before_pre + g.k2_pre * (step
                                                                   + 1)
    torch.cuda.synchronize()
    assert not prof_counters


def _wire_box(angles=(0.0,)):
    """A water box with absorbing wire planes 3 mm apart from z = 0, their
    wires at `angles` (degrees) to x."""
    from chroma_tpu_torch.geometry import WirePlane
    absorber = Surface('absorber')
    absorber.set('absorb', 1.0)
    geo = Geometry(vacuum)
    geo.add_solid(Solid(box(2000.0, 2000.0, 2000.0), water, vacuum,
                        surface=absorber))
    for i, deg in enumerate(angles):
        a = np.radians(deg)
        geo.add_wireplane(WirePlane(
            origin=(0.0, 0.0, 3.0 * i), u=(np.cos(a), np.sin(a), 0.0),
            v=(-np.sin(a), np.cos(a), 0.0), pitch=3.0, radius=0.15,
            umin=-500, umax=500, vmin=-500, vmax=500, surface=absorber,
            material_inner=glass, material_outer=water))
    geo.flatten()
    return geo


@pytest.mark.cuda
def test_capture_with_host_sync_raises(cuda, monkeypatch, prof_counters):
    """Capturing a step that reads a device value on the host (here the
    wire walk's plain twin, which reads the batch's widest window) raises,
    with no eager retry, and the card stays usable: with K3, which reads
    nothing on the host, the fused route then captures the same step."""
    from chroma_tpu_torch.ops import graphs, wire_kernel, wireplane
    from chroma_tpu_torch.ops import propagate as P
    ga = build_geometry_arrays(_wire_box()).to(cuda)
    state = _device_bomb(4096, 9, cuda)
    before = visit_kernel.launches
    with monkeypatch.context() as mp:
        mp.setattr(wire_kernel, 'walk', wireplane.walk_plain)
        with pytest.raises(RuntimeError):
            graphs.capture(ga, state, False, 0, True)
        assert visit_kernel.launches == before
        assert graphs.lookup(ga, state, False, 0, True) is None
        torch.cuda.synchronize()
    captures = prof_counters['graphs.captures']
    res, _, _ = P._fused_bomb(state, ga, 3, ((1, 2),), 100)
    torch.cuda.synchronize()
    assert prof_counters['graphs.captures'] > captures
    assert visit_kernel.launches > before
    assert not res.alive.any()


def _optics_box():
    """Every surface model, bulk reemission and a wire plane, small: a 2 m
    box of reemitting scintillator behind a wavelength-shifting wall, with
    complex-film, angular, dichroic, default and plain blocks around the
    centre and an absorbing wire plane above it (the all-models detector
    of tests/test_torch_surfaces.py, built from the port alone)."""
    from chroma_tpu_torch.geometry import (
        AngularProps, DichroicProps, WirePlane, SURFACE_COMPLEX, SURFACE_WLS,
        SURFACE_DICHROIC, SURFACE_ANGULAR, standard_wavelengths as wl,
        standard_times)

    def pairs(x, y):
        return np.column_stack([x, np.broadcast_to(y, len(x))]).astype(
            np.float32)

    def gauss_cdf(x, mean, sigma):
        pdf = np.exp(-0.5 * ((x - mean) / sigma) ** 2)
        cdf = np.concatenate([[0.0], np.cumsum((pdf[1:] + pdf[:-1]) / 2)])
        return cdf / cdf[-1]

    scint = Material('wbls')
    for name, value in (('refractive_index', 1.36),
                        ('absorption_length', 3000.0),
                        ('scattering_length', 4000.0)):
        scint.set(name, value)
    scint.comp_reemission_prob = [pairs(wl, 0.6), pairs(wl, 0.9)]
    scint.comp_reemission_wvl_cdf = [pairs(wl, gauss_cdf(wl, 430, 15)),
                                     pairs(wl, gauss_cdf(wl, 480, 25))]
    scint.comp_reemission_time_cdf = [
        pairs(standard_times, 1.0 - np.exp(-standard_times / 5.0)),
        pairs(standard_times, 1.0 - np.exp(-standard_times / 20.0))]
    scint.comp_absorption_length = [pairs(wl, 5000.0), pairs(wl, 7500.0)]
    pc = Surface('pc', model=SURFACE_COMPLEX)
    for name, value in (('detect', 0.3), ('reflect_diffuse', 0.2),
                        ('eta', 2.7), ('k', 1.5)):
        pc.set(name, value)
    pc.thickness = 25.0
    pc.transmissive = 1
    wls = Surface('wls', model=SURFACE_WLS)
    for name, value in (('absorb', 0.5), ('reemit', 0.8),
                        ('reflect_specular', 0.1), ('reflect_diffuse', 0.1)):
        wls.set(name, value)
    wls.set('reemission_cdf', gauss_cdf(wl, 500.0, 20.0))
    wls.transmissive = 1
    dichroic = Surface('dichroic', model=SURFACE_DICHROIC)
    wl_pts = np.array([300.0, 449.0, 451.0, 800.0])
    dichroic.dichroic_props = DichroicProps(
        [0.0, np.pi / 2],
        [np.column_stack([wl_pts, [1.0, 1.0, 0.0, 0.0]])] * 2,
        [np.column_stack([wl_pts, [0.0, 0.0, 0.9, 0.9]])] * 2)
    dichroic.transmissive = 1
    angular = Surface('angular', model=SURFACE_ANGULAR)
    angular.angular_props = AngularProps(
        [0.0, np.pi / 4, np.pi / 2], transmit=[0.8, 0.3, 0.0],
        reflect_specular=[0.1, 0.3, 0.2], reflect_diffuse=[0.05, 0.2, 0.4])
    angular.transmissive = 1
    default = Surface('default')
    for name, value in (('detect', 0.3), ('absorb', 0.2),
                        ('reflect_diffuse', 0.2), ('reflect_specular', 0.1)):
        default.set(name, value)
    wire = Surface('wire')
    wire.set('absorb', 1.0)
    metal = Material('metal')
    for name, value in (('refractive_index', 1.5), ('absorption_length',
                                                    1e-3),
                        ('scattering_length', 1e6)):
        metal.set(name, value)

    det = Detector(vacuum)
    det.add_solid(Solid(box(2000.0, 2000.0, 2000.0), scint, vacuum,
                        surface=wls))
    det.add_pmt(Solid(box(300.0, 300.0, 300.0), glass, scint, surface=pc),
                displacement=(500.0, 0, 0))
    for disp, surf in (((-500.0, 0, 0), angular), ((0, 500.0, 0), dichroic),
                       ((0, -500.0, 0), default), ((0, 0, -500.0), None)):
        det.add_solid(Solid(box(300.0, 300.0, 300.0), glass, scint,
                            surface=surf), displacement=disp)
    det.add_wireplane(WirePlane(
        origin=(0, 0, 100.0), u=(1, 0, 0), v=(0, 1, 0), pitch=3.0,
        radius=1.0, umin=-800, umax=800, vmin=-800, vmax=800, surface=wire,
        material_inner=metal, material_outer=scint))
    det.set_time_dist_gaussian(1.2, -6.0, 6.0)
    det.set_charge_dist_gaussian(1.0, 0.1, 0.5, 1.5)
    det.flatten()
    return det


def _step_inputs(ga, state, seed, use_weights=False, scatter_first=0,
                 prune=True):
    """What K2 is given in a step: the prologue, K1 and (on wire planes)
    K3 on the card, as propagate_step runs them."""
    from chroma_tpu_torch.ops import photon, wire_kernel
    from chroma_tpu_torch.ops.sample import DrawPool, make_generator
    pool = DrawPool(len(state), state.pos.device,
                    generator=make_generator(state.pos.device, seed))
    ph, active, blocks, pruned, limit = photon.step_prologue(
        state, ga, pool, use_weights, prune)
    query = visit_kernel.traverse(ga.wide, ph.pos, ph.dir,
                                  ph.last_hit_triangle, mask=active,
                                  best_limit=limit)[:5]
    wires = wire_kernel.walk(ph.pos, ph.dir, ga, active) \
        if ga.has_wireplanes else None
    return ph, active, blocks, pruned, query, wires


def _lanes_agree(got, ref, min_equal=0.999):
    """K2 against its plain twin: a lane agrees when its integer fields
    are equal and its floats match to rtol 1e-5 (absolute floor 1e-5 of
    the field's scale); at least `min_equal` of the lanes must agree (an
    ulp of the complex arithmetic or a division can move a roulette draw
    across its threshold), and the others are printed."""
    n = len(ref)
    agree = torch.ones(n, dtype=torch.bool)
    for name in ('flags', 'last_hit_triangle', 'cur_mat', 'evidx'):
        agree &= getattr(got, name).cpu() == getattr(ref, name).cpu()
    for name in ('pos', 'dir', 'pol', 'wavelength', 't', 'weight'):
        a = getattr(got, name).cpu().reshape(n, -1)
        b = getattr(ref, name).cpu().reshape(n, -1)
        atol = 1e-5 * max(float(b.abs().max()), 1.0)
        agree &= torch.isclose(a, b, rtol=1e-5, atol=atol).all(dim=1)
    bad = torch.nonzero(~agree).flatten()
    for i in bad[:10].tolist():
        print('lane %d differs' % i, {
            name: (getattr(got, name)[i].tolist(),
                   getattr(ref, name)[i].tolist())
            for name in ('flags', 'cur_mat', 'pos', 'dir', 'weight')})
    assert float(agree.float().mean()) >= min_equal, \
        '%d of %d lanes differ' % (len(bad), n)
    return len(bad)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['tiny', 'optics', 'optics-weights',
                                  'optics-sf+1', 'optics-sf-1', 'wires'])
def test_step_kernel_matches_plain(cuda, case):
    """K2 against its plain twin on the card, same inputs (the prologue,
    K1 and K3 of each step), three steps: every surface model, bulk
    reemission, weights, scatter_first +-1 and wire planes; one launch a
    step."""
    from chroma_tpu_torch.ops import step_kernel
    geo = _optics_box() if case.startswith('optics') else (
        _wire_box((0.0, 60.0, -60.0)) if case == 'wires' else None)
    ga = build_geometry_arrays(geo).to(cuda) if geo is not None \
        else _tiny_on(cuda)
    opts = {'optics-weights': dict(use_weights=True),
            'optics-sf+1': dict(scatter_first=1, prune=False),
            'optics-sf-1': dict(scatter_first=-1, prune=False)}.get(case, {})
    state = _device_bomb(1 << 15, 10, cuda)
    if case == 'wires':
        state = state.replace(pos=state.pos + torch.tensor(
            [0.0, 0.0, -40.0], device=cuda))
    for s in range(3):
        o = dict(opts, scatter_first=opts.get('scatter_first', 0) if s == 0
                 else 0)
        prune = o.pop('prune', True)
        ph, active, blocks, pruned, query, wires = _step_inputs(
            ga, state, (11, s), prune=prune, **o)
        before = step_kernel.launches
        got = step_kernel.after_query(ph, ga, blocks, active, pruned, query,
                                      wires, **o)
        assert step_kernel.launches == before + 1
        ref = step_kernel.after_query_plain(ph, ga, blocks, active, pruned,
                                            query, wires, **o)
        torch.cuda.synchronize()
        _lanes_agree(got, ref)
        state = ref


@pytest.mark.cuda
def test_wire_kernel_matches_plain(cuda):
    """K3 against its plain twin on the card on three U/V/Y planes:
    planes equal, distances and transverse coordinates to rtol 1e-5."""
    from chroma_tpu_torch.ops import wire_kernel, wireplane
    ga = build_geometry_arrays(_wire_box((0.0, 60.0, -60.0))).to(cuda)
    rs = np.random.RandomState(12)
    n = 1 << 16
    pos = np.column_stack([rs.uniform(-600, 600, (n, 2)),
                           rs.uniform(-60, 60, n)]).astype(np.float32)
    d = rs.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    pos, d = (torch.from_numpy(x).to(cuda) for x in (pos, d))
    active = torch.from_numpy(rs.uniform(size=n) > 0.1).to(cuda)
    before = wire_kernel.launches
    got = wire_kernel.walk(pos, d, ga, active)
    assert wire_kernel.launches == before + 1
    ref = wireplane.walk_plain(pos, d, ga, active)
    torch.cuda.synchronize()
    assert torch.equal(got[1], ref[1])
    hit = ref[1] >= 0
    assert int(hit.sum()) > 100
    for a, b in zip(got[::2] + got[3:], ref[::2] + ref[3:]):
        torch.testing.assert_close(a[hit], b[hit], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_wire_kernel_is_exact_on_far_rays(cuda):
    """K3 on rays 0.5 m to 3 m from three MicroBooNE-pitch planes (the
    closest-approach solve): bit for bit its plain twin on the card, and
    on every ray that passes no wire within 1e-3 mm of its surface the
    float64 solve's plane (a miss as -1) and distance within 1e-3 mm."""
    from chroma_tpu_torch.ops import wire_kernel, wireplane
    ga = build_geometry_arrays(microboone_planes()).to(cuda)
    pos, d = far_rays(1 << 14)
    tpos, td = (torch.from_numpy(x).to(cuda) for x in (pos, d))
    active = torch.ones(len(pos), dtype=torch.bool, device=cuda)
    got = wire_kernel.walk(tpos, td, ga, active)
    ref = wireplane.walk_plain(tpos, td, ga, active)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    t64, plane64, _, _, clear = f64_walk(pos, d, ga.wireplanes.to('cpu'))
    sure = clear > 1e-3
    assert sure.mean() > 0.98
    plane = got[1].cpu().numpy()
    np.testing.assert_array_equal(plane[sure], plane64[sure])
    hit = sure & (plane64 >= 0)
    assert hit.sum() > 1000
    np.testing.assert_allclose(got[0].cpu().numpy()[hit], t64[hit], rtol=0,
                               atol=1e-3)


@pytest.mark.cuda
def test_wire_plane_replay_matches_eager(cuda, prof_counters):
    """The fused bomb on a wire-plane geometry takes the graph route: with
    graph replays and with every step eager, same seed, every field equal
    bit for bit; K1, K3 and K2's k2_pre and k2_post launched once a step
    either way."""
    from chroma_tpu_torch.ops import step_kernel, wire_kernel
    from chroma_tpu_torch.ops import propagate as P
    ga = build_geometry_arrays(_optics_box()).to(cuda)
    state = _device_bomb(1 << 15, 13, cuda)
    sched = ((1, 2), (2, 2), (4, 2))
    out = {}
    def counters():
        return (visit_kernel.launches, step_kernel.launches,
                step_kernel.pre_launches, wire_kernel.launches,
                prof_counters['graphs.replays'],
                prof_counters['graphs.captures'])
    for use_graphs in (False, True):
        counts = counters()
        res, _, abort = P._fused_bomb(state, ga, (9, 3), sched, 100,
                                      use_graphs=use_graphs)
        torch.cuda.synchronize()
        assert not abort
        k1, k2, k2_pre, k3, r, c = (now - then for now, then in zip(
            counters(), counts))
        assert k1 == k2 == k2_pre == k3 > 0
        out[use_graphs] = res
        if use_graphs:
            assert r > 0 and c > 0 and k1 == r + c
        else:
            assert r == 0 and c == 0
    for name in FUSED_FIELDS:
        assert torch.equal(getattr(out[True], name),
                           getattr(out[False], name)), name


def _prologue_state(ga, cuda, n=1 << 15):
    """A bomb after two card steps (media known, so lanes prune), with
    NaN positions or directions on some alive lanes and some lanes
    finished: what a step's prologue meets."""
    from chroma_tpu_torch.ops import photon
    from chroma_tpu_torch.ops.sample import DrawPool, make_generator
    state = _device_bomb(n, 14, cuda)
    for s in range(2):
        state = photon.propagate_step(state, ga, DrawPool(
            n, cuda, generator=make_generator(cuda, 15, s)))
    pos, d = state.pos.clone(), state.dir.clone()
    pos[7::97, 1] = float('nan')
    d[11::101, 2] = float('nan')
    d[13::103] = torch.tensor([float('inf'), float('-inf'), 0.0])
    flags = state.flags.clone()
    flags[5::89] |= photon.i32(event.NO_HIT)
    return state.replace(pos=pos, dir=d, flags=flags)


def _assert_prologue_equal(got, ref):
    """k2_pre's step_prologue tuple against the plain one: flags, active
    and pruned lanes equal, limits equal (inf where unpruned)."""
    ph, active, blocks, pruned, limit = got
    rph, ractive, rblocks, rpruned, rlimit = ref
    assert torch.equal(blocks, rblocks)
    assert torch.equal(ph.flags, rph.flags)
    assert torch.equal(active, ractive) and active.dtype == torch.bool
    assert (pruned is None) == (rpruned is None)
    if rpruned is not None:
        assert torch.equal(pruned, rpruned) and int(pruned.sum()) > 0
        torch.testing.assert_close(limit, rlimit, rtol=1e-6, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['tiny', 'optics', 'optics-no-prune',
                                  'optics-weights'])
def test_step_prologue_kernel_matches_plain(cuda, case):
    """k2_pre (step_kernel.before_query on the card: the uniform blocks
    and one launch) against photon.step_prologue on the same lanes and
    generator: the NaN guard's flags, the active and pruned lanes and the
    pruning limit; no pruning under weights or prune=False."""
    from chroma_tpu_torch.ops import photon, step_kernel
    from chroma_tpu_torch.ops.sample import DrawPool, make_generator
    ga = _tiny_on(cuda) if case == 'tiny' else \
        build_geometry_arrays(_optics_box()).to(cuda)
    state = _prologue_state(ga, cuda)
    opts = {'optics-no-prune': dict(prune=False),
            'optics-weights': dict(use_weights=True)}.get(case, {})

    def pool():
        return DrawPool(len(state), cuda,
                        generator=make_generator(cuda, 16))
    before = step_kernel.pre_launches
    got = step_kernel.before_query(state, ga, pool(), **opts)
    assert step_kernel.pre_launches == before + 1
    ref = photon.step_prologue(state, ga, pool(), **opts)
    torch.cuda.synchronize()
    _assert_prologue_equal(got, ref)
    assert (got[3] is None) == bool(opts)
    nan_abort = (got[0].flags & photon.i32(event.NAN_ABORT)) != 0
    assert int(nan_abort.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize('block', [32, 64, 128, 256])
@pytest.mark.parametrize('n', [1 << 15, 30001])
def test_step_kernel_blocks_match_plain(cuda, block, n):
    """k2_post at each block size, at a width that is a multiple of every
    block and at an odd one, against its plain twin and bit for bit
    against the first design (one thread a lane) on the all-models box
    (every surface model, Fresnel alone, reemission and a wire plane)."""
    from chroma_tpu_torch.ops import step_kernel
    ga = build_geometry_arrays(_optics_box()).to(cuda)
    state = _device_bomb(n, 17, cuda)
    ph, active, blocks, pruned, query, wires = _step_inputs(ga, state,
                                                            (18,))
    args = (ph, ga, blocks, active, pruned, query, wires)
    before = step_kernel.launches, step_kernel.thread_launches
    got = step_kernel.launch(*args, block=block)
    first = step_kernel.launch(*args, design='thread')
    assert (step_kernel.launches, step_kernel.thread_launches) == (
        before[0] + 1, before[1] + 1)
    ref = step_kernel.after_query_plain(*args)
    torch.cuda.synchronize()
    for name in FUSED_FIELDS:
        assert torch.equal(getattr(got, name), getattr(first, name)), name
    _lanes_agree(got, ref)


def _tie_box():
    """Three wire planes where two coincide (same origin and wires: every
    hit on the first ties with the second) and a third turned 60 degrees,
    1 mm above them: the ties between planes."""
    from chroma_tpu_torch.geometry import WirePlane
    absorber = Surface('absorber')
    absorber.set('absorb', 1.0)
    geo = Geometry(vacuum)
    geo.add_solid(Solid(box(2000.0, 2000.0, 2000.0), water, vacuum,
                        surface=absorber))
    for z, deg in ((0.0, 0.0), (0.0, 0.0), (1.0, 60.0)):
        a = np.radians(deg)
        geo.add_wireplane(WirePlane(
            origin=(0.0, 0.0, z), u=(np.cos(a), np.sin(a), 0.0),
            v=(-np.sin(a), np.cos(a), 0.0), pitch=3.0, radius=0.15,
            umin=-500, umax=500, vmin=-500, vmax=500, surface=absorber,
            material_inner=glass, material_outer=water))
    geo.flatten()
    return geo


def tie_rays(n, seed):
    """Rays at the planes of _tie_box: a third aimed exactly at a wire's
    axis (x along the wire, y = 3 k, z = 0) from below, a third starting on
    a wire's axis (inside it), the rest from random points below, some
    grazing; (pos, dir, active) as float32 numpy arrays and a bool mask."""
    rs = np.random.RandomState(seed)
    k = rs.randint(-100, 100, n).astype(np.float64)
    target = np.column_stack([rs.uniform(-400, 400, n), 3.0 * k,
                              np.zeros(n)])
    pos = np.column_stack([rs.uniform(-400, 400, (n, 2)),
                           rs.uniform(-60, -1, n)])
    third = n // 3
    pos[third:2 * third] = target[third:2 * third]
    d = target - pos
    d[third:2 * third] = rs.randn(third, 3)
    d[2 * third:] = rs.randn(n - 2 * third, 3)
    d[2 * third::7, 2] = 1e-12                   # grazing
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (pos.astype(np.float32), d.astype(np.float32),
            rs.uniform(size=n) > 0.05)


@pytest.mark.cuda
def test_wire_kernel_ties_match_plain(cuda):
    """K3 (the warp's walk) against walk_plain and the first design on
    rays that force ties: hits on two coinciding planes (the first plane
    keeps them), rays through a wire's axis and rays starting inside a
    wire: planes, distances and coordinates equal bit for bit."""
    from chroma_tpu_torch.ops import wire_kernel, wireplane
    ga = build_geometry_arrays(_tie_box()).to(cuda)
    pos, d, active = (torch.from_numpy(x).to(cuda)
                      for x in tie_rays(30001, 19))
    got = wire_kernel.walk(pos, d, ga, active)
    first = wire_kernel.launch(pos, d, wire_kernel.planes(ga), active,
                               design='thread')
    ref = wireplane.walk_plain(pos, d, ga, active)
    torch.cuda.synchronize()
    for a, b, c in zip(got, first, ref):
        assert torch.equal(a, b) and torch.equal(a, c)
    planes = ref[1].cpu().numpy()
    assert (planes == 0).sum() > 1000 and (planes == 2).sum() > 100
    assert (planes == 1).sum() == 0     # the coinciding plane never wins


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_masks(cuda):
    """The wrappers take bool (or u8) masks as they are and raise on
    another dtype, shape or a non-contiguous mask."""
    from chroma_tpu_torch.ops import wire_kernel
    ga = build_geometry_arrays(_tie_box()).to(cuda)
    pos, d, active = (torch.from_numpy(x).to(cuda)
                      for x in tie_rays(256, 20))
    table = wire_kernel.planes(ga)
    for bad in (active.float(), active[:128],
                torch.stack([active, active], 1)[:, 0]):
        with pytest.raises(ValueError):
            wire_kernel.launch(pos, d, table, bad)
    got = wire_kernel.launch(pos, d, table, active.to(torch.uint8))
    assert torch.equal(got[1], wire_kernel.launch(pos, d, table, active)[1])


@pytest.fixture(scope='module')
def daq_geos():
    return daq_geometries()


@pytest.mark.cuda
@pytest.mark.parametrize('name', list(DAQ_CASES))
def test_daq_kernel_matches_plain(cuda, daq_geos, prof_counters, name):
    """K4 (run_daq on the card, one launch) against its plain twin
    readout_plain on the same injected draws: earliest times, charges and
    histories bit for bit; some channels hit, some times negative."""
    from chroma_tpu_torch.ops import daq, daq_kernel
    photons, ga, kw = daq_case(daq_geos, name, cuda)
    before = daq_kernel.launches
    got = daq.run_daq(photons, ga, **kw)
    assert daq_kernel.launches == before + 1
    assert prof_counters['daq.kernel_calls'] == 1
    ndaq = kw['ndaq']
    draws = daq.daq_draws(len(photons), ndaq, cuda, uniforms=daq_uniforms)
    ref = daq.readout_plain(photons, ga, draws, ndaq,
                            kw.get('global_weight', 1.0),
                            kw.get('detection_state', event.SURFACE_DETECT))
    torch.cuda.synchronize()
    channel_arrays_equal(got, ref)
    assert got.earliest_time.shape == (ndaq * ga.detector.nchannels,)
    t = ref.earliest_time
    assert bool((t < 0).any()) and bool(((t > 0) & (t < daq.HIT_TIME_CUT))
                                        .any())
    assert bool((t == daq.MAX_TIME).any()) == (name == 'few-photons')


@pytest.mark.cuda
@pytest.mark.parametrize('ndaq', [1, 50])
def test_daq_kernel_generator_path(cuda, daq_geos, ndaq):
    """run_daq with a generator on the card against the twin fed one
    torch.rand a block and site from an identically seeded generator (the
    old per-block draw stream), four readouts of one shape, one starting
    from a generator already drawn from. Each equal bit for bit, and each
    caller's generator left where the per-block draws leave the
    reference's."""
    from chroma_tpu_torch.ops import daq
    ga = daq_geos['inst'].to(cuda)
    photons = daq_photons(daq_geos['ntri'], 10000, 5, cuda)
    rows = min(ndaq, daq.DAQ_BLOCK)
    gen, ref_gen = (torch.Generator(device=cuda) for _ in range(2))
    for k in range(4):
        for g in (gen, ref_gen):
            g.manual_seed(2 ** 40 + 7 * k)
            if k == 2:
                torch.rand(1000, generator=g, device=cuda)
        got = daq.run_daq(photons, ga, gen, ndaq=ndaq)
        draws = torch.stack([
            torch.stack([torch.rand((rows, len(photons)), generator=ref_gen,
                                    device=cuda) for _ in range(3)])
            for _ in range(-(-ndaq // daq.DAQ_BLOCK))])
        ref = daq.readout_plain(photons, ga, draws, ndaq)
        torch.cuda.synchronize()
        channel_arrays_equal(got, ref)
        assert gen.get_offset() == ref_gen.get_offset()
        assert torch.equal(torch.rand(64, generator=gen, device=cuda),
                           torch.rand(64, generator=ref_gen, device=cuda))


@pytest.mark.cuda
def test_pinned_readback_matches_pageable_and_reuses_its_block(
        cuda, prof_counters, monkeypatch):
    """A 2^20-lane bomb on demo.tiny() propagated on the card and read
    back with a device channel: every field as the pageable route (.cpu()
    a field) gives it, bit for bit, in 64 B a lane. Event B's readback
    while A's arrays are held grows the pinned pool by one block and
    leaves A's arrays as they were; once A's are dropped, C's readback
    takes A's block and grows nothing."""
    from chroma_tpu_torch.ops import propagate as P
    from test_torch_readback import assert_bit_equal, pageable
    monkeypatch.setenv('CHROMA_FUSED_SCHEDULE', '1:2,2:2')
    n = 1 << 20
    res = P.propagate(_device_bomb(n, 11, cuda), _tiny_on(cuda), (4, 2),
                      max_steps=100)
    ch = torch.where(res.last_hit_triangle >= 0,
                     res.last_hit_triangle % 37, -1).to(torch.int32)
    ev_b = res.map(lambda a: a.flip(0))

    def want(state, channel):
        return pageable(state, np.maximum(channel.cpu().numpy(), 0)
                        .astype(np.uint32))
    want_a, want_b = want(res, ch), want(ev_b, ch.flip(0))
    assert (ch < 0).any() and (ch > 0).any()

    def readback(state, channel):
        grown = prof_counters['readback.new_blocks']
        host = P.photon_state_to_host(state, channel=channel)
        return host, prof_counters['readback.new_blocks'] - grown
    got_a, _ = readback(res, ch)
    assert_bit_equal(got_a, want_a)
    assert prof_counters['readback.bytes'] == 64 * n
    got_b, grown = readback(ev_b, ch.flip(0))
    assert grown == 1
    assert_bit_equal(got_a, want_a)
    assert_bit_equal(got_b, want_b)
    del got_a
    torch.cuda.synchronize()    # the freed block's stream events complete
    got_c, grown = readback(res, ch)
    assert grown == 0
    assert_bit_equal(got_c, want_a)
    assert_bit_equal(got_b, want_b)
    assert prof_counters['readback.calls'] == 3
