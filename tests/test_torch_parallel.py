"""The port's photon sharding (chroma_tpu_torch.parallel) against the JAX
package's (chroma_tpu.parallel), on the CPU: the cases of
tests/test_parallel.py, with the port's ranks as processes of a gloo
group started by parallel.run_ranks (2 ranks, 4 for one case) and the JAX
package's shards as virtual CPU devices.

- The channel reduction equals JAX's reduce_channel_arrays under
  shard_map, and numpy's min / sum / OR, bit for bit, on integer-valued
  readouts; pad_to_mesh equals JAX's on every field.
- The sharded DAQ on JAX-propagated photons, fed JAX's per-shard uniforms
  (fold_in(daq_key, s)), equals JAX's sharded DAQ program: earliest times
  and histories bit for bit, charge at the detector's charge unit.
- Sharded propagation terminates every photon with a detected fraction of
  0.4-0.6 (the photocathode detects half), repeats bit for bit, agrees
  with compact=False to 0.06, and its gathered state equals, bit for bit,
  each rank's slice propagated alone in this process with the rank's seed.
- Simulation(mesh=...) at n = 3001, which does not divide the mesh,
  agrees with the port's single-device Simulation and with JAX's sharded
  one to 0.06 in the detected fraction, with the one channel hit on every
  rank; Simulation(n_devices=2) on 4 ranks runs on the first two and
  raises on the others.
- No process group, an indivisible batch, more devices than ranks, and a
  rank that fails or hangs, each raise.

The JAX inputs are made in this process and passed to the ranks as numpy
arrays: jax is imported only inside test bodies, because every spawned
rank imports this module. Each rank uses one torch thread."""
import numpy as np
import pytest
import torch

from chroma_tpu_torch import event
from chroma_tpu_torch.detector import Detector
from chroma_tpu_torch.geometry import Material, Solid, Surface, vacuum
from chroma_tpu_torch.make import box
from chroma_tpu_torch.ops import daq as tdaq
from chroma_tpu_torch.ops.propagate import (photon_state_from_host,
                                            propagate)
from chroma_tpu_torch.ops.types import build_geometry_arrays
from chroma_tpu_torch.parallel import (PhotonMesh, pad_to_mesh, photon_mesh,
                                       propagate_sharded, run_ranks,
                                       shard_seed)
from chroma_tpu_torch.sample import uniform_sphere

TIMEOUT = 300.0     # seconds for each group of ranks, start to end
N_BOMB = 1024
MAX_STEPS = 50
N_SIM = 3001        # not a multiple of the mesh: pad_to_mesh
SEED = 7


def box_detector(pmts=1):
    """The detectors of tests/test_parallel.py from the port's modules:
    one 1 m water box with a photocathode detecting half the photons, or
    four 30 cm boxes 80 cm from the centre detecting 60%."""
    water = Material('water')
    water.set('refractive_index', 1.33)
    water.set('absorption_length', 1e5)
    water.set('scattering_length', 1e5)
    pc = Surface('pc')
    pc.set('detect', 0.5 if pmts == 1 else 0.6)
    pc.set('absorb', 0.5 if pmts == 1 else 0.4)
    det = Detector(vacuum)
    if pmts == 1:
        det.add_pmt(Solid(box(1000.0, 1000, 1000), water, vacuum,
                          surface=pc))
    else:
        pmt = Solid(box(300.0, 300.0, 300.0), water, vacuum, surface=pc)
        for disp in ([800.0, 0, 0], [-800.0, 0, 0], [0, 800.0, 0],
                     [0, -800.0, 0]):
            det.add_pmt(pmt, displacement=np.asarray(disp, np.float64))
    det.set_time_dist_gaussian(1.2, -6.0, 6.0)
    det.set_charge_dist_gaussian(1.0, 0.1, 0.5, 1.5)
    return det


def bomb(n, seed, photons=event.Photons):
    """n isotropic 400 nm photons at the origin, as host Photons (the
    port's, or the `photons` class given)."""
    np.random.seed(seed)
    d = uniform_sphere(n)
    pol = np.cross(d, uniform_sphere(n))
    pol /= np.linalg.norm(pol, axis=1, keepdims=True)
    return photons(pos=np.zeros((n, 3)), dir=d, pol=pol,
                   wavelengths=np.full(n, 400.0), t=np.zeros(n))


def _arrays(state):
    return {k: v.numpy().copy() for k, v in vars(state).items()}


def _channels(arrays):
    return (arrays.earliest_time.numpy(), arrays.charge.numpy(),
            arrays.histories.numpy().view(np.uint32))


def _reduce(readouts, mesh):
    "This rank's row of each (k, C) readout, reduced over the mesh."
    from chroma_tpu_torch.parallel import reduce_channel_arrays
    t, q, h = (torch.from_numpy(np.ascontiguousarray(a[mesh.rank]))
               for a in (readouts[0], readouts[1],
                         readouts[2].view(np.int32)))
    return _channels(reduce_channel_arrays(tdaq.ChannelArrays(
        earliest_time=t, charge=q, histories=h), mesh))


def two_rank_cases(inputs):
    """Every 2-rank case, run in each rank: returns a dict of numpy
    results."""
    from chroma_tpu_torch.parallel import (photon_channels_sharded,
                                           propagate_and_daq_sharded)
    from chroma_tpu_torch.sim import Simulation
    torch.set_num_threads(1)
    mesh = photon_mesh(device='cpu')
    out = {'reduce': _reduce(inputs['reduce'], mesh)}

    # the DAQ on JAX-propagated photons with JAX's uniforms of this shard
    ga4 = build_geometry_arrays(box_detector(4))
    ph = photon_state_from_host(event.Photons(**inputs['daq_photons']),
                                'cpu')
    u = inputs['daq_uniforms'][mesh.rank]
    same, channels = propagate_and_daq_sharded(
        ph, ga4, SEED, max_steps=0, mesh=mesh,
        uniforms=lambda block, site, shape: u[site])
    out['daq'] = _channels(channels)
    out['photon_channels'] = photon_channels_sharded(ph, ga4, mesh).numpy()
    out['daq_photons_kept'] = all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        for a, b in zip(vars(same).values(), vars(ph).values()))

    ga = build_geometry_arrays(box_detector())
    photons = photon_state_from_host(bomb(N_BOMB, 1), 'cpu')
    runs = [propagate_sharded(photons, ga, SEED, max_steps=MAX_STEPS,
                              mesh=mesh) for _ in range(2)]
    out['runs'] = [_arrays(r) for r in runs]
    out['no_compact'] = propagate_sharded(
        photons, ga, SEED, max_steps=MAX_STEPS, mesh=mesh,
        compact=False).flags.numpy()

    sim = Simulation(box_detector(), seed=17, mesh=mesh)
    ev = next(sim.simulate(bomb(N_SIM, 3), run_daq=True))
    out['sim'] = (len(ev.flat_hits), ev.channels.t, ev.channels.hit,
                  sim.device.type)
    try:
        photon_mesh(3, device='cpu')
    except ValueError:
        out['too_many_devices'] = True
    return out


def four_rank_cases(inputs):
    "The 4-rank reduction and Simulation(n_devices=2), run in each rank."
    from chroma_tpu_torch.sim import Simulation
    torch.set_num_threads(1)
    out = {'reduce': _reduce(inputs['reduce'], photon_mesh(device='cpu'))}
    try:
        sim = Simulation(box_detector(), seed=17, n_devices=2, device='cpu')
    except ValueError as exc:
        out['sim'] = str(exc)
    else:
        ev = next(sim.simulate(bomb(N_SIM, 3), run_daq=True))
        out['sim'] = (sim.mesh.size, sim.mesh.rank, len(ev.flat_hits),
                      ev.channels.t)
    return out


def failing_rank():
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise ZeroDivisionError('rank 1 fails')
    dist.barrier()


def hanging_rank():
    import time
    time.sleep(3600)


# --- the JAX side, in this process --------------------------------------

def jax_box_arrays(pmts=1):
    "The same detector built by the JAX package, with its GeometryArrays."
    from chroma_tpu.detector import Detector as JDetector
    from chroma_tpu.geometry import Material as JMaterial, Solid as JSolid
    from chroma_tpu.geometry import Surface as JSurface, vacuum as jvacuum
    from chroma_tpu.loader import create_geometry_from_obj
    from chroma_tpu.make import box as jbox
    from chroma_tpu.ops.types import build_geometry_arrays as jbuild
    water = JMaterial('water')
    water.set('refractive_index', 1.33)
    water.set('absorption_length', 1e5)
    water.set('scattering_length', 1e5)
    pc = JSurface('pc')
    pc.set('detect', 0.5 if pmts == 1 else 0.6)
    pc.set('absorb', 0.5 if pmts == 1 else 0.4)
    det = JDetector(jvacuum)
    if pmts == 1:
        det.add_pmt(JSolid(jbox(1000.0, 1000, 1000), water, jvacuum,
                           surface=pc))
    else:
        pmt = JSolid(jbox(300.0, 300.0, 300.0), water, jvacuum, surface=pc)
        for disp in ([800.0, 0, 0], [-800.0, 0, 0], [0, 800.0, 0],
                     [0, -800.0, 0]):
            det.add_pmt(pmt, displacement=np.asarray(disp, np.float64))
    det.set_time_dist_gaussian(1.2, -6.0, 6.0)
    det.set_charge_dist_gaussian(1.0, 0.1, 0.5, 1.5)
    return det, jbuild(create_geometry_from_obj(det, update_bvh_cache=False))


def readouts(k):
    "Integer-valued (k, 37) readouts: any order of sums is exact."
    rs = np.random.RandomState(4)
    return (rs.randint(1, 1 << 20, (k, 37)).astype(np.float32),
            rs.randint(0, 1 << 10, (k, 37)).astype(np.float32),
            rs.randint(0, 1 << 31, (k, 37)).astype(np.uint32)
            | np.uint32(1 << 31) * rs.randint(0, 2, (k, 37)).astype(
                np.uint32))


def jax_reduce(times, charges, hists):
    "JAX's reduce_channel_arrays under shard_map on k virtual devices."
    from functools import partial
    import jax
    from jax.sharding import PartitionSpec as P
    from chroma_tpu.ops import daq as jdaq
    from chroma_tpu.parallel.sharding import AXIS, reduce_channel_arrays
    from chroma_tpu.parallel import photon_mesh as jmesh

    @jax.jit
    @partial(jax.shard_map, mesh=jmesh(len(times)),
             in_specs=(P(AXIS), P(AXIS), P(AXIS)), out_specs=P())
    def reduce(t, q, h):
        out = reduce_channel_arrays(jdaq.ChannelArrays(
            earliest_time=t[0], charge=q[0], histories=h[0]))
        return out.earliest_time, out.charge, out.histories
    return [np.asarray(x) for x in reduce(times, charges, hists)]


def jax_daq(k):
    """1024 photons propagated by JAX in the 4-PMT box, JAX's sharded DAQ
    of them on k devices, and the uniforms each shard drew."""
    import jax
    from chroma_tpu.ops import daq as jdaq
    from chroma_tpu.ops import propagate as jprop
    from chroma_tpu.ops.sample import site_key
    from chroma_tpu.parallel import photon_mesh as jmesh
    from chroma_tpu.parallel import sharding
    _, ga = jax_box_arrays(4)
    n = N_BOMB
    photons = jprop.photon_state_from_host(bomb(n, 13))
    out, _, _ = jprop.run_steps(photons, ga, jax.random.key(21), 0,
                                MAX_STEPS, trav_stages=())
    daq_key = jax.random.key(33)
    sharded = sharding._daq_program(jmesh(k), 1)(out, ga, daq_key)
    per = n // k
    uniforms = [[np.asarray(jax.random.uniform(
        site_key(jax.random.fold_in(daq_key, s), site), (1, per)))
        for site in range(3)] for s in range(k)]
    host = jprop.photon_state_to_host(out)
    fields = {name: np.asarray(getattr(host, name)) for name in (
        'pos', 'dir', 'pol', 'wavelengths', 't', 'last_hit_triangles',
        'flags', 'weights', 'evidx')}
    want = [np.asarray(x) for x in (sharded.earliest_time, sharded.charge,
                                    sharded.histories)]
    want.append(np.asarray(jdaq.photon_channels_device(out, ga)))
    return fields, uniforms, want, float(ga.detector.charge_unit)


def jax_sharded_fraction():
    "JAX's Simulation(mesh=photon_mesh(2)) on the N_SIM-photon bomb."
    from chroma_tpu.event import Photons
    from chroma_tpu.parallel import photon_mesh as jmesh
    from chroma_tpu.sim import Simulation as JaxSimulation
    det, _ = jax_box_arrays()
    ev = next(JaxSimulation(det, seed=17, mesh=jmesh(2)).simulate(
        bomb(N_SIM, 3, Photons), run_daq=True))
    return len(ev.flat_hits) / N_SIM, int(ev.channels.hit.sum())


@pytest.fixture(scope='module')
def two():
    "(inputs, every rank's results, JAX's DAQ) of the 2-rank cases."
    fields, uniforms, want, unit = jax_daq(2)
    inputs = {'reduce': readouts(2), 'daq_photons': fields,
              'daq_uniforms': uniforms}
    results = run_ranks(two_rank_cases, 2, args=(inputs,), backend='gloo',
                        timeout=TIMEOUT)
    return inputs, results, (want, unit)


@pytest.fixture(scope='module')
def four():
    inputs = {'reduce': readouts(4)}
    return inputs, run_ranks(four_rank_cases, 4, args=(inputs,),
                             backend='gloo', timeout=TIMEOUT)


def _flags(a):
    return a['flags'].view(np.uint32)


# --- the cases -----------------------------------------------------------

@pytest.mark.parametrize('k', [2, 4])
def test_channel_reduction_bitwise(k, two, four):
    """Every rank's reduced readout equals JAX's psum/pmin reduction and
    numpy's min / sum / OR, bit for bit (bit 31 of the histories
    included)."""
    inputs, results = (two[0], two[1]) if k == 2 else four
    times, charges, hists = inputs['reduce']
    want = jax_reduce(times, charges, hists)
    np.testing.assert_array_equal(want[0], times.min(axis=0))
    np.testing.assert_array_equal(want[1], charges.sum(axis=0))
    np.testing.assert_array_equal(want[2],
                                  np.bitwise_or.reduce(hists, axis=0))
    assert (want[2] >> 31).any()
    for res in results:
        for got, ref in zip(res['reduce'], want):
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('n,k', [(3001, 2), (1000, 8), (1024, 4)])
def test_pad_to_mesh_matches_jax(n, k):
    from chroma_tpu.ops import propagate as jprop
    from chroma_tpu.parallel import pad_to_mesh as jpad, photon_mesh as jmesh
    photons = bomb(n, 5)
    photons.flags[::3] = event.SURFACE_DETECT
    photons.last_hit_triangles[::5] = 7
    want, wn = jpad(jprop.photon_state_from_host(photons), jmesh(k))
    got, gn = pad_to_mesh(photon_state_from_host(photons, 'cpu'), k)
    assert gn == wn == n and len(got) == len(want) == -(-n // k) * k
    for name, field in vars(got).items():
        ref = np.asarray(getattr(want, name))
        ref = ref.view(np.int32) if ref.dtype == np.uint32 else ref
        assert field.numpy().tobytes() == ref.tobytes(), name


def test_sharded_daq_matches_jax(two):
    """The reduced readout on both ranks equals JAX's sharded DAQ of the
    same photons with the same per-shard draws; max_steps=0 leaves the
    photons as they were; photon_channels_sharded gathers every photon's
    channel as JAX computes it."""
    _, results, (want, unit) = two
    t_w, q_w, h_w, channels = want
    assert (channels >= 0).sum() > 10
    assert (t_w < tdaq.HIT_TIME_CUT).sum() >= 2, 'expect several channels'
    for res in results:
        t, q, h = res['daq']
        np.testing.assert_array_equal(t, t_w)
        np.testing.assert_array_equal(h, h_w)
        np.testing.assert_array_equal(np.round(q / unit),
                                      np.round(q_w / unit))
        assert res['daq_photons_kept']
        np.testing.assert_array_equal(res['photon_channels'], channels)


def test_propagate_sharded_terminates(two):
    _, results, _ = two
    flags = _flags(results[0]['runs'][0])
    assert len(flags) == N_BOMB
    assert ((flags & np.uint32(event.TERMINAL_FLAGS)) != 0).all()
    frac = ((flags & np.uint32(event.SURFACE_DETECT)) != 0).mean()
    assert 0.4 < frac < 0.6


def test_sharded_repeats_and_compaction(two):
    """Two calls with one seed are equal bit for bit, on both ranks, and
    compact=False agrees in the detected fraction."""
    _, results, _ = two
    first = results[0]['runs'][0]
    for res in results:
        for run in res['runs']:
            for name, field in run.items():
                assert field.tobytes() == first[name].tobytes(), name
    detected = [((f.view(np.uint32) & np.uint32(event.SURFACE_DETECT))
                 != 0).mean()
                for f in (first['flags'], results[0]['no_compact'])]
    assert abs(detected[0] - detected[1]) < 0.06


def test_gathered_state_equals_slices(two):
    """The gathered state is each rank's slice propagated alone with the
    rank's seed, bit for bit, in input lane order."""
    _, results, _ = two
    got = results[0]['runs'][0]
    ga = build_geometry_arrays(box_detector())
    photons = photon_state_from_host(bomb(N_BOMB, 1), 'cpu')
    per = N_BOMB // 2
    for rank in range(2):
        mesh = PhotonMesh(group=None, size=2, rank=rank,
                          device=torch.device('cpu'))
        alone = propagate(photons.map(lambda a: a[rank * per:
                                                  (rank + 1) * per]),
                          ga, shard_seed(SEED, mesh), max_steps=MAX_STEPS)
        for name, field in _arrays(alone).items():
            assert field.tobytes() == \
                got[name][rank * per:(rank + 1) * per].tobytes(), name
    # the two ranks drew different streams
    a, b = _flags(got)[:per], _flags(got)[per:]
    assert not np.array_equal(a, b)


def test_sharded_simulation_matches(two):
    """Simulation(mesh=...) on 3001 photons: every rank yields the same
    event, and its detected fraction agrees with the port's single-device
    Simulation and with JAX's sharded one."""
    from chroma_tpu_torch.sim import Simulation
    _, results, _ = two
    nhit, t, hit, dev = results[0]['sim']
    assert dev == 'cpu'
    for res in results[1:]:
        assert res['sim'][0] == nhit
        np.testing.assert_array_equal(res['sim'][1], t)
    assert hit.sum() == 1
    frac = nhit / N_SIM
    single = next(Simulation(box_detector(), seed=17, device='cpu')
                  .simulate(bomb(N_SIM, 3), run_daq=True))
    jfrac, jhit = jax_sharded_fraction()
    assert jhit == 1 and single.channels.hit.sum() == 1
    assert 0.4 < frac < 0.6
    assert abs(frac - len(single.flat_hits) / N_SIM) < 0.06
    assert abs(frac - jfrac) < 0.06


def test_n_devices_makes_a_subgroup(four):
    """Simulation(n_devices=2) on 4 ranks: ranks 0 and 1 form the mesh and
    yield the same event; ranks 2 and 3 raise."""
    _, results = four
    (s0, r0, n0, t0), (s1, r1, n1, t1) = results[0]['sim'], results[1]['sim']
    assert (s0, r0, s1, r1) == (2, 0, 2, 1) and n0 == n1
    np.testing.assert_array_equal(t0, t1)
    assert 0.4 < n0 / N_SIM < 0.6
    for res in results[2:]:
        assert 'outside the first 2 ranks' in res['sim']


def test_missing_group_or_bad_length_raises(two):
    from chroma_tpu_torch.sim import Simulation
    with pytest.raises(RuntimeError, match='process group'):
        photon_mesh()
    with pytest.raises(RuntimeError, match='process group'):
        Simulation(box_detector(), n_devices=2, device='cpu')
    mesh = PhotonMesh(group=None, size=2, rank=0, device=torch.device('cpu'))
    ga = build_geometry_arrays(box_detector())
    with pytest.raises(ValueError, match='does not divide'):
        propagate_sharded(photon_state_from_host(bomb(1001, 1), 'cpu'), ga,
                          SEED, mesh=mesh)
    assert all(res.get('too_many_devices') for res in two[1])


@pytest.mark.parametrize('fn,error,timeout', [
    (failing_rank, 'ZeroDivisionError', TIMEOUT),
    (hanging_rank, 'did not finish', 10.0)])
def test_run_ranks_raises_for_a_failing_or_hanging_rank(fn, error, timeout):
    with pytest.raises((RuntimeError, TimeoutError), match=error):
        run_ranks(fn, 2, backend='gloo', timeout=timeout)
