"""The port's fused bomb (chroma_tpu_torch.ops.propagate's default route)
against the JAX package's.

Held exactly, where the arithmetic is deterministic: the schedule helpers
and the tuner (with the JAX package's cost constants), the perf cache's
fingerprints, and the route without compaction (CHROMA_FUSED_SCHEDULE=
none equals run_steps bit for bit). Held in distribution, because the two
packages draw from different generators: the lanes that overflow a
stage's slice (the port runs them on at a wider width, JAX mops them up) and
Simulation's detected fraction, within 5 sigma of the binomial spread of
the difference of two independent runs. Also: the probe-then-tune cycle,
and the port's perf cache never reading an entry the JAX package wrote.
Each side builds its geometry and photons from its own package."""
import os

import numpy as np
import pytest
import torch

from chroma_tpu import perfcache as jperf
from chroma_tpu.ops import propagate as jprop
from chroma_tpu.ops import types as jtypes
from chroma_tpu_torch import perfcache as tperf
from chroma_tpu_torch.ops import propagate as tprop
from chroma_tpu_torch.ops import types as ttypes
from chroma_tpu_torch.profiler import profiler

from test_torch_host import (J, T, fresh_perf_cache,  # noqa: F401
                             same_native_kit)

torch.set_num_threads(2)

# the JAX tuner's cost constants, which the port's tuner takes as arguments
JAX_COSTS = dict(floor_lanes=jprop.SCHED_FLOOR_LANES,
                 boundary_frac=jprop.SCHED_BOUNDARY_FRAC,
                 boundary_lanes=jprop.SCHED_BOUNDARY_LANES)

SPECS = {'probe': ','.join('%d:%d' % e for e in jprop.PROBE_SCHEDULE),
         'eighth': '1:8,8:2', 'none': 'none',
         'absolute': '3:65536,10:8192,20:2048', 'mixed': '1:2,2:4096,4:2'}


def _five_sigma(a, b, n_a, n_b):
    "Two binomial counts of n_a and n_b trials agree within 5 sigma."
    p = (a + b) / float(n_a + n_b)
    sigma = np.sqrt(p * (1 - p) * (1.0 / n_a + 1.0 / n_b))
    assert abs(a / n_a - b / n_b) <= 5 * sigma + 1e-12, (a, n_a, b, n_b)


@pytest.fixture
def fresh_cache(tmp_path, monkeypatch):
    """Both perf caches on an empty CHROMA_CACHE_DIR, no session state."""
    monkeypatch.setenv('CHROMA_CACHE_DIR', str(tmp_path))
    for mod in (jperf, tperf):
        monkeypatch.setattr(mod, '_DISK', {})
    monkeypatch.setattr(tprop, '_SCHED_CACHE', {})
    monkeypatch.setattr(tprop, '_PROBE_COUNTS', {})
    return tmp_path


def _tiny(h):
    geo = h.demo.tiny()
    geo.flatten()
    return geo


@pytest.fixture(scope='module')
def tiny():
    """demo.tiny() built by each package: (JAX geometry, port geometry,
    JAX arrays, port arrays)."""
    geo_j, geo_t = _tiny(J), _tiny(T)
    return (geo_j, geo_t, jtypes.build_geometry_arrays(geo_j),
            ttypes.build_geometry_arrays(geo_t))


def _all_models(h):
    from test_torch_surfaces import all_models_detector
    return all_models_detector(h)


def _bomb(n, seed):
    np.random.seed(seed)
    return T.photon_bomb(n, 400.0, (0, 0, 0))


@pytest.mark.parametrize('spec', sorted(SPECS))
@pytest.mark.parametrize('n', [4096, 10 ** 4, 1 << 17, 1 << 20])
def test_schedule_helpers_match_jax(n, spec):
    parsed = tprop._parse_schedule(SPECS[spec])
    assert parsed == jprop._parse_schedule(SPECS[spec])
    trimmed = tprop._trim_schedule(parsed, n)
    assert trimmed == jprop._trim_schedule(parsed, n)
    for max_steps in (10, 100):
        assert tprop._boundary_steps(trimmed, max_steps) == \
            jprop._boundary_steps(trimmed, max_steps)
    width = n
    for ent in parsed:
        assert tprop._resolve_width(width, ent) == \
            jprop._resolve_width(width, ent)
        width = max(tprop._resolve_width(width, ent), 1)
    assert (tprop.SCHED_FLOOR, tprop.PROBE_SCHEDULE, tprop.MIN_BATCH) == \
        (jprop.SCHED_FLOOR, jprop.PROBE_SCHEDULE, jprop.MIN_BATCH)
    assert tprop._round_lanes(n + 1) == jprop._round_lanes(n + 1)


def _curve(kind, n, steps=31):
    "A probe's per-step alive counts of a survival curve of this kind."
    s = np.arange(1, steps + 1)
    if kind == 'fast':
        f = 0.55 ** s
    elif kind == 'gradual':
        f = 0.82 ** s
    elif kind == 'tail':            # a long-lived minority flattens out
        f = 0.9 * 0.6 ** s + 0.1 * 0.97 ** s
    else:                           # 'dies': everything dead by step 6
        f = np.where(s < 6, 0.5 ** s, 0.0)
    return [int(x) for x in np.floor(f * n)]


@pytest.mark.parametrize('kind', ['fast', 'gradual', 'tail', 'dies'])
@pytest.mark.parametrize('n', [4096, 10 ** 4, 1 << 17, 1 << 20])
def test_tuner_matches_jax(n, kind):
    """With the JAX package's cost constants the port's tuner returns the
    JAX tuner's schedule exactly, and the survival interpolation agrees."""
    counts = _curve(kind, n)
    bsteps = list(range(1, len(counts) + 1))
    for max_steps in (64, 100):
        want = jprop._tune_schedule(n, bsteps, counts, max_steps)
        got = tprop._tune_schedule(n, bsteps, counts, max_steps,
                                   **JAX_COSTS)
        assert got == want
    jf = jprop._survival_fn(n, bsteps, counts)
    tf = tprop._survival_fn(n, bsteps, counts)
    assert [tf(s) for s in range(0, 80, 3)] == \
        [jf(s) for s in range(0, 80, 3)]


@pytest.mark.parametrize('case', ['tiny', 'all_models'])
def test_fingerprints_match_jax(case, tiny, tmp_path):
    """The port registers the JAX package's content fingerprint for the
    same table: at build, on a device copy, through from_jax_arrays and
    after a geocache round trip."""
    from chroma_tpu_torch.io.geocache import (load_geometry_arrays,
                                              save_geometry_arrays)
    if case == 'tiny':
        ga_j, ga_t = tiny[2:]
    else:
        ga_j = jtypes.build_geometry_arrays(_all_models(J))
        ga_t = ttypes.build_geometry_arrays(_all_models(T))
    fp = jperf.key_of(ga_j.wide)
    assert jperf.persistent(fp)
    assert tperf.key_of(ga_t.wide) == fp
    assert tperf.key_of(ga_t) == jperf.key_of(ga_j) == fp + '-ga'
    assert tperf.key_of(ga_t.to('cpu')) == fp + '-ga'
    assert tperf.key_of(ttypes.from_jax_arrays(ga_j).wide) == fp
    path = str(tmp_path / 'geo')
    save_geometry_arrays(path, ga_t)
    assert tperf.key_of(load_geometry_arrays(path).wide) == fp
    assert tperf.fingerprint_rows(ga_t.wide.rows.numpy(), extra=(1, 'x')) \
        == jperf.fingerprint_rows(np.asarray(ga_j.wide.rows), extra=(1, 'x'))


def test_port_never_reads_jax_entries(fresh_cache, tiny):
    """Under one CHROMA_CACHE_DIR the JAX package's tuned schedule for a
    geometry is invisible to the port, whose entries live apart."""
    ga_t = tiny[3]
    fp = tperf.key_of(ga_t)
    assert fp == jperf.key_of(tiny[2])
    jperf.update(fp, {'sched:4096:100': [[1, 2048]]})
    jfile = fresh_cache / 'perf' / (fp + '.json')
    assert jfile.exists()
    assert tperf.load(fp) == {}
    assert tprop._sched_lookup(ga_t, 4096, 100) is None
    assert tprop.schedule_for(ga_t, 4096, 100) == \
        tprop._trim_schedule(tprop.PROBE_SCHEDULE, 4096)
    before = jfile.read_bytes()
    tperf.update(fp, {'sched:4096:100': [[2, 2048]]})
    assert (fresh_cache / tperf.PERF_DIR / (fp + '.json')).exists()
    assert jfile.read_bytes() == before
    jperf._DISK.clear()
    assert jperf.load(fp)['sched:4096:100'] == [[1, 2048]]


def test_unscheduled_route_equals_run_steps(monkeypatch, tiny):
    """CHROMA_FUSED_SCHEDULE=none: one stage to max_steps, the same result
    as run_steps, bit for bit, for the same seed."""
    monkeypatch.setenv('CHROMA_FUSED_SCHEDULE', 'none')
    ga = tiny[3]
    state = tprop.photon_state_from_host(_bomb(2048, 3), 'cpu')
    got = tprop.propagate(state, ga, seed=(7, 1), max_steps=25)
    want, _, _ = tprop.run_steps(state, ga, (7, 1), 0, 25)
    for name in ('pos', 'dir', 'pol', 'wavelength', 't', 'weight', 'flags',
                 'last_hit_triangle', 'evidx', 'cur_mat'):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _gray_box(h):
    """A 1 m water box in vacuum with gray walls (35% absorb, 65% diffuse
    reflection), built through the package's loader."""
    gray = h.Surface('gray')
    gray.set('absorb', 0.35)
    gray.set('reflect_diffuse', 0.65)
    geo = h.Geometry(h.vacuum)
    geo.add_solid(h.Solid(h.box(1000.0, 1000.0, 1000.0), h.optics.water,
                          h.vacuum, surface=gray))
    geo.flatten()
    loader = __import__(('chroma_tpu' if h is J else 'chroma_tpu_torch')
                        + '.loader', fromlist=['loader'])
    return loader.create_geometry_from_obj(geo, auto_build_bvh=False,
                                           update_bvh_cache=False)


def _gray_photons(n):
    "n photons at the box centre, isotropic (numpy seed 11), 450 nm."
    rng = np.random.default_rng(11)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pol = np.cross(d, [0.0, 0.0, 1.0])
    return d.astype(np.float32), pol.astype(np.float32)


def test_fused_bomb_suffix_mop(monkeypatch):
    """The port's counterpart of test_perf_tuning.test_fused_bomb_suffix_mop:
    schedule 1:8,8:2 compacts to 1/8 after one step while most photons are
    alive (at 16,384 lanes, so that the 1/8 slice is above SCHED_FLOOR;
    8:2 then trims away). The survivors overflow the slice: the port skips
    the boundary and runs them on at the full width, where JAX mops them
    up. Every lane comes back terminated and accounted for, and the flag
    counts agree with JAX's propagate under the same schedule within 5
    sigma."""
    from chroma_tpu_torch import event
    from chroma_tpu_torch.ops.photon import PhotonState
    import jax.numpy as jnp
    from chroma_tpu.ops.photon import PhotonState as JState
    from chroma_tpu.ops.sample import make_key

    monkeypatch.setenv('CHROMA_FUSED_SCHEDULE', '1:8,8:2')
    monkeypatch.setenv('CHROMA_TRAV_STAGE_PILOT', '0')
    monkeypatch.setattr(profiler, 'enabled', True)
    monkeypatch.setattr(profiler, 'counters', type(profiler.counters)(int))
    n = 16384
    d, pol = _gray_photons(n)
    ga_t = ttypes.build_geometry_arrays(_gray_box(T))
    ps = PhotonState(
        pos=torch.zeros((n, 3)), dir=torch.from_numpy(d),
        pol=torch.from_numpy(pol), wavelength=torch.full((n,), 450.0),
        t=torch.zeros(n), weight=torch.ones(n),
        flags=torch.zeros(n, dtype=torch.int32),
        last_hit_triangle=torch.full((n,), -1, dtype=torch.int32),
        evidx=torch.zeros(n, dtype=torch.int32),
        cur_mat=torch.full((n,), -1, dtype=torch.int32))
    assert tprop.schedule_for(ga_t, n, 64) == ((1, 8),)
    res = tprop.propagate(ps, ga_t, seed=5, max_steps=64)
    # survivors after step 1 overflowed the 2,048-lane slice
    assert profiler.counters['propagate.overflow_lanes'] > 0
    fl = res.flags.numpy().view(np.uint32)
    term = (event.SURFACE_DETECT | event.BULK_ABSORB
            | event.SURFACE_ABSORB | event.NO_HIT | event.NAN_ABORT)
    assert ((fl & event.NAN_ABORT) == 0).all()
    assert ((fl & term) != 0).all(), 'unterminated lanes after overflow'
    # no lane lost or doubled: lanes keep their input order and photons
    np.testing.assert_array_equal(res.wavelength.numpy(),
                                  ps.wavelength.numpy())
    assert np.isfinite(res.t.numpy()).all()
    absorbed = int(((fl & event.SURFACE_ABSORB) > 0).sum())
    assert absorbed > 0.5 * n

    ga_j = jtypes.build_geometry_arrays(_gray_box(J))
    jps = JState(
        pos=jnp.zeros((n, 3), jnp.float32), dir=jnp.asarray(d),
        pol=jnp.asarray(pol), wavelength=jnp.full(n, 450.0, jnp.float32),
        t=jnp.zeros(n, jnp.float32), weight=jnp.ones(n, jnp.float32),
        flags=jnp.zeros(n, jnp.uint32),
        last_hit_triangle=jnp.full(n, -1, jnp.int32),
        evidx=jnp.zeros(n, jnp.uint32), cur_mat=jnp.full(n, -1, jnp.int32))
    jfl = np.asarray(jprop.propagate(jps, ga_j, make_key(5),
                                     max_steps=64).flags)
    for bit in (event.SURFACE_ABSORB, event.REFLECT_DIFFUSE, event.NO_HIT):
        _five_sigma(int(((fl & bit) != 0).sum()),
                    int(((jfl & bit) != 0).sum()), n, n)


def test_probe_then_tuned(fresh_cache, monkeypatch, tiny):
    """The first bomb of a (geometry, batch, max_steps) runs the probe and
    records its curve step by step; the tuned schedule is
    _tune_schedule(curve). The second bomb runs propagate.fused with it,
    and a process that lost its session cache reads it from disk."""
    monkeypatch.delenv('CHROMA_FUSED_SCHEDULE', raising=False)
    monkeypatch.setattr(profiler, 'enabled', True)
    monkeypatch.setattr(profiler, 'regions', type(profiler.regions)(
        profiler.regions.default_factory))
    ga = tiny[3]
    n, max_steps = 8192, 100
    state = tprop.photon_state_from_host(_bomb(n, 4), 'cpu')
    pk = tprop.perf_key(ga)
    probe = tprop._trim_schedule(tprop.PROBE_SCHEDULE, n)
    assert probe and tprop.schedule_for(ga, n, max_steps) == probe

    tprop.propagate(state, ga, seed=1, max_steps=max_steps)
    assert 'propagate.probe[n=%d]' % n in profiler.regions
    curve = tprop._PROBE_COUNTS[(pk, n)]
    assert len(curve) == sum(steps for steps, _ in probe)
    assert curve[0] > 0 and (np.diff(curve) <= 0).all()
    tuned = tprop._tune_schedule(n, list(range(1, len(curve) + 1)), curve,
                                 max_steps)
    assert tprop.schedule_for(ga, n, max_steps) == tuned

    out = tprop.propagate(state, ga, seed=2, max_steps=max_steps)
    assert 'propagate.fused[n=%d]' % n in profiler.regions
    assert profiler.regions['propagate.probe[n=%d]' % n].calls == 1
    assert not out.alive.any()

    tprop._SCHED_CACHE.clear()
    tperf._DISK.clear()
    assert tprop._sched_lookup(ga, n, max_steps) == tuned
    assert tperf.load(pk)['counts:%d:%d' % (n, max_steps)] == \
        [int(c) for c in curve]


def test_tune_false_never_probes(fresh_cache, monkeypatch, tiny):
    """propagate(tune=False), as a sharded rank calls it: the fused route
    with schedule_for's schedule (the probe schedule before any probe),
    equal bit for bit to _fused_bomb by that schedule; nothing is tuned or
    written to the perf cache."""
    monkeypatch.delenv('CHROMA_FUSED_SCHEDULE', raising=False)
    monkeypatch.setattr(profiler, 'enabled', True)
    monkeypatch.setattr(profiler, 'regions', type(profiler.regions)(
        profiler.regions.default_factory))
    ga = tiny[3]
    n, max_steps = 8192, 100
    state = tprop.photon_state_from_host(_bomb(n, 5), 'cpu')
    sched = tprop.schedule_for(ga, n, max_steps)
    assert sched == tprop._trim_schedule(tprop.PROBE_SCHEDULE, n)
    got = tprop.propagate(state, ga, seed=4, max_steps=max_steps,
                          tune=False)
    want, _, _ = tprop._fused_bomb(state, ga, 4, sched, max_steps)
    for name in ('pos', 'dir', 'pol', 'wavelength', 't', 'weight', 'flags',
                 'last_hit_triangle', 'evidx', 'cur_mat'):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert [r for r in profiler.regions if '[' in r] == \
        ['propagate.fused[n=%d]' % n]
    assert not tprop._SCHED_CACHE and not tprop._PROBE_COUNTS
    assert not (fresh_cache / tperf.PERF_DIR).exists()


class _FakeGraph:
    "Stands in for graphs.StepGraph: records the widths it was made for."

    def __init__(self, geometry, photons, use_weights, scatter_first,
                 prune):
        self.width = len(photons)


def test_graph_cache_is_bounded(monkeypatch):
    """A geometry keeps its MAX_GRAPHS most recently used step graphs:
    a capture beyond them destroys the least recently used one (a lookup
    makes a graph the most recent), before the new capture starts."""
    import gc
    import weakref
    from chroma_tpu_torch.ops import graphs
    monkeypatch.setattr(graphs, 'StepGraph', _FakeGraph)
    monkeypatch.setattr(graphs, 'MAX_GRAPHS', 3)

    class Geometry:
        pass

    geo = Geometry()
    refs = {w: weakref.ref(graphs.capture(geo, [0] * w, False, 0, True))
            for w in (10, 20, 30)}
    assert graphs.lookup(geo, [0] * 10, False, 0, True).width == 10
    assert graphs.lookup(geo, [0] * 10, True, 0, True) is None
    graphs.capture(geo, [0] * 40, False, 0, True)
    gc.collect()
    assert refs[20]() is None              # the least recently used
    assert graphs.lookup(geo, [0] * 20, False, 0, True) is None
    assert [k[0] for k in graphs._graphs_of(geo)] == [30, 10, 40]
    graphs.capture(geo, [0] * 50, False, 0, True)
    gc.collect()
    assert refs[30]() is None and refs[10]() is not None
    assert len(graphs._graphs_of(geo)) == 3
    del geo
    gc.collect()
    graphs.capture(Geometry(), [0] * 60, False, 0, True)
    gc.collect()
    assert refs[10]() is None              # freed with its geometry


def test_simulation_fused_matches_chunked_and_jax(monkeypatch, fresh_cache,
                                                  tiny):
    """Simulation(demo.tiny()): the detected fraction of the fused route
    (the default), of the chunked route (CHROMA_FUSED=0) and of the JAX
    package's fused Simulation under the same schedule (one compaction to
    half the lanes) agree within 5 sigma."""
    from chroma_tpu.sim import Simulation as JaxSimulation
    import chroma_tpu_torch
    monkeypatch.setenv('CHROMA_FUSED_SCHEDULE', '1:2')
    monkeypatch.setenv('CHROMA_TRAV_STAGE_PILOT', '0')
    geo_j, geo_t, ga_j, ga_t = tiny
    n = 8192
    detected = {}
    for route in ('fused', 'chunked', 'jax'):
        monkeypatch.setenv('CHROMA_FUSED', '0' if route == 'chunked'
                           else '1')
        h = J if route == 'jax' else T
        np.random.seed(1)
        bomb = h.photon_bomb(n, 400.0, (0, 0, 0))
        if route == 'jax':
            sim = JaxSimulation(geo_j, seed=0, gpu_geometry=ga_j)
        else:
            sim = chroma_tpu_torch.Simulation(geo_t, seed=0, device='cpu',
                                              geometry_arrays=ga_t)
        ev = next(sim.simulate([bomb], run_daq=False, max_steps=100))
        detected[route] = len(ev.flat_hits)
    assert detected['fused'] > 0
    _five_sigma(detected['fused'], detected['chunked'], n, n)
    _five_sigma(detected['fused'], detected['jax'], n, n)


def test_cli_profile_fused_regions(tmp_path, fresh_cache, monkeypatch):
    """cli.profile on the default route reports the fused driver's
    regions, with JAX's names, and its step counters."""
    import io
    from contextlib import redirect_stdout
    from chroma_tpu_torch import cache as tcache
    from chroma_tpu_torch.cli import profile
    monkeypatch.setattr(tcache.Cache.__init__, '__defaults__',
                        (str(tmp_path / 'cache'),))
    monkeypatch.delenv('CHROMA_FUSED', raising=False)
    monkeypatch.delenv('CHROMA_FUSED_SCHEDULE', raising=False)
    monkeypatch.setattr(profiler, 'enabled', False)
    profiler.reset()
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            profile.main(['@chroma_tpu_torch.demo.tiny', '-p', '1000', '-n',
                          '2', '--device', 'cpu'])
    finally:
        profiler.reset()
    text = buf.getvalue()
    for needle in ('propagate.fused[n=1000]', 'propagate.steps',
                   'propagate.lane_steps', 'photons/s'):
        assert needle in text, needle
    assert 'propagate.chunk[' not in text
