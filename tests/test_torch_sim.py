"""The torch port's Simulation facade.

Against chroma_tpu.Simulation on demo.tiny() with the same 16,384 host
photons: the detected, bulk-absorbed and escaped (NO_HIT) counts must
agree within 4 sigma of the binomial spread of the difference of two
independent runs (the two use different random streams), and so must a
box with a thin-film complex surface. Also: batching routes results to
their events, a CUDA device without a card raises, photons_end.channel is
filled only when hits are wanted and a Detector passed without arrays gets
the classic BVH, both as in chroma_tpu.Simulation, and the whole package
imports and runs -- a reemitting medium and the likelihood included --
with jax, flax and the JAX package chroma_tpu blocked, as on a machine
that has none of them. Each side builds its geometry and photons from its
own package (test_torch_host.host)."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from chroma_tpu.ops.types import build_geometry_arrays
import chroma_tpu_torch

from test_torch_host import (J, T, _box_detector,  # noqa: F401
                             fresh_perf_cache, same_native_kit)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _counts(ev):
    event = J.event
    f = ev.photons_end.flags
    return {'detected': len(ev.flat_hits),
            'bulk_absorb': int(((f & event.BULK_ABSORB) != 0).sum()),
            'no_hit': int(((f & event.NO_HIT) != 0).sum())}


def _jax_and_port_events(build, n, monkeypatch):
    """One 400 nm bomb of n photons (numpy seed 1) through
    chroma_tpu.Simulation and the port's, each on the geometry build(h)
    and the bomb that its own package makes; returns both events."""
    from chroma_tpu.sim import Simulation as JaxSimulation
    # one fused stage: the JAX driver skips its probe bomb and schedule
    # tuning (compile time); the physics and the statistics are the same
    monkeypatch.setenv('CHROMA_FUSED_SCHEDULE', 'none')
    events = []
    for h in (J, T):
        geo = build(h)
        np.random.seed(1)
        bomb = h.photon_bomb(n, 400.0, (0, 0, 0))
        if h is J:
            sim = JaxSimulation(geo, seed=0,
                                gpu_geometry=build_geometry_arrays(geo))
        else:
            sim = chroma_tpu_torch.Simulation(geo, seed=0, device='cpu')
        events.append(next(sim.simulate([bomb], run_daq=True,
                                        max_steps=100,
                                        keep_photons_end=True)))
    return events


def _assert_counts_agree(jc, tc, n):
    "Within 4 sigma of the binomial spread of the difference."
    for name in jc:
        p = (jc[name] + tc[name]) / (2.0 * n)
        sigma = np.sqrt(2.0 * n * p * (1.0 - p))
        assert abs(jc[name] - tc[name]) <= 4.0 * sigma + 1e-9, (name, jc,
                                                                  tc)


def _tiny(h):
    geo = h.demo.tiny()
    geo.flatten()
    return geo


def test_matches_jax_simulation(monkeypatch):
    n = 16384
    jev, tev = _jax_and_port_events(_tiny, n, monkeypatch)
    assert type(tev).__module__ == 'chroma_tpu_torch.event'
    jc, tc = _counts(jev), _counts(tev)
    _assert_counts_agree(jc, tc, n)
    assert tc['detected'] > 0
    # every detected photon reads out on its channel
    assert tev.channels.hit.sum() == len(tev.hits)
    assert set(np.flatnonzero(tev.channels.hit)) == set(tev.hits)
    assert len(tev.photons_end) == n
    assert (tev.flat_hits.flags & T.event.SURFACE_DETECT).all()


def test_multi_event_batch_routing():
    sim = chroma_tpu_torch.Simulation(_box_detector(T), seed=31,
                                      device='cpu')
    np.random.seed(0)
    sizes = [100, 300, 200]
    events = [T.event.Event(id=i, photons_beg=T.photon_bomb(k, 400.0,
                                                            (0, 0, 0)))
              for i, k in enumerate(sizes)]
    out = list(sim.simulate(iter(events), keep_photons_end=True,
                            run_daq=True, photons_per_batch=10000))
    assert len(out) == 3
    for i, (ev, k) in enumerate(zip(out, sizes)):
        assert len(ev.photons_end) == k
        assert (ev.flat_hits.evidx == i).all()
        assert ev.channels.hit[0]
        assert 0.2 * k < ev.channels.q[0] < 0.8 * k
        assert len(ev.hits[0]) == len(ev.flat_hits)


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        chroma_tpu_torch.Simulation(_box_detector(T), device='cuda')


def test_unsupported_surface_model_raises(monkeypatch):
    """A surface model other than the default -- a thin absorbing film
    (the complex model) on a block inside the box detector -- simulates on
    the port with the JAX package's statistics."""
    def filmed(h):
        det = _box_detector(h)
        film = h.Surface('film', model=h.SURFACE_COMPLEX)
        film.set('detect', 0.3)
        film.set('eta', 2.7)
        film.set('k', 1.5)
        film.thickness = 25.0
        film.transmissive = 1
        glass = h.Material('glass')
        glass.set('refractive_index', 1.5)
        glass.set('absorption_length', 1e4)
        glass.set('scattering_length', 1e6)
        water = det.solids[0].material1[0]
        det.add_solid(h.Solid(h.box(300.0, 300, 300), glass, water,
                              surface=film), displacement=(0, 0, 250.0))
        det.flatten()
        return det
    n = 16384
    jev, tev = _jax_and_port_events(filmed, n, monkeypatch)

    def counts(ev):
        f = ev.photons_end.flags
        c = _counts(ev)
        for name in ('SURFACE_ABSORB', 'SURFACE_TRANSMIT', 'REFLECT_DIFFUSE',
                     'REFLECT_SPECULAR'):
            c[name] = int(((f & getattr(J.event, name)) != 0).sum())
        return c
    jc, tc = counts(jev), counts(tev)
    _assert_counts_agree(jc, tc, n)
    assert tc['SURFACE_TRANSMIT'] > 0 and tc['detected'] > 0


BLOCKED_RUN = textwrap.dedent('''
    import importlib, pkgutil, sys
    assert 'jax' not in sys.modules

    BLOCKED = ('jax', 'jaxlib', 'flax', 'chroma_tpu')

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split('.')[0] in BLOCKED:
                raise ImportError('blocked: ' + name)
            return None

    sys.meta_path.insert(0, Blocker())
    import numpy as np
    import chroma_tpu_torch
    for m in pkgutil.walk_packages(chroma_tpu_torch.__path__,
                                   'chroma_tpu_torch.'):
        importlib.import_module(m.name)
    from chroma_tpu_torch.detector import Detector
    from chroma_tpu_torch.generator import photon_bomb
    from chroma_tpu_torch.geometry import Material, Solid, Surface, vacuum
    from chroma_tpu_torch.make import box
    water = Material('w')
    for name, value in (('refractive_index', 1.33),
                        ('absorption_length', 1e5),
                        ('scattering_length', 1e5)):
        water.set(name, value)
    pc = Surface('pc')
    pc.set('detect', 0.5)
    pc.set('absorb', 0.5)
    det = Detector(vacuum)
    det.add_pmt(Solid(box(1000.0, 1000, 1000), water, vacuum, surface=pc))
    det.set_time_dist_gaussian(1.2, -6.0, 6.0)
    det.set_charge_dist_gaussian(1.0, 0.1, 0.5, 1.5)
    sim = chroma_tpu_torch.Simulation(det, seed=2, device='cpu')
    np.random.seed(2)
    ev = next(sim.simulate([photon_bomb(1024, 400.0, (0, 0, 0))],
                           run_daq=True, max_steps=100))
    assert 0 < len(ev.flat_hits) < 1024 and ev.channels.hit[0]

    # the port's own likelihood facade
    from chroma_tpu_torch import event, Likelihood
    events = (event.Event(photons_beg=photon_bomb(200, 400.0, (0, 0, 0)))
              for _ in range(100))
    lk = Likelihood(sim, ev, trange=(-0.5, 20.0))
    assert np.isfinite(lk.eval(events, nevals=3, nreps=1,
                               ndaq=4).nominal_value)
    lk.setup_kernel(events, nevals=3, nreps=1, ndaq=4, oversample_factor=1)
    assert np.isfinite(lk.eval_kernel(events, nevals=3, nreps=1, ndaq=4,
                                      navg=2).nominal_value)

    # a scintillating medium: bulk reemission
    from chroma_tpu_torch.geometry import Geometry, standard_wavelengths as wl
    scint = Material('scint')
    for name, value in (('refractive_index', 1.5),
                        ('absorption_length', 100.0),
                        ('scattering_length', 1e9)):
        scint.set(name, value)
    flat = np.column_stack([wl, np.ones_like(wl)]).astype(np.float32)
    scint.comp_reemission_prob = [flat]
    scint.comp_reemission_wvl_cdf = [np.column_stack(
        [wl, np.clip((wl - 420.0) / 20.0, 0, 1)]).astype(np.float32)]
    scint.comp_reemission_time_cdf = [
        np.array([[0.0, 0.0], [1000.0, 1.0]], np.float32)]
    scint.comp_absorption_length = [flat * np.float32([1.0, 100.0])]
    geo = Geometry(vacuum)
    geo.add_solid(Solid(box(5000, 5000, 5000), scint, vacuum))
    scint_sim = chroma_tpu_torch.Simulation(geo, seed=3, device='cpu')
    ev = next(scint_sim.simulate([photon_bomb(1024, 350.0, (0, 0, 0))],
                                 keep_photons_end=True, max_steps=2))
    assert ((ev.photons_end.flags & event.BULK_REEMIT) != 0).sum() > 900
    assert not any(m.split('.')[0] in BLOCKED for m in sys.modules)
    print('OK', len(ev.photons_end))
''')


def _four_pmt_detector(h):
    "The 4-channel box detector of tests/test_parallel.py, from h."
    water = h.Material('water')
    water.set('refractive_index', 1.33)
    water.set('absorption_length', 1e5)
    water.set('scattering_length', 1e5)
    pc = h.Surface('pc')
    pc.set('detect', 0.6)
    pc.set('absorb', 0.4)
    det = h.Detector(h.vacuum)
    pmt = h.Solid(h.box(300.0, 300.0, 300.0), water, h.vacuum, surface=pc)
    for disp in ([800.0, 0, 0], [-800.0, 0, 0], [0, 800.0, 0],
                 [0, -800.0, 0]):
        det.add_pmt(pmt, displacement=np.asarray(disp, np.float64))
    det.set_time_dist_gaussian(1.2, -6.0, 6.0)
    det.set_charge_dist_gaussian(1.0, 0.1, 0.5, 1.5)
    return det


@pytest.mark.parametrize('keep_hits', [False, True])
def test_photons_end_channel_only_with_hits(keep_hits, monkeypatch):
    """photons_end.channel is filled only when hits are wanted, as
    chroma_tpu/sim.py:237-244 fills it: zeros otherwise; with hits, each
    detected photon's channel, on the 4-channel box in both packages."""
    from chroma_tpu.sim import Simulation as JaxSimulation
    monkeypatch.setenv('CHROMA_FUSED_SCHEDULE', 'none')
    for h in (J, T):
        np.random.seed(1)
        bomb = h.photon_bomb(4096, 400.0, (0, 0, 0))
        sim = JaxSimulation(_four_pmt_detector(J), seed=0) if h is J \
            else chroma_tpu_torch.Simulation(_four_pmt_detector(T), seed=0,
                                             device='cpu')
        ev = next(sim.simulate([bomb], keep_photons_end=True,
                               keep_hits=keep_hits,
                               keep_flat_hits=keep_hits, max_steps=100))
        end = ev.photons_end
        assert end.channel.dtype == np.uint32
        if not keep_hits:
            assert (end.channel == 0).all(), h
            continue
        detected = (end.flags & h.event.SURFACE_DETECT) != 0
        assert sorted(set(end.channel[detected])) == [0, 1, 2, 3], h
        assert (end.channel[~detected] == 0).all(), h
        np.testing.assert_array_equal(np.sort(end.channel[detected]),
                                      np.sort(ev.flat_hits.channel))


def test_detector_gets_the_classic_bvh(tmp_path, monkeypatch):
    """A Detector passed without arrays gets the classic BVH that
    loader.create_geometry_from_obj builds, through the port's cache, when
    sim.detector is first read: the JAX Simulation's in DFS layout bit for
    bit, so ops.mesh.build_dfs_arrays takes sim.detector; a second
    Simulation reads it from the cache; given arrays, nothing is built."""
    from chroma_tpu.bvh.dfs import flatten_to_dfs as jflatten
    from chroma_tpu.sim import Simulation as JaxSimulation
    from chroma_tpu_torch import cache as tcache
    from chroma_tpu_torch.bvh import flatten_to_dfs
    from chroma_tpu_torch.ops import mesh
    # the port's cache of its own: the test session shares one directory
    # with the JAX package, whose pickles hold its classes
    cache_dir = str(tmp_path / 'cache')
    monkeypatch.setattr(tcache.Cache.__init__, '__defaults__', (cache_dir,))
    jsim = JaxSimulation(_box_detector(J), seed=0)
    tsim = chroma_tpu_torch.Simulation(_box_detector(T), seed=0,
                                       device='cpu')
    assert not os.path.exists(cache_dir)
    assert tsim.detector.bvh is not None
    mesh_hash = tsim.detector.mesh.md5()
    assert tcache.Cache().list_bvh(mesh_hash) == ['default']
    again = chroma_tpu_torch.Simulation(_box_detector(T), device='cpu')
    cached = tcache.Cache().load_bvh(mesh_hash)
    monkeypatch.setattr(tcache.Cache, 'load_bvh', lambda *a: cached)
    assert again.detector.bvh is cached
    for a, b in zip(jflatten(jsim.detector.bvh),
                    flatten_to_dfs(tsim.detector.bvh)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    dfs = mesh.build_dfs_arrays(tsim.detector)
    assert dfs.n_nodes == len(flatten_to_dfs(tsim.detector.bvh)[0])
    det = _box_detector(T)
    det.flatten()
    sim = chroma_tpu_torch.Simulation(det, device='cpu',
                                      geometry_arrays=tsim.gpu_geometry)
    assert sim.detector is det and det.bvh is None


def test_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', BLOCKED_RUN], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith('OK')
