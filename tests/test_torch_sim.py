"""The torch port's Simulation facade.

Against chroma_tpu.Simulation on demo.tiny() with the same 16,384 host
photons: the detected, bulk-absorbed and escaped (NO_HIT) counts must
agree within 4 sigma of the binomial spread of the difference of two
independent runs (the two use different random streams), and so must a
box with a thin-film complex surface. Also: batching routes results to
their events, a CUDA device without a card raises, and the whole package
imports and runs -- a reemitting medium and the likelihood included --
with jax and flax blocked, as on a machine that has neither."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from chroma_tpu import demo, event
from chroma_tpu.detector import Detector
from chroma_tpu.generator import photon_bomb
from chroma_tpu.geometry import (Material, Solid, Surface, vacuum,
                                 SURFACE_COMPLEX)
from chroma_tpu.make import box
from chroma_tpu.ops.types import build_geometry_arrays
import chroma_tpu_torch
from chroma_tpu_torch.ops.types import from_jax_arrays

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _counts(ev):
    f = ev.photons_end.flags
    return {'detected': len(ev.flat_hits),
            'bulk_absorb': int(((f & event.BULK_ABSORB) != 0).sum()),
            'no_hit': int(((f & event.NO_HIT) != 0).sum())}


def _jax_and_port_events(geo, n, monkeypatch):
    """One 400 nm bomb of n photons through chroma_tpu.Simulation and the
    port's, on the same geometry arrays; returns both events."""
    from chroma_tpu.sim import Simulation as JaxSimulation
    # one fused stage: the JAX driver skips its probe bomb and schedule
    # tuning (compile time); the physics and the statistics are the same
    monkeypatch.setenv('CHROMA_FUSED_SCHEDULE', 'none')
    ga = build_geometry_arrays(geo)
    np.random.seed(1)
    bomb = photon_bomb(n, 400.0, (0, 0, 0))

    jsim = JaxSimulation(geo, seed=0, gpu_geometry=ga)
    jev = next(jsim.simulate([bomb[:]], run_daq=True, max_steps=100,
                             keep_photons_end=True))
    tsim = chroma_tpu_torch.Simulation(geo, seed=0, device='cpu',
                                       geometry_arrays=from_jax_arrays(ga))
    tev = next(tsim.simulate([bomb[:]], run_daq=True, max_steps=100,
                             keep_photons_end=True))
    return jev, tev


def _assert_counts_agree(jc, tc, n):
    "Within 4 sigma of the binomial spread of the difference."
    for name in jc:
        p = (jc[name] + tc[name]) / (2.0 * n)
        sigma = np.sqrt(2.0 * n * p * (1.0 - p))
        assert abs(jc[name] - tc[name]) <= 4.0 * sigma + 1e-9, (name, jc,
                                                                  tc)


def test_matches_jax_simulation(monkeypatch):
    geo = demo.tiny()
    geo.flatten()
    n = 16384
    jev, tev = _jax_and_port_events(geo, n, monkeypatch)
    jc, tc = _counts(jev), _counts(tev)
    _assert_counts_agree(jc, tc, n)
    assert tc['detected'] > 0
    # every detected photon reads out on its channel
    assert tev.channels.hit.sum() == len(tev.hits)
    assert set(np.flatnonzero(tev.channels.hit)) == set(tev.hits)
    assert len(tev.photons_end) == n
    assert (tev.flat_hits.flags & event.SURFACE_DETECT).all()


def _box_detector():
    water = Material('w')
    water.set('refractive_index', 1.33)
    water.set('absorption_length', 1e5)
    water.set('scattering_length', 1e5)
    pc = Surface('pc')
    pc.set('detect', 0.5)
    pc.set('absorb', 0.5)
    det = Detector(vacuum)
    det.add_pmt(Solid(box(1000.0, 1000, 1000), water, vacuum, surface=pc))
    det.set_time_dist_gaussian(1.2, -6.0, 6.0)
    det.set_charge_dist_gaussian(1.0, 0.1, 0.5, 1.5)
    return det


def test_multi_event_batch_routing():
    sim = chroma_tpu_torch.Simulation(_box_detector(), seed=31,
                                      device='cpu')
    np.random.seed(0)
    sizes = [100, 300, 200]
    events = [event.Event(id=i, photons_beg=photon_bomb(k, 400.0,
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
        chroma_tpu_torch.Simulation(_box_detector(), device='cuda')


def test_unsupported_surface_model_raises(monkeypatch):
    """A surface model other than the default -- a thin absorbing film
    (the complex model) on a block inside the box detector -- simulates on
    the port with the JAX package's statistics."""
    det = _box_detector()
    film = Surface('film', model=SURFACE_COMPLEX)
    film.set('detect', 0.3)
    film.set('eta', 2.7)
    film.set('k', 1.5)
    film.thickness = 25.0
    film.transmissive = 1
    glass = Material('glass')
    glass.set('refractive_index', 1.5)
    glass.set('absorption_length', 1e4)
    glass.set('scattering_length', 1e6)
    water = det.solids[0].material1[0]
    det.add_solid(Solid(box(300.0, 300, 300), glass, water, surface=film),
                  displacement=(0, 0, 250.0))
    det.flatten()
    n = 16384
    jev, tev = _jax_and_port_events(det, n, monkeypatch)

    def counts(ev):
        f = ev.photons_end.flags
        c = _counts(ev)
        for name in ('SURFACE_ABSORB', 'SURFACE_TRANSMIT', 'REFLECT_DIFFUSE',
                     'REFLECT_SPECULAR'):
            c[name] = int(((f & getattr(event, name)) != 0).sum())
        return c
    jc, tc = counts(jev), counts(tev)
    _assert_counts_agree(jc, tc, n)
    assert tc['SURFACE_TRANSMIT'] > 0 and tc['detected'] > 0


BLOCKED_RUN = textwrap.dedent('''
    import importlib, pkgutil, sys
    assert 'jax' not in sys.modules

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split('.')[0] in ('jax', 'jaxlib', 'flax'):
                raise ImportError('blocked: ' + name)
            return None

    sys.meta_path.insert(0, Blocker())
    import numpy as np
    import chroma_tpu_torch
    for m in pkgutil.walk_packages(chroma_tpu_torch.__path__,
                                   'chroma_tpu_torch.'):
        importlib.import_module(m.name)
    from chroma_tpu.detector import Detector
    from chroma_tpu.generator import photon_bomb
    from chroma_tpu.geometry import Material, Solid, Surface, vacuum
    from chroma_tpu.make import box
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

    # the likelihood facade, reused from chroma_tpu
    from chroma_tpu import event
    from chroma_tpu.likelihood import Likelihood
    events = (event.Event(photons_beg=photon_bomb(200, 400.0, (0, 0, 0)))
              for _ in range(100))
    lk = Likelihood(sim, ev, trange=(-0.5, 20.0))
    assert np.isfinite(lk.eval(events, nevals=3, nreps=1,
                               ndaq=4).nominal_value)
    lk.setup_kernel(events, nevals=3, nreps=1, ndaq=4, oversample_factor=1)
    assert np.isfinite(lk.eval_kernel(events, nevals=3, nreps=1, ndaq=4,
                                      navg=2).nominal_value)

    # a scintillating medium: bulk reemission
    from chroma_tpu.geometry import Geometry, standard_wavelengths as wl
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
    assert not any(m.split('.')[0] in ('jax', 'flax') for m in sys.modules)
    print('OK', len(ev.photons_end))
''')


def test_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', BLOCKED_RUN], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith('OK')
