"""The port's own host modules against the JAX package's originals.

chroma_tpu_torch carries copies of chroma_tpu's host modules (geometry,
detector, make, pmt, demo and its data, event, generator, sample, native,
likelihood, ...) so that it imports nothing of chroma_tpu. The copies must
compute what the originals do: the same geometry built by each package
gives bit-equal GeometryArrays, photon_bomb under one numpy seed gives
equal photons, and both Likelihood classes give the same NLL on one port
Simulation. `host(pkg)` is how every tests/test_torch_*.py builds each
side from its own package."""
from importlib import import_module
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chroma_tpu.ops import types as jtypes
import chroma_tpu_torch
from chroma_tpu_torch.ops import types as ttypes

from test_torch_bvh import _assert_struct

torch.set_num_threads(2)

JAX_PKG, PORT_PKG = 'chroma_tpu', 'chroma_tpu_torch'


def host(pkg):
    """The public host names of package `pkg` (chroma_tpu or
    chroma_tpu_torch) in one namespace: the classes and functions of
    geometry, make, detector, generator, transform and pmt, and the modules
    event, demo, optics (demo.optics) and likelihood."""
    names = {}
    for mod in ('geometry', 'make', 'detector', 'generator', 'transform',
                'pmt'):
        names.update((k, v) for k, v in vars(import_module(pkg + '.' + mod))
                     .items() if not k.startswith('_'))
    for mod in ('event', 'demo', 'likelihood'):
        names[mod] = import_module(pkg + '.' + mod)
    names['optics'] = import_module(pkg + '.demo.optics')
    names['Likelihood'] = names['likelihood'].Likelihood
    return SimpleNamespace(**names)


J, T = host(JAX_PKG), host(PORT_PKG)


def test_host_namespaces_are_separate():
    "Each side's classes come from its own package."
    for name in ('Geometry', 'Detector', 'Solid', 'Mesh', 'Material',
                 'Surface', 'Likelihood'):
        assert getattr(J, name).__module__.startswith(JAX_PKG + '.')
        assert getattr(T, name).__module__.startswith(PORT_PKG + '.')
    assert T.event.Photons is not J.event.Photons
    assert T.optics.__file__.startswith(
        chroma_tpu_torch.__path__[0])


def _tiny(h):
    geo = h.demo.tiny()
    geo.flatten()
    return geo


def _all_models(h):
    from test_torch_surfaces import all_models_detector
    return all_models_detector(h)


@pytest.mark.parametrize('build', [_tiny, _all_models],
                         ids=['tiny', 'all_models'])
def test_geometry_arrays_bitwise(build):
    """demo.tiny() and the all-models detector (every surface model, bulk
    reemission, a wire plane, channels) built by each package and
    marshalled by each package's builder: every GeometryArrays field has
    the same bits."""
    ga_j = jtypes.build_geometry_arrays(build(J))
    ga_t = ttypes.build_geometry_arrays(build(T))
    _assert_struct(ga_j, ga_t, 'ga')


@pytest.mark.parametrize('n,wavelength,pos', [(1000, 400.0, (0, 0, 0)),
                                              (4097, 350.0, (10, -5, 2.5))])
def test_photon_bomb_equal(n, wavelength, pos):
    bombs = []
    for h in (J, T):
        np.random.seed(17)
        bombs.append(h.photon_bomb(n, wavelength, pos, t0=1.5))
    for name in ('pos', 'dir', 'pol', 'wavelengths', 't',
                 'last_hit_triangles', 'flags', 'weights', 'evidx',
                 'channel'):
        a, b = (getattr(p, name) for p in bombs)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


def test_vertex_gun_equal():
    "The particle gun and its photons, as the likelihood path makes them."
    out = []
    for h in (J, T):
        np.random.seed(5)
        gun = h.constant_particle_gun('e-', (0, 0, 0), (0, 0, 1), 2.0)
        ev = next(h.vertex_gun_to_events(gun))
        out.append(ev.photons_beg)
    for name in ('pos', 'dir', 'pol', 'wavelengths', 't'):
        a, b = (getattr(p, name) for p in out)
        assert len(a) > 0 and a.tobytes() == b.tobytes(), name


def _box_detector(h):
    "The tests/test_pdf.py box detector, from host namespace h."
    water = h.Material('water')
    water.set('refractive_index', 1.33)
    water.set('absorption_length', 1e5)
    water.set('scattering_length', 1e5)
    pc = h.Surface('pc')
    pc.set('detect', 0.5)
    pc.set('absorb', 0.5)
    det = h.Detector(h.vacuum)
    det.add_pmt(h.Solid(h.box(1000.0, 1000, 1000), water, h.vacuum,
                        surface=pc))
    det.set_time_dist_gaussian(1.2, -6.0, 6.0)
    det.set_charge_dist_gaussian(1.0, 0.1, 0.5, 1.5)
    return det


def _events(n, nphotons=200):
    for _ in range(n):
        yield T.event.Event(photons_beg=T.photon_bomb(nphotons, 400.0,
                                                      (0, 0, 0)))


@pytest.mark.parametrize('method', ['eval', 'eval_kernel'])
def test_likelihoods_agree(method):
    """chroma_tpu.likelihood.Likelihood and the port's copy, each driving a
    fresh port Simulation with seed 4 on the same observed event and the
    same numpy-seeded events, give the same NLL and uncertainty."""
    det = _box_detector(T)
    obs = None
    nll = []
    for cls in (J.Likelihood, T.Likelihood):
        sim = chroma_tpu_torch.Simulation(det, seed=4, device='cpu')
        np.random.seed(3)
        ev = next(sim.simulate(T.photon_bomb(300, 400.0, (0, 0, 0)),
                               run_daq=True))
        obs = ev if obs is None else obs
        lk = cls(sim, obs, trange=(-0.5, 20.0))
        np.random.seed(4)
        if method == 'eval':
            value = lk.eval(_events(30), nevals=3, nreps=1, ndaq=4)
        else:
            lk.setup_kernel(_events(30), nevals=3, nreps=1, ndaq=4,
                            oversample_factor=1)
            value = lk.eval_kernel(_events(30), nevals=3, nreps=1, ndaq=4,
                                   navg=2)
        nll.append((value.nominal_value, value.s))
    assert np.isfinite(nll[0][0]) and nll[0] == nll[1], nll
