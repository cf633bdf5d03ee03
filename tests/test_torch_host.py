"""The port's own host modules against the JAX package's originals.

chroma_tpu_torch carries copies of chroma_tpu's host modules (geometry,
detector, make, pmt, demo and its data, event, generator, sample, native,
likelihood, ...) so that it imports nothing of chroma_tpu. The copies must
compute what the originals do: the same geometry built by each package
gives bit-equal GeometryArrays, photon_bomb under one numpy seed gives
equal photons, and both Likelihood classes give the same NLL on one port
Simulation. `host(pkg)` is how every tests/test_torch_*.py builds each
side from its own package.

Both packages build geometry through a native kit (csrc/geometry_kit.cpp)
with a numpy fallback, and the two branches order deduplicated vertices
differently. `same_native_kit` puts both sides on the same branch for
every port test module that builds a geometry in each package: the JAX
kit is built by `make` in place in every process, so a process that loads
it half-written, or whose make fails, keeps the numpy fallback, while the
port's kit loads. The fallback itself is held bit for bit by the
`*_numpy_kit` cases."""
import dataclasses
import fcntl
import os
from importlib import import_module
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chroma_tpu import native as jnative
from chroma_tpu.ops import types as jtypes
import chroma_tpu_torch
from chroma_tpu_torch import native as tnative
from chroma_tpu_torch import perfcache as tperf
from chroma_tpu_torch.ops import propagate as tprop
from chroma_tpu_torch.ops import types as ttypes

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


def same_kit(mp, kit):
    """Put both packages' native geometry kits on one branch while the
    MonkeyPatch `mp` is active: kit 'numpy' forces both onto the numpy
    fallback; kit 'native' loads both libraries, the JAX one under a file
    lock in build/ and once more if its first load failed, and forces both
    onto the fallback if either library is still missing."""
    if kit == 'native':
        os.makedirs(tnative.BUILD_DIR, exist_ok=True)
        lock_path = os.path.join(tnative.BUILD_DIR, 'native_kit.lock')
        with open(lock_path, 'w') as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if jnative._load() is None:
                jnative._tried = False
                jnative._load()
            tnative._load()
    if kit == 'numpy' or jnative._lib is None or tnative._lib is None:
        for mod in (jnative, tnative):
            mp.setattr(mod, '_lib', None)
            mp.setattr(mod, '_tried', True)


@pytest.fixture(scope='module', autouse=True)
def same_native_kit():
    """Both packages on the same native-kit branch for the whole module;
    port test modules that build a geometry in each package import it."""
    with pytest.MonkeyPatch.context() as mp:
        same_kit(mp, 'native')
        yield


@pytest.fixture(scope='module', autouse=True)
def fresh_perf_cache(tmp_path_factory):
    """The port's learned schedules start empty for the whole module:
    CHROMA_CACHE_DIR (which spawned ranks inherit) points at a new
    directory, and the session caches are emptied. A fused bomb's result
    depends on its schedule (the probe's on the first bomb of a batch
    size, a tuned one after it), so no test may read one that an earlier
    run or module left behind. Port test modules that propagate import
    it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('CHROMA_CACHE_DIR', str(tmp_path_factory.mktemp('cache')))
        mp.setattr(tperf, '_DISK', {})
        mp.setattr(tprop, '_SCHED_CACHE', {})
        mp.setattr(tprop, '_PROBE_COUNTS', {})
        yield


def _bits(a):
    "Host array with u32 read as its int32 bit pattern."
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _assert_bitwise(jax_value, torch_value, name):
    a = _bits(jax_value)
    b = torch_value.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, \
        '%s: %s%s vs %s%s' % (name, a.dtype, a.shape, b.dtype, b.shape)
    assert a.tobytes() == b.tobytes(), '%s differs' % name


def _assert_struct(jax_struct, torch_struct, prefix):
    for f in dataclasses.fields(torch_struct):
        tv = getattr(torch_struct, f.name)
        jv = getattr(jax_struct, f.name)
        name = prefix + '.' + f.name
        if isinstance(tv, torch.Tensor):
            _assert_bitwise(jv, tv, name)
        elif dataclasses.is_dataclass(tv):
            _assert_struct(jv, tv, name)
        else:
            assert tv == jv, name


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


def _fixture_rows(fmt):
    "The visit-kernel fixture geometry's instanced table in format fmt."
    from test_torch_bvh import FORMATS, _fixture_instances
    from chroma_tpu.bvh import wide as jwide
    from chroma_tpu_torch.bvh import wide as twide
    pf, bf = FORMATS[fmt]
    out = []
    for pkg, types, wide in (('chroma_tpu', jtypes, jwide),
                             ('chroma_tpu_torch', ttypes, twide)):
        inst, codes = _fixture_instances(pkg, types)
        out.append(wide.build_instanced_bvh(
            inst, material_codes=codes, packed_fanout=pf,
            bounds_fmt=bf).rows)
    return out


@pytest.mark.parametrize('case', ['tiny', 'all_models', 'rows_f32',
                                  'rows_bf16', 'rows_q8'])
def test_builders_bitwise_numpy_kit(monkeypatch, case):
    """The native kit's numpy fallback, forced in both packages, builds the
    same bits in each: demo.tiny() and the all-models detector's
    GeometryArrays, and the fixture geometry's instanced table in every
    bounds format (test_geometry_arrays_bitwise and
    test_torch_bvh.test_instanced_rows_bitwise run on the native kit)."""
    same_kit(monkeypatch, 'numpy')
    assert not jnative.available() and not tnative.available()
    if case.startswith('rows_'):
        j_rows, t_rows = _fixture_rows(case[5:])
        _assert_bitwise(j_rows, t_rows, 'rows')
    else:
        build = {'tiny': _tiny, 'all_models': _all_models}[case]
        _assert_struct(jtypes.build_geometry_arrays(build(J)),
                       ttypes.build_geometry_arrays(build(T)), 'ga')


def test_native_kit_shared():
    "Both packages' builders run on the same native-kit branch here."
    assert (jnative._lib is None) == (tnative._lib is None)


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
