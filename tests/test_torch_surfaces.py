"""The torch port's full optics step against the JAX step.

One small geometry holds every surface model (default with a residual
PASS, thin-film complex, wavelength shifter, dichroic, angular), a medium
with two bulk-reemission components and an analytic wire plane. Photons of
350-550 nm start from the centre. Each of three steps starts from the JAX
state and both steps consume the same uniforms: the port's DrawPool is fed
the exact blocks the JAX DrawPool draws. Integer fields (flags, last-hit
triangle, medium) must agree on at least 99.9% of the lanes, and the lanes
that differ are printed: an ulp of XLA's against torch's complex division,
sqrt or a transcendental can move a roulette draw across its threshold.
Floats on the agreeing lanes agree to rtol 1e-5. The port must draw exactly
as many uniforms as the JAX step, for plain, weighted and scatter_first=+-1
transport, and under the two switches CHROMA_FORCE_SCATTER_AT_PASS=1 and
CHROMA_PRUNE_TRAVERSAL=0 (both modules imported afresh with the switch
set). Every geometry of tests/test_surfaces.py also simulates on the port
with the distributions that file checks."""
import importlib.util

import numpy as np
import pytest
import torch
import jax

from chroma_tpu import event
from chroma_tpu.detector import Detector
from chroma_tpu.generator import photon_bomb
from chroma_tpu.geometry import (Solid, Material, Surface, WirePlane,
                                 DichroicProps, AngularProps, vacuum,
                                 SURFACE_COMPLEX, SURFACE_WLS,
                                 SURFACE_DICHROIC, SURFACE_ANGULAR,
                                 standard_wavelengths, standard_times)
from chroma_tpu.make import box
from chroma_tpu.ops import photon as jphoton
from chroma_tpu.ops import propagate as jprop
from chroma_tpu.ops import sample as jsample
from chroma_tpu.ops import types as jtypes
import chroma_tpu_torch
from chroma_tpu_torch.ops import photon
from chroma_tpu_torch.ops.sample import DrawPool
from chroma_tpu_torch.ops.types import from_jax_arrays

from test_torch_photon import (FLOAT_FIELDS, INT_FIELDS, jax_blocks,
                               torch_state)

torch.set_num_threads(2)

N = 4096
STEPS = 3
# every model and bulk reemission (see the module docstring), by the JAX
# step's own count
ALL_MODELS_DRAWS = 45


def _pairs(x, y):
    return np.column_stack([x, np.broadcast_to(y, len(x))]).astype(
        np.float32)


def _gauss_cdf(x, mean, sigma):
    pdf = np.exp(-0.5 * ((x - mean) / sigma) ** 2)
    cdf = np.concatenate([[0.0], np.cumsum((pdf[1:] + pdf[:-1]) / 2)])
    return cdf / cdf[-1]


def all_models_detector():
    """A 2 m box of reemitting water-based scintillator behind a WLS wall,
    with a complex-film PMT (the one channel), angular, dichroic, default
    and plain glass blocks around the centre and an absorbing wire plane
    above it."""
    wl = standard_wavelengths
    scint = Material('wbls')
    scint.set('refractive_index', 1.36)
    scint.set('absorption_length', 3000.0)
    scint.set('scattering_length', 4000.0)
    scint.comp_reemission_prob = [_pairs(wl, 0.6), _pairs(wl, 0.9)]
    scint.comp_reemission_wvl_cdf = [_pairs(wl, _gauss_cdf(wl, 430, 15)),
                                     _pairs(wl, _gauss_cdf(wl, 480, 25))]
    scint.comp_reemission_time_cdf = [
        _pairs(standard_times, 1.0 - np.exp(-standard_times / 5.0)),
        _pairs(standard_times, 1.0 - np.exp(-standard_times / 20.0))]
    scint.comp_absorption_length = [_pairs(wl, 5000.0), _pairs(wl, 7500.0)]
    glass = Material('glass')
    glass.set('refractive_index', 1.49)
    glass.set('absorption_length', 1e4)
    glass.set('scattering_length', 1e6)
    metal = Material('metal')
    metal.set('refractive_index', 1.5)
    metal.set('absorption_length', 1e-3)
    metal.set('scattering_length', 1e6)

    pc = Surface('pc', model=SURFACE_COMPLEX)
    pc.set('detect', 0.3)
    pc.set('reflect_diffuse', 0.2)
    pc.set('eta', 2.7)
    pc.set('k', 1.5)
    pc.thickness = 25.0
    pc.transmissive = 1
    wls = Surface('wls', model=SURFACE_WLS)
    wls.set('absorb', 0.5)
    wls.set('reemit', 0.8)
    wls.set('reflect_specular', 0.1)
    wls.set('reflect_diffuse', 0.1)
    wls.set('reemission_cdf', _gauss_cdf(wl, 500.0, 20.0))
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
    default = Surface('default')        # 20% residual PASS
    default.set('detect', 0.3)
    default.set('absorb', 0.2)
    default.set('reflect_diffuse', 0.2)
    default.set('reflect_specular', 0.1)
    wire = Surface('wire')
    wire.set('absorb', 1.0)

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
        radius=1.0, umin=-800, umax=800, vmin=-800, vmax=800,
        surface=wire, material_inner=metal, material_outer=scint))
    det.set_time_dist_gaussian(1.2, -6.0, 6.0)
    det.set_charge_dist_gaussian(1.0, 0.1, 0.5, 1.5)
    det.flatten()
    return det


def bomb(n, seed):
    "Isotropic photons from the centre, 350-550 nm."
    np.random.seed(seed)
    ph = photon_bomb(n, 400.0, (0, 0, 0))
    ph.wavelengths = np.random.uniform(350.0, 550.0, n).astype(np.float32)
    return ph


def fresh_module(name, monkeypatch, **env):
    """A new copy of module `name`, imported with `env` set (sys.modules
    keeps the original)."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    spec = importlib.util.find_spec(name)
    spec = importlib.util.spec_from_file_location(name + '_env_copy',
                                                  spec.origin)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def geometry():
    det = all_models_detector()
    ga = jtypes.build_geometry_arrays(det)
    assert ga.surfaces.models_present == (0, 1, 2, 3, 4)
    assert ga.materials.has_reemission and ga.has_wireplanes
    return ga, from_jax_arrays(ga), jprop.photon_state_from_host(bomb(N, 5))


def assert_lanes_agree(js, ts, min_equal=0.999):
    """A lane agrees when its integer fields are equal and its floats match
    to rtol 1e-5 (absolute floor 1e-5 of the field's scale); at least
    `min_equal` of the lanes must agree, and the others are printed."""
    n = len(ts)
    agree = np.ones(n, bool)
    for name in INT_FIELDS + FLOAT_FIELDS:
        a = np.asarray(getattr(js, name))
        a = a.view(np.int32) if a.dtype == np.uint32 else a
        b = getattr(ts, name).numpy()
        if name in INT_FIELDS:
            ok = a == b
        else:
            atol = 1e-5 * max(float(np.abs(a).max()), 1.0)
            ok = np.isclose(b, a, rtol=1e-5, atol=atol).reshape(n, -1).all(1)
        agree &= ok
    for i in np.flatnonzero(~agree)[:20]:
        print('lane %d differs:' % i, {
            name: (np.asarray(getattr(js, name))[i].tolist(),
                   getattr(ts, name)[i].tolist())
            for name in INT_FIELDS + FLOAT_FIELDS})
    assert agree.mean() >= min_equal, '%d lanes differ' % (~agree).sum()
    return agree


def run_steps_against_jax(ga, ta, js, key, jstep, tstep, **opts):
    """STEPS steps, each from the JAX state: returns the JAX states and the
    port's draw count per step."""
    counts = []
    sf = opts.pop('scatter_first', 0)
    jit = jax.jit(lambda ph, k, sf: jstep(ph, ga, k, scatter_first=sf,
                                          **opts))
    states = []
    for s in range(STEPS):
        step_key = jax.random.fold_in(key, s)
        pool = DrawPool(N, 'cpu', blocks=jax_blocks(step_key, N))
        ts = tstep(torch_state(js), ta, pool, scatter_first=sf, **opts)
        js = jit(js, step_key, sf)
        assert_lanes_agree(js, ts)
        counts.append(pool._count)
        states.append(js)
    return states, counts


def _flag_counts(js):
    f = np.asarray(js.flags)
    return {name: int(((f & bit) != 0).sum()) for name, bit in (
        ('detect', event.SURFACE_DETECT), ('absorb', event.SURFACE_ABSORB),
        ('reemit', event.SURFACE_REEMIT), ('transmit', event.SURFACE_TRANSMIT),
        ('bulk_reemit', event.BULK_REEMIT), ('bulk_absorb', event.BULK_ABSORB),
        ('diffuse', event.REFLECT_DIFFUSE),
        ('specular', event.REFLECT_SPECULAR),
        ('rayleigh', event.RAYLEIGH_SCATTER), ('no_hit', event.NO_HIT))}


@pytest.mark.parametrize('mode', ['plain', 'weights', 'scatter+1',
                                  'scatter-1'])
def test_full_step_matches_jax(geometry, mode, monkeypatch):
    ga, ta, js = geometry
    opts = {'plain': {}, 'weights': {'use_weights': True},
            'scatter+1': {'scatter_first': 1, 'prune': False},
            'scatter-1': {'scatter_first': -1, 'prune': False}}[mode]

    class CountingPool(jsample.DrawPool):
        made = []

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            CountingPool.made.append(self)

    monkeypatch.setattr(jphoton, 'DrawPool', CountingPool)
    states, counts = run_steps_against_jax(
        ga, ta, js, jsample.make_key(3), jphoton.propagate_step,
        photon.propagate_step, **opts)
    jax_draws = CountingPool.made[-1]._count
    assert jax_draws == ALL_MODELS_DRAWS
    assert counts == [jax_draws] * STEPS
    seen = _flag_counts(states[-1])
    print(mode, seen)
    if mode == 'plain':
        # every model, bulk reemission and the wire plane acted
        for name in ('detect', 'absorb', 'reemit', 'transmit',
                     'bulk_reemit', 'diffuse', 'specular', 'rayleigh'):
            assert seen[name] > 0, name
        assert (np.asarray(states[-1].last_hit_triangle) == -2).any()
    elif mode == 'weights':
        # absorption became weight: no bulk absorption, no WLS absorption
        w = np.asarray(states[-1].weight)
        assert (w < 1.0).any() and seen['bulk_absorb'] == 0
        assert seen['reemit'] == 0
    else:
        w = np.asarray(states[-1].weight)
        assert (w < 1.0).any()
        assert (seen['rayleigh'] == 0) == (mode == 'scatter-1')


@pytest.mark.parametrize('switch', ['CHROMA_FORCE_SCATTER_AT_PASS=1',
                                    'CHROMA_PRUNE_TRAVERSAL=0'])
def test_physics_switches_match_jax(geometry, switch, monkeypatch):
    """Both modules re-imported with the switch at its non-default value:
    one step from a state with tracked media (where pruning acts) agrees
    with the JAX step's."""
    ga, ta, js0 = geometry
    name, value = switch.split('=')
    jmod = fresh_module('chroma_tpu.ops.photon', monkeypatch,
                        **{name: value})
    tmod = fresh_module('chroma_tpu_torch.ops.photon', monkeypatch)
    assert jmod.FORCE_SCATTER_AT_PASS == tmod.FORCE_SCATTER_AT_PASS \
        == (name == 'CHROMA_FORCE_SCATTER_AT_PASS')
    assert jmod.PRUNE_TRAVERSAL == tmod.PRUNE_TRAVERSAL \
        == (name != 'CHROMA_PRUNE_TRAVERSAL')
    key = jsample.make_key(4)
    js = jax.jit(jphoton.propagate_step)(js0, ga, jax.random.fold_in(key, 0))
    assert (np.asarray(js.cur_mat) >= 0).all()
    step_key = jax.random.fold_in(key, 1)
    pool = DrawPool(N, 'cpu', blocks=jax_blocks(step_key, N))
    ts = tmod.propagate_step(torch_state(js), ta, pool)
    ref = jax.jit(jmod.propagate_step)(js, ga, step_key)
    assert_lanes_agree(ref, ts)
    # the switch changed the outcome against the default step
    dflt = jax.jit(jphoton.propagate_step)(js, ga, step_key)
    assert not np.array_equal(np.asarray(dflt.flags), np.asarray(ref.flags))


def _beam(n, wavelength=350.0, direction=(0.0, 0.0, 1.0)):
    "A pencil beam from the origin (tests/test_surfaces.py)."
    np.random.seed(0)
    phi = np.random.uniform(0, 2 * np.pi, n)
    return event.Photons(
        pos=np.zeros((n, 3), np.float32),
        dir=np.tile(direction, (n, 1)).astype(np.float32),
        pol=np.column_stack([np.cos(phi), np.sin(phi), np.zeros(n)]),
        wavelengths=np.full(n, wavelength, np.float32),
        t=np.zeros(n, np.float32))


def _box_sim(surface, seed, dims=(1000, 1000, 1000), inside=vacuum):
    from chroma_tpu.geometry import Geometry
    geo = Geometry(vacuum)
    geo.add_solid(Solid(box(*dims), inside, vacuum, surface=surface))
    return chroma_tpu_torch.Simulation(geo, seed=seed, device='cpu')


def _ends(sim, photons, max_steps):
    return next(sim.simulate(photons, keep_photons_end=True,
                             max_steps=max_steps)).photons_end


def _bits(pe, bit):
    return (pe.flags & np.uint32(bit)) != 0


@pytest.mark.parametrize('case', ['wls', 'dichroic', 'angular',
                                  'complex_transparent', 'complex_metal',
                                  'bulk_reemission'])
def test_surface_geometries_simulate(case):
    """Each geometry of tests/test_surfaces.py simulates on the port with
    the distributions that file checks for the JAX package."""
    wl = standard_wavelengths
    if case == 'wls':
        s = Surface('wls', model=SURFACE_WLS)
        s.set('absorb', 1.0)
        s.set('reemit', 1.0)
        s.set('reemission_cdf', _gauss_cdf(wl, 500.0, 20.0))
        s.transmissive = 1
        pe = _ends(_box_sim(s, 4), _beam(20000), 1)
        re = _bits(pe, event.SURFACE_REEMIT)
        assert re.sum() > 15000
        assert abs(pe.wavelengths[re].mean() - 500.0) < 2.0
        assert abs(pe.wavelengths[re].std() - 20.0) < 2.0
        assert abs(pe.dir[re][:, 2].mean()) < 0.05
    elif case == 'dichroic':
        wl_pts = np.array([300.0, 449.0, 451.0, 800.0])
        s = Surface('dichroic', model=SURFACE_DICHROIC)
        s.dichroic_props = DichroicProps(
            [0.0, np.pi / 2],
            [np.column_stack([wl_pts, [1.0, 1.0, 0.0, 0.0]])] * 2,
            [np.column_stack([wl_pts, [0.0, 0.0, 1.0, 1.0]])] * 2)
        s.transmissive = 1
        sim = _box_sim(s, 5)
        assert _bits(_ends(sim, _beam(5000, 350.0), 2),
                     event.REFLECT_SPECULAR).mean() > 0.99
        assert _bits(_ends(sim, _beam(5000, 550.0), 2),
                     event.SURFACE_TRANSMIT).mean() > 0.99
    elif case == 'angular':
        s = Surface('angular', model=SURFACE_ANGULAR)
        s.angular_props = AngularProps(
            [0.0, np.pi / 4, np.pi / 2], transmit=[1.0, 0.0, 0.0],
            reflect_specular=[0.0, 0.0, 0.0],
            reflect_diffuse=[0.0, 0.0, 0.0])
        s.transmissive = 1
        sim = _box_sim(s, 6, dims=(8000, 8000, 1000))
        assert _bits(_ends(sim, _beam(2000), 2),
                     event.SURFACE_TRANSMIT).mean() > 0.99
        oblique = _beam(2000, direction=(np.sin(np.pi / 3), 0.0,
                                         np.cos(np.pi / 3)))
        assert _bits(_ends(sim, oblique, 2),
                     event.SURFACE_ABSORB).mean() > 0.99
    elif case.startswith('complex'):
        s = Surface('film', model=SURFACE_COMPLEX)
        metal = case == 'complex_metal'
        s.set('eta', 1.5 if metal else 1.0)
        s.set('k', 3.0 if metal else 0.0)
        s.thickness = 200.0 if metal else 100.0
        s.transmissive = 1
        pe = _ends(_box_sim(s, 8 if metal else 7), _beam(2000),
                   3 if metal else 2)
        ended = _bits(pe, event.SURFACE_ABSORB | event.SURFACE_DETECT)
        if metal:
            reflected = _bits(pe, event.REFLECT_SPECULAR
                              | event.REFLECT_DIFFUSE)
            assert (ended | reflected).mean() > 0.9
        else:
            assert _bits(pe, event.SURFACE_TRANSMIT).mean() > 0.98
            assert ended.mean() < 0.01
    else:
        scint = Material('scint')
        scint.set('refractive_index', 1.5)
        scint.set('absorption_length', 100.0)
        scint.set('scattering_length', 1e9)
        scint.comp_reemission_prob = [_pairs(wl, 1.0)]
        scint.comp_reemission_wvl_cdf = [_pairs(wl, _gauss_cdf(wl, 430.0,
                                                              15.0))]
        scint.comp_reemission_time_cdf = [_pairs(
            standard_times, 1.0 - np.exp(-standard_times / 5.0))]
        scint.comp_absorption_length = [_pairs(wl, 100.0)]
        pe = _ends(_box_sim(None, 9, dims=(5000, 5000, 5000), inside=scint),
                   _beam(20000), 2)
        re = _bits(pe, event.BULK_REEMIT)
        assert re.sum() > 15000
        assert abs(pe.wavelengths[re].mean() - 430.0) < 3.0
