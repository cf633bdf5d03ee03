#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (chroma_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # from the repository root
    python3 chip_smoke.py --profile FILE   # also profile the quick,
                                          # quick-optics and likelihood
                                          # paths, full tables to FILE

Phases, each printing its results; any failure raises and the exit code is
non-zero:

  0. card and software (nvidia-smi name and power limit, torch, CUDA);
  1. build the visit kernel (csrc/visit_kernel.cu) with nvcc;
  2. the kernel against its plain PyTorch version on the card, 65,536 rays,
     on the visit-kernel fixture geometry in f32, bf16 and q8 bounds, on
     demo.tiny() and on the quick demo detector: triangles, instance ids,
     codes and visit counts equal, distances and normals to rtol 1e-5;
  3. three propagation steps of 65,536 quick-detector photons on the card
     (kernel) and on the CPU (plain version) with the same uniforms: on
     >= 99.9% of lanes flags, last-hit triangles and media equal and
     floats to rtol 1e-5 (absolute floor: 1e-5 of the field's scale);
  4. kernel and plain traversal times at 2^20 rays (CUDA events, median of
     5 runs);
  5. the main path: Simulation(quick detector, device='cuda') on a 2^20
     photon bomb with run_daq=True, counting the kernel's launches; its
     detected fraction is checked against a 65,536-photon run on the CPU;
  6. full optics ("quick-optics"): the quick detector rebuilt with every
     surface model -- thin-film complex photocathodes, angular light
     cones, dichroic PMT backs, a wavelength-shifting outer sphere -- in
     water with one bulk-reemission component: three steps card vs CPU as
     in phase 3, then the 2^20-photon Simulation with each model's flag bit
     counted (each must be non-zero) and its detected fraction against a
     65,536-photon CPU run;
  7. wire planes ("lartpc-wires"): three absorbing U/V/Y anode planes in a
     2 m liquid-argon box; intersect_wireplanes card vs CPU on 65,536 rays
     (hits equal, distances to rtol 1e-5), then a 2^20-photon Simulation
     with the share of photons absorbed on wires and the candidate-wire
     iterations per plane;
  8. likelihood: a 10 MeV electron's ~10^4 photons in the quick-optics
     detector as the observed event; Likelihood.eval (nreps=4, ndaq=50,
     nevals=4), setup_kernel and eval_kernel (navg=2), create_pdf; the
     summed hit probability is checked against a CPU run.

The kernel's launches are counted on each main path (phases 5 to 8, reset
just before and read just after) and printed per phase. The last lines are
a JSON object describing the kernels, and {"ok": true, "device": {...}}.
Needs CUDA and the repository checkout.
"""
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

N_CHECK = 65536
N_TIME = 1 << 20
N_BOMB = 1 << 20
QUICK = (4000.0, 4500.0, 400.0)     # demo.detector args of the quick cell
RTOL = 1e-5
GUN_MEV = 10.0      # phase 8's electron: ~10^4 photons (1000 per MeV)
LIKELIHOOD = (4, 4, 50)             # phase 8's nevals, nreps, ndaq


def log(*args):
    print(*args, flush=True)


def card_line():
    proc = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def fixture_table(fmt):
    "The tests/test_visit_kernel.py fixture geometry as a port table."
    from chroma_tpu.geometry import Geometry, Solid
    from chroma_tpu.demo.optics import water, glass
    from chroma_tpu.make import box, sphere
    from chroma_tpu_torch.bvh.wide import build_instanced_bvh
    from chroma_tpu_torch.ops.types import pack_material_codes
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
    packed, bounds = {'f32': (0, 'f32'), 'bf16': (32, 'bf16'),
                      'q8': (32, 'q8')}[fmt]
    return build_instanced_bvh(instances, material_codes=codes,
                               packed_fanout=packed, bounds_fmt=bounds)


def detector_arrays(args):
    from chroma_tpu import demo
    from chroma_tpu_torch.ops.types import build_geometry_arrays
    t0 = time.perf_counter()
    geo = demo.detector(*args)
    geo.flatten()
    ga = build_geometry_arrays(geo)
    log('  built demo.detector%s: %d triangles, %d rows x %d, %s bounds, '
        'fanout %d, depth %d, %.1f s' % (
            args, len(geo.mesh.triangles), ga.wide.rows.shape[0],
            ga.wide.rows.shape[1], ga.wide.bounds_fmt, ga.wide.fanout,
            ga.wide.max_depth, time.perf_counter() - t0))
    return geo, ga


def ray_mix(n, seed, radius, device):
    """Half the rays from the centre, isotropic; half from random origins
    inside `radius` (a box of half-width `radius` around the fixture): 10%
    masked, 25% with a distance limit."""
    import torch
    rs = np.random.RandomState(seed)
    d = rs.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.zeros((n, 3))
    half = n // 2
    if radius is None:      # fixture: random points around the solids
        o[half:] = rs.uniform(-200, 200, (n - half, 3))
        target = rs.uniform((-150, -50, -40), (150, 50, 40), (n - half, 3))
        d[half:] = target - o[half:]
        d[half:] /= np.linalg.norm(d[half:], axis=1, keepdims=True)
    else:
        r = radius * rs.uniform(size=n - half) ** (1 / 3.0)
        v = rs.randn(n - half, 3)
        o[half:] = v / np.linalg.norm(v, axis=1, keepdims=True) * r[:, None]
    mask = rs.uniform(size=n) >= 0.1
    limit = np.where(rs.uniform(size=n) < 0.25, rs.uniform(10, 2000, n),
                     np.inf)

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype)).to(device)
    return (t(o, np.float32), t(d, np.float32), t(mask, bool),
            t(limit, np.float32), rs.uniform(size=n) < 0.5)


def compare_kernel(name, table, rays):
    """Kernel against the plain traversal on the same card; returns the
    largest absolute distance/normal difference on hits."""
    import torch
    from chroma_tpu_torch.ops import mesh_wide, visit_kernel
    o, d, mask, limit, relast = rays
    first = visit_kernel.traverse(table, o, d)[0]
    last = torch.where(torch.from_numpy(relast).to(o.device), first,
                       -1).to(torch.int32)
    args = (table, o, d, last, mask, limit)
    ref = [x.cpu().numpy() for x in mesh_wide.traverse(*args)]
    got = [x.cpu().numpy() for x in visit_kernel.traverse(*args)]
    torch.cuda.synchronize()
    tri, dist, code, normal, iid, visits = ref
    for label, a, b in (('tri', got[0], tri), ('code', got[2], code),
                        ('iid', got[4], iid), ('visits', got[5], visits)):
        np.testing.assert_array_equal(a, b, err_msg='%s %s' % (name, label))
    hit = tri >= 0
    np.testing.assert_array_equal(got[1][~hit], dist[~hit])
    np.testing.assert_allclose(got[1][hit], dist[hit], rtol=RTOL,
                               err_msg=name + ' dist')
    np.testing.assert_allclose(got[3][hit], normal[hit], rtol=RTOL,
                               atol=RTOL * np.abs(normal[hit]).max(),
                               err_msg=name + ' normal')
    err = max(float(np.abs(got[1][hit] - dist[hit]).max(initial=0.0)),
              float(np.abs(got[3][hit] - normal[hit]).max(initial=0.0)))
    log('  %-22s %6d rays: %5.1f%% hit, mean visits %.2f, max %d, equal '
        '(max |diff| %.3g)' % (name, len(tri), 100.0 * hit.mean(),
                               visits.mean(), visits.max(), err))
    return err


def compare_steps(ga, device, n, nsteps):
    """`nsteps` propagation steps on the card and on the CPU with the same
    injected uniforms; >= 99.9% of the lanes must agree."""
    import torch
    from chroma_tpu.generator import photon_bomb
    from chroma_tpu_torch.ops.photon import propagate_step
    from chroma_tpu_torch.ops.propagate import photon_state_from_host
    from chroma_tpu_torch.ops.sample import DrawPool
    np.random.seed(3)
    bomb = photon_bomb(n, 400.0, (0, 0, 0))
    states = {}
    for dev in (device, 'cpu'):
        g = ga.to(dev)
        ps = photon_state_from_host(bomb, dev)
        for s in range(nsteps):
            def blocks(b, s=s):
                return np.random.RandomState(1000 * s + b).uniform(
                    size=(8, n)).astype(np.float32)
            ps = propagate_step(ps, g, DrawPool(n, dev, blocks=blocks))
        states[dev] = ps.to('cpu')
    gpu, cpu = states[device], states['cpu']
    # CUDA's and the CPU's cos/sin/acos/log may differ in the last ulp;
    # a photon that then meets the shared edge of two triangles can take
    # the neighbour (both pass Moller-Trumbore's edge tolerance), and
    # arccos near +-1 (near-normal incidence) turns an ulp of a cosine
    # into ~1e-5 of a direction. So a lane agrees when its integer fields
    # are equal and its floats match to rtol 1e-5 with an absolute floor
    # of 1e-5 of the field's scale; >= 99.9% of lanes must agree, and the
    # others are printed
    agree = np.ones(n, bool)
    for name in ('flags', 'last_hit_triangle', 'cur_mat'):
        a, b = getattr(gpu, name).numpy(), getattr(cpu, name).numpy()
        bad = np.flatnonzero(a != b)
        agree[bad] = False
        log('  %s: %d of %d lanes differ %s' % (
            name, len(bad), n, [(int(i), int(a[i]), int(b[i]))
                                for i in bad[:5]]))
    err = 0.0
    for name in ('pos', 'dir', 'pol', 't', 'wavelength'):
        a = getattr(gpu, name).numpy().reshape(n, -1)
        b = getattr(cpu, name).numpy().reshape(n, -1)
        atol = RTOL * max(float(np.abs(b).max()), 1.0)
        close = np.isclose(a, b, rtol=RTOL, atol=atol).all(axis=1)
        bad = np.flatnonzero(~close)
        log('  %s: %d lanes beyond tolerance, worst |diff| %.3g' % (
            name, len(bad), float(np.abs(a - b).max())))
        agree &= close
        err = max(err, float(np.abs(a - b)[agree].max(initial=0.0)))
    assert agree.mean() >= 0.999, '%d lanes disagree' % (~agree).sum()
    log('  %d steps x %d photons: %d lanes agree (%.4f%%), max |diff| on '
        'them %.3g; %d alive' % (nsteps, n, agree.sum(),
                                 100.0 * agree.mean(), err,
                                 int(gpu.alive.sum())))


def time_cuda(fn, reps=5):
    "Median milliseconds of fn() over `reps` runs, by CUDA events."
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), times


def detected_fraction_check(frac_a, n_a, frac_b, n_b, label):
    "Two detected fractions agree within 5 sigma (binomial)."
    p = (frac_a * n_a + frac_b * n_b) / (n_a + n_b)
    sigma = np.sqrt(p * (1 - p) * (1.0 / n_a + 1.0 / n_b))
    log('  %s: %.5f vs %.5f (%.2f sigma)' % (label, frac_a, frac_b,
                                           abs(frac_a - frac_b) / sigma))
    assert abs(frac_a - frac_b) <= 5 * sigma, label


FLAG_BITS = ('SURFACE_DETECT', 'SURFACE_ABSORB', 'SURFACE_REEMIT',
             'SURFACE_TRANSMIT', 'BULK_REEMIT', 'BULK_ABSORB',
             'REFLECT_DIFFUSE', 'REFLECT_SPECULAR', 'RAYLEIGH_SCATTER',
             'NO_HIT')


def flag_counts(flags):
    "Photons with each history bit set."
    from chroma_tpu import event
    return {name: int(((flags & getattr(event, name)) != 0).sum())
            for name in FLAG_BITS}


def quick_optics_detector():
    """demo.detector(4000, 4500, 400)'s placement (630 PMTs) rebuilt with
    chroma_tpu.pmt's public functions, with every surface model and bulk
    reemission:

      * photocathode: the thin-film complex model, detect = the R7081HQE
        QE (demo/data/r7081hqe_detect.csv), a bialkali (K2CsSb) film of
        eta 2.7, k 1.5 and 23 nm -- about the optical constants near
        400 nm and the thickness reported by Motta and Schoenert, NIM A
        539 (2005) 217 -- taken as flat in wavelength;
      * light cones: an angular surface, specular 0.90 at normal incidence
        falling to 0.80 at grazing, the rest diffuse or absorbed;
      * PMT backs: a dichroic filter reflecting below 450 nm and
        transmitting above (the table of tests/test_surfaces.py:71-77);
      * outer sphere: a wavelength shifter, absorb 1, reemit 0.3 at the
        500 nm CDF of tests/test_surfaces.py:40-50, transmissive;
      * medium: the demo water with one reemission component (430 nm,
        5 ns CDFs of tests/test_surfaces.py:176-194) whose absorption
        length is the water's. With one component every bulk absorption
        is the component's (chroma_tpu/ops/photon.py:515-517): the
        reemission probability, 0.25, sets the share of a 400 nm bomb that
        reemits to a few percent."""
    from chroma_tpu import demo
    from chroma_tpu.demo import optics
    from chroma_tpu.detector import Detector
    from chroma_tpu.geometry import (Material, Solid, Surface, DichroicProps,
                                     AngularProps, SURFACE_COMPLEX,
                                     SURFACE_WLS, SURFACE_DICHROIC,
                                     SURFACE_ANGULAR, standard_wavelengths,
                                     standard_times)
    from chroma_tpu.make import sphere
    from chroma_tpu.pmt import build_pmt, build_light_collector_from_file
    from chroma_tpu.transform import make_rotation_matrix, normalize
    data = os.path.join(os.path.dirname(demo.__file__), 'data')
    wl = standard_wavelengths

    def pairs(x, y):
        return np.column_stack([x, np.broadcast_to(y, len(x))]).astype(
            np.float32)

    def gauss_cdf(mean, sigma):
        pdf = np.exp(-0.5 * ((wl - mean) / sigma) ** 2)
        cdf = np.concatenate([[0.0], np.cumsum((pdf[1:] + pdf[:-1]) / 2)])
        return cdf / cdf[-1]

    medium = Material('wbls')
    medium.refractive_index = optics.water.refractive_index
    medium.absorption_length = optics.water.absorption_length
    medium.scattering_length = optics.water.scattering_length
    medium.comp_reemission_prob = [pairs(wl, 0.25)]
    medium.comp_reemission_wvl_cdf = [pairs(wl, gauss_cdf(430.0, 15.0))]
    medium.comp_reemission_time_cdf = [pairs(
        standard_times, 1.0 - np.exp(-standard_times / 5.0))]
    medium.comp_absorption_length = [
        optics.water.absorption_length.astype(np.float32)]

    cathode = Surface('bialkali_film', model=SURFACE_COMPLEX)
    cathode.detect = optics.r7081hqe_photocathode.detect
    cathode.set('eta', 2.7)
    cathode.set('k', 1.5)
    cathode.thickness = 23.0
    cathode.transmissive = 1
    cone = Surface('cone', model=SURFACE_ANGULAR)
    cone.angular_props = AngularProps(
        [0.0, np.pi / 4, np.pi / 2], transmit=[0.0, 0.0, 0.0],
        reflect_specular=[0.90, 0.85, 0.80],
        reflect_diffuse=[0.05, 0.05, 0.10])
    wl_pts = np.array([300.0, 449.0, 451.0, 800.0])
    back = Surface('dichroic_back', model=SURFACE_DICHROIC)
    back.dichroic_props = DichroicProps(
        [0.0, np.pi / 2],
        [np.column_stack([wl_pts, [1.0, 1.0, 0.0, 0.0]])] * 2,
        [np.column_stack([wl_pts, [0.0, 0.0, 1.0, 1.0]])] * 2)
    back.transmissive = 1
    wls = Surface('wls_sphere', model=SURFACE_WLS)
    wls.set('absorb', 1.0)
    wls.set('reemit', 0.3)
    wls.set('reemission_cdf', gauss_cdf(500.0, 20.0))
    wls.transmissive = 1

    pmt = build_pmt(os.path.join(data, 'sno_pmt.txt'), 3.0,
                    outer_material=medium, glass=optics.glass,
                    vacuum=optics.vacuum, photocathode_surface=cathode,
                    back_surface=back, nsteps=24) \
        + build_light_collector_from_file(os.path.join(data, 'sno_cone.txt'),
                                          outer_material=medium,
                                          surface=cone, nsteps=24)
    pmt_radius, sphere_radius, spacing = QUICK
    geo = Detector(medium)
    geo.add_solid(Solid(sphere(sphere_radius, nsteps=200), medium, medium,
                        surface=wls, color=0xBBFFFFFF))
    y_axis = np.array((0.0, 1.0, 0.0))
    for position in demo.spherical_spiral(pmt_radius, spacing):
        direction = -normalize(position)
        rotation = make_rotation_matrix(
            np.arccos(np.dot(y_axis, direction)),
            np.cross(direction, y_axis))
        geo.add_pmt(pmt, rotation, position)
    geo.set_time_dist_gaussian(1.5, -7.5, 7.5)
    geo.set_charge_dist_gaussian(1.0, 0.1, 0.0, 1.5)
    return geo


def lartpc_geometry():
    """A 2 m liquid-argon box with absorbing walls and three absorbing
    anode planes (U/V/Y: wires at 0 and +-60 degrees) 3 mm apart at
    z = 0, 3, 6 mm: 3 mm pitch, 0.15 mm radius, 1 m x 1 m, the geometry of
    tests/test_wireplane.py:15-37 with the layout of running LArTPCs."""
    from chroma_tpu.geometry import (Geometry, Material, Solid, Surface,
                                     WirePlane, vacuum)
    from chroma_tpu.make import box
    lar = Material('lar')
    lar.set('refractive_index', 1.38)
    lar.set('absorption_length', 1e6)
    lar.set('scattering_length', 1e6)
    metal = Material('metal')
    metal.set('refractive_index', 1.5)
    metal.set('absorption_length', 1e-3)
    metal.set('scattering_length', 1e6)
    absorber = Surface('absorber')
    absorber.set('absorb', 1.0)
    geo = Geometry(vacuum)
    geo.add_solid(Solid(box(2000.0, 2000.0, 2000.0), lar, vacuum,
                        surface=absorber))
    for i, deg in enumerate((0.0, 60.0, -60.0)):
        a = np.radians(deg)
        geo.add_wireplane(WirePlane(
            origin=(0.0, 0.0, 3.0 * i), u=(np.cos(a), np.sin(a), 0.0),
            v=(-np.sin(a), np.cos(a), 0.0), pitch=3.0, radius=0.15,
            umin=-500, umax=500, vmin=-500, vmax=500, surface=absorber,
            material_inner=metal, material_outer=lar))
    geo.flatten()
    return geo


def run_main_path(sim, n, seed, pos=(0, 0, 0), run_daq=True):
    """A bomb of n 400 nm photons from `pos` through sim.simulate, with
    the visit kernel's launches counted from 0: returns (event, wall s,
    NaN aborts, launches)."""
    from chroma_tpu_torch.ops import visit_kernel
    import torch
    from chroma_tpu.generator import photon_bomb
    from chroma_tpu import event
    np.random.seed(seed)
    bomb = photon_bomb(n, 400.0, pos)
    if sim.device.type == 'cuda':
        torch.cuda.synchronize()
    visit_kernel.launches = 0
    t0 = time.perf_counter()
    ev = next(sim.simulate([bomb], run_daq=run_daq, max_steps=100,
                           keep_photons_end=True))
    if sim.device.type == 'cuda':
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = visit_kernel.launches
    aborts = int(((ev.photons_end.flags & event.NAN_ABORT) != 0).sum())
    return ev, wall, aborts, launches


def phase_quick_optics(device, card):
    "Phase 6: every surface model and bulk reemission at full width."
    import torch
    import chroma_tpu_torch
    from chroma_tpu_torch.ops.types import build_geometry_arrays
    t0 = time.perf_counter()
    geo = quick_optics_detector()
    geo.flatten()
    ga = build_geometry_arrays(geo)
    log('phase 6: quick-optics detector: %d triangles, %d channels, surface '
        'models %s, %d reemission component(s), built in %.1f s' % (
            len(geo.mesh.triangles), ga.detector.nchannels,
            ga.surfaces.models_present, ga.materials.max_comp,
            time.perf_counter() - t0))
    compare_steps(ga, device, N_CHECK, 3)

    sim = chroma_tpu_torch.Simulation(geo, seed=0, device='cuda',
                                      geometry_arrays=ga)
    torch.cuda.reset_peak_memory_stats()
    ev, wall, aborts, launches = run_main_path(sim, N_BOMB, 8)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    counts = flag_counts(ev.photons_end.flags)
    log('  Simulation: wall %.3f s, %.0f photons/s, detected %d, channels '
        'hit %d of %d, NaN aborts %d, visit-kernel launches %d, peak device '
        'memory %.0f MiB (%s)' % (
            wall, N_BOMB / wall, len(ev.flat_hits),
            int(ev.channels.hit.sum()), len(ev.channels.hit), aborts,
            launches, peak, card))
    log('  flag bits: %s; bulk reemission share %.4f' % (
        json.dumps(counts), counts['BULK_REEMIT'] / N_BOMB))
    assert launches > 0 and aborts == 0
    for name in ('SURFACE_DETECT', 'SURFACE_REEMIT', 'SURFACE_TRANSMIT',
                 'BULK_REEMIT', 'REFLECT_DIFFUSE', 'REFLECT_SPECULAR'):
        assert counts[name] > 0, name
    assert np.isfinite(ev.flat_hits.t).all()
    assert np.isfinite(ev.channels.t[ev.channels.hit]).all()

    cpu_sim = chroma_tpu_torch.Simulation(geo, seed=1, device='cpu',
                                          geometry_arrays=ga)
    cev, cwall, caborts, _ = run_main_path(cpu_sim, N_CHECK, 9)
    assert caborts == 0
    log('  CPU reference: %d photons in %.1f s, detected %d' % (
        N_CHECK, cwall, len(cev.flat_hits)))
    detected_fraction_check(len(ev.flat_hits) / N_BOMB, N_BOMB,
                            len(cev.flat_hits) / N_CHECK, N_CHECK,
                            'quick-optics detected fraction, card vs CPU')
    return geo, ga, sim, launches, wall


def phase_lartpc(device, card):
    "Phase 7: analytic wire planes."
    import torch
    import chroma_tpu_torch
    from chroma_tpu import event
    from chroma_tpu_torch.ops.types import build_geometry_arrays
    from chroma_tpu_torch.ops.wireplane import (candidate_windows,
                                                intersect_wireplanes)
    geo = lartpc_geometry()
    ga = build_geometry_arrays(geo)
    log('phase 7: lartpc-wires: %d wire planes' % ga.wireplanes.pitch.shape[0])
    rs = np.random.RandomState(10)
    pos = np.column_stack([rs.uniform(-600, 600, (N_CHECK, 2)),
                           rs.uniform(-300, 300, N_CHECK)]).astype(np.float32)
    d = rs.randn(N_CHECK, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    out = {}
    for dev in (device, 'cpu'):
        g = ga.to(dev)
        args = [torch.from_numpy(x).to(dev) for x in (pos, d)]
        active = torch.ones(N_CHECK, dtype=torch.bool, device=dev)
        hit = intersect_wireplanes(*args, g, active)
        out[dev] = (hit.hit.cpu().numpy(), hit.distance.cpu().numpy())
    (gh, gd), (ch, cd) = out[device], out['cpu']
    np.testing.assert_array_equal(gh, ch)
    np.testing.assert_allclose(gd[gh], cd[ch], rtol=RTOL)
    log('  intersect_wireplanes, %d rays: %d hits, card and CPU equal hits, '
        'max |diff| of distances %.3g' % (
            N_CHECK, int(gh.sum()), float(np.abs(gd[gh] - cd[ch]).max(
                initial=0.0))))

    source = (0.0, 0.0, -300.0)
    sim = chroma_tpu_torch.Simulation(geo, seed=0, device='cuda',
                                      geometry_arrays=ga)
    np.random.seed(11)
    from chroma_tpu.generator import photon_bomb
    bomb = photon_bomb(N_BOMB, 400.0, source)
    g = sim.gpu_geometry
    windows = candidate_windows(
        torch.from_numpy(bomb.pos.astype(np.float32)).to(device),
        torch.from_numpy(bomb.dir.astype(np.float32)).to(device), g,
        torch.ones(N_BOMB, dtype=torch.bool, device=device))
    stats = ['plane %d: mean %.2f (over rays that reach it %.2f), max %d' % (
        i, float(w.float().mean()), float(w[w > 0].float().mean()),
        int(w.max())) for i, w in enumerate(windows)]
    log('  candidate-wire iterations of the first step: ' + '; '.join(stats))
    torch.cuda.reset_peak_memory_stats()
    ev, wall, aborts, launches = run_main_path(sim, N_BOMB, 11, pos=source,
                                               run_daq=False)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    pe = ev.photons_end
    on_wire = (pe.last_hit_triangles == -2) \
        & ((pe.flags & event.SURFACE_ABSORB) != 0)
    log('  Simulation: wall %.3f s, %.0f photons/s, absorbed on wires %d '
        '(%.4f), NaN aborts %d, visit-kernel launches %d, peak device '
        'memory %.0f MiB (%s)' % (wall, N_BOMB / wall, int(on_wire.sum()),
                                  on_wire.mean(), aborts, launches, peak,
                                  card))
    log('  flag bits: %s' % json.dumps(flag_counts(pe.flags)))
    assert launches > 0 and aborts == 0 and on_wire.sum() > 0
    assert np.isfinite(pe.pos).all()
    return launches, wall


def hit_channels_per_readout(sim, events, nreps, ndaq, trange):
    """Mean number of channels hit inside trange per DAQ readout, one value
    per propagation (the ndaq readouts of one propagation share photons)."""
    out = []
    for ev in events:
        for _ in range(nreps):
            t = sim._run_daq_once(ev, ndaq).earliest_time.reshape(ndaq, -1)
            ok = (t >= trange[0]) & (t <= trange[1])
            out.append(float(ok.sum()) / ndaq)
    return np.asarray(out)


def likelihood_gun(seed):
    "Events of a GUN_MEV electron at the centre heading +z, seeded."
    from chroma_tpu.generator import (constant_particle_gun,
                                      vertex_gun_to_events)
    np.random.seed(seed)
    return vertex_gun_to_events(constant_particle_gun(
        'e-', (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), GUN_MEV))


def phase_likelihood(geo, ga, sim, card):
    "Phase 8: the hybrid-MC likelihood path on the quick-optics detector."
    import torch
    import chroma_tpu_torch
    from chroma_tpu.likelihood import Likelihood
    from chroma_tpu_torch.ops import visit_kernel

    obs = next(sim.simulate(itertools.islice(likelihood_gun(12), 1),
                            run_daq=True, max_steps=100))
    lk = Likelihood(sim, obs)
    nevals, nreps, ndaq = LIKELIHOOD
    log('phase 8: likelihood, observed event: %d photons, %d channels hit'
        % (obs.nphotons, int(obs.channels.hit.sum())))
    visit_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nll = lk.eval(likelihood_gun(13), nevals, nreps=nreps, ndaq=ndaq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    props = nevals * nreps
    log('  Likelihood.eval: NLL %.3f +- %.3f, wall %.3f s, %.2f '
        'propagations/s of %d photons (%s)' % (
            nll.nominal_value, nll.s, wall, props / wall,
            obs.nphotons, card))
    t0 = time.perf_counter()
    lk.setup_kernel(likelihood_gun(14), nevals, nreps, ndaq,
                    oversample_factor=1)
    knll = lk.eval_kernel(likelihood_gun(15), nevals, nreps=nreps,
                          ndaq=ndaq, navg=2)
    torch.cuda.synchronize()
    kwall = time.perf_counter() - t0
    launches = visit_kernel.launches
    log('  setup_kernel + eval_kernel (navg=2): NLL %.3f +- %.3f, wall '
        '%.3f s, %.2f propagations/s; visit-kernel launches in phase 8: %d'
        % (knll.nominal_value, knll.s, kwall, 3 * props / kwall,
           launches))
    assert np.isfinite(nll.nominal_value) and np.isfinite(knll.nominal_value)
    assert launches > 0

    hitcount, pdf = sim.create_pdf(itertools.islice(likelihood_gun(16), 2),
                                   100, lk.trange, 10, lk.qrange, nreps=1,
                                   ndaq=10)
    assert pdf.sum() == hitcount.sum() > 0
    log('  create_pdf: %d hits binned, pdf.sum() == hitcount.sum()'
        % int(hitcount.sum()))

    gpu = hit_channels_per_readout(
        sim, itertools.islice(likelihood_gun(17), nevals), nreps, ndaq,
        lk.trange)
    cpu_sim = chroma_tpu_torch.Simulation(geo, seed=2, device='cpu',
                                          geometry_arrays=ga)
    t0 = time.perf_counter()
    cpu = hit_channels_per_readout(
        cpu_sim, itertools.islice(likelihood_gun(18), 2), 2, ndaq, lk.trange)
    sigma = np.sqrt(gpu.var(ddof=1) / len(gpu) + cpu.var(ddof=1) / len(cpu))
    diff = abs(gpu.mean() - cpu.mean())
    log('  summed hit probability (channels hit per readout): card %.2f '
        '(%d propagations), CPU %.2f (%d propagations, %.1f s), %.2f sigma'
        % (gpu.mean(), len(gpu), cpu.mean(), len(cpu),
           time.perf_counter() - t0, diff / sigma))
    assert diff <= 5 * sigma
    return launches, lk


def main(argv):
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available: chip_smoke.py needs an '
                           'NVIDIA GPU')
    # the port itself; in a directory without the repository this fails
    import chroma_tpu_torch
    from chroma_tpu_torch.ops import mesh_wide, visit_kernel
    profile = argv[argv.index('--profile') + 1] \
        if '--profile' in argv else None
    device = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- 0. card and software
    card = card_line()
    log('phase 0: card:', card)
    log('  torch %s, CUDA %s, %s, %d device(s)' % (
        torch.__version__, torch.version.cuda,
        torch.cuda.get_device_name(0), torch.cuda.device_count()))

    # --- 1. build
    t0 = time.perf_counter()
    visit_kernel.build()
    log('phase 1: built %s in %.1f s' % (
        os.path.relpath(visit_kernel.SOURCE), time.perf_counter() - t0))
    for line in visit_kernel.build_log.splitlines():
        if 'registers' in line or 'spill' in line:
            log('  ptxas:', line.strip())

    # --- 2. kernel vs plain on the card
    log('phase 2: visit kernel vs plain traversal on the card')
    max_err = 0.0
    for fmt in ('f32', 'bf16', 'q8'):
        table = fixture_table(fmt).to(device)
        max_err = max(max_err, compare_kernel(
            'fixture/' + fmt, table, ray_mix(N_CHECK, 1, None, device)))
    _, tiny = detector_arrays((2000.0, 2500.0, 700.0))
    max_err = max(max_err, compare_kernel(
        'tiny/bf16', tiny.wide.to(device),
        ray_mix(N_CHECK, 2, 1800.0, device)))
    quick_geo, quick = detector_arrays(QUICK)
    quick_wide = quick.wide.to(device)
    max_err = max(max_err, compare_kernel(
        'quick/bf16', quick_wide, ray_mix(N_CHECK, 3, 3600.0, device)))

    # --- 3. propagation steps, card against CPU
    log('phase 3: propagate_step on the card (kernel) vs the CPU (plain)')
    compare_steps(quick, device, N_CHECK, 3)

    # --- 4. times at 2^20 rays: the first step's query of the bomb
    rs = np.random.RandomState(4)
    d = rs.randn(N_TIME, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o_t = torch.zeros((N_TIME, 3), dtype=torch.float32, device=device)
    d_t = torch.from_numpy(d.astype(np.float32)).to(device)
    ms, k_all = time_cuda(lambda: visit_kernel.traverse(quick_wide, o_t,
                                                        d_t))
    plain_ms, p_all = time_cuda(lambda: mesh_wide.traverse(quick_wide, o_t,
                                                           d_t))
    visits = visit_kernel.traverse(quick_wide, o_t, d_t)[5].float()
    log('phase 4: %d rays from the centre, quick detector, %s: kernel '
        '%.3f ms (runs %s), plain %.3f ms (runs %s), mean visits %.2f; '
        '%.1f Mrays/s' % (N_TIME, card, ms, ['%.3f' % x for x in k_all],
                          plain_ms, ['%.3f' % x for x in p_all],
                          float(visits.mean()), N_TIME / ms / 1e3))

    # --- 5. the main path
    log('phase 5: Simulation(quick detector, device=cuda), %d photons, '
        'run_daq=True' % N_BOMB)
    sim = chroma_tpu_torch.Simulation(quick_geo, seed=0, device='cuda',
                                      geometry_arrays=quick)
    torch.cuda.reset_peak_memory_stats()
    ev, wall, aborts, launches = run_main_path(sim, N_BOMB, 5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    hits = ev.flat_hits
    nhit_ch = int(ev.channels.hit.sum())
    log('  wall %.3f s, %.0f photons/s, detected %d, channels hit %d of '
        '%d, NaN aborts %d, visit-kernel launches %d, peak device memory '
        '%.0f MiB (%s)' % (wall, N_BOMB / wall, len(hits), nhit_ch,
                           len(ev.channels.hit), aborts, launches, peak,
                           card))
    assert launches > 0, 'the main path launched no visit kernel'
    assert len(hits) > 0 and aborts == 0
    assert len(ev.photons_end) == N_BOMB
    for name in ('pos', 'dir', 't'):
        assert np.isfinite(getattr(hits, name)).all(), name
    assert np.isfinite(ev.channels.t[ev.channels.hit]).all()
    assert nhit_ch == len(ev.hits) and (hits.flags & 4).all()

    # the same path on the CPU (plain traversal) at 65,536 photons
    cpu_sim = chroma_tpu_torch.Simulation(quick_geo, seed=1, device='cpu',
                                          geometry_arrays=quick)
    cev, cwall, caborts, _ = run_main_path(cpu_sim, N_CHECK, 6)
    assert caborts == 0
    log('  CPU reference: %d photons in %.1f s, detected %d' % (
        N_CHECK, cwall, len(cev.flat_hits)))
    detected_fraction_check(len(hits) / N_BOMB, N_BOMB,
                            len(cev.flat_hits) / N_CHECK, N_CHECK,
                            'detected fraction, card vs CPU')

    # --- 6.-8. the full optics, wire planes and the likelihood path
    geo6, ga6, sim6, launches6, _ = phase_quick_optics(device, card)
    launches7, _ = phase_lartpc(device, card)
    launches8, lk = phase_likelihood(geo6, ga6, sim6, card)

    if profile:
        profile_run('quick', lambda: run_main_path(sim, N_BOMB, 7), card,
                    profile)
        profile_run('quick-optics', lambda: run_main_path(sim6, N_BOMB, 7),
                    card, profile)
        nevals, nreps, ndaq = LIKELIHOOD
        profile_run('likelihood eval', lambda: lk.eval(
            likelihood_gun(19), nevals, nreps=nreps, ndaq=ndaq), card,
            profile)
    per_phase = {'5 quick': launches, '6 quick-optics': launches6,
                 '7 lartpc-wires': launches7, '8 likelihood': launches8}
    log('visit-kernel launches per main path: %s' % json.dumps(per_phase))

    log(json.dumps({'kernels': [{
        'name': 'visit_inst',
        'route': 'cuda',
        'source': 'chroma_tpu_torch/csrc/visit_kernel.cu',
        'replaces': 'chroma_tpu/ops/visit_kernel.py:109',
        'launches': sum(per_phase.values()),
        'max_abs_err': max_err,
        'ms': ms,
        'plain_ms': plain_ms,
    }]}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


def profile_run(label, fn, card, path):
    """Device time by kernel over one run of fn() (torch.profiler); the
    full table is appended to `path`. Logs wall, device busy time, the
    visit kernel's share and the device's idle share."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    table = prof.key_averages().table(sort_by='cuda_time_total',
                                      row_limit=40)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'a') as fh:
        fh.write('== %s\n%s\nwall %.3f s (profiled)\n%s\n' % (
            label, card, wall, table))
    # device-side rows only (kernels, copies): the aten rows repeat them
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e6
    visit = sum(e.self_device_time_total for e in events
                if 'visit_inst_kernel' in e.key) / 1e6
    cpu_ops = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.key.startswith('aten::'))
    log('profile %s: wall %.3f s profiled, device busy %.3f s (idle %.1f%%)'
        ', visit kernel %.3f s (%.1f%% of device time), %d aten ops; top '
        'rows:' % (label, wall, total, 100.0 * (1 - total / wall), visit,
                   100.0 * visit / max(total, 1e-9), cpu_ops))
    for line in table.splitlines()[:12]:
        log('  ' + line)

if __name__ == '__main__':
    main(sys.argv[1:])
