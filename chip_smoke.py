#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (chroma_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # from the repository root
    python3 chip_smoke.py --profile FILE   # also profile the main path,
                                          # full table to FILE

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
     detected fraction is checked against a 65,536-photon run on the CPU.

The last lines are a JSON object describing the kernels, and
{"ok": true, "device": {...}}. Needs CUDA and the repository checkout.
"""
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


def run_simulation(sim, n, seed):
    import torch
    from chroma_tpu.generator import photon_bomb
    from chroma_tpu import event
    np.random.seed(seed)
    bomb = photon_bomb(n, 400.0, (0, 0, 0))
    if sim.device.type == 'cuda':
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = next(sim.simulate([bomb], run_daq=True, max_steps=100,
                           keep_photons_end=True))
    if sim.device.type == 'cuda':
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flags = ev.photons_end.flags
    aborts = int(((flags & event.NAN_ABORT) != 0).sum())
    return ev, wall, aborts


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
    visit_kernel.launches = 0
    ev, wall, aborts = run_simulation(sim, N_BOMB, 5)
    launches = visit_kernel.launches
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
    cev, cwall, caborts = run_simulation(cpu_sim, N_CHECK, 6)
    assert caborts == 0
    log('  CPU reference: %d photons in %.1f s, detected %d' % (
        N_CHECK, cwall, len(cev.flat_hits)))
    detected_fraction_check(len(hits) / N_BOMB, N_BOMB,
                            len(cev.flat_hits) / N_CHECK, N_CHECK,
                            'detected fraction, card vs CPU')

    if profile:
        profile_main_path(sim, card, profile)

    log(json.dumps({'kernels': [{
        'name': 'visit_inst',
        'route': 'cuda',
        'source': 'chroma_tpu_torch/csrc/visit_kernel.cu',
        'replaces': 'chroma_tpu/ops/visit_kernel.py:109',
        'launches': launches,
        'max_abs_err': max_err,
        'ms': ms,
        'plain_ms': plain_ms,
    }]}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


def profile_main_path(sim, card, path):
    """Device time by kernel over one more main-path run (torch.profiler);
    the full table goes to `path`."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev, wall, _ = run_simulation(sim, N_BOMB, 7)
    table = prof.key_averages().table(sort_by='cuda_time_total',
                                      row_limit=40)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'w') as fh:
        fh.write('%s\nwall %.3f s (profiled)\n%s\n' % (card, wall, table))
    # device-side rows only (kernels, copies): the aten rows repeat them
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events)
    visit = sum(e.self_device_time_total for e in events
                if 'visit_inst_kernel' in e.key)
    log('profile: wall %.3f s profiled, device time %.3f s, visit kernel '
        '%.3f s (%.1f%%); top rows:' % (
            wall, total / 1e6, visit / 1e6, 100.0 * visit / max(total, 1)))
    for line in table.splitlines()[:14]:
        log('  ' + line)


if __name__ == '__main__':
    main(sys.argv[1:])
