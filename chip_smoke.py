#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (chroma_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # from the repository root
    python3 chip_smoke.py --out DIR        # keep phase 10's PNG frames in
                                          # DIR (else they go with the
                                          # scratch files)

Phases, each printing its results; any failure raises and the exit code is
non-zero:

  0. card and software (nvidia-smi name and power limit, torch, CUDA);
  1. build, all at once, into build/: the four kernels with nvcc -- K1,
     the visit kernel (chroma_tpu_torch/csrc/visit_kernel.cu), K2, the
     step around the query (csrc/step_kernel.cu: k2_pre and k2_post), K3,
     the wire walk (csrc/wire_walk.cu), K4, the DAQ readout
     (csrc/daq_kernel.cu) -- and the host geometry kit
     (chroma_tpu_torch/csrc/geometry_kit.cpp) with g++; print ptxas's
     registers and spills for each kernel;
  2. the kernel against its plain PyTorch version on the card, on 10^4
     rays (a grid of one group a ray) and on 2^18 (persistent groups),
     on the visit-kernel fixture geometry, on demo.tiny() and on the quick
     demo detector, each in f32 bounds at fanout 16 and bf16 and q8 bounds
     at fanout 32: triangles, instance ids, codes and visit counts equal,
     distances and normals to rtol 1e-5;
  3. three propagation steps of 65,536 quick-detector photons on the card
     (kernel) and on the CPU (plain version) with the same uniforms: on
     >= 99.9% of lanes flags, last-hit triangles and media equal and
     floats to rtol 1e-5 (absolute floor: 1e-5 of the field's scale);
  4. K1's times at 2^20 and at 10^4 rays from the centre of the quick
     detector (CUDA events, median of runs taken in turns; at 10^4 rays
     also as a launch of a 20-launch CUDA graph, which leaves the host's
     dispatch out): the warp-cooperative walk the port runs and the plain
     version, the walk held to the plain version's outputs, with the
     visits by node kind and the rows visited and the bound they give;
     then the two launch choices `traverse` makes (16 or 32 lanes a ray;
     a grid of one group a ray or persistent groups) at the ray counts a
     bomb's compacted steps launch;
  5. the main path: Simulation(quick detector, device='cuda') on a 2^20
     photon bomb with run_daq=True, counting the kernel's launches and the
     rays of each; its detected fraction is checked against a 65,536-photon run on the CPU;
  6. full optics ("quick-optics"): the quick detector rebuilt with every
     surface model -- thin-film complex photocathodes, angular light
     cones, dichroic PMT backs, a wavelength-shifting outer sphere -- in
     water with one bulk-reemission component: three steps card vs CPU as
     in phase 3, then the 2^20-photon Simulation with each model's flag bit
     counted (each must be non-zero) and its detected fraction against a
     65,536-photon CPU run;
  7. wire planes ("lartpc-wires"): three absorbing U/V/Y anode planes in a
     2 m liquid-argon box; intersect_wireplanes card (K3) vs CPU on
     65,536 rays (hits equal, distances to rtol 1e-5); the first step of
     the 2^20-photon bomb (ms, cold and warm); then 2^20-photon
     Simulations on the graph route (probe, then tuned bombs, captures
     and replays > 0, K3 launched every step) in turns with the chunked
     driver, with the share of photons absorbed on wires and the
     candidate-wire iterations per plane;
  8. likelihood: a 10 MeV electron's ~10^4 photons in the quick-optics
     detector as the observed event; Likelihood.eval (nreps=4, ndaq=50,
     nevals=4), setup_kernel and eval_kernel (navg=2), create_pdf; the
     summed hit probability is checked against a CPU run;
  9. the user entry points on the quick detector (built in phase 2 through
     loader.create_geometry_from_obj, auto_build_bvh=False):
     a. the geocache: its GeometryArrays saved and loaded back (lean) onto
        the card, every field equal to the build, save and load timed;
     b. a device-resident source: a 2^20-photon bomb made on the card with
        an explicit torch.Generator through Simulation(gpu_geometry=the
        loaded arrays), run_daq and keep_photons_end, no host Photons
        built before propagation, the detected fraction against phase 5's,
        and the profiler's regions and counters of the run;
     c. the facade: GPUPhotons(the same state).propagate(GPUGeometry) and
        GPUDaq.acquire with the same seed, flags and channels equal 9b's;
     d. tracking: Simulation(photon_tracking=True) on 10^4 photons, each
        track at most max_steps + 1 points, its first point on the start's
        ray, its last point the photon's end state; timed against the same
        photons untracked;
     e. the command-line tools: chroma_tpu_torch.cli.sim (2 events of 2^20
        photons on demo.tiny() with --daq, read back with EventReader) and
        chroma_tpu_torch.cli.profile, each as a subprocess;
 10. the renderer and the viewer on the quick detector's dense arrays:
     a. K1 on camera rays: the 1920 x 1080 rays of the default pose, first
        layer (no mask) and third layer (last hits excluded, rays still
        active), kernel against plain, all six outputs; K1 and the plain
        version timed on the first layer, with visits by kind and bound;
     b. ops.render.render and distances, card against CPU, 256 x 144 rays
        of the same pose (the frames' field of view) at alpha_depth 10: at
        least 99.9% of the pixels equal, every channel within 1 count,
        distances to rtol 1e-5;
     c. frames at full width: camera.snapshot, then 5 frames of the same
        rays turned by Rays.rotate_around_point, wall per frame, K1
        launches per frame, the share of pixels that show geometry (held
        to the CPU render's within 2%), one frame written as a PNG;
     d. the viewer's modes, no display, through Camera._frame and
        EventViewer: anaglyph, BVH layer 1 of demo.tiny(), a frame
        recolored by phase 5's channels, the track overlay of a
        10^4-photon tracked event, GPURays against Rays, and the photon
        map (4 batches of 100,000 photons at 640 x 480): once through the
        quick detector from its centre, for the launches and the wall, and
        once in a matte room, for a lit image -- hybrid_render lights a
        pixel when the first triangle its ray meets holds a parked photon,
        and a PMT's first surface is its glass, which parks none;
     e. the tools: chroma_tpu_torch.cli.cam -o as a subprocess on
        demo.tiny(), and chroma_tpu_torch.cli.bvh create, stat and sort;
     f. GDML: a document with a boolean solid through GDMLLoader as a
        Detector, a 65,536-photon bomb with run_daq=True and one frame.
 11. photon sharding (chroma_tpu_torch.parallel) through run_ranks: two
     gloo ranks sharing the card (and NCCL with one rank a card where there
     are several), each lean-loading 9a's geocache: Simulation(n_devices=k)
     on phase 5's bomb, its detected fraction against phase 5's, the same
     channels on every rank; propagate_and_daq_sharded's reduced readout
     against a single-process emulation, bit for bit; two calls with one
     seed equal; every rank's K1 launches; the wall against phase 5's.
 12. the fused bomb, the default route of ops.propagate since phases 5-11
     took it (each stage's step a CUDA graph with K1, K2 and, on wire
     planes, K3 inside, after the first step at its width, which runs
     eagerly):
     a. the tuner's cost model on this card: graph-replayed quick-detector
        steps from 2^11 to 2^20 lanes (and the host's ms to enqueue each)
        and the boundaries between stages, fitted to lines, printed as
        ops.propagate's three constants; the step prologue's aten ops,
        device kernels (at most n_blocks + 1) and ms, as the card runs it
        (the uniform blocks and k2_pre) and as its plain twin;
     b. 65,536-photon fused bombs on the quick detector and on
        lartpc-wires with every step eager and with graph replays, same
        seed: every field equal bit for bit;
     c. the quick detector's phase-5 bomb through new Simulations: a probe
        (fresh schedule caches), then tuned and chunked (CHROMA_FUSED=0)
        bombs in turns, each with its wall, schedule, captures and capture
        seconds, replays, K1 launches (= replays + captures: one a step),
        blocking reads (at most one a boundary plus one) and its detected
        fraction against phase 5's CPU run;
     d. quick-optics' bomb and e. Likelihood.eval (nevals 1) on both
        routes in turns.
 13. K2 and K3 against their plain twins on the card: on 2^20 lanes
     (after two steps) of the quick detector, quick-optics (plain,
     use_weights, scatter_first 1 and -1) and lartpc-wires, k2_pre
     against step_prologue (flags, active and pruned lanes equal, limits
     to rtol 1e-5, the lanes that differ counted) and k2_post against its
     twin on the step's inputs (k2_pre, K1, K3): integer fields and floats
     to rtol 1e-5 on all but at most 0.1% of the lanes (printed), at 2^20
     and at an odd width; K3 on the 2^20 rays of phase 7's bomb: planes
     and floats equal to its twin's. Each timed in turns at the main
     paths' widths (2^11 to 2^20) as a launch of a 20-launch CUDA graph:
     k2_post at 64, 128 and 256 lanes a block, through its wrapper and
     its twin; k2_pre and its twin; K3, its wrapper (its twin at 2^20
     only), each with its bound. Then what each main path loses to each
     kernel against its bound: its steps by width times (time - bound).
 14. K4, the DAQ readout, against its plain twin on the card at the
     likelihood's 50 replicas of 10^4 photons and the bomb's one of 2^22
     (phase 5's end states): equal bit for bit, and run_daq's generator
     path equal to the twin fed the old per-block torch.rand draws; the readout timed as a launch of a
     20-launch graph, the twin and the whole run_daq eagerly, beside its
     bound (the bytes it must move, in 32-byte sectors: every photon's
     last triangle and flags, a detected photon's time and weight, a
     detected pair's keep draw, a kept pair's two other draws, the
     channels written); K4's launches and run_daq's calls, counted from
     0, equal on a Likelihood.eval of 4 x 16 x 50 (64) and on a bomb (1).

The kernels' launches (k1, k2_pre, k2_post, k3, k4 in
ops.cuda_build.launches) are counted on each main path (phases 5 to 12,
set to 0 just before and read just after; a graph replay adds the
launches its capture holds) and printed per phase. The last
lines are a JSON object describing the kernels, and {"ok": true,
"device": {...}}. Needs CUDA and the repository checkout.
"""
import collections
import contextlib
import io
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_CHECK = 65536
N_TIME = 1 << 20
N_SMALL = 10000     # rays of one likelihood-path query (phase 8)
N_BOMB = 1 << 20
QUICK = (4000.0, 4500.0, 400.0)     # demo.detector args of the quick cell
RTOL = 1e-5
GUN_MEV = 10.0      # phase 8's electron: ~10^4 photons (1000 per MeV)
LIKELIHOOD = (4, 4, 50)             # phase 8's nevals, nreps, ndaq
N_TRACK = 10000     # phase 9d's tracked photons
MAX_STEPS = 100     # steps of every bomb, as in bench.py
RENDER_SIZE = (1920, 1080)          # phase 10's frames
CHECK_SIZE = (256, 144)             # phase 10b's card-against-CPU render:
                                    # the frames' field of view
VIEWER_SIZE = (640, 480)            # phase 10d's frames
ALPHA_DEPTH = 10
N_FRAMES = 5
CLI_CAM_SIZE = (800, 600)
# (packed_fanout, bounds_fmt) of each table format: f32 at fanout 16, bf16
# and q8 at fanout 32
FORMATS = {'f32': (0, 'f32'), 'bf16': (32, 'bf16'), 'q8': (32, 'q8')}
# phase 4's ray counts for the launch choices: the powers of two a bomb's
# compacted steps launch, and a likelihood query's N_SMALL
SWEEP = sorted([1 << k for k in range(13, 21)] + [N_SMALL])
# published peaks of one H100 SXM at 700 W: device memory, f32 outside the
# tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# phase 14's readouts (replicas, photons): the likelihood's, the bomb's
DAQ_SHAPES = ((50, 10000), (1, 1 << 22))


def log(*args):
    print(*args, flush=True)


def zero_launches():
    """Set every kernel's launch count (ops.cuda_build.launches: k1,
    k2_pre, k2_post, k3, k4) to 0."""
    from chroma_tpu_torch.ops import cuda_build
    cuda_build.launches.clear()


def launches_now():
    "Each kernel's launches since zero_launches(): a Counter."
    from chroma_tpu_torch.ops import cuda_build
    return cuda_build.launches.copy()


def total_launches(counters):
    "The sum of launch Counters."
    return sum(counters, collections.Counter())


def launch_list(launches):
    "[k1, k2_pre, k2_post, k3, k4] of a launch Counter."
    return [launches[k] for k in ('k1', 'k2_pre', 'k2_post', 'k3', 'k4')]


def card_line():
    proc = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def table_of(geo, fmt):
    """The instanced table of flattened geometry `geo` in bounds format
    `fmt` (FORMATS), built as build_geometry_arrays builds it."""
    from chroma_tpu_torch.bvh.wide import build_instanced_bvh
    from chroma_tpu_torch.ops.types import pack_material_codes
    codes = pack_material_codes(geo.material1_index, geo.material2_index,
                                geo.surface_index)
    tri_base = np.cumsum([0] + [len(s.mesh.triangles) for s in geo.solids])
    instances = [(s.mesh, geo.solid_rotations[i], geo.solid_displacements[i],
                  int(tri_base[i])) for i, s in enumerate(geo.solids)]
    packed, bounds = FORMATS[fmt]
    return build_instanced_bvh(instances, material_codes=codes,
                               packed_fanout=packed, bounds_fmt=bounds)


def fixture_table(fmt):
    "The tests/test_visit_kernel.py fixture geometry as a port table."
    from chroma_tpu_torch.geometry import Geometry, Solid
    from chroma_tpu_torch.demo.optics import water, glass
    from chroma_tpu_torch.make import box, sphere
    geo = Geometry(water)
    geo.add_solid(Solid(box(100.0, 80.0, 60.0), glass, water))
    geo.add_solid(Solid(sphere(30.0, nsteps=24), glass, water),
                  displacement=(120.0, 0.0, 0.0))
    geo.add_solid(Solid(box(40.0, 40.0, 40.0), glass, water),
                  displacement=(-120.0, 30.0, 0.0))
    geo.flatten()
    return table_of(geo, fmt)


def detector_tables(geo, ga, device):
    """geo's table in each bounds format on `device`; bf16 is the one
    build_geometry_arrays made (ga.wide), which the main path runs."""
    assert ga.wide.bounds_fmt == 'bf16' and ga.wide.fanout == 32
    return {fmt: (ga.wide if fmt == 'bf16' else table_of(geo, fmt)).to(
        device) for fmt in FORMATS}


def detector_arrays(args, cache_dir):
    """demo.detector(*args) through the loader (no classic BVH, as bench.py
    builds it; its cache in cache_dir) and its GeometryArrays."""
    from chroma_tpu_torch import demo
    from chroma_tpu_torch.loader import create_geometry_from_obj
    from chroma_tpu_torch.ops.types import build_geometry_arrays
    t0 = time.perf_counter()
    geo = create_geometry_from_obj(lambda: demo.detector(*args),
                                   auto_build_bvh=False, cache_dir=cache_dir)
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


def assert_same(name, got, ref):
    """Kernel outputs `got` against the plain version's `ref` (numpy):
    triangles, codes, instance ids and visits equal, distances and normals
    of hits to RTOL. Returns the largest absolute distance/normal
    difference on hits."""
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
    return max(float(np.abs(got[1][hit] - dist[hit]).max(initial=0.0)),
               float(np.abs(got[3][hit] - normal[hit]).max(initial=0.0)))


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
    err = assert_same(name, got, ref)
    tri, visits = ref[0], ref[5]
    log('  %-22s %6d rays (%s): %5.1f%% hit, mean visits %.2f, max %d, '
        'equal (max |diff| %.3g)' % (
            name, len(tri), 'persistent' if len(tri)
            >= visit_kernel.PERSISTENT_MIN_RAYS else 'grid',
            100.0 * (tri >= 0).mean(), visits.mean(), visits.max(), err))
    return err


def compare_steps(ga, device, n, nsteps):
    """`nsteps` propagation steps on the card and on the CPU with the same
    injected uniforms; >= 99.9% of the lanes must agree."""
    import torch
    from chroma_tpu_torch.generator import photon_bomb
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


def time_turns(fns, rounds=6):
    """Milliseconds of each fns[name]() by CUDA events, all run in turns
    (forward order, then backward, `rounds` times) after one warm-up run
    each: (medians by name, all runs by name)."""
    import torch
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    runs = {name: [] for name in fns}
    order = list(fns)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            end.synchronize()
            runs[name].append(start.elapsed_time(end))
    return {name: float(np.median(v)) for name, v in runs.items()}, runs


def k1_bound(table, n, kinds, rows_seen):
    """The least time (ms) an H100 at 700 W could take for one K1 query of
    n rays (origin and direction only) on `table` whose walk makes `kinds`
    = (internal, leaf, instance) visits to `rows_seen` distinct rows: the
    larger of its bytes (each row visited read once, 24 bytes in and 32
    out a ray) over PEAK_BYTES_S and its f32
    operations over PEAK_F32_S. Operations, counted from the plain
    version's arithmetic (csrc/visit_kernel.cu's note): a sweep of an
    internal or instance row 12 + 25 a child (q8: 21 + 32), an instance
    entry 33 more, a leaf 55 a triangle slot. Returns (bound ms, 'bytes' or
    'operations', operations, bytes)."""
    from chroma_tpu_torch.bvh.wide import fmt_of
    width = table.rows.shape[1]
    q8 = fmt_of(table) == 'q8'
    sweep = (21 if q8 else 12) + (32 if q8 else 25) * table.fanout
    v_int, v_leaf, v_inst = (int(k) for k in kinds)
    ops = v_int * sweep + v_inst * (33 + sweep) \
        + v_leaf * 55 * table.leaf_size
    nbytes = 4 * rows_seen * width + n * (24 + 32)
    t_ops = ops / PEAK_F32_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes
            else 'bytes', ops, nbytes)


def ptxas_summary(text):
    "'N kernels, registers lo-hi, spill stores up to B bytes' of nvcc -v."
    regs = [int(x) for x in re.findall(r'Used (\d+) registers', text)]
    spills = [int(x) for x in re.findall(r'(\d+) bytes spill stores', text)]
    if not regs:
        return 'no ptxas report (library from an earlier build)'
    return '%d kernels, registers %d-%d, spill stores up to %d bytes' % (
        len(regs), min(regs), max(regs), max(spills, default=0))


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
    from chroma_tpu_torch import event
    return {name: int(((flags & getattr(event, name)) != 0).sum())
            for name in FLAG_BITS}


def quick_optics_detector():
    """demo.detector(4000, 4500, 400)'s placement (630 PMTs) rebuilt with
    chroma_tpu_torch.pmt's public functions, with every surface model and
    bulk reemission:

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
    from chroma_tpu_torch import demo
    from chroma_tpu_torch.demo import optics
    from chroma_tpu_torch.detector import Detector
    from chroma_tpu_torch.geometry import (
        Material, Solid, Surface, DichroicProps, AngularProps,
        SURFACE_COMPLEX, SURFACE_WLS, SURFACE_DICHROIC, SURFACE_ANGULAR,
        standard_wavelengths, standard_times)
    from chroma_tpu_torch.make import sphere
    from chroma_tpu_torch.pmt import (build_pmt,
                                      build_light_collector_from_file)
    from chroma_tpu_torch.transform import make_rotation_matrix, normalize
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
    from chroma_tpu_torch.geometry import (Geometry, Material, Solid,
                                           Surface, WirePlane, vacuum)
    from chroma_tpu_torch.make import box
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


@contextlib.contextmanager
def launch_rays():
    """Within the block, the rays of each visit-kernel query made through
    visit_kernel.traverse and run (not only recorded by a graph capture),
    in a Counter (rays -> queries)."""
    import torch
    from chroma_tpu_torch.ops import visit_kernel
    sizes = collections.Counter()
    traverse = visit_kernel.traverse

    def counted(inst, origin, *args, **kwargs):
        # a step graph's capture only records its query
        if not (origin.is_cuda and torch.cuda.is_current_stream_capturing()):
            sizes[int(origin.shape[0])] += 1
        return traverse(inst, origin, *args, **kwargs)
    visit_kernel.traverse = counted
    try:
        yield sizes
    finally:
        visit_kernel.traverse = traverse


def graph_cache(geometry):
    "The step graphs captured on `geometry`, by key (ops.graphs)."
    from chroma_tpu_torch.ops import graphs
    ent = graphs._GRAPHS.get(id(geometry))
    return ent[1] if ent is not None and ent[0]() is geometry else {}


@contextlib.contextmanager
def path_widths(geometry):
    """Within the block, the widths of the steps run on `geometry`: the
    rays of each eager visit-kernel query (launch_rays) and of each graph
    replay (counted by wrapping StepGraph.replay). Yields a dict that
    holds, after the block, 'eager' and 'replayed' Counters (lanes ->
    steps) and 'all', their sum."""
    from chroma_tpu_torch.ops import graphs
    replayed = collections.Counter()
    replay = graphs.StepGraph.replay

    def counted(graph, *seed):
        replayed[len(graph.state)] += 1
        return replay(graph, *seed)
    graphs.StepGraph.replay = counted
    out = {}
    try:
        with launch_rays() as sizes:
            yield out
    finally:
        graphs.StepGraph.replay = replay
    out.update(eager=sizes, replayed=replayed, all=sizes + replayed)


def run_main_path(sim, n, seed, pos=(0, 0, 0), run_daq=True):
    """A bomb of n 400 nm photons from `pos` through sim.simulate, with
    the kernels' launches counted from 0 and the rays of each query
    logged: returns (event, wall s, NaN aborts, launches, the steps by
    lanes (path_widths' 'all'))."""
    import torch
    from chroma_tpu_torch.generator import photon_bomb
    from chroma_tpu_torch import event
    np.random.seed(seed)
    bomb = photon_bomb(n, 400.0, pos)
    if sim.device.type == 'cuda':
        torch.cuda.synchronize()
    zero_launches()
    with path_widths(sim.gpu_geometry) as widths:
        t0 = time.perf_counter()
        ev = next(sim.simulate([bomb], run_daq=run_daq, max_steps=100,
                               keep_photons_end=True))
        if sim.device.type == 'cuda':
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launches_now()
    log('  visit-kernel queries by rays, eager: %s; in graph replays: %s'
        % tuple(', '.join('%d x %d' % (k, c[k])
                          for k in sorted(c, reverse=True)) or 'none'
                for c in (widths['eager'], widths['replayed'])))
    aborts = int(((ev.photons_end.flags & event.NAN_ABORT) != 0).sum())
    return ev, wall, aborts, launches, widths['all']


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
    ev, wall, aborts, launches, _ = run_main_path(sim, N_BOMB, 8)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    counts = flag_counts(ev.photons_end.flags)
    log('  Simulation: wall %.3f s, %.0f photons/s, detected %d, channels '
        'hit %d of %d, NaN aborts %d, visit-kernel launches %d, peak device '
        'memory %.0f MiB (%s)' % (
            wall, N_BOMB / wall, len(ev.flat_hits),
            int(ev.channels.hit.sum()), len(ev.channels.hit), aborts,
            launches['k1'], peak, card))
    log('  flag bits: %s; bulk reemission share %.4f' % (
        json.dumps(counts), counts['BULK_REEMIT'] / N_BOMB))
    assert launches['k1'] > 0 and aborts == 0
    for name in ('SURFACE_DETECT', 'SURFACE_REEMIT', 'SURFACE_TRANSMIT',
                 'BULK_REEMIT', 'REFLECT_DIFFUSE', 'REFLECT_SPECULAR'):
        assert counts[name] > 0, name
    assert np.isfinite(ev.flat_hits.t).all()
    assert np.isfinite(ev.channels.t[ev.channels.hit]).all()

    cpu_sim = chroma_tpu_torch.Simulation(geo, seed=1, device='cpu',
                                          geometry_arrays=ga)
    cev, cwall, caborts, _, _ = run_main_path(cpu_sim, N_CHECK, 9)
    assert caborts == 0
    log('  CPU reference: %d photons in %.1f s, detected %d' % (
        N_CHECK, cwall, len(cev.flat_hits)))
    detected_fraction_check(len(ev.flat_hits) / N_BOMB, N_BOMB,
                            len(cev.flat_hits) / N_CHECK, N_CHECK,
                            'quick-optics detected fraction, card vs CPU')
    return geo, ga, sim, launches, wall


def phase_lartpc(device, card):
    """Phase 7: analytic wire planes, card against CPU; the first step of
    the 2^20-photon bomb (its ms, cold and warm); and the bomb on the
    declared route (the fused driver, each stage's step a CUDA graph with
    K1, K3 and K2 in it: the probe, then tuned bombs) in turns with the
    chunked driver. Returns (launches by path, a row a bomb, the
    geometry's arrays)."""
    import torch
    import chroma_tpu_torch
    from chroma_tpu_torch import event
    from chroma_tpu_torch.ops import propagate as P
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
    from chroma_tpu_torch.generator import photon_bomb
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
    first_ms = first_step_ms(g, bomb, device)
    log('  the first step of the bomb (%d lanes, eager: prologue, K1, K3, '
        'K2), ms: cold %.3f, warm %.3f (%s)' % (N_BOMB, *first_ms, card))
    # the probe bomb on the declared route, then tuned and chunked bombs
    # of the same photons in turns
    rows = []
    for i, route in enumerate(('fused', 'fused', 'chunked', 'fused',
                               'chunked')):
        os.environ['CHROMA_FUSED'] = '1' if route == 'fused' else '0'
        try:
            sched = P.schedule_for(g, N_BOMB, MAX_STEPS)
            kind = route if route == 'chunked' else (
                'probe' if P._sched_lookup(g, N_BOMB, MAX_STEPS) is None
                else 'tuned')
            torch.cuda.reset_peak_memory_stats()
            fused_counters()
            ev, wall, aborts, launches, widths = run_main_path(
                sim, N_BOMB, 11, pos=source, run_daq=False)
            stats = fused_stats()
        finally:
            os.environ.pop('CHROMA_FUSED')
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        pe = ev.photons_end
        on_wire = (pe.last_hit_triangles == -2) \
            & ((pe.flags & event.SURFACE_ABSORB) != 0)
        log('  %s bomb: wall %.3f s, %.0f photons/s, absorbed on wires %d '
            '(%.4f), NaN aborts %d, visit-kernel launches %d, peak device '
            'memory %.0f MiB (%s)' % (kind, wall, N_BOMB / wall,
                                      int(on_wire.sum()), on_wire.mean(),
                                      aborts, launches['k1'], peak, card))
        if i == 0:
            log('  flag bits: %s' % json.dumps(flag_counts(pe.flags)))
        assert launches['k1'] > 0 and aborts == 0 and on_wire.sum() > 0
        assert np.isfinite(pe.pos).all()
        row = dict(kind=kind, wall_s=wall, on_wire=float(on_wire.mean()),
                   widths={str(k): c for k, c in widths.items()},
                   **stats)
        if route == 'fused':
            # the declared route: the fused driver, its steps graphs
            check_fused(stats, sched)
            assert stats['launches']['k3'] == stats['launches']['k1'], stats
            row['schedule'] = sched
        else:
            detected_fraction_check(row['on_wire'], N_BOMB,
                                    rows[0]['on_wire'], N_BOMB,
                                    'absorbed on wires, chunked vs probe')
        if kind == 'tuned':
            detected_fraction_check(row['on_wire'], N_BOMB,
                                    rows[0]['on_wire'], N_BOMB,
                                    'absorbed on wires, tuned vs probe')
        rows.append(row)
    fused = [r for r in rows if r['kind'] != 'chunked']
    assert sum(r['captures'] for r in fused) > 0
    assert sum(r['replays'] for r in fused) > 0
    log('  route: fused driver, graph replays (K1, K3, K2 a step); by bomb, '
        'in turns: %s' % json.dumps(rows))
    log('  lartpc-wires wall: probe %.3f s, tuned %s s, chunked %s s; '
        'captures %d, replays %d on the fused bombs; first step %.3f ms '
        'cold, %.3f warm' % (
            rows[0]['wall_s'],
            ['%.3f' % r['wall_s'] for r in rows if r['kind'] == 'tuned'],
            ['%.3f' % r['wall_s'] for r in rows if r['kind'] == 'chunked'],
            sum(r['captures'] for r in fused),
            sum(r['replays'] for r in fused), *first_ms))
    rows.append(dict(kind='first step', cold_ms=first_ms[0],
                     warm_ms=first_ms[1]))
    launches = {'7 lartpc-wires': rows[0]['launches'],
                '7 lartpc-wires tuned': total_launches(
                    r['launches'] for r in rows if r['kind'] == 'tuned'),
                '7 lartpc-wires chunked': total_launches(
                    r['launches'] for r in rows if r['kind'] == 'chunked')}
    return launches, rows, ga


def first_step_ms(geometry, bomb, device):
    """Milliseconds of one eager propagate_step of host photons `bomb` on
    the card, the first at its width (cold) and a second one (warm)."""
    import torch
    from chroma_tpu_torch.ops.photon import propagate_step
    from chroma_tpu_torch.ops.propagate import photon_state_from_host
    from chroma_tpu_torch.ops.sample import DrawPool, make_generator
    state = photon_state_from_host(bomb, device)
    out = []
    for seed in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        propagate_step(state, geometry, DrawPool(
            len(state), device, generator=make_generator(device, seed)))
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


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
    from chroma_tpu_torch.generator import (constant_particle_gun,
                                            vertex_gun_to_events)
    np.random.seed(seed)
    return vertex_gun_to_events(constant_particle_gun(
        'e-', (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), GUN_MEV))


def phase_likelihood(geo, ga, sim, card):
    "Phase 8: the hybrid-MC likelihood path on the quick-optics detector."
    import torch
    import chroma_tpu_torch
    from chroma_tpu_torch.likelihood import Likelihood

    obs = next(sim.simulate(itertools.islice(likelihood_gun(12), 1),
                            run_daq=True, max_steps=100))
    lk = Likelihood(sim, obs)
    nevals, nreps, ndaq = LIKELIHOOD
    log('phase 8: likelihood, observed event: %d photons, %d channels hit'
        % (obs.nphotons, int(obs.channels.hit.sum())))
    zero_launches()
    torch.cuda.synchronize()
    with path_widths(sim.gpu_geometry) as widths:
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
    launches = launches_now()
    log('  setup_kernel + eval_kernel (navg=2): NLL %.3f +- %.3f, wall '
        '%.3f s, %.2f propagations/s; visit-kernel launches in phase 8: %d'
        '; Likelihood.eval\'s steps by lanes %s' % (
            knll.nominal_value, knll.s, kwall, 3 * props / kwall,
            launches['k1'], dict(sorted(widths['all'].items()))))
    assert np.isfinite(nll.nominal_value) and np.isfinite(knll.nominal_value)
    assert launches['k1'] > 0

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
    return launches, widths['all'], lk


def phase_k1_times(tables, device, card):
    """Phase 4: K1 at N_TIME and N_SMALL rays from the centre of the quick
    detector (a bomb's first query). On the main path's table (bf16): the
    warp-cooperative walk as traverse launches it and the plain version,
    timed in turns; the walk equals the plain version's outputs; the
    visits by node kind and the rows visited give the bound. Then
    traverse's two launch choices, lanes a ray and schedule, at the SWEEP
    ray counts (bf16) and at N_TIME (f32, fanout 16). Returns ({n: times},
    max |diff| against the plain version)."""
    import torch
    from chroma_tpu_torch.ops import mesh_wide, visit_kernel
    rs = np.random.RandomState(4)
    d = rs.randn(N_TIME, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o_all = torch.zeros((N_TIME, 3), dtype=torch.float32, device=device)
    d_all = torch.from_numpy(d.astype(np.float32)).to(device)
    table = tables['bf16']
    out, err = {}, 0.0
    for n in (N_TIME, N_SMALL):
        o, dn = o_all[:n], d_all[:n]
        seen = torch.zeros(table.rows.shape[0], dtype=torch.bool,
                           device=device)
        ref = [x.cpu().numpy() for x in mesh_wide.traverse(
            table, o, dn, by_kind=True, seen=seen)]
        by_kind = ref[5]
        ref[5] = by_kind.sum(axis=1)
        walk = [x.cpu().numpy() for x in visit_kernel.traverse(
            table, o, dn, by_kind=True)]
        np.testing.assert_array_equal(walk[5], by_kind,
                                      err_msg='walk visits by kind')
        walk[5] = walk[5].sum(axis=1)
        err = max(err, assert_same('walk %d' % n, walk, ref))
        kinds = by_kind.sum(axis=0).tolist()
        rows_seen = int(seen.sum())
        bound, by, ops, nbytes = k1_bound(table, n, kinds, rows_seen)
        fns = {
            'walk': lambda o=o, dn=dn: visit_kernel.traverse(table, o, dn),
            'plain': lambda o=o, dn=dn: mesh_wide.traverse(table, o, dn)}
        if n == N_SMALL:
            # a narrow launch alone times the host's dispatch: here the
            # walk also runs GRAPH_LAUNCHES launches from one graph
            fns['walk graph'] = graphed(fns['walk'])
        med, runs = time_turns(fns)
        runs = {k: [t / GRAPH_LAUNCHES for t in v] if 'graph' in k else v
                for k, v in runs.items()}
        med = {k: float(np.median(v)) for k, v in runs.items()}
        graph = 'walk graph' in med
        out[n] = dict(ms=med['walk graph' if graph else 'walk'],
                      eager_ms=med['walk'], plain_ms=med['plain'],
                      bound_ms=bound, bound_by=by)
        log('phase 4: K1, %d rays from the centre, quick/bf16, %s:' % (
            n, card))
        log('  the walk equals the plain version; visits %d: '
            'internal %d, leaf %d, instance %d (%.2f a ray, %.1f%% hit) to '
            '%d of %d rows; %.4g f32 operations, %.4g bytes: bound %.4f ms '
            'by %s' % (sum(kinds), *kinds, sum(kinds) / n,
                       100.0 * (ref[0] >= 0).mean(), rows_seen,
                       table.rows.shape[0], ops, nbytes, bound, by))
        for name, label in (('walk', 'warp-cooperative walk'),
                            ('walk graph', 'walk, a launch of a %d-launch '
                             'graph' % GRAPH_LAUNCHES),
                            ('plain', 'plain version')):
            if name not in med:
                continue
            log('  %-32s %9.4f ms (runs %s), %.2f%% of the bound' % (
                label, med[name], ' '.join('%.4f' % x for x in runs[name]),
                100.0 * bound / med[name]))

    log('phase 4: traverse\'s launch choices, rays from the centre of the '
        'quick detector, %s (ms, median of runs in turns; traverse: %d '
        'lanes where the table fits, persistent from %d rays)' % (
            card, visit_kernel.GROUP, visit_kernel.PERSISTENT_MIN_RAYS))
    sweep = {}
    for fmt, sizes in (('bf16', SWEEP), ('f32', (N_TIME,))):
        table = tables[fmt]
        for n in sizes:
            o, dn = o_all[:n], d_all[:n]
            fns = {}
            for group in (16, 32):
                for persistent in (False, True):
                    fns['%d lanes %s' % (
                        group, 'persistent' if persistent else 'grid')] = \
                        lambda o=o, dn=dn, g=group, p=persistent: \
                        visit_kernel.launch(table, o, dn, group=g,
                                            persistent=p)
            # traverse's own choice, a launch of a graph of them
            fns['traverse, graphed'] = graphed(
                lambda o=o, dn=dn: visit_kernel.traverse(table, o, dn))
            med = time_graphed(fns, ('traverse, graphed',))
            if fmt == 'bf16':
                sweep[n] = med['traverse, graphed']
            log('  %s (fanout %d) %7d rays: %s' % (
                fmt, table.fanout, n, '; '.join(
                    '%s %.4f' % kv for kv in med.items())))
    out['sweep'] = sweep
    return out, err


def device_bomb(n, seed, device):
    """An isotropic 400 nm bomb at the origin made on `device` with an
    explicit torch.Generator: a PhotonState that never was host Photons."""
    import torch
    from chroma_tpu_torch.ops.photon import PhotonState
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d = torch.randn((n, 3), generator=gen, device=device)
    d = d / d.norm(dim=1, keepdim=True)
    pol = torch.linalg.cross(torch.randn((n, 3), generator=gen,
                                         device=device), d)
    pol = pol / pol.norm(dim=1, keepdim=True)

    def full(value, dtype=torch.float32):
        return torch.full((n,), value, dtype=dtype, device=device)
    return PhotonState(
        pos=torch.zeros((n, 3), device=device), dir=d, pol=pol,
        wavelength=full(400.0), t=full(0.0), weight=full(1.0),
        flags=full(0, torch.int32), last_hit_triangle=full(-1, torch.int32),
        evidx=full(0, torch.int32), cur_mat=full(-1, torch.int32))


@contextlib.contextmanager
def host_photons_before_propagation():
    """Within the block, the number of event.Photons built before each
    call of the Simulation's propagation driver, in a list."""
    import chroma_tpu_torch.sim as sim_module
    from chroma_tpu_torch import event
    built, at_propagate = [0], []
    init, propagate = event.Photons.__init__, sim_module.propagate

    def counted_init(self, *args, **kwargs):
        built[0] += 1
        init(self, *args, **kwargs)

    def counted_propagate(*args, **kwargs):
        at_propagate.append(built[0])
        return propagate(*args, **kwargs)
    event.Photons.__init__ = counted_init
    sim_module.propagate = counted_propagate
    try:
        yield at_propagate
    finally:
        event.Photons.__init__ = init
        sim_module.propagate = propagate


def timed(fn):
    "(fn()'s result, wall seconds up to a device synchronise)."
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_geocache(quick, device, work, card):
    """Phase 9a: the quick detector's arrays through the port's geocache
    and back onto the card; every field present equals the build."""
    import dataclasses
    import torch
    from chroma_tpu_torch.io.geocache import (load_geometry_arrays,
                                              save_geometry_arrays)
    path = os.path.join(work, 'quick_geocache')
    t0 = time.perf_counter()
    save_geometry_arrays(path, quick)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_geometry_arrays(path, lean=True)
    t_load = time.perf_counter() - t0
    on_card, t_move = timed(lambda: loaded.to(device))

    def same(a, b, prefix):
        "Count a's tensors, each equal to b's; static fields equal."
        n = 0
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            name = prefix + '.' + f.name
            if x is None:
                continue
            if dataclasses.is_dataclass(x):
                n += same(x, y, name)
            elif isinstance(x, torch.Tensor):
                # bitwise: packed bf16 bounds include NaN words
                assert x.device == device and x.dtype == y.dtype and \
                    x.cpu().numpy().tobytes() == y.numpy().tobytes(), name
                n += 1
            else:
                assert x == y, name
        return n
    nfields = same(on_card, quick, 'ga')
    size = sum(os.path.getsize(path + ext) for ext in ('.npz', '.json'))
    log('phase 9a: geocache of the quick detector (%s): save %.3f s (%.1f '
        'MB with the per-triangle arrays), lean load %.3f s, to the card '
        '%.3f s; %d tensors equal the build, per-triangle arrays dropped'
        % (card, t_save, size / 1e6, t_load, t_move, nfields))
    assert on_card.vertices is None and on_card.inst is not None
    return on_card, dict(save_s=t_save, load_s=t_load, to_card_s=t_move)


def phase_device_source(quick_geo, loaded, device, card, phase5):
    """Phase 9b: a 2^20-photon bomb made on the card through
    Simulation(gpu_geometry=...), with the profiler's report; 9c: the same
    state through the gpu facade. Returns (9b's launches, 9c's launches,
    9b's wall)."""
    import chroma_tpu_torch
    from chroma_tpu_torch import gpu
    from chroma_tpu_torch.profiler import profiler
    state = device_bomb(N_BOMB, 90, device)
    sim = chroma_tpu_torch.Simulation(quick_geo, seed=0, device='cuda',
                                      gpu_geometry=loaded)
    profiler.reset()
    profiler.enabled = True
    zero_launches()
    with host_photons_before_propagation() as built:
        ev, wall = timed(lambda: next(sim.simulate(
            state, run_daq=True, keep_photons_end=True,
            max_steps=MAX_STEPS)))
    launches_b = launches_now()
    profiler.enabled = False
    frac5, wall5 = phase5
    log('phase 9b: device-resident source, %d photons made on the card, '
        'Simulation(gpu_geometry=geocache): wall %.3f s, %.0f photons/s '
        '(phase 5, host bomb: %.3f s, %.0f photons/s), detected %d, '
        'visit-kernel launches %d, host Photons built before propagation '
        '%s (%s)' % (N_BOMB, wall, N_BOMB / wall, wall5, N_BOMB / wall5,
                     len(ev.flat_hits), launches_b['k1'], built, card))
    assert built == [0], 'host Photons were built before propagation'
    assert launches_b['k1'] > 0 and len(ev.photons_end) == N_BOMB
    assert ((ev.photons_end.flags & (1 << 31)) == 0).all()
    detected_fraction_check(len(ev.flat_hits) / N_BOMB, N_BOMB, frac5,
                            N_BOMB, 'detected fraction, device source vs '
                            'phase 5')
    log('  profiler report of the run:')
    log_report()

    # what the device-resident source saves, on identical physics: the same
    # 2^20 host photons given as host Photons and as the PhotonState the
    # host path uploads them to, same seed, in turns
    from chroma_tpu_torch.generator import photon_bomb
    from chroma_tpu_torch.ops.propagate import photon_state_from_host
    np.random.seed(92)
    host = photon_bomb(N_BOMB, 400.0, (0, 0, 0))
    uploaded = photon_state_from_host(host, device)
    pair = {'host Photons': [], 'PhotonState': []}
    ends = []
    for name in ('host Photons', 'PhotonState', 'PhotonState',
                 'host Photons'):
        src = host if name == 'host Photons' else uploaded
        psim = chroma_tpu_torch.Simulation(quick_geo, seed=4, device='cuda',
                                           gpu_geometry=loaded)
        zero_launches()
        pev, pwall = timed(lambda: next(psim.simulate(
            src, run_daq=True, keep_photons_end=True, max_steps=MAX_STEPS)))
        pair[name].append((pwall, launches_now()['k1'],
                           len(pev.flat_hits)))
        end = pev.photons_end
        ends.append((len(pev.flat_hits), end.flags, end.pos, end.t,
                     end.last_hit_triangles))
    log('  the same %d host photons, seed 4, in turns (wall s, K1 launches, '
        'detected): %s' % (N_BOMB, json.dumps(pair)))
    # the same history: the detected hits and every photon's end state bit
    # for bit. (The K1 launches count the steps a stage ran after its last
    # lane died too, which depends on how far the host ran ahead of its
    # poll, as in phase 12b.)
    assert all(e[0] == ends[0][0] and all(
        np.array_equal(a, b) for a, b in zip(e[1:], ends[0][1:]))
        for e in ends), 'the two sources gave different histories'

    zero_launches()
    gg = gpu.GPUGeometry(quick_geo, arrays=loaded, device='cuda')
    gp = gpu.GPUPhotons(state)
    rng = gpu.get_rng_states(N_BOMB, seed=0)
    daq = gpu.GPUDaq(gg)

    def facade():
        gp.propagate(gg, rng, max_steps=MAX_STEPS)
        daq.begin_acquire()
        daq.acquire(gp, rng)
        return daq.end_acquire().get()
    channels, fwall = timed(facade)
    launches_c = launches_now()
    end = gp.get()
    log('phase 9c: GPUPhotons(state).propagate(GPUGeometry) + GPUDaq, seed '
        '0: wall %.3f s, visit-kernel launches %d' % (fwall,
                                                      launches_c['k1']))
    for name in ('flags', 'last_hit_triangles'):
        a, b = getattr(end, name), getattr(ev.photons_end, name)
        bad = np.flatnonzero(a != b)
        log('  %s: %d of %d lanes differ from 9b %s' % (
            name, len(bad), N_BOMB, [(int(i), int(a[i]), int(b[i]))
                                     for i in bad[:5]]))
        assert len(bad) == 0, name
    for name in ('hit', 't', 'q', 'flags'):
        a, b = getattr(channels, name), getattr(ev.channels, name)
        bad = np.flatnonzero(a != b)
        log('  channels.%s: %d of %d channels differ from 9b %s' % (
            name, len(bad), len(a), [int(i) for i in bad[:5]]))
        assert len(bad) == 0, 'channels.' + name
    assert launches_c['k1'] > 0
    return launches_b, launches_c, wall, pair


def log_report():
    "Log the profiler's report, indented, and reset it."
    from chroma_tpu_torch.profiler import profiler
    buf = io.StringIO()
    profiler.report(buf)
    for line in buf.getvalue().splitlines():
        log('    ' + line)
    profiler.reset()


def phase_tracking(quick_geo, loaded, card):
    """Phase 9d: photon tracking on N_TRACK photons of the quick detector,
    checked track by track, and timed against the same photons
    untracked. Returns (launches, tracked wall, untracked wall)."""
    import chroma_tpu_torch
    from chroma_tpu_torch.generator import photon_bomb
    from chroma_tpu_torch.profiler import profiler
    walls, events, launches = {}, {}, None
    for run, tracking in enumerate((False, True, False, True)):
        sim = chroma_tpu_torch.Simulation(quick_geo, seed=3, device='cuda',
                                          gpu_geometry=loaded,
                                          photon_tracking=tracking)
        np.random.seed(91)
        bomb = photon_bomb(N_TRACK, 400.0, (0, 0, 0))
        zero_launches()
        profiler.enabled = run >= 2     # the last pair: where time goes
        ev, wall = timed(lambda: next(sim.simulate(
            bomb, keep_photons_end=True, max_steps=MAX_STEPS)))
        profiler.enabled = False
        walls.setdefault(tracking, []).append(wall)
        if tracking:
            launches = launches_now()
        events[tracking] = (bomb, ev)
    bomb, ev = events[True]
    tracks, end = ev.photon_tracks, ev.photons_end
    lengths = np.array([len(t) for t in tracks])
    assert len(tracks) == N_TRACK and lengths.min() >= 1
    assert lengths.max() <= MAX_STEPS + 1
    for name in ('pos', 'dir', 'pol', 't', 'flags', 'last_hit_triangles'):
        last = np.array([getattr(t, name)[-1] for t in tracks])
        np.testing.assert_array_equal(last, getattr(end, name),
                                      err_msg='last point ' + name)
    # a track holds the state after each chunk (one step with tracking),
    # as chroma_tpu's does: the first point is where the first step left
    # the photon, on the ray from its start
    first = np.array([t.pos[0] for t in tracks], dtype=np.float64)
    step = first - bomb.pos
    off_ray = np.linalg.norm(np.cross(step, bomb.dir), axis=1)
    assert (off_ray <= 1e-4 * np.maximum(np.linalg.norm(step, axis=1),
                                         1.0)).all()
    t_track, t_plain = min(walls[True]), min(walls[False])
    log('phase 9d: photon tracking, %d photons, quick detector (%s): %d '
        'tracks, %d-%d points (mean %.2f), first points on the start rays, '
        'last points equal photons_end; wall tracked %s s, untracked %s s '
        '(%.2fx), visit-kernel launches tracked %d' % (
            N_TRACK, card, len(tracks), lengths.min(), lengths.max(),
            lengths.mean(), ' '.join('%.3f' % w for w in walls[True]),
            ' '.join('%.3f' % w for w in walls[False]), t_track / t_plain,
            launches['k1']))
    log('  profiler report of the second untracked and tracked runs:')
    log_report()
    assert launches['k1'] > 0
    return launches, t_track, t_plain


def run_tool(module, args, env):
    """`python -m module args` as a subprocess through runpy (what -m
    does), then the kernels' launches in that process: (stdout, stderr,
    a Counter)."""
    prelude = ('import runpy, sys, time; sys.argv[0] = %r; '
               't0 = time.perf_counter(); '
               'runpy.run_module(%r, run_name="__main__", alter_sys=True); '
               'print("tool seconds %%.3f" %% (time.perf_counter() - t0), '
               'file=sys.stderr); '
               'import json; from chroma_tpu_torch.ops import cuda_build; '
               'print("kernel launches", json.dumps(cuda_build.launches), '
               'file=sys.stderr)' % (module, module))
    proc = subprocess.run([sys.executable, '-c', prelude, *args], env=env,
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError('%s failed (%d):\n%s' % (module, proc.returncode,
                                                    proc.stderr[-4000:]))
    launches = collections.Counter(json.loads(re.findall(
        r'kernel launches (\{.*\})', proc.stderr)[-1]))
    return proc.stdout, proc.stderr, launches


def phase_cli(work, card):
    """Phase 9e: the port's command-line tools as subprocesses on
    demo.tiny(): chroma_tpu_torch.cli.sim writes two 2^20-photon events
    with DAQ, read back with EventReader; chroma_tpu_torch.cli.profile
    prints its report. Returns the launches of each."""
    from chroma_tpu_torch.io import EventReader
    env = dict(os.environ, CHROMA_CACHE_DIR=os.path.join(work, 'cache'))
    out = os.path.join(work, 'out.chroma')
    t0 = time.perf_counter()
    _, err, launches_sim = run_tool(
        'chroma_tpu_torch.cli.sim', ['@chroma_tpu_torch.demo.tiny', out,
                                     '-n', '2', '-p', str(N_BOMB), '--daq'],
        env)
    wall = time.perf_counter() - t0
    events = list(EventReader(out))
    log('phase 9e: python -m chroma_tpu_torch.cli.sim @chroma_tpu_torch.'
        'demo.tiny out.chroma -n 2 -p %d --daq (%s): %.1f s with the '
        'process start, %s; visit-kernel launches %d; read back %d events, '
        'channels hit %s, flat hits %s' % (
            N_BOMB, card, wall,
            re.findall(r'\d+ events in [^\n]*', err)[-1],
            launches_sim['k1'], len(events),
            [int(e.channels.hit.sum()) for e in events],
            [len(e.flat_hits) for e in events]))
    assert len(events) == 2 and launches_sim['k1'] > 0
    for e in events:
        assert e.channels is not None and e.channels.hit.any()
    stdout, _, launches_prof = run_tool(
        'chroma_tpu_torch.cli.profile', ['@chroma_tpu_torch.demo.tiny',
                                         '-p', '262144', '-n', '2'], env)
    log('  python -m chroma_tpu_torch.cli.profile @chroma_tpu_torch.demo.'
        'tiny -p 262144 -n 2: visit-kernel launches %d; its report:'
        % launches_prof['k1'])
    for line in stdout.splitlines():
        log('    ' + line)
    assert 'photons/s' in stdout and launches_prof['k1'] > 0
    return launches_sim, launches_prof



GDML_DOC = """<?xml version="1.0"?>
<gdml>
  <define>
    <position name="pmt_pos" unit="mm" x="0" y="0" z="400"/>
    <rotation name="pmt_rot" unit="deg" x="0" y="0" z="45"/>
    <position name="slab_pos" unit="mm" x="0" y="0" z="-500"/>
  </define>
  <materials/>
  <solids>
    <box name="world_box" lunit="mm" x="5000" y="5000" z="5000"/>
    <tube name="tank" lunit="mm" rmin="0" rmax="1000" z="2000"
          deltaphi="6.283185307179586"/>
    <orb name="pmt_ball" lunit="mm" r="100"/>
    <box name="slab" lunit="mm" x="300" y="300" z="100"/>
    <tube name="drill" lunit="mm" rmin="0" rmax="50" z="120"
          deltaphi="6.283185307179586"/>
    <subtraction name="holey_slab">
      <first ref="slab"/>
      <second ref="drill"/>
      <position name="drill_pos" unit="mm" x="0" y="0" z="0"/>
    </subtraction>
  </solids>
  <structure>
    <volume name="pmt_log">
      <materialref ref="glass"/>
      <solidref ref="pmt_ball"/>
    </volume>
    <volume name="slab_log">
      <materialref ref="steel"/>
      <solidref ref="holey_slab"/>
    </volume>
    <volume name="tank_log">
      <materialref ref="water"/>
      <solidref ref="tank"/>
      <physvol>
        <volumeref ref="pmt_log"/>
        <positionref ref="pmt_pos"/>
        <rotationref ref="pmt_rot"/>
      </physvol>
      <physvol>
        <volumeref ref="slab_log"/>
        <positionref ref="slab_pos"/>
      </physvol>
    </volume>
    <volume name="world_log">
      <materialref ref="air"/>
      <solidref ref="world_box"/>
      <physvol>
        <volumeref ref="tank_log"/>
        <position name="tank_pos" unit="mm" x="0" y="0" z="0"/>
      </physvol>
    </volume>
  </structure>
  <setup name="Default" version="1.0">
    <world ref="world_log"/>
  </setup>
</gdml>
"""


def matte_room():
    """A 2 m room of matte (80% diffuse, 20% absorbing) walls with a glass
    block in it, in air: every surface a camera inside sees parks photons."""
    from chroma_tpu_torch.geometry import Geometry, Material, Solid, Surface
    from chroma_tpu_torch.demo.optics import glass, vacuum
    from chroma_tpu_torch.make import box
    air = Material('air')
    air.set('refractive_index', 1.0003)
    air.set('absorption_length', 1e6)
    air.set('scattering_length', 1e6)
    matte = Surface('matte')
    matte.set('reflect_diffuse', 0.8)
    matte.set('absorb', 0.2)
    geo = Geometry(vacuum)
    geo.add_solid(Solid(box(2000.0, 2000.0, 2000.0), air, vacuum,
                        surface=matte, color=0x00CCCCCC))
    geo.add_solid(Solid(box(300.0, 300.0, 300.0), glass, air, surface=matte,
                        color=0x0000CC00), displacement=(200.0, 300.0, -100.0))
    geo.flatten()
    return geo


def shown(image):
    "Share of an (h, w, 3) frame's pixels that are not the white background."
    return float((image != 255).any(axis=-1).mean())


def peeled(table, origin, direction, nlayers):
    """The traversal state of the camera rays after `nlayers` depth layers
    peeled by the kernel, as ops.render.peel carries it: (position, last hit
    triangle, rays still active)."""
    import torch
    from chroma_tpu_torch.ops import visit_kernel
    from chroma_tpu_torch.ops.linalg import fma
    pos = origin
    last = torch.full((len(origin),), -1, dtype=torch.int32,
                      device=origin.device)
    active = torch.ones(len(origin), dtype=torch.bool, device=origin.device)
    for layer in range(nlayers):
        tri, dist = visit_kernel.traverse(
            table, pos, direction, last,
            mask=None if layer == 0 else active)[:2]
        hit = tri >= 0
        pos = torch.where(hit[:, None], fma(dist[:, None], direction, pos),
                          pos)
        last = torch.where(hit, tri, last)
        active = active & hit
    return pos, last, active


def phase_camera_rays(quick_geo, table, device, card):
    """Phase 10a: K1 against its plain version on the camera rays of the
    default pose, first and third depth layer; K1's time, visits and bound
    on the first. Returns (times and bound, max |diff|)."""
    import torch
    from chroma_tpu_torch.camera import _scene_pose
    from chroma_tpu_torch.ops import mesh_wide, visit_kernel
    from chroma_tpu_torch.ops.render import _unit
    pose, scale, center = _scene_pose(quick_geo)
    rays = pose.rays(RENDER_SIZE, device=device)
    o, d = rays.pos.contiguous(), _unit(rays.dir)
    n = len(o)
    seen = torch.zeros(table.rows.shape[0], dtype=torch.bool, device=device)
    ref = [x.cpu().numpy() for x in mesh_wide.traverse(
        table, o, d, by_kind=True, seen=seen)]
    walk = [x.cpu().numpy() for x in visit_kernel.traverse(
        table, o, d, by_kind=True)]
    by_kind = ref[5]
    np.testing.assert_array_equal(walk[5], by_kind,
                                  err_msg='camera rays: visits by kind')
    ref[5], walk[5] = by_kind.sum(axis=1), walk[5].sum(axis=1)
    err = assert_same('camera rays, layer 1', walk, ref)
    kinds = by_kind.sum(axis=0).tolist()
    rows_seen = int(seen.sum())
    bound, by, ops, nbytes = k1_bound(table, n, kinds, rows_seen)

    pos, last, active = peeled(table, o, d, 2)
    args = (table, pos, d, last, active)
    ref3 = [x.cpu().numpy() for x in mesh_wide.traverse(*args)]
    got3 = [x.cpu().numpy() for x in visit_kernel.traverse(*args)]
    err = max(err, assert_same('camera rays, layer 3', got3, ref3))

    med, runs = time_turns({
        'walk': lambda: visit_kernel.traverse(table, o, d),
        'plain': lambda: mesh_wide.traverse(table, o, d)})
    log('phase 10a: K1 on the %d camera rays of the default pose (%d x %d, '
        'from %.0f mm outside the centre), quick/bf16, %s:' % (
            n, *RENDER_SIZE, scale, card))
    log('  layer 1: kernel equals plain; %.1f%% of the rays hit; visits %d: '
        'internal %d, leaf %d, instance %d (%.2f a ray) to %d of %d rows; '
        '%.4g f32 operations, %.4g bytes: bound %.4f ms by %s' % (
            100.0 * (ref[0] >= 0).mean(), sum(kinds), *kinds,
            sum(kinds) / n, rows_seen, table.rows.shape[0], ops, nbytes,
            bound, by))
    log('  layer 3 (last hits excluded, %d rays still active, %d hit '
        'again): kernel equals plain (max |diff| %.3g)' % (
            int(active.sum()), int((ref3[0] >= 0).sum()), err))
    for name, label in (('walk', 'warp-cooperative walk'),
                        ('plain', 'plain version')):
        log('  %-24s %9.4f ms (runs %s), %.2f%% of the bound' % (
            label, med[name], ' '.join('%.4f' % x for x in runs[name]),
            100.0 * bound / med[name]))
    return dict(rays=n, ms=med['walk'], plain_ms=med['plain'],
                bound_ms=bound, bound_by=by), err


def phase_render(quick_geo, quick, quick_dev, device, card, out_dir):
    """Phase 10b: render and distances, card against CPU; 10c: frames at
    full width. Returns (K1 launches of 10c's frames, median wall a frame,
    one frame's milliseconds in render(), in K1 and on the host)."""
    import torch
    from chroma_tpu_torch.camera import (_pixels_to_image, _scene_pose,
                                         save_png, snapshot)
    from chroma_tpu_torch.ops import render, visit_kernel
    pose, scale, center = _scene_pose(quick_geo)
    out = {}
    for dev, ga in (('cpu', quick), (device, quick_dev)):
        rays = pose.rays(CHECK_SIZE, device=dev)
        (pix, dist), wall = timed(lambda: (
            rays.render(ga, ALPHA_DEPTH),
            render.distances(rays.pos, rays.dir, ga)))
        out[dev] = (render.pixels_to_host(pix), dist.cpu().numpy(), wall)
    (cp, cd, cwall), (gp, gd, gwall) = out['cpu'], out[device]
    differ = np.flatnonzero(cp != gp)
    worst = max(int(np.abs(((cp >> s) & 0xFF).astype(int)
                           - ((gp >> s) & 0xFF).astype(int)).max())
                for s in (24, 16, 8, 0))
    hit = np.isfinite(cd)
    log('phase 10b: render, %d x %d rays, alpha_depth %d, card (%.3f s) '
        'against CPU (%.1f s): %d of %d pixels differ %s, largest channel '
        'difference %d; distances: %d hits, max |diff| %.3g' % (
            *CHECK_SIZE, ALPHA_DEPTH, gwall, cwall, len(differ), len(cp),
            [(int(k), '%08x' % cp[k], '%08x' % gp[k]) for k in differ[:5]],
            worst, int(hit.sum()),
            float(np.abs(cd[hit] - gd[hit]).max(initial=0.0))))
    assert len(differ) <= len(cp) // 1000 and worst <= 1
    np.testing.assert_array_equal(hit, np.isfinite(gd))
    np.testing.assert_allclose(gd[hit], cd[hit], rtol=RTOL)
    cpu_image = _pixels_to_image(cp, CHECK_SIZE)

    # 10c: a warm-up snapshot, then frames of turning rays
    warm = snapshot(quick_geo, size=RENDER_SIZE, alpha_depth=ALPHA_DEPTH,
                    geometry_arrays=quick_dev, device=device)
    rays = pose.rays(RENDER_SIZE, device=device)
    walls, frames = [], []
    zero_launches()
    for _ in range(N_FRAMES):
        image, wall = timed(lambda: _pixels_to_image(
            rays.render(quick_dev, ALPHA_DEPTH), RENDER_SIZE))
        walls.append(wall)
        frames.append(image)
        rays.rotate_around_point(0.05, (0.0, 0.0, 1.0), center)
    launches = launches_now()
    wall = float(np.median(walls))
    nrays = RENDER_SIZE[0] * RENDER_SIZE[1]
    shares = [shown(f) for f in frames]
    log('phase 10c: %d x %d frames of the quick detector, alpha_depth %d '
        '(%s): wall a frame %s s (median %.4f s: %.2f frames/s, %.4g '
        'rays/s), K1 launches %d (%.1f a frame), pixels showing geometry '
        '%s (CPU render of the first pose, %d x %d: %.4f)' % (
            *RENDER_SIZE, ALPHA_DEPTH, card,
            ' '.join('%.4f' % w for w in walls), wall, 1.0 / wall,
            nrays / wall, launches['k1'], launches['k1'] / N_FRAMES,
            ' '.join('%.4f' % x for x in shares), *CHECK_SIZE,
            shown(cpu_image)))
    assert launches['k1'] > 0
    for image in frames:
        assert image.shape == (RENDER_SIZE[1], RENDER_SIZE[0], 3)
        assert image.dtype == np.uint8
    assert frames[0].tobytes() == warm.tobytes(), \
        'the first frame is not snapshot()\'s'
    assert abs(shares[0] - shown(cpu_image)) <= 0.02
    save_png(os.path.join(out_dir, 'render_quick.png'), frames[0])

    # where a frame's time goes: K1 layer by layer (CUDA events around each
    # launch), the rest of render() on the card, the pixels to the host and
    # the image there
    spans = []
    traverse = visit_kernel.traverse

    def timed_traverse(inst, origin, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        result = traverse(inst, origin, *args, **kwargs)
        end.record()
        spans.append((start, end, kwargs.get('mask')))
        return result
    visit_kernel.traverse = timed_traverse
    try:
        pixels, t_render = timed(lambda: rays.render(quick_dev, ALPHA_DEPTH))
    finally:
        visit_kernel.traverse = traverse
    _, t_image = timed(lambda: _pixels_to_image(pixels, RENDER_SIZE))
    layers = [(a.elapsed_time(b), nrays if m is None else int(m.sum()))
              for a, b, m in spans]
    k1_ms = sum(ms for ms, _ in layers)
    log('  one more frame: render() %.2f ms to a device synchronise, of it '
        'K1 %.2f ms (%.1f%% of the %.2f ms frame) in %d launches [ms on '
        'rays traced: %s]; pixels to the host and the image in numpy %.2f '
        'ms' % (t_render * 1e3, k1_ms, 100.0 * k1_ms / (
            (t_render + t_image) * 1e3), (t_render + t_image) * 1e3,
            len(layers), ', '.join('%.3f on %d' % x for x in layers),
            t_image * 1e3))
    return launches, wall, dict(render_ms=t_render * 1e3, k1_ms=k1_ms,
                                image_ms=t_image * 1e3)


def phase_viewer(quick_geo, quick_dev, tiny_geo, ev5, device, card, work):
    """Phase 10d: the viewer's frame modes with no display. Returns (K1
    launches of the viewer frames, of the photon map, its wall)."""
    import torch
    import chroma_tpu_torch
    from chroma_tpu_torch import gpu
    from chroma_tpu_torch.camera import (Camera, CameraPose, EventViewer,
                                         _scene_pose, bvh_layer_geometry,
                                         draw_tracks, snapshot)
    from chroma_tpu_torch.generator import photon_bomb
    from chroma_tpu_torch.loader import load_bvh
    from chroma_tpu_torch.make import box
    size = VIEWER_SIZE
    pose, scale, center = _scene_pose(quick_geo)
    cam = Camera(quick_geo, size=size, alpha_depth=ALPHA_DEPTH,
                 device=device)
    cam._scale = scale
    zero_launches()
    mono = cam._frame(quick_dev, pose, False, False, (0, 0))
    stereo = cam._frame(quick_dev, pose, True, False, (0, 0))
    red = int((stereo[..., 0] != mono[..., 0]).sum())
    assert mono.shape == (size[1], size[0], 3) and red > 0
    assert (stereo[..., 1:] != 255).any()

    tiny_geo.bvh = load_bvh(tiny_geo, cache_dir=os.path.join(work, 'cache'))
    layer_geo = bvh_layer_geometry(tiny_geo, 1)
    layer = snapshot(layer_geo, size=size, alpha_depth=ALPHA_DEPTH,
                     device=device)
    nboxes = len(tiny_geo.bvh.get_layer(1))
    assert len(layer_geo.mesh.triangles) == len(box(1.0, 1.0, 1.0)
                                                .triangles) * nboxes
    assert shown(layer) > 0.01

    viewer = EventViewer(quick_geo, [ev5], size=size,
                         alpha_depth=ALPHA_DEPTH, device=device)
    viewer._scale = scale
    viewer._ga_base = quick_dev
    colors = viewer.event_colors(ev5)
    solid_hit = np.zeros(int(quick_geo.solid_id.max()) + 1, bool)
    solid_hit[np.asarray(quick_geo.channel_index_to_solid_id)[
        ev5.channels.hit]] = True
    of_hit = solid_hit[quick_geo.solid_id]
    changed = colors != quick_geo.colors
    assert not changed[~of_hit].any() and changed[of_hit].mean() > 0.99
    recolored = viewer._recolored()
    assert recolored.colors.device == quick_dev.colors.device
    event_frame = viewer._frame(recolored, pose, False, False, (0, 0))
    repainted = int((event_frame != mono).any(axis=-1).sum())
    assert repainted > 0

    tsim = chroma_tpu_torch.Simulation(quick_geo, seed=3, device='cuda',
                                       gpu_geometry=quick_dev,
                                       photon_tracking=True)
    np.random.seed(93)
    tev = next(tsim.simulate(photon_bomb(N_TRACK, 400.0, (0, 0, 0)),
                             max_steps=MAX_STEPS))
    viewer.source = type(viewer.source)([tev])
    viewer.show_tracks = True
    overlaid = viewer._overlay(event_frame.copy(), pose)
    marked = int((overlaid != event_frame).any(axis=-1).sum())
    assert marked > 0
    assert draw_tracks(event_frame.copy(), tev.photon_tracks, pose,
                       size).tobytes() == overlaid.tobytes()

    rays = pose.rays(size, device=device)
    grays = gpu.GPURays(rays.pos, rays.dir, device=device)
    host = np.zeros(size[0] * size[1], np.uint32)
    pix = grays.render(gpu.GPUGeometry(quick_geo, arrays=quick_dev,
                                       device=device), pixels=host,
                       alpha_depth=ALPHA_DEPTH)
    assert torch.equal(pix, rays.render(quick_dev, ALPHA_DEPTH))
    assert (host.view(np.int32) == pix.cpu().numpy()).all()
    launches = launches_now()
    log('phase 10d: viewer frames at %d x %d through Camera._frame and '
        'EventViewer (%s): anaglyph differs from mono in the red of %d '
        'pixels; BVH layer 1 of demo.tiny(): %d boxes, %.4f of the frame; '
        'event colors: %d channels hit, only their triangles recolored, %d '
        'pixels repainted; track overlay of %d tracked photons marks %d '
        'pixels; GPURays.render equals Rays.render; K1 launches %d' % (
            *size, card, red, nboxes, shown(layer),
            int(ev5.channels.hit.sum()), repainted, N_TRACK, marked,
            launches['k1']))
    assert launches['k1'] > 0

    # the photon map. In the quick detector photons park on photocathodes,
    # behind the glass that a camera ray meets first, so its map is dark:
    # it gives the launches and the wall at the detector's width. A matte
    # room gives the lit image.
    inside = CameraPose(center, axis1=(0, 0, 1), axis2=(1, 0, 0))
    zero_launches()
    hybrid, wall = timed(lambda: cam._frame(quick_dev, inside, False, True,
                                            (0, 0)))
    room = matte_room()
    room_cam = Camera(room, size=size, device=device)
    room_pose = CameraPose((0.0, -900.0, 0.0), axis1=(0, 0, 1),
                           axis2=(1, 0, 0))
    lit_room, room_wall = timed(lambda: room_cam._frame(
        room_cam._geometry_arrays(), room_pose, False, True, (0, 0)))
    launches_h = launches_now()
    lit = float(lit_room.any(axis=-1).mean())
    log('  photon map (hybrid_render, 4 batches of 100000 photons, %d x '
        '%d): from the centre of the quick detector wall %.3f s, %d pixels '
        'lit; in a matte room wall %.3f s, %.4f of the pixels lit, '
        'brightest channel %d; K1 launches %d' % (
            *size, wall, int(hybrid.any(axis=-1).sum()), room_wall, lit,
            int(lit_room.max()), launches_h['k1']))
    assert hybrid.shape == lit_room.shape == (size[1], size[0], 3)
    assert lit > 0.9 and lit_room.max() == 255 and launches_h['k1'] > 0
    return launches, launches_h, wall


def phase_render_tools(work, card, out_dir):
    """Phase 10e: chroma_tpu_torch.cli.cam -o as a subprocess on
    demo.tiny(), and chroma_tpu_torch.cli.bvh create, stat and sort on a
    demo mesh, their caches in the work directory. Returns cli.cam's K1
    launches and its walls with and without the process start."""
    env = dict(os.environ, CHROMA_CACHE_DIR=os.path.join(work, 'cache'))
    png = os.path.join(out_dir, 'tiny.png')
    t0 = time.perf_counter()
    stdout, err, launches = run_tool(
        'chroma_tpu_torch.cli.cam', [
            '@chroma_tpu_torch.demo.tiny', '--size',
            *(str(x) for x in CLI_CAM_SIZE), '-o', png], env)
    wall = time.perf_counter() - t0
    inner = float(re.findall(r'tool seconds ([\d.]+)', err)[-1])
    with open(png, 'rb') as fh:
        head = fh.read(24)
    assert 'wrote' in stdout and head[:8] == b'\x89PNG\r\n\x1a\n'
    assert tuple(int.from_bytes(head[k:k + 4], 'big')
                 for k in (16, 20)) == CLI_CAM_SIZE
    log('phase 10e: python -m chroma_tpu_torch.cli.cam @chroma_tpu_torch.'
        'demo.tiny --size %d %d -o tiny.png (%s): %.1f s with the process '
        'start, %.1f s in the tool (imports, geometry, BVH, arrays, frame), '
        'K1 launches %d, %d bytes' % (*CLI_CAM_SIZE, card, wall, inner,
                                      launches['k1'],
                                      os.path.getsize(png)))
    assert launches['k1'] > 0
    mesh = '@chroma_tpu_torch.models.liberty'
    code = ('from chroma_tpu_torch.cli import bvh\n'
            'for argv in (["create", %r, "smoke"], ["stat", %r, "smoke"], '
            '["sort", %r, "smoke"], ["list", %r]):\n'
            '    bvh.main(argv)\n' % (mesh, mesh, mesh, mesh))
    proc = subprocess.run([sys.executable, '-c', code], env=env,
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError('cli.bvh failed (%d):\n%s' % (
            proc.returncode, proc.stderr[-4000:]))
    lines = proc.stdout.splitlines()
    log('  chroma_tpu_torch.cli.bvh create / stat / sort / list on %s: %s'
        % (mesh, ' | '.join(line.strip() for line in lines[:3] + lines[-2:])))
    assert 'BVH built in' in lines[0] and 'nodes:' in proc.stdout
    assert 'Sorting BVH nodes by area' in proc.stdout and lines[-1] == 'smoke'
    return launches, wall, inner


def phase_gdml(device, card, work):
    """Phase 10f: a GDML document with a boolean solid, through GDMLLoader,
    as a Detector on the card: a bomb with the DAQ, and one frame. Returns
    the K1 launches of both."""
    import chroma_tpu_torch
    from chroma_tpu_torch import event
    from chroma_tpu_torch.camera import snapshot
    from chroma_tpu_torch.csg import mesh_volume
    from chroma_tpu_torch.demo import optics
    from chroma_tpu_torch.gdml import GDMLLoader
    from chroma_tpu_torch.generator import photon_bomb
    path = os.path.join(work, 'smoke.gdml')
    with open(path, 'w') as fh:
        fh.write(GDML_DOC)
    loader = GDMLLoader(path)

    def classify(volume_ref, material_ref, parent_material_ref):
        if volume_ref == 'pmt_log':
            return 'pmt', dict(material1=optics.vacuum,
                               material2=optics.water,
                               surface=optics.r7081hqe_photocathode,
                               channel_type=0)
        if volume_ref == 'world_log':
            return 'omit', dict()
        if volume_ref == 'slab_log':
            return 'solid', dict(material1=optics.glass,
                                 material2=optics.water,
                                 surface=optics.shiny_surface)
        return 'solid', dict(material1=optics.water,
                             material2=optics.vacuum,
                             surface=optics.black_surface)
    det = loader.build_detector(volume_classifier=classify)
    det.set_time_dist_gaussian(1.5, -7.5, 7.5)
    det.set_charge_dist_gaussian(1.0, 0.1, 0.0, 1.5)
    det.flatten()
    drilled = mesh_volume(loader.get_mesh('holey_slab'))
    want = 300.0 * 300 * 100 - np.pi * 50 ** 2 * 100
    assert abs(drilled - want) / want < 0.02
    sim = chroma_tpu_torch.Simulation(det, seed=0, device='cuda')
    np.random.seed(94)
    zero_launches()
    ev, wall = timed(lambda: next(sim.simulate(
        photon_bomb(N_CHECK, 400.0, (0, 0, 0)), run_daq=True,
        keep_photons_end=True, max_steps=MAX_STEPS)))
    flags = ev.photons_end.flags
    aborts = int(((flags & event.NAN_ABORT) != 0).sum())
    image = snapshot(det, size=VIEWER_SIZE, alpha_depth=ALPHA_DEPTH,
                     geometry_arrays=sim.gpu_geometry, device=device)
    launches = launches_now()
    log('phase 10f: GDML detector (tank, PMT ball, a slab with a drilled '
        'hole: %d solids, %d triangles, %d channel; the boolean solid has '
        '%.4f of the analytic volume): %d-photon bomb in %.3f s, detected '
        '%d, channel hit %s, NaN aborts %d; one %d x %d frame shows '
        'geometry in %.4f of its pixels; K1 launches %d (%s)' % (
            len(det.solids), len(det.mesh.triangles), det.num_channels(),
            drilled / want, N_CHECK, wall, len(ev.flat_hits),
            ev.channels.hit.tolist(), aborts, *VIEWER_SIZE, shown(image),
            launches['k1'], card))
    assert aborts == 0 and launches['k1'] > 0 and ev.channels.hit.all()
    assert len(ev.flat_hits) > 0 and shown(image) > 0.05
    return launches


def sharded_rank(geocache, seed):
    """Phase 11 in one rank of the group run_ranks started: the quick
    detector lean-loaded from phase 9a's geocache onto the rank's card;
    propagate_and_daq_sharded twice with one seed on phase 5's 2^20-photon
    bomb (after pad_to_mesh), then Simulation(n_devices=size) on the same
    bomb with K1's launches counted from 0. Returns numpy results, and
    rank 0 also the propagated state the DAQ read."""
    import hashlib
    import torch
    import chroma_tpu_torch
    from chroma_tpu_torch import event
    from chroma_tpu_torch.generator import photon_bomb
    from chroma_tpu_torch.io.geocache import load_geometry_arrays
    from chroma_tpu_torch.ops.propagate import photon_state_from_host
    from chroma_tpu_torch.parallel import (pad_to_mesh, photon_mesh,
                                           propagate_and_daq_sharded)
    from chroma_tpu_torch.profiler import profiler
    mesh = photon_mesh()
    ga = load_geometry_arrays(geocache, lean=True).to(mesh.device)
    np.random.seed(5)
    bomb = photon_bomb(N_BOMB, 400.0, (0, 0, 0))
    state, _ = pad_to_mesh(photon_state_from_host(bomb, mesh.device), mesh)

    def fields(st):
        return {k: v.cpu().numpy() for k, v in vars(st).items()}
    out = dict(rank=mesh.rank, device=str(mesh.device), digests=[],
               daq_s=[])
    for _ in range(2):
        torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        photons, channels = propagate_and_daq_sharded(
            state, ga, seed, max_steps=MAX_STEPS, mesh=mesh)
        torch.cuda.synchronize(mesh.device)
        out['daq_s'].append(time.perf_counter() - t0)
        daq = tuple(x.cpu().numpy() for x in (
            channels.earliest_time, channels.charge, channels.histories))
        digest = hashlib.sha256()
        for arr in list(fields(photons).values()) + list(daq):
            digest.update(arr.tobytes())
        out['digests'].append(digest.hexdigest())
    out['daq'] = daq
    if mesh.rank == 0:
        out['state'] = fields(photons)

    sim = chroma_tpu_torch.Simulation(None, seed=0, gpu_geometry=ga,
                                      n_devices=mesh.size)
    torch.cuda.synchronize(mesh.device)
    profiler.reset()
    profiler.enabled = True
    zero_launches()
    t0 = time.perf_counter()
    ev = next(sim.simulate([bomb], run_daq=True, max_steps=MAX_STEPS,
                           keep_photons_end=True))
    torch.cuda.synchronize(mesh.device)
    out['wall'] = time.perf_counter() - t0
    out['launches'] = launches_now()
    profiler.enabled = False
    out['regions'] = {name: st.total for name, st in
                      sorted(profiler.regions.items())}
    out['detected'] = len(ev.flat_hits)
    out['aborts'] = int(((ev.photons_end.flags & event.NAN_ABORT)
                         != 0).sum())
    out['channels'] = (ev.channels.t, ev.channels.q, ev.channels.flags)
    return out


def phase_sharded(loaded, work, card, phase5):
    """Phase 11: the photon sharding, through parallel.run_ranks: two gloo
    ranks on card 0 (NCCL refuses two ranks on one card; gloo reduces
    through the host), and with more than one card, NCCL with one rank a
    card. (a) Simulation(n_devices=k): its detected fraction against phase
    5's within 5 sigma, no NaN abort, one channel set on every rank; (b)
    propagate_and_daq_sharded: the ranks' reduced ChannelArrays equal a
    single-process emulation (each shard's run_daq here with the rank's
    generator, reduced by numpy min / sum / OR), earliest times and
    histories bit for bit, charge at charge_unit; (c) two calls with one
    seed equal bit for bit; (d) every rank launched K1; (e) the wall
    against phase 5's. Returns (K1 launches summed over the ranks of every
    run, a summary for the JSON line)."""
    import torch
    from chroma_tpu_torch.ops import daq as daq_ops
    from chroma_tpu_torch.ops.photon import PhotonState
    from chroma_tpu_torch.ops.sample import make_generator
    from chroma_tpu_torch.parallel import PhotonMesh, run_ranks, shard_seed
    from chroma_tpu_torch.parallel.sharding import DAQ_SITE
    geocache = os.path.join(work, 'quick_geocache')
    seed = 11
    frac5, wall5 = phase5
    runs = [('gloo', 2)]
    if torch.cuda.device_count() > 1:
        runs.append(('nccl', torch.cuda.device_count()))
    launches, summary = collections.Counter(), {}
    for backend, nranks in runs:
        t0 = time.perf_counter()
        res = run_ranks(sharded_rank, nranks, args=(geocache, seed),
                        backend=backend, timeout=600)
        call_s = time.perf_counter() - t0
        # (a) Simulation(n_devices=k)
        first = res[0]
        for r in res:
            assert r['aborts'] == 0, 'NaN aborts in rank %d' % r['rank']
            assert r['detected'] == first['detected']
            for a, b in zip(r['channels'], first['channels']):
                assert a.tobytes() == b.tobytes(), 'channels differ'
        detected_fraction_check(first['detected'] / N_BOMB, N_BOMB, frac5,
                                N_BOMB, 'phase 11 (%s) detected fraction, '
                                'sharded vs phase 5' % backend)
        # (b) the reduced readout against the single-process emulation
        state = {k: torch.from_numpy(v).to(loaded.wide.rows.device)
                 for k, v in first['state'].items()}
        n = len(state['t'])
        per = n // nranks
        parts = []
        for rank in range(nranks):
            part = PhotonState(**{k: v[rank * per:(rank + 1) * per]
                                  for k, v in state.items()})
            mesh = PhotonMesh(None, nranks, rank, loaded.wide.rows.device)
            gen = make_generator(mesh.device,
                                 *shard_seed((seed, DAQ_SITE), mesh))
            arr = daq_ops.run_daq(part, loaded, gen)
            parts.append([x.cpu().numpy() for x in (
                arr.earliest_time, arr.charge, arr.histories)])
        t_e = np.min([p[0] for p in parts], axis=0)
        q_e = np.sum([p[1] for p in parts], axis=0)
        h_e = np.bitwise_or.reduce([p[2].view(np.uint32) for p in parts],
                                   axis=0)
        unit = float(loaded.detector.charge_unit)
        for r in res:
            t, q, h = r['daq']
            assert t.tobytes() == t_e.tobytes(), 'earliest times differ'
            assert h.view(np.uint32).tobytes() == h_e.tobytes(), \
                'histories differ'
            np.testing.assert_array_equal(np.round(q / unit),
                                          np.round(q_e / unit))
        # (c) repeatability, (d) launches
        digests = {d for r in res for d in r['digests']}
        assert len(digests) == 1, 'two calls with one seed differ'
        per_rank = [r['launches'] for r in res]
        assert min(c['k1'] for c in per_rank) > 0, 'a rank launched no K1'
        launches += total_launches(per_rank)
        wall = max(r['wall'] for r in res)
        log('phase 11: %s, %d ranks on %s: Simulation(n_devices=%d) on '
            'the %d-photon bomb of phase 5: wall %.3f s (ranks %s) against '
            'phase 5\'s one-process %.3f s (x%.2f), detected %d (%.5f; '
            'phase 5 %.5f), channels hit %d, NaN aborts 0, K1 launches a '
            'rank %s; propagate_and_daq_sharded %s s, the reduced readout '
            'equal to the single-process emulation (%d channels hit), two '
            'calls equal; run_ranks call %.1f s (%s)' % (
                backend, nranks, sorted({r['device'] for r in res}), nranks,
                N_BOMB, wall, ['%.3f' % r['wall'] for r in res], wall5,
                wall / wall5, first['detected'], first['detected'] / N_BOMB,
                frac5, int((first['channels'][0] < 1e8).sum()),
                [c['k1'] for c in per_rank],
                ['%.3f' % x for x in first['daq_s']],
                int((t_e < 1e8).sum()), call_s, card))
        log('  host seconds by profiler region, rank by rank: %s'
            % '; '.join(', '.join('%s %.3f' % kv
                                  for kv in r['regions'].items())
                        for r in res))
        summary[backend] = dict(ranks=nranks, wall_s=wall,
                                rank_wall_s=[r['wall'] for r in res],
                                phase5_s=wall5, daq_s=first['daq_s'],
                                launches=[c['k1'] for c in per_rank],
                                call_s=call_s)
    log('phase 11: backends run: %s' % ', '.join(summary))
    return launches, summary


FUSED_CHECK = 65536          # phase 12b's lanes, replay against eager
FIXED_SCHEDULE = ((1, 2), (2, 2), (4, 2))   # phase 12b's schedule
COST_WIDTHS = [1 << k for k in range(11, 21)]  # phase 12a's step widths
COST_REPLAYS = 8
MANY_EVENTS = 32             # phase 12f's likelihood events


def fused_counters():
    """Zero the counters of the fused route (the kernels' launches; the
    profiler's graph and host-read counters) and enable the profiler."""
    from chroma_tpu_torch.profiler import profiler
    zero_launches()
    profiler.reset()
    profiler.enabled = True


def fused_stats():
    "The counters fused_counters zeroed, read; the profiler disabled."
    from chroma_tpu_torch.profiler import profiler
    profiler.enabled = False
    c = profiler.counters
    capture = profiler.regions.get('graphs.capture')
    return dict(launches=launches_now(), captures=c['graphs.captures'],
                capture_s=capture.total if capture else 0.0,
                replays=c['graphs.replays'],
                blocking_reads=c['propagate.blocking_reads'],
                throttle_waits=c['propagate.throttle_waits'])


def check_fused(stats, schedule):
    """A fused bomb's counters hold the route's contract: every step
    launched K1 and K2 once, eagerly (one step before each capture) or in
    a replay; at most one blocking read a stage boundary and one at the
    end."""
    k1 = stats['launches']['k1']
    assert k1 > 0
    assert k1 == stats['replays'] + stats['captures'], stats
    assert stats['launches']['k2_post'] == k1, stats
    assert stats['launches']['k2_pre'] == k1, stats
    assert stats['blocking_reads'] <= len(schedule) + 1, stats


def fit_line(x, y):
    "Least-squares (slope, intercept) of y against x."
    a, b = np.polyfit(np.asarray(x, float), np.asarray(y, float), 1)
    return float(a), float(b)


def boundary_ms(ph, width):
    """Host ms of one fused-stage boundary at `width` lanes, as
    _fused_bomb makes it: the blocking read of the alive count, the
    front-pack, the lane gathers into a prefix of half the width and the
    suffix, the prefix's copy into a graph's state and out of it, and the
    reassembly in input order."""
    import torch
    from chroma_tpu_torch.ops import propagate as P
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    int(ph.alive.sum())
    dest, perm = P._ps_compact_perm(ph.alive)
    php = ph.map(lambda a: a[perm])
    prefix = php.map(lambda a: a[:width // 2]).map(torch.clone).map(
        torch.clone)
    out = P._cat(prefix, php.map(lambda a: a[width // 2:])).map(
        lambda a: a[dest])
    torch.cuda.synchronize()
    del out
    return (time.perf_counter() - t0) * 1e3


def phase_cost_model(quick, device, card):
    """Phase 12a: the tuner's cost model on this card. Graph-replayed
    steps of the quick detector (a 2^20-photon bomb's first lanes, from
    step 0; CUDA events over COST_REPLAYS replays) from 2^11 to 2^20
    lanes fit t = a*w + b; boundaries (boundary_ms, median of 5) fit
    c*w + d. Prints the constants of ops.propagate's tuner beside the
    module's defaults."""
    import torch
    from chroma_tpu_torch.ops import graphs
    from chroma_tpu_torch.ops import propagate as P
    geo = quick.to(device)
    big = device_bomb(N_BOMB, 120, device)
    steps, bounds, enqueue = [], [], []
    for w in COST_WIDTHS:
        sub = big.map(lambda a: a[:w].contiguous())
        P._steps(sub, geo, 1, 1, 1, False, 0, True, True)   # eager+capture
        g = graphs.lookup(geo, sub, False, 0, True)
        g.load(sub)
        g.replay(2, 1)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        g.load(sub)
        torch.cuda.synchronize()
        e0.record()
        t0 = time.perf_counter()
        for s in range(COST_REPLAYS):
            g.replay(2, 1 + s)
        # the host's time to enqueue the replays (each re-seeds the
        # graph's generator and launches it): where it exceeds the card's,
        # the step time below is the host's
        enqueue.append((time.perf_counter() - t0) * 1e3 / COST_REPLAYS)
        e1.record()
        torch.cuda.synchronize()
        steps.append(e0.elapsed_time(e1) / COST_REPLAYS)
        bounds.append(float(np.median([boundary_ms(sub, w)
                                       for _ in range(5)])))
    a, b = fit_line(COST_WIDTHS, steps)
    c, d = fit_line(COST_WIDTHS, bounds)
    consts = dict(floor_lanes=b / a, boundary_frac=c / a,
                  boundary_lanes=d / a)
    log('phase 12a: the tuner\'s cost model on the card (%s): graph-'
        'replayed step ms by lanes %s; boundary ms %s' % (
            card, ', '.join('%d: %.3f' % wt for wt in zip(COST_WIDTHS,
                                                           steps)),
            ', '.join('%d: %.3f' % wt for wt in zip(COST_WIDTHS, bounds))))
    log('  host ms to enqueue a replay, by lanes: %s (beside the card\'s '
        'ms a step above: the larger of the two sets the step time)' % (
            ', '.join('%d: %.3f' % wt for wt in zip(COST_WIDTHS, enqueue))))
    log('  step = %.4g ms/lane x w + %.4g ms; boundary = %.4g ms/lane x w '
        '+ %.4g ms -> SCHED_FLOOR_LANES %.0f, SCHED_BOUNDARY_FRAC %.4f, '
        'SCHED_BOUNDARY_LANES %.0f (module defaults %d, %.4f, %d)' % (
            a, b, c, d, consts['floor_lanes'], consts['boundary_frac'],
            consts['boundary_lanes'], P.SCHED_FLOOR_LANES,
            P.SCHED_BOUNDARY_FRAC, P.SCHED_BOUNDARY_LANES))
    assert a > 0 and all(np.isfinite(list(consts.values())))
    prologue = prologue_cost(geo, big, device)
    for name, label in (('kernel', 'the uniform blocks and k2_pre, as the '
                         'card runs it'),
                        ('plain', 'its plain twin step_prologue')):
        row = prologue[name]
        log('  the step prologue (NaN guard, uniform blocks, pruning '
            'limit), %s: %d aten ops, %d device kernels; ms by lanes %s, '
            'the host\'s ms to enqueue it %s (%s)' % (
                label, row['aten_ops'], row['kernels'], ', '.join(
                    '%d: %.4f' % wt for wt in row['ms'].items()),
                ', '.join('%d: %.4f' % wt for wt in row['enqueue_ms']
                          .items()), card))
    assert prologue['kernel']['kernels'] <= prologue['n_blocks'] + 1, \
        prologue
    return dict(step_ms=dict(zip(COST_WIDTHS, steps)),
                enqueue_ms=dict(zip(COST_WIDTHS, enqueue)),
                boundary_ms=dict(zip(COST_WIDTHS, bounds)),
                constants=consts, prologue=prologue, card=card)


def prologue_cost(geo, big, device):
    """The step prologue on the first lanes of `big` after one step, as
    the card runs it (step_kernel.before_query: the uniform blocks and
    k2_pre) and as its plain twin (photon.step_prologue, the first
    card prologue): for each, its aten ops and device kernels (torch.profiler,
    one call at 2^11 lanes) and its ms at 2^11 lanes and all of them (2^20;
    CUDA events over COST_REPLAYS calls, and the host's ms to enqueue
    them)."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    from chroma_tpu_torch.ops import photon, step_kernel
    from chroma_tpu_torch.ops.sample import DrawPool, make_generator
    state = photon.propagate_step(big, geo, DrawPool(
        len(big), device, generator=make_generator(device, 3)))
    out = {}
    for name, fn in (('kernel', step_kernel.before_query),
                     ('plain', photon.step_prologue)):
        def run(w, fn=fn):
            sub = state.map(lambda a: a[:w])
            fn(sub, geo, DrawPool(w, device,
                                  generator=make_generator(device, 4)))
        run(1 << 11)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(1 << 11)
            torch.cuda.synchronize()
        events = prof.key_averages()
        aten = sum(e.count for e in events if e.key.startswith('aten::')
                   and e.device_type == torch.autograd.DeviceType.CPU)
        kernels = sum(e.count for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        ms, host = {}, {}
        for w in (1 << 11, len(state)):
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            for _ in range(COST_REPLAYS):
                run(w)
            host[w] = (time.perf_counter() - t0) * 1e3 / COST_REPLAYS
            e1.record()
            torch.cuda.synchronize()
            ms[w] = e0.elapsed_time(e1) / COST_REPLAYS
        out[name] = dict(aten_ops=aten, kernels=kernels, ms=ms,
                         enqueue_ms=host)
    out['n_blocks'] = step_kernel.n_blocks(geo)
    return out


def phase_replay_vs_eager(geometries, device, card):
    """Phase 12b: on each (name, arrays, source) of `geometries` (the
    quick detector; lartpc-wires, whose steps launch K3 too), the fused
    bomb of FUSED_CHECK photons from `source` by FIXED_SCHEDULE, every
    step eager and every step a graph replay (after its width's first,
    eager, step), same seed: every PhotonState field equal bit for bit,
    K1 and K2 (and K3) launched once a step either way (steps after the
    last lane died change nothing, and their number depends on how far
    the host runs ahead of the card). Returns the launches."""
    import torch
    from chroma_tpu_torch.ops import propagate as P
    total = collections.Counter()
    for label, arrays, source in geometries:
        geo = arrays.to(device)
        state = device_bomb(FUSED_CHECK, 121, device)
        state = state.replace(pos=state.pos + torch.tensor(
            source, dtype=torch.float32, device=device))
        runs = []
        # eager, then the graph route twice: its first bomb captures each
        # width after that width's first (eager) step, the second replays
        # every step (a lartpc photon lives a step or two)
        for mode in (False, True, True):
            fused_counters()
            ph, _, abort = P._fused_bomb(state, geo, (3, 1), FIXED_SCHEDULE,
                                         MAX_STEPS, use_graphs=mode)
            torch.cuda.synchronize()
            runs.append((ph, fused_stats()))
            assert not abort
        (eager, se), graphed = runs[0], runs[1:]
        for ph, _ in graphed:
            for name in ('pos', 'dir', 'pol', 'wavelength', 't', 'weight',
                         'flags', 'last_hit_triangle', 'evidx', 'cur_mat'):
                assert torch.equal(getattr(eager, name),
                                   getattr(ph, name)), \
                    '%s: replay differs from eager in %s' % (label, name)
        # a stage stops a few steps after its last lane died, as its poll
        # sees it: the faster graph route may run more of those no-op steps
        assert se['launches']['k1'] > 0 and se['replays'] == 0
        assert graphed[1][1]['replays'] > 0
        for _, sg in graphed:
            check_fused(sg, FIXED_SCHEDULE)
        for _, st in runs:
            assert st['launches']['k3'] == (st['launches']['k1']
                                            if geo.has_wireplanes else 0)
        log('phase 12b: %s, fused bomb of %d photons, schedule %s: graph '
            'replays equal eager steps bit for bit on every field; K1 / '
            'k2_pre / k2_post '
            '/ K3 launches %s eager, %s on the graph route (replays + eager '
            'steps before captures: %s), blocking reads %s (%s)' % (
                label, FUSED_CHECK, FIXED_SCHEDULE,
                launch_list(se['launches']),
                [launch_list(sg['launches']) for _, sg in graphed],
                ['%d + %d' % (sg['replays'], sg['captures'])
                 for _, sg in graphed],
                [sg['blocking_reads'] for _, sg in graphed], card))
        total += total_launches(st['launches'] for _, st in runs)
    return total


def route_bomb(sim, route, seed, cpu_frac, label):
    """One phase-5 bomb (2^20 photons, run_daq) through `sim` on `route`
    ('fused' or 'chunked', CHROMA_FUSED in this process), with the fused
    route's counters; the detected fraction against phase 5's CPU
    reference."""
    from chroma_tpu_torch.ops import propagate as P
    os.environ['CHROMA_FUSED'] = '1' if route == 'fused' else '0'
    try:
        sched = P.schedule_for(sim.gpu_geometry, N_BOMB, MAX_STEPS)
        probe = P._sched_lookup(sim.gpu_geometry, N_BOMB, MAX_STEPS) is None
        fused_counters()
        ev, wall, aborts, _, _ = run_main_path(sim, N_BOMB, seed)
        stats = fused_stats()
    finally:
        os.environ.pop('CHROMA_FUSED')
    assert aborts == 0
    frac = len(ev.flat_hits) / N_BOMB
    detected_fraction_check(frac, N_BOMB, cpu_frac, N_CHECK,
                            '%s detected fraction vs the CPU' % label)
    row = dict(route=route, wall_s=wall, detected_frac=frac, **stats)
    if route == 'fused':
        check_fused(stats, sched)
        row.update(kind='probe' if probe else 'tuned', schedule=sched,
                   stages=len(sched) + 1)
    log('  %s: %s' % (label, json.dumps(row)))
    return row


def phase_fused(quick_geo, quick, sim6, lk, cpu_frac, card):
    """Phase 12c-e: the fused route against the chunked one on one card,
    in turns. (c) the quick detector's phase-5 bomb: a probe (a fresh
    session and perf cache), then tuned and chunked bombs in turns, each
    with wall, schedule, stages, captures, replays, K1 launches, blocking
    reads and its detected fraction against phase 5's CPU reference;
    (d) quick-optics' bomb and (e) Likelihood.eval (nevals 1) on both
    routes in turns; (f) Likelihood.eval over MANY_EVENTS events, with
    the graphs cached and the device memory before and after. Returns
    (K1 launches by path, rows)."""
    import torch
    import chroma_tpu_torch
    from chroma_tpu_torch import perfcache
    from chroma_tpu_torch.ops import graphs
    from chroma_tpu_torch.ops import propagate as P
    log('phase 12: the fused bomb (static schedule, probe-tuned, CUDA '
        'graphs) against the chunked driver (%s)' % card)
    P._SCHED_CACHE.clear()
    perfcache._DISK.clear()
    os.environ['CHROMA_CACHE_DIR'] = os.path.join(
        os.environ['CHROMA_CACHE_DIR'], 'phase12')
    # one Simulation a route: the fused one's first bomb is the probe, its
    # second the first tuned bomb (its new widths captured), later ones warm
    sims = {route: chroma_tpu_torch.Simulation(
        quick_geo, seed=seed, device='cuda', geometry_arrays=quick)
        for route, seed in (('fused', 12), ('chunked', 13))}
    rows = []
    for i, route in enumerate(('fused', 'fused', 'chunked', 'fused',
                               'chunked', 'fused')):
        rows.append(route_bomb(sims[route], route, 200 + i, cpu_frac,
                               '12c %d %s' % (i, route)))
    assert rows[0]['kind'] == 'probe' and rows[1]['kind'] == 'tuned'
    launches = {'12c probe': rows[0]['launches'],
                '12c tuned': total_launches(r['launches'] for r in rows[1:]
                                            if r['route'] == 'fused'),
                '12c chunked': total_launches(r['launches'] for r in rows
                                              if r['route'] == 'chunked')}
    fused_w = [r['wall_s'] for r in rows[3:] if r['route'] == 'fused']
    chunk_w = [r['wall_s'] for r in rows if r['route'] == 'chunked']
    log('  quick bomb wall: probe %.3f s, first tuned %.3f s, warm tuned '
        '%s s, chunked %s s' % (rows[0]['wall_s'], rows[1]['wall_s'],
                                ['%.3f' % w for w in fused_w],
                                ['%.3f' % w for w in chunk_w]))

    optics = []
    for route in ('fused', 'chunked', 'chunked', 'fused'):
        os.environ['CHROMA_FUSED'] = '1' if route == 'fused' else '0'
        sched = P.schedule_for(sim6.gpu_geometry, N_BOMB, MAX_STEPS)
        try:
            fused_counters()
            ev, wall, aborts, _, _ = run_main_path(sim6, N_BOMB, 122)
            stats = fused_stats()
        finally:
            os.environ.pop('CHROMA_FUSED')
        assert aborts == 0 and stats['launches']['k1'] > 0
        if route == 'fused':
            check_fused(stats, sched)
        optics.append(dict(route=route, wall_s=wall,
                           detected=len(ev.flat_hits), **stats))
    log('phase 12d: quick-optics bomb by route, in turns: %s'
        % json.dumps(optics))
    launches['12d optics fused'] = total_launches(
        r['launches'] for r in optics if r['route'] == 'fused')
    launches['12d optics chunked'] = total_launches(
        r['launches'] for r in optics if r['route'] == 'chunked')

    nevals, nreps, ndaq = LIKELIHOOD
    lrows = []
    for route in ('fused', 'chunked', 'chunked', 'fused'):
        os.environ['CHROMA_FUSED'] = '1' if route == 'fused' else '0'
        try:
            fused_counters()
            nll, wall = timed(lambda: lk.eval(likelihood_gun(123), 1,
                                              nreps=nreps, ndaq=ndaq))
            stats = fused_stats()
        finally:
            os.environ.pop('CHROMA_FUSED')
        assert np.isfinite(nll.nominal_value) and stats['launches']['k1'] > 0
        lrows.append(dict(route=route, wall_s=wall,
                          propagations_s=nreps / wall,
                          nll=nll.nominal_value, **stats))
    log('phase 12e: Likelihood.eval (nevals 1, nreps %d, ndaq %d) by '
        'route, in turns: %s' % (nreps, ndaq, json.dumps(lrows)))
    launches['12e likelihood fused'] = total_launches(
        r['launches'] for r in lrows if r['route'] == 'fused')
    launches['12e likelihood chunked'] = total_launches(
        r['launches'] for r in lrows if r['route'] == 'chunked')

    # 12f: a fit's many events, each with its own photon count (the gun
    # gives every 10 MeV electron the same count, so each event keeps a
    # prefix of its own length, as a yield that fluctuates would), so
    # each probes and captures anew: the graph cache stays bounded
    def varied_events():
        for i, ev in enumerate(itertools.islice(likelihood_gun(124),
                                                MANY_EVENTS)):
            n = len(ev.photons_beg) - 97 * (i + 1)
            ev.photons_beg = ev.photons_beg[:n]
            yield ev

    geom = sim6.gpu_geometry
    torch.cuda.synchronize()
    before = dict(graphs=len(graph_cache(geom)),
                  allocated_mib=torch.cuda.memory_allocated() / 2 ** 20,
                  reserved_mib=torch.cuda.memory_reserved() / 2 ** 20)
    fused_counters()
    nll, wall = timed(lambda: lk.eval(varied_events(), MANY_EVENTS,
                                      nreps=1, ndaq=ndaq))
    stats = fused_stats()
    after = dict(graphs=len(graph_cache(geom)),
                 allocated_mib=torch.cuda.memory_allocated() / 2 ** 20,
                 reserved_mib=torch.cuda.memory_reserved() / 2 ** 20)
    many = dict(events=MANY_EVENTS, wall_s=wall,
                propagations_s=MANY_EVENTS / wall, nll=nll.nominal_value,
                max_graphs=graphs.MAX_GRAPHS, before=before, after=after,
                **stats)
    log('phase 12f: Likelihood.eval over %d events (nreps 1, ndaq %d), '
        'each a batch size of its own: %s' % (MANY_EVENTS, ndaq,
                                              json.dumps(many)))
    assert np.isfinite(nll.nominal_value) and stats['launches']['k1'] > 0
    assert stats['captures'] >= MANY_EVENTS
    assert after['graphs'] <= graphs.MAX_GRAPHS
    launches['12f likelihood many events'] = stats['launches']
    torch.cuda.synchronize()
    return launches, dict(quick=rows, optics=optics, likelihood=lrows,
                          many_events=many, card=card)


GRAPH_LAUNCHES = 20  # launches of one call a timing graph holds


def graphed(fn, launches=GRAPH_LAUNCHES):
    """fn() (one kernel launch through its wrapper) captured `launches`
    times in one CUDA graph: a callable that replays them all once. Timed
    by events around it and divided by `launches`, it gives the kernel's
    time on the card without the host's dispatch: the card runs the
    launches back to back, as in a step's graph, and the one replay's host
    call (Python, cudaGraphLaunch) overlaps them instead of preceding a
    lone kernel on an idle card."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return graph.replay


def time_graphed(fns, graphs_of, rounds=6):
    """time_turns over fns, where the names in `graphs_of` are graphed()
    callables: their medians are divided by GRAPH_LAUNCHES (ms a launch).
    Returns the medians by name."""
    med, _ = time_turns(fns, rounds)
    return {name: t / GRAPH_LAUNCHES if name in graphs_of else t
            for name, t in med.items()}


# phase 13's timed lanes: the widths phase 5's queries show the main paths
# launching (the likelihood's 2,048 to a bomb's first 2^20), and an odd
# width (no multiple of a block) where the kernels are held to their twins
STEP_WIDTHS = (1 << 11, 1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 18,
               1 << 19, 1 << 20)
ODD_WIDTH = (1 << 20) - 77
K2_BLOCKS = (64, 128, 256)      # k2_post's block sizes timed
# f32 operations of one stepping lane in K2 (the decode, bulk transport and
# a Fresnel boundary: counted from csrc/step_kernel.cu, an estimate); K3's
# per plane and per candidate wire (csrc/wire_walk.cu's note)
K2_OPS_LANE = 300
K3_OPS_PLANE, K3_OPS_WIRE = 70, 30
STATE_BYTES = 60    # a PhotonState lane's fields K2 reads and writes


def step_inputs(geo, state, seed, use_weights=False, scatter_first=0,
                prune=True):
    """What k2_post is given in a step, made as propagate_step makes it
    on the card: the prologue (k2_pre), K1 and (wire planes) K3."""
    from chroma_tpu_torch.ops import step_kernel, visit_kernel, wire_kernel
    from chroma_tpu_torch.ops.sample import DrawPool, make_generator
    dev = state.pos.device
    ph, active, blocks, pruned, limit = step_kernel.before_query(
        state, geo, DrawPool(len(state), dev,
                             generator=make_generator(dev, seed)),
        use_weights, prune)
    query = visit_kernel.traverse(geo.wide, ph.pos, ph.dir,
                                  ph.last_hit_triangle, mask=active,
                                  best_limit=limit)[:5]
    wires = wire_kernel.walk(ph.pos, ph.dir, geo, active) \
        if geo.has_wireplanes else None
    return ph, active, blocks, pruned, query, wires


def lanes_agree(label, got, ref):
    """k2_post against its plain twin, assert_same's rules for a step:
    integer fields equal and floats to RTOL (absolute floor RTOL of the
    field's scale) on every lane but at most 0.1% (an ulp of a division,
    of the complex arithmetic or of a transcendental can move a roulette
    draw across its threshold), those lanes printed. Returns (lanes that
    differ, max |diff| on the others)."""
    n = len(ref)
    agree = np.ones(n, bool)
    for name in ('flags', 'last_hit_triangle', 'cur_mat', 'evidx'):
        agree &= getattr(got, name).cpu().numpy() \
            == getattr(ref, name).cpu().numpy()
    err = 0.0
    fields = ('pos', 'dir', 'pol', 'wavelength', 't', 'weight')
    for name in fields:
        a = getattr(got, name).cpu().numpy().reshape(n, -1)
        b = getattr(ref, name).cpu().numpy().reshape(n, -1)
        atol = RTOL * max(float(np.abs(b).max()), 1.0)
        agree &= np.isclose(a, b, rtol=RTOL, atol=atol).all(axis=1)
    for name in fields:
        a = getattr(got, name).cpu().numpy().reshape(n, -1)[agree]
        b = getattr(ref, name).cpu().numpy().reshape(n, -1)[agree]
        err = max(err, float(np.abs(a - b).max(initial=0.0)))
    bad = np.flatnonzero(~agree)
    for i in bad[:5]:
        log('    %s lane %d differs: %s' % (label, i, {
            name: (getattr(got, name)[i].tolist(),
                   getattr(ref, name)[i].tolist())
            for name in ('flags', 'cur_mat', 'dir', 'weight')}))
    assert len(bad) <= 0.001 * n, '%s: %d lanes differ' % (label, len(bad))
    return len(bad), err


def prologue_agree(label, got, ref):
    """k2_pre against prologue_after_blocks: flags, active and pruned
    lanes must be equal; the lanes whose limit differs are counted, none
    beyond RTOL. Returns (lanes that differ, max |diff| of finite
    limits)."""
    import torch
    ph, active, _, pruned, limit = got
    rph, ractive, _, rpruned, rlimit = ref
    assert torch.equal(ph.flags, rph.flags), label + ': flags differ'
    assert torch.equal(active, ractive), label + ': active lanes differ'
    if rpruned is None:
        assert pruned is None
        return 0, 0.0
    assert torch.equal(pruned, rpruned), label + ': pruned lanes differ'
    a, b = limit.cpu().numpy(), rlimit.cpu().numpy()
    finite = np.isfinite(b)
    assert np.array_equal(finite, np.isfinite(a)), label
    np.testing.assert_allclose(a[finite], b[finite], rtol=RTOL)
    return (int((a[finite] != b[finite]).sum()),
            float(np.abs(a[finite] - b[finite]).max(initial=0.0)))


def k2_bound(active, pruned, wires):
    """The least ms of one k2_post launch: each lane's photon read and
    written (STATE_BYTES each way), its active byte (and pruned byte),
    its query (28 bytes: tri, dist, code, normal, instance; wires 16
    more), and on each stepping lane the three uniforms every stepping
    lane reads (absorption, scattering, forcing; the path's others are not
    counted, so the bound is a little low) -- against K2_OPS_LANE
    operations a stepping lane. Returns (ms, 'bytes' or 'operations')."""
    n = active.shape[0]
    stepping = int(active.sum())
    lane = 2 * STATE_BYTES + 1 + 28 + (pruned is not None) \
        + (16 if wires is not None else 0)
    nbytes = n * lane + 4 * 3 * stepping
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = stepping * K2_OPS_LANE / PEAK_F32_S * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def k2_pre_bound(n, prune):
    """The least ms of one k2_pre launch over n lanes: position and
    direction (24 bytes) and flags (4) read, flags and the active byte
    written; with pruning also the wavelength, the medium and two
    uniforms read (16) and the pruned byte and the limit written (5). A
    few operations a lane: bytes bound it."""
    lane = 24 + 4 + 4 + 1 + (16 + 5 if prune else 0)
    return n * lane / PEAK_BYTES_S * 1e3, 'bytes'


def k3_bound(windows, n):
    """The least ms of one K3 launch over n rays: 41 bytes a ray (ray in,
    mask, (t, plane, vn, nn) out) against K3_OPS_PLANE operations a plane
    and K3_OPS_WIRE a candidate wire (`windows`, per plane, this run's)."""
    ops = K3_OPS_PLANE * len(windows) * n \
        + K3_OPS_WIRE * sum(int(w[:n].sum()) for w in windows)
    t_bytes = 41 * n / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_S * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def cut(t, w):
    "The first w lanes of a lane tensor (None stays None)."
    return None if t is None else t[:w].contiguous()


def cut_args(args, w):
    """k2_post's arguments (photons, geometry, blocks, active, pruned,
    query, wires) cut to their first w lanes."""
    ph, geo, blocks, active, pruned, query, wires = args
    return (ph.map(lambda t: cut(t, w)), geo, blocks[:, :w].contiguous(),
            cut(active, w), cut(pruned, w), tuple(cut(t, w) for t in query),
            None if wires is None else tuple(cut(t, w) for t in wires))


def time_step_kernels(label, geo, ph, active, blocks, pruned, query, wires,
                      card):
    """k2_pre and k2_post at each STEP_WIDTHS on the first lanes of one
    step's inputs, in turns: k2_post at each K2_BLOCKS, each a launch of a
    GRAPH_LAUNCHES-launch graph; k2_post through its wrapper; its plain
    twin; k2_pre graphed and its plain twin (prologue_after_blocks).
    Returns {width: row}."""
    from chroma_tpu_torch.ops import photon, step_kernel
    prune = pruned is not None
    rows = {}
    for w in STEP_WIDTHS:
        args = cut_args((ph, geo, blocks, active, pruned, query, wires), w)
        pre = (args[0], geo, args[2], prune)
        fns = {}
        for b in K2_BLOCKS:
            fns['B=%d' % b] = graphed(
                lambda a=args, b=b: step_kernel.launch(*a, block=b))
        fns['k2_pre'] = graphed(lambda a=pre: step_kernel.launch_pre(*a))
        graphs_of = tuple(fns)
        fns['wrapper'] = lambda a=args: step_kernel.launch(*a)
        fns['plain'] = lambda a=args: step_kernel.after_query_plain(*a)
        fns['k2_pre plain'] = lambda a=pre: photon.prologue_after_blocks(*a)
        med = time_graphed(fns, graphs_of)
        bound, by = k2_bound(args[3], args[4], args[6])
        pre_bound, pre_by = k2_pre_bound(w, prune)
        block = step_kernel.block_for(w, len(geo.surfaces.models_present))
        rows[w] = dict(
            ms=med['B=%d' % block], block=block,
            by_block={b: med['B=%d' % b] for b in K2_BLOCKS},
            eager_ms=med['wrapper'], plain_ms=med['plain'],
            bound_ms=bound, bound_by=by,
            pre=dict(ms=med['k2_pre'], plain_ms=med['k2_pre plain'],
                     bound_ms=pre_bound, bound_by=pre_by))
        log('  %s, %7d lanes: k2_post %s ms by block (the wrapper\'s B=%d; '
            'a launch of a %d-launch graph), through the wrapper %.4f ms, '
            'plain twin %.3f ms, bound %.5f ms (%s), %.2f%% of it; k2_pre '
            '%.4f ms, plain twin %.3f ms, bound %.5f ms (%s), %.2f%% of it '
            '(%s)' % (
                label, w, ', '.join('%d: %.4f' % (b, med['B=%d' % b])
                                    for b in K2_BLOCKS), block,
                GRAPH_LAUNCHES, med['wrapper'],
                med['plain'], bound, by, 100.0 * bound / rows[w]['ms'],
                med['k2_pre'], med['k2_pre plain'], pre_bound, pre_by,
                100.0 * pre_bound / med['k2_pre'], card))
    return rows


def phase_step_kernels(cases, lartpc_ga, device, card):
    """Phase 13: K2 (k2_pre, k2_post) and K3 against their plain twins on
    the card, and timed.

    K2: on each (label, arrays, source, options, steps before) of
    `cases`, a 2^20-photon bomb from `source` stepped that many times on
    the card (media known, lanes on surfaces; a lartpc photon lives a
    step or two). k2_pre (step_kernel.before_query) against
    photon.step_prologue with the same generator: prologue_agree. Then
    one step's inputs (k2_pre, K1, K3) given to k2_post and to
    step_kernel.after_query_plain: lanes_agree at 2^20 and at ODD_WIDTH.
    K3: the 2^20 rays of phase 7's bomb (300 mm below the lartpc planes)
    against wireplane.walk_plain: planes and floats equal. The cases
    without options are timed (time_step_kernels), and K3 at STEP_WIDTHS,
    beside their bounds. Returns the
    kernels' rows."""
    import torch
    from chroma_tpu_torch.ops import photon, step_kernel, wire_kernel
    from chroma_tpu_torch.ops import wireplane
    from chroma_tpu_torch.ops.sample import DrawPool, make_generator
    k2_err, k2_bad, pre_err, pre_bad, timed = 0.0, 0, 0.0, 0, {}
    for label, arrays, source, opts, before in cases:
        geo = arrays.to(device)
        state = device_bomb(N_BOMB, 130, device)
        state = state.replace(pos=state.pos + torch.tensor(
            source, dtype=torch.float32, device=device))
        for s in range(before):
            state = photon.propagate_step(state, geo, DrawPool(
                N_BOMB, device, generator=make_generator(device, 131, s)))
        prune = opts.get('scatter_first', 0) == 0
        popts = dict(use_weights=opts.get('use_weights', False),
                     prune=prune)
        got = step_kernel.before_query(state, geo, DrawPool(
            N_BOMB, device, generator=make_generator(device, 133)), **popts)
        ref = photon.step_prologue(state, geo, DrawPool(
            N_BOMB, device, generator=make_generator(device, 133)), **popts)
        pbad, perr = prologue_agree(label, got, ref)
        pre_bad, pre_err = pre_bad + pbad, max(pre_err, perr)
        ph, active, blocks, pruned, query, wires = step_inputs(
            geo, state, (132,), prune=prune, **opts)
        args = (ph, geo, blocks, active, pruned, query, wires)
        got = step_kernel.after_query(*args, **opts)
        ref = step_kernel.after_query_plain(*args, **opts)
        odd = cut_args(args, ODD_WIDTH)
        got_odd = step_kernel.after_query(*odd, **opts)
        ref_odd = step_kernel.after_query_plain(*odd, **opts)
        torch.cuda.synchronize()
        bad, err = lanes_agree(label, got, ref)
        bad_odd, err_odd = lanes_agree(label + ' odd', got_odd, ref_odd)
        k2_bad += bad + bad_odd
        k2_err = max(k2_err, err, err_odd)
        log('phase 13: K2 against its plain twins, %s (models %s, %s), %d '
            'lanes (%d stepping): k2_pre against step_prologue: flags, '
            'active and pruned lanes equal, %d limits differ (max |diff| '
            '%.3g); k2_post: %d lanes differ (at most 0.1%%), max |diff| on '
            'the others %.3g; at %d lanes %d differ, max |diff| %.3g' % (
                label, geo.surfaces.models_present, opts or 'plain',
                N_BOMB, int(active.sum()), pbad, perr, bad, err,
                ODD_WIDTH, bad_odd, err_odd))
        if not opts:
            timed[label] = time_step_kernels(label, geo, ph, active, blocks,
                                             pruned, query, wires, card)

    geo = lartpc_ga.to(device)
    np.random.seed(11)
    from chroma_tpu_torch.generator import photon_bomb
    bomb = photon_bomb(N_BOMB, 400.0, (0.0, 0.0, -300.0))
    pos = torch.from_numpy(bomb.pos.astype(np.float32)).to(device)
    d = torch.from_numpy(bomb.dir.astype(np.float32)).to(device)
    active = torch.ones(N_BOMB, dtype=torch.bool, device=device)
    table = wire_kernel.planes(geo)
    got = wire_kernel.launch(pos, d, table, active)
    ref = wireplane.walk_plain(pos, d, geo, active)
    got_odd = wire_kernel.launch(pos[:ODD_WIDTH], d[:ODD_WIDTH], table,
                                 active[:ODD_WIDTH])
    torch.cuda.synchronize()
    for a, c, e in zip(got, ref, got_odd):
        assert torch.equal(a, c), 'K3 differs'
        assert torch.equal(e, c[:ODD_WIDTH]), 'K3 differs at the odd width'
    hit = ref[1] >= 0
    windows = wireplane.candidate_windows(pos, d, geo, active)
    log('phase 13: K3 against its plain twin, %d lartpc rays: %d hit a wire, '
        'planes and t, vn, nn equal bit for bit (at %d rays too); candidate '
        'wires a plane %s' % (
            N_BOMB, int(hit.sum()), ODD_WIDTH,
            [int(w.sum()) for w in windows]))
    k3_rows = {}
    for w in STEP_WIDTHS:
        args = (pos[:w].contiguous(), d[:w].contiguous(), table, active[:w])
        med = time_graphed({
            'K3': graphed(lambda a=args: wire_kernel.launch(*a)),
            'wrapper': lambda a=args: wire_kernel.launch(*a)},
            ('K3',))
        bound, by = k3_bound(windows, w)
        k3_rows[w] = dict(ms=med['K3'], eager_ms=med['wrapper'],
                          plain_ms=None, bound_ms=bound, bound_by=by)
        if w == N_BOMB:
            # the plain twin's lockstep loop takes over a second a call:
            # timed at the widest only
            k3_rows[w]['plain_ms'] = time_turns({'plain': lambda: (
                wireplane.walk_plain(pos, d, geo, active))}, rounds=2)[0][
                    'plain']
        log('  K3, %7d rays: %.4f ms (a launch of a %d-launch graph), '
            'through the wrapper %.4f ms, plain twin %s, bound %.5f ms '
            '(%s), %.2f%% of it (%s)' % (
                w, med['K3'], GRAPH_LAUNCHES, med['wrapper'],
                'not timed' if k3_rows[w]['plain_ms'] is None
                else '%.3f ms' % k3_rows[w]['plain_ms'], bound, by,
                100.0 * bound / med['K3'], card))
    return dict(k2=dict(max_abs_err=k2_err, lanes_differing=k2_bad,
                        times=timed),
                k2_pre=dict(max_abs_err=pre_err, lanes_differing=pre_bad),
                k3=dict(max_abs_err=0.0, times=k3_rows))


def main_path_loss(widths, times, key=None):
    """Milliseconds a main path loses to a kernel against its bound: the
    launches at each width (`widths`, {lanes: launches}) times (the
    kernel's time - its bound) at the nearest timed width (log scale; a
    timed row's key `key` holds the times where given). Returns (ms,
    launches counted)."""
    timed = sorted(times)
    total, count = 0.0, 0
    for w, k in widths.items():
        near = min(timed, key=lambda t: abs(np.log2(t) - np.log2(int(w))))
        row = times[near] if key is None else times[near][key]
        total += int(k) * (row['ms'] - row['bound_ms'])
        count += int(k)
    return total, count


def daq_photons(ends, n, device):
    """n end states for a readout: phase 5's, repeated as needed, on the
    card."""
    from chroma_tpu_torch.ops.propagate import photon_state_from_host
    state = photon_state_from_host(ends, device)
    reps = -(-n // len(state))
    return state.map(lambda a: a.repeat(
        (reps,) + (1,) * (a.dim() - 1))[:n].contiguous())


def k4_bytes(ph, ga, draws, ndaq, global_weight=1.0):
    """The bytes a readout of `draws` (ops.daq.daq_draws) must move, in
    32-byte sectors, and its kept (replica, photon) pairs: every photon's
    last triangle and flags; the time and weight of each detected one;
    each detected pair's keep draw and each kept pair's time and charge
    draws; the (ndaq * C,) earliest times, charges and histories
    written."""
    import torch
    from chroma_tpu_torch.ops import daq
    n = len(ph)
    rows = draws.shape[2]

    def sectors(idx):       # distinct sectors of 4-byte elements at idx
        return int(torch.unique(idx // 8).numel())

    det = torch.nonzero(daq.photon_channels_device(ph, ga) >= 0).flatten()
    total = 2 * sectors(torch.arange(n, device=det.device)) \
        + 2 * sectors(det)
    keep_below = ph.weight[det] * global_weight
    site = rows * n
    kept_pairs = 0
    for r in range(ndaq):
        b, row = divmod(r, rows)
        base = (3 * b * rows + row) * n
        kept = det[(1.0 - draws[b, 0, row, det]) < keep_below]
        kept_pairs += len(kept)
        total += sectors(base + det) + sectors(base + site + kept) \
            + sectors(base + 2 * site + kept)
    total += 3 * -(-ndaq * ga.detector.nchannels // 8)
    return 32 * total, kept_pairs


def phase_daq_kernel(ga, ends, device, card):
    """Phase 14: K4 (init, K4 and finish as ops.daq_kernel.readout
    launches them) against its plain twin readout_plain on the card at
    DAQ_SHAPES, phase 5's end states read out: earliest times, charges and
    histories equal bit for bit, and run_daq's generator path equal to the
    twin fed one torch.rand a block and site. Timed in turns: the readout
    as a launch of a 20-launch graph, the twin and the whole of run_daq
    (the draws' fills, the readout) eagerly, each beside the bound of the
    bytes the readout must move (k4_bytes) over PEAK_BYTES_S. Returns the
    rows by shape."""
    import torch
    from chroma_tpu_torch.ops import daq, daq_kernel
    log('phase 14: K4 (the DAQ readout) against its plain twin, timed')
    rows = {}
    for ndaq, n in DAQ_SHAPES:
        ph = daq_photons(ends, n, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(2 ** 35 + n + ndaq)
        draws = daq.daq_draws(n, ndaq, device, gen)
        got = daq.ChannelArrays(*daq_kernel.readout(ph, ga, draws, ndaq))
        ref = daq.readout_plain(ph, ga, draws, ndaq)
        gen.manual_seed(7)
        by_gen = daq.run_daq(ph, ga, gen, ndaq=ndaq)
        gen.manual_seed(7)
        nrow = min(ndaq, daq.DAQ_BLOCK)
        old = torch.stack([torch.stack([
            torch.rand((nrow, n), generator=gen, device=device)
            for _ in range(3)]) for _ in range(-(-ndaq // daq.DAQ_BLOCK))])
        old = daq.readout_plain(ph, ga, old, ndaq)
        for name in ('earliest_time', 'charge', 'histories'):
            for a, b in ((got, ref), (by_gen, old)):
                assert torch.equal(getattr(a, name).view(torch.int32),
                                   getattr(b, name).view(torch.int32)), \
                    '%s differs at (%d, %d)' % (name, ndaq, n)
        detected = int((daq.photon_channels_device(ph, ga) >= 0).sum())
        hit = int((ref.earliest_time < daq.HIT_TIME_CUT).sum())
        times = time_graphed({
            'k4': graphed(lambda: daq_kernel.readout(ph, ga, draws, ndaq)),
            'plain': lambda: daq.readout_plain(ph, ga, draws, ndaq),
            'run_daq': lambda: daq.run_daq(ph, ga, gen, ndaq=ndaq)}, {'k4'})
        nbytes, kept = k4_bytes(ph, ga, draws, ndaq)
        bound = nbytes / PEAK_BYTES_S * 1e3
        rows['%dx%d' % (ndaq, n)] = row = dict(
            ndaq=ndaq, photons=n, detected=detected, kept_pairs=kept,
            slots_hit=hit, ms=times['k4'], plain_ms=times['plain'],
            run_daq_ms=times['run_daq'], bytes=nbytes, bound_ms=bound,
            bound_by='bytes', bound_share=bound / times['k4'])
        log('  %d replicas x %d photons (%d detected, %d pairs kept, %d of '
            '%d slots hit): K4 %.4f ms (graphed), twin %.3f ms, run_daq '
            '%.3f ms, bound %.4f ms (%d bytes in sectors, %.1f%%); equal to '
            'the twin bit for bit, the generator path to the per-block '
            'draws (%s)' % (
                ndaq, n, detected, kept, hit, ndaq * ga.detector.nchannels,
                row['ms'], row['plain_ms'], row['run_daq_ms'], bound,
                nbytes, 100.0 * row['bound_share'], card))
    return rows


def daq_kernel_calls(sim, lk, card):
    """K4's launches (cuda_build's count, from 0 just before) and
    run_daq's calls (its daq.run spans) on each of two main paths: a
    Likelihood.eval as the benchmark's likelihood makes it (4 trial
    vertices x 16 reps x 50 replicas, 64 readouts) and an N_BOMB-photon
    quick bomb (one event, one readout). Both equal, path by path;
    returns them by path."""
    from chroma_tpu_torch.profiler import profiler
    paths = {
        'likelihood eval 4 x 16 x 50': (64, lambda: lk.eval(
            likelihood_gun(19), 4, nreps=16, ndaq=50)),
        'bomb %d' % N_BOMB: (1, lambda: run_main_path(sim, N_BOMB, 21))}
    out = {}
    profiler.enabled = True
    try:
        for name, (want, run) in paths.items():
            profiler.reset()
            zero_launches()
            run()
            out[name] = dict(k4_launches=launches_now()['k4'],
                             run_daq_calls=profiler.regions['daq.run'].calls)
            assert set(out[name].values()) == {want}, (name, out[name])
    finally:
        profiler.enabled = False
        profiler.reset()
    log('  K4 launches and run_daq calls by path: %s (%s)'
        % (json.dumps(out), card))
    return out


def daq_row(k4, launches, per_path):
    """K4's entry of the `kernels` line: its launches on the main paths
    (phases 5 to 12, `per_path`), a call of each path phase 14 counts, and
    its times at each of DAQ_SHAPES."""
    big = k4['shapes']['%dx%d' % DAQ_SHAPES[-1]]
    return {'name': 'daq', 'route': 'cuda',
            'source': 'chroma_tpu_torch/csrc/daq_kernel.cu',
            'replaces': 'chroma_tpu/ops/daq.py:70',
            'launches': launches, 'launches_per_path': per_path,
            'launches_per_call': {k: v['k4_launches'] for k, v in
                                  k4['kernel_calls'].items()},
            'max_abs_err': 0.0,
            'lanes': big['photons'], 'ms': big['ms'],
            'plain_ms': big['plain_ms'], 'bound_ms': big['bound_ms'],
            'bound_by': big['bound_by'], 'bound_share': big['bound_share'],
            'library_ms': None, 'by_shape': k4['shapes']}


def main(argv, work):
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available: chip_smoke.py needs an '
                           'NVIDIA GPU')
    # the port itself; in a directory without the repository this fails
    import chroma_tpu_torch
    from chroma_tpu_torch.ops import mesh_wide, visit_kernel
    out_dir = os.path.abspath(argv[argv.index('--out') + 1]) \
        if '--out' in argv else os.path.join(work, 'frames')
    os.makedirs(out_dir, exist_ok=True)
    device = torch.device('cuda', 0)
    # the port's caches (the perf cache's tuned schedules among them) go
    # with the scratch files; the ranks of phase 11 inherit it
    os.environ['CHROMA_CACHE_DIR'] = os.path.join(work, 'cache')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- 0. card and software
    card = card_line()
    log('phase 0: card:', card)
    log('  torch %s, CUDA %s, %s, %d device(s)' % (
        torch.__version__, torch.version.cuda,
        torch.cuda.get_device_name(0), torch.cuda.device_count()))

    # --- 1. build, all at once
    from chroma_tpu_torch import native
    from chroma_tpu_torch.ops import daq_kernel, step_kernel, wire_kernel
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        jobs = [pool.submit(mod.library.load) for mod in (
            visit_kernel, step_kernel, wire_kernel, daq_kernel)]
        jobs.append(pool.submit(native.available))
        kit = [job.result() for job in jobs][-1]
    log('phase 1: built %s, %s, %s, %s and %s (%s) in %.1f s' % (
        os.path.relpath(visit_kernel.SOURCE),
        os.path.relpath(step_kernel.SOURCE),
        os.path.relpath(wire_kernel.SOURCE),
        os.path.relpath(daq_kernel.SOURCE),
        os.path.relpath(native.SOURCE),
        'loaded' if kit else 'unavailable: numpy paths',
        time.perf_counter() - t0))
    assert kit, 'the host geometry kit did not build'
    for name, mod in (('K1', visit_kernel), ('K2', step_kernel),
                      ('K3', wire_kernel), ('K4', daq_kernel)):
        log('  ptxas %s: %s' % (name,
                                ptxas_summary(mod.library.build_log)))

    # --- 2. kernel vs plain on the card
    log('phase 2: visit kernel vs plain traversal on the card')
    # one ray set under the persistent schedule's threshold, one at it
    sizes = (N_SMALL, visit_kernel.PERSISTENT_MIN_RAYS)
    max_err = 0.0
    for fmt in FORMATS:
        for n in sizes:
            max_err = max(max_err, compare_kernel(
                'fixture/' + fmt, fixture_table(fmt).to(device),
                ray_mix(n, 1, None, device)))
    tiny_geo, tiny = detector_arrays((2000.0, 2500.0, 700.0), work)
    quick_geo, quick = detector_arrays(QUICK, work)
    quick_tables = detector_tables(quick_geo, quick, device)
    for name, tables, seed, radius in (
            ('tiny', detector_tables(tiny_geo, tiny, device), 2, 1800.0),
            ('quick', quick_tables, 3, 3600.0)):
        for fmt, table in tables.items():
            for n in sizes:
                max_err = max(max_err, compare_kernel(
                    '%s/%s' % (name, fmt), table,
                    ray_mix(n, seed, radius, device)))

    # --- 3. propagation steps, card against CPU
    log('phase 3: propagate_step on the card (kernel) vs the CPU (plain)')
    compare_steps(quick, device, N_CHECK, 3)

    # --- 4. K1's times: rays of a bomb's first query from the centre
    k1, err = phase_k1_times(quick_tables, device, card)
    max_err = max(max_err, err)

    # --- 5. the main path
    log('phase 5: Simulation(quick detector, device=cuda), %d photons, '
        'run_daq=True' % N_BOMB)
    sim = chroma_tpu_torch.Simulation(quick_geo, seed=0, device='cuda',
                                      geometry_arrays=quick)
    torch.cuda.reset_peak_memory_stats()
    ev, wall, aborts, launches, widths5 = run_main_path(sim, N_BOMB, 5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    hits = ev.flat_hits
    nhit_ch = int(ev.channels.hit.sum())
    log('  wall %.3f s, %.0f photons/s, detected %d, channels hit %d of '
        '%d, NaN aborts %d, visit-kernel launches %d, peak device memory '
        '%.0f MiB (%s)' % (wall, N_BOMB / wall, len(hits), nhit_ch,
                           len(ev.channels.hit), aborts, launches['k1'], peak,
                           card))
    assert launches['k1'] > 0, 'the main path launched no visit kernel'
    assert launches['k4'] == 1, 'one event read out by %d K4 launches' \
        % launches['k4']
    assert len(hits) > 0 and aborts == 0
    assert len(ev.photons_end) == N_BOMB
    for name in ('pos', 'dir', 't'):
        assert np.isfinite(getattr(hits, name)).all(), name
    assert np.isfinite(ev.channels.t[ev.channels.hit]).all()
    assert nhit_ch == len(ev.hits) and (hits.flags & 4).all()

    # the same path on the CPU (plain traversal) at 65,536 photons
    cpu_sim = chroma_tpu_torch.Simulation(quick_geo, seed=1, device='cpu',
                                          geometry_arrays=quick)
    cev, cwall, caborts, _, _ = run_main_path(cpu_sim, N_CHECK, 6)
    assert caborts == 0
    log('  CPU reference: %d photons in %.1f s, detected %d' % (
        N_CHECK, cwall, len(cev.flat_hits)))
    detected_fraction_check(len(hits) / N_BOMB, N_BOMB,
                            len(cev.flat_hits) / N_CHECK, N_CHECK,
                            'detected fraction, card vs CPU')

    # --- 6.-8. the full optics, wire planes and the likelihood path
    geo6, ga6, sim6, launches6, _ = phase_quick_optics(device, card)
    launches7, lartpc, lartpc_ga = phase_lartpc(device, card)
    launches8, widths8, lk = phase_likelihood(geo6, ga6, sim6, card)

    # --- 9. the user entry points
    loaded, geocache_s = phase_geocache(quick, device, work, card)
    launches9b, launches9c, wall9b, pair9b = phase_device_source(
        quick_geo, loaded, device, card, (len(hits) / N_BOMB, wall))
    launches9d, wall_track, wall_plain = phase_tracking(quick_geo, loaded,
                                                        card)
    launches9e, launches9e_prof = phase_cli(work, card)

    # --- 10. the renderer and the viewer
    camera_k1, err = phase_camera_rays(quick_geo, quick_tables['bf16'],
                                       device, card)
    max_err = max(max_err, err)
    quick_dev = quick.to(device)
    launches10c, wall10c, frame_ms = phase_render(
        quick_geo, quick, quick_dev, device, card, out_dir)
    launches10d, launches10h, wall10h = phase_viewer(
        quick_geo, quick_dev, tiny_geo, ev, device, card, work)
    launches10e, wall10e, inner10e = phase_render_tools(work, card,
                                                        out_dir)
    launches10f = phase_gdml(device, card, work)

    # --- 11. photon sharding over the ranks of a process group
    launches11, sharded = phase_sharded(loaded, work, card,
                                        (len(hits) / N_BOMB, wall))

    # --- 12. the fused bomb: cost model, replay vs eager, routes in turns
    cost = phase_cost_model(quick, device, card)
    launches12b = phase_replay_vs_eager(
        [('quick', quick, (0.0, 0.0, 0.0)),
         ('lartpc-wires', lartpc_ga, (0.0, 0.0, -300.0))], device, card)
    launches12, fused = phase_fused(quick_geo, quick, sim6, lk,
                                    len(cev.flat_hits) / N_CHECK, card)

    # --- 13. K2 and K3 against their plain twins, timed
    twins = phase_step_kernels(
        [('quick', quick, (0.0, 0.0, 0.0), {}, 2),
         ('quick-optics', ga6, (0.0, 0.0, 0.0), {}, 2),
         ('quick-optics weights', ga6, (0.0, 0.0, 0.0),
          {'use_weights': True}, 2),
         ('quick-optics scatter_first 1', ga6, (0.0, 0.0, 0.0),
          {'scatter_first': 1}, 2),
         ('quick-optics scatter_first -1', ga6, (0.0, 0.0, 0.0),
          {'scatter_first': -1}, 2),
         ('lartpc-wires', lartpc_ga, (0.0, 0.0, -300.0), {}, 0)],
        lartpc_ga, device, card)

    # --- 14. K4 against its plain twin, timed; its calls counted
    k4 = dict(shapes=phase_daq_kernel(quick_dev, ev.photons_end, device,
                                      card),
              kernel_calls=daq_kernel_calls(sim, lk, card))

    per_phase = {'5 quick': launches, '6 quick-optics': launches6,
                 **launches7, '8 likelihood': launches8,
                 '9b device source': launches9b, '9c facade': launches9c,
                 '9d tracking': launches9d, '9e cli sim': launches9e,
                 '9e cli profile': launches9e_prof,
                 '10c render': launches10c, '10d viewer': launches10d,
                 '10d hybrid': launches10h, '10e cli cam': launches10e,
                 '10f gdml': launches10f, '11 sharded': launches11,
                 '12b replay vs eager': launches12b, **launches12}
    k1_per_phase = {k: v['k1'] for k, v in per_phase.items()}
    log('visit-kernel launches per main path: %s'
        % json.dumps(k1_per_phase))
    log('K1, k2_pre, k2_post, K3, K4 launches per main path: %s'
        % json.dumps({k: launch_list(v) for k, v in per_phase.items()}))
    total = total_launches(per_phase.values())
    assert min(total[k] for k in ('k2_pre', 'k2_post', 'k3', 'k4')) > 0

    # what each main path loses to a kernel against its bound: its steps
    # by width (phase 5's quick bomb, phase 7's first tuned lartpc bomb,
    # phase 8's Likelihood.eval) times (time - bound) at that width
    lartpc_widths = next(r['widths'] for r in lartpc
                         if r.get('kind') == 'tuned')
    paths = {'5 quick': widths5,
             '7 lartpc-wires tuned': lartpc_widths,
             '8 likelihood eval': widths8}
    k2_times = twins['k2']['times']
    # K1 at phase 4's sweep of ray counts (traverse's choice, graphed),
    # its bound there the 2^20 rays' operations scaled by the rays (the
    # visits a ray, about 9.1, do not depend on the count), and at 10^4
    # rays its own
    k1_times = {n: dict(ms=t, bound_ms=k1[N_TIME]['bound_ms'] * n / N_TIME)
                for n, t in k1['sweep'].items()}
    k1_times[N_SMALL]['bound_ms'] = k1[N_SMALL]['bound_ms']
    losses = {
        'K1': {'5 quick': main_path_loss(paths['5 quick'], k1_times),
               '8 likelihood eval': main_path_loss(
                   paths['8 likelihood eval'], k1_times)},
        'k2_pre': {'5 quick': main_path_loss(paths['5 quick'],
                                             k2_times['quick'], 'pre'),
                   '8 likelihood eval': main_path_loss(
                       paths['8 likelihood eval'],
                       k2_times['quick-optics'], 'pre')},
        'k2_post': {'5 quick': main_path_loss(paths['5 quick'],
                                              k2_times['quick']),
                    '7 lartpc-wires tuned': main_path_loss(
                        lartpc_widths, k2_times['lartpc-wires']),
                    '8 likelihood eval': main_path_loss(
                        paths['8 likelihood eval'],
                        k2_times['quick-optics'])},
        'K3': {'7 lartpc-wires tuned': main_path_loss(
            lartpc_widths, twins['k3']['times'])}}
    log('main-path loss, ms (launches counted) of each kernel against its '
        'bound, by path: %s; the paths\' steps by lanes: %s' % (
            json.dumps(losses), json.dumps({k: {str(w): c for w, c in
                                                sorted(v.items())}
                                            for k, v in paths.items()})))

    big, small = k1[N_TIME], k1[N_SMALL]
    log(json.dumps({'entry_points': dict(
        geocache_s=geocache_s, device_source_s=wall9b, phase5_s=wall,
        same_photons_s=pair9b, tracked_s=wall_track,
        untracked_s=wall_plain, frame_s=wall10c, frame_ms=frame_ms,
        hybrid_s=wall10h,
        cli_cam_s=wall10e, cli_cam_tool_s=inner10e, sharded=sharded,
        card=card)}))
    log(json.dumps({'fused': dict(cost_model=cost, lartpc=lartpc,
                                  **fused)}))
    quick = k2_times['quick']
    pre_times = {w: r['pre'] for w, r in quick.items()}
    log(json.dumps({'kernels': [{
        'name': 'visit_inst',
        'route': 'cuda',
        'source': 'chroma_tpu_torch/csrc/visit_kernel.cu',
        'replaces': 'chroma_tpu/ops/visit_kernel.py:109',
        'launches': total['k1'],
        'launches_per_path': k1_per_phase,
        'max_abs_err': max_err,
        'rays': N_TIME,
        'ms': big['ms'],
        'plain_ms': big['plain_ms'],
        'bound_ms': big['bound_ms'],
        'bound_by': big['bound_by'],
        'bound_share': big['bound_ms'] / big['ms'],
        'library_ms': None,
        'rays_small': N_SMALL,
        'ms_small': small['ms'],
        'eager_ms_small': small['eager_ms'],
        'plain_ms_small': small['plain_ms'],
        'bound_ms_small': small['bound_ms'],
        'bound_share_small': small['bound_ms'] / small['ms'],
        'rays_camera': camera_k1['rays'],
        'ms_camera': camera_k1['ms'],
        'plain_ms_camera': camera_k1['plain_ms'],
        'bound_ms_camera': camera_k1['bound_ms'],
        'bound_by_camera': camera_k1['bound_by'],
        'bound_share_camera': camera_k1['bound_ms'] / camera_k1['ms'],
        'main_path_loss_ms': {k: v[0] for k, v in losses['K1'].items()},
        'by_rays': {str(n): t for n, t in k1_times.items()},
    }, kernel_row('k2_pre', 'step_kernel.cu',
                  'chroma_tpu/ops/photon.py:1106', total['k2_pre'],
                  {k: v['k2_pre'] for k, v in per_phase.items()},
                  twins['k2_pre'], pre_times, losses['k2_pre']),
        kernel_row('k2_post', 'step_kernel.cu',
                   'chroma_tpu/ops/photon.py:1086', total['k2_post'],
                   {k: v['k2_post'] for k, v in per_phase.items()},
                   twins['k2'],
                   quick, losses['k2_post']),
        kernel_row('wire_walk', 'wire_walk.cu',
                   'chroma_tpu/ops/wireplane.py:151', total['k3'],
                   {k: v['k3'] for k, v in per_phase.items() if v['k3']},
                   twins['k3'], twins['k3']['times'], losses['K3']),
        daq_row(k4, total['k4'],
                {k: v['k4'] for k, v in per_phase.items() if v['k4']})]}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


def kernel_row(name, source, replaces, launches, per_path, twin, times,
               losses):
    """A kernel's entry of the `kernels` line: launches on the main paths,
    its time, its plain twin's and its bound at 2^20
    lanes (phase 13), the other widths timed, and what each main path
    loses to it (main_path_loss)."""
    big = times[N_BOMB]
    return {'name': name, 'route': 'cuda',
            'source': 'chroma_tpu_torch/csrc/' + source,
            'replaces': replaces, 'launches': launches,
            'launches_per_path': per_path,
            'max_abs_err': twin['max_abs_err'], 'lanes': N_BOMB,
            'ms': big['ms'], 'plain_ms': big['plain_ms'],
            'bound_ms': big['bound_ms'], 'bound_by': big['bound_by'],
            'bound_share': big['bound_ms'] / big['ms'], 'library_ms': None,
            'main_path_loss_ms': {k: v[0] for k, v in losses.items()},
            'by_lanes': {str(w): t for w, t in times.items()}}


if __name__ == '__main__':
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as workdir:
        main(sys.argv[1:], workdir)
