"""Stage profiling driver (the torch port's counterpart of
bin/chroma-profile):

    python -m chroma_tpu_torch.cli.profile [DETECTOR] [-p P] [-n N]
        [--trace DIR] [--visits] [--daq] [--device cuda|cpu]

Runs photon bombs through a detector with the profiler enabled and prints
stage timings, the driver's counters and throughput. --trace writes a
torch.profiler Chrome trace; --visits reports the visit kernel's BVH
visits by node kind for one bomb's first query.
"""
import argparse
import os
import sys
import time


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Profile photon propagation stages.')
    parser.add_argument('detector', nargs='?',
                        default='@chroma_tpu_torch.demo.tiny',
                        help='geometry string (default: demo tiny detector)')
    parser.add_argument('-p', '--photons', type=int, default=262144)
    parser.add_argument('-n', '--events', type=int, default=3)
    parser.add_argument('--max-steps', type=int, default=100)
    parser.add_argument('--step-chunk', type=int, default=2)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--npz', default=None,
                        help='load photons from an .npz file '
                             '(pos/dir/pol/wavelengths/t arrays)')
    parser.add_argument('--trace', default=None,
                        help='also capture a torch.profiler trace to this '
                             'directory')
    parser.add_argument('--visits', action='store_true',
                        help='also report BVH traversal visit-count '
                             'statistics by node kind (device counters '
                             'analog; reference: cuda/profile.h)')
    parser.add_argument('--daq', action='store_true',
                        help='include per-event DAQ in the profile')
    parser.add_argument('--device', default='cuda',
                        help='torch device to simulate on (default cuda)')
    args = parser.parse_args(argv)

    import numpy as np
    import torch
    from chroma_tpu_torch import event
    from chroma_tpu_torch.generator import photon_bomb
    from chroma_tpu_torch.loader import load_geometry_from_string
    from chroma_tpu_torch.profiler import profiler
    from chroma_tpu_torch.sim import Simulation

    # on unless CHROMA_PROFILE is set empty, as bin/chroma-profile's
    # os.environ.setdefault('CHROMA_PROFILE', '1')
    profiler.enabled = bool(os.environ.get('CHROMA_PROFILE', '1'))

    def sync():
        if sim.device.type == 'cuda':
            torch.cuda.synchronize()

    geometry = load_geometry_from_string(args.detector)
    with profiler.region('setup.simulation'):
        sim = Simulation(geometry, seed=args.seed, device=args.device,
                         step_chunk=args.step_chunk)

    def make_photons():
        if args.npz:
            data = np.load(args.npz)
            return event.Photons(data['pos'], data['dir'], data['pol'],
                                 data['wavelengths'], data.get('t'))
        return photon_bomb(args.photons, 400.0, (0, 0, 0))

    # warm-up launch (builds the visit kernel on a card)
    with profiler.region('warmup'):
        next(sim.simulate(make_photons(), max_steps=args.max_steps))
        sync()

    ctx = profiler.trace(args.trace) if args.trace else None
    if ctx:
        ctx.__enter__()

    nphotons = 0
    t0 = time.time()
    for _ in range(args.events):
        photons = make_photons()
        nphotons += len(photons)
        with profiler.region('event.total'):
            next(sim.simulate(photons, max_steps=args.max_steps,
                              run_daq=args.daq))
            sync()
    elapsed = time.time() - t0

    if ctx:
        ctx.__exit__(None, None, None)

    # stage table: per-bucket propagate chunks + upload/readback/hit
    # extraction/DAQ regions; first_ms vs min_ms separates the first
    # call's kernel build and warm-up from steady state
    profiler.report(sys.stdout)
    print()

    if args.visits:
        # visits per query of one bomb's first step, by node kind: the
        # analog of the reference's intersect_mesh region counters
        # (reference: cuda/profile.h, gpu/profiler.py device_report)
        from chroma_tpu_torch.ops import visit_kernel
        from chroma_tpu_torch.ops.propagate import photon_state_from_host
        ps = photon_state_from_host(make_photons(), sim.device)
        kinds = visit_kernel.traverse(
            sim.gpu_geometry.wide, ps.pos, ps.dir, ps.last_hit_triangle,
            by_kind=True)[5].cpu().numpy()
        v = kinds.sum(axis=1)
        qs = np.percentile(v, [50, 90, 99]).astype(int)
        print('traversal visits/query: mean %.1f  p50 %d  p90 %d  '
              'p99 %d  max %d  (x %d rays)'
              % (v.mean(), qs[0], qs[1], qs[2], v.max(), len(v)))
        print('  by node kind: internal %.2f  leaf %.2f  instance %.2f '
              'a query' % tuple(kinds.mean(axis=0)))
        hist, edges = np.histogram(v, bins=min(16, int(v.max()) + 1))
        for h, lo, hi in zip(hist, edges[:-1], edges[1:]):
            bar = '#' * int(50 * h / max(hist.max(), 1))
            print('  %4d-%-4d %8d %s' % (lo, hi, h, bar))
        print()

    lane_steps = profiler.counters.get('propagate.lane_steps', 0)
    steps = profiler.counters.get('propagate.steps', 0)
    print('%d photons in %.2f s -> %.0f photons/s'
          % (nphotons, elapsed, nphotons / elapsed))
    if steps:
        print('%d propagation steps, %d lane-steps (%.1f lane-steps/photon)'
              % (steps, lane_steps, lane_steps / max(nphotons, 1)))


if __name__ == '__main__':
    main()
