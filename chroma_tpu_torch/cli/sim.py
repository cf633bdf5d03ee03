"""Batch photon simulation -> portable event file (the torch port's
counterpart of bin/chroma-sim):

    python -m chroma_tpu_torch.cli.sim DETECTOR OUT.chroma [-n N] [-p P]
        [--daq] [--device cuda|cpu] ...
"""
import argparse
import sys
import time
from itertools import islice


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Simulate photon-bomb events in a detector and write '
                    'them to a .chroma event file.')
    parser.add_argument('detector',
                        help='geometry string (STL file, cache name, or '
                             '@python.module.obj)')
    parser.add_argument('output', help='output event file (.chroma)')
    parser.add_argument('-n', '--events', type=int, default=10)
    parser.add_argument('-p', '--photons', type=int, default=100000,
                        help='photons per event')
    parser.add_argument('--wavelength', type=float, default=400.0)
    parser.add_argument('--pos', type=float, nargs=3, default=(0, 0, 0))
    parser.add_argument('--seed', type=int, default=None)
    parser.add_argument('--max-steps', type=int, default=1000)
    parser.add_argument('--daq', action='store_true',
                        help='run the PMT DAQ per event')
    parser.add_argument('--keep-photons-end', action='store_true',
                        help='store final photon states in the output '
                             '(default when the geometry has no channels)')
    parser.add_argument('--device', default='cuda',
                        help='torch device to simulate on (default cuda)')
    args = parser.parse_args(argv)

    from chroma_tpu_torch.loader import load_geometry_from_string
    from chroma_tpu_torch.sim import Simulation
    from chroma_tpu_torch.generator import constant_photon_bomb_gun
    from chroma_tpu_torch.io import EventWriter

    geometry = load_geometry_from_string(args.detector)
    sim = Simulation(geometry, seed=args.seed, device=args.device)

    source = islice(constant_photon_bomb_gun(args.photons, args.wavelength,
                                             args.pos), args.events)

    keep_end = args.keep_photons_end or not hasattr(geometry,
                                                    'num_channels')
    start = time.time()
    with EventWriter(args.output) as writer:
        for i, ev in enumerate(sim.simulate(source, run_daq=args.daq,
                                            keep_photons_end=keep_end,
                                            max_steps=args.max_steps)):
            writer.write_event(ev)
            print('\revent %d/%d' % (i + 1, args.events), end='',
                  file=sys.stderr)
    elapsed = time.time() - start
    print('\n%d events in %.1f s (%.1f events/s)'
          % (args.events, elapsed, args.events / elapsed), file=sys.stderr)


if __name__ == '__main__':
    main()
