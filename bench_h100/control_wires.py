"""The lower-precision control of the cells whose entry is
`simulate_wires`, and the program's readings beside them.

    python3 bench_h100/control_wires.py --workload lartpc.bomb \
        --seeds 1 2 3 [--program-seeds 4 5 ...] [--photons N]

control.py's control with the wires: the reference (reference/wires.py's
transport, its wire query and meshes) computed in bfloat16 in the
program's place makes each event's end states, and reference/daq.py in
bfloat16 reads them out; the same judge as a benchmark run reads them on
the cell's own events and sizes. --program-seeds runs the program itself
through the same judge (no timing). The benchmark's runs never run this
script.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from bench_h100 import control  # noqa: E402
from bench_h100.harness import cell, traffic  # noqa: E402
from bench_h100.reference import daq as ref_daq  # noqa: E402
from bench_h100.reference import wires  # noqa: E402

simulate_wires = cell.load_module(
    os.path.join(HERE, 'entries', 'simulate_wires.py'),
    'bench_h100.entries.simulate_wires')
simulate = simulate_wires.simulate


class WireControl(simulate_wires.Entry):
    """The simulate_wires entry with the reference in bfloat16 in the
    program's place: control.ControlEntry's calls, the transport with
    wires."""

    setup = control.ControlEntry.setup

    def call(self, index, window):
        ctx = self.ctx
        ev = traffic.bomb(self.mix, ctx.cfg, ctx.seed, index, ctx.device)
        gen = traffic.generator(ctx.device, ctx.seed, 0xC0, index)
        end = wires.propagate(self.scene16, ev, gen,
                              max_steps=int(self.mix['max_steps']))
        batch, self.batch = self.batch, self.batch + 1
        host = {k: end[k].float().cpu().numpy() for k in ('pos', 'dir', 't')}
        host['flags'] = end['flags'].int().cpu().numpy()
        host['last'] = end['last'].int().cpu().numpy()
        rec = dict(batch=batch, end=host)
        if self.run_daq:
            sim_seed = traffic.stream_seed(ctx.seed, 1) & 0xFFFFFFFF
            ch = simulate.channel_of(self.scene16, end['last'])
            n_ch = int((self.scene16.t_channel >= 0).sum())
            hit, t, q, _ = ref_daq.readout(
                ch, end['t'], end['flags'], n_ch, sim_seed, batch,
                *ctx.config_module.daq_tables(ctx.cfg),
                dtype=torch.bfloat16)
            rec['channels'] = tuple(x.cpu().numpy() for x in (hit, t, q))
        self.kept[index] = rec
        return dict(index=index, latency_s=0.0, photons=self.n)


control.CONTROLS.setdefault('simulate_wires',
                            (simulate_wires.Entry, WireControl))


def readings(side, workload, seed, device, overrides=None, cache_dir=None):
    "control.readings of a simulate_wires cell."
    return control.readings(side, workload, seed, device, overrides,
                            calls=simulate.JUDGED_EVENTS,
                            cache_dir=cache_dir)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='*', default=[])
    p.add_argument('--program-seeds', type=int, nargs='*', default=[])
    p.add_argument('--photons', type=int, default=None)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    os.environ.setdefault('CHROMA_CACHE_DIR', os.path.join(HERE, '.cache'))
    ov = {'traffic': {'photons': args.photons}} if args.photons else None
    for side, seeds in (('program', args.program_seeds),
                        ('control', args.seeds)):
        for seed in seeds:
            numbers, ok = readings(side, args.workload, seed, args.device, ov)
            print(json.dumps({'side': side, 'seed': seed, 'correct': ok,
                              'numbers': numbers}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
