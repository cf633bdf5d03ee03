"""The lower-precision control of a cell, and the program's readings
beside it.

    python3 bench_h100/control.py --workload quick.bomb --seeds 1 2 3 \
        [--program-seeds 4 5 ...] [--photons N]

The control is the reference put in the program's place and computed in
bfloat16, the precision below the float32 the configurations state: for
a bomb its transport (reference/physics.py on a bfloat16 scene) makes
each event's end states and its readout (reference/daq.py in bfloat16)
the channels; for a likelihood evaluation the same transport and readout
make every propagation's DAQ samples and reference/likelihood.py in
bfloat16 the NLL; for a frame its renderer (reference/render.py) the
image.
The same judge as a benchmark run then reads them, on the cell's own
events and sizes; each seed prints its numbers and whether they pass the
cell's limits. --program-seeds runs the program itself through the same
judge (no timing) for the lower readings. The benchmark's runs never run
this script.
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

from bench_h100.entries import likelihood, simulate, snapshot  # noqa: E402
from bench_h100.harness import cell, traffic  # noqa: E402
from bench_h100.reference import daq as ref_daq  # noqa: E402
from bench_h100.reference import likelihood as ref_lk  # noqa: E402
from bench_h100.reference import physics  # noqa: E402
from bench_h100.reference import render as ref_render  # noqa: E402


class ControlEntry(simulate.Entry):
    """The simulate entry with the reference in bfloat16 in the
    program's place: a call transports the event's photons and reads
    them out in bfloat16, and keeps what a program call keeps."""

    def setup(self):
        ctx = self.ctx
        self.scene16 = ctx.config_module.reference_scene(
            ctx.cfg, float(ctx.mix['wavelength_nm'])).to(
                ctx.device, torch.bfloat16)
        self.has_channels = ctx.config_module.daq_tables(ctx.cfg) is not None
        self.run_daq = bool(self.mix['run_daq']) and self.has_channels
        self.batch = 0

    def call(self, index, window):
        ctx = self.ctx
        ev = traffic.bomb(self.mix, ctx.cfg, ctx.seed, index, ctx.device)
        gen = traffic.generator(ctx.device, ctx.seed, 0xC0, index)
        end = physics.propagate(self.scene16, ev, gen,
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


class LikelihoodControl(likelihood.Entry):
    """The likelihood entry with the reference in bfloat16 in the
    program's place: a call transports each trial event's light nreps
    times, reads each out ndaq times and works out the NLL, all in
    bfloat16, and keeps what a program call keeps."""

    def setup(self):
        ctx = self.ctx
        self.channels = self.observe(self.reference_scene())
        self.scene16 = ctx.config_module.reference_scene(
            ctx.cfg, float(self.mix['wavelength_nm'])).to(
                ctx.device, torch.bfloat16)
        self.batch = 0

    def call(self, index, window):
        ctx = self.ctx
        dev = ctx.device
        tables = ctx.config_module.daq_tables(ctx.cfg)
        n_ch = int((self.scene16.t_channel >= 0).sum())
        props = []
        for k in range(self.nevals):
            ev = self.trial(index, k)
            reps = {key: torch.cat([v] * self.nreps) for key, v in ev.items()}
            gen = traffic.generator(dev, ctx.seed, 0xC1, index, k)
            end = physics.propagate(self.scene16, reps, gen,
                                    max_steps=int(self.mix['max_steps']))
            for r in range(self.nreps):
                part = {key: v[r * self.n:(r + 1) * self.n]
                        for key, v in end.items()}
                ch = simulate.channel_of(self.scene16, part['last'])
                _, t, q, _ = ref_daq.readout(
                    ch, part['t'], part['flags'], n_ch, self.sim_seed,
                    self.batch, *tables, dtype=torch.bfloat16,
                    ndaq=self.ndaq)
                rec = dict(batch=self.batch, t=t.reshape(-1))
                if r == 0:
                    rec['end'] = _State(part)
                    rec['q'] = q.reshape(-1)
                props.append(rec)
                self.batch += 1
        samples = torch.cat([p['t'].reshape(-1, n_ch) for p in props])
        nll = ref_lk.nll(torch.as_tensor(self.channels.hit, device=dev),
                         torch.as_tensor(self.channels.t, device=dev),
                         samples, self.nevals * self.nreps * self.ndaq,
                         float(self.mix['min_twidth_ns']),
                         tuple(self.mix['trange_ns']),
                         int(self.mix['min_bin_content']),
                         dtype=torch.bfloat16)
        self.kept[index] = dict(nll=nll, props=props)
        return dict(index=index, latency_s=0.0,
                    photons=self.n * self.nevals * self.nreps)

    def release(self):
        self.scene16 = None


class _State:
    "A reference end state under the program's field names."

    def __init__(self, end):
        self.pos, self.dir = end['pos'].float(), end['dir'].float()
        self.t, self.flags = end['t'].float(), end['flags']
        self.last_hit_triangle = end['last']


class RenderControl(snapshot.Entry):
    """The snapshot entry with the reference renderer in bfloat16 in the
    program's place: a call renders the whole frame and keeps what a
    program call keeps."""

    def setup(self):
        ctx = self.ctx
        self.scene16 = ctx.config_module.reference_scene(ctx.cfg, 400.0).to(
            ctx.device, torch.bfloat16)

    def call(self, index, window):
        pos = self.position(index)
        o, d = ref_render.film_rays(pos, self.size)
        pix = torch.cat([ref_render.render(
            self.scene16, o[a:a + (1 << 18)], d[a:a + (1 << 18)],
            int(self.mix['alpha_depth']), int(self.mix['bg_color']))[0]
            for a in range(0, len(o), 1 << 18)])
        rgb = torch.stack([(pix >> s) & 0xFF for s in (16, 8, 0)], 1).cpu()
        self.kept[index] = (pos, rgb[self.pixels])
        return dict(index=index, latency_s=0.0, frames=1, pixels=self.n)


CONTROLS = {'simulate': (simulate.Entry, ControlEntry),
            'likelihood': (likelihood.Entry, LikelihoodControl),
            'snapshot': (snapshot.Entry, RenderControl)}


def readings(side, workload, seed, device, overrides=None, calls=None,
             cache_dir=None):
    """(numbers compared, whether all are within the cell's limits) for a
    few calls of `seed`, every one kept for the judge, from the program
    (side 'program') or the control (side 'control')."""
    ctx = cell.context(workload, seed, device, overrides=overrides,
                       cache_dir=cache_dir)
    program_cls, control_cls = CONTROLS[ctx.mix['entry']]
    entry_cls = program_cls if side == 'program' else control_cls
    kwargs = {} if ctx.mix['entry'] == 'snapshot' else {'keep_one_in': 1}
    calls = calls or {'simulate': simulate.JUDGED_EVENTS,
                      'likelihood': likelihood.JUDGED_EVALS,
                      'snapshot': snapshot.JUDGED_FRAMES}[ctx.mix['entry']]
    entry = entry_cls(ctx, **kwargs)
    entry.setup()
    if side == 'program':
        for index in entry.warm_indices()[:1]:
            entry.call(index, window=False)
    for index in range(calls):
        entry.call(index, window=True)
    entry.release()
    numbers, _ = entry.judge(entry.reference_scene())
    return numbers, cell.judged(workload, numbers)[1]


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
