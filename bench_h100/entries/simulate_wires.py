"""Entry `simulate_wires`: the `simulate` entry (photon bombs through
`Simulation.simulate`, one event a call) on a detector with wire planes,
judged by the reference with its wires (reference/wires.py).

The calls and what they keep are the simulate entry's. The judge is its
judge with every ray query, the transport, the path checks and the
single-leg breaks wire-aware: a photon that ends on a wire reports the
triangle -2 and must end on a wire's surface, and `tally_z` has one more
history class, ended on a wire. Its facts add what the wire walk's
readers need: the steps a photon takes whose ray reaches a plane's slab
before its mesh hit (`wire_steps_per_photon`) and the wires within the
slab chords of its steps' rays (`k3_wires_per_photon`), by the reference's
transport of the judged photons.
"""
from __future__ import annotations

import os

from bench_h100.harness import cell, traffic
from bench_h100.reference import wires as ref_wires

simulate = cell.load_module(os.path.join(cell.BENCH, 'entries',
                                         'simulate.py'),
                            'bench_h100.entries.simulate')


class Entry(simulate.Entry):

    def reference_scene(self):
        "The reference's scene of the cell, its wire planes included."
        scene = super().reference_scene()
        if not getattr(scene, 'planes', None):
            raise ValueError('simulate_wires judges a detector with wire '
                             'planes; %s has none' % self.ctx.cfg['name'])
        return scene

    def judge(self, scene):
        """The numbers compared, from the kept events: (numbers, facts
        for the per-layer readers)."""
        ctx = self.ctx
        dev = ctx.device
        kept = sorted(self.kept)
        if not kept:
            raise RuntimeError('no event of the window kept its end state')
        pick = traffic.sample(len(kept), simulate.JUDGED_EVENTS, ctx.seed,
                              simulate.JUDGE_SITE + 1).tolist()
        events = [kept[i] for i in pick]
        lanes = self.lanes.to(dev)
        faults, end_gap, tz = 0, 0.0, 0.0
        dgap_t, dgap_q = 0.0, 0.0
        steps, wire_steps, k3_wires, stepped = 0, 0, 0, 0
        counts = []
        for k, index in enumerate(events):
            rec = self.kept[index]
            start = traffic.bomb(self.mix, ctx.cfg, ctx.seed, index, dev)
            s_all = {key: start[key][lanes] for key in ('pos', 'dir', 't',
                                                        'medium')}
            e_all = simulate.end_lanes(rec['end'], self.lanes, dev)
            path_n = min(simulate.PATH_LANES, len(lanes))
            f, eg, c = ref_wires.path_checks(
                scene, {key: v[:path_n] for key, v in s_all.items()},
                {key: v[:path_n] for key, v in e_all.items()})
            faults += f
            end_gap = max(end_gap, eg)
            counts.append(c)
            if k < simulate.TALLY_EVENTS:
                gen = traffic.generator(dev, ctx.seed,
                                        simulate.JUDGE_SITE + 2, index)
                ref = ref_wires.propagate(
                    scene, s_all | {'pol': start['pol'][lanes]}, gen,
                    max_steps=int(self.mix['max_steps']))
                ref['t'] = ref['t'].float()
                for side in (e_all, ref):
                    side['leg'] = ref_wires.single_leg_breaks(scene, s_all,
                                                              side)
                tz = max(tz, ref_wires.tally_z(e_all, ref))
                steps += int(ref['steps'].sum())
                wire_steps += int(ref['wire_steps'].sum())
                k3_wires += int(ref['k3_wires'].sum())
                stepped += int(ref['steps'].numel())
            if self.run_daq:
                g_t, g_q = self._daq_gap(scene, rec)
                dgap_t, dgap_q = max(dgap_t, g_t), max(dgap_q, g_q)
        numbers = dict(path_faults=faults, end_gap_mm=end_gap, tally_z=tz)
        if self.run_daq:
            numbers.update(daq_time_gap_ns=dgap_t, daq_charge_gap=dgap_q)
        stepped = max(stepped, 1)
        facts = dict(steps_per_photon=steps / stepped,
                     wire_steps_per_photon=wire_steps / stepped,
                     k3_wires_per_photon=k3_wires / stepped,
                     judged_events=events, path_counts=counts)
        return numbers, facts

