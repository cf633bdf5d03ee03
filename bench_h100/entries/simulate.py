"""Entry `simulate`: photon bombs through `Simulation.simulate` of the
program, one event a call, and their judgement against the reference.

A call submits one event (a device PhotonState made from the seed) and
returns when its results are on the host: the photons' end states and,
where the detector has channels, the DAQ's channels. One in
`keep_one_in` of the window's events, at a seeded phase, keeps its end
state and channels for the judge (the program's own host arrays, no
copy); the others keep nothing.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench_h100.harness import traffic
from bench_h100.reference import daq as ref_daq
from bench_h100.reference import judge as ref_judge
from bench_h100.reference import physics as ref_physics

JUDGE_SITE = 0x7D6E
KEEP_ONE_IN = 8        # events that keep their end state for the judge
JUDGED_EVENTS = 3      # events judged on their paths and readout
TALLY_EVENTS = 2       # of those, events the reference transports again
PATH_LANES = 1 << 14   # lanes of a judged event whose paths are checked
TALLY_LANES = 1 << 17  # lanes the reference transports again
WARM_INDEX = 1 << 40   # warm-up events: indices no window reaches
WARM_SEED = 0          # warm-up events are the same in every run, so the
                       # schedule a first run probes does not follow --seed


class Entry:
    SPANS = [('chroma_tpu_torch.sim', 'propagate', 'bench.propagate'),
             ('chroma_tpu_torch.sim', 'photon_state_to_host',
              'bench.readback'),
             ('chroma_tpu_torch.ops.daq', 'extract_flat_hits', 'bench.hits'),
             ('chroma_tpu_torch.ops.daq', 'run_daq', 'bench.daq')]

    def __init__(self, ctx, keep_one_in=None):
        self.ctx = ctx
        self.mix = ctx.mix
        self.n = int(ctx.mix['photons'])
        self.sim = None
        self.kept = {}        # event index -> what the judge reads
        self.keep_one_in = keep_one_in or KEEP_ONE_IN
        self.keep_phase = traffic.stream_seed(ctx.seed, JUDGE_SITE) \
            % self.keep_one_in
        self.lanes = traffic.sample(self.n, max(PATH_LANES, TALLY_LANES),
                                    ctx.seed, JUDGE_SITE)

    # -- set-up ---------------------------------------------------------------
    def setup(self):
        from chroma_tpu_torch.sim import Simulation
        ctx = self.ctx
        arrays, self.has_channels = ctx.config_module.port_geometry(
            ctx.cfg, ctx.cache_dir)
        sim_seed = traffic.stream_seed(ctx.seed, 1) & 0xFFFFFFFF
        self.sim = Simulation(None, gpu_geometry=arrays, seed=sim_seed,
                              device=ctx.device)
        self.run_daq = bool(self.mix['run_daq']) and self.has_channels

    def warm_indices(self):
        """Event indices run before the window: the first probes the
        compaction schedule where none is cached; the next two capture
        every stage's graphs at the tuned widths."""
        return [WARM_INDEX + k for k in range(3)]

    def _state(self, index):
        from chroma_tpu_torch.ops.photon import PhotonState
        seed = WARM_SEED if index >= WARM_INDEX else self.ctx.seed
        return photon_state(PhotonState, traffic.bomb(
            self.mix, self.ctx.cfg, seed, index, self.ctx.device))

    # -- one call -------------------------------------------------------------
    def call(self, index, window):
        "One event; its record: index, wall, photons."
        state = self._state(index)
        if self.ctx.device.type == 'cuda':
            torch.cuda.synchronize()
        batch = self.sim._batch
        t0 = time.perf_counter()
        ev = next(self.sim.simulate(
            state, keep_photons_end=bool(self.mix['keep_photons_end']),
            run_daq=self.run_daq, max_steps=int(self.mix['max_steps']),
            photons_per_batch=int(self.mix['photons_per_batch'])))
        latency = time.perf_counter() - t0
        if window:
            self._keep(index, batch, ev)
        return dict(index=index, latency_s=latency, photons=self.n)

    def _keep(self, index, batch, ev):
        if index % self.keep_one_in != self.keep_phase:
            return
        end = ev.photons_end
        rec = dict(batch=batch, end=dict(
            pos=end.pos, dir=end.dir, t=end.t, flags=end.flags,
            last=end.last_hit_triangles))
        if self.run_daq:
            ch = ev.channels
            rec['channels'] = (ch.hit, ch.t, ch.q)
        self.kept[index] = rec

    # -- after the window -------------------------------------------------------
    def release(self):
        "Free the program's state before the reference runs."
        self.sim = None

    def reference_scene(self):
        "The reference's scene of the cell, at the photons' wavelength."
        ctx = self.ctx
        return ctx.config_module.reference_scene(
            ctx.cfg, float(self.mix['wavelength_nm'])).to(ctx.device)

    def judge(self, scene):
        """The numbers compared, from the kept events: (numbers, facts
        for the per-layer readers)."""
        ctx = self.ctx
        dev = ctx.device
        kept = sorted(self.kept)
        if not kept:
            raise RuntimeError('no event of the window kept its end state')
        pick = traffic.sample(len(kept), JUDGED_EVENTS, ctx.seed,
                              JUDGE_SITE + 1).tolist()
        events = [kept[i] for i in pick]
        lanes = self.lanes.to(dev)
        faults, end_gap, tz = 0, 0.0, 0.0
        dgap_t, dgap_q = 0.0, 0.0
        steps, stepped = 0, 0
        counts = []
        for k, index in enumerate(events):
            rec = self.kept[index]
            start = traffic.bomb(self.mix, ctx.cfg, ctx.seed, index, dev)
            s_all = {key: start[key][lanes] for key in ('pos', 'dir', 't',
                                                        'medium')}
            e_all = end_lanes(rec['end'], self.lanes, dev)
            path_n = min(PATH_LANES, len(lanes))
            f, eg, c = ref_judge.path_checks(
                scene, {key: v[:path_n] for key, v in s_all.items()},
                {key: v[:path_n] for key, v in e_all.items()})
            faults += f
            end_gap = max(end_gap, eg)
            counts.append(c)
            if k < TALLY_EVENTS:
                gen = traffic.generator(dev, ctx.seed, JUDGE_SITE + 2, index)
                ref = ref_physics.propagate(
                    scene, s_all | {'pol': start['pol'][lanes]}, gen,
                    max_steps=int(self.mix['max_steps']))
                ref['t'] = ref['t'].float()
                for side in (e_all, ref):
                    side['leg'] = ref_judge.single_leg_breaks(scene, s_all,
                                                              side)
                tz = max(tz, ref_judge.tally_z(e_all, ref))
                steps += int(ref['steps'].sum())
                stepped += int(ref['steps'].numel())
            if self.run_daq:
                g_t, g_q = self._daq_gap(scene, rec)
                dgap_t, dgap_q = max(dgap_t, g_t), max(dgap_q, g_q)
        numbers = dict(path_faults=faults, end_gap_mm=end_gap, tally_z=tz)
        if self.run_daq:
            numbers.update(daq_time_gap_ns=dgap_t, daq_charge_gap=dgap_q)
        facts = dict(steps_per_photon=steps / max(stepped, 1),
                     judged_events=events, path_counts=counts)
        return numbers, facts

    def _daq_gap(self, scene, rec):
        "The readout gaps of one kept event."
        dev = self.ctx.device
        end = rec['end']
        whole = {k: torch.as_tensor(_signed(end[k])).to(dev)
                 for k in ('t', 'flags', 'last')}
        whole['flags'], whole['last'] = whole['flags'].long(), \
            whole['last'].long()
        return daq_gap(self.ctx, scene, whole, rec['batch'],
                       [torch.as_tensor(x).to(dev) for x in rec['channels']])


def end_lanes(end, lanes, device):
    """The sampled lanes of a kept end state (the program's host arrays)
    as device tensors: pos, dir, t, flags, last."""
    ix = lanes.numpy()
    out = {k: torch.as_tensor(_signed(end[k])[ix]).to(device)
           for k in ('pos', 'dir', 't', 'flags', 'last')}
    out['flags'], out['last'] = out['flags'].long(), out['last'].long()
    return out


def _signed(a):
    "A host array; the program's uint32 flags as int32."
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def photon_state(cls, ev):
    """The program's PhotonState (`cls`) of an event made by the
    generator: weight 1, no history, no last hit, medium left to the
    program."""
    n, dev = ev['t'].shape[0], ev['t'].device

    def full(v, dtype=torch.int32):
        return torch.full((n,), v, dtype=dtype, device=dev)
    return cls(pos=ev['pos'], dir=ev['dir'], pol=ev['pol'],
               wavelength=ev['wavelength'], t=ev['t'],
               weight=full(1.0, torch.float32), flags=full(0),
               last_hit_triangle=full(-1), evidx=full(0), cur_mat=full(-1))


def channel_of(scene, last):
    "Each photon's channel from its last triangle (-1: none)."
    ok = last >= 0
    _, _, _, inst = scene.triangle_props(torch.where(ok, last, 0))
    return torch.where(ok, scene.t_channel[torch.clamp(inst, min=0)], -1)


def daq_gap(ctx, scene, whole, batch, channels, dtype=torch.float32):
    "(time gap, charge gap) of one event's readout against the reference."
    tables = ctx.config_module.daq_tables(ctx.cfg)
    sim_seed = traffic.stream_seed(ctx.seed, 1) & 0xFFFFFFFF
    ch = channel_of(scene, whole['last'])
    n_ch = int((scene.t_channel >= 0).sum())
    hit, t, q, unit = ref_daq.readout(ch, whole['t'], whole['flags'], n_ch,
                                      sim_seed, batch, *tables, dtype=dtype)
    return ref_judge.daq_gaps(channels, (hit, t, q), unit)
