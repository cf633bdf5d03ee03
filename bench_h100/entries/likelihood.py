"""Entry `likelihood`: the reconstruction loop, `Likelihood.eval` of the
program on the configuration's detector, one evaluation a call, and its
judgement against the reference.

Set-up makes the observed event: the light of a charged track from a
seeded vertex and direction, transported and read out by the reference
(the program sees only its channels). A call evaluates the negative log
likelihood of that event under trial vertices drawn from the seed about
the observed one (mix['nevals'] events of the same track's light, each
propagated mix['nreps'] times and read out mix['ndaq'] times), and
returns when the number is on the host. The window's first call and one
in `keep_one_in` of the others, at a seeded phase, keep what the judge
reads: each propagation's DAQ samples (the program's own tensors, no
copy) and the end state and channels of each event's first propagation
(its end state copied on the card, since the driver's buffers are its
own).
"""
from __future__ import annotations

import time
import types

import torch

from bench_h100.entries import simulate
from bench_h100.harness import traffic
from bench_h100.reference import daq as ref_daq
from bench_h100.reference import judge as ref_judge
from bench_h100.reference import likelihood as ref_lk
from bench_h100.reference import physics as ref_physics

JUDGE_SITE = 0x11C0
OBS_SITE = 0x0B5
KEEP_ONE_IN = 4        # calls that keep what the judge reads
JUDGED_EVALS = 2       # calls judged
WARM_INDEX = 1 << 40
WARM_SEED = 0          # warm-up calls are the same in every run
OBS_MAX_STEPS = 1000   # the observed event's transport


class Recorder:
    """What the program's likelihood loop made, read where it is made:
    replaces `propagate` in chroma_tpu_torch.sim and `run_daq` in
    chroma_tpu_torch.ops.daq by wrappers that pass everything through and,
    while `on`, note each propagation's batch, DAQ earliest times, and for
    one in `ends_every` propagations its end state and charges."""

    def __init__(self, ends_every):
        self.ends_every = ends_every
        self.on = False
        self.props = []
        self.saved = []

    def install(self):
        import chroma_tpu_torch.sim as sim
        from chroma_tpu_torch.ops import daq
        real_propagate, real_daq = sim.propagate, daq.run_daq

        def propagate(state, geometry, seed, *args, **kwargs):
            out = real_propagate(state, geometry, seed, *args, **kwargs)
            if self.on:
                rec = dict(batch=int(seed[1]))
                if len(self.props) % self.ends_every == 0:
                    rec['end'] = out.map(torch.clone)
                self.props.append(rec)
            return out

        def run_daq(*args, **kwargs):
            out = real_daq(*args, **kwargs)
            if self.on:
                rec = self.props[-1]
                rec['t'] = out.earliest_time
                if 'end' in rec:
                    rec['q'] = out.charge
            return out
        self.saved = [(sim, 'propagate', real_propagate),
                      (daq, 'run_daq', real_daq)]
        sim.propagate, daq.run_daq = propagate, run_daq

    def remove(self):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)
        self.saved = []

    def take(self):
        props, self.props = self.props, []
        return props


class Entry:
    SPANS = [('chroma_tpu_torch.sim', 'propagate', 'bench.propagate'),
             ('chroma_tpu_torch.ops.daq', 'run_daq', 'bench.daq'),
             ('chroma_tpu_torch.ops.pdf', 'PDFEval.accumulate', 'bench.pdf'),
             ('chroma_tpu_torch.ops.pdf', 'PDFEval.get', 'bench.pdf_get')]

    def __init__(self, ctx, keep_one_in=None):
        self.ctx = ctx
        self.mix = ctx.mix
        self.n = int(ctx.mix['photons'])
        self.nevals = int(ctx.mix['nevals'])
        self.nreps = int(ctx.mix['nreps'])
        self.ndaq = int(ctx.mix['ndaq'])
        self.sim = None
        self.recorder = None
        self.kept = {}
        self.keep_one_in = keep_one_in or KEEP_ONE_IN
        self.keep_phase = traffic.stream_seed(ctx.seed, JUDGE_SITE) \
            % self.keep_one_in
        self.sim_seed = traffic.stream_seed(ctx.seed, 1) & 0xFFFFFFFF

    # -- the events -----------------------------------------------------------
    def observed_track(self, seed=None):
        "(vertex, axis) of the observed event."
        gen = traffic.generator(self.ctx.device,
                                self.ctx.seed if seed is None else seed,
                                OBS_SITE)
        v = traffic.vertex(self.ctx.cfg['vertex_region'], gen,
                           self.ctx.device)
        return v, traffic.direction(gen, self.ctx.device)

    def trial(self, index, k):
        "The photons of trial event k of call `index` (a dict of tensors)."
        seed = WARM_SEED if index >= WARM_INDEX else self.ctx.seed
        vertex, axis = self.observed_track(seed)
        gen = traffic.generator(self.ctx.device, seed, traffic.EVENT_SITE,
                                index, k)
        offset = traffic.vertex(
            {'ball_radius_mm': float(self.mix['trial_offset_mm'])}, gen,
            self.ctx.device)
        return traffic.track(self.mix, vertex + offset, axis,
                             self.ctx.cfg['vertex_medium'], gen,
                             self.ctx.device)

    def observe(self, scene, dtype=torch.float32):
        """The observed event's channels (hit, t, q as host arrays): the
        reference's transport and readout of the observed track's light."""
        ctx = self.ctx
        vertex, axis = self.observed_track()
        gen = traffic.generator(ctx.device, ctx.seed, OBS_SITE, 1)
        light = traffic.track(self.mix, vertex, axis,
                              ctx.cfg['vertex_medium'], gen, ctx.device)
        end = ref_physics.propagate(scene, light, gen,
                                    max_steps=OBS_MAX_STEPS)
        ch = simulate.channel_of(scene, end['last'])
        n_ch = int((scene.t_channel >= 0).sum())
        hit, t, q, _ = ref_daq.readout(
            ch, end['t'].float(), end['flags'], n_ch,
            traffic.stream_seed(ctx.seed, OBS_SITE) & 0xFFFFFFFF, 0,
            *ctx.config_module.daq_tables(ctx.cfg), dtype=dtype)
        return types.SimpleNamespace(hit=hit.cpu().numpy(),
                                     t=t.cpu().numpy(), q=q.cpu().numpy())

    # -- set-up ---------------------------------------------------------------
    def setup(self):
        from chroma_tpu_torch.likelihood import Likelihood
        from chroma_tpu_torch.sim import Simulation
        ctx = self.ctx
        self.channels = self.observe(self.reference_scene())
        if ctx.device.type == 'cuda':
            # the reference's scene is gone: the peak is the program's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(ctx.device)
        arrays, _ = ctx.config_module.port_geometry(ctx.cfg, ctx.cache_dir)
        self.sim = Simulation(None, gpu_geometry=arrays, seed=self.sim_seed,
                              device=ctx.device)
        self.likelihood = Likelihood(
            self.sim, types.SimpleNamespace(channels=self.channels))
        self.recorder = Recorder(self.nreps)
        self.recorder.install()

    def warm_indices(self):
        """Calls run before the window: the first probes the compaction
        schedule of the events' width where none is cached and captures
        its stages' graphs; the second runs them."""
        return [WARM_INDEX + k for k in range(2)]

    # -- one call -------------------------------------------------------------
    def call(self, index, window):
        from chroma_tpu_torch.ops.photon import PhotonState
        events = []
        for k in range(self.nevals):
            ev = self.trial(index, k)
            events.append(types.SimpleNamespace(
                photons_beg=simulate.photon_state(PhotonState, ev)))
        keep = window and (index == 0 or
                           index % self.keep_one_in == self.keep_phase)
        self.recorder.on = keep
        if self.ctx.device.type == 'cuda':
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        nll = self.likelihood.eval(iter(events), self.nevals,
                                   nreps=self.nreps, ndaq=self.ndaq)
        latency = time.perf_counter() - t0
        self.recorder.on = False
        if keep:
            self.kept[index] = dict(nll=float(nll.nominal_value),
                                    props=self.recorder.take())
        return dict(index=index, latency_s=latency,
                    photons=self.n * self.nevals * self.nreps)

    # -- after the window ---------------------------------------------------
    def release(self):
        "Free the program's state before the reference runs."
        if self.recorder is not None:
            self.recorder.remove()
        self.sim = self.likelihood = None

    def reference_scene(self):
        ctx = self.ctx
        return ctx.config_module.reference_scene(
            ctx.cfg, float(self.mix['wavelength_nm'])).to(ctx.device)

    def judge(self, scene):
        """The numbers compared, from the kept calls: (numbers, facts for
        the per-layer readers)."""
        ctx = self.ctx
        dev = ctx.device
        kept = sorted(self.kept)
        if not kept:
            raise RuntimeError('no call of the window kept its record')
        pick = traffic.sample(len(kept), JUDGED_EVALS, ctx.seed,
                              JUDGE_SITE + 1).tolist()
        calls = [kept[i] for i in pick]
        hit = torch.as_tensor(self.channels.hit, device=dev)
        obs_t = torch.as_tensor(self.channels.t, device=dev)
        n_ch = hit.shape[0]
        ntotal = self.nevals * self.nreps * self.ndaq
        tables = ctx.config_module.daq_tables(ctx.cfg)
        nll_gap, faults, end_gap = 0.0, 0, 0.0
        dgap_t, dgap_q = 0.0, 0.0
        prog_ends, ref_ends, starts, steps = [], [], [], []
        for index in calls:
            rec = self.kept[index]
            props = rec['props']
            samples = torch.cat([p['t'].to(dev).reshape(-1, n_ch)
                                 for p in props])
            ref_nll = ref_lk.nll(hit, obs_t, samples, ntotal,
                                 float(self.mix['min_twidth_ns']),
                                 tuple(self.mix['trange_ns']),
                                 int(self.mix['min_bin_content']))
            nll_gap = max(nll_gap, abs(rec['nll'] - ref_nll))
            for k in range(self.nevals):
                p = props[k * self.nreps]
                start = self.trial(index, k)
                end = {key: getattr(p['end'], f).to(dev) for key, f in (
                    ('pos', 'pos'), ('dir', 'dir'), ('t', 't'),
                    ('flags', 'flags'), ('last', 'last_hit_triangle'))}
                end['flags'] = end['flags'].long()
                end['last'] = end['last'].long()
                s = {key: start[key] for key in ('pos', 'dir', 't', 'medium')}
                f, eg, _ = ref_judge.path_checks(scene, s, end)
                faults += f
                end_gap = max(end_gap, eg)
                ch = simulate.channel_of(scene, end['last'])
                ref = ref_daq.readout(ch, end['t'], end['flags'], n_ch,
                                      self.sim_seed, p['batch'], *tables,
                                      ndaq=self.ndaq)
                prog_t = p['t'].to(dev).reshape(self.ndaq, n_ch)
                prog_q = p['q'].to(dev).reshape(self.ndaq, n_ch)
                g_t, g_q = ref_judge.daq_gaps(
                    (prog_t < ref_daq.HIT_TIME_CUT, prog_t, prog_q),
                    ref[:3], ref[3])
                dgap_t, dgap_q = max(dgap_t, g_t), max(dgap_q, g_q)
                gen = traffic.generator(dev, ctx.seed, JUDGE_SITE + 2,
                                        index, k)
                r = ref_physics.propagate(scene, start, gen,
                                          max_steps=int(self.mix['max_steps']))
                r['t'] = r['t'].float()
                prog_ends.append(end)
                ref_ends.append(r)
                starts.append(s)
                steps.append(r['steps'])
        cat = {key: torch.cat([st[key] for st in starts]) for key in starts[0]}
        sides = []
        for ends in (prog_ends, ref_ends):
            side = {key: torch.cat([e[key] for e in ends])
                    for key in ('pos', 'dir', 't', 'flags', 'last')}
            side['leg'] = ref_judge.single_leg_breaks(scene, cat, side)
            sides.append(side)
        tz = ref_judge.tally_z(*sides)
        steps = torch.cat(steps)
        numbers = dict(path_faults=faults, end_gap_mm=end_gap, tally_z=tz,
                       daq_time_gap_ns=dgap_t, daq_charge_gap=dgap_q,
                       nll_gap=nll_gap)
        facts = dict(steps_per_photon=float(steps.double().mean()),
                     judged_calls=calls)
        return numbers, facts
