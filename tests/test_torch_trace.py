"""The port's tracing system (chroma_tpu_torch.profiler) on the CPU.

Off, a span is one shared no-op context: a simulate with the DAQ and a
fused propagate open no torch.profiler range and record nothing. On,
every span is a `chroma.` range in a torch.profiler trace, nested as the
program's layers nest, and closed before simulate yields; the fused
driver's counters add up over its stages."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chroma_tpu_torch
from chroma_tpu_torch import demo
from chroma_tpu_torch import profiler as tprofiler
from chroma_tpu_torch.demo.optics import water
from chroma_tpu_torch.generator import photon_bomb
from chroma_tpu_torch.geometry import Geometry, Solid, Surface, vacuum
from chroma_tpu_torch.make import box
from chroma_tpu_torch.ops import propagate as tprop
from chroma_tpu_torch.ops.types import build_geometry_arrays
from chroma_tpu_torch.profiler import profiler

from test_torch_host import fresh_perf_cache  # noqa: F401
from test_torch_readback import seeded_state

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def tiny():
    "demo.tiny(), flattened, and its port arrays."
    geo = demo.tiny()
    geo.flatten()
    return geo, build_geometry_arrays(geo)


@pytest.fixture(scope='module')
def gray_box():
    """Port arrays of a 1 m water box with gray walls (35% absorb, 65%
    diffuse reflection): most photons outlive the first step."""
    gray = Surface('gray')
    gray.set('absorb', 0.35)
    gray.set('reflect_diffuse', 0.65)
    geo = Geometry(vacuum)
    geo.add_solid(Solid(box(1000.0, 1000.0, 1000.0), water, vacuum,
                        surface=gray))
    geo.flatten()
    return build_geometry_arrays(geo)


@pytest.fixture
def profiling(monkeypatch):
    "The profiler on, with fresh regions and counters."
    monkeypatch.setattr(profiler, 'enabled', True)
    monkeypatch.setattr(profiler, 'regions', type(profiler.regions)(
        profiler.regions.default_factory))
    monkeypatch.setattr(profiler, 'counters', type(profiler.counters)(int))
    return profiler


def _simulate(tiny, n, seed):
    "One bomb through Simulation.simulate with the DAQ and end states."
    sim = chroma_tpu_torch.Simulation(tiny[0], seed=seed, device='cpu',
                                      gpu_geometry=tiny[1])
    np.random.seed(seed)
    gen = sim.simulate(photon_bomb(n, 400.0, (0, 0, 0)),
                       keep_photons_end=True, run_daq=True, max_steps=40)
    return gen, next(gen)


def _ranges(prof):
    "The trace's chroma. host ranges as (start, end, name), by start."
    out = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(tprofiler.PREFIX)]
    return sorted(out)


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_off_opens_no_range(tiny, monkeypatch):
    """Profiler off: one shared no-op context for every span, no range
    opened (record_function and the port's range raise if called) and
    nothing recorded, through a simulate with the DAQ on the fused
    route."""
    monkeypatch.setattr(profiler, 'enabled', False)
    monkeypatch.delenv('CHROMA_FUSED', raising=False)
    monkeypatch.setenv('CHROMA_FUSED_SCHEDULE', '1:2')
    profiler.reset()

    def boom(*args, **kwargs):
        raise AssertionError('a range was opened with the profiler off')
    monkeypatch.setattr(tprofiler, '_range', boom)
    monkeypatch.setattr(torch.profiler, 'record_function', boom)
    monkeypatch.setattr(torch.autograd.profiler, 'record_function', boom)
    assert profiler.region('sim.event') is profiler.region('daq.run')
    _, ev = _simulate(tiny, 4096, 3)
    assert ev.channels.hit.any()
    assert not profiler.regions and not profiler.counters


def test_span_names_and_stats(profiling, monkeypatch):
    """A span's range is chroma.<name up to any '['>; its host time goes
    to the full name's statistics."""
    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            pass

        def __exit__(self, *exc):
            pass
    monkeypatch.setattr(tprofiler, '_range', Range)
    for _ in range(2):
        with profiling.region('propagate.fused[n=4194304]'):
            with profiling.region('propagate.stage'):
                pass
    assert opened == ['chroma.propagate.fused', 'chroma.propagate.stage'] * 2
    st = profiling.regions['propagate.fused[n=4194304]']
    assert st.calls == 2 and 0 <= st.min <= st.max <= st.total
    assert not hasattr(st, 'last')


def test_spans_nest_in_the_trace(tiny, profiling, monkeypatch):
    """Under torch.profiler the spans are kineto host ranges that nest as
    the layers do: sim.propagate > propagate.fused > propagate.stage and
    sim.daq > daq.run > daq.draws, daq.reduce; any two chroma. ranges are
    disjoint or nested; and what the caller runs after next(simulate(...))
    lies in no chroma. range."""
    monkeypatch.delenv('CHROMA_FUSED', raising=False)
    monkeypatch.setenv('CHROMA_FUSED_SCHEDULE', '1:2')
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gen, ev = _simulate(tiny, 4096, 5)
        with torch.profiler.record_function('caller.after'):
            torch.ones(8).sum()
    assert ev.channels.hit.any()
    ranges = _ranges(prof)
    names = {r[2] for r in ranges}
    for name in ('chroma.sim.upload', 'chroma.sim.readback',
                 'chroma.sim.channels', 'chroma.sim.event',
                 'chroma.sim.hit_extraction', 'chroma.daq.hits',
                 'chroma.daq.to_host',
                 'chroma.propagate.compact', 'chroma.propagate.wait'):
        assert name in names, name
    for a in ranges:
        for b in ranges:
            assert (a[1] <= b[0] or b[1] <= a[0] or _inside(a, b)
                    or _inside(b, a)), (a, b)

    def chains(*path):
        outer = [r for r in ranges if r[2] == 'chroma.' + path[0]]
        for name in path[1:]:
            outer = [r for r in ranges if r[2] == 'chroma.' + name
                     and any(_inside(r, o) for o in outer)]
        return outer
    assert len(chains('sim.propagate', 'propagate.fused',
                      'propagate.stage')) >= 2
    assert chains('sim.daq', 'daq.run', 'daq.draws')
    assert chains('sim.daq', 'daq.run', 'daq.reduce')
    assert chains('sim.event', 'sim.daq')
    after, = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() == 'caller.after']
    assert all(r[1] <= after[0] or after[1] <= r[0] for r in ranges)


def _stage_widths(monkeypatch):
    "Record each _steps call's (width, steps run)."
    stages = []
    steps = tprop._steps

    def counted(*args, **kwargs):
        out = steps(*args, **kwargs)
        stages.append((len(args[0]), len(out[1].events)))
        return out
    monkeypatch.setattr(tprop, '_steps', counted)
    return stages


def test_stage_counters_add_up(gray_box, profiling, monkeypatch):
    """propagate.steps is the sum of the stages' steps (one
    propagate.stage span each); with schedule 1:8 the survivors of the
    first step overflow the 1/8 slice: they are counted as overflow
    lanes, the boundary is skipped (no compaction, no tail of their own)
    and every later step is the last stage's tail, at the full width. The
    CPU takes no graph route and makes no blocking read on the card, and a
    geometry without wire planes counts no wire.walked."""
    monkeypatch.setenv('CHROMA_FUSED_SCHEDULE', '1:8')
    widths = _stage_widths(monkeypatch)
    n = 16384
    state = tprop.photon_state_from_host(photon_bomb(n, 450.0, (0, 0, 0)),
                                         'cpu')
    assert tprop.schedule_for(gray_box, n, 30) == ((1, 8),)
    tprop.propagate(state, gray_box, seed=6, max_steps=30)
    c = profiling.counters
    stages = [k for _, k in widths]
    assert [w for w, _ in widths] == [n, n] and stages[0] == 1
    assert c['propagate.steps'] == sum(stages)
    assert c['propagate.lane_steps'] == n * sum(stages)
    assert c['propagate.tail_steps'] == sum(stages) - 1
    assert c['propagate.tail_steps'] <= c['propagate.steps']
    assert c['propagate.overflow_lanes'] > 0
    assert profiling.regions['propagate.stage'].calls == len(stages)
    assert 'propagate.compact' not in profiling.regions
    assert 'propagate.mop' not in profiling.regions
    for name in ('graphs.captures', 'graphs.replays',
                 'propagate.blocking_reads', 'wire.walked'):
        assert name not in c, name


def test_overflow_compacts_to_a_skipped_width(gray_box, profiling,
                                              monkeypatch):
    """Survivors that overflow a stage's slice stay at the width of the
    stage; at the next boundary they compact to the narrowest skipped
    width that holds them. Schedule 1:8192,1:4096 on 16,384 lanes in the
    gray box (about 65% outlive a step): step 1 leaves more than 8,192
    alive (skipped), step 2 more than 4,096 and at most 8,192 (compacted
    to 8,192), and the tail runs there. Every lane ends terminated, at its
    input index."""
    monkeypatch.setenv('CHROMA_FUSED_SCHEDULE', '1:8192,1:4096')
    widths = _stage_widths(monkeypatch)
    n = 16384
    state = tprop.photon_state_from_host(photon_bomb(n, 450.0, (0, 0, 0)),
                                         'cpu')
    assert tprop.schedule_for(gray_box, n, 60) == ((1, 8192), (1, 4096))
    out = tprop.propagate(state, gray_box, seed=6, max_steps=60)
    assert [w for w, _ in widths] == [n, n, 8192]
    assert [k for _, k in widths][:2] == [1, 1]
    c = profiling.counters
    assert c['propagate.overflow_lanes'] > (n - 8192) // 2
    assert profiling.regions['propagate.compact'].calls == 2
    assert c['propagate.tail_steps'] == widths[2][1]
    np.testing.assert_array_equal(out.wavelength.numpy(),
                                  state.wavelength.numpy())
    term = (chroma_tpu_torch.event.SURFACE_DETECT
            | chroma_tpu_torch.event.BULK_ABSORB
            | chroma_tpu_torch.event.SURFACE_ABSORB
            | chroma_tpu_torch.event.NO_HIT)
    assert ((out.flags.numpy() & term) != 0).all()


@pytest.mark.parametrize('enabled', [True, False])
def test_readback_counters(enabled, monkeypatch):
    """One readback.calls a readback; readback.bytes 60 a lane, 64 with a
    device channel (cur_mat stays on the device); no pinned pool on the
    CPU, so readback.new_blocks stays 0. Off, nothing is counted."""
    monkeypatch.setattr(profiler, 'enabled', enabled)
    monkeypatch.setattr(profiler, 'counters', type(profiler.counters)(int))
    n = 1000
    state = seeded_state(n, 3)
    tprop.photon_state_to_host(state)
    c = profiler.counters
    if not enabled:
        tprop.photon_state_to_host(state, channel=state.last_hit_triangle)
        assert not c
        return
    assert c['readback.calls'] == 1 and c['readback.bytes'] == 60 * n
    tprop.photon_state_to_host(state, channel=state.last_hit_triangle)
    assert c['readback.calls'] == 2
    assert c['readback.bytes'] == 60 * n + 64 * n
    assert c['readback.new_blocks'] == 0
