"""The program's spans (`chroma.` ranges of chroma_tpu_torch's profiler) in
a synthetic trace: they leave the trace's own reduction as it was, and
the card's idle time goes to the host's innermost program span, or to
`outside`, summing to the gaps' total."""
from __future__ import annotations

import types

import pytest
import torch

from bench_h100.harness import program, trace
from bench_h100.tests.test_bench_arithmetic import Ev, reader, run_of

CPU, GPU = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

# the benchmark's spans, the runtime calls and the card's operations
BENCH = [Ev('bench.daq', CPU, 0, 100), Ev('bench.propagate', CPU, 200, 400),
         Ev('cudaLaunchKernel', CPU, 5, 8, 1),
         Ev('cudaGraphLaunch', CPU, 210, 215, 2),
         Ev('cudaMemcpyAsync', CPU, 90, 95, 3),
         Ev('scatter_kernel', GPU, 10, 40, 1),
         Ev('Memcpy DtoH', GPU, 30, 50, 3),
         Ev('visit_warp_kernel', GPU, 220, 300, 2),
         Ev('bench.daq', GPU, 10, 60)]
# the program's spans inside and between them
PROGRAM = [Ev('chroma.daq.run', CPU, 2, 98),
           Ev('chroma.daq.block', CPU, 4, 60),
           Ev('chroma.sim.event', CPU, 100, 150),
           Ev('chroma.propagate.stage', CPU, 205, 300),
           Ev('chroma.propagate.wait', CPU, 280, 290)]
# what a range marked on the card's timeline would add
MARKS = [Ev('chroma.sim.event', GPU, 100, 150),
         Ev('chroma.propagate.stage', GPU, 205, 300)]

# the card idles from 50 to 220: in daq.block to 60, in daq.run to 98,
# outside to 100, in sim.event to 150, outside to 205, in the stage to 220
IDLE = {'chroma.daq.block': 10e-9, 'chroma.daq.run': 38e-9,
        'chroma.sim.event': 50e-9, 'chroma.propagate.stage': 15e-9,
        'outside': 57e-9}


def held(events):
    "A stand-in for the torch.profiler the harness holds."
    results = types.SimpleNamespace(events=lambda: list(events))
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def test_program_ranges_leave_the_reduction_as_it_was():
    a = trace.summarize(BENCH, 1e-6)
    b = trace.summarize(BENCH + PROGRAM, 1e-6)
    assert b.busy_s == a.busy_s and b.window_s == a.window_s
    assert b.span_s == a.span_s and b.kernel_s == a.kernel_s
    assert b.idle == a.idle and b.breakdown() == a.breakdown()


@pytest.mark.parametrize('marks', [[], MARKS], ids=['plain', 'marked'])
def test_idle_goes_to_the_innermost_program_span(marks):
    idle, n = program.reduce(BENCH + PROGRAM + marks, 'chroma.')
    assert n == len(PROGRAM)
    assert idle == {k: pytest.approx(v) for k, v in IDLE.items()}
    gaps = trace.gaps([(10, 40), (30, 50), (220, 300)])
    assert sum(idle.values()) == pytest.approx(
        sum(b - a for a, b in gaps) * 1e-9)


def test_readers_take_shares_of_the_window(monkeypatch):
    s = trace.Summary(busy_s=110e-9, window_s=400e-9, kernel_s={},
                      op_s={}, span_s={}, idle=[])
    reads = []

    def found():
        reads.append(1)
        return held(BENCH + PROGRAM)
    monkeypatch.setattr(program, '_held_profiler', found)
    r = run_of([dict(photons=1)] * 4, 1.0, trace=s, counters={
        'propagate.tail_steps': 6, 'graphs.captures': 0})
    assert reader('driver_idle').read(r) == pytest.approx(3.75)
    assert reader('daq_idle').read(r) == pytest.approx(12.0)
    assert reader('sim_host_idle').read(r) == pytest.approx(12.5)
    assert reader('camera_host_idle').read(r) == 0.0
    assert len(reads) == 1              # the trace is read once a run
    assert reader('tail_steps_per_event').read(r) == 1.5
    assert reader('graph_captures').read(r) == 0.0


IDLE_READERS = ('driver_idle', 'daq_idle', 'sim_host_idle',
                'camera_host_idle')


def test_readers_stay_silent_without_program_spans(monkeypatch):
    s = trace.Summary(busy_s=1, window_s=1, kernel_s={}, op_s={},
                      span_s={}, idle=[])
    for name in IDLE_READERS + ('tail_steps_per_event', 'graph_captures'):
        assert reader(name).read(run_of([dict(photons=1)], 1.0)) is None
    # a trace, but no profiler held by any caller
    for name in IDLE_READERS:
        assert reader(name).read(run_of([], 1.0, trace=s)) is None
    # a profiler whose trace holds no program range (a program without
    # spans)
    monkeypatch.setattr(program, '_held_profiler', lambda: held(BENCH))
    for name in IDLE_READERS:
        assert reader(name).read(run_of([], 1.0, trace=s)) is None
    # a program whose profiler declares no span prefix
    monkeypatch.setattr(program, '_held_profiler',
                        lambda: held(BENCH + PROGRAM))
    monkeypatch.setattr(program, 'prefix', lambda: None)
    for name in IDLE_READERS:
        assert reader(name).read(run_of([], 1.0, trace=s)) is None


def test_the_held_profiler_is_found_in_a_callers_frame():
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU])

    def reader_of_metrics():
        return program._held_profiler()
    assert reader_of_metrics() is prof
