"""The metric arithmetic on synthetic inputs: a rate over the whole
window, a p95 over all calls, the idle share from overlapping device
intervals, and roofline shares from fixed bytes a photon-step."""
from __future__ import annotations

import math

import pytest

from bench_h100.harness import cell, roofline, trace, traffic


def reader(name):
    return cell.load_module('%s/metrics/%s.py' % (cell.BENCH, name),
                            'bench_h100.metrics.' + name)


def run_of(calls, window_s, **kw):
    return cell.Run(None, calls, window_s, 0.0, **kw)


def test_rate_is_all_work_over_the_whole_window():
    calls = [dict(photons=100, latency_s=0.1) for _ in range(7)]
    # a window of 2 s holds 700 photons, whatever the calls' own walls
    assert reader('photons_per_s').read(run_of(calls, 2.0)) == 350.0


def test_p95_is_over_every_call():
    lat = [i / 1000 for i in range(1, 201)]          # 1 .. 200 ms
    calls = [dict(photons=1, latency_s=x) for x in lat]
    assert reader('event_p95_ms').read(run_of(calls, 1.0)) == \
        pytest.approx(190.0)
    assert traffic.p95([5.0]) == 5.0
    assert traffic.p95([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                        16, 17, 18, 19, 100]) == 19


def test_idle_share_from_overlapping_intervals():
    iv = [(0, 10), (5, 20), (30, 40), (35, 36), (50, 50)]
    assert trace.union_seconds(iv) == 30
    assert trace.gaps(iv) == [(20, 30), (40, 50)]
    s = trace.Summary(busy_s=0.3, window_s=1.2, kernel_s={}, op_s={},
                      span_s={'bench.daq': 0.06}, idle=[])
    r = run_of([], 1.2, trace=s)
    assert reader('device_idle.sim').read(r) == pytest.approx(75.0)
    assert reader('daq_share').read(r) == pytest.approx(20.0)


class Ev:
    "A raw profiler event as the trace reduction reads it."

    def __init__(self, name, dev, a, b, corr=0):
        self._n, self._d, self._a, self._b, self._c = name, dev, a, b, corr

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return 0


def test_trace_reduction_from_raw_events():
    import torch
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ev = [Ev('bench.daq', cpu, 0, 100), Ev('bench.propagate', cpu, 200, 400),
          Ev('cudaLaunchKernel', cpu, 5, 8, 1),
          Ev('cudaGraphLaunch', cpu, 210, 215, 2),
          Ev('cudaMemcpyAsync', cpu, 90, 95, 3),
          Ev('scatter_kernel', gpu, 10, 40, 1),
          Ev('Memcpy DtoH', gpu, 30, 50, 3),
          Ev('visit_warp_kernel', gpu, 220, 300, 2),
          Ev('bench.daq', gpu, 10, 60)]
    s = trace.summarize(ev, 1e-6)
    assert s.busy_s == pytest.approx(120e-9)
    assert s.kernel_s == {'scatter_kernel': pytest.approx(30e-9),
                          'visit_warp_kernel': pytest.approx(80e-9)}
    assert s.span_s['bench.daq'] == pytest.approx(50e-9)
    assert s.span_s['bench.propagate'] == pytest.approx(80e-9)
    # the card idles from 50 to 220: to 100 in bench.daq, to 200 outside
    # every span, to 220 in bench.propagate
    assert dict(s.idle) == {'bench.daq': pytest.approx(50e-9),
                            'host': pytest.approx(100e-9),
                            'bench.propagate': pytest.approx(20e-9)}
    assert s.idle[0][0] == 'host'
    assert s.kernel_seconds(('visit_',)) == pytest.approx(80e-9)
    assert set(s.breakdown()) == {'device_ops', 'idle_gaps'}


def test_nested_spans_flatten_to_the_innermost():
    spans = [(0, 100, 'bench.packing'), (20, 40, 'bench.pixels_to_host'),
             (60, 70, 'bench.other'), (150, 200, 'bench.rays')]
    assert trace.flatten(spans) == [
        (0, 20, 'bench.packing'), (20, 40, 'bench.pixels_to_host'),
        (40, 60, 'bench.packing'), (60, 70, 'bench.other'),
        (70, 100, 'bench.packing'), (150, 200, 'bench.rays')]
    idle = trace.idle_by_span([(30, 65), (120, 160)], trace.flatten(spans))
    assert idle == {'bench.pixels_to_host': pytest.approx(10e-9),
                    'bench.packing': pytest.approx(20e-9),
                    'bench.other': pytest.approx(5e-9),
                    'host': pytest.approx(30e-9),
                    'bench.rays': pytest.approx(10e-9)}


def test_roofline_from_fixed_bytes():
    s = trace.Summary(busy_s=1, window_s=1, kernel_s={
        '_Z17visit_warp_kernel5QueryPi': 0.002, 'pre_kernel': 0.001,
        'step_kernel': 0.003, 'wire_walk_kernel': 0.004, 'other': 9.0},
        op_s={}, span_s={}, idle=[])
    calls = [dict(photons=1 << 20)] * 3
    r = run_of(calls, 1.0, trace=s, facts={'steps_per_photon': 2.5})
    steps = 2.5 * 3 * (1 << 20)
    bw = roofline.HBM_BYTES_PER_S
    assert reader('k1_roofline.sim').read(r) == pytest.approx(
        100 * steps * 32 / bw / 0.002)
    assert reader('k2_roofline').read(r) == pytest.approx(
        100 * steps * (2 * 56 + 8) / bw / 0.004)
    # the counts are the interface's, not the kernels' launches
    assert roofline.PHOTON_STATE_BYTES == 56
    r.counters = {'propagate.lane_steps': 4 * steps,
                  'propagate.steps': 120}
    assert reader('lane_efficiency').read(r) == pytest.approx(25.0)
    assert reader('steps_per_event').read(r) == 40


def test_readers_stay_silent_without_their_input():
    r = run_of([dict(photons=1)], 1.0)
    for name in ('k1_roofline.sim', 'k2_roofline', 'k1_roofline.render',
                 'daq_share', 'device_idle.sim', 'lane_efficiency',
                 'steps_per_event'):
        assert reader(name).read(r) is None
    s = trace.Summary(busy_s=1, window_s=1, kernel_s={}, op_s={},
                      span_s={}, idle=[])
    r = run_of([dict(photons=1)], 1.0, trace=s, facts={
        'steps_per_photon': 1.0})
    assert reader('k2_roofline').read(r) is None     # no K2 in the trace


def test_seeded_streams_take_any_seed():
    a = traffic.stream_seed(2 ** 31 + 12345, 7)
    assert a == traffic.stream_seed(2 ** 31 + 12345, 7)
    assert a != traffic.stream_seed(2 ** 31 + 12346, 7)
    assert 0 <= a < 2 ** 63
    assert not math.isnan(float(traffic.sample(100, 5, 2 ** 40, 1)[0]))
