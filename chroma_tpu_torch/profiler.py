"""Profiling facade of the torch port (counterpart of chroma_tpu.profiler;
reference: chroma/gpu/profiler.py + cuda/profile.h): the port's one
tracing system.

Three mechanisms, all opt-in like the reference:

  * spans -- `region(name)` around a layer or stage of the program. When
    the profiler is enabled a span accumulates calls/total/min/max of its
    host time under `name` (report(), chroma-profile), and opens a
    torch.profiler host range `chroma.<base>`, where <base> is the name up
    to any '[' (propagate.fused[n=4194304] -> chroma.propagate.fused). The
    range lands in any torch.profiler trace, nested under its parent span
    and on the clock of the card's activity, so the card's idle time can
    be put down to the span the host was in. The range is torch's fast
    record function: it marks the host's timeline only, not the card's.
    When disabled, region() returns one shared no-op context;
  * counters -- `count(name, n)`: the drivers count once per call (a stage,
    a capture, a read), never per step, from what they already hold on
    the host, so a counter adds no device sync;
  * device traces -- trace(logdir) wraps torch.profiler and writes a
    Chrome trace (chrome://tracing, Perfetto) holding the spans.

Enable with CHROMA_PROFILE=1 (auto-report at exit with
CHROMA_PROFILE_AUTOREPORT=1), as the JAX package does. A span's host time
around asynchronous CUDA work measures the enqueue, unless the code inside
synchronises.
"""
from __future__ import annotations

import atexit
import contextlib
import os
import time
from collections import defaultdict

import torch

PREFIX = 'chroma.'

_OFF = contextlib.nullcontext()


def _range(name):
    "A torch.profiler host range named `name` (no device-side mark)."
    return torch._C._profiler._RecordFunctionFast(name)


class RegionStats(object):
    __slots__ = ('calls', 'total', 'min', 'max', 'first')

    def __init__(self):
        self.calls = 0
        self.total = 0.0
        self.min = float('inf')
        self.max = 0.0
        self.first = 0.0   # first call: includes kernel builds and warm-up

    def add(self, dt):
        if self.calls == 0:
            self.first = dt
        self.calls += 1
        self.total += dt
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)


class _Span(object):
    "An enabled region: its host range and its host-clock statistics."
    __slots__ = ('stats', 'range', 't0')

    def __init__(self, stats, name):
        self.stats = stats
        self.range = _range(PREFIX + name.split('[', 1)[0])

    def __enter__(self):
        self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.stats.add(time.perf_counter() - self.t0)
        self.range.__exit__(*exc)


class Profiler(object):
    def __init__(self, enabled=False):
        self.enabled = enabled
        self.regions = defaultdict(RegionStats)
        self.counters = defaultdict(int)

    def region(self, name):
        "A span around a code region (a shared no-op when disabled)."
        if not self.enabled:
            return _OFF
        return _Span(self.regions[name], name)

    def count(self, name, n=1):
        if self.enabled:
            self.counters[name] += int(n)

    def report(self, out=None):
        "Print a sorted timing table (reference: profiler.py:155-173)."
        import sys
        out = out or sys.stderr
        if not self.regions and not self.counters:
            print('profiler: nothing recorded', file=out)
            return
        rows = sorted(self.regions.items(), key=lambda kv: -kv[1].total)
        print('%-32s %8s %10s %10s %10s %10s %10s'
              % ('region', 'calls', 'total_ms', 'mean_ms', 'min_ms',
                 'max_ms', 'first_ms'), file=out)
        for name, st in rows:
            print('%-32s %8d %10.1f %10.2f %10.2f %10.2f %10.2f'
                  % (name, st.calls, st.total * 1e3,
                     st.total / st.calls * 1e3, st.min * 1e3,
                     st.max * 1e3, st.first * 1e3), file=out)
        for name in sorted(self.counters):
            print('%-32s %12d' % (name, self.counters[name]), file=out)

    def reset(self):
        self.regions.clear()
        self.counters.clear()

    @contextlib.contextmanager
    def trace(self, logdir='chroma_tpu_torch_trace'):
        """Capture a torch.profiler trace of the block (host ops and the
        enabled spans, and CUDA kernels when a card is present) as a
        Chrome trace in `logdir`."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        path = os.path.join(logdir, 'trace.json')
        prof.export_chrome_trace(path)
        print('torch profiler trace written to %s' % path)


# global instance, enabled by environment like the reference
profiler = Profiler(enabled=bool(os.environ.get('CHROMA_PROFILE')))

if os.environ.get('CHROMA_PROFILE_AUTOREPORT'):
    atexit.register(profiler.report)
