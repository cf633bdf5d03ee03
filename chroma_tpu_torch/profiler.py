"""Profiling facade of the torch port (counterpart of chroma_tpu.profiler;
reference: chroma/gpu/profiler.py + cuda/profile.h).

Three mechanisms, all opt-in like the reference:

  * host region timers -- accumulate calls/total/min/max per named region;
    regions are recorded by the Simulation/propagate drivers when
    profiling is on;
  * step counters -- the propagate driver reports steps executed, the
    live-lane integral and the survivors of each chunk (the analog of
    cuda/profile.h's region counters), from counts it already holds on
    the host, so they add no device sync;
  * device traces -- trace(logdir) wraps torch.profiler and writes a
    Chrome trace (chrome://tracing, Perfetto).

Enable with CHROMA_PROFILE=1 (auto-report at exit with
CHROMA_PROFILE_AUTOREPORT=1), as the JAX package does. A region times the
host: around asynchronous CUDA work it measures the enqueue, unless the
code inside synchronises.
"""
from __future__ import annotations

import atexit
import contextlib
import os
import time
from collections import defaultdict


class RegionStats(object):
    __slots__ = ('calls', 'total', 'min', 'max', 'last', 'first')

    def __init__(self):
        self.calls = 0
        self.total = 0.0
        self.min = float('inf')
        self.max = 0.0
        self.last = 0.0
        self.first = 0.0   # first call: includes kernel builds and warm-up

    def add(self, dt):
        if self.calls == 0:
            self.first = dt
        self.calls += 1
        self.total += dt
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)
        self.last = dt


class Profiler(object):
    def __init__(self, enabled=False):
        self.enabled = enabled
        self.regions = defaultdict(RegionStats)
        self.counters = defaultdict(int)

    @contextlib.contextmanager
    def region(self, name):
        "Time a code region (no-op when disabled)."
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.regions[name].add(time.perf_counter() - t0)

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
        """Capture a torch.profiler trace of the block (host ops, and CUDA
        kernels when a card is present) as a Chrome trace in `logdir`."""
        import torch
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
