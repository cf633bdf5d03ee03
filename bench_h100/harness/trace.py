"""The traced run: torch.profiler over the window, spans the benchmark
opens around the program's layers, and the reduction of the trace to
device busy time, kernel times by name, each span's device time and
the card's idle time by what the host was doing.

Spans are record_function ranges that the benchmark opens around calls
into the program, only in a traced run; each entry names its own
(`Entry.SPANS`: module, attribute, span name). A device operation belongs
to the innermost span in which the runtime call that launched it
(matched by correlation id) ran; an idle instant to the innermost span
the host was in, or to `host` outside every span.
"""
from __future__ import annotations

import bisect
import collections
import importlib

import torch

TOP = 10


class Spans:
    """record_function ranges around the program's calls, put in by
    replacing attributes (`Class.method` too) and taken out again by
    remove(). `sites` are (module, attribute, span name)."""

    def __init__(self, sites):
        self.sites = list(sites)
        self.saved = []

    def install(self):
        for module, attr, span in self.sites:
            owner = importlib.import_module(module)
            *path, name = attr.split('.')
            for part in path:
                owner = getattr(owner, part)
            fn = getattr(owner, name)
            self.saved.append((owner, name, fn))
            setattr(owner, name, _wrap(fn, span))

    def remove(self):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)
        self.saved = []


def _wrap(fn, span):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(span):
            return fn(*args, **kwargs)
    return wrapped


def start():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop(prof, window_s, log=None):
    import time
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    t1 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    t2 = time.perf_counter()
    summary = summarize(events, window_s)
    if log is not None:
        log('trace: profiler stopped in %.3f s, %d events read in %.3f s, '
            'reduced in %.3f s' % (t1 - t0, len(events), t2 - t1,
                                   time.perf_counter() - t2))
    return summary


def union_seconds(intervals):
    "Total length of the union of (start, end) intervals."
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def flatten(spans):
    """Nested (start, end, name) spans, sorted by start, as adjoining
    (start, end, name) pieces, each named by the innermost span."""
    out, stack, t = [], [], None
    for a, b, name in spans:
        while stack and stack[-1][0] <= a:
            end, inner = stack.pop()
            out.append((t, end, inner))
            t = end
        if stack:
            out.append((t, a, stack[-1][1]))
        stack.append((b, name))
        t = a
    while stack:
        end, inner = stack.pop()
        out.append((t, end, inner))
        t = end
    return [p for p in out if p[1] > p[0]]


def idle_by_span(idle, pieces):
    """Seconds of the (start, end) idle gaps (ns) spent in each piece's
    span (flatten), the rest under 'host'."""
    starts = [p[0] for p in pieces]
    out = collections.Counter()
    for a, b in idle:
        inside = 0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(pieces) and pieces[i][0] < b:
            lo, hi = max(a, pieces[i][0]), min(b, pieces[i][1])
            if hi > lo:
                out[pieces[i][2]] += (hi - lo) * 1e-9
                inside += hi - lo
            i += 1
        out['host'] += (b - a - inside) * 1e-9
    return out


def gaps(intervals):
    "The idle (start, end) gaps between the union's pieces."
    out, end = [], None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


class Summary:
    """The trace reduced: busy_s (union of device operations), window_s,
    kernel_s (device seconds by kernel name), span_s (device seconds of
    the operations launched inside each span), idle (seconds of the
    card's idle time by the host's innermost span, longest first)."""

    def __init__(self, busy_s, window_s, kernel_s, op_s, span_s, idle):
        self.busy_s = busy_s
        self.window_s = window_s
        self.kernel_s = kernel_s
        self.op_s = op_s
        self.span_s = span_s
        self.idle = idle

    def idle_pct(self):
        "The share of the traced window with nothing on the card, in %."
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_seconds(self, patterns):
        "Device seconds of kernels whose name contains any pattern."
        return sum(s for name, s in self.kernel_s.items()
                   if any(p in name for p in patterns))

    def breakdown(self):
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {'device_ops': [[n, s] for n, s in ops],
                'idle_gaps': [[n, s] for n, s in self.idle[:TOP]]}


def summarize(events, window_s):
    """The Summary of the profiler's raw events (times in ns): the device's
    kernels, copies and memsets; the host's runtime calls that launched
    them (matched by correlation id); the bench.* spans. A span's device
    time is that of the operations launched inside it (the innermost
    span holding the launch); the card's idle time inside the window's
    device activity goes to the host's innermost span at each instant."""
    cpu = torch.autograd.DeviceType.CPU
    dev_iv, device_ops = [], []
    op_s, kernel_s = collections.Counter(), collections.Counter()
    launches, spans = {}, []
    for e in events:
        name = e.name()
        if e.device_type() == cpu:
            # host events: only the spans and the runtime calls count
            if name.startswith('bench.'):
                a = e.start_ns()
                spans.append((a, a + e.duration_ns(), name))
            elif name.startswith('cuda'):
                launches[e.correlation_id()] = e.start_ns()
            continue
        if name.startswith('bench.'):
            continue            # the span's own mark on the device timeline
        a = e.start_ns()
        b = a + e.duration_ns()
        dev_iv.append((a, b))
        device_ops.append((e, b - a))
        op_s[name] += (b - a) * 1e-9
        if not name.startswith(('Memcpy', 'Memset')):
            kernel_s[name] += (b - a) * 1e-9
    if not dev_iv:
        raise RuntimeError('the trace holds no device operation: the '
                           'profiler did not trace the card')
    spans.sort()
    pieces = flatten(spans)
    starts = [p[0] for p in pieces]
    span_s = collections.Counter()
    for e, dur in device_ops:
        t = launches.get(e.correlation_id())
        if t is None:
            t = launches.get(e.linked_correlation_id())
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < pieces[i][1]:
            span_s[pieces[i][2]] += dur * 1e-9
    busy = union_seconds(dev_iv) * 1e-9
    idle = idle_by_span(gaps(dev_iv), pieces)
    labelled = sorted(idle.items(), key=lambda kv: -kv[1])
    return Summary(busy, window_s, dict(kernel_s), dict(op_s), dict(span_s),
                   labelled)
