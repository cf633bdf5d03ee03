"""The program's own spans in a traced run.

chroma_tpu_torch's profiler, which the harness enables for a traced
window, opens a torch.profiler host range `chroma.<layer>.<what>` at each
layer and stage boundary of the program (chroma_tpu_torch/profiler.py;
PERF.md section 3 lists them). This module reads those ranges beside the
card's activity in the same trace: the card's idle time by the host's
innermost `chroma.` range, `outside` for idle time in none. The gaps are
those of harness/trace.py (every kernel, copy and memset; span marks on
the card's timeline skipped), so the values sum to the trace's total gap
time, and nothing of trace.py's Summary changes.

The Summary keeps no raw events, so `idle(run)` reads them once more from
the torch.profiler the harness still holds while it reads the metrics
(found among the callers' locals), once a run. A program that marks no
spans (its profiler declares no PREFIX), a run without a trace and a
trace without a program range all read None.
"""
from __future__ import annotations

import sys
import time

import torch

from bench_h100.harness import trace

OUTSIDE = 'outside'
TOP = 10


def prefix():
    "The program's span prefix, or None when it marks no spans."
    from chroma_tpu_torch import profiler
    return getattr(profiler, 'PREFIX', None)


def reduce(events, mark):
    """({innermost `mark` span, or OUTSIDE: the card's idle seconds in the
    gaps between its operations}, number of `mark` ranges) of raw
    profiler events (times in ns)."""
    cpu = torch.autograd.DeviceType.CPU
    dev_iv, spans = [], []
    for e in events:
        name = e.name()
        if e.device_type() == cpu:
            if name.startswith(mark):
                a = e.start_ns()
                spans.append((a, a + e.duration_ns(), name))
            continue
        if name.startswith(('bench.', mark)):
            continue            # a range's mark on the card's timeline
        a = e.start_ns()
        dev_iv.append((a, a + e.duration_ns()))
    spans.sort()
    idle = trace.idle_by_span(trace.gaps(dev_iv), trace.flatten(spans))
    idle[OUTSIDE] = idle.pop('host', 0.0)
    return dict(idle), len(spans)


def _held_profiler():
    "The torch.profiler.profile a calling frame holds, or None."
    kind = torch.profiler.profile
    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, kind):
                return value
        frame = frame.f_back
    return None


def idle(run):
    """The run's {span: idle seconds} (see reduce), or None; read once a
    run and logged (the ten longest) to standard error."""
    if run.trace is None:
        return None
    if '_program_idle' not in vars(run):
        run._program_idle = _read(run)
    return run._program_idle


def _read(run):
    mark = prefix()
    prof = _held_profiler() if mark else None
    if prof is None:
        return None
    t0 = time.perf_counter()
    out, n = reduce(prof.profiler.kineto_results.events(), mark)
    if not n:
        return None
    top = sorted(out.items(), key=lambda kv: -kv[1])[:TOP]
    print('program spans: %d %s ranges read in %.3f s; the card idle %.6f s '
          'of %.6f s in the window, by innermost span: %s' % (
              n, mark, time.perf_counter() - t0, sum(out.values()),
              run.trace.window_s, ', '.join('%s %.6f' % kv for kv in top)),
          file=sys.stderr, flush=True)
    return out


def share(run, prefixes):
    """The card's idle time under program spans whose names start with any
    of `prefixes`, in percent of the traced window; None as idle()."""
    out = idle(run)
    if out is None:
        return None
    return 100.0 * sum(s for name, s in out.items()
                       if name.startswith(prefixes)) / run.trace.window_s
