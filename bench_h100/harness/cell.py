"""One run of one cell: set-up, warm-up, the measured window, the
judgement against the reference, the metrics, the result line.

Everything a cell names is found by name under the benchmark's folder:
configs/<config>.json (sizes) and configs/<config>.py (the program's
build and the reference's), traffic/<mix>.json, entries/<entry>.py (the
program entry a mix drives), metrics/<metric>.py (one reader a metric)
and limits/<workload>.json (the limit of each number compared).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time

import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'chroma_tpu')


def load_module(path, name):
    "Import a benchmark file by its path, once a process, as `name`."
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def load_spec(root=ROOT):
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        return json.load(f)


def find(items, name, what):
    for it in items:
        if it['name'] == name:
            return it
    raise KeyError('no %s named %r in BENCHMARK.json' % (what, name))


def cell_metrics(spec, workload, kind):
    "The metrics of `kind` ('end_to_end' or 'per_layer') a cell reports."
    return [m for m in spec[kind]
            if 'workloads' not in m or workload in m['workloads']]


def forbidden_modules():
    "Top-level names of loaded modules the benchmark may not load."
    return sorted({name.split('.')[0] for name in sys.modules}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    spec: dict
    cell: dict
    cfg: dict
    config_module: object
    mix: dict
    seed: int
    device: torch.device
    cache_dir: str


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    ctx: Context
    calls: list
    window_s: float
    setup_s: float
    trace: object = None       # harness.trace.Summary of a traced run
    counters: dict = None      # the program's profiler counters
    facts: dict = None         # the judge's counts (reference photon-steps)


def config(name, overrides=None):
    """(sizes, module) of configuration `name`: configs/<name>.json and
    configs/<name>.py; `overrides` updates the sizes."""
    with open(os.path.join(BENCH, 'configs', name + '.json')) as f:
        cfg = json.load(f)
    cfg.update(overrides or {})
    module = load_module(os.path.join(BENCH, 'configs', name + '.py'),
                         'bench_h100.configs.' + name)
    return cfg, module


def context(workload, seed, device, spec=None, overrides=None,
            cache_dir=None):
    """The cell's pieces, found by name. `overrides` (tests) updates the
    configuration and mix dictionaries; `cache_dir` (tests) replaces the
    checkout's cache directory."""
    spec = spec or load_spec()
    cell = find(spec['workloads'], workload, 'workload')
    find(spec['configs'], cell['config'], 'config')
    overrides = overrides or {}
    cfg, module = config(cell['config'], overrides.get('config'))
    mix = load_json('traffic', cell['traffic'] + '.json')
    mix.update(overrides.get('traffic', {}))
    cache_dir = cache_dir or os.path.join(BENCH, '.cache')
    os.makedirs(cache_dir, exist_ok=True)
    return Context(spec, cell, cfg, module, mix, int(seed),
                   torch.device(device), cache_dir)


def limits(workload):
    return load_json('limits', workload + '.json')


def judged(workload, numbers):
    """(each number beside its limit, whether every number is within its
    limit). A number that cannot be read (no hit where one must be) is
    inf, and JSON has no inf: it is written as the largest double."""
    lim = limits(workload)
    compared = {k: {'value': v if math.isfinite(v) else sys.float_info.max,
                    'limit': lim[k]} for k, v in numbers.items()}
    return compared, all(v <= lim[k] for k, v in numbers.items())


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize()


def run_cell(ctx, seconds, trace, t_process, log=None):
    """One run: returns (result dict, compared numbers with limits)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    entry_mod = load_module(os.path.join(BENCH, 'entries',
                                         ctx.mix['entry'] + '.py'),
                            'bench_h100.entries.' + ctx.mix['entry'])
    entry = entry_mod.Entry(ctx)
    dev = ctx.device
    entry.setup()
    for index in entry.warm_indices():
        entry.call(index, window=False)
    _sync(dev)
    spans = None
    prof = None
    if trace:
        from bench_h100.harness import trace as tr
        spans = tr.Spans(entry.SPANS)
        prof = tr.start()
        spans.install()
    from chroma_tpu_torch.profiler import profiler
    profiler.reset()
    profiler.enabled = bool(trace)
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    calls = []
    index = 0
    while True:
        calls.append(entry.call(index, window=True))
        index += 1
        if time.perf_counter() - t_window >= seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - t_window
    profiler.enabled = False
    counters = dict(profiler.counters)
    summary = None
    if trace:
        spans.remove()
        t_trace = time.perf_counter()
        summary = tr.stop(prof, window_s, log)
        log('trace read in %.3f s' % (time.perf_counter() - t_trace))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' else 0
    bad = forbidden_modules()
    if bad:
        raise SystemExit('loaded after the window: %s' % ', '.join(bad))
    lat = sorted(c['latency_s'] for c in calls)
    log('window: %d calls in %.3f s; set-up %.3f s; call walls ms: median '
        '%.1f, p95 %.1f, max %.1f, slowest %s' % (
            len(calls), window_s, setup_s, 1e3 * lat[len(lat) // 2],
            1e3 * lat[max(0, -(-95 * len(lat) // 100) - 1)], 1e3 * lat[-1],
            ' '.join('%.0f' % (1e3 * x) for x in lat[-8:])))
    entry.release()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers, facts = entry.judge(entry.reference_scene())
    log('reference and judge: %.3f s' % (time.perf_counter() - t_ref))
    run = Run(ctx, calls, window_s, setup_s, summary, counters, facts)
    kind = 'per_layer' if trace else 'end_to_end'
    metrics = {}
    for m in cell_metrics(ctx.spec, ctx.cell['name'], kind):
        if m['name'] == 'setup_s':
            value = setup_s
        else:
            reader = load_module(os.path.join(BENCH, 'metrics',
                                              m['name'] + '.py'),
                                 'bench_h100.metrics.' + m['name'])
            value = reader.read(run)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    compared, correct = judged(ctx.cell['name'], numbers)
    device = device_info(dev, peak)
    if trace:
        device.update(busy_s=summary.busy_s, window_s=summary.window_s)
    result = {'correct': correct, 'attempted': len(calls), 'failed': 0,
              'metrics': metrics, 'device': device}
    if trace:
        result['breakdown'] = summary.breakdown()
    result['compared'] = compared
    return result, compared


def device_info(dev, peak):
    if dev.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                'memory_peak_bytes': peak}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(dev),
            'count': 1, 'memory_peak_bytes': int(peak)}

