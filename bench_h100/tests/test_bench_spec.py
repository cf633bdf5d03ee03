"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, entry, limit and metric is data found by name, and a cell
is added by new files and an entry alone."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from bench_h100.harness import cell

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
SPEC = cell.load_spec()


def test_top_level_keys_and_command():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert SPEC['command'] == ['python3', 'bench_h100/run.py']
    assert SPEC['paths'] == ['bench_h100']
    assert 1 <= SPEC['run_seconds'] <= 51


@pytest.mark.parametrize('work', SPEC['workloads'], ids=lambda w: w['name'])
def test_cell_found_by_name(work):
    assert NAME.match(work['name']) and work['chips'] == 1
    ctx = cell.context(work['name'], 1, 'cpu')
    assert ctx.cfg['name'] == work['config']
    assert hasattr(ctx.config_module, 'port_geometry')
    assert hasattr(ctx.config_module, 'reference_scene')
    entry = os.path.join(cell.BENCH, 'entries', ctx.mix['entry'] + '.py')
    assert os.path.exists(entry)
    assert set(cell.limits(work['name']))
    kinds = {m['name'] for m in cell.cell_metrics(SPEC, work['name'],
                                                  'end_to_end')}
    assert 'setup_s' in kinds and len(kinds) >= 2
    assert cell.cell_metrics(SPEC, work['name'], 'per_layer')


@pytest.mark.parametrize('metric', SPEC['end_to_end'] + SPEC['per_layer'],
                         ids=lambda m: m['name'])
def test_metric_has_reader(metric):
    assert NAME.match(metric['name']) and UNIT.match(metric['unit'])
    assert metric['better'] in ('lower', 'higher')
    if metric['name'] != 'setup_s':
        path = os.path.join(cell.BENCH, 'metrics', metric['name'] + '.py')
        reader = cell.load_module(path, 'bench_h100.metrics.'
                                  + metric['name'])
        assert callable(reader.read)
    for w in metric.get('workloads', []):
        cell.find(SPEC['workloads'], w, 'workload')
    if metric in SPEC['end_to_end']:
        assert 0.01 <= metric['bound'] <= 0.25
        assert metric['source'] in ('host_clock', 'device_trace')
    else:
        moved = cell.find(SPEC['end_to_end'], metric['moves'], 'metric')
        for w in metric['workloads']:
            assert 'workloads' not in moved or w in moved['workloads']


@pytest.mark.parametrize('conf', SPEC['configs'], ids=lambda c: c['name'])
def test_config_file_states_its_cut(conf):
    with open(os.path.join(cell.ROOT, conf['file'])) as f:
        cfg = json.load(f)
    assert cfg['name'] == conf['name']
    assert cfg['reduced'] == conf['reduced']
    assert all(NAME.match(k) for k in conf['reduced'])
    assert 'assumed' in cfg


def test_cell_added_by_files_and_an_entry(tmp_path):
    """A copy of the benchmark gains a traffic mix, a metric reader and a
    cell by new files and one entry in BENCHMARK.json; the harness finds
    them without an edit to any file it had."""
    root = tmp_path / 'checkout'
    shutil.copytree(cell.BENCH, root / 'bench_h100',
                    ignore=shutil.ignore_patterns('.cache', '__pycache__'))
    spec = json.loads(json.dumps(SPEC))
    spec['workloads'].append({'name': 'quick.small', 'config': 'quick',
                              'traffic': 'small', 'chips': 1,
                              'why': 'a test cell'})
    spec['per_layer'].append({'name': 'calls_seen', 'unit': 'calls',
                              'better': 'higher', 'source': 'host_clock',
                              'layer': 'test', 'moves': 'photons_per_s',
                              'workloads': ['quick.small']})
    spec['end_to_end'][0].setdefault('workloads', []).append('quick.small')
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))
    mix = json.loads((root / 'bench_h100/traffic/bomb.json').read_text())
    mix['photons'] = 4096
    (root / 'bench_h100/traffic/small.json').write_text(json.dumps(mix))
    (root / 'bench_h100/metrics/calls_seen.py').write_text(
        'def read(run):\n    return len(run.calls)\n')
    (root / 'bench_h100/limits/quick.small.json').write_text(
        (root / 'bench_h100/limits/quick.bomb.json').read_text())
    code = ('import json; from bench_h100.harness import cell\n'
            'ctx = cell.context("quick.small", 1, "cpu")\n'
            'names = [m["name"] for m in cell.cell_metrics(ctx.spec, '
            '"quick.small", "per_layer")]\n'
            'r = cell.load_module("bench_h100/metrics/calls_seen.py", '
            '"bench_h100.metrics.calls_seen")\n'
            'run = cell.Run(ctx, [{}, {}], 1.0, 0.0)\n'
            'print(json.dumps([ctx.mix["photons"], names, r.read(run)]))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(root)))
    assert out.returncode == 0, out.stderr
    photons, names, seen = json.loads(out.stdout.splitlines()[-1])
    assert photons == 4096 and names == ['calls_seen'] and seen == 2
