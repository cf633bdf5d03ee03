"""On the card: a short run of each cell comes out correct and prints the
contract's last line. Skipped without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench_h100.harness import cell
from bench_h100.tests.bench_fixtures import cuda  # noqa: F401

SPEC = cell.load_spec()


@pytest.mark.cuda
@pytest.mark.parametrize('work', [w['name'] for w in SPEC['workloads']])
def test_short_run_is_correct(cuda, work):  # noqa: F811
    out = subprocess.run(
        [sys.executable, 'bench_h100/run.py', '--workload', work, '--seed',
         '2147483701', '--seconds', '3', '--trace', '0'], cwd=cell.ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result['correct'] is True, result
    assert result['device']['platform'] == 'gpu'
    assert set(result) >= {'correct', 'attempted', 'failed', 'metrics',
                           'device'}
