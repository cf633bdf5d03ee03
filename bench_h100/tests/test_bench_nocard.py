"""A measuring run without a card fails and prints no result; a trace
that holds no device operation fails rather than reading the host."""
from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from bench_h100.harness import cell, trace


def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    out = subprocess.run(
        [sys.executable, 'bench_h100/run.py', '--workload', 'quick.bomb',
         '--seed', '2147483659', '--seconds', '1', '--trace', '0'],
        cwd=cell.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
    assert 'CUDA' in out.stderr


def test_benchmark_alone_cannot_build_a_cell(tmp_path):
    """BENCHMARK.json and the benchmark's folder alone, without the
    program beside them, build nothing: the set-up fails."""
    import shutil
    shutil.copytree(cell.BENCH, tmp_path / 'bench_h100',
                    ignore=shutil.ignore_patterns('.cache', '__pycache__'))
    shutil.copy(os.path.join(cell.ROOT, 'BENCHMARK.json'), tmp_path)
    code = ('from bench_h100.harness import cell\n'
            'ctx = cell.context("quick.bomb", 1, "cpu")\n'
            'ctx.config_module.port_geometry(ctx.cfg, ctx.cache_dir)\n'
            'print("built")\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode != 0 and 'built' not in out.stdout
    assert 'chroma_tpu_torch' in out.stderr


def test_trace_without_device_time_fails():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(10).sum()
    with pytest.raises(RuntimeError, match='no device operation'):
        trace.summarize(prof.profiler.kineto_results.events(), 1.0)
