"""Shared pieces of the benchmark's tests: the small CPU versions of the
cells (the quick detector at demo.tiny()'s size, few photons) and the
card fixture."""
from __future__ import annotations

import pytest
import torch

TINY_QUICK = dict(pmt_radius_mm=2000.0, sphere_radius_mm=2500.0,
                  spiral_step_mm=700.0,
                  vertex_region={'ball_radius_mm': 1000.0})


def small(workload, photons):
    "Overrides that shrink a cell to a CPU test's size."
    ov = {'traffic': {'photons': photons, 'photons_per_batch': photons - 1}}
    if workload.endswith('likelihood'):
        ov['traffic'] = {'photons': photons, 'nevals': 2, 'nreps': 2,
                         'ndaq': 4}
    if workload.startswith('quick'):
        ov['config'] = dict(TINY_QUICK)
    return ov


@pytest.fixture
def small_judge(monkeypatch):
    """Judge samples that a CPU test can hold, every event kept, one
    warm-up event (a correctness test needs no captured widths)."""
    from bench_h100.entries import simulate
    monkeypatch.setattr(simulate, 'KEEP_ONE_IN', 1)
    monkeypatch.setattr(simulate, 'PATH_LANES', 1 << 12)
    monkeypatch.setattr(simulate, 'TALLY_LANES', 1 << 13)
    monkeypatch.setattr(simulate.Entry, 'warm_indices',
                        lambda self: [simulate.WARM_INDEX])
    return simulate


@pytest.fixture
def cuda():
    "The card, or a skip: the benchmark measures only on a card."
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the benchmark measures only there')
    return torch.device('cuda:0')
