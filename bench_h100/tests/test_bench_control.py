"""The comparison fails what it must: the lower-precision control (the
reference in bfloat16 in the program's place) and a run of the harness
with the timed path broken underneath each come out not correct, where
the program itself comes out correct. CPU, small sizes."""
from __future__ import annotations

import time

import pytest
import torch

from bench_h100 import control
from bench_h100.harness import cell
from bench_h100.tests.bench_fixtures import small, small_judge  # noqa: F401

PHOTONS = 1 << 14


@pytest.fixture(scope='module')
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp('bench_cache'))


def readings(side, seed, cache):
    return control.readings(side, 'quick.bomb', seed, 'cpu',
                            small('quick.bomb', PHOTONS), cache_dir=cache)


def test_program_passes_and_control_fails(small_judge, cache):  # noqa: F811
    numbers, ok = readings('program', 31, cache)
    assert ok, numbers
    numbers, ok = readings('control', 31, cache)
    assert not ok, numbers
    lim = cell.limits('quick.bomb')
    failed = [k for k, v in numbers.items() if v > lim[k]]
    assert {'path_faults', 'tally_z', 'daq_charge_gap'} <= set(failed)


def _unchanged_step(monkeypatch):
    from chroma_tpu_torch.ops import propagate
    monkeypatch.setattr(propagate, 'propagate_step',
                        lambda photons, *a, **k: photons)


def _half_batch(monkeypatch):
    import chroma_tpu_torch.sim as sim
    real = sim.propagate

    def half(state, *a, **k):
        m = len(state) // 2
        out = real(state.map(lambda x: x[:m]), *a, **k)
        return out.map(lambda x: x).__class__(**{
            f: torch.cat([getattr(out, f), getattr(state, f)[m:]])
            for f in state.__dataclass_fields__})
    monkeypatch.setattr(sim, 'propagate', half)


def _nll_altered(monkeypatch):
    from chroma_tpu_torch.likelihood import Likelihood
    real = Likelihood.eval

    def altered(self, *a, **k):
        return real(self, *a, **k) + 0.05
    monkeypatch.setattr(Likelihood, 'eval', altered)


def _daq_time_altered(monkeypatch):
    from chroma_tpu_torch.ops import daq
    real = daq.run_daq

    def altered(*a, **k):
        out = real(*a, **k)
        hit = torch.nonzero(out.earliest_time < daq.HIT_TIME_CUT)[0, 0]
        out.earliest_time[hit] += 1.0
        return out
    monkeypatch.setattr(daq, 'run_daq', altered)


def _end_position_altered(monkeypatch):
    import chroma_tpu_torch.sim as sim
    real = sim.propagate

    def moved(*a, **k):
        out = real(*a, **k)
        return out.replace(pos=out.pos + 0.5 * out.dir)
    monkeypatch.setattr(sim, 'propagate', moved)


@pytest.mark.parametrize('fault', [_unchanged_step, _half_batch,
                                   _daq_time_altered, _end_position_altered],
                         ids=lambda f: f.__name__.strip('_'))
def test_broken_timed_path_is_not_correct(fault, monkeypatch, small_judge,  # noqa: F811
                                          cache):
    """The harness's run with its look for a card skipped (device cpu),
    the program broken under the timed path."""
    ov = small('quick.bomb', PHOTONS)
    ov['traffic']['max_steps'] = 100
    ctx = cell.context('quick.bomb', 41, 'cpu', overrides=ov,
                       cache_dir=cache)
    fault(monkeypatch)
    result, compared = cell.run_cell(ctx, 0.01, False, time.perf_counter(),
                                     log=lambda msg: None)
    assert result['correct'] is False, compared
    assert set(compared) == set(cell.limits('quick.bomb'))


LIKELIHOOD_PHOTONS = 600


def test_likelihood_program_passes_and_control_fails(cache):
    ov = small('quick.likelihood', LIKELIHOOD_PHOTONS)
    numbers, ok = control.readings('program', 'quick.likelihood', 61, 'cpu',
                                   ov, cache_dir=cache)
    assert ok, numbers
    numbers, ok = control.readings('control', 'quick.likelihood', 61, 'cpu',
                                   ov, cache_dir=cache)
    assert not ok, numbers
    lim = cell.limits('quick.likelihood')
    assert numbers['nll_gap'] > lim['nll_gap'], numbers


@pytest.mark.parametrize('fault', [_unchanged_step, _half_batch,
                                   _daq_time_altered, _nll_altered],
                         ids=lambda f: f.__name__.strip('_'))
def test_broken_likelihood_is_not_correct(fault, monkeypatch, cache):
    from bench_h100.entries import likelihood
    monkeypatch.setattr(likelihood, 'KEEP_ONE_IN', 1)
    ov = small('quick.likelihood', LIKELIHOOD_PHOTONS)
    ctx = cell.context('quick.likelihood', 67, 'cpu', overrides=ov,
                       cache_dir=cache)
    fault(monkeypatch)
    result, compared = cell.run_cell(ctx, 0.01, False, time.perf_counter(),
                                     log=lambda msg: None)
    assert result['correct'] is False, compared
    assert set(compared) == set(cell.limits('quick.likelihood'))


def test_render_control_fails(cache, monkeypatch):
    from bench_h100.entries import snapshot
    from bench_h100.tests.bench_fixtures import TINY_QUICK
    monkeypatch.setattr(snapshot, 'PIXELS', 2000)
    ov = {'traffic': {'width': 160, 'height': 90},
          'config': dict(TINY_QUICK, scene_radius_mm=2500.0)}
    numbers, ok = control.readings('program', 'quick.render', 5, 'cpu', ov,
                                   cache_dir=cache)
    assert ok, numbers
    numbers, ok = control.readings('control', 'quick.render', 5, 'cpu', ov,
                                   cache_dir=cache)
    assert not ok, numbers


def test_sound_run_is_correct(small_judge, cache):  # noqa: F811
    ov = small('quick.bomb', PHOTONS)
    ctx = cell.context('quick.bomb', 43, 'cpu', overrides=ov,
                       cache_dir=cache)
    result, compared = cell.run_cell(ctx, 0.01, False, time.perf_counter(),
                                     log=lambda msg: None)
    assert result['correct'] is True, compared
    assert set(result['metrics']) == {'photons_per_s', 'event_p95_ms',
                                      'setup_s'}
    assert list(result)[-1] == 'compared'


def _peel_unchanged(monkeypatch):
    from chroma_tpu_torch.ops import render
    real = render.peel

    def stuck(origin, direction, geometry, alpha_depth):
        first = next(real(origin, direction, geometry, alpha_depth))
        for _ in range(alpha_depth):
            yield first
    monkeypatch.setattr(render, 'peel', stuck)


def _half_frame(monkeypatch):
    from chroma_tpu_torch import camera
    real = camera.render

    def half(origin, direction, geometry_arrays, **kw):
        out = real(origin, direction, geometry_arrays, **kw)
        out[len(out) // 2:] = -1
        return out
    monkeypatch.setattr(camera, 'render', half)


def _pixels_altered(monkeypatch):
    from chroma_tpu_torch import camera
    real = camera._pixels_to_image

    def altered(pixels, size):
        img = real(pixels, size)
        img[..., 2] = img[..., 2] // 2
        return img
    monkeypatch.setattr(camera, '_pixels_to_image', altered)


@pytest.mark.parametrize('fault', [_peel_unchanged, _half_frame,
                                   _pixels_altered],
                         ids=lambda f: f.__name__.strip('_'))
def test_broken_frame_is_not_correct(fault, monkeypatch, cache):
    from bench_h100.entries import snapshot
    from bench_h100.tests.bench_fixtures import TINY_QUICK
    monkeypatch.setattr(snapshot, 'PIXELS', 2000)
    ov = {'traffic': {'width': 160, 'height': 90},
          'config': dict(TINY_QUICK, scene_radius_mm=2500.0)}
    ctx = cell.context('quick.render', 47, 'cpu', overrides=ov,
                       cache_dir=cache)
    fault(monkeypatch)
    result, compared = cell.run_cell(ctx, 0.01, False, time.perf_counter(),
                                     log=lambda msg: None)
    assert result['correct'] is False, compared
