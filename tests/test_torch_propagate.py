"""Ten propagation steps of the torch port against the JAX step loop.

Same photons, same uniforms (the JAX blocks fold_in(fold_in(key, step), b)
injected into the port), no compaction, so lanes line up step by step.
XLA's and torch's log, sin and acos may differ in the last ulp, which can
flip a roulette draw on a rare lane and send its history elsewhere: the
integer fields must agree on at least 99.9% of the lanes (the lanes that
differ are printed), and the floats on the agreeing lanes to rtol 1e-5
with an absolute floor of 1e-5 of each field's scale (ulp differences
compound over ten steps of trigonometry).
Also checks the compaction and write-back of both drivers: the chunked
one (CHROMA_FUSED=0) and the fused bomb under a fixed schedule."""
import numpy as np
import pytest
import torch
import jax

from chroma_tpu.ops import types as jtypes
from chroma_tpu.ops import propagate as jprop
from chroma_tpu.ops.sample import make_key
from chroma_tpu_torch.ops import propagate as tprop
from chroma_tpu_torch.ops import types as ttypes
from chroma_tpu_torch.profiler import profiler

from test_torch_host import (J, T, fresh_perf_cache,  # noqa: F401
                             same_native_kit)
from test_torch_photon import assert_states_match

torch.set_num_threads(2)

N = 4096
STEPS = 10


@pytest.fixture(scope='module')
def tiny():
    """demo.tiny() and a bomb (numpy seed 12), each built by each package:
    (JAX arrays, port arrays, JAX bomb, port bomb)."""
    out = []
    for h, types in ((J, jtypes), (T, ttypes)):
        geo = h.demo.tiny()
        geo.flatten()
        out.append(types.build_geometry_arrays(geo))
    for h in (J, T):
        np.random.seed(12)
        out.append(h.photon_bomb(N, 400.0, (0, 0, 0)))
    return tuple(out)


def test_ten_steps_match_jax(tiny):
    ga, ta, bomb, t_bomb = tiny
    key = make_key(9)
    js, steps, _ = jprop.run_steps(jprop.photon_state_from_host(bomb), ga,
                                   key, 0, STEPS)
    assert int(steps) == STEPS

    def blocks(step, b):
        return np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(key, step), b), (8, N)))

    ts, done, alive = tprop.run_steps(
        tprop.photon_state_from_host(t_bomb, 'cpu'), ta, None, 0, STEPS,
        blocks=blocks)
    assert done == STEPS and alive > 0
    assert_states_match(js, ts, min_equal=0.999, scaled=True)


def _compacts_and_writes_back(tiny):
    """Two propagations of one bomb by the route the environment selects:
    every lane's final state at its input index, equal for one seed."""
    _, ta, _, t_bomb = tiny
    state = tprop.photon_state_from_host(t_bomb, 'cpu')
    out = tprop.propagate(state, ta, seed=3, max_steps=STEPS)
    assert len(out) == N
    # the input order is kept: evidx/wavelength ride along unchanged
    np.testing.assert_array_equal(out.wavelength.numpy(),
                                  state.wavelength.numpy())
    again = tprop.propagate(state, ta, seed=3, max_steps=STEPS)
    for name in ('flags', 'last_hit_triangle', 'cur_mat'):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      getattr(again, name).numpy())
    flags = out.flags.numpy()
    assert ((flags & (4 | 8)) != 0).mean() > 0.5   # most end on a surface


def test_chunked_driver_compacts_and_writes_back(tiny, monkeypatch):
    """The chunked driver (compaction between chunks) returns every lane's
    final state at its input index, reproducibly for a seed."""
    monkeypatch.setenv('CHROMA_FUSED', '0')
    _compacts_and_writes_back(tiny)

    _, perm = tprop._ps_compact_perm(torch.tensor([False, True, False,
                                                   True, True]))
    assert perm.tolist() == [1, 3, 4, 0, 2]


def test_fused_driver_compacts_and_writes_back(tiny, monkeypatch):
    """The fused bomb, by a fixed schedule (a front-pack to half the lanes
    after step 1), does the same:
    both runs take that schedule, where an unpinned first run would probe
    and the second take the tuned schedule, which draws otherwise."""
    monkeypatch.delenv('CHROMA_FUSED', raising=False)
    monkeypatch.setenv('CHROMA_FUSED_SCHEDULE', '1:2')
    monkeypatch.setattr(profiler, 'enabled', True)
    monkeypatch.setattr(profiler, 'regions', type(profiler.regions)(
        profiler.regions.default_factory))
    assert tprop.schedule_for(tiny[1], N, STEPS) == ((1, 2),)
    _compacts_and_writes_back(tiny)
    assert profiler.regions['propagate.fused[n=%d]' % N].calls == 2
    assert not [r for r in profiler.regions if r.startswith('propagate.probe')]
