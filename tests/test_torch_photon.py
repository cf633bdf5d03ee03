"""One propagation step of the torch port against the JAX step.

On demo.tiny() with 4,096 photons, both steps consume the same uniforms:
the port's DrawPool is fed the exact (8, N) blocks the JAX DrawPool draws
(fold_in(step_key, b)). Flags, last-hit triangles and media must agree
exactly; positions, directions, polarizations, times and wavelengths to
rtol 1e-5 (XLA's and torch's transcendental functions may differ in the
last ulp). Step 0 starts from the bomb (no medium known, no pruning);
step 1 from the JAX state after step 0 (pruned query, surfaces,
Fresnel)."""
import numpy as np
import pytest
import torch
import jax

from chroma_tpu.ops import types as jtypes
from chroma_tpu.ops import propagate as jprop
from chroma_tpu.ops.photon import propagate_step as jax_step
from chroma_tpu.ops.sample import make_key
from chroma_tpu_torch.ops import photon
from chroma_tpu_torch.ops import types as ttypes
from chroma_tpu_torch.ops.sample import DrawPool

from test_torch_host import J, T, same_native_kit  # noqa: F401

torch.set_num_threads(2)

N = 4096
INT_FIELDS = ('flags', 'last_hit_triangle', 'cur_mat', 'evidx')
FLOAT_FIELDS = ('pos', 'dir', 'pol', 't', 'wavelength', 'weight')


def torch_state(js):
    "The port's PhotonState holding a JAX PhotonState's values."
    def t(a):
        a = np.asarray(a)
        return torch.from_numpy(np.array(
            a.view(np.int32) if a.dtype == np.uint32 else a))
    return photon.PhotonState(**{name: t(getattr(js, name)) for name in (
        INT_FIELDS + FLOAT_FIELDS)})


def jax_blocks(step_key, n):
    "The uniform blocks JAX's DrawPool(step_key, n) draws."
    return lambda b: np.asarray(jax.random.uniform(
        jax.random.fold_in(step_key, b), (8, n)))


def assert_states_match(js, ts, min_equal=1.0, scaled=False):
    """Integer fields equal on at least `min_equal` of the lanes (all by
    default; lanes that differ are printed), float fields to rtol 1e-5 on
    the lanes whose integer fields agree -- with `scaled`, to 1e-5 of the
    field's largest magnitude (components near zero of a vector carried
    through many steps lose relative, not absolute, precision)."""
    same = np.ones(len(ts), bool)
    for name in INT_FIELDS:
        a = np.asarray(getattr(js, name))
        a = a.view(np.int32) if a.dtype == np.uint32 else a
        b = getattr(ts, name).numpy()
        same &= a == b
    bad = np.flatnonzero(~same)
    for i in bad[:20]:
        print('lane %d differs:' % i, {
            name: (int(np.asarray(getattr(js, name))[i]),
                   int(getattr(ts, name)[i])) for name in INT_FIELDS})
    assert same.mean() >= min_equal, '%d lanes differ' % len(bad)
    for name in FLOAT_FIELDS:
        a = np.asarray(getattr(js, name))[same]
        b = getattr(ts, name).numpy()[same]
        atol = 1e-5 * max(np.abs(a).max(), 1.0) if scaled else 1e-5
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=atol, err_msg=name)


@pytest.fixture(scope='module')
def tiny():
    "demo.tiny() as each package builds it, and the JAX bomb's state."
    arrays = []
    for h, types in ((J, jtypes), (T, ttypes)):
        geo = h.demo.tiny()
        geo.flatten()
        arrays.append(types.build_geometry_arrays(geo))
    np.random.seed(11)
    bomb = J.photon_bomb(N, 400.0, (0, 0, 0))
    return (*arrays, jprop.photon_state_from_host(bomb))


def test_step_matches_jax(tiny):
    ga, ta, js = tiny
    step = jax.jit(jax_step)
    key = make_key(5)
    for s in range(2):
        step_key = jax.random.fold_in(key, s)
        pool = DrawPool(N, 'cpu', blocks=jax_blocks(step_key, N))
        ts = photon.propagate_step(torch_state(js), ta, pool)
        js = step(js, ga, step_key)
        assert_states_match(js, ts)
        assert pool._count == 12          # the JAX step's draw count
    flags = np.asarray(js.flags)
    # the second step saw surfaces and boundaries, not just bulk transport
    assert ((flags & 4) != 0).sum() > 0 and ((flags & 8) != 0).sum() > 0

