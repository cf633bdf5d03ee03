"""The torch port's samplers against the JAX package's, on shared draws.

The port's DrawPool, fed the blocks the JAX DrawPool draws, must return
the same uniform streams bit for bit (uniform_sphere up to the last ulp of
cos/sin), and sample_cdf_pairs must equal jnp.interp bit for bit, edges
and ties included."""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chroma_tpu.ops import sample as jsample
from chroma_tpu_torch.ops import sample as tsample

torch.set_num_threads(2)

N = 5000


def test_draw_pool_matches_jax():
    key = jsample.make_key(21)
    jpool = jsample.DrawPool(key, N)
    tpool = tsample.DrawPool(N, 'cpu', blocks=lambda b: np.asarray(
        jax.random.uniform(jax.random.fold_in(key, b), (8, N))))
    ranges = [(0.0, 1.0), (0.0, 2.0 * math.pi), (-1.0, 1.0)] * 3
    for low, high in ranges:
        a = np.asarray(jpool.draw(low, high))
        b = tpool.draw(low, high).numpy()
        np.testing.assert_array_equal(b, a)
        assert b.min() > low and b.max() <= high
    for _ in range(3):       # crosses the second block boundary
        got = tpool.uniform_sphere().numpy()
        ref = np.asarray(jpool.uniform_sphere())
        # z is the draw itself; x and y go through XLA's and torch's own
        # cos/sin, which may differ in the last ulp
        np.testing.assert_array_equal(got[:, 2], ref[:, 2])
        np.testing.assert_allclose(got[:, :2], ref[:, :2], rtol=0,
                                   atol=2 * np.finfo(np.float32).eps)


def test_draw_pool_generator_streams():
    "Production pools: reproducible per (seed, step), distinct across."
    def first(seed, step):
        gen = tsample.make_generator('cpu', seed, step)
        return tsample.DrawPool(N, 'cpu', generator=gen).draw().numpy()
    np.testing.assert_array_equal(first(1, 4), first(1, 4))
    assert not np.array_equal(first(1, 4), first(1, 5))
    assert not np.array_equal(first((1, 0), 4), first((1, 1), 4))
    u = first(2, 0)
    assert u.min() > 0.0 and u.max() <= 1.0
    with pytest.raises(ValueError):
        tsample.DrawPool(N, 'cpu')


@pytest.mark.parametrize('table', ['gaussian', 'ties'])
def test_sample_cdf_pairs_matches_interp(table):
    if table == 'gaussian':
        x = np.linspace(-7.5, 7.5, 51)
        y = np.concatenate([[0.0], np.cumsum(np.exp(-0.5 * (x[1:] / 1.5)
                                                     ** 2))])
        y /= y[-1]
    else:   # flat stretches of the CDF (ties in cdf_y) and a zero step
        x = np.array([0.0, 1.0, 2.0, 3.0, 3.0, 5.0])
        y = np.array([0.0, 0.25, 0.25, 0.5, 0.75, 1.0])
    x = x.astype(np.float32)
    y = y.astype(np.float32)
    rs = np.random.RandomState(4)
    u = np.concatenate([rs.uniform(size=4000), y, [-0.5, 1.5, 0.0, 1.0]]
                       ).astype(np.float32)
    ref = np.asarray(jnp.interp(jnp.asarray(u), jnp.asarray(y),
                                jnp.asarray(x)))
    got = tsample.sample_cdf_pairs(torch.from_numpy(u), torch.from_numpy(x),
                                   torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        np.asarray(jsample.sample_cdf_pairs(jnp.asarray(u), jnp.asarray(x),
                                            jnp.asarray(y))), got)


@pytest.mark.parametrize('grid', ['wavelength', 'time'])
def test_sample_cdf_uniform_rows_matches_jax(grid):
    """Per-lane CDF rows (bulk and WLS reemission), on the standard grids,
    bit for bit against the JAX bisection compiled as the step compiles
    it, with u at the table's end and on its knots. u is at least 2^-24,
    the pool's smallest draw: XLA on the CPU flushes the denormals of a
    CDF's far tail to zero, so a denormal u would compare differently."""
    from chroma_tpu.geometry import standard_wavelengths, standard_times
    x = standard_wavelengths if grid == 'wavelength' else standard_times
    scale = 30.0 if grid == 'wavelength' else 20.0
    rows = []
    for r in range(5):
        pdf = np.exp(-0.5 * ((x - x[len(x) // 4] - 2 * scale * r) / scale)
                     ** 2) + (r == 4)
        cdf = np.concatenate([[0.0], np.cumsum((pdf[1:] + pdf[:-1]) / 2)])
        rows.append(cdf / cdf[-1])
    table = np.asarray(rows, np.float32)
    table[3, :10] = 0.0                    # a flat start: zero-width bins
    rs = np.random.RandomState(6)
    u = np.concatenate([rs.uniform(size=6000), table[2, ::7], [1.0]]
                       ).astype(np.float32)
    u = u[u >= 2.0 ** -24]
    row = rs.randint(0, 5, len(u)).astype(np.int32)
    x0, dx = float(x[0]), float(x[1] - x[0])
    ref = np.asarray(jax.jit(lambda u, t, r: jsample.sample_cdf_uniform_rows(
        u, t, r, x0, dx))(u, table, row))
    got = tsample.sample_cdf_uniform_rows(
        torch.from_numpy(u), torch.from_numpy(table), torch.from_numpy(row),
        x0, dx).numpy()
    np.testing.assert_array_equal(got, ref)
