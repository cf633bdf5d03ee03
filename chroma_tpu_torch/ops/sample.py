"""Device random sampling for the torch port (counterpart of
chroma_tpu.ops.sample).

Random numbers come from explicit torch.Generators: the propagation driver
seeds one generator per (seed, absolute step), and every step draws its
uniforms as (8, N) blocks from it. Threefry and torch's generators do not
share streams, so the tests inject the exact blocks the JAX DrawPool would
draw instead.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from chroma_tpu_torch.ops.linalg import fma


def _flat(parts):
    for p in parts:
        if isinstance(p, tuple):
            yield from _flat(p)
        else:
            yield int(p)


def mix_seed(*parts):
    """A 63-bit generator seed from non-negative ints or tuples of them
    (e.g. ((seed, batch), step)): distinct inputs give unrelated
    streams."""
    state = np.random.SeedSequence(list(_flat(parts))).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def make_generator(device, *parts):
    "A torch.Generator on `device` seeded from mix_seed(*parts)."
    gen = torch.Generator(device=device)
    gen.manual_seed(mix_seed(*parts))
    return gen


def uniform(u, low=0.0, high=1.0):
    """Map U[0, 1) draws to U(low, high] like curand_uniform (excludes
    low, includes high): never 0 for (0, 1], so -L*log(u) is finite."""
    return high - u * (high - low)


def _sphere(theta, u):
    """Unit vectors (..., 3) from azimuths theta and cosines u
    (reference: random.h:17-25)."""
    c = torch.sqrt(torch.clamp(1.0 - u * u, min=0.0))
    return torch.stack([c * torch.cos(theta), c * torch.sin(theta), u],
                       dim=-1)


def uniform_sphere(generator, shape, device=None):
    """Isotropic unit vectors, shape (*shape, 3), from two U[0, 1) draws of
    `generator` (on its device unless `device` is given) (counterpart of
    chroma_tpu.ops.sample.uniform_sphere)."""
    device = generator.device if device is None else device
    theta, u = (torch.rand(shape, generator=generator, device=device,
                           dtype=torch.float32) for _ in range(2))
    return _sphere(uniform(theta, 0.0, 2.0 * math.pi), uniform(u, -1.0, 1.0))


def exponential(generator, shape, scale, device=None):
    """Exponentially distributed distances with per-lane `scale`, from one
    U[0, 1) draw of `generator` mapped to (0, 1] (counterpart of
    chroma_tpu.ops.sample.exponential)."""
    device = generator.device if device is None else device
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return -scale * torch.log(uniform(u))


def sample_cdf_pairs(u, cdf_x, cdf_y):
    """Inverse-CDF draw from a shared (cdf_x, cdf_y) table: linear
    interpolation of u against cdf_y, with jnp.interp's edge and tie rules
    (reference: random.h:29-34)."""
    xp, fp = cdf_y, cdf_x
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, u, right=True), 1, n - 1)
    x_lo = xp[i - 1]
    f_lo = fp[i - 1]
    df = fp[i] - f_lo
    dx = xp[i] - x_lo
    delta = u - x_lo
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    # the lerp is one fused multiply-add, as XLA contracts it: the f32
    # product is exact in f64, so only the final rounding to f32 remains
    q = delta / torch.where(dx0, 1.0, dx)
    lerp = (f_lo.double() + q.double() * df.double()).float()
    f = torch.where(dx0, f_lo, lerp)
    f = torch.where(u < xp[0], fp[0], f)
    return torch.where(u > xp[-1], fp[-1], f)


def sample_cdf_uniform_rows(u, table, row_idx, x0, dx):
    """Inverse-CDF draw on a uniform x grid with a per-lane CDF row
    (reference: random.h:38-55). table: (R, n) cumulative values; row_idx:
    (N,) row per lane; u: (N,). Bisection for a fixed ceil(log2(n))
    iterations with converged lanes masked, as the JAX sampler. The final
    x0 + dx*lower + dx*frac is rounded as XLA compiles it on the CPU:
    fma(dx, lower, x0) + dx*frac, and with x0 == 0 (the time grid), where
    the add of zero folds away, fma(dx, lower, dx*frac)."""
    n = table.shape[1]
    iters = max(1, math.ceil(math.log2(n)))
    row = row_idx.to(torch.int64)
    lower = torch.zeros_like(row)
    upper = torch.full_like(row, n - 1)
    for _ in range(iters):
        active = lower < upper - 1
        half = (lower + upper) // 2
        go_left = u < table[row, half]
        upper = torch.where(active & go_left, half, upper)
        lower = torch.where(active & ~go_left, half, lower)
    y_lo = table[row, lower]
    y_hi = table[row, upper]
    dy = y_hi - y_lo
    frac = torch.where(dy > 0, (u - y_lo) / torch.where(dy > 0, dy, 1.0),
                       0.0)
    lower = lower.to(torch.float32)
    dx_t = torch.full_like(lower, dx)
    if float(np.float32(x0)) == 0.0:
        return fma(dx_t, lower, dx * frac)
    return fma(dx_t, lower, torch.full_like(lower, x0)) + dx * frac


class DrawPool:
    """Pooled uniform draws for one propagation step: (block, N) batches on
    demand, consumed one (N,) stream at a time in the fixed order the step
    code asks for them (the order of chroma_tpu.ops.sample.DrawPool).

    `generator` supplies the blocks in production; `blocks`, a callable
    b -> (block, N) U[0, 1) array, injects them instead (tests feed the
    JAX pool's exact blocks). `stacked` makes a step's blocks at once, and
    `DrawPool.over` draws from blocks made before."""

    def __init__(self, n, device, generator=None, blocks=None, block=8):
        if (generator is None) == (blocks is None):
            raise ValueError('give exactly one of generator and blocks')
        self.n = n
        self.device = device
        self.block = block
        self._gen = generator
        self._inject = blocks
        self._blocks = []
        self._count = 0

    def _make_block(self, b):
        if self._inject is not None:
            arr = torch.from_numpy(np.array(self._inject(b), np.float32))
            if arr.shape != (self.block, self.n):
                raise ValueError('injected block %d has shape %s, want %s'
                                 % (b, tuple(arr.shape),
                                    (self.block, self.n)))
            return arr.to(self.device)
        return torch.rand((self.block, self.n), generator=self._gen,
                          device=self.device, dtype=torch.float32)

    @classmethod
    def over(cls, stacked, count=0, block=8):
        """A pool that draws from `stacked`, a (B * block, N) U[0, 1)
        tensor, from stream `count` on, and raises past its end."""
        pool = cls.__new__(cls)
        pool.n = stacked.shape[1]
        pool.device = stacked.device
        pool.block = block
        pool._gen = pool._inject = None
        pool._blocks = list(stacked.split(block))
        pool._count = count
        return pool

    def stacked(self, draws):
        """All the blocks that `draws` streams take, as one (B * block, N)
        tensor, made as `draw` would make them one by one (a generator
        fills block b in order, with the numbers torch.rand of that shape
        would give), and counted as drawn: a step that hands its draws out
        at once."""
        if self._count or self._blocks:
            raise ValueError('stacked() needs a fresh pool')
        nblocks = -(-draws // self.block)
        if self._gen is None:
            out = torch.cat([self._make_block(b) for b in range(nblocks)])
        else:
            out = torch.empty((nblocks * self.block, self.n),
                              dtype=torch.float32, device=self.device)
            for part in out.split(self.block):
                part.uniform_(0.0, 1.0, generator=self._gen)
        self._blocks = list(out.split(self.block))
        self._count = draws
        return out

    def draw(self, low=0.0, high=1.0):
        "One (N,) stream of U(low, high]."
        b, i = divmod(self._count, self.block)
        if b >= len(self._blocks):
            if self._gen is None and self._inject is None:
                raise IndexError('draw %d is past the pool\'s %d blocks'
                                 % (self._count, len(self._blocks)))
            self._blocks.append(self._make_block(b))
        self._count += 1
        return uniform(self._blocks[b][i], low, high)

    def uniform_sphere(self):
        """Isotropic unit vectors (N, 3) from two pooled draws
        (reference: random.h:17-25)."""
        theta = self.draw(0.0, 2.0 * math.pi)
        return _sphere(theta, self.draw(-1.0, 1.0))
