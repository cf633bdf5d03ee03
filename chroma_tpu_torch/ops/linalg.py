"""Small-vector helpers over (..., 3) tensors (counterpart of
chroma_tpu.ops.linalg). Sums over the 3 components are written out in
index order, so every device rounds them the same way."""
from __future__ import annotations

import torch


def dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def fma(a, b, c):
    """a * b + c of f32 tensors rounded once to f32, as a fused
    multiply-add. The JAX package's CPU build contracts some `x * y + z`
    this way, and where rounding decides a discrete outcome the port does
    the same.

    The product is exact in f64 and the sum s rounds once there, with an
    exact residual err (p + c == s + err). Rounding s to f32 rounds a
    second time, which is wrong only where s lies on the midpoint of two
    f32 values r and o and err points past it towards o: then o is the
    answer."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)
    r = s.float()
    d = s - r.double()
    o = r.double() + 2.0 * d  # an f32 value only when s is a midpoint
    o32 = o.float()
    return torch.where((err * d > 0) & (o32.double() == o), o32, r)


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by,
                        az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def norm(a):
    return torch.sqrt(dot(a, a))


def normalize(a):
    return a / norm(a)[..., None]


def rotate(x, phi, n):
    """Rotate vectors `x` by angle `phi` counter-clockwise about unit axis
    `n` (Rodrigues' formula; reference: chroma/cuda/rotate.h:20-28)."""
    cos_phi = torch.cos(phi)[..., None]
    sin_phi = torch.sin(phi)[..., None]
    return (x * cos_phi
            + n * dot(x, n)[..., None] * (1.0 - cos_phi)
            + cross(x, n) * sin_phi)
