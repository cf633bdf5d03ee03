"""Ray-primitive intersection tests, branchless and batched (counterpart
of chroma_tpu.ops.intersect; device analog of chroma/cuda/intersect.h):
the scalar early-out tests become mask algebra over whole ray batches.

The products and sums round as XLA compiles the JAX package's tests on
the CPU, where `a*b + c` becomes one fused multiply-add (`_cross`, `_dot`,
the slab planes): where a ray runs along an edge shared by two triangles,
both give the same distance to the last ulp, and that rounding decides
which triangle is hit.
"""
from __future__ import annotations

import torch

from chroma_tpu_torch.ops.linalg import fma

EPSILON = 1e-6       # reference: CHROMA_EPSILON
FLT_EPSILON = 1.19209290e-07


def _cross(a, b):
    "cross(a, b), each component rounded as fma(a_i, b_j, -(a_j * b_i))."
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([fma(ay, bz, -(az * by)),
                        fma(az, bx, -(ax * bz)),
                        fma(ax, by, -(ay * bx))], dim=-1)


def _dot(a, b):
    """sum(a * b) over the last axis, rounded as fma(a2, b2, fma(a1, b1,
    a0 * b0))."""
    return fma(a[..., 2], b[..., 2],
               fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def intersect_triangle(origin, direction, v0, v1, v2):
    """Moller-Trumbore ray/triangle test
    (reference: chroma/cuda/intersect.h:26-101).

    origin/direction: (...,3); v0/v1/v2: (...,3) triangle vertices.
    Returns (hit (...,) bool, distance (...,) f32; distance valid iff hit).
    """
    edge1 = v1 - v0
    edge2 = v2 - v0
    h = _cross(direction, edge2)
    a = _dot(edge1, h)
    parallel = torch.abs(a) <= FLT_EPSILON
    f = 1.0 / torch.where(parallel, 1.0, a)
    s = origin - v0
    u = f * _dot(s, h)
    q = _cross(s, edge1)
    v = f * _dot(direction, q)
    t = f * _dot(edge2, q)

    hit = (~parallel
           & (u >= -EPSILON) & (u <= 1.0 + EPSILON)
           & (v >= -EPSILON) & (u + v <= 1.0 + EPSILON)
           & (t > EPSILON) & torch.isfinite(t))
    return hit, t


def intersect_box(origin, neg_origin_inv_dir, inv_dir, lower, upper):
    """Slab ray/AABB test with precomputed -origin/dir and 1/dir
    (reference: chroma/cuda/intersect.h:112-157).

    Returns (hit (...,) bool, distance (...,) f32 = entry distance, 0 if
    the origin is inside the box). Axes with a zero direction component
    (inv_dir = +-inf; the fma form would produce NaN there) degrade to an
    exact containment test: the box hits on that axis iff the origin
    coordinate lies inside the slab, the answer IEEE arithmetic gives the
    reference's (lower - origin) / dir form.
    """
    inf = torch.inf
    finite = torch.isfinite(inv_dir)
    contained = (origin >= lower) & (origin <= upper)
    t0 = fma(lower, inv_dir, neg_origin_inv_dir)
    t1 = fma(upper, inv_dir, neg_origin_inv_dir)
    tsmall = torch.where(finite, torch.minimum(t0, t1),
                         torch.where(contained, -inf, inf))
    tbig = torch.where(finite, torch.maximum(t0, t1),
                       torch.where(contained, inf, -inf))

    tmin = torch.clamp(tsmall.amax(dim=-1), min=0.0)
    tmax = tbig.amin(dim=-1)
    return tmin <= tmax, tmin
