"""Ray-primitive intersection tests, branchless and batched (counterpart
of chroma_tpu.ops.intersect; device analog of chroma/cuda/intersect.h):
the scalar early-out tests become mask algebra over whole ray batches.
"""
from __future__ import annotations

import torch

from chroma_tpu_torch.ops.linalg import dot, cross

EPSILON = 1e-6       # reference: CHROMA_EPSILON
FLT_EPSILON = 1.19209290e-07


def intersect_triangle(origin, direction, v0, v1, v2):
    """Moller-Trumbore ray/triangle test
    (reference: chroma/cuda/intersect.h:26-101).

    origin/direction: (...,3); v0/v1/v2: (...,3) triangle vertices.
    Returns (hit (...,) bool, distance (...,) f32; distance valid iff hit).
    """
    edge1 = v1 - v0
    edge2 = v2 - v0
    h = cross(direction, edge2)
    a = dot(edge1, h)
    parallel = torch.abs(a) <= FLT_EPSILON
    f = 1.0 / torch.where(parallel, 1.0, a)
    s = origin - v0
    u = f * dot(s, h)
    q = cross(s, edge1)
    v = f * dot(direction, q)
    t = f * dot(edge2, q)

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
    t0 = lower * inv_dir + neg_origin_inv_dir
    t1 = upper * inv_dir + neg_origin_inv_dir
    tsmall = torch.where(finite, torch.minimum(t0, t1),
                         torch.where(contained, -inf, inf))
    tbig = torch.where(finite, torch.maximum(t0, t1),
                       torch.where(contained, inf, -inf))

    tmin = torch.clamp(tsmall.amax(dim=-1), min=0.0)
    tmax = tbig.amin(dim=-1)
    return tmin <= tmax, tmin
