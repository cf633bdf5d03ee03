"""Host-side random direction samplers.

Same call surface as the reference module (reference: chroma/sample.py),
different sampling recipes: isotropic directions come from normalized
Gaussian triples (rotation-invariant by construction) rather than the
cylindrical-projection method, and cone sampling builds an orthonormal
frame around the target direction instead of rotating the +z cone.
Distribution-identical; draws from the global numpy RNG like the
reference.
"""
from __future__ import annotations

import numpy as np

from chroma_tpu_torch.transform import get_perp


def uniform_sphere(size=None, dtype=np.double):
    """Isotropically distributed unit vectors: (3,) for size=None, else
    (size, 3)."""
    g = np.random.standard_normal((3,) if size is None else (size, 3))
    r2 = (g * g).sum(axis=-1, keepdims=True)
    # a zero triple has probability zero but would divide by zero
    g[..., 0] = np.where(r2[..., 0] == 0.0, 1.0, g[..., 0])
    r2 = np.maximum(r2, np.finfo(float).tiny)
    pts = g / np.sqrt(r2)
    return pts.astype(dtype, copy=False) if size is not None else pts


def flashlight(phi=np.pi / 4, direction=(0, 0, 1), size=None,
               dtype=np.double):
    """Directions uniform over the spherical cap of half-angle `phi`
    around `direction`: (3,) for size=None, else (size, 3)."""
    n = 1 if size is None else size
    axial = np.random.uniform(np.cos(phi), 1.0, n)     # cos of polar angle
    azimuth = np.random.uniform(0.0, 2.0 * np.pi, n)
    ring = np.sqrt(np.maximum(1.0 - axial * axial, 0.0))

    # orthonormal frame (t1, t2, w) with w along the beam
    w = np.asarray(direction, dtype=float)
    w = w / np.linalg.norm(w)
    t1 = get_perp(w)
    t1 = t1 / np.linalg.norm(t1)
    t2 = np.cross(w, t1)

    frame = np.stack([t1, t2, w])                      # (3, 3)
    local = np.stack([ring * np.cos(azimuth),
                      ring * np.sin(azimuth), axial], axis=1)
    pts = (local @ frame).astype(dtype, copy=False)
    return pts[0] if size is None else pts
