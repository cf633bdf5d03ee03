"""Host-side 3D rotations, formulated with quaternions.

Provides the same call surface as the reference module
(reference: chroma/transform.py) — ``rotate``/``make_rotation_matrix``
follow its orientation convention: a positive angle turns points
counter-clockwise about the axis *when looking along the axis towards
+infinity* (i.e. clockwise in the right-hand-rule sense). Internally every
rotation is the quaternion sandwich x' = x + 2w(v X x) + 2v X (v X x)
with (w, v) = (cos(phi/2), -sin(phi/2) n) encoding that convention.
"""
from __future__ import annotations

import numpy as np


def norm(x):
    "Euclidean length along the last axis."
    x = np.asarray(x)
    return np.sqrt((x * x).sum(-1))


def normalize(x):
    "Unit vector(s) in the direction of `x`."
    x = np.atleast_2d(np.asarray(x, dtype=float))
    return (x / norm(x)[:, np.newaxis]).squeeze()


def get_perp(x):
    """Some vector perpendicular to `x`: cross `x` with the coordinate
    axis it points along least."""
    x = np.asarray(x)
    e = np.zeros(3)
    e[np.argmin(np.abs(x))] = 1.0
    return np.cross(e, x)


def _half_angle_quaternion(phi, n):
    """(w, v) quaternion components for this module's rotation convention.
    phi may be scalar or (M,); returns (w (M,1), v (M,3))."""
    axis = np.asarray(n, dtype=float)
    length = np.sqrt((axis * axis).sum())
    if length == 0:
        raise ValueError('rotation axis has zero magnitude')
    axis = axis / length
    half = 0.5 * np.atleast_1d(np.asarray(phi, dtype=float))[:, np.newaxis]
    return np.cos(half), -np.sin(half) * axis


def rotate(x, phi, n):
    """Rotate point(s) `x` by angle(s) `phi` counter-clockwise about axis
    `n` (looking towards +infinity). Vector `phi` pairs one angle with one
    point."""
    x = np.atleast_2d(np.asarray(x, dtype=float))
    w, v = _half_angle_quaternion(phi, n)
    t = 2.0 * np.cross(v, x)
    return (x + w * t + np.cross(v, t)).squeeze()


def make_rotation_matrix(phi, n):
    """Matrix form of rotate(), i.e. R such that R @ x == rotate(x, phi, n),
    assembled from the quaternion components."""
    w, v = _half_angle_quaternion(phi, n)
    w = w.reshape(())
    v = v.reshape(3)
    vx, vy, vz = v
    cross = np.array([[0.0, -vz, vy],
                      [vz, 0.0, -vx],
                      [-vy, vx, 0.0]])
    return ((w * w - v @ v) * np.identity(3)
            + 2.0 * np.outer(v, v) + 2.0 * w * cross)


def rotate_matrix(x, phi, n):
    "Like rotate() but through an explicit matrix (scalar `phi` only)."
    return np.inner(np.asarray(x), make_rotation_matrix(phi, n))


def gen_rot(a, b):
    """Rotation matrix carrying unit(a) onto -unit(b), built from the
    half-angle quaternion between the two directions (no trig calls)."""
    a = np.asarray(a, dtype=float)
    a = a / np.linalg.norm(a)
    target = -np.asarray(b, dtype=float)
    target = target / np.linalg.norm(target)

    d = float(np.dot(a, target))
    if d >= 1.0:                     # already aligned
        return np.identity(3)
    if d <= -1.0:                    # antiparallel: half-turn about any perp
        u = get_perp(a)
        u = u / np.linalg.norm(u)
        return 2.0 * np.outer(u, u) - np.identity(3)

    # right-handed quaternion taking a -> target:
    #   w = cos(theta/2) = sqrt((1+d)/2),  v = (a x target) / (2w)
    w = np.sqrt(0.5 * (1.0 + d))
    v = np.cross(a, target) / (2.0 * w)
    vx, vy, vz = v
    cross = np.array([[0.0, -vz, vy],
                      [vz, 0.0, -vx],
                      [-vy, vx, 0.0]])
    return ((w * w - v @ v) * np.identity(3)
            + 2.0 * np.outer(v, v) + 2.0 * w * cross)
