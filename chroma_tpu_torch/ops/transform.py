"""Device-side point/ray transforms (counterpart of
chroma_tpu.ops.transform; analog of chroma/cuda/transform.cu). Plain
functions on tensors: the result lies on the device of `points`."""
from __future__ import annotations

import torch

from chroma_tpu_torch.ops.linalg import norm, rotate as _rotate


def _on(points, x):
    "x as an f32 tensor on the device of `points`."
    return torch.as_tensor(x, dtype=torch.float32, device=points.device)


def rotate_points(points, phi, axis):
    "Rotate (N,3) points by angle phi about a unit axis through the origin."
    axis = _on(points, axis)
    axis = axis / norm(axis)
    phi = _on(points, phi).expand(points.shape[:1])
    return _rotate(points, phi, axis[None, :])


def rotate_around_point(points, phi, axis, center):
    "Rotate (N,3) points by phi about an axis through `center`."
    center = _on(points, center)
    return rotate_points(points - center, phi, axis) + center


def translate_points(points, delta):
    return points + _on(points, delta)
