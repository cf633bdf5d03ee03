"""The reference's viewer frame: Chroma's pinhole camera and its
depth-peeled, alpha-composited render, as plain torch.

A pixel's ray meets up to `alpha_depth` surfaces, nearest first, each
found again from the last one with that triangle excluded; each layer
adds its triangle's colour shaded by |cos| of the incidence, weighted by
the colour's opacity and what the layers in front let through, and the
background fills the rest. The result is packed ARGB, as the viewer
packs it.
"""
from __future__ import annotations

import numpy as np
import torch

from bench_h100.reference import scene as sc

FILM_WIDTH = 35.0
FOCAL_LENGTH = 18.0


AXIS1 = np.array([0.0, 0.0, 1.0])   # the film's vertical
AXIS2 = np.array([1.0, 0.0, 0.0])   # and horizontal: the viewer looks along +y


def film_rays(position, size, pixels=None):
    """(origins, directions) f64 numpy of the pinhole camera's pixels in
    the viewer's order (pixel i = x * height + y); all, or `pixels`."""
    w, h = size
    height = FILM_WIDTH * (h / float(w))
    a1, a2 = AXIS1, AXIS2
    idx = np.arange(w * h) if pixels is None else np.asarray(pixels)
    x, y = idx // h, idx % h
    grid = (-a2[None] * (x * (FILM_WIDTH / w))[:, None]
            + a1[None] * (y * (height / h))[:, None])
    grid = grid + a2 * FILM_WIDTH / 2 - a1 * height / 2
    grid = grid - np.cross(a1, a2) * FOCAL_LENGTH
    d = -grid / np.linalg.norm(grid, axis=1, keepdims=True)
    return np.tile(np.asarray(position, float), (len(idx), 1)), d


def render(scene, origin, direction, alpha_depth=10, bg_color=0xFFFFFFFF):
    """(packed ARGB int64 pixels, the traversal queries each pixel needed)
    of rays (N, 3) in the scene."""
    dev = scene.device
    dt = scene.dtype
    o = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    d = torch.as_tensor(direction, dtype=torch.float32, device=dev)
    d = d / d.norm(dim=1, keepdim=True)
    n = o.shape[0]
    acc = torch.zeros((n, 3), dtype=dt, device=dev)
    scale = torch.ones(n, dtype=dt, device=dev)
    hits = torch.zeros(n, dtype=torch.int64, device=dev)
    queries = torch.zeros(n, dtype=torch.int64, device=dev)
    pos, last = o, torch.full((n,), -1, dtype=torch.int64, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    for _ in range(alpha_depth):
        queries += active.long()
        h = sc.query(scene, pos, d, excl=last)
        hit = active & (h.tri >= 0)
        safe = torch.where(hit, h.tri, 0)
        rgba = scene.triangle_color(safe)
        a0, r0, g0, b0 = (((rgba >> s) & 0xFF).to(dt) for s in (24, 16, 8, 0))
        alpha = (255.0 - a0) / 255.0
        cos = (h.normal.to(dt) * -d.to(dt)).sum(-1).abs()
        rgb = torch.stack([r0, g0, b0], 1) * cos[:, None]
        acc = acc + torch.where(hit[:, None], scale[:, None] * rgb
                                * alpha[:, None], torch.zeros_like(acc))
        scale = torch.where(hit, scale * (1.0 - alpha), scale)
        hits += hit.long()
        step = torch.where(hit, h.t, torch.zeros_like(h.t))
        pos = pos + step[:, None] * d
        last = torch.where(hit, h.tri, last)
        active = hit
        if not bool(active.any()):
            break
    bg = int(bg_color) & 0xFFFFFFFF
    bga = ((bg >> 24) & 0xFF) / 255.0
    bg_rgb = torch.tensor([(bg >> s) & 0xFF for s in (16, 8, 0)], dtype=dt,
                          device=dev)
    acc = acc + scale[:, None] * bg_rgb * bga
    scale = scale * (1.0 - bga)
    denom = torch.clamp(1.0 - scale, min=1e-20)
    a_out = torch.where(hits < alpha_depth,
                        torch.floor(255.0 * (1.0 - scale)),
                        torch.full_like(scale, 255.0)).long()
    rgb = torch.floor(acc / denom[:, None]).long()
    pixel = (a_out << 24) | (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    return torch.where(hits > 0, pixel, bg), queries
