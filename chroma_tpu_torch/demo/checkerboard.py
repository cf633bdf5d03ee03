"""Checkerboard demo scene (reference: chroma/demo/checkerboard.py)."""
from __future__ import annotations

import numpy as np

from chroma_tpu_torch.geometry import Mesh, Solid, Geometry
from chroma_tpu_torch.make import sphere
from chroma_tpu_torch.demo.optics import (vacuum, water, black_surface,
                                    lambertian_surface, shiny_surface)


def build_checkerboard_scene(checkers_per_side=10, squares_per_checker=50):
    n = checkers_per_side * squares_per_checker
    x = np.linspace(-5000.0, 5000.0, n + 1)
    y = np.linspace(-5000.0, 5000.0, n + 1)

    xx, yy = np.meshgrid(x, y, indexing='ij')
    vertices = np.column_stack([xx.ravel(), yy.ravel(), np.zeros(xx.size)])

    # two triangles per grid cell
    j, i = np.meshgrid(np.arange(n), np.arange(n), indexing='ij')
    v00 = (j * len(x) + i).ravel()
    v10 = ((j + 1) * len(x) + i).ravel()
    v11 = ((j + 1) * len(x) + i + 1).ravel()
    v01 = (j * len(x) + i + 1).ravel()
    tris = np.empty((2 * n * n, 3), dtype=np.int64)
    tris[0::2] = np.column_stack([v00, v10, v11])
    tris[1::2] = np.column_stack([v00, v01, v11])
    checkerboard_mesh = Mesh(vertices, tris, remove_duplicate_vertices=True)

    # checker pattern per triangle: (cell_x // sq + cell_y // sq) parity
    cell_x = np.repeat(i.ravel(), 2) // squares_per_checker
    cell_y = np.repeat(j.ravel(), 2) // squares_per_checker
    dark = ((cell_x + cell_y) % 2).astype(bool)

    colors = np.where(dark, 0x000000, 0xffffff).astype(np.uint32)
    surfaces = np.where(dark, black_surface, lambertian_surface)

    checkerboard = Solid(checkerboard_mesh, vacuum, vacuum,
                         surface=surfaces, color=colors)

    sphere1 = Solid(sphere(1000.0, nsteps=512), water, vacuum)
    sphere2 = Solid(sphere(1000.0, nsteps=512), vacuum, vacuum,
                    surface=shiny_surface)
    sphere3 = Solid(sphere(1000.0, nsteps=512), vacuum, vacuum,
                    surface=lambertian_surface)

    scene = Geometry()
    scene.add_solid(checkerboard, displacement=(0, 0, -1500.0))
    scene.add_solid(sphere1, displacement=(2000.0, -2000.0, 0))
    scene.add_solid(sphere2, displacement=(-2000.0, -2000.0, 0))
    scene.add_solid(sphere3, displacement=(0.0, 2000.0, 0))
    return scene
