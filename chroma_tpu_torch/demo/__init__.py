"""Demo detectors: PMTs placed on a spherical spiral inside a black sphere
(reference: chroma/demo/__init__.py)."""
from __future__ import annotations

from math import sin, cos, sqrt

import numpy as np

from chroma_tpu_torch.make import sphere
from chroma_tpu_torch.geometry import Solid
from chroma_tpu_torch.detector import Detector
from chroma_tpu_torch.transform import make_rotation_matrix, normalize
from chroma_tpu_torch.demo.pmt import build_8inch_pmt_with_lc
from chroma_tpu_torch.demo.optics import water, black_surface
from chroma_tpu_torch.demo.checkerboard import (
    build_checkerboard_scene as checkerboard_scene)  # noqa: F401
from chroma_tpu_torch.log import logger


def spherical_spiral(radius, spacing):
    """Points approximately equidistant along a spiral wrapping a sphere."""
    dl = spacing / radius
    t = 0.0
    a = np.pi / dl
    while t < np.pi:
        yield np.array([sin(t) * sin(a * t), sin(t) * cos(a * t),
                        cos(t)]) * radius
        t += dl / sqrt(1 + a ** 2 * sin(t) ** 2)


def detector(pmt_radius=14000.0, sphere_radius=14500.0, spiral_step=350.0):
    """Spherical detector: 8-inch PMTs on a spiral at `pmt_radius` inside a
    black containment sphere of `sphere_radius` filled with water."""
    pmt = build_8inch_pmt_with_lc()
    geo = Detector(water)

    geo.add_solid(Solid(sphere(sphere_radius, nsteps=200),
                        water, water,
                        surface=black_surface,
                        color=0xBBFFFFFF))

    for position in spherical_spiral(pmt_radius, spiral_step):
        direction = -normalize(position)
        # PMT mesh starts facing the +y axis
        y_axis = np.array((0.0, 1.0, 0.0))
        axis = np.cross(direction, y_axis)
        angle = np.arccos(np.dot(y_axis, direction))
        rotation = make_rotation_matrix(angle, axis)
        geo.add_pmt(pmt, rotation, position)

    time_rms = 1.5  # ns
    charge_mean = 1.0
    charge_rms = 0.1

    geo.set_time_dist_gaussian(time_rms, -5 * time_rms, 5 * time_rms)
    geo.set_charge_dist_gaussian(charge_mean, charge_rms, 0.0,
                                 charge_mean + 5 * charge_rms)

    logger.info('Demo detector: %d PMTs' % geo.num_channels())
    logger.info('               %1.1f ns time RMS' % time_rms)
    logger.info('               %1.1f%% charge RMS'
                % (100.0 * charge_rms / charge_mean))
    return geo


def tiny():
    "A small (~30 PMT) version of the demo detector, for tests."
    return detector(2000.0, 2500.0, 700.0)
