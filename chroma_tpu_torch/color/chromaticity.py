"""Wavelength -> RGB via the CIE 1964 color matching functions
(reference: chroma/color/chromaticity.py; data: ciexyz64_1.csv)."""
from __future__ import annotations

from os.path import dirname, realpath

import numpy as np

from chroma_tpu_torch.tools import read_csv

color_map = read_csv(dirname(realpath(__file__)) + '/ciexyz64_1.csv')


def map_wavelength(wavelength):
    "RGB triplet(s) in [0,1] for wavelength(s) in nm."
    r = np.interp(wavelength, color_map[:, 0], color_map[:, 1])
    g = np.interp(wavelength, color_map[:, 0], color_map[:, 2])
    b = np.interp(wavelength, color_map[:, 0], color_map[:, 3])
    if np.iterable(wavelength):
        return np.stack([r, g, b], axis=-1)
    return np.array([r, g, b])
