"""Demo optical materials and surfaces (reference: chroma/demo/optics.py).

The numeric tables are physical data, loaded from CSV files in demo/data/:
  water_wcsim.csv          - water optics from WCSim
  r7081hqe_detect.csv      - Hamamatsu R7081HQE photocathode QE (datasheet)
  glass_sno_absorption.csv - 'glass_sno' material from the SNO+ optics DB
"""
from __future__ import annotations

import os

import numpy as np

from chroma_tpu_torch.geometry import Material, Surface

_DATA = os.path.join(os.path.dirname(__file__), 'data')


def _load(name):
    return np.loadtxt(os.path.join(_DATA, name), delimiter=',', comments='#')


vacuum = Material('vacuum')
vacuum.set('refractive_index', 1.0)
vacuum.set('absorption_length', 1e6)
vacuum.set('scattering_length', 1e6)

lambertian_surface = Surface('lambertian_surface')
lambertian_surface.set('reflect_diffuse', 1)

black_surface = Surface('black_surface')
black_surface.set('absorb', 1)

shiny_surface = Surface('shiny_surface')
shiny_surface.set('reflect_specular', 1)

glossy_surface = Surface('glossy_surface')
glossy_surface.set('reflect_diffuse', 0.5)
glossy_surface.set('reflect_specular', 0.5)

red_absorb_surface = Surface('red_absorb')
red_absorb_surface.set('absorb', [0.0, 0.0, 1.0], [465, 545, 685])
red_absorb_surface.set('reflect_diffuse', [1.0, 1.0, 0.0], [465, 545, 685])

# R7081HQE photocathode: detect with the measured QE, absorb (without
# detection) with equal probability, diffusely reflect the remainder.
r7081hqe_photocathode = Surface('r7081hqe_photocathode')
_qe = _load('r7081hqe_detect.csv')
r7081hqe_photocathode.detect = _qe.astype(np.float32)
r7081hqe_photocathode.absorb = r7081hqe_photocathode.detect
r7081hqe_photocathode.set(
    'reflect_diffuse', 1.0 - 2.0 * _qe[:, 1], wavelengths=_qe[:, 0])

glass = Material('glass')
glass.set('refractive_index', 1.49)
glass.absorption_length = _load('glass_sno_absorption.csv').astype(np.float32)
glass.set('scattering_length', 1e6)

water = Material('water')
water.density = 1.0  # g/cm^3
water.composition = {'H': 0.1119, 'O': 0.8881}  # by mass
_water = _load('water_wcsim.csv')
water.refractive_index = _water[:, [0, 1]].astype(np.float32)
water.absorption_length = _water[:, [0, 2]].astype(np.float32)
water.scattering_length = _water[:, [0, 3]].astype(np.float32)
