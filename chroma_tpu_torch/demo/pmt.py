"""Demo 8-inch PMT builders (reference: chroma/demo/pmt.py)."""
from __future__ import annotations

import os

from chroma_tpu_torch.pmt import build_pmt, build_light_collector_from_file
from chroma_tpu_torch.demo.optics import (water, glass, vacuum, shiny_surface,
                                    r7081hqe_photocathode)

_DATA = os.path.join(os.path.dirname(__file__), 'data')


def build_8inch_pmt(outer_material=water, nsteps=24):
    return build_pmt(os.path.join(_DATA, 'sno_pmt.txt'), 3.0,  # 3 mm glass
                     outer_material=outer_material,
                     glass=glass, vacuum=vacuum,
                     photocathode_surface=r7081hqe_photocathode,
                     back_surface=shiny_surface,
                     nsteps=nsteps)


def build_8inch_pmt_with_lc(outer_material=water, nsteps=24):
    pmt = build_8inch_pmt(outer_material, nsteps)
    lc = build_light_collector_from_file(os.path.join(_DATA, 'sno_cone.txt'),
                                         outer_material=outer_material,
                                         surface=shiny_surface,
                                         nsteps=nsteps)
    return pmt + lc
