"""Colormap -> packed RGB ints (counterpart of chroma_tpu.color.colormap;
reference: chroma/color/colormap.py).

The default map is matplotlib's reversed jet. The port keeps its own
256-entry table of it, computed as matplotlib computes a segmented
colormap's, so the event display needs no matplotlib; any other map is a
callable from floats in [0, 1] to (N, 4) RGBA floats, e.g. a matplotlib
colormap."""
from __future__ import annotations

import numpy as np

_LUT_SIZE = 256

# matplotlib's 'jet' segments: (x, y below x, y above x) per channel
_JET = (
    ((0.00, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.00, 0.5, 0.5)),
    ((0.000, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.640, 1, 1),
     (0.910, 0, 0), (1.000, 0, 0)),
    ((0.00, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.00, 0, 0)),
)


def _segment_table(data, n=_LUT_SIZE):
    "The n-entry lookup table of one channel's (x, y0, y1) segments."
    adata = np.array(data, dtype=float)
    x = adata[:, 0] * (n - 1)
    y0 = adata[:, 1]
    y1 = adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]],
                          distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def _reversed(data):
    return [(1.0 - x, y1, y0) for x, y0, y1 in reversed(data)]


_JET_R_LUT = np.ones((_LUT_SIZE, 4))
for _c, _data in enumerate(_JET):
    _JET_R_LUT[:, _c] = _segment_table(_reversed(_data))


def jet_r(x):
    "Reversed jet: floats in [0, 1] -> (N, 4) RGBA floats."
    xa = np.array(x, copy=True)
    xa *= _LUT_SIZE
    xa[xa == _LUT_SIZE] = _LUT_SIZE - 1
    idx = np.clip(xa, 0, _LUT_SIZE - 1).astype(int)
    return _JET_R_LUT[idx]


def map_to_color(a, range=None, map=None, weights=None):
    "Map scalars to 0xRRGGBB ints through a colormap (default jet_r)."
    if map is None:
        map = jet_r
    a = np.asarray(a, dtype=np.float32)
    if range is None:
        range = (a.min(), a.max())
    span = float(range[1]) - float(range[0])
    ax = (a - float(range[0])) / (span if span else 1.0)

    frgba = map(ax)
    if weights is not None:
        frgba = np.array(frgba)
        frgba[:, 0] *= weights
        frgba[:, 1] *= weights
        frgba[:, 2] *= weights

    rgba = (frgba * 255).astype(np.uint32)
    return rgba[:, 0] << 16 | rgba[:, 1] << 8 | rgba[:, 2]
