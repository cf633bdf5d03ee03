"""Scatter/error-bar graph container (reference: chroma/histogram/graph.py)."""
from __future__ import annotations

import numpy as np


class Graph(object):
    "x/y points with optional errors."

    def __init__(self, x=(), y=(), xerr=None, yerr=None):
        self.x = np.asarray(x, dtype=float)
        self.y = np.asarray(y, dtype=float)
        if self.x.shape != self.y.shape:
            raise ValueError('array shape mismatch')
        self.size = self.x.size
        self.xerr = np.zeros(self.size) if xerr is None \
            else np.asarray(xerr, dtype=float)
        self.yerr = np.zeros(self.size) if yerr is None \
            else np.asarray(yerr, dtype=float)
