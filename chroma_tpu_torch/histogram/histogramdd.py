"""N-D histogram (reference: chroma/histogram/histogramdd.py)."""
from __future__ import annotations

from copy import deepcopy

import numpy as np


class HistogramDD(object):
    """Multidimensional histogram.

    bins: int / sequence-of-ints / sequence of bin-edge arrays, with
    `range` per dimension when bins are counts (numpy.histogramdd
    conventions)."""

    def __init__(self, bins=10, range=None, dims=None):
        if np.isscalar(bins):
            if range is None:
                raise ValueError('range required with scalar bins')
            range = np.asarray(range, dtype=float)
            if range.ndim == 1:
                range = range[np.newaxis, :]
            self.bins = [np.linspace(lo, hi, bins + 1) for lo, hi in range]
        elif np.isscalar(bins[0]):
            if range is None:
                raise ValueError('range required with per-dim bin counts')
            self.bins = [np.linspace(lo, hi, b + 1)
                         for b, (lo, hi) in zip(bins, range)]
        else:
            self.bins = [np.asarray(b, dtype=float) for b in bins]

        self.bincenters = [(b[:-1] + b[1:]) / 2 for b in self.bins]
        shape = tuple(len(b) - 1 for b in self.bins)
        self.hist = np.zeros(shape)
        self.errs = np.zeros(shape)
        self.nentries = 0

    @property
    def ndim(self):
        return len(self.bins)

    def fill(self, x):
        "Fill with an (n, ndim) array of points."
        x = np.atleast_2d(np.asarray(x))
        add = np.histogramdd(x, self.bins)[0]
        self.hist += add
        self.errs = np.sqrt(self.errs ** 2 + add)
        self.nentries += int(add.sum())

    def findbin(self, x):
        "Tuple of per-dimension bin indices for point(s) x."
        x = np.atleast_2d(np.asarray(x))
        return tuple(np.searchsorted(b, x[:, i], side='right') - 1
                     for i, b in enumerate(self.bins))

    def eval(self, x, fill_value=0):
        idx = self.findbin(x)
        valid = np.ones(len(idx[0]), dtype=bool)
        clipped = []
        for i, b in enumerate(idx):
            valid &= (b >= 0) & (b < self.hist.shape[i])
            clipped.append(np.clip(b, 0, self.hist.shape[i] - 1))
        return np.where(valid, self.hist[tuple(clipped)], fill_value)

    def ueval(self, x, fill_value=0, fill_err=0):
        idx = self.findbin(x)
        valid = np.ones(len(idx[0]), dtype=bool)
        clipped = []
        for i, b in enumerate(idx):
            valid &= (b >= 0) & (b < self.hist.shape[i])
            clipped.append(np.clip(b, 0, self.hist.shape[i] - 1))
        val = np.where(valid, self.hist[tuple(clipped)], fill_value)
        err = np.where(valid, self.errs[tuple(clipped)], fill_err)
        return val, err

    def reset(self):
        self.hist[:] = 0
        self.errs[:] = 0
        self.nentries = 0

    def scale(self, c):
        self.hist *= c
        self.errs *= abs(c)

    def normalize(self):
        widths = [np.diff(b) for b in self.bins]
        cell = widths[0]
        for w in widths[1:]:
            cell = np.multiply.outer(cell, w)
        integral = (self.hist * cell).sum()
        if integral:
            self.scale(1.0 / integral)

    def __add__(self, other):
        out = deepcopy(self)
        out.hist = self.hist + other.hist
        out.errs = np.sqrt(self.errs ** 2 + other.errs ** 2)
        out.nentries = self.nentries + other.nentries
        return out
