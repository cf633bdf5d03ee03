"""1-D histogram with Poisson errors (reference: chroma/histogram/histogram.py)."""
from __future__ import annotations

from copy import deepcopy

import numpy as np


class Histogram(object):
    """Binned 1-D histogram.

    bins: int (with `range`) or explicit bin-edge sequence. Bins are
    half-open [lo, hi) except the last, which includes its upper edge
    (numpy.histogram convention).
    """

    def __init__(self, bins=10, range=(-0.5, 9.5)):
        if np.isscalar(bins):
            self.bins = np.linspace(range[0], range[1], bins + 1)
        else:
            self.bins = np.asarray(bins, float)
            if (np.diff(self.bins) < 0).any():
                raise AttributeError('bins must increase monotonically.')

        self.bincenters = (self.bins[:-1] + self.bins[1:]) / 2
        self.errs = np.zeros(self.bins.size - 1)
        self.hist = np.zeros(self.bins.size - 1)
        self.nentries = 0

    def fill(self, x):
        "Fill with values from array `x`."
        add = np.histogram(np.asarray(x), self.bins)[0]
        self.hist += add
        self.errs = np.sqrt(self.errs ** 2 + add)
        self.nentries += int(np.sum(add))

    def findbin(self, x):
        "Bin index containing `x` (-1/overflow handled by clipping)."
        return np.searchsorted(self.bins, x, side='right') - 1

    def eval(self, x, fill_value=0):
        "Histogram content at point(s) `x`."
        bins = self.findbin(x)
        valid = (bins >= 0) & (bins < len(self.hist))
        out = np.where(valid, self.hist[np.clip(bins, 0,
                                                len(self.hist) - 1)],
                       fill_value)
        return out if np.iterable(x) else float(out)

    def ueval(self, x, fill_value=0, fill_err=0):
        "Content and error at point(s) `x` as (value, err)."
        bins = self.findbin(x)
        valid = (bins >= 0) & (bins < len(self.hist))
        idx = np.clip(bins, 0, len(self.hist) - 1)
        val = np.where(valid, self.hist[idx], fill_value)
        err = np.where(valid, self.errs[idx], fill_err)
        return val, err

    def interp(self, x):
        "Linear interpolation of bin contents at `x`."
        return np.interp(x, self.bincenters, self.hist)

    def mean(self):
        total = self.hist.sum()
        return float((self.bincenters * self.hist).sum() / total) \
            if total else 0.0

    def rms(self):
        total = self.hist.sum()
        if not total:
            return 0.0
        m = self.mean()
        return float(np.sqrt((self.hist * (self.bincenters - m) ** 2).sum()
                             / total))

    def reset(self):
        self.hist[:] = 0
        self.errs[:] = 0
        self.nentries = 0

    def scale(self, c):
        self.hist *= c
        self.errs *= abs(c)

    def normalize(self):
        "Scale so the integral (sum * bin width) is 1."
        widths = np.diff(self.bins)
        integral = (self.hist * widths).sum()
        if integral:
            self.scale(1.0 / integral)

    def __add__(self, other):
        out = deepcopy(self)
        out.hist = self.hist + other.hist
        out.errs = np.sqrt(self.errs ** 2 + other.errs ** 2)
        out.nentries = self.nentries + other.nentries
        return out

    def __mul__(self, c):
        out = deepcopy(self)
        out.scale(c)
        return out

    __rmul__ = __mul__
