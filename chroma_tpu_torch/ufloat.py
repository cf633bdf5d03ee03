"""Minimal value-with-uncertainty arithmetic.

The reference depends on the external `uncertainties` package for its
likelihood/parabola results; this standalone shim provides the subset used
there (ufloat arithmetic with uncorrelated first-order propagation, and
correlated_values which keeps the marginal sigmas from a covariance
matrix)."""
from __future__ import annotations

import math

import numpy as np


class UFloat(object):
    __slots__ = ('nominal_value', '_std_dev')

    def __init__(self, nominal_value, std_dev=0.0):
        self.nominal_value = float(nominal_value)
        self._std_dev = float(std_dev)

    def std_dev(self):
        return self._std_dev

    # the external package exposes std_dev both ways across versions
    @property
    def s(self):
        return self._std_dev

    @property
    def n(self):
        return self.nominal_value

    def _coerce(self, other):
        if isinstance(other, UFloat):
            return other
        return UFloat(other, 0.0)

    def __add__(self, other):
        o = self._coerce(other)
        return UFloat(self.nominal_value + o.nominal_value,
                      math.hypot(self._std_dev, o._std_dev))

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        return UFloat(self.nominal_value - o.nominal_value,
                      math.hypot(self._std_dev, o._std_dev))

    def __rsub__(self, other):
        return self._coerce(other) - self

    def __mul__(self, other):
        o = self._coerce(other)
        n = self.nominal_value * o.nominal_value
        s = math.hypot(self._std_dev * o.nominal_value,
                       o._std_dev * self.nominal_value)
        return UFloat(n, s)

    __rmul__ = __mul__

    def __truediv__(self, other):
        o = self._coerce(other)
        n = self.nominal_value / o.nominal_value
        s = abs(n) * math.hypot(
            self._std_dev / self.nominal_value if self.nominal_value else 0,
            o._std_dev / o.nominal_value if o.nominal_value else 0)
        return UFloat(n, s)

    def __neg__(self):
        return UFloat(-self.nominal_value, self._std_dev)

    def __float__(self):
        return self.nominal_value

    def __repr__(self):
        return '%g+/-%g' % (self.nominal_value, self._std_dev)


def ufloat(arg, std_dev=None):
    "ufloat(n, s) or ufloat((n, s)) like the external package."
    if std_dev is None and isinstance(arg, (tuple, list)):
        return UFloat(arg[0], arg[1])
    return UFloat(arg, std_dev or 0.0)


def correlated_values(values, covariance):
    """UFloats with marginal standard deviations from a covariance matrix.
    (Correlations between the values are not tracked by this shim.)"""
    cov = np.asarray(covariance, dtype=float)
    sigmas = np.sqrt(np.maximum(np.diag(cov), 0.0))
    return [UFloat(v, s) for v, s in zip(values, sigmas)]


def nominal_values(arr):
    return np.array([getattr(v, 'nominal_value', float(v)) for v in arr])


def std_devs(arr):
    out = []
    for v in arr:
        if isinstance(v, UFloat):
            out.append(v.std_dev())
        else:
            out.append(0.0)
    return np.array(out)
