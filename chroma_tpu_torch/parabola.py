"""Multidimensional parabola fitting with uncertainties
(reference: chroma/parabola.py; SVD least squares per Numerical Recipes
15.4, chi2 probability via scipy instead of ROOT)."""
from __future__ import annotations

import numpy as np

from chroma_tpu_torch.ufloat import (UFloat, correlated_values, nominal_values,
                               std_devs)


def build_design_matrix(x, y):
    "Quadratic design matrix rows [1, x_i, x_j*x_k], sigma-weighted."
    y_invsigma = 1.0 / std_devs(y)
    dims = x.shape[1]
    n = int(1 + dims + dims * (dims + 1) / 2)

    a = np.zeros(shape=(len(x), n))
    a[:, 0] = 1.0 * y_invsigma
    for i in range(dims):
        a[:, 1 + i] = x[:, i] * y_invsigma

    col = 1 + dims
    for j in range(dims):
        for k in range(j, dims):
            a[:, col] = x[:, j] * x[:, k] * y_invsigma
            col += 1
    return a


def build_design_vector(y):
    return nominal_values(y) / std_devs(y)


def _chi2_prob(chi2, ndf):
    from scipy.stats import chi2 as chi2_dist
    return float(chi2_dist.sf(chi2, ndf))


def parabola_fit(points):
    """Least-squares fit of f(x) = a + b.x + x.c.x to a list of
    (x_vector, ufloat) points. Returns (a, b, c, chi2, prob) with
    coefficient uncertainties from the SVD covariance."""
    dims = points[0][0].shape[0]
    x = np.array([p[0] for p in points])
    f = np.array([p[1] for p in points], dtype=object)

    a_mat = build_design_matrix(x, f)
    b_vec = build_design_vector(f)[:, np.newaxis]

    u, w, vt = np.linalg.svd(a_mat, full_matrices=False)
    v = vt.T  # Numerical Recipes convention
    inv_w = 1.0 / w
    inv_w[np.abs(w) < 1e-6] = 0.0
    # Eq 15.4.17
    coeffs = np.zeros(a_mat.shape[1])
    for i in range(len(coeffs)):
        coeffs += (np.dot(u[:, i], b_vec[:, 0]) * inv_w[i]) * v[:, i]

    chi2_terms = np.dot(a_mat, coeffs[:, np.newaxis]) - b_vec
    chi2 = float((chi2_terms ** 2).sum())
    ndf = len(points) - int(1 + dims + dims * (dims + 1) / 2)
    prob = _chi2_prob(chi2, ndf)

    # Eq 15.4.20
    covariance = np.dot(v * inv_w ** 2, v.T)
    ufloat_coeffs = correlated_values(coeffs, covariance)

    a = ufloat_coeffs[0]
    b = np.array(ufloat_coeffs[1:dims + 1])
    c = np.zeros(shape=(dims, dims), dtype=object)
    index = dims + 1
    for i in range(dims):
        for j in range(i, dims):
            cij = ufloat_coeffs[index]
            if j != i:
                # off-diagonal terms were combined in the fit; split them
                cij = cij / 2.0
            c[i, j] = cij
            c[j, i] = cij
            index += 1

    return a, b, c, chi2, prob


def parabola_eval(x, a, b, c):
    "Evaluate the fitted parabola at point(s) x."
    if len(x.shape) == 1:
        return a + np.dot(x, b) + np.dot(x, np.dot(c, x.T))
    y = np.array([a] * x.shape[0])
    for i, xrow in enumerate(x):
        y[i] = y[i] + np.dot(xrow, b) + np.dot(xrow, np.dot(c, xrow.T))
    return y


def parabola_minimum(a, b, c):
    """Location and value of the parabola's extremum: x* = -c^-1 b / 2.
    Returns (x (dims,), f(x*) ufloat)."""
    bn = nominal_values(b)
    cn = np.array([[getattr(c[i, j], 'nominal_value', float(c[i, j]))
                    for j in range(c.shape[1])]
                   for i in range(c.shape[0])])
    xmin = -0.5 * np.linalg.solve(cn, bn)
    fmin = parabola_eval(xmin, a, b, c)
    if not isinstance(fmin, UFloat):
        fmin = UFloat(float(fmin), 0.0)
    return xmin, fmin
