"""The port's analysis tools (histogram/, parabola.py, pi0.py, color/):
the cases of tests/test_analysis.py run on the port, and each copy held bit
for bit to its original on the same numpy-seeded inputs."""
import importlib

import numpy as np
import pytest

PKGS = ['chroma_tpu', 'chroma_tpu_torch']


def mod(pkg, name):
    return importlib.import_module(pkg + '.' + name)


def both(fn):
    "fn(pkg) for the JAX package and the port."
    return fn(PKGS[0]), fn(PKGS[1])


def _bits(a):
    return np.asarray(a).tobytes()


def test_histogram_fill_and_moments():
    def run(pkg):
        h = mod(pkg, 'histogram').Histogram(100, (-5, 5))
        np.random.seed(0)
        h.fill(np.random.normal(0, 1, 100000))
        return h
    hj, h = both(run)
    assert type(h).__module__ == 'chroma_tpu_torch.histogram.histogram'
    assert abs(h.mean()) < 0.02
    assert abs(h.rms() - 1.0) < 0.02
    assert h.nentries > 99000
    # eval/interp at the center returns the peak bin
    assert h.eval(0.0) == h.hist[h.findbin(0.0)]
    xs = np.linspace(-6, 6, 101)
    for a, b in ((hj.hist, h.hist), (hj.errs, h.errs), (hj.bins, h.bins),
                 (hj.mean(), h.mean()), (hj.rms(), h.rms()),
                 (hj.eval(xs), h.eval(xs)), (hj.interp(xs), h.interp(xs)),
                 (hj.ueval(xs)[1], h.ueval(xs)[1])):
        assert _bits(a) == _bits(b)
    for hist in (hj, h):
        hist.normalize()
    widths = np.diff(h.bins)
    np.testing.assert_allclose((h.hist * widths).sum(), 1.0, rtol=1e-6)
    assert _bits(hj.hist) == _bits(h.hist)
    total, scaled = h + h, h * 2.0
    np.testing.assert_allclose(total.hist, scaled.hist)
    h.reset()
    assert h.hist.sum() == 0 and h.nentries == 0


def test_histogramdd():
    def run(pkg):
        h = mod(pkg, 'histogram').HistogramDD(bins=(10, 20),
                                              range=[(0, 1), (0, 2)])
        np.random.seed(3)
        h.fill(np.random.uniform([0, 0], [1, 2], size=(10000, 2)))
        return h
    hj, h = both(run)
    assert h.hist.sum() == 10000 and h.ndim == 2
    pts = [[0.5, 1.0], [0.05, 1.95], [2.0, 0.5]]
    val = h.eval(pts)
    assert val[0] > 0 and val[2] == 0
    assert _bits(hj.hist) == _bits(h.hist)
    assert _bits(hj.eval(pts)) == _bits(val)
    assert _bits(hj.ueval(pts)[1]) == _bits(h.ueval(pts)[1])
    for hist in (hj, h):
        hist.normalize()
    assert _bits(hj.hist) == _bits(h.hist)


def test_graph_and_draw():
    Graph = mod(PKGS[1], 'histogram').Graph
    g = Graph([1, 2, 3], [2.0, 4.0, 8.0], yerr=[0.1, 0.2, 0.3])
    assert g.size == 3 and g.xerr.tolist() == [0, 0, 0]
    with pytest.raises(ValueError):
        Graph([1, 2], [1])
    import matplotlib
    matplotlib.use('Agg')
    draw = mod(PKGS[1], 'histogram.draw').draw
    h = mod(PKGS[1], 'histogram').Histogram(5, (0, 5))
    h.fill([0.5, 1.5, 1.6])
    ax = draw(h)
    assert draw(g, ax=ax) is ax
    with pytest.raises(TypeError):
        draw(object())


def _quadratic_points(pkg, a, b, c, noise=0.01):
    "1-D parabola sample points with uncertainties."
    ufloat = mod(pkg, 'ufloat').ufloat
    return [(np.array([x]), ufloat(a + b * x + c * x * x, noise))
            for x in np.linspace(-1, 1, 11)]


def test_parabola_fit_1d():
    def run(pkg):
        par = mod(pkg, 'parabola')
        a, b, c, chi2, prob = par.parabola_fit(
            _quadratic_points(pkg, 2.0, -1.0, 3.0))
        y = par.parabola_eval(np.array([0.5]), a, b, c)
        xmin, fmin = par.parabola_minimum(a, b, c)
        return a, b, c, chi2, prob, y, xmin, fmin
    rj, rt = both(run)
    a, b, c, chi2, prob, y, xmin, fmin = rt
    assert abs(a.nominal_value - 2.0) < 1e-4
    assert abs(b[0].nominal_value - (-1.0)) < 1e-4
    assert abs(c[0, 0].nominal_value - 3.0) < 1e-4
    assert chi2 < 1e-6  # exact quadratic data
    # uncertainties are propagated (non-zero)
    assert a.std_dev() > 0
    assert abs(y.nominal_value - (2.0 - 0.5 + 0.75)) < 1e-4
    assert abs(xmin[0] - (1.0 / 6.0)) < 1e-4
    assert type(a).__module__ == 'chroma_tpu_torch.ufloat'
    aj, bj, cj = rj[:3]
    assert (aj.nominal_value, aj.std_dev()) == (a.nominal_value, a.std_dev())
    assert bj[0].nominal_value == b[0].nominal_value
    assert cj[0, 0].std_dev() == c[0, 0].std_dev()
    assert rj[3:5] == rt[3:5]
    assert rj[5].nominal_value == y.nominal_value
    assert _bits(rj[6]) == _bits(xmin)


def test_parabola_fit_2d():
    def run(pkg):
        ufloat = mod(pkg, 'ufloat').ufloat
        pts = []
        for x in np.linspace(-1, 1, 5):
            for y in np.linspace(-1, 1, 5):
                f = 1.0 + 2 * x - y + 0.5 * x * x + 0.25 * y * y \
                    + 0.1 * x * y
                pts.append((np.array([x, y]), ufloat(f, 0.01)))
        return mod(pkg, 'parabola').parabola_fit(pts)
    (aj, bj, cj, chi2j, _), (a, b, c, chi2, prob) = both(run)
    assert abs(a.nominal_value - 1.0) < 1e-3
    assert abs(b[0].nominal_value - 2.0) < 1e-3
    assert abs(b[1].nominal_value + 1.0) < 1e-3
    assert abs(c[0, 0].nominal_value - 0.5) < 1e-3
    assert abs(c[1, 1].nominal_value - 0.25) < 1e-3
    # off-diagonal split across (i,j)/(j,i)
    assert abs(c[0, 1].nominal_value * 2 - 0.1) < 1e-3
    assert chi2 == chi2j and a.nominal_value == aj.nominal_value
    for i in range(2):
        assert b[i].nominal_value == bj[i].nominal_value
        for j in range(2):
            assert c[i, j].nominal_value == cj[i, j].nominal_value


@pytest.mark.parametrize('theta,phi', [(0.7, 1.1), (0.0, 0.0), (2.9, -2.0)])
def test_pi0_decay(theta, phi):
    pi0 = mod(PKGS[1], 'pi0')
    # energy and momentum conservation in the lab frame
    e_pi0 = 500.0  # MeV
    direction = np.array([0.0, 0.0, 1.0])
    (e1, v1), (e2, v2) = pi0.pi0_decay(e_pi0, direction, theta=theta,
                                       phi=phi)
    assert abs((e1 + e2) - e_pi0) < 1e-6 * e_pi0
    p_total = e1 * v1 + e2 * v2
    p_expected = np.sqrt(e_pi0 ** 2 - pi0.PI0_MASS_MEV ** 2) * direction
    np.testing.assert_allclose(p_total, p_expected, atol=1e-6 * e_pi0)
    # invariant mass of the photon pair is the pi0 mass
    m2 = (e1 + e2) ** 2 - np.dot(p_total, p_total)
    assert abs(np.sqrt(m2) - pi0.PI0_MASS_MEV) < 1e-3
    # the original gives the same photons
    (f1, w1), (f2, w2) = mod(PKGS[0], 'pi0').pi0_decay(
        e_pi0, direction, theta=theta, phi=phi)
    assert (e1, e2) == (f1, f2)
    assert _bits(v1) == _bits(w1) and _bits(v2) == _bits(w2)


def test_color_maps_match():
    """map_wavelength reads the port's own CIE table; map_to_color's
    built-in reversed jet equals matplotlib's, which the original uses."""
    import os
    cj, ct = mod(PKGS[0], 'color'), mod(PKGS[1], 'color')
    chroma = mod(PKGS[1], 'color.chromaticity')
    assert os.path.dirname(chroma.__file__) in os.path.realpath(
        os.path.join(os.path.dirname(chroma.__file__), 'ciexyz64_1.csv'))
    assert _bits(mod(PKGS[0], 'color.chromaticity').color_map) == \
        _bits(chroma.color_map)
    wl = np.linspace(300.0, 900.0, 1001)
    assert _bits(cj.map_wavelength(wl)) == _bits(ct.map_wavelength(wl))
    assert _bits(cj.map_wavelength(555.0)) == _bits(ct.map_wavelength(555.0))
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100000):
        x = rng.normal(size=n) * 37.0
        w = rng.random(n)
        assert cj.map_to_color(x).dtype == ct.map_to_color(x).dtype
        assert _bits(cj.map_to_color(x)) == _bits(ct.map_to_color(x))
        assert _bits(cj.map_to_color(x, weights=w)) == \
            _bits(ct.map_to_color(x, weights=w))
        assert _bits(cj.map_to_color(x, range=(-10, 10))) == \
            _bits(ct.map_to_color(x, range=(-10, 10)))
    ramp = np.linspace(0.0, 1.0, 100001)
    assert _bits(cj.map_to_color(ramp)) == _bits(ct.map_to_color(ramp))
    import matplotlib.cm as cm
    assert _bits(ct.map_to_color(ramp, map=cm.viridis)) == \
        _bits(cj.map_to_color(ramp, map=cm.viridis))
