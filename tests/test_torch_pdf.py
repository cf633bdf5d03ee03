"""The torch port's PDF estimators and PDF API against the JAX package's.

The three estimators (binned accumulator, adaptive-bin evaluator, Gaussian
KDE) take the same numpy-made channel readouts in both packages: counts
must be equal, floats agree to rtol 1e-5. Then tests/test_pdf.py's three
cases (create_pdf, eval_pdf with the Likelihood facade, the kernel PDF)
run on the port's Simulation."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from chroma_tpu import event
from chroma_tpu.detector import Detector
from chroma_tpu.generator import photon_bomb
from chroma_tpu.geometry import Material, Solid, Surface, vacuum
from chroma_tpu.likelihood import Likelihood
from chroma_tpu.make import box
from chroma_tpu.ops import daq as jdaq
from chroma_tpu.ops import pdf as jpdf
import chroma_tpu_torch
from chroma_tpu_torch.ops import daq as tdaq
from chroma_tpu_torch.ops import pdf as tpdf

torch.set_num_threads(2)

C = 40        # channels
NDAQ = 24     # replicas per readout


class _Geo:
    "Just what the estimators read: the channel count and the device."
    def __init__(self, jax_side):
        det = type('Det', (), {})()
        det.nchannels = C
        det.solid_id_to_channel_index = jnp.zeros(C, jnp.int32) if jax_side \
            else torch.zeros(C, dtype=torch.int32)
        self.detector = det


def _readouts(seed):
    """(ndaq * C,) earliest times (MAX_TIME where a channel is not hit),
    charges, and the observed event's channels."""
    rs = np.random.RandomState(seed)
    hit = rs.uniform(size=(NDAQ, C)) < 0.6
    t = np.where(hit, rs.normal(10.0, 3.0, (NDAQ, C)), jdaq.MAX_TIME)
    q = np.where(hit, rs.normal(1.0, 0.3, (NDAQ, C)), 0.0)
    obs_hit = rs.uniform(size=C) < 0.7
    obs = event.Channels(hit=obs_hit,
                         t=np.where(obs_hit, rs.normal(10.0, 3.0, C), 1e9)
                         .astype(np.float32),
                         q=rs.normal(1.0, 0.3, C).astype(np.float32))
    return (t.reshape(-1).astype(np.float32),
            q.reshape(-1).astype(np.float32), obs)


def _both(t, q):
    j = jdaq.ChannelArrays(earliest_time=jnp.asarray(t), charge=jnp.asarray(q),
                           histories=jnp.zeros(len(t), jnp.uint32))
    p = tdaq.ChannelArrays(earliest_time=torch.from_numpy(t),
                           charge=torch.from_numpy(q),
                           histories=torch.zeros(len(t), dtype=torch.int32))
    return j, p


def test_accumulator_matches_jax():
    ja = jpdf.PDFAccumulator(_Geo(True), 32, (0.0, 20.0), 8, (0.0, 2.0))
    ta = tpdf.PDFAccumulator(_Geo(False), 32, (0.0, 20.0), 8, (0.0, 2.0))
    for seed in range(3):
        t, q, _ = _readouts(seed)
        j, p = _both(t, q)
        ja.add(j, ndaq=NDAQ)
        ta.add(p, ndaq=NDAQ)
    (jh, jp), (th, tp) = ja.get(), ta.get()
    assert th.dtype == np.uint32 and tp.dtype == np.uint32
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(tp, jp)
    assert tp.sum() == th.sum() > 0
    assert ta.events_in_histogram == 3 * NDAQ


@pytest.mark.parametrize('min_bin_content', [4, 40])
def test_pdf_eval_matches_jax(min_bin_content):
    t0, q0, obs = _readouts(10)
    je = jpdf.PDFEval(_Geo(True), obs, 1.0, (-0.5, 30.0), 1, (0, 5),
                      min_bin_content=min_bin_content)
    te = tpdf.PDFEval(_Geo(False), obs, 1.0, (-0.5, 30.0), 1, (0, 5),
                      min_bin_content=min_bin_content)
    for seed in range(3):
        t, q, _ = _readouts(20 + seed)
        j, p = _both(t, q)
        je.accumulate(j, ndaq=NDAQ)
        te.accumulate(p, ndaq=NDAQ)
    np.testing.assert_array_equal(te.nearest_mc.numpy(),
                                  np.asarray(je.nearest_mc))
    ref, got = je.get(), te.get()
    np.testing.assert_array_equal(got[0], ref[0])
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert (got[1][obs.hit] > 0).all()


@pytest.mark.parametrize('time_only', [True, False])
def test_kernel_pdf_matches_jax(time_only):
    _, _, obs = _readouts(30)
    jk = jpdf.KernelPDF(_Geo(True), (0.0, 25.0), (0.0, 3.0), time_only)
    tk = tpdf.KernelPDF(_Geo(False), (0.0, 25.0), (0.0, 3.0), time_only)
    for seed in range(2):
        j, p = _both(*_readouts(40 + seed)[:2])
        jk.accumulate_moments(j)
        tk.accumulate_moments(p)
    for k in (jk, tk):
        k.compute_bandwidth(obs.hit, obs.t, obs.q, scale_factor=2.0)
        k.setup_kernel(obs.hit, obs.t, obs.q)
    np.testing.assert_allclose(tk.inv_time_bandwidths.numpy(),
                               np.asarray(jk.inv_time_bandwidths), rtol=1e-5)
    for seed in range(2):
        j, p = _both(*_readouts(50 + seed)[:2])
        jk.accumulate_kernel(j)
        tk.accumulate_kernel(p)
    ref, got = jk.get_kernel_eval(), tk.get_kernel_eval()
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5)
    assert (got[1][obs.hit] > 0).any()


@pytest.fixture(scope='module')
def sim():
    "The tests/test_pdf.py box detector on the port (CPU)."
    water = Material('water')
    water.set('refractive_index', 1.33)
    water.set('absorption_length', 1e5)
    water.set('scattering_length', 1e5)
    pc = Surface('pc')
    pc.set('detect', 0.5)
    pc.set('absorb', 0.5)
    det = Detector(vacuum)
    det.add_pmt(Solid(box(1000.0, 1000, 1000), water, vacuum, surface=pc))
    det.set_time_dist_gaussian(1.2, -6.0, 6.0)
    det.set_charge_dist_gaussian(1.0, 0.1, 0.5, 1.5)
    return chroma_tpu_torch.Simulation(det, seed=11, device='cpu')


def _events(n, nphotons=500):
    for _ in range(n):
        yield event.Event(photons_beg=photon_bomb(nphotons, 400.0,
                                                  (0, 0, 0)))


def test_create_pdf(sim):
    np.random.seed(0)
    hitcount, pdf = sim.create_pdf(_events(4, nphotons=50), 32,
                                   (0, 50), 16, (-0.5, 49.5), nreps=2,
                                   ndaq=3)
    assert hitcount.shape == (1,) and pdf.shape == (1, 32, 16)
    assert pdf.sum() == hitcount.sum() > 0
    assert hitcount[0] <= 4 * 2 * 3


def test_eval_pdf_and_likelihood(sim):
    np.random.seed(1)
    obs = next(sim.simulate(photon_bomb(500, 400.0, (0, 0, 0)),
                            run_daq=True, keep_photons_end=True))
    assert obs.channels.hit[0]
    hitcount, pdf_value, pdf_uncert = sim.eval_pdf(
        obs.channels, _events(6), 0.5, (-0.5, 20.0), 1, (-0.5, 7.5),
        nreps=1, ndaq=4, min_bin_content=10)
    assert hitcount[0] > 0 and pdf_value[0] > 0 and pdf_uncert[0] > 0
    lk = Likelihood(sim, obs, trange=(-0.5, 20.0))
    nll = lk.eval(_events(50), nevals=6, nreps=1, ndaq=4)
    assert np.isfinite(nll.nominal_value) and np.isfinite(nll.s)


def test_kernel_pdf(sim):
    np.random.seed(2)
    obs = next(sim.simulate(photon_bomb(500, 400.0, (0, 0, 0)),
                            run_daq=True))
    sim.setup_kernel(obs.channels, _events(4), (-10.0, 20.0), (-0.5, 49.5),
                     nreps=1, ndaq=4)
    hitcount, pdf_values, _ = sim.eval_kernel(obs.channels, _events(4),
                                              (-10.0, 20.0), (-0.5, 49.5),
                                              nreps=1, ndaq=4)
    assert hitcount[0] > 0 and pdf_values[0] > 0
    lk = Likelihood(sim, obs, trange=(-10.0, 20.0))
    nll = lk.eval_kernel(_events(40), nevals=4, nreps=1, ndaq=4, navg=2)
    assert np.isfinite(nll.nominal_value)
