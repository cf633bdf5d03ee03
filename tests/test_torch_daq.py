"""The torch port's DAQ and flat-hit packing against the JAX package's.

Given the same photons and the same uniforms (the JAX draws fed to the
port), the channel arrays (earliest time, charge, OR of histories) and the
flat-hit pack (channels, permutation, count) must be bit for bit equal,
for one readout and for replicas spanning two blocks."""
import numpy as np
import pytest
import torch
import jax

from chroma_tpu import demo, event
from chroma_tpu.ops import daq as jdaq
from chroma_tpu.ops import types as jtypes
from chroma_tpu.ops import propagate as jprop
from chroma_tpu.ops.sample import make_key, site_key
from chroma_tpu_torch.ops import daq as tdaq
from chroma_tpu_torch.ops import propagate as tprop
from chroma_tpu_torch.ops.types import from_jax_arrays

torch.set_num_threads(2)

N = 20000


@pytest.fixture(scope='module')
def hits():
    "Photons ending all over demo.tiny(), half of them flagged detected."
    geo = demo.tiny()
    geo.flatten()
    ga = jtypes.build_geometry_arrays(geo)
    rs = np.random.RandomState(8)
    ntri = len(geo.mesh.triangles)
    flags = rs.choice([0, 2, 4, 4 | 16, 4 | 32, 8, 4 | (1 << 31)], N)
    photons = event.Photons(
        pos=rs.randn(N, 3), dir=rs.randn(N, 3), pol=rs.randn(N, 3),
        wavelengths=np.full(N, 400.0), t=rs.uniform(0, 50, N),
        last_hit_triangles=np.where(rs.uniform(size=N) < 0.1, -1,
                                    rs.randint(0, ntri, N)),
        flags=flags.astype(np.uint32),
        weights=np.where(rs.uniform(size=N) < 0.2, 0.5, 1.0))
    return (ga, from_jax_arrays(ga), jprop.photon_state_from_host(photons),
            tprop.photon_state_from_host(photons, 'cpu'))


def test_flat_hit_pack_bitwise(hits):
    ga, ta, js, ts = hits
    j_ch, j_perm, j_n = [np.asarray(x) for x in jdaq.flat_hit_pack(js, ga)]
    t_ch, t_perm, t_n = tdaq.flat_hit_pack(ts, ta)
    np.testing.assert_array_equal(t_ch.numpy(), j_ch)
    np.testing.assert_array_equal(t_perm.numpy(), j_perm)
    assert int(t_n) == int(j_n) > 0
    flat = tdaq.extract_flat_hits(ts, ta)
    assert len(flat) == int(j_n)
    np.testing.assert_array_equal(flat.channel, j_ch[j_perm[:int(j_n)]])


@pytest.mark.parametrize('ndaq', [1, 10])
def test_run_daq_bitwise(hits, ndaq):
    ga, ta, js, ts = hits
    key = make_key(17)
    ref = jdaq.run_daq(js, ga, key, ndaq=ndaq)

    def uniforms(block, site, shape):
        bkey = key if ndaq <= jdaq.DAQ_BLOCK else \
            jax.random.fold_in(key, block)
        return np.asarray(jax.random.uniform(site_key(bkey, site), shape))

    got = tdaq.run_daq(ts, ta, ndaq=ndaq, uniforms=uniforms)
    c = ga.detector.nchannels
    assert got.earliest_time.shape == (ndaq * c,)
    for name in ('earliest_time', 'charge', 'histories'):
        a = np.asarray(getattr(ref, name))
        a = a.view(np.int32) if a.dtype == np.uint32 else a
        np.testing.assert_array_equal(getattr(got, name).numpy(), a,
                                      err_msg=name)
    hit = got.earliest_time.numpy() < tdaq.HIT_TIME_CUT
    assert hit.sum() > c // 2
    # bit 31 (NAN_ABORT) survives the OR as a u32 history
    ch = tdaq.channels_to_host(got)
    assert ch.flags.dtype == np.uint32 and (ch.flags >> 31).any()


@pytest.mark.parametrize('weight,state', [(0.6, event.SURFACE_DETECT),
                                          (1.0, event.SURFACE_ABSORB)])
def test_run_daq_weight_and_detection_state_bitwise(hits, weight, state):
    """global_weight scales every photon's keep probability, and
    detection_state picks the flag bit that counts as a detection (the
    weighted likelihood runs); wire hits (last-hit triangle -2) are no
    triangle."""
    ga, ta, js, ts = hits
    lh = ts.last_hit_triangle.clone()
    lh[::7] = -2
    ts = ts.replace(last_hit_triangle=lh)
    js = js.replace(last_hit_triangle=jax.numpy.asarray(lh.numpy()))
    key = make_key(23)
    ref = jdaq.run_daq(js, ga, key, ndaq=3, global_weight=weight,
                       detection_state=state)

    def uniforms(block, site, shape):
        return np.asarray(jax.random.uniform(site_key(key, site), shape))

    got = tdaq.run_daq(ts, ta, ndaq=3, uniforms=uniforms,
                       global_weight=weight, detection_state=state)
    for name in ('earliest_time', 'charge', 'histories'):
        a = np.asarray(getattr(ref, name))
        a = a.view(np.int32) if a.dtype == np.uint32 else a
        np.testing.assert_array_equal(getattr(got, name).numpy(), a,
                                      err_msg=name)
    hist = got.histories.numpy().view(np.uint32)
    assert ((hist & state) != 0).sum() > 0
    base = tdaq.run_daq(ts, ta, ndaq=3, uniforms=uniforms,
                        detection_state=state)
    assert (got.charge.numpy() <= base.charge.numpy()).all()
    if weight < 1.0:
        assert got.charge.sum() < base.charge.sum()
