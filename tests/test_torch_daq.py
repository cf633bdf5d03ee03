"""The torch port's DAQ and flat-hit packing against the JAX package's.

Given the same photons and the same uniforms (the JAX draws fed to the
port), the channel arrays (earliest time, charge, OR of histories) and the
flat-hit pack (channels, permutation, count) must be bit for bit equal,
for one readout and for replicas spanning two blocks; so must the gathers
of the packed hits, the host channel map, and the fields of the hits that
stay on the device (LazyHits) once they are read."""
import numpy as np
import pytest
import torch
import jax

from chroma_tpu import demo, event
from chroma_tpu.ops import daq as jdaq
from chroma_tpu.ops import types as jtypes
from chroma_tpu.ops import propagate as jprop
from chroma_tpu.ops.sample import make_key, site_key
from chroma_tpu_torch import demo as tdemo, event as tevent
from chroma_tpu_torch.ops import daq as tdaq
from chroma_tpu_torch.ops import propagate as tprop
from chroma_tpu_torch.ops import types as ttypes

from test_torch_host import same_native_kit  # noqa: F401

torch.set_num_threads(2)

N = 20000


@pytest.fixture(scope='module')
def hits():
    """Photons ending all over demo.tiny(), half of them flagged detected;
    geometry and photons built by each package from the same arrays."""
    geo = demo.tiny()
    geo.flatten()
    ga = jtypes.build_geometry_arrays(geo)
    tgeo = tdemo.tiny()
    tgeo.flatten()
    rs = np.random.RandomState(8)
    ntri = len(geo.mesh.triangles)
    flags = rs.choice([0, 2, 4, 4 | 16, 4 | 32, 8, 4 | (1 << 31)], N)
    fields = dict(
        pos=rs.randn(N, 3), dir=rs.randn(N, 3), pol=rs.randn(N, 3),
        wavelengths=np.full(N, 400.0), t=rs.uniform(0, 50, N),
        last_hit_triangles=np.where(rs.uniform(size=N) < 0.1, -1,
                                    rs.randint(0, ntri, N)),
        flags=flags.astype(np.uint32),
        weights=np.where(rs.uniform(size=N) < 0.2, 0.5, 1.0))
    return (ga, ttypes.build_geometry_arrays(tgeo),
            jprop.photon_state_from_host(event.Photons(**fields)),
            tprop.photon_state_from_host(tevent.Photons(**fields), 'cpu'))


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


@pytest.mark.parametrize('weight,state', [(0.6, tevent.SURFACE_DETECT),
                                          (1.0, tevent.SURFACE_ABSORB)])
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


def test_photon_channels_matches_jax(hits):
    "The host channel map of every photon, -1 where none was detected."
    ga, ta, js, ts = hits
    host = tprop.photon_state_to_host(ts)
    solid_id = np.asarray(ga.solid_id)
    table = np.asarray(ga.detector.solid_id_to_channel_index)
    want = jdaq.photon_channels(jprop.photon_state_to_host(js), solid_id,
                                table)
    got = tdaq.photon_channels(host, solid_id, table)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tdaq.photon_channels_device(ts, ta).numpy())


@pytest.mark.parametrize('m', [4096, N])
def test_flat_hit_gathers_match_jax(hits, m):
    """flat_hit_gather and gather_hits at gather width m: the m packed
    lanes (the detected ones first, then filler), their channels and the
    count equal JAX's bit for bit."""
    ga, ta, js, ts = hits
    j_sub, j_ch, j_n = jdaq.flat_hit_gather(js, ga, m)
    t_sub, t_ch, t_n = tdaq.flat_hit_gather(ts, ta, m)
    assert int(t_n) == int(j_n) and len(t_sub) == m
    np.testing.assert_array_equal(t_ch.numpy(), np.asarray(j_ch))
    for name, field in vars(t_sub).items():
        a = np.asarray(getattr(j_sub, name))
        a = a.view(np.int32) if a.dtype == np.uint32 else a
        assert field.numpy().tobytes() == a.tobytes(), name
    channel, perm, _ = tdaq.flat_hit_pack(ts, ta)
    g_sub, g_ch = tdaq.gather_hits(ts, channel, perm, m)
    j_gsub, j_gch = jdaq.gather_hits(js, *jdaq.flat_hit_pack(js, ga)[:2], m)
    np.testing.assert_array_equal(g_ch.numpy(), np.asarray(j_gch))
    assert g_sub.t.numpy().tobytes() == np.asarray(j_gsub.t).tobytes()


def test_lazy_hits_match_jax(hits):
    """extract_flat_hits keeps the hits on the device until a field is
    read (len() is free); then every field equals JAX's LazyHits'; slices
    and pickles are plain Photons."""
    import pickle
    ga, ta, js, ts = hits
    want = jdaq.extract_flat_hits(js, ga)
    got = tdaq.extract_flat_hits(ts, ta)
    assert isinstance(got, tdaq.LazyHits) and isinstance(got, tevent.Photons)
    n = len(got)
    assert n == len(want) > 0
    sub, ch = got.device_state()
    assert len(sub) == n and (ch >= 0).all()
    assert 'pos' not in vars(got)
    for name in tdaq.LazyHits._FIELDS:
        a = np.asarray(getattr(want, name))
        assert getattr(got, name).tobytes() == a.tobytes(), name
    assert got.device_state() is None
    assert type(got[:n // 2]) is tevent.Photons and len(got[:n // 2]) == n // 2
    back = pickle.loads(pickle.dumps(tdaq.extract_flat_hits(ts, ta)))
    assert type(back) is tevent.Photons and len(back) == n
    assert back.channel.tobytes() == got.channel.tobytes()


def test_propagate_with_hits_matches_jax():
    """propagate_with_hits: the final state and its LazyHits, which equal
    extract_flat_hits of that state; on the box detector the detected
    count agrees with JAX's propagate_with_hits within 5 sigma."""
    from test_torch_host import J, T, _box_detector
    from chroma_tpu.loader import create_geometry_from_obj
    n = 4096
    counts = []
    for h in (J, T):
        np.random.seed(2)
        bomb = h.photon_bomb(n, 400.0, (0, 0, 0))
        if h is J:
            ga = jtypes.build_geometry_arrays(create_geometry_from_obj(
                _box_detector(J), update_bvh_cache=False))
            result, got = jdaq.propagate_with_hits(
                jprop.photon_state_from_host(bomb), ga, make_key(3),
                max_steps=50)
        else:
            geo = _box_detector(T)
            geo.flatten()
            ta = ttypes.build_geometry_arrays(geo)
            result, got = tdaq.propagate_with_hits(
                tprop.photon_state_from_host(bomb, 'cpu'), ta, 3,
                max_steps=50)
            assert isinstance(got, tdaq.LazyHits)
            again = tdaq.extract_flat_hits(result, ta)
            assert len(again) == len(got)
            assert again.t.tobytes() == got.t.tobytes()
            flags = result.flags.numpy().view(np.uint32)
            assert len(got) == int(((flags & tevent.SURFACE_DETECT)
                                    != 0).sum())
        counts.append(len(got))
    p = sum(counts) / (2.0 * n)
    assert 0.4 < p < 0.6
    assert abs(counts[0] - counts[1]) <= 5 * np.sqrt(2 * n * p * (1 - p))
