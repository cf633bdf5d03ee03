"""The torch port's DAQ and flat-hit packing against the JAX package's.

Given the same photons and the same uniforms (the JAX draws fed to the
port), the channel arrays (earliest time, charge, OR of histories) and the
flat-hit pack (channels, permutation, count) must be bit for bit equal,
for one readout and for replicas spanning two blocks; so must the gathers
of the packed hits, the host channel map, and the fields of the hits that
stay on the device (LazyHits) once they are read."""
import os

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

from daq_cases import (DAQ_CASES, channel_arrays_equal, daq_case,
                       daq_geometries)
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


@pytest.mark.parametrize('ndaq', [1, 7, 8, 9, 50])
def test_draw_buffer_matches_per_block_rand(ndaq):
    """daq_draws fills its (blocks, 3, rows, N) buffer with the numbers one
    torch.rand a block and site (keep, time, charge) gives from the same
    generator, the last block drawn whole, and leaves the generator where
    those calls leave it."""
    n = 1001
    gen = torch.Generator()
    gen.manual_seed(2 ** 33 + 5)
    got = tdaq.daq_draws(n, ndaq, 'cpu', gen)
    after = torch.rand(4, generator=gen)
    gen.manual_seed(2 ** 33 + 5)
    rows = min(ndaq, tdaq.DAQ_BLOCK)
    nblocks = -(-ndaq // tdaq.DAQ_BLOCK)
    assert got.shape == (nblocks, 3, rows, n) and got.dtype == torch.float32
    for b in range(nblocks):
        for site in range(3):
            assert torch.equal(got[b, site],
                               torch.rand((rows, n), generator=gen))
    assert torch.equal(after, torch.rand(4, generator=gen))


@pytest.mark.parametrize('ndaq', [1, 9])
def test_draw_buffer_holds_injected_uniforms(ndaq):
    """daq_draws with `uniforms` copies uniforms(block, site, (rows, N))
    into block `block`, site `site` of its buffer, the last block whole,
    and draws nothing from a generator."""
    n = 37
    calls = []

    def uniforms(block, site, shape):
        calls.append((block, site, shape))
        return np.full(shape, 0.125 * (3 * block + site) + 0.0625,
                       np.float64)
    got = tdaq.daq_draws(n, ndaq, 'cpu', uniforms=uniforms)
    rows = min(ndaq, tdaq.DAQ_BLOCK)
    nblocks = -(-ndaq // tdaq.DAQ_BLOCK)
    assert got.shape == (nblocks, 3, rows, n) and got.dtype == torch.float32
    assert calls == [(b, site, (rows, n)) for b in range(nblocks)
                     for site in range(3)]
    for b in range(nblocks):
        for site in range(3):
            assert torch.equal(got[b, site], torch.full(
                (rows, n), 0.125 * (3 * b + site) + 0.0625))


def test_rows_past_ndaq_contribute_nothing(hits):
    """The last block's rows past ndaq are drawn but read by no replica:
    with every one of their draws changed (every photon kept, another time
    and charge) the readout is the same, and it has ndaq * C slots."""
    _, ta, _, ts = hits
    ndaq = 9
    gen = torch.Generator()
    gen.manual_seed(4)
    draws = tdaq.daq_draws(len(ts), ndaq, 'cpu', gen)
    base = tdaq.readout_plain(ts, ta, draws, ndaq)
    changed = draws.clone()
    changed[-1, :, ndaq - tdaq.DAQ_BLOCK:] = 0.999
    got = tdaq.readout_plain(ts, ta, changed, ndaq)
    assert base.earliest_time.shape == (ndaq * ta.detector.nchannels,)
    for name in ('earliest_time', 'charge', 'histories'):
        assert torch.equal(getattr(got, name), getattr(base, name)), name


def test_run_daq_on_cpu_never_touches_k4(hits, monkeypatch):
    """run_daq on CPU tensors reads out with the plain twin: K4's wrapper
    is neither built nor called, and K4's launch count stays as it was."""
    from chroma_tpu_torch.ops import cuda_build, daq_kernel

    def boom(*args, **kwargs):
        raise AssertionError('K4 touched on the CPU')
    monkeypatch.setattr(daq_kernel, 'readout', boom)
    monkeypatch.setattr(daq_kernel.library, 'load', boom)
    _, ta, _, ts = hits
    before = cuda_build.launches['k4']
    gen = torch.Generator()
    gen.manual_seed(9)
    got = tdaq.run_daq(ts, ta, gen, ndaq=10)
    assert (got.earliest_time < tdaq.HIT_TIME_CUT).any()
    assert cuda_build.launches['k4'] == before


@pytest.fixture(scope='module')
def host_k4():
    """K4 (csrc/daq_kernel.cu) built for the host (tools_torch/
    kernel_emulation.py): daq_kernel.readout runs it on CPU tensors."""
    import shutil
    import sys
    from chroma_tpu_torch.ops import daq_kernel
    if shutil.which('g++') is None:
        pytest.skip('needs g++ to build the kernel for the host')
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'tools_torch'))
    import kernel_emulation
    with kernel_emulation.host_kernels((daq_kernel,)):
        yield


@pytest.fixture(scope='module')
def daq_geos():
    return daq_geometries()


@pytest.mark.parametrize('name', list(DAQ_CASES))
def test_host_built_k4_matches_twin(host_k4, daq_geos, name):
    """K4 built for the host, its threads real threads and its atomics
    atomic, against readout_plain on the same draws: the cases of the card
    test (tests/test_torch_cuda.py), bit for bit. The readout's arithmetic
    is IEEE adds, multiplies and divides and one rint, which glibc and the
    card round alike."""
    from chroma_tpu_torch.ops import cuda_build, daq_kernel
    photons, ga, kw = daq_case(daq_geos, name, 'cpu')
    ndaq = kw['ndaq']
    draws = tdaq.daq_draws(len(photons), ndaq, 'cpu',
                           uniforms=kw['uniforms'])
    opts = (kw.get('global_weight', 1.0),
            kw.get('detection_state', tevent.SURFACE_DETECT))
    before = cuda_build.launches['k4']
    got = tdaq.ChannelArrays(*daq_kernel.readout(photons, ga, draws, ndaq,
                                                 *opts))
    assert cuda_build.launches['k4'] == before + 1
    ref = tdaq.readout_plain(photons, ga, draws, ndaq, *opts)
    channel_arrays_equal(got, ref)
    t = ref.earliest_time
    assert bool((t < 0).any()) and bool(((t > 0) & (t < tdaq.HIT_TIME_CUT))
                                        .any())
    assert bool((t == tdaq.MAX_TIME).any()) == (name == 'few-photons')
