"""The torch port's user entry points against the JAX package's.

Host side, bit for bit, each side building from its own package
(test_torch_host.host): the classic BVH builders, STL meshes (ASCII,
binary, bz2), every geometry-string form of the loader with a cache under
tmp_path, and the Cache. Files cross between the packages: a .chroma event
file and a geocache written by either package load in the other with
equal contents. Device side, in the port on the CPU: PhotonState sources
give the events the equal host Photons give; the gpu facade gives
Simulation's results, and its select gives JAX's on the same state; photon
tracks equal JAX's on a geometry where no draw decides an outcome; the
ZeroMQ services answer over a loopback socket; each command-line tool runs
end to end on demo.tiny()."""
import bz2
import dataclasses
import io
import queue
import threading
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from chroma_tpu import cache as jcache, loader as jloader, stl as jstl
from chroma_tpu import bvh as jbvh
from chroma_tpu.bvh import build as jbuild
from chroma_tpu.io import EventReader as JReader, EventWriter as JWriter
from chroma_tpu.io import geocache as jgeocache
from chroma_tpu.ops import types as jtypes
import chroma_tpu_torch
from chroma_tpu_torch import cache as tcache, gpu, loader as tloader
from chroma_tpu_torch import stl as tstl
from chroma_tpu_torch import bvh as tbvh
from chroma_tpu_torch.bvh import build as tbuild
from chroma_tpu_torch.io import EventReader as TReader, EventWriter as TWriter
from chroma_tpu_torch.io import geocache as tgeocache
from chroma_tpu_torch.ops import types as ttypes
from chroma_tpu_torch.ops.propagate import photon_state_from_host
from chroma_tpu_torch.profiler import profiler

from test_torch_host import (J, T, _box_detector,  # noqa: F401
                             fresh_perf_cache, same_native_kit)

torch.set_num_threads(2)

PHOTON_FIELDS = ('pos', 'dir', 'pol', 'wavelengths', 't',
                 'last_hit_triangles', 'flags', 'weights', 'evidx',
                 'channel')


def _np(v):
    "A torch tensor, JAX array or numpy array as numpy."
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_same(a, b, prefix):
    """Two containers (dataclasses of either package) hold the same bits:
    every array equal in dtype, shape and bytes, every static field equal,
    None where the other is None; walks b's fields."""
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        name = prefix + '.' + f.name
        if vb is None or va is None:
            assert va is None and vb is None, name
        elif dataclasses.is_dataclass(vb):
            _assert_same(va, vb, name)
        elif isinstance(vb, (bool, int, float, str, tuple)):
            assert va == vb, name
        else:
            x, y = _np(va), _np(vb)
            assert x.dtype == y.dtype and x.shape == y.shape, (name, x.dtype,
                                                               y.dtype)
            assert x.tobytes() == y.tobytes(), name


def _assert_photons_equal(a, b, fields=PHOTON_FIELDS):
    assert len(a) == len(b)
    for name in fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name


def _tiny_mesh(h):
    geo = h.demo.tiny()
    geo.flatten()
    return geo.mesh


# --------------------------------------------------------------------------
# the classic BVH, STL meshes, the loader and the cache
# --------------------------------------------------------------------------

@pytest.mark.parametrize('builder', ['recursive_grid', 'simple'])
def test_classic_bvh_bitwise(builder):
    "Both classic builders on demo.tiny()'s mesh: equal nodes and layers."
    out = []
    for h, bvh in ((J, jbvh), (T, tbvh)):
        mesh = _tiny_mesh(h)
        out.append(bvh.make_recursive_grid_bvh(mesh, target_degree=3)
                   if builder == 'recursive_grid'
                   else bvh.make_simple_bvh(mesh, 8))
    jb, tb = out
    assert tb.nodes.dtype == jb.nodes.dtype
    assert tb.nodes.tobytes() == jb.nodes.tobytes()
    assert [int(x) for x in tb.layer_bounds] == \
        [int(x) for x in jb.layer_bounds]
    assert tb.world_coords.world_scale == jb.world_coords.world_scale
    assert tb.world_coords.world_origin.tobytes() == \
        jb.world_coords.world_origin.tobytes()


def test_bvh_tools_bitwise():
    """chroma-bvh's node tools on a sphere's BVH: the area sort, one
    layer's pair optimisation and the rebuild above it."""
    out = []
    for h, bvh, build in ((J, jbvh, jbuild), (T, tbvh, tbuild)):
        b = bvh.make_recursive_grid_bvh(h.sphere(100.0, nsteps=40))
        nodes = build.area_sort_nodes(b.nodes, b.layer_bounds)
        lo, hi = b.layer_bounds[2], b.layer_bounds[3]
        b.nodes[lo:hi] = build.optimize_layer(b.nodes[lo:hi])
        rebuilt = build.rebuild_above(b, 2)
        out.append((nodes, rebuilt.nodes, rebuilt.layer_bounds))
    (jn, jr, jl), (tn, tr, tl) = out
    assert tn.tobytes() == jn.tobytes() and tr.tobytes() == jr.tobytes()
    assert [int(x) for x in tl] == [int(x) for x in jl]


def _write_stl(path, mesh, binary):
    "The mesh's triangles as an STL file (ASCII or binary, .bz2 by name)."
    tri = mesh.vertices[mesh.triangles].astype(np.float32)
    if binary:
        rec = np.zeros(len(tri), dtype=[('normal', '<f4', (3,)),
                                         ('vertices', '<f4', (3, 3)),
                                         ('attr', '<u2')])
        rec['vertices'] = tri
        data = b'\0' * 80 + np.uint32(len(tri)).tobytes() + rec.tobytes()
    else:
        lines = ['solid test']
        for t in tri:
            lines += ['facet normal 0 0 0', ' outer loop']
            lines += ['  vertex %r %r %r' % tuple(map(float, v)) for v in t]
            lines += [' endloop', 'endfacet']
        data = ('\n'.join(lines + ['endsolid test']) + '\n').encode('ascii')
    if str(path).endswith('.bz2'):
        data = bz2.compress(data)
    path.write_bytes(data)


@pytest.mark.parametrize('kind', ['ascii', 'binary', 'ascii.bz2',
                                  'binary.bz2'])
def test_mesh_from_stl_bitwise(tmp_path, kind):
    path = tmp_path / ('mesh.stl' + kind[kind.find('.'):]
                       if '.' in kind else 'mesh.stl')
    _write_stl(path, T.sphere(50.0, nsteps=12), kind.startswith('binary'))
    jm = jstl.mesh_from_stl(str(path))
    tm = tstl.mesh_from_stl(str(path))
    assert type(tm).__module__ == 'chroma_tpu_torch.geometry'
    assert len(tm.triangles) == len(T.sphere(50.0, nsteps=12).triangles)
    for name in ('vertices', 'triangles'):
        a, b = getattr(jm, name), getattr(tm, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


def _loaded(form, tmp_path):
    """Each package's load_geometry_from_string for one descriptor form,
    with its own cache under tmp_path."""
    out = []
    for pkg, h, loader, cache in (('chroma_tpu', J, jloader, jcache),
                                  ('chroma_tpu_torch', T, tloader, tcache)):
        cache_dir = str(tmp_path / pkg)
        if form == 'file':
            path = tmp_path / 'cube.stl'
            if not path.exists():
                _write_stl(path, T.box(100.0, 60.0, 40.0), binary=True)
            descriptor = str(path)
        elif form == 'module':
            descriptor = '@%s.demo.tiny' % pkg
        else:
            geo = h.Geometry(h.vacuum)
            geo.add_solid(h.Solid(h.sphere(80.0, nsteps=24), h.vacuum,
                                  h.vacuum))
            geo.flatten()
            c = cache.Cache(cache_dir)
            c.save_geometry('ball', geo)
            descriptor = 'ball'
            if form == 'name:bvh':
                bvh = jbvh if pkg == 'chroma_tpu' else tbvh
                c.save_bvh(bvh.make_simple_bvh(geo.mesh, 4), geo.mesh.md5(),
                           'simple4')
                descriptor = 'ball:simple4'
        out.append(loader.load_geometry_from_string(descriptor,
                                                    cache_dir=cache_dir))
    return out


@pytest.mark.parametrize('form', ['file', 'module', 'name', 'name:bvh'])
def test_load_geometry_from_string_bitwise(tmp_path, form):
    """"file.stl", "@pkg.module.obj", "name" and "name:bvh", each with a
    cache under tmp_path: the port's geometry is the port's own and equals
    JAX's, mesh and BVH, bit for bit."""
    jg, tg = _loaded(form, tmp_path)
    assert type(tg).__module__.startswith('chroma_tpu_torch.')
    for name in ('vertices', 'triangles'):
        a, b = getattr(jg.mesh, name), getattr(tg.mesh, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert tg.bvh is not None and type(tg.bvh).__module__ == \
        'chroma_tpu_torch.bvh.bvh'
    assert tg.bvh.nodes.tobytes() == jg.bvh.nodes.tobytes()
    assert [int(x) for x in tg.bvh.layer_bounds] == \
        [int(x) for x in jg.bvh.layer_bounds]
    if form == 'name:bvh':
        # the named BVH came from the cache, not the default build
        assert tg.bvh.layer_count() != tbvh.make_recursive_grid_bvh(
            tg.mesh).layer_count()
    # a second load reads the BVH from the cache
    again = _loaded(form, tmp_path)[1]
    assert again.bvh.nodes.tobytes() == tg.bvh.nodes.tobytes()


def test_cache_save_load_list_remove(tmp_path):
    cache = tcache.Cache(str(tmp_path / 'cache'))
    geo = T.Geometry(T.vacuum)
    geo.add_solid(T.Solid(T.cube(1.0), T.vacuum, T.vacuum))
    geo.flatten()
    cache.save_geometry('box', geo)
    cache.save_geometry('box2', geo)
    assert sorted(cache.list_geometry()) == ['box', 'box2']
    loaded = cache.load_geometry('box')
    assert type(loaded).__module__ == 'chroma_tpu_torch.geometry'
    assert loaded.mesh.md5() == cache.get_geometry_hash('box') == \
        geo.mesh.md5()
    cache.set_default_geometry('box2')
    assert cache.load_default_geometry().mesh.md5() == geo.mesh.md5()
    h = geo.mesh.md5()
    bvh = tbvh.make_recursive_grid_bvh(geo.mesh)
    cache.save_bvh(bvh, h, 'mine')
    assert cache.exist_bvh(h, 'mine') and cache.list_bvh(h) == ['mine']
    assert cache.load_bvh(h, 'mine').nodes.tobytes() == bvh.nodes.tobytes()
    cache.remove_bvh(h, 'mine')
    cache.remove_geometry('box')
    assert not cache.exist_bvh(h, 'mine')
    assert 'box' not in cache.list_geometry()
    with pytest.raises(tcache.GeometryNotFoundError):
        cache.load_geometry('box')
    with pytest.raises(tcache.BVHNotFoundError):
        cache.load_bvh(h, 'mine')


# --------------------------------------------------------------------------
# files across the packages: .chroma events and the geocache
# --------------------------------------------------------------------------

def _event(h, i):
    "An event with every stored part, from host namespace h."
    np.random.seed(40 + i)
    ev = h.event.Event(id=i)
    ev.nphotons = 100
    ev.photons_beg = h.photon_bomb(100, 400.0, (0, 0, 0))
    ev.photons_end = h.photon_bomb(100, 450.0, (1, 1, 1))
    ev.photons_end.flags[:] = np.arange(100, dtype=np.uint32) << 2
    ev.flat_hits = h.photon_bomb(7, 420.0, (2, 2, 2))
    ev.flat_hits.channel = np.arange(7, dtype=np.uint32)
    hit = np.zeros(20, dtype=bool)
    hit[[1, 5, 7]] = True
    t = np.where(hit, np.float32(10.5), np.float32(1e9)).astype(np.float32)
    q = np.where(hit, np.float32(2.25), 0).astype(np.float32)
    flags = np.where(hit, np.uint32(4 | (1 << 31)), 0).astype(np.uint32)
    ev.channels = h.event.Channels(hit, t, q, flags)
    ev.vertices = [h.event.Vertex('e-', np.zeros(3), np.array([0, 0, 1.0]),
                                  5.0, t0=1.5, trackid=3, pdgcode=11)]
    return ev


@pytest.mark.parametrize('direction', ['jax_to_port', 'port_to_jax'])
def test_event_files_cross(tmp_path, direction):
    """A .chroma file written by one package reads back in the other with
    every stored field equal, into the reader's own classes."""
    path = str(tmp_path / 'events.chroma')
    src, dst, writer, reader = (J, T, JWriter, TReader) \
        if direction == 'jax_to_port' else (T, J, TWriter, JReader)
    written = [_event(src, i) for i in range(3)]
    with writer(path) as w:
        for ev in written:
            w.write_event(ev)
    r = reader(path)
    got = list(r)
    r.close()
    assert len(got) == 3
    for ev, orig in zip(got, written):
        assert type(ev) is dst.event.Event and ev.id == orig.id
        assert ev.nphotons == orig.nphotons
        for part in ('photons_beg', 'photons_end', 'flat_hits'):
            assert type(getattr(ev, part)) is dst.event.Photons
            _assert_photons_equal(getattr(ev, part), getattr(orig, part))
        for name in ('hit', 't', 'q', 'flags'):
            a = np.asarray(getattr(ev.channels, name))
            b = np.asarray(getattr(orig.channels, name))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
        (v,), (w,) = ev.vertices, orig.vertices
        assert (v.particle_name, v.ke, v.t0, v.trackid, v.pdgcode) == \
            (w.particle_name, w.ke, w.t0, w.trackid, w.pdgcode)
        np.testing.assert_array_equal(v.dir, w.dir)


@pytest.fixture(scope='module')
def tiny_arrays():
    "demo.tiny()'s GeometryArrays as each package builds them."
    out = []
    for h, types in ((J, jtypes), (T, ttypes)):
        geo = h.demo.tiny()
        geo.flatten()
        out.append(types.build_geometry_arrays(geo))
    return tuple(out)


_SOUP = ('vertices', 'triangles', 'tri_normals', 'material_codes', 'colors',
         'solid_id')


@pytest.mark.parametrize('lean', [False, True], ids=['dense', 'lean'])
@pytest.mark.parametrize('direction', ['jax_to_port', 'port_to_jax'])
def test_geocache_cross(tmp_path, tiny_arrays, direction, lean):
    """A geocache saved by one package loads in the other and equals the
    loader's own build of demo.tiny() bit for bit, dtypes included (u32
    codes and colors are the port's int32 bit patterns), with and without
    lean (which drops the per-triangle world arrays)."""
    ga_j, ga_t = tiny_arrays
    path = str(tmp_path / 'tiny')
    if direction == 'jax_to_port':
        jgeocache.save_geometry_arrays(path, ga_j)
        got, own = tgeocache.load_geometry_arrays(path, lean=lean), ga_t
        assert isinstance(got, ttypes.GeometryArrays)
        assert got.wide.rows.device.type == 'cpu'
    else:
        tgeocache.save_geometry_arrays(path, ga_t)
        got, own = jgeocache.load_geometry_arrays(path, lean=lean), ga_j
        assert isinstance(got, jtypes.GeometryArrays)
    if lean:
        own = dataclasses.replace(own, **{k: None for k in _SOUP})
    _assert_same(got, own, 'ga')


def _rows_v3(rows, fanout, leaf_size, packed):
    """The version-3 layout of a version-4 instanced table: bounds and
    first child at column 0 of internal rows, and each instance row (its
    tri_base and instance id at 13, 14) pointing at column 12 to a BLAS
    root row, appended at the end, that holds what the version-4 instance
    row embeds."""
    from chroma_tpu_torch.bvh.wide import INST_B0, LEAF_STRIDE, TAG_INTERNAL
    nw = 3 * fanout if packed else 6 * fanout
    tags = rows[:, -1].view(np.int32)
    old = np.zeros_like(rows)
    old[:, -1] = rows[:, -1]
    internal, idx = tags == TAG_INTERNAL, np.flatnonzero(tags == 2)
    leaf = tags == 1
    old[internal, :nw + 1] = rows[internal, INST_B0:INST_B0 + nw + 1]
    old[leaf, :LEAF_STRIDE * leaf_size] = rows[leaf,
                                               :LEAF_STRIDE * leaf_size]
    old[idx, :12] = rows[idx, :12]
    old[idx, 13:15] = rows[idx, 12:14]
    old[idx, 12] = (len(rows) + np.arange(len(idx), dtype=np.int32)
                    ).view(np.float32)
    roots = np.zeros((len(idx), rows.shape[1]), np.float32)
    roots[:, :nw + 1] = rows[idx, INST_B0:INST_B0 + nw + 1]
    roots[:, -1] = np.int32(TAG_INTERNAL).view(np.float32)
    return np.concatenate([old, roots])


def test_upgrade_instanced_rows_v3_bitwise(tiny_arrays):
    """bvh.wide.upgrade_instanced_rows_v3 equals the JAX original bit for
    bit, and turns the version-3 layout of demo.tiny()'s table back into
    the table (plus the appended root rows), bounds in bf16 and in f32,
    and a tiny mesh whose BLAS root is a leaf."""
    from chroma_tpu.bvh.wide import upgrade_instanced_rows_v3 as jup
    from chroma_tpu_torch.bvh.wide import upgrade_instanced_rows_v3 as tup
    _, ga_t = tiny_arrays
    rows = ga_t.wide.rows.numpy()
    f, k = ga_t.wide.fanout, ga_t.wide.leaf_size
    v3 = _rows_v3(rows, f, k, True)
    got = tup(v3, f, k, True)
    assert got.tobytes() == jup(v3, f, k, True).tobytes()
    assert got[:len(rows)].tobytes() == rows.tobytes()
    # an instance whose BLAS root is a leaf: its bounds are made from the
    # triangles of that leaf, packed or (in a table wide enough) f32
    leaf_row = np.flatnonzero(rows[:, -1].view(np.int32) == 1)[0]
    v3[np.flatnonzero(v3[:, -1].view(np.int32) == 2)[0], 12] = \
        np.int32(leaf_row).view(np.float32)
    wide = np.zeros((len(v3), 6 * f + 16), np.float32)
    wide[:, :v3.shape[1] - 1] = v3[:, :-1]
    wide[:, -1] = v3[:, -1]
    for table, packed in ((v3, True), (wide, False)):
        a, b = tup(table, f, k, packed), jup(table, f, k, packed)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), packed


def test_geocache_v3_loads_upgraded(tmp_path, tiny_arrays):
    """A version-3 geocache loads in both packages, its table upgraded on
    the host as chroma_tpu/io/geocache.py:135 does, with no re-mesh: the
    two loads are equal bit for bit, and equal to the build."""
    import json
    _, ga_t = tiny_arrays
    path = str(tmp_path / 'tiny')
    tgeocache.save_geometry_arrays(path, ga_t)
    with open(path + '.json') as fh:
        meta = json.load(fh)
    with np.load(path + '.npz') as zf:
        arrays = {key: zf[key] for key in zf.files}
    rows = arrays['ga.wide.rows']
    arrays['ga.wide.rows'] = _rows_v3(rows, ga_t.wide.fanout,
                                      ga_t.wide.leaf_size, True)
    meta['__version__'] = 3
    np.savez(path + '.npz', **arrays)
    with open(path + '.json', 'w') as fh:
        json.dump(meta, fh)
    got, want = (pkg.load_geometry_arrays(path)
                 for pkg in (tgeocache, jgeocache))
    assert got is not None and want is not None
    assert got.wide.rows.numpy().tobytes() == \
        np.asarray(want.wide.rows).tobytes()
    assert got.wide.rows[:len(rows)].numpy().tobytes() == rows.tobytes()
    _assert_same(dataclasses.replace(got, wide=dataclasses.replace(
        got.wide, rows=got.wide.rows[:len(rows)])), ga_t, 'ga')


def test_has_detector_matches_jax(tiny_arrays):
    ga_j, ga_t = tiny_arrays
    assert ga_t.has_detector and ga_j.has_detector
    assert dataclasses.replace(ga_t, detector=None).has_detector is \
        dataclasses.replace(ga_j, detector=None).has_detector is False


# --------------------------------------------------------------------------
# device-resident sources, the facade, tracking
# --------------------------------------------------------------------------

def _bombs(sizes, seed):
    np.random.seed(seed)
    return [T.photon_bomb(k, 400.0, (0, 0, 0)) for k in sizes]


def _assert_events_equal(a, b):
    _assert_photons_equal(a.photons_end, b.photons_end)
    _assert_photons_equal(a.flat_hits, b.flat_hits)
    assert sorted(a.hits) == sorted(b.hits)
    for name in ('hit', 't', 'q', 'flags'):
        x, y = getattr(a.channels, name), getattr(b.channels, name)
        assert x.tobytes() == y.tobytes(), name


@pytest.mark.parametrize('source', ['states', 'events'])
def test_photon_state_sources(monkeypatch, source):
    """A batch of three events as device PhotonStates (or Events holding
    them) gives the events of the equal host Photons under one seed, with
    run_daq; no host Photons is built before propagation."""
    import chroma_tpu_torch.sim as tsim
    sizes = [300, 100, 200]
    det = _box_detector(T)
    opts = dict(keep_photons_end=True, run_daq=True, max_steps=100)
    host = list(chroma_tpu_torch.Simulation(det, seed=11, device='cpu')
                .simulate(iter(_bombs(sizes, 3)), **opts))
    states = [photon_state_from_host(b, 'cpu') for b in _bombs(sizes, 3)]
    if source == 'events':
        states = [T.event.Event(id=i, photons_beg=s)
                  for i, s in enumerate(states)]

    built = []
    init = T.event.Photons.__init__
    monkeypatch.setattr(T.event.Photons, '__init__', lambda self, *a, **k: (
        built.append(1), init(self, *a, **k))[1])
    at_propagate = []
    propagate = tsim.propagate
    monkeypatch.setattr(tsim, 'propagate', lambda *a, **k: (
        at_propagate.append(len(built)), propagate(*a, **k))[1])
    device = list(chroma_tpu_torch.Simulation(det, seed=11, device='cpu')
                  .simulate(iter(states), **opts))
    assert at_propagate == [0]
    assert len(device) == 3
    for i, (a, b) in enumerate(zip(device, host)):
        assert a.nphotons == sizes[i] and (a.flat_hits.evidx == i).all()
        _assert_events_equal(a, b)


def test_gpu_facade_matches_simulation():
    """GPUPhotons.propagate with get_rng_states(seed), get_flat_hits,
    select and GPUDaq give Simulation's photons, hits and channels for the
    same seed; join_states and ncopies stack states on the device."""
    det = _box_detector(T)
    (bomb,) = _bombs([2000], 5)
    ev = next(chroma_tpu_torch.Simulation(det, seed=21, device='cpu')
              .simulate([bomb], keep_photons_end=True, run_daq=True,
                        max_steps=100))
    context = gpu.create_cuda_context()
    gg = gpu.GPUDetector(det, device='cpu')
    rng = gpu.get_rng_states(len(bomb), seed=21)
    gp = gpu.GPUPhotons(photon_state_from_host(bomb, 'cpu'))
    gp.propagate(gg, rng, max_steps=100)
    _assert_photons_equal(gp.get(), ev.photons_end,
                          [f for f in PHOTON_FIELDS if f != 'channel'])
    _assert_photons_equal(gp.get_flat_hits(gg), ev.flat_hits)
    detected = gp.select(T.event.SURFACE_DETECT)
    pe = ev.photons_end
    _assert_photons_equal(
        detected, pe[(pe.flags & T.event.SURFACE_DETECT) != 0],
        [f for f in PHOTON_FIELDS if f != 'channel'])
    daq = gpu.GPUDaq(gg)
    daq.begin_acquire()
    daq.acquire(gp, rng)
    channels = daq.end_acquire().get()
    for name in ('hit', 't', 'q', 'flags'):
        a, b = getattr(channels, name), getattr(ev.channels, name)
        assert a.tobytes() == b.tobytes(), name
    context.pop()

    two = gpu.GPUPhotons(gp.state, ncopies=2)
    assert len(two) == 2 * len(bomb) and two.true_nphotons == len(bomb)
    joined = gpu.join_states([gp.state, gp.state])
    assert torch.equal(joined.pos, two.state.pos)


def test_gpu_select_matches_jax():
    "select on the same injected state: JAX's photons, in JAX's order."
    from chroma_tpu import gpu as jgpu
    rs = np.random.RandomState(6)
    n = 3000
    fields = dict(pos=rs.randn(n, 3), dir=rs.randn(n, 3),
                  pol=rs.randn(n, 3), wavelengths=rs.uniform(300, 600, n),
                  t=rs.uniform(0, 50, n),
                  last_hit_triangles=rs.randint(-1, 100, n),
                  flags=rs.choice([0, 1, 4, 8, 4 | 32, 1 << 31],
                                  n).astype(np.uint32),
                  weights=rs.uniform(size=n))
    jp = jgpu.GPUPhotons(J.event.Photons(**fields))
    tp = gpu.GPUPhotons(T.event.Photons(**fields), device='cpu')
    for flag in (T.event.SURFACE_DETECT, T.event.NAN_ABORT,
                 T.event.SURFACE_DETECT | T.event.BULK_ABSORB):
        a, b = jp.select(flag), tp.select(flag)
        assert len(b) > 0
        _assert_photons_equal(a, b)


def _mirror_box(h):
    """Water in a specular box (reflect_specular 1) with an absorbing cube
    inside and bulk lengths far beyond the box: every step's outcome is
    decided by geometry, none by a draw, so two random streams give the
    same histories."""
    water = h.Material('water')
    water.set('refractive_index', 1.33)
    water.set('absorption_length', 1e12)
    water.set('scattering_length', 1e12)
    mirror = h.Surface('mirror')
    mirror.set('reflect_specular', 1.0)
    black = h.Surface('black')
    black.set('absorb', 1.0)
    geo = h.Geometry(h.vacuum)
    geo.add_solid(h.Solid(h.box(1000.0, 1000.0, 1000.0), water, h.vacuum,
                          surface=mirror))
    geo.add_solid(h.Solid(h.box(300.0, 300.0, 300.0), water, water,
                          surface=black), displacement=(250.0, 0.0, 0.0))
    geo.flatten()
    return geo


def test_tracking_matches_jax(monkeypatch):
    """photon_tracking on 1,024 photons for 12 steps in the mirror box:
    JAX and the port give every photon the same number of track points
    (snapshots after each chunk, compactions included), equal flags, and
    positions to 1e-5 of the distance the photon has travelled (at least
    of the box's half-width): XLA's and torch's reflections differ by an
    ulp of the direction, and each bounce carries that over ~1 m, so
    position differences grow with the path, about 5e-4 mm a bounce."""
    from chroma_tpu.sim import Simulation as JaxSimulation
    n, steps = 1024, 12
    tracks, ends = [], []
    for h in (J, T):
        geo = _mirror_box(h)
        np.random.seed(2)
        bomb = h.photon_bomb(n, 400.0, (0, 0, 0))
        if h is J:
            sim = JaxSimulation(geo, seed=0, photon_tracking=True,
                                gpu_geometry=jtypes.build_geometry_arrays(
                                    geo))
        else:
            sim = chroma_tpu_torch.Simulation(geo, seed=0, device='cpu',
                                              photon_tracking=True)
        ev = next(sim.simulate([bomb], keep_photons_end=True,
                               max_steps=steps))
        tracks.append(ev.photon_tracks)
        ends.append(ev.photons_end)
    (jt, tt), (je, te) = tracks, ends
    assert len(jt) == len(tt) == n
    np.testing.assert_array_equal(je.flags, te.flags)
    absorbed = (te.flags & T.event.SURFACE_ABSORB) != 0
    assert 0.1 < absorbed.mean() < 0.9     # the batch was compacted
    lengths = np.array([len(t) for t in tt])
    np.testing.assert_array_equal(lengths, [len(t) for t in jt])
    assert lengths.max() >= 3 and lengths.max() <= steps
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(a.flags, b.flags)
        np.testing.assert_allclose(b.t, a.t, rtol=1e-5)
        path = np.maximum(a.t * (299.792458 / 1.33), 500.0)
        assert (np.abs(b.pos - a.pos) <= 1e-5 * path[:, None]).all()
    last = np.array([t.pos[-1] for t in tt])
    np.testing.assert_array_equal(last, te.pos)


# --------------------------------------------------------------------------
# the ZeroMQ services
# --------------------------------------------------------------------------

def _serve_one(server):
    "Serve one request on a thread; returns the thread."
    thread = threading.Thread(target=server.serve_forever,
                              kwargs=dict(max_requests=1), daemon=True)
    thread.start()
    return thread


def _endpoint(server):
    import zmq
    return server.socket.getsockopt(zmq.LAST_ENDPOINT).decode()


def _bounded(sock):
    "A client socket whose receive gives up after 5 minutes, never hangs."
    import zmq
    sock.setsockopt(zmq.RCVTIMEO, 300000)
    return sock


def _rat_request(photons, eventid):
    msg = np.asarray([len(photons), eventid], dtype=np.uint32).tobytes()
    for col in (photons.pos.T, photons.dir.T, photons.pol.T):
        msg += np.ascontiguousarray(col, dtype=np.float64).tobytes()
    for col in (photons.wavelengths, photons.t):
        msg += np.ascontiguousarray(col, dtype=np.float64).tobytes()
    return msg + np.arange(len(photons), dtype=np.uint32).tobytes()


def test_servers_loopback():
    """PhotonServer/PhotonClient and RatServer over tcp://127.0.0.1 on a
    port the system picks: the server's reply is what the port's
    Simulation with the same seed gives."""
    pytest.importorskip('zmq')
    import zmq
    from chroma_tpu_torch.server import PhotonServer, PhotonClient, RatServer
    det = _box_detector(T)
    (bomb,) = _bombs([500], 8)
    ref = next(chroma_tpu_torch.Simulation(det, seed=1, device='cpu')
               .simulate(bomb, keep_photons_end=True)).photons_end

    server = PhotonServer('tcp://127.0.0.1:*', det, seed=1, device='cpu')
    thread = _serve_one(server)
    client = PhotonClient(_endpoint(server))
    _bounded(client.socket)
    result = client.propagate(bomb)
    thread.join(timeout=120)
    assert not thread.is_alive()
    client.close()
    server.close()
    _assert_photons_equal(result, ref)

    rat = RatServer('tcp://127.0.0.1:*', det, seed=1, device='cpu')
    thread = _serve_one(rat)
    ctx = zmq.Context()
    sock = _bounded(ctx.socket(zmq.REQ))
    sock.connect(_endpoint(rat))
    sock.send(_rat_request(bomb, 9))
    reply = sock.recv()
    thread.join(timeout=120)
    assert not thread.is_alive()
    sock.close(0)
    ctx.term()
    rat.close()
    nhits, eventid = np.frombuffer(reply[:8], dtype=np.uint32)
    assert eventid == 9 and 0 < nhits < len(bomb)
    assert len(reply) == 8 + int(nhits) * (11 * 4 + 2 * 4)


# --------------------------------------------------------------------------
# the command-line tools
# --------------------------------------------------------------------------

@pytest.fixture
def cli_cache(tmp_path, monkeypatch):
    """The port's default cache directory, under tmp_path for the test;
    the profiler off, with its records cleared, before and after."""
    cache_dir = str(tmp_path / 'cache')
    monkeypatch.setattr(tcache.Cache.__init__, '__defaults__', (cache_dir,))
    monkeypatch.setattr(profiler, 'enabled', False)
    profiler.reset()
    yield cache_dir
    profiler.reset()


def test_cli_sim(tmp_path, cli_cache, capsys):
    from chroma_tpu_torch.cli import sim
    out = str(tmp_path / 'out.chroma')
    sim.main(['@chroma_tpu_torch.demo.tiny', out, '-n', '2', '-p', '1000',
              '--daq', '--seed', '3', '--device', 'cpu'])
    assert '2 events in' in capsys.readouterr().err
    for reader in (TReader, JReader):      # the file reads in both
        events = list(reader(out))
        assert len(events) == 2
        for ev in events:
            assert ev.channels is not None and ev.channels.hit.any()
            assert len(ev.flat_hits) > 0 and ev.photons_end is None


def test_cli_geo(tmp_path, cli_cache, capsys):
    from chroma_tpu_torch.cli import geo
    stl = tmp_path / 'cube.stl'
    _write_stl(stl, T.box(10.0, 10.0, 10.0), binary=True)
    geo.main(['save', str(stl), 'cube'])
    geo.main(['save', '@chroma_tpu_torch.demo.tiny'])
    assert "cached geometry as 'chroma_tpu_torch_demo_tiny'" in \
        capsys.readouterr().out
    geo.main(['default', 'cube'])
    geo.main(['list'])
    assert capsys.readouterr().out.split() == [
        '.default', 'chroma_tpu_torch_demo_tiny', 'cube']
    geo.main(['remove', 'chroma_tpu_torch_demo_tiny'])
    loaded = tloader.load_geometry_from_string('', cache_dir=cli_cache)
    assert len(loaded.mesh.triangles) == len(T.box(10.0, 10.0,
                                                   10.0).triangles)
    assert loaded.bvh is not None
    assert sorted(tcache.Cache().list_geometry()) == ['.default', 'cube']


def test_cli_profile(tmp_path, cli_cache, monkeypatch):
    from chroma_tpu_torch.cli import profile
    # the chunked driver's regions and counters (the fused route's are in
    # test_torch_fused.py::test_cli_profile_fused_regions)
    monkeypatch.setenv('CHROMA_FUSED', '0')
    buf = io.StringIO()
    with redirect_stdout(buf):
        profile.main(['@chroma_tpu_torch.demo.tiny', '-p', '1000', '-n', '2',
                      '--daq', '--visits', '--trace', str(tmp_path / 'trace'),
                      '--device', 'cpu'])
    text = buf.getvalue()
    for needle in ('propagate.chunk[n=1000]', 'sim.daq', 'event.total',
                   'propagate.steps', 'propagate.lane_steps', 'sim.event',
                   'by node kind', 'photons/s', 'lane-steps/photon'):
        assert needle in text, needle
    assert (tmp_path / 'trace' / 'trace.json').stat().st_size > 0


@pytest.mark.parametrize('tool', ['server', 'server_rat'])
def test_cli_servers(monkeypatch, cli_cache, tool):
    """The server tools on demo.tiny(): each binds, answers one request
    and is closed (serve_forever is limited to one request here)."""
    pytest.importorskip('zmq')
    import zmq
    from importlib import import_module
    from chroma_tpu_torch import server as tserver
    cls = tserver.PhotonServer if tool == 'server' else tserver.RatServer
    bound = queue.Queue()
    serve = cls.serve_forever

    def serve_one(self):
        bound.put(_endpoint(self))
        serve(self, max_requests=1)
        # close with a linger, unlike close()'s 0: the reply may still be
        # queued in zmq's I/O thread, and dropping it would leave the
        # client waiting
        self.socket.close(linger=60000)
        self.context.term()
    monkeypatch.setattr(cls, 'serve_forever', serve_one)
    main = import_module('chroma_tpu_torch.cli.' + tool).main
    thread = threading.Thread(target=main, args=([
        '@chroma_tpu_torch.demo.tiny', '--address', 'tcp://127.0.0.1:*',
        '--device', 'cpu'],), daemon=True)
    thread.start()
    address = bound.get(timeout=300)
    (bomb,) = _bombs([1000], 4)
    if tool == 'server':
        from chroma_tpu_torch.server import PhotonClient
        client = PhotonClient(address)
        _bounded(client.socket)
        result = client.propagate(bomb)
        client.close()
        assert len(result) == len(bomb)
        assert ((result.flags & T.event.TERMINAL_FLAGS) != 0).all()
    else:
        ctx = zmq.Context()
        sock = _bounded(ctx.socket(zmq.REQ))
        sock.connect(address)
        sock.send(_rat_request(bomb, 5))
        reply = sock.recv()
        sock.close(0)
        ctx.term()
        assert np.frombuffer(reply[4:8], dtype=np.uint32)[0] == 5
    thread.join(timeout=120)
    assert not thread.is_alive()
