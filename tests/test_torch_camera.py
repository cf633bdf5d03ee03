"""The torch port's camera, viewer modes and viewer tools, on the CPU.

First the cases of tests/test_render.py::test_snapshot and of
tests/test_viewer_features.py, run on the port. Then the port against the
JAX package, each side building its scene from its own package:
CameraPose (rays, project, orbit) bit for bit; `snapshot` and
`snapshot_anaglyph` with at least 99.9% of the pixels equal and every
channel within 1 count; `bvh_layer_geometry`, `color_solids` and
`EventViewer.event_colors` bit for bit; the demo meshes of `models` bit for
bit. `save_png` is read back with matplotlib; `cli.cam -o` and `cli.bvh`
run in process with the CPU; the viewer's frame modes run through
`Camera._frame` with no display, and the interactive loop once in a spawned
process on SDL's dummy video backend.

The scenes compared with JAX are turned out of the camera's symmetry
planes: seen head-on, rays run along the diagonals of a box's faces, where
two triangles tie to the ulp."""
import functools
import io
import os
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from chroma_tpu import camera as jcamera, loader as jloader
from chroma_tpu import models as jmodels
from chroma_tpu_torch import cache as tcache, camera, loader as tloader
from chroma_tpu_torch import models as tmodels
from chroma_tpu_torch.camera import (CameraPose, EventSource, EventViewer,
                                     Camera, draw_tracks,
                                     bvh_layer_geometry, snapshot,
                                     snapshot_anaglyph, save_png,
                                     _scene_pose)
from chroma_tpu_torch.ops import render
from chroma_tpu_torch.ops import types as ttypes

from test_torch_host import (J, T, fresh_perf_cache,  # noqa: F401
                             same_native_kit)

torch.set_num_threads(2)

LOADER = {id(J): jloader, id(T): tloader}
CAMERA = {id(J): jcamera, id(T): camera}


def box_geometry(h):
    "The geometry of tests/test_viewer_features.py, from host namespace h."
    geo = h.Geometry(h.optics.water)
    geo.add_solid(h.Solid(h.box(100.0, 100.0, 100.0), h.optics.glass,
                          h.optics.water, color=0xFF3366))
    return LOADER[id(h)].create_geometry_from_obj(geo, update_bvh_cache=False)


def turned_scene(h):
    """A semi-transparent box, turned out of the camera's axes, with a
    sphere inside and a second box beside it."""
    geo = h.Geometry(h.optics.water)
    rot = h.make_rotation_matrix(0.4, (1.0, 2.0, 3.0))
    geo.add_solid(h.Solid(h.box(100.0, 80.0, 60.0), h.optics.glass,
                          h.optics.water, color=0x80FF3366), rotation=rot)
    geo.add_solid(h.Solid(h.sphere(20.0, 12), h.optics.glass,
                          h.optics.water, color=0x4000FF40),
                  displacement=(3.0, -2.0, 5.0))
    geo.add_solid(h.Solid(h.box(30.0, 30.0, 30.0), h.optics.glass,
                          h.optics.water, color=0x002060FF), rotation=rot,
                  displacement=(90.0, 20.0, -35.0))
    return LOADER[id(h)].create_geometry_from_obj(geo, update_bvh_cache=False)


@pytest.fixture(scope='module')
def geometry():
    return box_geometry(T)


@pytest.fixture(scope='module')
def turned():
    return turned_scene(J), turned_scene(T)


def assert_images_match(want, got, min_equal=0.999):
    assert want.shape == got.shape and got.dtype == np.uint8
    differ = (want != got).any(axis=-1)
    for y, x in np.argwhere(differ)[:20]:
        print('pixel (%d, %d) differs: jax %s torch %s'
              % (y, x, want[y, x], got[y, x]))
    assert 1.0 - differ.mean() >= min_equal, '%d pixels differ' % differ.sum()
    assert np.abs(want.astype(int) - got.astype(int)).max() <= 1


# --- tests/test_render.py::test_snapshot and tests/test_viewer_features.py
# --- on the port -----------------------------------------------------------

def test_snapshot():
    geo = T.Geometry()
    geo.add_solid(T.Solid(T.cube(2.0), T.vacuum, T.vacuum,
                          color=0x80FF0000))
    geo = tloader.create_geometry_from_obj(geo, update_bvh_cache=False)
    img = snapshot(geo, size=(64, 48), device='cpu')
    assert img.shape == (48, 64, 3)
    assert img.dtype == np.uint8
    # the cube should occupy some of the frame with non-background pixels
    assert (img != img[0, 0]).any()


def test_projection_inverts_rays(geometry):
    "Projecting a point along a film ray lands on that ray's pixel."
    pose, scale, center = _scene_pose(geometry)
    size = (64, 48)
    rays = pose.rays(size, device='cpu')
    pos = rays.pos.numpy()
    dirs = rays.dir.numpy()
    pick = [0, 1000, 2345, size[0] * size[1] - 1]
    pts = pos[pick] + 500.0 * dirs[pick]
    px, py, vis = pose.project(pts, size)
    assert vis.all()
    for n, p in enumerate(pick):
        assert abs(px[n] - p // size[1]) < 1.0
        assert abs(py[n] - p % size[1]) < 1.0


def test_draw_tracks_marks_pixels(geometry):
    pose, scale, center = _scene_pose(geometry)
    size = (64, 48)
    image = np.zeros((size[1], size[0], 3), np.uint8)
    track = T.event.Photons(pos=np.array([center, center + [30.0, 0, 0]]),
                            dir=np.tile([0.0, 0, 1], (2, 1)),
                            pol=np.tile([1.0, 0, 0], (2, 1)),
                            wavelengths=np.array([450.0, 550.0]),
                            t=np.zeros(2))
    out = draw_tracks(image, [track], pose, size)
    assert (out > 0).any()
    # the JAX package's draw_tracks marks the same pixels
    jpose, _, _ = jcamera._scene_pose(box_geometry(J))
    want = jcamera.draw_tracks(np.zeros_like(image), [track], jpose, size)
    assert want.tobytes() == out.tobytes()


def test_bvh_layer_geometry(geometry):
    layer_geo = bvh_layer_geometry(geometry, 1)
    per_box = len(T.box(1.0, 1.0, 1.0).triangles)
    n_layer = len(geometry.bvh.get_layer(1))
    assert len(layer_geo.mesh.triangles) == per_box * n_layer
    # layer boxes cover the original geometry's extent
    lo, hi = layer_geo.mesh.get_bounds()
    glo, ghi = geometry.mesh.get_bounds()
    assert (lo <= glo + 1.0).all() and (hi >= ghi - 1.0).all()
    img = snapshot(layer_geo, size=(48, 32), device='cpu')
    assert img.shape == (32, 48, 3)


def test_anaglyph_differs_between_channels(geometry):
    img = snapshot_anaglyph(geometry, size=(48, 32), device='cpu')
    assert img.shape == (32, 48, 3)
    mono = snapshot(geometry, size=(48, 32), device='cpu')
    # left/right eyes see slightly different reds
    assert (img[..., 0] != mono[..., 0]).any()


def test_event_source_streams():
    def gen():
        for i in range(5):
            yield 'ev%d' % i

    src = EventSource(gen())
    assert src.current() == 'ev0'
    assert src.next() == 'ev1'
    assert src.jump(3) == 'ev3'
    assert src.prev() == 'ev2'
    # walking past the end stays on the last event
    for _ in range(10):
        last = src.next()
    assert last == 'ev4'
    # list input still works
    src2 = EventSource(['a', 'b'])
    assert src2.current() == 'a' and src2.next() == 'b'
    assert src2.next() == 'b'


def test_event_source_pickles_a_lazy_stream():
    "A viewer started as a process reads a lazy stream to its end."
    import pickle
    src = EventSource(iter(['a', 'b', 'c']))
    assert src.next() == 'b'
    copy = pickle.loads(pickle.dumps(src))
    assert copy.current() == 'b' and copy.next() == 'c'
    assert copy.next() == 'c' and src.current() == 'b'


# --- the port against the JAX package ---------------------------------------

def test_camera_pose_matches_jax(turned):
    gj, gt = turned
    (pj, sj, cj), (pt, st, ct) = jcamera._scene_pose(gj), _scene_pose(gt)
    assert sj == st and cj.tobytes() == ct.tobytes()
    size = (40, 30)
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(200, 3)) * 80.0
    for pose in (pj, pt):
        pose.orbit(0.3, np.array([0.0, 0.0, 1.0]), cj)
        pose.translate(np.array([5.0, -7.0, 2.0]))
    for name in ('position', 'axis1', 'axis2', 'forward'):
        assert getattr(pj, name).tobytes() == getattr(pt, name).tobytes()
    for shift in (0.0, 1.5):
        rj, rt = pj.rays(size, shift), pt.rays(size, shift, device='cpu')
        assert rt.pos.dtype == torch.float32 and rt.pos.shape == (1200, 3)
        assert np.asarray(rj.pos).tobytes() == rt.pos.numpy().tobytes()
        assert np.asarray(rj.dir).tobytes() == rt.dir.numpy().tobytes()
    for a, b in zip(pj.project(pts, size), pt.project(pts, size)):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize('alpha_depth', [1, 4])
def test_snapshot_matches_jax(turned, alpha_depth):
    gj, gt = turned
    want = jcamera.snapshot(gj, size=(48, 32), alpha_depth=alpha_depth)
    got = snapshot(gt, size=(48, 32), alpha_depth=alpha_depth, device='cpu')
    assert (got != 255).any(axis=-1).mean() > 0.05
    assert_images_match(want, got)
    # prebuilt arrays and an explicit position and background
    pos = _scene_pose(gt)[0].position + np.array([40.0, 10.0, 25.0])
    want = jcamera.snapshot(gj, size=(48, 32), alpha_depth=alpha_depth,
                            position=pos, bg_color=0xFF203040)
    got = snapshot(gt, size=(48, 32), alpha_depth=alpha_depth,
                   position=pos, bg_color=0xFF203040, device='cpu',
                   geometry_arrays=ttypes.build_geometry_arrays(gt))
    assert (got[0, 0] == (0x20, 0x30, 0x40)).all()
    assert_images_match(want, got)


def test_snapshot_anaglyph_matches_jax(turned):
    gj, gt = turned
    want = jcamera.snapshot_anaglyph(gj, size=(48, 32), alpha_depth=3)
    got = snapshot_anaglyph(gt, size=(48, 32), alpha_depth=3, device='cpu')
    assert_images_match(want, got)
    mono = snapshot(gt, size=(48, 32), alpha_depth=3, device='cpu')
    assert (got[..., 0] != mono[..., 0]).any()


def test_bvh_layer_geometry_matches_jax(turned):
    gj, gt = turned
    for layer in (0, 1, gt.bvh.layer_count() - 1):
        lj = jcamera.bvh_layer_geometry(gj, layer)
        lt = bvh_layer_geometry(gt, layer)
        for name in ('vertices', 'triangles'):
            a, b = getattr(lj.mesh, name), getattr(lt.mesh, name)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
        assert lj.colors.tobytes() == lt.colors.tobytes()
        assert (lt.colors == 0xDD00AAFF).all()


def pmt_detector(h):
    "Four box PMTs (channels 0-3) and a matte block, in water."
    pc = h.Surface('pc')
    pc.set('detect', 0.5)
    pc.set('absorb', 0.5)
    det = h.Detector(h.optics.water)
    for k in range(4):
        det.add_pmt(h.Solid(h.box(40.0, 40.0, 40.0), h.optics.glass,
                            h.optics.water, surface=pc, color=0x00808080),
                    displacement=(-150.0 + 100.0 * k, 0.0, 10.0 * k))
    matte = h.Surface('matte')
    matte.set('reflect_diffuse', 0.8)
    matte.set('absorb', 0.2)
    det.add_solid(h.Solid(h.box(30.0, 30.0, 30.0), h.optics.glass,
                          h.optics.water, surface=matte, color=0x00FFFF00),
                  displacement=(0.0, 0.0, 120.0))
    det.set_time_dist_gaussian(1.2, -6.0, 6.0)
    det.set_charge_dist_gaussian(1.0, 0.1, 0.5, 1.5)
    return LOADER[id(h)].create_geometry_from_obj(det, update_bvh_cache=False)


def _event(h, hit, t, q):
    return h.event.Event(channels=h.event.Channels(
        np.array(hit), np.array(t, np.float32), np.array(q, np.float32)))


@pytest.mark.parametrize('mode', ['charge', 'time'])
def test_event_colors_match_jax(mode):
    colors = []
    for h in (J, T):
        det = pmt_detector(h)
        ev = _event(h, [True, False, True, True], [3.0, 0.0, 7.5, 5.0],
                    [1.0, 0.0, 2.5, 0.7])
        viewer = CAMERA[id(h)].EventViewer(det, [ev], mode=mode)
        colors.append((np.asarray(viewer.event_colors(ev)),
                       np.asarray(viewer.event_colors(None)), det))
        # color_solids itself, on a mask of its own
        solid_hit = np.array([False, True, False, False, True])
        solid_colors = np.arange(5, dtype=np.uint32) * 0x010101
        colors[-1] += (CAMERA[id(h)].color_solids(det, solid_hit,
                                                  solid_colors),)
    (cj, nj, dj, sj), (ct, nt, dt, st) = colors
    assert cj.dtype == ct.dtype and cj.tobytes() == ct.tobytes()
    assert nj.tobytes() == nt.tobytes() == dt.colors.tobytes()
    assert sj.tobytes() == st.tobytes()
    # the hit PMTs' triangles change color, the others keep theirs
    solid_of = dt.channel_index_to_solid_id
    for ch, was_hit in enumerate([True, False, True, True]):
        tris = dt.solid_id == solid_of[ch]
        assert (ct[tris] != dt.colors[tris]).all() == was_hit
        assert (ct[tris] == dt.colors[tris]).all() == (not was_hit)
    block = dt.solid_id == 4
    assert (ct[block] == dt.colors[block]).all()
    assert (st[dt.solid_id == 1] == 0x010101).all()


# --- the viewer's frame modes, no display ------------------------------------

def test_viewer_frame_modes(monkeypatch):
    """Camera._frame in its mono, stereo and photon-map modes, and an
    EventViewer's recolored frame and track overlay."""
    det = pmt_detector(T)
    size = (48, 32)
    monkeypatch.setattr(camera, 'hybrid_render', functools.partial(
        render.hybrid_render, nphotons=2000, nbatches=1))
    cam = Camera(det, size=size, alpha_depth=4, device='cpu')
    ga = cam._geometry_arrays()
    pose, scale, center = _scene_pose(det)
    cam._scale = scale
    mono = cam._frame(ga, pose, False, False, (0, 0))
    assert mono.shape == (32, 48, 3) and mono.dtype == np.uint8
    assert mono.tobytes() == snapshot(det, size=size, alpha_depth=4,
                                      device='cpu').tobytes()
    stereo = cam._frame(ga, pose, True, False, (0, 0))
    assert stereo.tobytes() == snapshot_anaglyph(
        det, size=size, alpha_depth=4, device='cpu').tobytes()
    assert (stereo[..., 0] != mono[..., 0]).any()
    hybrid = cam._frame(ga, pose, False, True, (0, 0))
    assert hybrid.shape == mono.shape and hybrid.any()
    assert hybrid.tobytes() == cam._frame(ga, pose, False, True,
                                          (0, 0)).tobytes()
    assert hybrid.tobytes() != cam._frame(ga, pose, False, True,
                                          (0, 1)).tobytes()
    assert cam._overlay(mono, pose) is mono

    track = T.event.Photons(pos=np.array([center, center + [30.0, 0, 0]]),
                            dir=np.tile([0.0, 0, 1], (2, 1)),
                            pol=np.tile([1.0, 0, 0], (2, 1)),
                            wavelengths=np.array([450.0, 550.0]),
                            t=np.zeros(2))
    ev = _event(T, [True, False, False, True], [3.0, 0.0, 0.0, 5.0],
                [1.0, 0.0, 0.0, 0.7])
    ev.photon_tracks = [track]
    viewer = EventViewer(det, [T.event.Event(), ev], size=size,
                         alpha_depth=4, show_tracks=True, device='cpu')
    base = viewer._geometry_arrays()
    assert torch.equal(base.colors, ga.colors)    # no channels yet
    plain = viewer._frame(base, pose, False, False, (0, 0))
    assert plain.tobytes() == mono.tobytes()
    viewer.source.next()
    recolored = viewer._recolored()
    assert recolored.colors.dtype == torch.int32
    assert recolored.colors.device == base.colors.device
    assert recolored.colors.numpy().view(np.uint32).tobytes() == \
        viewer.event_colors(ev).astype(np.uint32).tobytes()
    assert recolored.wide is base.wide
    frame = viewer._frame(recolored, pose, False, False, (0, 0))
    changed = (frame != plain).any(axis=-1)
    assert changed.any() and not changed.all()
    # only pixels that showed a hit PMT changed: the outer PMTs lie in the
    # left and right quarters of the frame
    assert not changed[:, 16:32].any()
    with_tracks = viewer._overlay(frame.copy(), pose)
    assert (with_tracks != frame).any()
    viewer.show_tracks = False
    assert (viewer._overlay(frame.copy(), pose) == frame).all()


def test_viewer_needs_a_card_unless_cpu(geometry, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        snapshot(geometry, size=(8, 6))
    with pytest.raises(RuntimeError, match='CUDA'):
        snapshot_anaglyph(geometry, size=(8, 6))
    with pytest.raises(RuntimeError, match='CUDA'):
        Camera(geometry)._geometry_arrays()
    with pytest.raises(RuntimeError, match='CUDA'):
        CameraPose((0, 0, 0)).rays((8, 6))


def test_camera_process_draws_frames(geometry, tmp_path, monkeypatch):
    """The interactive loop in its spawned process, on SDL's dummy video
    backend: it builds its arrays there, draws the first frame (written as a
    movie frame) and ends when asked."""
    pytest.importorskip('pygame')
    monkeypatch.setenv('SDL_VIDEODRIVER', 'dummy')
    movie = tmp_path / 'movie'
    movie.mkdir()
    cam = Camera(geometry, size=(48, 32), alpha_depth=3,
                 movie_dir=str(movie), device='cpu')
    cam.start()
    try:
        frame = movie / 'frame000000.png'
        deadline = time.time() + 240
        while not frame.exists() and cam.is_alive() \
                and time.time() < deadline:
            time.sleep(0.2)
        assert frame.exists(), 'no frame (exit code %r)' % cam.exitcode
    finally:
        cam.stop()
        cam.join(60)
        if cam.is_alive():
            cam.kill()
    assert cam.exitcode == 0
    from matplotlib.pyplot import imread
    time.sleep(0.2)
    got = np.round(imread(str(frame))[..., :3] * 255).astype(np.uint8)
    want = snapshot(geometry, size=(48, 32), alpha_depth=3, device='cpu')
    assert got.tobytes() == want.tobytes()


# --- files and tools ---------------------------------------------------------

def test_save_png_reads_back(tmp_path):
    from matplotlib.pyplot import imread
    rng = np.random.default_rng(6)
    for shape in ((32, 48, 3), (1, 1, 3), (7, 301, 3)):
        image = rng.integers(0, 256, shape, dtype=np.uint8)
        path = str(tmp_path / ('img%d.png' % shape[1]))
        save_png(path, image)
        back = imread(path)
        assert back.shape == shape
        assert (np.round(back * 255).astype(np.uint8) == image).all()
    with open(path, 'rb') as fh:
        assert fh.read(8) == b'\x89PNG\r\n\x1a\n'


MODELS = ['companioncube', 'liberty', 'lionsolid', 'MiniFig',
          'tie_interceptor6', 'icosahedron', 'ball', 'donut']


@pytest.mark.parametrize('name', MODELS)
def test_models_match_jax(name):
    mj, mt = getattr(jmodels, name)(), getattr(tmodels, name)()
    assert type(mt).__module__ == 'chroma_tpu_torch.geometry'
    assert len(mt.triangles) > 50
    for field in ('vertices', 'triangles'):
        a, b = getattr(mj, field), getattr(mt, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field


def test_models_load_as_geometry_strings():
    assert sorted(n for n in dir(tmodels) if not n.startswith('_')
                  and callable(getattr(tmodels, n)) and n != 'Loader') \
        == sorted(MODELS)
    geo = tloader.load_geometry_from_string(
        '@chroma_tpu_torch.models.tie_interceptor6', update_bvh_cache=False)
    assert len(geo.mesh.triangles) == len(tmodels.tie_interceptor6().triangles)
    assert os.path.dirname(tmodels.liberty.filename) == \
        os.path.dirname(tmodels.__file__)


@pytest.fixture
def cli_cache(tmp_path, monkeypatch):
    "The port's default cache directory, under tmp_path for the test."
    cache_dir = str(tmp_path / 'cache')
    monkeypatch.setattr(tcache.Cache.__init__, '__defaults__', (cache_dir,))
    return cache_dir


def test_cli_cam_writes_a_snapshot(tmp_path, cli_cache, capsys, monkeypatch):
    from matplotlib.pyplot import imread
    from chroma_tpu_torch.cli import cam
    out = str(tmp_path / 'donut.png')
    cam.main(['@chroma_tpu_torch.models.donut', '--size', '48', '32', '-o',
              out, '--alpha-depth', '3', '--device', 'cpu'])
    assert 'wrote %s' % out in capsys.readouterr().out
    geo = tloader.load_geometry_from_string('@chroma_tpu_torch.models.donut')
    want = snapshot(geo, size=(48, 32), alpha_depth=3, device='cpu')
    got = np.round(imread(out)[..., :3] * 255).astype(np.uint8)
    assert got.tobytes() == want.tobytes() and (got != 255).any()
    # the default device is the card, and its absence an error
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        cam.main(['@chroma_tpu_torch.models.donut', '-o', out])


def test_cli_bvh(cli_cache):
    from chroma_tpu_torch.cli import bvh

    def run(*argv):
        buf = io.StringIO()
        with redirect_stdout(buf):
            bvh.main(list(argv))
        return buf.getvalue()

    geo = '@chroma_tpu_torch.models.icosahedron'
    mesh_hash = tloader.load_geometry_from_string(
        geo, auto_build_bvh=False).mesh.md5()
    assert 'BVH built in' in run('create', geo, 'mine', '--degree', '2')
    assert run('list', geo).split() == ['mine']
    stat = run('stat', geo, 'mine')
    assert 'nodes:' in stat and 'layer  0:' in stat
    before = tcache.Cache().load_bvh(mesh_hash, 'mine')
    assert 'Sorting BVH nodes by area' in run('sort', geo, 'mine')
    after = tcache.Cache().load_bvh(mesh_hash, 'mine')
    assert len(after.nodes) == len(before.nodes)
    layers = after.layer_count()
    assert layers >= 3
    out = run('optimize', geo, str(layers - 2), 'mine', '--sweeps', '1')
    assert 'parent area' in out
    assert 'Can only optimize' in run('optimize', geo, '0', 'mine')
    run('remove', geo, 'mine')
    assert run('list', geo).split() == []
    with pytest.raises(SystemExit):
        run('frobnicate', geo)


def test_setup_lists_the_new_data():
    "setup.py ships the port's meshes, color table and kernel sources."
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, 'setup.py')) as fh:
        text = fh.read()
    for needle in ("'chroma_tpu_torch.models': ['*.stl', '*.stl.bz2']",
                   "'chroma_tpu_torch.color': ['*.csv']"):
        assert needle in text, needle
