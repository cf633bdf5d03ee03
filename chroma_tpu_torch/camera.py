"""Geometry/event viewer (counterpart of chroma_tpu.camera; reference:
chroma/camera.py).

Two modes:
  * headless snapshots — render(geometry) to a numpy image / PNG, usable
    anywhere (tests, notebooks, servers); includes anaglyph stereo,
    BVH-layer views and photon-track overlays;
  * interactive pygame viewer — orbit/zoom/pan with the same bindings as
    the reference (mouse drag rotates, wheel zooms), run inline or as a
    separate process like the reference Camera.

Viewer keys (reference: camera.py:246-282, 475-488, 882-928):
  ESC/Q quit · F5 hybrid (photon-map) render toggle · F6 screenshot ·
  M movie capture toggle · 3 anaglyph stereo toggle · B/N cycle BVH layer
  display · EventViewer adds PAGEUP/PAGEDOWN event nav, C/T charge/time
  coloring, P photon-track overlay.

Both paths share the device ray tracer (chroma_tpu_torch.ops.render),
which is the same wide-BVH traversal the simulation uses: the CUDA visit
kernel on a card. Rays, snapshots and viewers take a `device` (default
'cuda'; 'cpu' runs the plain traversal) and raise when a card is asked for
and none is present. The interactive viewer starts its process by spawn,
since a forked child of a parent that has touched CUDA cannot use the card;
PNGs are written with the standard library, so a headless snapshot needs
neither pygame nor matplotlib.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import struct
import time
import zlib

import numpy as np
import torch

from chroma_tpu_torch.color import map_to_color, map_wavelength
from chroma_tpu_torch.ops.render import (hybrid_render, pixels_to_host,
                                         render)
from chroma_tpu_torch.ops.transform import (rotate_around_point,
                                            rotate_points, translate_points)
from chroma_tpu_torch.ops.types import build_geometry_arrays
from chroma_tpu_torch.profiler import profiler
from chroma_tpu_torch.tools import from_film

FILM_WIDTH = 35.0
FOCAL_LENGTH = 18.0

_spawn = multiprocessing.get_context('spawn')


def _device(device):
    "torch.device(device); RuntimeError for a CUDA device with no card."
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('device %r requested but CUDA is not available'
                           % str(device))
    return device


class Rays(object):
    """A bundle of rays on `device` with rigid-motion updates
    (replaces GPURays, reference: chroma/gpu/render.py)."""

    def __init__(self, pos, dir, device='cuda'):
        self.device = _device(device)
        self.pos = self._f32(pos)
        self.dir = self._f32(dir)

    def _f32(self, a):
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a, dtype=np.float32)
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def rotate(self, phi, n):
        self.pos = rotate_points(self.pos, phi, n)
        self.dir = rotate_points(self.dir, phi, n)

    def rotate_around_point(self, phi, n, point):
        self.pos = rotate_around_point(self.pos, phi, n, point)
        self.dir = rotate_points(self.dir, phi, n)

    def translate(self, v):
        self.pos = translate_points(self.pos, v)

    def render(self, geometry_arrays, alpha_depth=10, bg_color=0xFFFFFFFF):
        """(N,) int32 ARGB pixels (u32 bit patterns) on the rays' device;
        `geometry_arrays` must lie there too."""
        return render(self.pos, self.dir, geometry_arrays,
                      alpha_depth=alpha_depth, bg_color=bg_color)


class CameraPose(object):
    """Explicit camera pose: position + film basis (axis1 vertical, axis2
    horizontal). Owning the pose (rather than only per-pixel rays) makes
    world->pixel projection possible, which the photon-track overlay
    needs."""

    def __init__(self, position, axis1=(0.0, 0.0, 1.0),
                 axis2=(1.0, 0.0, 0.0)):
        self.position = np.asarray(position, dtype=np.float64).copy()
        self.axis1 = np.asarray(axis1, dtype=np.float64).copy()
        self.axis2 = np.asarray(axis2, dtype=np.float64).copy()

    @property
    def forward(self):
        "Viewing direction (into the scene)."
        return np.cross(self.axis1, self.axis2)

    def translate(self, v):
        self.position = self.position + v

    def orbit(self, phi, n, center):
        from chroma_tpu_torch.transform import make_rotation_matrix
        rot = make_rotation_matrix(phi, n)
        self.position = rot @ (self.position - center) + center
        self.axis1 = rot @ self.axis1
        self.axis2 = rot @ self.axis2

    def rays(self, size, eye_shift=0.0, device='cuda'):
        "Per-pixel ray bundle for this pose (optionally shifted for stereo)."
        with profiler.region('camera.rays'):
            pos = self.position + eye_shift * self.axis2
            origins, directions = from_film(pos, axis1=self.axis1,
                                            axis2=self.axis2, size=size,
                                            width=FILM_WIDTH,
                                            focal_length=FOCAL_LENGTH)
            return Rays(origins, directions, device)

    def project(self, points, size):
        """Project world points to pixel coordinates. Returns
        (px (N,), py (N,), visible (N,) bool). Inverse of the from_film
        ray construction (chroma_tpu_torch.tools.from_film)."""
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        height = FILM_WIDTH * (size[1] / float(size[0]))
        dx0 = FILM_WIDTH / size[0]
        dx1 = height / size[1]
        r = points - self.position
        a1 = r @ self.axis1
        a2 = r @ self.axis2
        d = r @ self.forward
        safe = np.where(d > 1e-9, d, 1.0)
        px = (a2 * FOCAL_LENGTH / safe + FILM_WIDTH / 2.0) / dx0
        py = (height / 2.0 - a1 * FOCAL_LENGTH / safe) / dx1
        visible = ((d > 1e-9) & (px >= -0.5) & (px < size[0] - 0.5)
                   & (py >= -0.5) & (py < size[1] - 0.5))
        return px, py, visible


def _pixels_to_image(pixels, size):
    """ARGB pixels (N,), a device tensor of int32 bit patterns or a host
    uint32 array -> (height, width, 3) uint8 RGB image."""
    with profiler.region('camera.pixels'):
        if isinstance(pixels, torch.Tensor):
            pixels = pixels_to_host(pixels)
        pixels = np.asarray(pixels, dtype=np.uint32).reshape(size[0],
                                                             size[1]).T
        img = np.empty(pixels.shape + (3,), dtype=np.uint8)
        img[..., 0] = (pixels >> 16) & 0xFF
        img[..., 1] = (pixels >> 8) & 0xFF
        img[..., 2] = pixels & 0xFF
        return img


def _scene_pose(geometry):
    with profiler.region('camera.pose'):
        lower, upper = geometry.mesh.get_bounds()
        scale = float(np.linalg.norm(upper - lower))
        center = (upper + lower) / 2.0
        pose = CameraPose(center - np.array([0.0, scale, 0.0]),
                          axis1=(0, 0, 1), axis2=(1, 0, 0))
        return pose, scale, center


def _arrays_on(geometry, geometry_arrays, device):
    "The geometry's device arrays on `device`, built unless given."
    device = _device(device)
    if geometry_arrays is None:
        geometry_arrays = build_geometry_arrays(geometry)
    return geometry_arrays.to(device)


def snapshot(geometry, size=(800, 600), position=None, focal_length=18.0,
             alpha_depth=10, bg_color=0xFFFFFFFF, geometry_arrays=None,
             device='cuda'):
    """Headless render of a flattened geometry on `device`. Returns an
    (h, w, 3) uint8 RGB image. `position` defaults to outside the bounding
    sphere looking at the center."""
    geometry_arrays = _arrays_on(geometry, geometry_arrays, device)

    pose, scale, center = _scene_pose(geometry)
    if position is not None:
        pose.position = np.asarray(position, dtype=np.float64)

    rays = pose.rays(size, device=device)
    pixels = rays.render(geometry_arrays, alpha_depth, bg_color)
    return _pixels_to_image(pixels, size)


def snapshot_anaglyph(geometry, size=(800, 600), eye_separation=None,
                      alpha_depth=10, geometry_arrays=None, device='cuda'):
    """Red/cyan stereo render (reference: camera.py 3D mode). The left
    eye supplies the red channel, the right eye green+blue."""
    geometry_arrays = _arrays_on(geometry, geometry_arrays, device)
    pose, scale, center = _scene_pose(geometry)
    if eye_separation is None:
        eye_separation = scale * 5e-3
    return _anaglyph(pose, size, eye_separation, geometry_arrays,
                     alpha_depth, device)


def _anaglyph(pose, size, eye_separation, geometry_arrays, alpha_depth,
              device):
    left, right = (
        _pixels_to_image(
            pose.rays(size, shift, device).render(geometry_arrays,
                                                  alpha_depth), size)
        for shift in (-eye_separation / 2, +eye_separation / 2))
    out = right.copy()
    out[..., 0] = left[..., 0]
    return out


def draw_tracks(image, tracks, pose, size, point_size=1):
    """Splat photon-track positions into an (h, w, 3) image, colored by
    wavelength (reference: camera.py:882-928 photon track display).
    `tracks` is an iterable of Photons-like objects (pos, wavelengths).
    Modifies and returns `image`."""
    for track in tracks:
        pos = np.asarray(track.pos)
        if len(pos) == 0:
            continue
        px, py, vis = pose.project(pos, size)
        if not vis.any():
            continue
        rgb = np.asarray(map_wavelength(
            np.asarray(track.wavelengths)[vis]))
        if rgb.max() <= 1.0:
            rgb = rgb * 255.0
        xi = px[vis].astype(int)
        yi = py[vis].astype(int)
        for ddx in range(-point_size + 1, point_size):
            for ddy in range(-point_size + 1, point_size):
                xs = np.clip(xi + ddx, 0, size[0] - 1)
                ys = np.clip(yi + ddy, 0, size[1] - 1)
                image[ys, xs] = rgb.astype(np.uint8)
    return image


def bvh_layer_geometry(geometry, layer_number):
    """A renderable Geometry whose mesh is the axis-aligned boxes of one
    BVH layer (reference: camera.py:475-488 BVH layer display)."""
    from chroma_tpu_torch.geometry import Geometry, Mesh, Solid, Material
    from chroma_tpu_torch.make import box

    layer = geometry.bvh.get_layer(layer_number)
    lower, upper = layer.get_bounds()
    verts = []
    tris = []
    base = 0
    unit = box(1.0, 1.0, 1.0)
    for lo, hi in zip(np.atleast_2d(lower), np.atleast_2d(upper)):
        extent = np.maximum(hi - lo, 1e-6)
        verts.append(unit.vertices * extent + (lo + hi) / 2.0)
        tris.append(unit.triangles + base)
        base += len(unit.vertices)
    mesh = Mesh(np.concatenate(verts), np.concatenate(tris), round=False)

    shell = Material('bvh_shell')
    shell.set('refractive_index', 1.0)
    shell.set('absorption_length', 1e6)
    shell.set('scattering_length', 1e6)
    out = Geometry(shell)
    out.add_solid(Solid(mesh, shell, shell, color=0xDD00AAFF))
    out.flatten()
    return out


def save_png(filename, image):
    """Write an (h, w, 3) uint8 image to an 8-bit RGB PNG, with the
    standard library only."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    height, width, _ = image.shape

    def chunk(tag, data):
        body = tag + data
        return (struct.pack('>I', len(data)) + body
                + struct.pack('>I', zlib.crc32(body)))

    # every scanline is preceded by its filter type (0: none)
    raw = np.zeros((height, 1 + 3 * width), dtype=np.uint8)
    raw[:, 1:] = image.reshape(height, 3 * width)
    with open(filename, 'wb') as fh:
        fh.write(b'\x89PNG\r\n\x1a\n')
        fh.write(chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, 8,
                                            2, 0, 0, 0)))
        fh.write(chunk(b'IDAT', zlib.compress(raw.tobytes(), 6)))
        fh.write(chunk(b'IEND', b''))


class Camera(_spawn.Process):
    """Interactive viewer in its own, spawned process (reference:
    camera.py:95-719). The device arrays are built in run(), so the parent
    hands the child only the picklable host geometry.

    Controls: drag = orbit, shift-drag = pan, wheel = zoom, F5 = hybrid
    render, F6 = screenshot, M = movie capture, 3 = anaglyph stereo,
    B/N = BVH layer display up/down, ESC/Q = quit."""

    def __init__(self, geometry, size=(800, 600), device_id=None,
                 alpha_depth=12, movie_dir=None, device='cuda'):
        super().__init__()
        self.geometry = geometry
        self.size = size
        self.alpha_depth = alpha_depth
        self.movie_dir = movie_dir
        self.device = device
        self.done = _spawn.Event()

    # --- rendering helpers shared with EventViewer -------------------

    def _frame(self, ga, pose, stereo, hybrid, hybrid_key):
        """Render one (h, w, 3) frame for the current mode; `hybrid_key`
        is the (seed, counter) pair of the photon-map render."""
        if hybrid:
            rays = pose.rays(self.size, device=self.device)
            pixels = hybrid_render(rays.pos, rays.dir, ga, hybrid_key)
            return _pixels_to_image(pixels, self.size)
        if stereo:
            return _anaglyph(pose, self.size, self._scale * 5e-3, ga,
                             self.alpha_depth, self.device)
        return _pixels_to_image(
            pose.rays(self.size, device=self.device).render(
                ga, self.alpha_depth), self.size)

    def _overlay(self, image, pose):
        "Hook for subclasses (EventViewer draws photon tracks)."
        return image

    def _geometry_arrays(self):
        return _arrays_on(self.geometry, None, self.device)

    def _screenshot(self, image):
        name = 'chroma-%s.png' % time.strftime('%Y%m%d-%H%M%S')
        save_png(name, image)
        print('Wrote %s' % name)

    def run(self):
        os.environ.setdefault('PYGAME_HIDE_SUPPORT_PROMPT', '1')
        import pygame

        pygame.init()
        screen = pygame.display.set_mode(self.size)
        pygame.display.set_caption('chroma_tpu_torch')
        clock = pygame.time.Clock()

        self._ga = self._geometry_arrays()
        pose, scale, center = _scene_pose(self.geometry)
        self._scale = scale

        stereo = False
        hybrid = False
        movie_frame = [0]
        bvh_layer = -1          # -1 = geometry, >= 0 = BVH layer display
        ga_layers = {}
        hybrid_key = (0, 0)

        def current_ga():
            if bvh_layer < 0:
                return self._ga
            if bvh_layer not in ga_layers:
                ga_layers[bvh_layer] = _arrays_on(
                    bvh_layer_geometry(self.geometry, bvh_layer), None,
                    self.device)
            return ga_layers[bvh_layer]

        last_image = [None]

        def redraw():
            image = self._frame(current_ga(), pose, stereo, hybrid,
                                hybrid_key)
            image = self._overlay(image, pose)
            last_image[0] = image
            pygame.surfarray.blit_array(
                screen, np.transpose(image, (1, 0, 2)))
            pygame.display.flip()
            if self.movie_dir is not None:
                save_png(os.path.join(
                    self.movie_dir,
                    'frame%06d.png' % movie_frame[0]), image)
                movie_frame[0] += 1

        redraw()
        dragging = False
        while not self.done.is_set():
            for ev in pygame.event.get():
                if ev.type == pygame.QUIT:
                    self.done.set()
                elif ev.type == pygame.KEYDOWN:
                    if ev.key in (pygame.K_ESCAPE, pygame.K_q):
                        self.done.set()
                    elif ev.key == pygame.K_F6:
                        if last_image[0] is not None:
                            self._screenshot(last_image[0])
                    elif ev.key == pygame.K_m:
                        if self.movie_dir is None:
                            self.movie_dir = 'chroma-movie-%s' \
                                % time.strftime('%Y%m%d-%H%M%S')
                            os.makedirs(self.movie_dir, exist_ok=True)
                            print('Recording to %s' % self.movie_dir)
                        else:
                            print('Stopped recording %s' % self.movie_dir)
                            self.movie_dir = None
                    elif ev.key == pygame.K_3:
                        stereo = not stereo
                        redraw()
                    elif ev.key == pygame.K_F5:
                        hybrid = not hybrid
                        hybrid_key = (0, int(time.time()))
                        redraw()
                    elif ev.key == pygame.K_b and \
                            self.geometry.bvh is not None:
                        bvh_layer = min(
                            bvh_layer + 1,
                            self.geometry.bvh.layer_count() - 1)
                        redraw()
                    elif ev.key == pygame.K_n:
                        bvh_layer = max(bvh_layer - 1, -1)
                        redraw()
                    elif self._handle_key(ev):
                        redraw()
                elif ev.type == pygame.MOUSEBUTTONDOWN:
                    if ev.button == 1:
                        dragging = True
                    elif ev.button in (4, 5):
                        step = scale * 0.05 * (1 if ev.button == 4 else -1)
                        pose.translate(step * pose.forward)
                        redraw()
                elif ev.type == pygame.MOUSEBUTTONUP and ev.button == 1:
                    dragging = False
                elif ev.type == pygame.MOUSEMOTION and dragging:
                    dx, dy = ev.rel
                    if pygame.key.get_mods() & pygame.KMOD_SHIFT:
                        pose.translate(scale * 1e-3
                                       * (-dx * pose.axis2
                                          + dy * pose.axis1))
                    else:
                        if dx:
                            pose.orbit(np.float32(dx * 1e-2),
                                       np.array([0.0, 0, 1]), center)
                        if dy:
                            axis = np.cross([0.0, 0, 1], pose.forward)
                            nrm = np.linalg.norm(axis)
                            if nrm > 0:
                                pose.orbit(np.float32(dy * 1e-2),
                                           axis / nrm, center)
                    redraw()
            clock.tick(20)  # reference frame cap: camera.py:701
        pygame.quit()

    def _handle_key(self, ev):
        "Subclass hook; return True to trigger a redraw."
        return False

    def stop(self):
        self.done.set()


def color_solids(geometry, solid_hit, solid_colors):
    """Per-triangle color array with hit solids recolored (host analog of
    the color_solids kernel, reference: chroma/cuda/mesh.h:162-174)."""
    colors = np.array(geometry.colors)
    hit_of_tri = solid_hit[geometry.solid_id]
    colors[hit_of_tri] = solid_colors[geometry.solid_id[hit_of_tri]]
    return colors


class EventSource(object):
    """Sequential event access with prev/next/jump over a (possibly lazy)
    event iterable — the reference streams from a RootReader instead of
    materializing the file (reference: camera.py EventViewer). Events
    already seen are kept; forward motion pulls from the iterator. Pickling
    (a viewer started as a process) reads a lazy iterable to its end."""

    def __init__(self, events):
        if hasattr(events, '__next__'):
            self._it = events
            self._cache = []
        else:
            self._it = None
            self._cache = list(events)
        self.index = -1
        if self._advance_to(0) is None:
            self.index = -1

    def _advance_to(self, i):
        while self._it is not None and len(self._cache) <= i:
            try:
                self._cache.append(next(self._it))
            except StopIteration:
                self._it = None
        if 0 <= i < len(self._cache):
            self.index = i
            return self._cache[i]
        return None

    def __getstate__(self):
        index = self.index
        self._advance_to(float('inf'))
        self.index = index
        return self.__dict__

    def current(self):
        return self._cache[self.index] if 0 <= self.index \
            < len(self._cache) else None

    def next(self):
        ev = self._advance_to(self.index + 1)
        return ev if ev is not None else self.current()

    def prev(self):
        if self.index > 0:
            self.index -= 1
        return self.current()

    def jump(self, i):
        ev = self._advance_to(i)
        return ev if ev is not None else self.current()


class EventViewer(Camera):
    """Event display: steps through events from a reader/list, coloring
    hit PMT solids by charge or time (reference: camera.py:753-1072).
    PAGEUP/PAGEDOWN navigate events; C/T switch charge/time coloring;
    P toggles the photon-track overlay (requires photon_tracking)."""

    def __init__(self, geometry, events, size=(800, 600), mode='charge',
                 show_tracks=False, **kwargs):
        super().__init__(geometry, size=size, **kwargs)
        self.source = EventSource(events)
        self.mode = mode
        self.show_tracks = show_tracks

    def event_colors(self, ev):
        "Triangle color array for one event's channel readout."
        if ev is None or ev.channels is None:
            return np.asarray(self.geometry.colors)
        return self.color_hit_channels(self.geometry, ev.channels)

    def color_hit_channels(self, geometry, channels):
        "Recolor each hit PMT's triangles by its charge (or time)."
        solid_ids = np.asarray(geometry.channel_index_to_solid_id)
        hit, t, q = channels.hit_channels()
        if len(hit) == 0:
            return np.asarray(geometry.colors)
        values = q if self.mode == 'charge' else t
        rgb = map_to_color(values)
        nsolids = int(geometry.solid_id.max()) + 1
        solid_hit = np.zeros(nsolids, dtype=bool)
        solid_colors = np.zeros(nsolids, dtype=np.uint32)
        solid_hit[solid_ids[hit]] = True
        solid_colors[solid_ids[hit]] = rgb
        return color_solids(geometry, solid_hit, solid_colors)

    def _geometry_arrays(self):
        self._ga_base = _arrays_on(self.geometry, None, self.device)
        return self._recolored()

    def _recolored(self):
        "The base arrays with the current event's colors, on their device."
        colors = self.event_colors(self.source.current())
        colors = np.ascontiguousarray(colors.astype(np.uint32))
        return dataclasses.replace(
            self._ga_base,
            colors=torch.from_numpy(colors.view(np.int32)).to(
                self._ga_base.colors.device))

    def _overlay(self, image, pose):
        ev = self.source.current()
        if (self.show_tracks and ev is not None
                and getattr(ev, 'photon_tracks', None)):
            image = draw_tracks(image, ev.photon_tracks, pose, self.size)
        return image

    def _handle_key(self, ev):
        import pygame
        if ev.key == pygame.K_PAGEDOWN:
            self.source.next()
        elif ev.key == pygame.K_PAGEUP:
            self.source.prev()
        elif ev.key == pygame.K_c:
            self.mode = 'charge'
        elif ev.key == pygame.K_t:
            self.mode = 'time'
        elif ev.key == pygame.K_p:
            self.show_tracks = not self.show_tracks
            return True
        else:
            return False
        self._ga = self._recolored()
        return True

    def run(self):
        # Camera.run drives everything through the subclass hooks; the
        # event-recolored arrays are refreshed by _handle_key
        super().run()


def view(obj, size=(800, 600), device='cuda'):
    "Open an interactive viewer on a geometry/solid/mesh (blocks)."
    from chroma_tpu_torch.loader import create_geometry_from_obj
    geometry = create_geometry_from_obj(obj)
    camera = Camera(geometry, size, device=device)
    camera.start()
    camera.join()
