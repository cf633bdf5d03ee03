"""The `quick` configuration: Chroma's demo PMT detector, built for the
program through its loader and for the reference from frozen copies of
the same mesh arithmetic (reference/shapes.py)."""
from __future__ import annotations

import os

import numpy as np

from bench_h100.reference import shapes
from bench_h100.reference.scene import Mesh, Scene

WATER, GLASS, VACUUM = 0, 1, 2
BLACK, PHOTOCATHODE, SHINY = 0, 1, 2
# the viewer's colours (ARGB, the top byte transparency): a solid's
# default, the photocathode, the PMT's back, the black sphere
DEFAULT_COLOR, GREEN, RED, SPHERE_COLOR = 0x33ffffff, 0x00ff00, 0xff0000, \
    0xBBFFFFFF


def _name(cfg):
    return 'geocache_%s_%g_%g_%g' % (cfg['name'], cfg['pmt_radius_mm'],
                                     cfg['sphere_radius_mm'],
                                     cfg['spiral_step_mm'])


def _build(cfg, cache_dir):
    """demo.detector through loader.create_geometry_from_obj
    (auto_build_bvh=False), once a checkout: saved as the program's
    geocache (device arrays) and, flat, in its loader cache."""
    from chroma_tpu_torch import demo
    from chroma_tpu_torch.cache import Cache
    from chroma_tpu_torch.io.geocache import save_geometry_arrays
    from chroma_tpu_torch.loader import create_geometry_from_obj
    from chroma_tpu_torch.ops.types import build_geometry_arrays
    args = (cfg['pmt_radius_mm'], cfg['sphere_radius_mm'],
            cfg['spiral_step_mm'])
    geo = create_geometry_from_obj(lambda: demo.detector(*args),
                                   auto_build_bvh=False, cache_dir=cache_dir)
    Cache(cache_dir).save_geometry(_name(cfg), geo)
    path = os.path.join(cache_dir, _name(cfg))
    tmp = path + '.partial'
    save_geometry_arrays(tmp, build_geometry_arrays(geo))
    os.replace(tmp + '.npz', path + '.npz')
    os.replace(tmp + '.json', path + '.json')


def port_geometry(cfg, cache_dir, dense=False):
    """The program's GeometryArrays (on the host) and whether it has
    channels, loaded from the program's geocache in `cache_dir` (built
    there by the first run): lean (no per-triangle world arrays), or
    `dense` for the renderer's normals and colours."""
    from chroma_tpu_torch.io.geocache import load_geometry_arrays
    path = os.path.join(cache_dir, _name(cfg))
    if not os.path.exists(path + '.json'):
        _build(cfg, cache_dir)
    return load_geometry_arrays(path, lean=not dense), True


def port_detector(cfg, cache_dir):
    """The program's flat Geometry of the detector, from its loader cache
    in `cache_dir` (built there by the first run)."""
    from chroma_tpu_torch.cache import Cache
    cache = Cache(cache_dir)
    if _name(cfg) not in cache.list_geometry():
        _build(cfg, cache_dir)
    return cache.load_geometry(_name(cfg))


def _optics(wavelength):
    water = shapes.read_csv('water_wcsim.csv')
    glass_abs = shapes.read_csv('glass_sno_absorption.csv')
    qe = shapes.read_csv('r7081hqe_detect.csv')

    def at(table, col=1):
        return float(np.interp(wavelength, table[:, 0].astype(np.float32),
                               table[:, col].astype(np.float32)))
    materials = [[at(water, 1), at(water, 2), at(water, 3)],
                 [1.49, at(glass_abs), 1e6],
                 [1.0, 1e6, 1e6]]
    q = at(qe)
    surfaces = [[0.0, 1.0, 0.0, 0.0],
                [q, q, 1.0 - 2.0 * q, 0.0],
                [0.0, 0.0, 0.0, 1.0]]
    return materials, surfaces


def reference_scene(cfg, wavelength):
    """The reference's Scene: the sphere (instance 0) and one PMT mesh
    (glass shell, vacuum cavity, light concentrator) at each spiral point,
    channel i the i-th PMT."""
    steps = cfg['pmt_steps']
    shell_rz = shapes.half_profile('sno_pmt.txt')
    cavity_rz = shapes.offset(shell_rz, -cfg['pmt_glass_mm'])
    lc_rz = shapes.read_csv('sno_cone.txt')
    parts = []
    for rz, m_in, m_out, surf in (
            (shell_rz, GLASS, WATER, -1),
            (cavity_rz, VACUUM, GLASS, None),
            (lc_rz, WATER, WATER, SHINY)):
        v, f = shapes.rotate_extrude(rz[:, 0], rz[:, 1], steps)
        color = DEFAULT_COLOR
        if surf is None:
            front = v[f].mean(axis=1)[:, 1] > 0
            surf = np.where(front, PHOTOCATHODE, SHINY)
            color = np.where(front, GREEN, RED)
        parts.append((v, f, m_in, m_out, surf, color))
    verts, faces, m_in, m_out, surf, colors = [], [], [], [], [], []
    base = 0
    for v, f, a, b, s, c in parts:
        verts.append(v)
        faces.append(f + base)
        base += len(v)
        m_in.append(np.full(len(f), a))
        m_out.append(np.full(len(f), b))
        surf.append(np.broadcast_to(s, (len(f),)))
        colors.append(np.broadcast_to(c, (len(f),)))
    pmt = Mesh(np.concatenate(verts), np.concatenate(faces),
               np.concatenate(m_in), np.concatenate(m_out),
               np.concatenate(surf), np.concatenate(colors))
    sv, sf = shapes.sphere(cfg['sphere_radius_mm'], cfg['sphere_steps'])
    ball = Mesh(sv, sf, WATER, WATER, BLACK, SPHERE_COLOR)
    positions = list(shapes.spherical_spiral(cfg['pmt_radius_mm'],
                                             cfg['spiral_step_mm']))
    rots = [np.identity(3)] + [shapes.rotation_to(-p / np.linalg.norm(p))
                               for p in positions]
    materials, surfaces = _optics(wavelength)
    return Scene([ball, pmt], [0] + [1] * len(positions), rots,
                 [np.zeros(3)] + positions, materials, surfaces,
                 inst_channel=[-1] + list(range(len(positions))))


def daq_tables(cfg):
    "The detector's (time, charge) distributions as binned CDFs."
    from bench_h100.reference.daq import gaussian_cdf
    rms = cfg['time_rms_ns']
    mean, qrms = cfg['charge_mean'], cfg['charge_rms']
    return (gaussian_cdf(0.0, rms, -5 * rms, 5 * rms),
            gaussian_cdf(mean, qrms, 0.0, mean + 5 * qrms))
