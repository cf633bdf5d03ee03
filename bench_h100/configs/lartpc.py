"""The `lartpc` configuration: MicroBooNE's liquid-argon TPC, built for the
program through its Detector and WirePlane and for the reference from
frozen copies of the same mesh arithmetic (reference/shapes.py) and the
reference's own wire planes (reference/wires.py).

Both builds read one layout worked out here from the sizes: the box (the
active volume, extended behind the anode to hold the PMTs), the three
planes and the PMTs' places. The configuration needs a wire walk that is
exact metres from the wires: `port_geometry` holds the program's plain
walk to the reference's float64 wire query on rays from the drift volume
to the planes, and refuses a program that finds other wires.
"""
from __future__ import annotations

import hashlib
import json
import math
import os

import numpy as np
import torch

from bench_h100.reference import shapes
from bench_h100.reference.scene import Mesh
from bench_h100.reference.wires import WirePlane, WireScene, wire_query

LAR, GLASS, VACUUM, METAL = 0, 1, 2, 3
BLACK, PHOTOCATHODE, SHINY, WIRE = 0, 1, 2, 3
BUILD_KEYS = ('active_mm', 'behind_anode_mm', 'planes', 'pitch_mm',
              'wire_radius_mm', 'pmt_grid', 'pmt_front_behind_y_mm',
              'pmt_steps', 'pmt_glass_mm', 'photocathode_efficiency', 'lar',
              'glass', 'time_rms_ns', 'charge_mean', 'charge_rms')
CHECK_RAYS = 512      # rays of the wire walk's check
CHECK_AGREE = 0.99    # the share of them that must find the reference's wire


def _name(cfg):
    key = json.dumps({k: cfg[k] for k in BUILD_KEYS}, sort_keys=True)
    return 'geocache_%s_%s' % (cfg['name'],
                               hashlib.sha1(key.encode()).hexdigest()[:12])


# -- the layout ---------------------------------------------------------------

def box_layout(cfg):
    "(dimensions, centre) of the absorbing box."
    ax, ay, az = cfg['active_mm']
    back = cfg['behind_anode_mm']
    return (ax + back, ay, az), (back / 2.0, 0.0, 0.0)


def plane_layout(cfg):
    """Per plane: (name, origin, u (the wires' axis), v, umax, vmax), the
    extents symmetric about the face's centre and covering the face."""
    ax, ay, az = cfg['active_mm']
    hy, hz = ay / 2.0, az / 2.0
    out = []
    for p in cfg['planes']:
        a = math.radians(p['angle_deg'])
        c, s = math.cos(a), math.sin(a)
        out.append((p['name'], (ax / 2.0 + p['behind_mm'], 0.0, 0.0),
                    (0.0, c, s), (0.0, -s, c),
                    hy * abs(c) + hz * abs(s), hy * abs(s) + hz * abs(c)))
    return out


def pmt_layout(cfg):
    """The PMTs' centres on the grid of cells over the anode face, their
    fronts (the SNO profile's face, +y in the mesh) the given distance
    behind the last plane, facing -x."""
    ax, ay, az = cfg['active_mm']
    ny, nz = cfg['pmt_grid']
    face = shapes.half_profile('sno_pmt.txt')[:, 1].max()
    x = ax / 2.0 + max(p['behind_mm'] for p in cfg['planes']) \
        + cfg['pmt_front_behind_y_mm'] + face
    return [np.array([x, -ay / 2.0 + ay * (i + 0.5) / ny,
                      -az / 2.0 + az * (j + 0.5) / nz])
            for i in range(ny) for j in range(nz)]


FACING = np.array([-1.0, 0.0, 0.0])


# -- the program's build ------------------------------------------------------

def detector(cfg):
    "The program's Detector of the configuration (host objects)."
    import chroma_tpu_torch.demo
    from chroma_tpu_torch.demo.optics import shiny_surface, vacuum
    from chroma_tpu_torch.detector import Detector
    from chroma_tpu_torch.geometry import Material, Solid, Surface, WirePlane
    from chroma_tpu_torch.make import box
    from chroma_tpu_torch.pmt import build_pmt
    from chroma_tpu_torch.transform import make_rotation_matrix

    def material(name, n, absorption, scattering):
        m = Material(name)
        m.set('refractive_index', n)
        m.set('absorption_length', absorption)
        m.set('scattering_length', scattering)
        return m
    lar = material('lar', cfg['lar']['refractive_index'],
                   cfg['lar']['absorption_length_mm'],
                   cfg['lar']['scattering_length_mm'])
    glass = material('glass_tpb', cfg['glass']['refractive_index'],
                     cfg['glass']['absorption_length_mm'],
                     cfg['glass']['scattering_length_mm'])
    metal = material('metal', 1.5, 1e-3, 1e6)
    black = Surface('black_surface')
    black.set('absorb', 1.0)
    wire = Surface('wire')
    wire.set('absorb', 1.0)
    q = cfg['photocathode_efficiency']
    cathode = Surface('flat_photocathode')
    cathode.set('detect', q)
    cathode.set('absorb', q)
    cathode.set('reflect_diffuse', 1.0 - 2.0 * q)

    profile = os.path.join(os.path.dirname(chroma_tpu_torch.demo.__file__),
                           'data', 'sno_pmt.txt')
    pmt = build_pmt(profile, cfg['pmt_glass_mm'], outer_material=lar,
                    glass=glass, vacuum=vacuum, photocathode_surface=cathode,
                    back_surface=shiny_surface, nsteps=cfg['pmt_steps'])
    det = Detector(lar)
    dims, centre = box_layout(cfg)
    det.add_solid(Solid(box(*dims, center=centre), lar, lar, surface=black))
    y = np.array([0.0, 1.0, 0.0])
    rotation = make_rotation_matrix(np.arccos(y @ FACING),
                                    np.cross(FACING, y))
    for position in pmt_layout(cfg):
        det.add_pmt(pmt, rotation, position)
    for _, origin, u, v, umax, vmax in plane_layout(cfg):
        det.add_wireplane(WirePlane(
            origin=origin, u=u, v=v, pitch=cfg['pitch_mm'],
            radius=cfg['wire_radius_mm'], umin=-umax, umax=umax, vmin=-vmax,
            vmax=vmax, surface=wire, material_inner=metal,
            material_outer=lar))
    rms = cfg['time_rms_ns']
    det.set_time_dist_gaussian(rms, -5 * rms, 5 * rms)
    mean, qrms = cfg['charge_mean'], cfg['charge_rms']
    det.set_charge_dist_gaussian(mean, qrms, 0.0, mean + 5 * qrms)
    return det


def _build(cfg, path):
    from chroma_tpu_torch.io.geocache import save_geometry_arrays
    from chroma_tpu_torch.ops.types import build_geometry_arrays
    tmp = path + '.partial'
    save_geometry_arrays(tmp, build_geometry_arrays(detector(cfg)))
    os.replace(tmp + '.npz', path + '.npz')
    os.replace(tmp + '.json', path + '.json')


def port_geometry(cfg, cache_dir, dense=False):
    """The program's GeometryArrays (on the host) and whether it has
    channels, from the program's geocache in `cache_dir` (built there by
    the first run), once its wire walk has passed check_wire_walk."""
    from chroma_tpu_torch.io.geocache import load_geometry_arrays
    path = os.path.join(cache_dir, _name(cfg))
    if not os.path.exists(path + '.json'):
        _build(cfg, path)
    arrays = load_geometry_arrays(path, lean=not dense)
    check_wire_walk(cfg, arrays)
    return arrays, True


def port_detector(cfg, cache_dir):
    "The program's flat Geometry of the detector."
    det = detector(cfg)
    det.flatten()
    return det


def check_wire_walk(cfg, arrays):
    """Rays from the drift volume to seeded points of the anode planes,
    through the program's plain wire walk (its CPU path, K3's twin) and
    the reference's float64 wire query: at least CHECK_AGREE of them must
    meet the same plane at the same distance (0.01 mm) or miss on both.
    A walk that loses the wires' radius to rounding a metre away finds
    other wires on a large share of them: this deployment cannot run on
    it, and the run stops here (RuntimeError) before any timing."""
    from chroma_tpu_torch.ops import wireplane
    gen = torch.Generator().manual_seed(0x11AE)
    ax, ay, az = cfg['active_mm']
    n = CHECK_RAYS

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen,
                                           dtype=torch.float64)
    x_face = ax / 2.0
    start = torch.stack([uniform(-0.4 * ax, 0.4 * ax),
                         uniform(-0.4 * ay, 0.4 * ay),
                         uniform(-0.4 * az, 0.4 * az)], 1)
    aim = torch.stack([uniform(x_face - 1.0, x_face + 8.0),
                       start[:, 1] + uniform(-0.3, 0.3) * ay,
                       start[:, 2] + uniform(-0.3, 0.3) * ay], 1)
    d = torch.nn.functional.normalize(aim - start, dim=1)
    o, d = start.float(), d.float()
    t, plane = wireplane.walk_plain(o, d, arrays,
                                    torch.ones(n, dtype=torch.bool))[:2]
    ref_t, ref_plane, _ = wire_query(reference_scene(cfg, 128.0).to('cpu'),
                                     o, d)
    same = (plane.long() == ref_plane) & (
        (ref_plane < 0) | ((t - ref_t).abs() < 0.01))
    share = float(same.double().mean())
    if share < CHECK_AGREE:
        raise RuntimeError(
            'the program\'s wire walk meets the reference\'s float64 wires '
            'on %.1f%% of %d rays from the drift volume (%d hits against '
            '%d): this configuration needs a walk exact metres from the '
            'wires' % (100 * share, n, int((plane >= 0).sum()),
                       int((ref_plane >= 0).sum())))


# -- the reference's build ----------------------------------------------------

def reference_planes(cfg):
    return [WirePlane(origin, u, v, cfg['pitch_mm'], cfg['wire_radius_mm'],
                      -umax, umax, -vmax, vmax, WIRE, METAL, LAR)
            for _, origin, u, v, umax, vmax in plane_layout(cfg)]


def _box(dims, centre):
    """make.box: the rectangle extruded along z with its end caps pinched
    to the axis, as the program builds it."""
    rx, ry, rz = dims[0] / 2.0, dims[1] / 2.0, dims[2] / 2.0
    x = np.array([-rx, rx, rx, -rx])
    y = np.array([-ry, -ry, ry, ry])
    zero = np.zeros(4)
    chain = [np.c_[zero, zero, np.full(4, -rz)],
             np.c_[x, y, np.full(4, -rz)], np.c_[x, y, np.full(4, rz)],
             np.c_[zero, zero, np.full(4, rz)]]
    v = np.stack(chain, axis=1).reshape(-1, 3) + np.asarray(centre)
    return shapes.clean(v, shapes.loop_faces(4, len(chain)))


def _optics(cfg):
    lar, glass = cfg['lar'], cfg['glass']
    materials = [[lar['refractive_index'], lar['absorption_length_mm'],
                  lar['scattering_length_mm']],
                 [glass['refractive_index'], glass['absorption_length_mm'],
                  glass['scattering_length_mm']],
                 [1.0, 1e6, 1e6],
                 [1.5, 1e-3, 1e6]]
    q = cfg['photocathode_efficiency']
    surfaces = [[0.0, 1.0, 0.0, 0.0],
                [q, q, 1.0 - 2.0 * q, 0.0],
                [0.0, 0.0, 0.0, 1.0],
                [0.0, 1.0, 0.0, 0.0]]
    return materials, surfaces


def reference_scene(cfg, wavelength):
    """The reference's WireScene: the box (instance 0), one PMT mesh (glass
    shell, vacuum cavity) at each grid point, channel i the i-th PMT, and
    the three planes. The tables are flat: `wavelength` only has to lie
    where they hold."""
    shell_rz = shapes.half_profile('sno_pmt.txt')
    cavity_rz = shapes.offset(shell_rz, -cfg['pmt_glass_mm'])
    parts = []
    for rz, m_in, m_out, surf in ((shell_rz, GLASS, LAR, -1),
                                  (cavity_rz, VACUUM, GLASS, None)):
        v, f = shapes.rotate_extrude(rz[:, 0], rz[:, 1], cfg['pmt_steps'])
        if surf is None:
            front = v[f].mean(axis=1)[:, 1] > 0
            surf = np.where(front, PHOTOCATHODE, SHINY)
        parts.append((v, f, m_in, m_out, surf))
    verts, faces, m_in, m_out, surf = [], [], [], [], []
    base = 0
    for v, f, a, b, s in parts:
        verts.append(v)
        faces.append(f + base)
        base += len(v)
        m_in.append(np.full(len(f), a))
        m_out.append(np.full(len(f), b))
        surf.append(np.broadcast_to(s, (len(f),)))
    pmt = Mesh(np.concatenate(verts), np.concatenate(faces),
               np.concatenate(m_in), np.concatenate(m_out),
               np.concatenate(surf))
    bv, bf = _box(*box_layout(cfg))
    wall = Mesh(bv, bf, LAR, LAR, BLACK)
    positions = pmt_layout(cfg)
    rots = [np.identity(3)] + [shapes.rotation_to(FACING)] * len(positions)
    materials, surfaces = _optics(cfg)
    return WireScene([wall, pmt], [0] + [1] * len(positions), rots,
                     [np.zeros(3)] + positions, materials, surfaces,
                     inst_channel=[-1] + list(range(len(positions))),
                     planes=reference_planes(cfg))


def daq_tables(cfg):
    "The detector's (time, charge) distributions as binned CDFs."
    from bench_h100.reference.daq import gaussian_cdf
    rms = cfg['time_rms_ns']
    mean, qrms = cfg['charge_mean'], cfg['charge_rms']
    return (gaussian_cdf(0.0, rms, -5 * rms, 5 * rms),
            gaussian_cdf(mean, qrms, 0.0, mean + 5 * qrms))
