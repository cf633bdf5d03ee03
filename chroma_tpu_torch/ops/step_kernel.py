"""Wrappers of K2, the step around the geometry query
(csrc/step_kernel.cu): k2_pre before the query, k2_post after it.

k2_post replaces what XLA fuses of the JAX step after the traversal
(chroma_tpu/ops/photon.py: fill_state's context decode, :201-362, bulk
transport, the surface models, Fresnel and medium tracking, :437-1085, as
propagate_step, :1086-1182, runs them), one launch a step writing the
photon fields. A block of B lanes runs the decode and bulk transport a
thread a lane, then regroups the lanes that reached the boundary by their
surface model (or Fresnel alone) in shared memory, so that a warp runs
one model at a time (the kernel source's note). Its plain twin is
`after_query_plain`, built from the port's plain functions (ops.photon)
with a DrawPool over the given uniforms; the CPU step and the tests run
it, no card path does. k2_pre replaces the per-lane work of the step's
prologue (photon.step_prologue, its plain twin): the NaN guard, the
active lanes and the pruning limit; the prologue's uniform blocks stay
torch's `uniform_`, so the Philox stream is the plain step's.

The uniforms. The plain step consumes its DrawPool's streams in a fixed
order that depends only on which surface models the geometry has and on
whether any material reemits (use_weights, scatter_first and
CHROMA_FORCE_SCATTER_AT_PASS change no draw), and it evaluates every
present model for every lane. K2 evaluates only a lane's own model, so
`draw_sites` gives each draw site of the plain step (SITES) the stream
index the plain step draws it from, once per (models, reemission); the
step makes exactly the blocks the plain step would make (n_blocks), so a
graph replay's Philox stream is an eager step's.

The tables. `tables` packs the geometry's material, surface, instance and
wire-plane arrays K2 reads into one f32 and one i32 tensor, once per
geometry and before any capture (ops.cuda_build.geometry_tables).

`before_query` and `after_query` launch k2_pre and k2_post for CUDA
tensors and run the plain twins for CPU tensors; on a CUDA tensor a failed
build or launch raises. Their launches count as `k2_pre` and `k2_post`
(ops.cuda_build).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import os

import numpy as np
import torch

from chroma_tpu_torch.geometry import (SURFACE_DEFAULT, SURFACE_COMPLEX,
                                       SURFACE_WLS, SURFACE_DICHROIC,
                                       SURFACE_ANGULAR)
from chroma_tpu_torch.ops import cuda_build, photon, wireplane
from chroma_tpu_torch.ops.sample import DrawPool
from chroma_tpu_torch.ops.types import SURF_REEMISSION_CDF

SOURCE = os.path.join(cuda_build.CSRC, 'step_kernel.cu')
BLOCK = 8       # uniform streams a DrawPool block holds

# k2_post's block: B lanes regrouped together. Wide blocks sort more lanes
# by model; narrow ones fill more of the card's 132 SMs at narrow widths.
# chip_smoke.py phase 13 times 64, 128 and 256 at the main paths' widths
# (NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6): below 2^16
# lanes 64 was the best or within 10% of it; from 2^16, 256 on the
# five-model quick-optics detector (0.417 ms at 2^20 lanes against 0.532
# at 128 and 0.805 at 64) and 128 on the one-model quick detector (0.105
# against 0.111 at 256). Chosen from the width and the geometry's surface
# models alone, so a graph and an eager step of one width launch the same
# blocks.
BLOCK_NARROW, BLOCK_WIDE, BLOCK_MODELS, WIDE_FROM = 64, 128, 256, 1 << 16


def block_for(n, n_models=1):
    """k2_post's block size at a width of n lanes on a geometry with
    n_models surface models."""
    if n < WIDE_FROM:
        return BLOCK_NARROW
    return BLOCK_MODELS if n_models > 1 else BLOCK_WIDE

# The plain step's draw sites, in its draw order (csrc/step_kernel.cu's
# `enum Site`): (name, the group that draws it, the chain of plain
# functions that draws it, innermost first, below after_query_plain).
# Groups: 'bulk' always; 'reemission' when a material reemits; a surface
# model's id when a surface has that model; 'fresnel' always.
_TB = ('propagate_to_boundary',)
_RE = ('_reemission',) + _TB
_AS = ('propagate_at_surface',)


def _model_sites(prefix, model_fn, model):
    "The four draws of _reflect_either's diffuse branch inside `model_fn`."
    chain = ('_diffuse_reflect', '_reflect_either', model_fn) + _AS
    return [(prefix + '_hemi_u1', model, ('cosine_hemisphere',) + chain),
            (prefix + '_hemi_u2', model, ('cosine_hemisphere',) + chain),
            (prefix + '_pol_phi', model, ('_random_perpendicular_pol',)
             + chain),
            (prefix + '_pol_u', model, ('_random_perpendicular_pol',)
             + chain)]


_DEF = ('propagate_at_default_surface',) + _AS
_CX = ('propagate_complex',) + _AS
_WLS = ('propagate_at_wls',) + _AS
_AN = ('propagate_at_angular',) + _AS
SITES = [
    ('abs', 'bulk', ()), ('scat', 'bulk', ()), ('force', 'bulk', _TB),
    ('re_comp', 'reemission', _RE), ('re_reemit', 'reemission', _RE),
    ('re_wl', 'reemission', _RE), ('re_time', 'reemission', _RE),
    ('re_dir_phi', 'reemission', _RE), ('re_dir_u', 'reemission', _RE),
    ('re_pol_phi', 'reemission', ('_random_perpendicular_pol',) + _RE),
    ('re_pol_u', 'reemission', ('_random_perpendicular_pol',) + _RE),
    ('ray_u', 'bulk', ('rayleigh_scatter',) + _TB),
    ('ray_phi', 'bulk', ('rayleigh_scatter',) + _TB),
    ('def_u', SURFACE_DEFAULT, _DEF),
    *_model_sites('def', 'propagate_at_default_surface', SURFACE_DEFAULT),
    ('cx_u', SURFACE_COMPLEX, _CX), ('cx_udet', SURFACE_COMPLEX, _CX),
    ('cx_urefl', SURFACE_COMPLEX, _CX),
    *_model_sites('cx', 'propagate_complex', SURFACE_COMPLEX),
    ('wls_u', SURFACE_WLS, _WLS), ('wls_ureemit', SURFACE_WLS, _WLS),
    ('wls_wl', SURFACE_WLS, _WLS), ('wls_dir_phi', SURFACE_WLS, _WLS),
    ('wls_dir_u', SURFACE_WLS, _WLS),
    ('wls_pol_phi', SURFACE_WLS, ('_random_perpendicular_pol',) + _WLS),
    ('wls_pol_u', SURFACE_WLS, ('_random_perpendicular_pol',) + _WLS),
    ('wls_urefl', SURFACE_WLS, _WLS),
    ('wls_hemi_u1', SURFACE_WLS, ('cosine_hemisphere', '_diffuse_reflect',
                                  '_reflect_either') + _WLS),
    ('wls_hemi_u2', SURFACE_WLS, ('cosine_hemisphere', '_diffuse_reflect',
                                  '_reflect_either') + _WLS),
    ('wls_rpol_phi', SURFACE_WLS, ('_random_perpendicular_pol',
                                   '_diffuse_reflect', '_reflect_either')
     + _WLS),
    ('wls_rpol_u', SURFACE_WLS, ('_random_perpendicular_pol',
                                 '_diffuse_reflect', '_reflect_either')
     + _WLS),
    ('di_u', SURFACE_DICHROIC, ('propagate_at_dichroic',) + _AS),
    ('an_u', SURFACE_ANGULAR, _AN),
    *_model_sites('an', 'propagate_at_angular', SURFACE_ANGULAR),
    ('fr_spol', 'fresnel', ('propagate_at_boundary',)),
    ('fr_u', 'fresnel', ('propagate_at_boundary',)),
]
SITE_NAMES = tuple(name for name, _, _ in SITES)


def draw_sites(models_present, has_reemission):
    """The plain step's stream index of every draw site (-1 where the step
    does not draw it), for a geometry with these surface models and
    reemission: (tuple in SITES order, total draws)."""
    out = []
    k = 0
    for _, group, _ in SITES:
        if group in ('bulk', 'fresnel') or group in models_present \
                or (group == 'reemission' and has_reemission):
            out.append(k)
            k += 1
        else:
            out.append(-1)
    return tuple(out), k


def _sites_of(geometry):
    return draw_sites(geometry.surfaces.models_present,
                      geometry.materials.has_reemission)


def n_draws(geometry):
    "The uniform streams one step on `geometry` draws."
    return _sites_of(geometry)[1]


def n_blocks(geometry):
    "The (8, N) uniform blocks one step on `geometry` draws."
    return math.ceil(n_draws(geometry) / BLOCK)


# ---------------------------------------------------------------------------
# the plain twin
# ---------------------------------------------------------------------------

def after_query_plain(photons, geometry, blocks, active, pruned, query,
                      wires, use_weights=False, scatter_first=0,
                      physics=photon):
    """K2's plain twin: the step after the geometry query, from the port's
    plain functions. photons: the PhotonState after step_prologue's NaN
    guard; blocks: the step's (B * 8, N) U[0, 1) uniforms; active: the
    lanes to step; pruned: the lanes whose query the interaction distance
    bounded, or None without pruning; query: the traversal's (tri, dist,
    code, nvec, iid); wires: the wire walk's (t, plane, vn, nn) or None.
    `physics` holds the plain functions (ops.photon, or the namespace a
    copy of it imported with other CHROMA_* switches passes). Returns the
    PhotonState after the step."""
    pool = DrawPool.over(blocks, block=BLOCK)
    u_abs = pool.draw()
    u_scat = pool.draw()
    mats = geometry.materials
    mrows = physics.wavelength_lerp_rows(mats.props_wl, photons.wavelength,
                                         mats.wavelength0,
                                         mats.wavelength_step)
    pre_props = None if pruned is None else \
        physics.medium_props(mrows, photons.cur_mat)
    wp = None if wires is None else \
        wireplane.classify(wires, photons.dir, geometry.wireplanes)
    photons, state = physics.decode_state(photons, geometry, active, pruned,
                                          pre_props, mrows, query, wp)
    return physics.finish_step(photons, state, pool, geometry, active,
                               u_abs, u_scat, use_weights, scatter_first)


def after_query(photons, geometry, blocks, active, pruned, query, wires,
                use_weights=False, scatter_first=0, physics=photon):
    """The step after the geometry query: K2 on CUDA tensors, the plain
    twin on CPU tensors (arguments as after_query_plain's; K2 takes the
    switch CHROMA_FORCE_SCATTER_AT_PASS from `physics`)."""
    if not photons.pos.is_cuda:
        return after_query_plain(photons, geometry, blocks, active, pruned,
                                 query, wires, use_weights, scatter_first,
                                 physics)
    return launch(photons, geometry, blocks, active, pruned, query, wires,
                  use_weights, scatter_first,
                  physics.FORCE_SCATTER_AT_PASS)


def before_query(photons, geometry, pool, use_weights=False, prune=True,
                 physics=photon):
    """The step before the geometry query, as photon.step_prologue returns
    it: (photons with the NaN-abort flags, active lanes, the (B * 8, N)
    uniform blocks, pruned lanes or None, the limit or None). On CUDA
    tensors the blocks are torch's uniform_ (DrawPool.stacked) and the
    rest one launch of k2_pre; on CPU tensors physics.step_prologue, the
    plain twin (`physics` holds it and the switch
    CHROMA_PRUNE_TRAVERSAL)."""
    if not photons.pos.is_cuda:
        return physics.step_prologue(photons, geometry, pool, use_weights,
                                     prune)
    blocks = pool.stacked(n_draws(geometry))
    return launch_pre(photons, geometry, blocks,
                      prune and not use_weights and physics.PRUNE_TRAVERSAL)


# ---------------------------------------------------------------------------
# the packed tables
# ---------------------------------------------------------------------------

# csrc/step_kernel.cu's `enum Table`, f32 then i32
TABLES_F32 = ('mat_wl', 'comp_abs', 'comp_prob', 'comp_wvl', 'comp_time',
              'surf_wl', 'surf_cdf', 'thickness', 'd_angles', 'd_reflect',
              'd_transmit', 'a_angles', 'a_transmit', 'a_rspec', 'a_rdiff',
              'rot', 'wire_v', 'wire_w')
TABLES_I32 = ('num_comp', 'model', 'transmissive', 'd_index', 'd_nangles',
              'a_index', 'a_nangles', 'wire_surface', 'wire_inner',
              'wire_outer')


def table_sources(geometry):
    """The geometry's tensors K2 reads, by table name (an empty tensor
    where the geometry has none: no instances, no wire planes)."""
    m, s = geometry.materials, geometry.surfaces
    wp, inst = geometry.wireplanes, geometry.inst
    dev = m.props_wl.device
    none_f = torch.zeros(0, dtype=torch.float32, device=dev)
    none_i = torch.zeros(0, dtype=torch.int32, device=dev)
    return {
        'mat_wl': m.props_wl, 'comp_abs': m.comp_absorption_length,
        'comp_prob': m.comp_reemission_prob,
        'comp_wvl': m.comp_reemission_wvl_cdf,
        'comp_time': m.comp_reemission_time_cdf,
        'surf_wl': s.props_wl, 'surf_cdf': s.props[:, SURF_REEMISSION_CDF],
        'thickness': s.thickness, 'd_angles': s.dichroic_angles,
        'd_reflect': s.dichroic_reflect, 'd_transmit': s.dichroic_transmit,
        'a_angles': s.angular_angles, 'a_transmit': s.angular_transmit,
        'a_rspec': s.angular_reflect_specular,
        'a_rdiff': s.angular_reflect_diffuse,
        'rot': none_f if inst is None else inst.rot_n,
        'wire_v': none_f if wp is None else wp.v,
        'wire_w': none_f if wp is None else wp.w,
        'num_comp': m.num_comp, 'model': s.model,
        'transmissive': s.transmissive, 'd_index': s.dichroic_index,
        'd_nangles': s.dichroic_nangles, 'a_index': s.angular_index,
        'a_nangles': s.angular_nangles,
        'wire_surface': none_i if wp is None else wp.surface_index,
        'wire_inner': none_i if wp is None else wp.material_inner_index,
        'wire_outer': none_i if wp is None else wp.material_outer_index,
    }


@dataclasses.dataclass
class TablePack:
    """K2's tables: every f32 table flattened into `f32`, every i32 one
    into `i32`, each starting at offsets[name] with its shape."""
    f32: torch.Tensor
    i32: torch.Tensor
    offsets: dict
    shapes: dict

    def read(self, name, index):
        """Element `index` (a tuple) of table `name`, read from the pack by
        the row-major offset arithmetic K2 uses."""
        flat = self.f32 if name in TABLES_F32 else self.i32
        return flat[self.offsets[name]
                    + int(np.ravel_multi_index(index, self.shapes[name]))]


def pack_tables(geometry):
    "The TablePack of `geometry`, on its device."
    src = table_sources(geometry)
    packs = []
    offsets, shapes = {}, {}
    for names, dtype in ((TABLES_F32, torch.float32),
                         (TABLES_I32, torch.int32)):
        parts, off = [], 0
        for name in names:
            t = src[name]
            offsets[name] = off
            shapes[name] = tuple(t.shape)
            parts.append(t.reshape(-1).to(dtype))
            off += t.numel()
        if off >= 2 ** 31:
            raise ValueError('K2 tables exceed 2^31 elements')
        packs.append(torch.cat(parts).contiguous())
    return TablePack(packs[0], packs[1], offsets, shapes)


def tables(geometry):
    "The geometry's TablePack, packed once per geometry object."
    return cuda_build.geometry_tables(geometry, 'step_tables', pack_tables)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LANE_IN = ('pos', 'dir', 'pol', 'wl', 't', 'weight', 'flags', 'lht',
            'cur_mat', 'active', 'pruned', 'tri', 'dist', 'code', 'nvec',
            'iid', 'w_t', 'w_plane', 'w_vn', 'w_nn', 'u')
_LANE_OUT = ('o_pos', 'o_dir', 'o_pol', 'o_wl', 'o_t', 'o_weight', 'o_flags',
             'o_lht', 'o_cur_mat')
_INTS = ('n', 'n_wl', 'n_mat', 'maxc', 'n_t', 'n_surf', 'd_nang', 'a_nang',
         'n_inst', 'use_weights', 'scatter_first', 'prune', 'force_scatter',
         'has_reemission', 'has_inst', 'wl0_zero', 't0_zero')


class _Args(ctypes.Structure):
    "csrc/step_kernel.cu's StepArgs, field for field."
    _fields_ = ([(name, _P) for name in _LANE_IN + _LANE_OUT]
                + [('tf', _P), ('ti', _P),
                   ('off', _I * (len(TABLES_F32) + len(TABLES_I32)))]
                + [(name, _I) for name in _INTS]
                + [(name, _F) for name in ('wl0', 'wl_step', 'time0',
                                           'time_step')]
                + [('sites', _I * len(SITES))])


class _PreArgs(ctypes.Structure):
    "csrc/step_kernel.cu's PreArgs, field for field."
    _fields_ = ([(name, _P) for name in (
        'pos', 'dir', 'wl', 'flags', 'cur_mat', 'u', 'mat_wl', 'o_flags',
        'o_active', 'o_pruned', 'o_limit')]
        + [(name, _I) for name in ('n', 'n_wl', 'n_mat')]
        + [(name, _F) for name in ('wl0', 'wl_step')])


def bind(lib):
    """Set the C entry points' argument types on `lib` (a build of
    csrc/step_kernel.cu); raises RuntimeError if its argument structs
    differ from _Args and _PreArgs."""
    lib.chroma_step.argtypes = [_Args, _I, _P]
    lib.chroma_step_pre.argtypes = [_PreArgs, _P]
    for fn in (lib.chroma_step, lib.chroma_step_pre, lib.chroma_step_load,
               lib.chroma_step_args_size, lib.chroma_step_pre_args_size):
        fn.restype = _I
    for name, size, struct in (
            ('StepArgs', lib.chroma_step_args_size(), _Args),
            ('PreArgs', lib.chroma_step_pre_args_size(), _PreArgs)):
        if size != ctypes.sizeof(struct):
            raise RuntimeError('%s is %d bytes in the library, %d here'
                               % (name, size, ctypes.sizeof(struct)))


library = cuda_build.Library(SOURCE, bind, 'chroma_step_load')


def _as_f32(x):
    return float(np.float32(x))


def launch(photons, geometry, blocks, active, pruned, query, wires,
           use_weights=False, scatter_first=0, force_scatter=None,
           block=None):
    """One launch of k2_post on CUDA tensors (arguments as
    after_query_plain's; force_scatter: CHROMA_FORCE_SCATTER_AT_PASS,
    ops.photon's when None; block: lanes a block, block_for(N, models)
    when None); returns the new PhotonState."""
    n = len(photons)
    dev = photons.pos.device
    sites, total = _sites_of(geometry)
    if blocks.shape != (n_blocks(geometry) * BLOCK, n):
        raise ValueError('blocks: want %s, got %s' % (
            (n_blocks(geometry) * BLOCK, n), tuple(blocks.shape)))
    pack = tables(geometry)
    if pack.f32.device != dev:
        raise ValueError('geometry tables on %s, photons on %s'
                         % (pack.f32.device, dev))
    f32, i32, u8 = torch.float32, torch.int32, torch.uint8
    a = _Args()
    ins = dict(pos=(photons.pos, f32, (n, 3)), dir=(photons.dir, f32, (n, 3)),
               pol=(photons.pol, f32, (n, 3)),
               wl=(photons.wavelength, f32, (n,)), t=(photons.t, f32, (n,)),
               weight=(photons.weight, f32, (n,)),
               flags=(photons.flags, i32, (n,)),
               lht=(photons.last_hit_triangle, i32, (n,)),
               cur_mat=(photons.cur_mat, i32, (n,)),
               active=(cuda_build.mask_bytes(active, n, dev), u8, (n,)),
               u=(blocks, f32, tuple(blocks.shape)))
    tri, dist, code, nvec, iid = query
    ins.update(tri=(tri, i32, (n,)), dist=(dist, f32, (n,)),
               code=(code, i32, (n,)), nvec=(nvec, f32, (n, 3)),
               iid=(iid, i32, (n,)))
    if pruned is not None:
        ins['pruned'] = (cuda_build.mask_bytes(pruned, n, dev, 'pruned'),
                         u8, (n,))
    if wires is not None:
        w_t, w_plane, w_vn, w_nn = wires
        ins.update(w_t=(w_t, f32, (n,)), w_plane=(w_plane, i32, (n,)),
                   w_vn=(w_vn, f32, (n,)), w_nn=(w_nn, f32, (n,)))
    for name, (t, dtype, shape) in ins.items():
        setattr(a, name, cuda_build.pointer(name, t, dtype, shape, dev))
    out = photons.replace(**{
        f: torch.empty_like(getattr(photons, f)) for f in (
            'pos', 'dir', 'pol', 'wavelength', 't', 'weight', 'flags',
            'last_hit_triangle', 'cur_mat')})
    for name, field in zip(_LANE_OUT, (
            'pos', 'dir', 'pol', 'wavelength', 't', 'weight', 'flags',
            'last_hit_triangle', 'cur_mat')):
        setattr(a, name, getattr(out, field).data_ptr())

    m, s = geometry.materials, geometry.surfaces
    a.tf, a.ti = pack.f32.data_ptr(), pack.i32.data_ptr()
    a.off[:] = [pack.offsets[name] for name in TABLES_F32 + TABLES_I32]
    a.n = n
    a.n_wl, a.n_mat, a.maxc, a.n_t = (m.n_wavelength, m.props_wl.shape[1],
                                      m.max_comp, m.n_time)
    a.n_surf = s.props_wl.shape[1]
    a.d_nang = s.dichroic_angles.shape[1]
    a.a_nang = s.angular_angles.shape[1]
    a.n_inst = 0 if geometry.inst is None else geometry.inst.rot_n.shape[0]
    a.use_weights = int(bool(use_weights))
    a.scatter_first = int(scatter_first)
    a.prune = int(pruned is not None)
    a.force_scatter = int(photon.FORCE_SCATTER_AT_PASS
                          if force_scatter is None else force_scatter)
    a.has_reemission = int(m.has_reemission)
    a.has_inst = int(geometry.inst is not None)
    a.wl0, a.wl_step = _as_f32(m.wavelength0), _as_f32(m.wavelength_step)
    a.time0, a.time_step = _as_f32(m.time0), _as_f32(m.time_step)
    a.wl0_zero = int(a.wl0 == 0.0)
    a.t0_zero = int(a.time0 == 0.0)
    a.sites[:] = list(sites)

    if block is None:
        block = block_for(n, len(s.models_present))
    cuda_build.launch('k2_post', library.load().chroma_step, dev, a, block)
    return out


def launch_pre(photons, geometry, blocks, prune):
    """One launch of k2_pre on CUDA tensors: the prologue's NaN guard,
    active lanes and (with `prune`) pruned lanes and limit, from the
    step's uniform blocks (streams 0 and 1: the absorption and scattering
    draws). Returns step_prologue's tuple."""
    n = len(photons)
    dev = photons.pos.device
    mats = geometry.materials
    if blocks.dim() != 2 or blocks.shape[1] != n or blocks.shape[0] < 2:
        raise ValueError('blocks: want (>= 2, %d), got %s'
                         % (n, tuple(blocks.shape)))
    f32, i32 = torch.float32, torch.int32
    a = _PreArgs()
    for name, t, dtype, shape in (
            ('pos', photons.pos, f32, (n, 3)),
            ('dir', photons.dir, f32, (n, 3)),
            ('wl', photons.wavelength, f32, (n,)),
            ('flags', photons.flags, i32, (n,)),
            ('cur_mat', photons.cur_mat, i32, (n,)),
            ('u', blocks, f32, tuple(blocks.shape)),
            ('mat_wl', mats.props_wl, f32, tuple(mats.props_wl.shape))):
        setattr(a, name, cuda_build.pointer(name, t, dtype, shape, dev))
    flags = torch.empty_like(photons.flags)
    active = torch.empty(n, dtype=torch.bool, device=dev)
    pruned = limit = None
    a.o_flags, a.o_active = flags.data_ptr(), active.data_ptr()
    if prune:
        pruned = torch.empty(n, dtype=torch.bool, device=dev)
        limit = torch.empty(n, dtype=f32, device=dev)
        a.o_pruned, a.o_limit = pruned.data_ptr(), limit.data_ptr()
    a.n = n
    a.n_wl, a.n_mat = mats.n_wavelength, mats.props_wl.shape[1]
    a.wl0, a.wl_step = _as_f32(mats.wavelength0), _as_f32(
        mats.wavelength_step)
    cuda_build.launch('k2_pre', library.load().chroma_step_pre, dev, a)
    return photons.replace(flags=flags), active, blocks, pruned, limit
