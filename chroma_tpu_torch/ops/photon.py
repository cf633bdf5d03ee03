"""Photon physics step for the torch port (counterpart of
chroma_tpu.ops.photon), vectorised over the photon batch.

Every phase of a step -- geometry query, bulk transport, surface
interaction, Fresnel boundary -- is computed for the whole batch and merged
with masks, in the JAX package's order, drawing uniforms from the step's
DrawPool in the JAX trace order. This slice ports the main path: the
default surface model, no bulk reemission, no wire planes, no weights or
scatter_first biasing; other geometries and options raise
NotImplementedError.

History flags are u32 in the reference; here they are int32 bit patterns
(NAN_ABORT = bit 31 is negative).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from chroma_tpu.event import (NO_HIT, BULK_ABSORB, SURFACE_DETECT,
                              SURFACE_ABSORB, RAYLEIGH_SCATTER,
                              REFLECT_DIFFUSE, REFLECT_SPECULAR, NAN_ABORT,
                              TERMINAL_FLAGS)
from chroma_tpu.geometry import SURFACE_DEFAULT
from chroma_tpu_torch.ops import visit_kernel
from chroma_tpu_torch.ops.linalg import dot, cross, norm, normalize, rotate
from chroma_tpu_torch.ops.types import (MAT_REFRACTIVE_INDEX,
                                        MAT_ABSORPTION_LENGTH,
                                        MAT_SCATTERING_LENGTH, SURF_DETECT,
                                        SURF_ABSORB, SURF_REFLECT_DIFFUSE,
                                        SURF_REFLECT_SPECULAR)

SPEED_OF_LIGHT = 299.792458  # mm/ns
PI = math.pi

# step outcomes (reference: photon.h:70)
BREAK, CONTINUE, PASS = 0, 1, 2


def i32(flag):
    "A u32 flag word as the int32 with the same bits."
    flag &= 0xFFFFFFFF
    return flag - (1 << 32) if flag >= 1 << 31 else flag


@dataclasses.dataclass
class PhotonState:
    """SoA photon batch on a device (the Photon struct, photon.h:19-34)."""
    pos: torch.Tensor         # (N,3) f32 mm
    dir: torch.Tensor         # (N,3) f32
    pol: torch.Tensor         # (N,3) f32
    wavelength: torch.Tensor  # (N,) f32 nm
    t: torch.Tensor           # (N,) f32 ns
    weight: torch.Tensor      # (N,) f32
    flags: torch.Tensor       # (N,) i32 history bits (u32 bit patterns)
    last_hit_triangle: torch.Tensor  # (N,) i32
    evidx: torch.Tensor       # (N,) i32 (u32 bit patterns)
    # current-medium index (-1 = unknown), tracked so the next geometry
    # query can be pruned by the sampled interaction length
    cur_mat: torch.Tensor     # (N,) i32

    def __len__(self):
        return self.pos.shape[0]

    @property
    def alive(self):
        return (self.flags & i32(TERMINAL_FLAGS)) == 0

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def map(self, fn):
        "Apply fn to every field tensor."
        return PhotonState(**{f.name: fn(getattr(self, f.name))
                              for f in dataclasses.fields(self)})

    def to(self, device):
        return self.map(lambda a: a.to(device))


@dataclasses.dataclass
class StepState:
    """Per-step boundary context (the State struct, photon.h:36-51)."""
    hit: torch.Tensor                # (N,) bool
    distance: torch.Tensor           # (N,) f32
    normal: torch.Tensor             # (N,3) f32, faces the incoming photon
    rindex1: torch.Tensor
    rindex2: torch.Tensor
    absorption_length: torch.Tensor
    scattering_length: torch.Tensor
    material1: torch.Tensor          # (N,) i32
    material2: torch.Tensor
    surface: torch.Tensor            # (N,) i32, -1 = plain boundary


def select(mask, a, b):
    "Per-lane select of two PhotonStates: mask -> a, else b."
    out = {}
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        m = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
        out[f.name] = torch.where(m, x, y)
    return PhotonState(**out)


def _flag(mask, bit):
    "`bit` where mask, else 0, as int32 flag words."
    return torch.where(mask, i32(bit), 0).to(torch.int32)


def _sext8(x):
    "Sign-extend an 8-bit field to int32 (reference: photon.h:72-79)."
    x = x & 0xFF
    return torch.where(x >= 128, x - 256, x)


def get_theta(a, b):
    return torch.arccos(torch.clamp(dot(a, b), -1.0, 1.0))


def wavelength_lerp_rows(table_wl, wavelength, x0, dx):
    """Fetch and lerp one wavelength row per lane from a wavelength-major
    table (n_wl, ...): every material's or surface's properties at each
    photon's wavelength."""
    n_wl = table_wl.shape[0]
    xf = (wavelength - x0) / dx
    jl = torch.clamp(xf.to(torch.int32), 0, n_wl - 2)
    frac = torch.clamp(xf - jl.to(torch.float32), 0.0, 1.0)
    flat = table_wl.reshape(n_wl, -1)
    jl = jl.to(torch.int64)
    lo = flat[jl]
    hi = flat[jl + 1]
    out = lo + frac[:, None] * (hi - lo)
    return out.reshape((len(jl),) + tuple(table_wl.shape[1:]))


def select_rows(rows, idx):
    "rows[lane, idx[lane]], 0 where idx is outside [0, rows.shape[1])."
    r = rows.shape[1]
    ok = (idx >= 0) & (idx < r)
    safe = torch.where(ok, idx, 0).to(torch.int64)
    out = rows[torch.arange(rows.shape[0], device=rows.device), safe]
    ok = ok.reshape(ok.shape + (1,) * (out.dim() - 1))
    return torch.where(ok, out, torch.zeros((), dtype=out.dtype,
                                            device=out.device))


def check_supported(geometry):
    "Raise NotImplementedError for what this slice does not port yet."
    if geometry.materials.has_reemission:
        raise NotImplementedError('bulk reemission is not ported to the '
                                  'torch backend yet')
    models = geometry.surfaces.models_present
    if tuple(models) != (SURFACE_DEFAULT,):
        raise NotImplementedError(
            'surface models %s: only the default model (%d) is ported to '
            'the torch backend yet' % (models, SURFACE_DEFAULT))


# ---------------------------------------------------------------------------
# fill_state: geometry query + boundary material resolution
# ---------------------------------------------------------------------------

def fill_state(photons, geometry, active, best_limit, pruned, pre_props,
               mrows):
    """Find each photon's next boundary and resolve the optical context
    (reference: photon.h:87-397), instanced-table branch. Lanes not in
    `active` are skipped. `best_limit`, `pruned` and `pre_props` (the
    current medium's (rindex, abslen, scatlen)) implement the
    interaction-length pruning of propagate_step: a pruned miss means "no
    boundary before the bulk interaction", not NO_HIT. `mrows` is every
    material's properties at each photon's wavelength. Returns (photons',
    StepState)."""
    tri, dist, code, nvec, hit_iid, _ = visit_kernel.traverse(
        geometry.wide, photons.pos, photons.dir, photons.last_hit_triangle,
        mask=active, best_limit=best_limit)
    hit = tri >= 0

    if geometry.inst is not None:
        R = geometry.inst.rot_n[hit_iid.to(torch.int64)]   # det * R_l2w
        nvec = torch.stack(
            [R[:, 0] * nvec[:, 0] + R[:, 1] * nvec[:, 1]
             + R[:, 2] * nvec[:, 2],
             R[:, 3] * nvec[:, 0] + R[:, 4] * nvec[:, 1]
             + R[:, 5] * nvec[:, 2],
             R[:, 6] * nvec[:, 0] + R[:, 7] * nvec[:, 1]
             + R[:, 8] * nvec[:, 2]], dim=1)
    ln = torch.sqrt(dot(nvec, nvec))[:, None]
    face_normal = nvec / torch.where(ln > 0, ln, 1.0)

    inner = _sext8(code >> 24)
    outer = _sext8(code >> 16)
    surf = _sext8(code >> 8)

    outside = dot(face_normal, -photons.dir) > 0.0
    normal = torch.where(outside[:, None], face_normal, -face_normal)
    mat1 = torch.where(outside, outer, inner)
    mat2 = torch.where(outside, inner, outer)

    mat1 = torch.where(hit, mat1, 0)
    mat2 = torch.where(hit, mat2, 0)

    m1p = select_rows(mrows, mat1)
    rindex1 = m1p[:, MAT_REFRACTIVE_INDEX]
    abslen = m1p[:, MAT_ABSORPTION_LENGTH]
    scatlen = m1p[:, MAT_SCATTERING_LENGTH]
    rindex2 = select_rows(mrows[:, :, MAT_REFRACTIVE_INDEX], mat2)

    # lanes with a tracked medium keep the properties their interaction
    # distances were sampled from
    known = photons.cur_mat >= 0
    rindex1 = torch.where(known, pre_props[0], rindex1)
    abslen = torch.where(known, pre_props[1], abslen)
    scatlen = torch.where(known, pre_props[2], scatlen)
    mat1 = torch.where(known, photons.cur_mat, mat1)

    no_hit_now = active & ~hit & ~pruned
    flags = photons.flags | _flag(no_hit_now, NO_HIT)
    last_hit = torch.where(active, torch.where(hit, tri, -1),
                           photons.last_hit_triangle)
    photons = photons.replace(flags=flags, last_hit_triangle=last_hit)

    state = StepState(hit=active & (hit | pruned), distance=dist,
                      normal=normal, rindex1=rindex1, rindex2=rindex2,
                      absorption_length=abslen, scattering_length=scatlen,
                      material1=mat1, material2=mat2, surface=surf)
    return photons, state


# ---------------------------------------------------------------------------
# direction sampling helpers
# ---------------------------------------------------------------------------

def pick_new_direction(axis, theta, phi):
    """Direction at polar angle (theta, phi) about `axis`
    (reference: photon.h:399-427)."""
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    cos_p, sin_p = torch.cos(phi), torch.sin(phi)
    ax, ay, az = axis[:, 0], axis[:, 1], axis[:, 2]
    sin_axis_theta = torch.sqrt(torch.clamp(1.0 - az * az, min=0.0))
    degenerate = sin_axis_theta < 1e-5
    inv = 1.0 / torch.where(degenerate, 1.0, sin_axis_theta)
    cos_axis_phi = torch.where(degenerate, 1.0, ax * inv)
    sin_axis_phi = torch.where(degenerate, 0.0, ay * inv)

    dirx = cos_t * ax + sin_t * (az * cos_p * cos_axis_phi
                                 - sin_p * sin_axis_phi)
    diry = cos_t * ay + sin_t * (cos_p * az * sin_axis_phi
                                 + sin_p * cos_axis_phi)
    dirz = cos_t * az - sin_t * cos_p * sin_axis_theta
    return torch.stack([dirx, diry, dirz], dim=-1)


def rayleigh_scatter(photons, pool):
    """Rayleigh scattering by the closed-form inverse CDF of (1+cos^2),
    polarization updated (reference: photon.h:429-453). Returns (dir,
    pol)."""
    u = pool.draw()
    cos_theta = 2.0 * torch.cos((torch.arccos(1.0 - 2.0 * u) - 2.0 * PI)
                                / 3.0)
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    phi = pool.draw(0.0, 2.0 * PI)

    new_dir = pick_new_direction(photons.pol, theta, phi)

    head_on = (1.0 - torch.abs(cos_theta)) < 1e-6
    pol_perp = pick_new_direction(photons.pol,
                                  torch.full_like(theta, PI / 2), phi)
    pol_mix = photons.pol - cos_theta[:, None] * new_dir
    new_pol = torch.where(head_on[:, None], pol_perp, pol_mix)
    return normalize(new_dir), normalize(new_pol)


def _random_perpendicular_pol(pool, direction):
    "Polarization uniformly distributed perpendicular to `direction`."
    r = pool.uniform_sphere()
    return normalize(cross(r, direction))


def cosine_hemisphere(pool, normal):
    """Cosine-weighted direction about `normal`, closed form
    (reference: photon.h:648-667)."""
    u1 = pool.draw()
    u2 = pool.draw()
    z = torch.sqrt(u1)
    r = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    phi = 2.0 * PI * u2

    # branchless orthonormal frame about the normal (Duff et al. 2017)
    nx, ny, nz = normal[:, 0], normal[:, 1], normal[:, 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t1 = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx],
                     dim=-1)
    t2 = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)

    return (r[:, None] * torch.cos(phi)[:, None] * t1
            + r[:, None] * torch.sin(phi)[:, None] * t2
            + z[:, None] * normal)


# ---------------------------------------------------------------------------
# bulk transport
# ---------------------------------------------------------------------------

def propagate_to_boundary(photons, state, pool, u_abs, u_scat):
    """Transport each photon to its absorption or scattering point or the
    boundary (reference: photon.h:455-570), with the absorption and
    scattering uniforms pre-drawn by propagate_step. Unweighted, no
    scatter_first biasing, no reemission. Returns (photons', command)."""
    d_bound = state.distance
    absorption_distance = -state.absorption_length * torch.log(u_abs)
    scattering_distance = -state.scattering_length * torch.log(u_scat)
    # the biasing draw (scatter_first) is consumed to keep the JAX order
    pool.draw()

    absorb_first = absorption_distance <= scattering_distance
    absorbed = absorb_first & (absorption_distance <= d_bound)
    scattered = ~absorb_first & (scattering_distance <= d_bound)
    passed = ~absorbed & ~scattered

    step_dist = torch.where(absorbed, absorption_distance,
                            torch.where(scattered, scattering_distance,
                                        d_bound))
    speed = SPEED_OF_LIGHT / state.rindex1
    new_t = photons.t + step_dist / speed
    new_pos = photons.pos + step_dist[:, None] * photons.dir

    ray_dir, ray_pol = rayleigh_scatter(photons, pool)

    new_dir = torch.where(scattered[:, None], ray_dir, photons.dir)
    new_pol = torch.where(scattered[:, None], ray_pol, photons.pol)

    flags = photons.flags
    flags = flags | _flag(absorbed, BULK_ABSORB)
    flags = flags | _flag(scattered, RAYLEIGH_SCATTER)

    # the boundary triangle only remains "last hit" if we reached it
    last_hit = torch.where(passed, photons.last_hit_triangle, -1)

    command = torch.where(passed, PASS,
                          torch.where(absorbed, BREAK, CONTINUE))

    photons = photons.replace(pos=new_pos, dir=new_dir, pol=new_pol,
                              t=new_t, flags=flags,
                              last_hit_triangle=last_hit)
    return photons, command


# ---------------------------------------------------------------------------
# boundary / surface interactions
# ---------------------------------------------------------------------------

def _incident_geometry(photons, state):
    """Incidence and refraction angles, plane-of-incidence normal and
    s-polarization fraction (reference: photon.h:575-592)."""
    incident_angle = get_theta(state.normal, -photons.dir)
    sin_ratio = torch.sin(incident_angle) * state.rindex1 / state.rindex2
    refracted_angle = torch.arcsin(sin_ratio)
    tir = torch.abs(sin_ratio) > 1.0

    ipn = cross(photons.dir, state.normal)
    ipn_len = norm(ipn)
    degenerate = ipn_len < 1e-6
    ipn = torch.where(degenerate[:, None], photons.pol,
                      ipn / torch.where(degenerate, 1.0, ipn_len)[:, None])

    normal_coefficient = dot(photons.pol, ipn)
    s_fraction = normal_coefficient * normal_coefficient
    return incident_angle, refracted_angle, tir, ipn, s_fraction


def propagate_at_boundary(photons, state, pool):
    """Polarized Fresnel reflect/refract at a plain dielectric boundary
    (reference: photon.h:572-632). Always CONTINUEs."""
    incident_angle, refracted_angle, tir, ipn, s_fraction = \
        _incident_geometry(photons, state)

    s_polarized = pool.draw() < s_fraction

    sum_angle = incident_angle + refracted_angle
    diff_angle = incident_angle - refracted_angle
    refl_s = -torch.sin(diff_angle) / torch.sin(sum_angle)
    refl_p = torch.tan(diff_angle) / torch.tan(sum_angle)
    refl_coeff = torch.where(s_polarized, refl_s, refl_p)

    u = pool.draw()
    reflects = (u < refl_coeff * refl_coeff) | tir

    reflect_dir = rotate(state.normal, incident_angle, ipn)
    safe_refr = torch.where(tir, 0.0, refracted_angle)
    transmit_dir = rotate(state.normal, PI - safe_refr, ipn)
    new_dir = torch.where(reflects[:, None], reflect_dir, transmit_dir)

    pol_s = ipn
    pol_p = normalize(cross(ipn, new_dir))
    new_pol = torch.where(s_polarized[:, None], pol_s, pol_p)

    flags = photons.flags | _flag(reflects, REFLECT_SPECULAR)
    return photons.replace(dir=new_dir, pol=new_pol, flags=flags)


def _specular_reflect(photons, state):
    "Mirror reflection; polarization unchanged (reference: photon.h:634-646)."
    incident_angle = get_theta(state.normal, -photons.dir)
    ipn = normalize(cross(photons.dir, state.normal))
    new_dir = rotate(state.normal, incident_angle, ipn)
    return photons.replace(dir=new_dir,
                           flags=photons.flags | REFLECT_SPECULAR)


def _diffuse_reflect(photons, state, pool):
    "Lambertian reflection (reference: photon.h:648-667)."
    new_dir = cosine_hemisphere(pool, state.normal)
    new_pol = _random_perpendicular_pol(pool, new_dir)
    return photons.replace(dir=new_dir, pol=new_pol,
                           flags=photons.flags | REFLECT_DIFFUSE)


def propagate_at_default_surface(photons, state, pool, sp):
    """Default surface: roulette over detect/absorb/diffuse/specular with
    PASS for any residual (reference: photon.h:967-1035). `sp` is the
    (N,8) per-lane surface property row."""
    detect = sp[:, SURF_DETECT]
    absorb = sp[:, SURF_ABSORB]
    rdiff = sp[:, SURF_REFLECT_DIFFUSE]
    rspec = sp[:, SURF_REFLECT_SPECULAR]

    u = pool.draw()
    absorbs = u < absorb
    detects = ~absorbs & (u < absorb + detect)
    diffuses = ~absorbs & ~detects & (u < absorb + detect + rdiff)
    speculars = (~absorbs & ~detects & ~diffuses
                 & (u < absorb + detect + rdiff + rspec))
    passes = ~absorbs & ~detects & ~diffuses & ~speculars

    spec = _specular_reflect(photons, state)
    diff = _diffuse_reflect(photons, state, pool)
    reflected = select(diffuses, diff, spec)
    photons = select(diffuses | speculars, reflected, photons)

    flags = photons.flags
    flags = flags | _flag(detects, SURFACE_DETECT)
    flags = flags | _flag(absorbs, SURFACE_ABSORB)
    photons = photons.replace(flags=flags)

    command = torch.where(absorbs | detects, BREAK,
                          torch.where(passes, PASS, CONTINUE))
    return photons, command


def propagate_at_surface(photons, state, pool, geometry):
    """Surface dispatch (reference: photon.h:953-1037); the default model is
    the only one ported, and check_supported refuses the others."""
    mats = geometry.materials
    sidx = torch.clamp(state.surface, min=0)
    srows = wavelength_lerp_rows(geometry.surfaces.props_wl,
                                 photons.wavelength, mats.wavelength0,
                                 mats.wavelength_step)
    sp = select_rows(srows, sidx)
    return propagate_at_default_surface(photons, state, pool, sp)


# ---------------------------------------------------------------------------
# one full step
# ---------------------------------------------------------------------------

def propagate_step(photons, geometry, pool):
    """One propagation step for the whole batch (reference:
    chroma/cuda/propagate.cu:300-338), drawing from the DrawPool `pool`.
    Termination is recorded in the history flags.

    The absorption and scattering uniforms are drawn before the geometry
    query and, for lanes whose medium is tracked (cur_mat >= 0), the
    sampled interaction distance bounds the BVH traversal (the JAX
    package's default pruning)."""
    check_supported(geometry)
    mats = geometry.materials
    alive = photons.alive

    # NaN guard (reference: propagate.cu:307-310)
    bad = torch.isnan(photons.dir.sum(dim=-1) + photons.pos.sum(dim=-1))
    nan_abort = alive & bad
    flags = photons.flags | _flag(nan_abort, NO_HIT | NAN_ABORT)
    photons = photons.replace(flags=flags)
    active = alive & ~nan_abort

    u_abs = pool.draw()
    u_scat = pool.draw()

    mrows = wavelength_lerp_rows(mats.props_wl, photons.wavelength,
                                 mats.wavelength0, mats.wavelength_step)
    known = active & (photons.cur_mat >= 0)
    safe_mat = torch.clamp(photons.cur_mat, min=0)
    pre_props = tuple(
        select_rows(mrows[:, :, p], safe_mat)
        for p in (MAT_REFRACTIVE_INDEX, MAT_ABSORPTION_LENGTH,
                  MAT_SCATTERING_LENGTH))
    pre_abs = -pre_props[1] * torch.log(u_abs)
    pre_scat = -pre_props[2] * torch.log(u_scat)
    interaction = torch.minimum(pre_abs, pre_scat)
    # near-vacuum media never interact in practice; leave those lanes
    # unpruned so a genuine escape still reads as NO_HIT
    pruned = known & (interaction < 1e20)
    limit = torch.where(pruned, interaction * (1.0 + 1e-4), torch.inf)

    photons, state = fill_state(photons, geometry, active, limit, pruned,
                                pre_props, mrows)
    active = active & state.hit

    moved, cmd_bulk = propagate_to_boundary(photons, state, pool, u_abs,
                                            u_scat)
    photons = select(active, moved, photons)
    at_boundary = active & (cmd_bulk == PASS)

    has_surface = state.surface != -1
    surf_lanes = at_boundary & has_surface
    ph_surf, cmd_surf = propagate_at_surface(photons, state, pool, geometry)
    photons = select(surf_lanes, ph_surf, photons)

    fresnel_lanes = at_boundary & (~has_surface
                                   | (has_surface & (cmd_surf == PASS)))
    ph_fres = propagate_at_boundary(photons, state, pool)
    photons = select(fresnel_lanes, ph_fres, photons)

    # medium tracking: a photon that ended the step heading through the
    # boundary plane is now in material2, everything else in material1
    crossed = at_boundary & (dot(photons.dir, state.normal) < 0.0)
    mat_now = torch.where(crossed, state.material2, state.material1)
    cur_mat = torch.where(active, mat_now, photons.cur_mat)
    return photons.replace(cur_mat=cur_mat)
