"""Photon physics step for the torch port (counterpart of
chroma_tpu.ops.photon), vectorised over the photon batch.

Every phase of a step -- geometry query (mesh and analytic wire planes),
bulk transport with reemission, the five surface models, Fresnel boundary
-- is computed for the whole batch and merged with masks, in the JAX
package's order, drawing uniforms from the step's DrawPool in the JAX trace
order: every surface model present in the geometry draws for every lane,
whether the lane uses it or not (default, complex, WLS, dichroic, angular).
Weighted transport (use_weights) and scatter_first biasing follow the JAX
step, and so do its two switches CHROMA_FORCE_SCATTER_AT_PASS and
CHROMA_PRUNE_TRAVERSAL, read once at import.

History flags are u32 in the reference; here they are int32 bit patterns
(NAN_ABORT = bit 31 is negative).
"""
from __future__ import annotations

import dataclasses
import math
import os

import torch

from chroma_tpu.event import (NO_HIT, BULK_ABSORB, SURFACE_DETECT,
                              SURFACE_ABSORB, RAYLEIGH_SCATTER,
                              REFLECT_DIFFUSE, REFLECT_SPECULAR,
                              SURFACE_REEMIT, SURFACE_TRANSMIT, BULK_REEMIT,
                              NAN_ABORT, TERMINAL_FLAGS)
from chroma_tpu.geometry import (SURFACE_DEFAULT, SURFACE_COMPLEX,
                                 SURFACE_WLS, SURFACE_DICHROIC,
                                 SURFACE_ANGULAR)
from chroma_tpu_torch.ops import visit_kernel
from chroma_tpu_torch.ops.linalg import dot, cross, norm, normalize, rotate
from chroma_tpu_torch.ops.sample import sample_cdf_uniform_rows
from chroma_tpu_torch.ops.types import (MAT_REFRACTIVE_INDEX,
                                        MAT_ABSORPTION_LENGTH,
                                        MAT_SCATTERING_LENGTH, SURF_DETECT,
                                        SURF_ABSORB, SURF_REEMIT,
                                        SURF_REFLECT_DIFFUSE,
                                        SURF_REFLECT_SPECULAR, SURF_ETA,
                                        SURF_K, SURF_REEMISSION_CDF)
from chroma_tpu_torch.ops.wireplane import intersect_wireplanes

SPEED_OF_LIGHT = 299.792458  # mm/ns
PI = math.pi
WEIGHT_LOWER_THRESHOLD = 1e-4  # reference: photon.h:13

# renormalize default-surface probabilities so they sum to one and no
# photon silently PASSes (reference: photon.h:15-17, 979-994)
FORCE_SCATTER_AT_PASS = bool(int(
    os.environ.get('CHROMA_FORCE_SCATTER_AT_PASS', '0')))

# interaction-length traversal pruning (see propagate_step); set to 0 for
# exact reference NO_HIT semantics in open geometries
PRUNE_TRAVERSAL = bool(int(os.environ.get('CHROMA_PRUNE_TRAVERSAL', '1')))

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
    inside_to_outside: torch.Tensor  # (N,) bool


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


def _interp_rows(table, row, x, x0, dx):
    """Linear interpolation of `x` on a uniform grid, one table row per
    lane (reference: geometry.h:61-74). table: (R, n); row, x: (N,)."""
    n = table.shape[1]
    xf = (x - x0) / dx
    jl = torch.clamp(xf.to(torch.int32), 0, n - 2).to(torch.int64)
    frac = torch.clamp(xf - jl.to(torch.float32), 0.0, 1.0)
    row = row.to(torch.int64)
    lo = table[row, jl]
    hi = table[row, jl + 1]
    return lo + frac * (hi - lo)


def material_comp_property(materials, table, mat_idx, comp, wavelength):
    "Reemission component `comp`'s property of material `mat_idx`."
    m = materials
    flat = table.reshape(-1, table.shape[-1])
    return _interp_rows(flat, mat_idx * m.max_comp + comp, wavelength,
                        m.wavelength0, m.wavelength_step)


# ---------------------------------------------------------------------------
# fill_state: geometry query + boundary material resolution
# ---------------------------------------------------------------------------

def fill_state(photons, geometry, active, best_limit, pruned, pre_props,
               mrows):
    """Find each photon's next boundary and resolve the optical context
    (reference: photon.h:87-397), instanced-table branch plus the analytic
    wire planes. Lanes not in `active` are skipped. `best_limit`, `pruned`
    and `pre_props` (the current medium's (rindex, abslen, scatlen))
    implement the interaction-length pruning of propagate_step, and are
    None without it: a pruned miss means "no boundary before the bulk
    interaction", not NO_HIT. `mrows` is every material's properties at
    each photon's wavelength. Returns (photons', StepState)."""
    tri, dist, code, nvec, hit_iid, _ = visit_kernel.traverse(
        geometry.wide, photons.pos, photons.dir, photons.last_hit_triangle,
        mask=active, best_limit=best_limit)
    hit = tri >= 0
    if pruned is None:
        pruned = torch.zeros_like(hit)

    if geometry.has_wireplanes:
        wp = intersect_wireplanes(photons.pos, photons.dir, geometry, active)
        best = torch.where(hit, dist, 1e30)
        # surface-less wire planes are ignored, like the reference's
        # analytic_surface >= 0 gate (reference: photon.h:273-277)
        use_analytic = wp.hit & (wp.surface >= 0) & (wp.distance + 1e-6
                                                     < best)
        any_hit = hit | use_analytic
    else:
        wp = None
        use_analytic = None
        any_hit = hit

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
    inside_to_outside = ~outside

    if wp is not None:
        # an analytic wire hit overrides the mesh hit
        dist = torch.where(use_analytic, wp.distance, dist)
        normal = torch.where(use_analytic[:, None], wp.normal, normal)
        mat1 = torch.where(use_analytic, wp.material1, mat1)
        mat2 = torch.where(use_analytic, wp.material2, mat2)
        surf = torch.where(use_analytic, wp.surface, surf)
        inside_to_outside = torch.where(use_analytic, wp.inside_to_outside,
                                        inside_to_outside)

    mat1 = torch.where(any_hit, mat1, 0)
    mat2 = torch.where(any_hit, mat2, 0)

    m1p = select_rows(mrows, mat1)
    rindex1 = m1p[:, MAT_REFRACTIVE_INDEX]
    abslen = m1p[:, MAT_ABSORPTION_LENGTH]
    scatlen = m1p[:, MAT_SCATTERING_LENGTH]
    rindex2 = select_rows(mrows[:, :, MAT_REFRACTIVE_INDEX], mat2)

    if pre_props is not None:
        # lanes with a tracked medium keep the properties their interaction
        # distances were sampled from
        known = photons.cur_mat >= 0
        rindex1 = torch.where(known, pre_props[0], rindex1)
        abslen = torch.where(known, pre_props[1], abslen)
        scatlen = torch.where(known, pre_props[2], scatlen)
        mat1 = torch.where(known, photons.cur_mat, mat1)

    no_hit_now = active & ~any_hit & ~pruned
    flags = photons.flags | _flag(no_hit_now, NO_HIT)
    # a wire hit leaves no triangle: -2, which no triangle id or the
    # "none" marker -1 equals
    new_last = torch.where(hit, tri, -1)
    if wp is not None:
        new_last = torch.where(use_analytic, -2, new_last)
    last_hit = torch.where(active, new_last, photons.last_hit_triangle)
    photons = photons.replace(flags=flags, last_hit_triangle=last_hit)

    state = StepState(hit=active & (any_hit | pruned), distance=dist,
                      normal=normal, rindex1=rindex1, rindex2=rindex2,
                      absorption_length=abslen, scattering_length=scatlen,
                      material1=mat1, material2=mat2, surface=surf,
                      inside_to_outside=inside_to_outside)
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

def _reemission(photons, state, pool, m):
    """Bulk reemission draws (reference: photon.h:501-538): which
    component absorbed the photon, whether it reemits, and the reemitted
    wavelength, time delay, direction and polarization. Returns
    (reemits, wavelength, dt, dir, pol); `reemits` is not yet restricted
    to absorbed lanes."""
    mat = state.material1.to(torch.int64)
    num_comp = m.num_comp[mat]
    maxc = m.max_comp
    comp_abs = torch.stack(
        [material_comp_property(m, m.comp_absorption_length, mat, c,
                                photons.wavelength)
         for c in range(maxc)], dim=1)                       # (N, maxc)
    cum = torch.cumsum(state.absorption_length[:, None] / comp_abs, dim=1)
    u_comp = pool.draw()
    arange = torch.arange(maxc, device=mat.device)
    is_last = arange[None, :] == (num_comp - 1)[:, None]
    comp = torch.argmax(((u_comp[:, None] < cum) | is_last).to(torch.int32),
                        dim=1)
    reemit_prob = material_comp_property(m, m.comp_reemission_prob, mat,
                                         comp, photons.wavelength)
    u_reemit = pool.draw()
    reemits = (num_comp > 0) & (u_reemit < reemit_prob)

    comp_row = mat * maxc + comp
    wvl_flat = m.comp_reemission_wvl_cdf.reshape(-1, m.n_wavelength)
    wavelength = sample_cdf_uniform_rows(pool.draw(), wvl_flat, comp_row,
                                         m.wavelength0, m.wavelength_step)
    time_flat = m.comp_reemission_time_cdf.reshape(-1, m.n_time)
    dt = sample_cdf_uniform_rows(pool.draw(), time_flat, comp_row, m.time0,
                                 m.time_step)
    new_dir = pool.uniform_sphere()
    new_pol = _random_perpendicular_pol(pool, new_dir)
    return reemits, wavelength, dt, new_dir, new_pol


def propagate_to_boundary(photons, state, pool, u_abs, u_scat, materials,
                          use_weights=False, scatter_first=0):
    """Transport each photon to its absorption or scattering point or the
    boundary (reference: photon.h:455-570), with the absorption and
    scattering uniforms pre-drawn by propagate_step. An absorbed photon in
    a medium with reemission components may reemit.

    scatter_first (a host int) 1 forces a scatter before the boundary
    (truncated exponential), -1 forbids it (memoryless shift past the
    boundary), with the reference's weight factors; use_weights replaces
    bulk absorption by a survival weight. Returns (photons', command)."""
    d_bound = state.distance
    absorption_distance = -state.absorption_length * torch.log(u_abs)
    scattering_distance = -state.scattering_length * torch.log(u_scat)

    if use_weights:
        lane_weighted = photons.weight > WEIGHT_LOWER_THRESHOLD
        absorption_distance = torch.where(lane_weighted, 1e30,
                                          absorption_distance)
    weight = photons.weight
    u_force = pool.draw()
    if scatter_first == 1:
        scatter_prob = 1.0 - torch.exp(-d_bound / state.scattering_length)
        force = scatter_prob > WEIGHT_LOWER_THRESHOLD
        truncated = (-state.scattering_length
                     * torch.log1p(-u_force * scatter_prob))
        scattering_distance = torch.where(force, truncated,
                                          scattering_distance)
        weight = weight * torch.where(force, scatter_prob, 1.0)
    elif scatter_first == -1:
        no_scatter_prob = torch.exp(-d_bound / state.scattering_length)
        prevent = no_scatter_prob > WEIGHT_LOWER_THRESHOLD
        shifted = d_bound - state.scattering_length * torch.log(u_force)
        scattering_distance = torch.where(prevent, shifted,
                                          scattering_distance)
        weight = weight * torch.where(prevent, no_scatter_prob, 1.0)

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

    if materials.has_reemission:
        reemits, reemit_wl, reemit_dt, reemit_dir, reemit_pol = \
            _reemission(photons, state, pool, materials)
        reemits = absorbed & reemits
    else:
        reemits = None

    ray_dir, ray_pol = rayleigh_scatter(photons, pool)

    new_dir = torch.where(scattered[:, None], ray_dir, photons.dir)
    new_pol = torch.where(scattered[:, None], ray_pol, photons.pol)
    wavelength = photons.wavelength
    bulk_absorbed = absorbed
    flags = photons.flags
    if reemits is not None:
        new_dir = torch.where(reemits[:, None], reemit_dir, new_dir)
        new_pol = torch.where(reemits[:, None], reemit_pol, new_pol)
        wavelength = torch.where(reemits, reemit_wl, wavelength)
        new_t = new_t + torch.where(reemits, reemit_dt, 0.0)
        bulk_absorbed = absorbed & ~reemits
        flags = flags | _flag(reemits, BULK_REEMIT)
    flags = flags | _flag(bulk_absorbed, BULK_ABSORB)
    flags = flags | _flag(scattered, RAYLEIGH_SCATTER)

    if use_weights:
        # weight *= survival probability along the travelled distance
        surv = torch.exp(-step_dist / state.absorption_length)
        weight = weight * torch.where(lane_weighted & (scattered | passed),
                                      surv, 1.0)

    # the boundary triangle only remains "last hit" if we reached it
    last_hit = torch.where(passed, photons.last_hit_triangle, -1)

    command = torch.where(passed, PASS,
                          torch.where(bulk_absorbed, BREAK, CONTINUE))

    photons = photons.replace(pos=new_pos, dir=new_dir, pol=new_pol,
                              wavelength=wavelength, t=new_t, weight=weight,
                              flags=flags, last_hit_triangle=last_hit)
    return photons, command


# ---------------------------------------------------------------------------
# boundary / surface interactions
# ---------------------------------------------------------------------------

def _incident_geometry(photons, state):
    """Incidence and refraction angles, plane-of-incidence normal and
    s-polarization fraction (reference: photon.h:575-592, 760-773)."""
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


def _reflect_either(photons, state, pool, diffuse_mask):
    "Per-lane choice between diffuse and specular reflection."
    spec = _specular_reflect(photons, state)
    diff = _diffuse_reflect(photons, state, pool)
    return select(diffuse_mask, diff, spec)


def _weight_out_absorption(photons, absorb, *probs):
    """use_weights: on lanes that carry weight and can survive, multiply
    the weight by the survival probability 1 - absorb, renormalise the
    other probabilities and absorb nothing. Returns (weight, absorb,
    probs)."""
    lane = ((photons.weight > WEIGHT_LOWER_THRESHOLD)
            & (absorb < 1.0 - WEIGHT_LOWER_THRESHOLD))
    survive = 1.0 - absorb
    weight = torch.where(lane, photons.weight * survive, photons.weight)
    probs = [torch.where(lane, p / survive, p) for p in probs]
    return weight, torch.where(lane, 0.0, absorb), probs


def propagate_at_default_surface(photons, state, pool, sp,
                                 use_weights=False):
    """Default surface: roulette over detect/absorb/diffuse/specular with
    PASS for any residual (reference: photon.h:967-1035). `sp` is the
    (N,8) per-lane surface property row."""
    detect = sp[:, SURF_DETECT]
    absorb = sp[:, SURF_ABSORB]
    rdiff = sp[:, SURF_REFLECT_DIFFUSE]
    rspec = sp[:, SURF_REFLECT_SPECULAR]

    if FORCE_SCATTER_AT_PASS:
        # numerically enforce sum-to-one; the residual goes to specular
        # (reference: photon.h:980-994)
        total = detect + absorb + rdiff + rspec
        inv = 1.0 / torch.where(total > 0, total, 1.0)
        scale = torch.where(total > 0, inv, 1.0)
        detect = detect * scale
        absorb = absorb * scale
        rdiff = rdiff * scale
        rspec = rspec * scale
        rspec = rspec + (1.0 - (detect + absorb + rdiff + rspec))

    u = pool.draw()
    weight = photons.weight
    if use_weights:
        weight, absorb, (detect, rdiff, rspec) = _weight_out_absorption(
            photons, absorb, detect, rdiff, rspec)
        # the reference forces detection whenever weighting is on and the
        # surface can detect at all (photon.h:1010-1014)
        forced_detect = detect > 0.0
    else:
        forced_detect = torch.zeros_like(u, dtype=torch.bool)

    absorbs = u < absorb
    detects = ~absorbs & (u < absorb + detect)
    diffuses = ~absorbs & ~detects & (u < absorb + detect + rdiff)
    if FORCE_SCATTER_AT_PASS:
        # any rounding residual reflects specularly instead of passing
        speculars = ~absorbs & ~detects & ~diffuses
    else:
        speculars = (~absorbs & ~detects & ~diffuses
                     & (u < absorb + detect + rdiff + rspec))
    passes = ~absorbs & ~detects & ~diffuses & ~speculars

    absorbs = absorbs & ~forced_detect
    detects = (detects | forced_detect) & ~absorbs
    diffuses = diffuses & ~forced_detect
    speculars = speculars & ~forced_detect
    passes = passes & ~forced_detect

    if use_weights:
        weight = torch.where(forced_detect, weight * detect, weight)

    reflected = _reflect_either(photons, state, pool, diffuses)
    photons = select(diffuses | speculars, reflected, photons)

    flags = photons.flags
    flags = flags | _flag(detects, SURFACE_DETECT)
    flags = flags | _flag(absorbs, SURFACE_ABSORB)
    photons = photons.replace(flags=flags, weight=weight)

    command = torch.where(absorbs | detects, BREAK,
                          torch.where(passes, PASS, CONTINUE))
    return photons, command


def _film(r12, r23, t12, t23, g, u_, v_, e):
    """Reflection and transmission of a thin absorbing film between two
    media for one polarization (reference: photon.h:690-760). Squares are
    products: complex pow goes through exp/log and misses the integer
    power by ulps."""
    abs_r12, abs_r23 = torch.abs(r12), torch.abs(r23)
    abs_t12, abs_t23 = torch.abs(t12), torch.abs(t23)
    arg_r12, arg_r23 = torch.angle(r12), torch.angle(r23)
    sq_r12, sq_r23 = abs_r12 * abs_r12, abs_r23 * abs_r23
    exp1 = torch.exp(2.0 * v_ * e)
    exp2 = 1.0 / exp1
    denom = (exp1 + sq_r12 * sq_r23 * exp2
             + 2.0 * abs_r12 * abs_r23
             * torch.cos(arg_r23 + arg_r12 + 2.0 * u_ * e))
    r = (sq_r12 * exp1 + sq_r23 * exp2
         + 2.0 * abs_r12 * abs_r23
         * torch.cos(arg_r23 - arg_r12 + 2.0 * u_ * e)) / denom
    t = g.real * (abs_t12 * abs_t12) * (abs_t23 * abs_t23) / denom
    return r, t


def propagate_complex(photons, state, pool, sp, thickness, transmissive,
                      use_weights=False):
    """Thin-film "complex" PMT surface model: multilayer interference with
    a complex-index film, from the RAT PMT optical model
    (reference: photon.h:669-827)."""
    wl = photons.wavelength
    detect = sp[:, SURF_DETECT]
    rdiff = sp[:, SURF_REFLECT_DIFFUSE]
    zero = torch.zeros_like(wl)

    n1 = torch.complex(state.rindex1, zero)
    n2 = torch.complex(sp[:, SURF_ETA], sp[:, SURF_K])
    n3 = torch.complex(state.rindex2, zero)

    cos_t1 = torch.abs(dot(photons.dir, state.normal))
    theta = torch.arccos(torch.clamp(cos_t1, -1.0, 1.0))
    cos1 = torch.complex(torch.cos(theta), zero)
    sin1 = torch.complex(torch.sin(theta), zero)
    sin1_sq = sin1 * sin1

    e = 2.0 * PI * thickness / wl
    r13 = n1 / n3
    r12 = n1 / n2
    cos3 = torch.sqrt(1.0 - r13 * r13 * sin1_sq)
    cos2 = torch.sqrt(1.0 - r12 * r12 * sin1_sq)
    n2c2 = n2 * cos2
    u_, v_ = n2c2.real, n2c2.imag

    # s polarization
    s_n1c1, s_n2c2, s_n3c3 = n1 * cos1, n2c2, n3 * cos3
    s_r, s_t = _film((s_n1c1 - s_n2c2) / (s_n1c1 + s_n2c2),
                     (s_n2c2 - s_n3c3) / (s_n2c2 + s_n3c3),
                     2.0 * s_n1c1 / (s_n1c1 + s_n2c2),
                     2.0 * s_n2c2 / (s_n2c2 + s_n3c3),
                     s_n3c3 / s_n1c1, u_, v_, e)
    # p polarization
    p_n2c1, p_n3c2 = n2 * cos1, n3 * cos2
    p_n2c3, p_n1c2 = n2 * cos3, n1 * cos2
    p_r, p_t = _film((p_n2c1 - p_n1c2) / (p_n2c1 + p_n1c2),
                     (p_n3c2 - p_n2c3) / (p_n3c2 + p_n2c3),
                     2.0 * n1 * cos1 / (p_n2c1 + p_n1c2),
                     2.0 * n2 * cos2 / (p_n3c2 + p_n2c3),
                     (n3 * cos3) / (n1 * cos1), u_, v_, e)

    incident_angle, refracted_angle, tir, ipn, s_fraction = \
        _incident_geometry(photons, state)

    transmit = s_fraction * s_t + (1.0 - s_fraction) * p_t
    transmit = torch.where(transmissive, transmit, 0.0)
    reflect = s_fraction * s_r + (1.0 - s_fraction) * p_r
    absorb = 1.0 - transmit - reflect

    weight = photons.weight
    if use_weights:
        weight, absorb, (detect, reflect, transmit) = \
            _weight_out_absorption(photons, absorb, detect, reflect,
                                   transmit)
        forced_detect = detect > 0.0  # photon.h:793-797
        weight = torch.where(forced_detect, weight * detect, weight)
    else:
        forced_detect = torch.zeros_like(transmissive)

    u = pool.draw()
    absorbs = (u < absorb) & ~forced_detect
    u_det = pool.draw()
    detects = (absorbs & (u_det < detect)) | forced_detect
    absorbs = absorbs & ~detects

    reflects = (~absorbs & ~detects
                & ((u < absorb + reflect) | ~transmissive))
    transmits = ~absorbs & ~detects & ~reflects

    u_refl = pool.draw()
    diffuses = reflects & (u_refl < rdiff)

    reflected = _reflect_either(photons, state, pool, diffuses)
    photons = select(reflects, reflected, photons)

    safe_refr = torch.where(tir, 0.0, refracted_angle)
    transmit_dir = rotate(state.normal, PI - safe_refr, ipn)
    transmit_pol = normalize(cross(ipn, transmit_dir))
    photons = select(transmits,
                     photons.replace(dir=transmit_dir, pol=transmit_pol),
                     photons)

    flags = photons.flags
    flags = flags | _flag(detects | forced_detect, SURFACE_DETECT)
    flags = flags | _flag(absorbs, SURFACE_ABSORB)
    flags = flags | _flag(transmits, SURFACE_TRANSMIT)
    photons = photons.replace(flags=flags, weight=weight)

    command = torch.where(absorbs | detects, BREAK, CONTINUE)
    return photons, command


def propagate_at_wls(photons, state, pool, sp, surfaces, wl0, wl_step,
                     use_weights=False):
    """Wavelength-shifting surface: absorb and reemit at a shifted
    wavelength, or reflect, or transmit (reference: photon.h:829-874)."""
    s = torch.clamp(state.surface, min=0)
    absorb = sp[:, SURF_ABSORB]
    rspec = sp[:, SURF_REFLECT_SPECULAR]
    rdiff = sp[:, SURF_REFLECT_DIFFUSE]
    reemit = sp[:, SURF_REEMIT]

    weight = photons.weight
    if use_weights:
        weight, absorb, (rdiff, rspec) = _weight_out_absorption(
            photons, absorb, rdiff, rspec)

    u = pool.draw()
    absorbs = u < absorb
    u_reemit = pool.draw()
    reemits = absorbs & (u_reemit < reemit)
    absorbs_dead = absorbs & ~reemits
    reflects = ~absorbs & (u < absorb + rspec + rdiff)
    passes = ~absorbs & ~reflects

    # reemission: new wavelength from the surface CDF, isotropic direction
    cdf_flat = surfaces.props[:, SURF_REEMISSION_CDF, :]
    new_wl = sample_cdf_uniform_rows(pool.draw(), cdf_flat, s, wl0, wl_step)
    new_dir = pool.uniform_sphere()
    new_pol = _random_perpendicular_pol(pool, new_dir)
    photons = select(reemits,
                     photons.replace(wavelength=new_wl, dir=new_dir,
                                     pol=new_pol),
                     photons)

    # reflection: specular vs diffuse in proportion
    u_refl = pool.draw() * (rspec + rdiff)
    diffuses = reflects & (u_refl >= rspec)
    reflected = _reflect_either(photons, state, pool, diffuses)
    photons = select(reflects, reflected, photons)

    flags = photons.flags
    flags = flags | _flag(reemits, SURFACE_REEMIT)
    flags = flags | _flag(absorbs_dead, SURFACE_ABSORB)
    flags = flags | _flag(passes, SURFACE_TRANSMIT)
    photons = photons.replace(flags=flags, weight=weight)

    command = torch.where(absorbs_dead, BREAK,
                          torch.where(passes, PASS, CONTINUE))
    return photons, command


def _interp_angle_rows(angles, nangles, row, x):
    """Fractional index of incidence angle `x` in a per-row angle table
    padded with +inf (reference: interpolate.h interp_idx)."""
    table = angles[row]
    below = (table <= x[:, None]).to(torch.int64).sum(dim=1)
    iidx = torch.clamp(below - 1, min=0)
    iidx = torch.minimum(iidx, nangles[row].to(torch.int64) - 2)
    a_lo = table.gather(1, iidx[:, None])[:, 0]
    a_hi = table.gather(1, iidx[:, None] + 1)[:, 0]
    frac = torch.clamp((x - a_lo) / torch.where(a_hi > a_lo, a_hi - a_lo,
                                                1.0), 0.0, 1.0)
    return iidx, frac


def propagate_at_dichroic(photons, state, pool, geometry):
    """Dichroic filter: angle x wavelength reflect/transmit tables
    (reference: photon.h:877-907)."""
    surfaces = geometry.surfaces
    mats = geometry.materials
    s = torch.clamp(state.surface, min=0).to(torch.int64)
    didx = torch.clamp(surfaces.dichroic_index[s], min=0).to(torch.int64)

    incident_angle = get_theta(state.normal, -photons.dir)
    iidx, frac = _interp_angle_rows(surfaces.dichroic_angles,
                                    surfaces.dichroic_nangles, didx,
                                    incident_angle)

    n_ang = surfaces.dichroic_angles.shape[1]
    refl_flat = surfaces.dichroic_reflect.reshape(-1, mats.n_wavelength)
    trans_flat = surfaces.dichroic_transmit.reshape(-1, mats.n_wavelength)
    row_lo = didx * n_ang + iidx
    wl = photons.wavelength

    def lerp(flat):
        lo = _interp_rows(flat, row_lo, wl, mats.wavelength0,
                          mats.wavelength_step)
        hi = _interp_rows(flat, row_lo + 1, wl, mats.wavelength0,
                          mats.wavelength_step)
        return lo + (hi - lo) * frac

    reflect_prob = lerp(refl_flat)
    transmit_prob = lerp(trans_flat)

    u = pool.draw()
    reflects = u < reflect_prob
    transmits = ~reflects & (u < reflect_prob + transmit_prob)
    absorbs = ~reflects & ~transmits

    photons = select(reflects, _specular_reflect(photons, state), photons)
    flags = photons.flags
    flags = flags | _flag(transmits, SURFACE_TRANSMIT)
    flags = flags | _flag(absorbs, SURFACE_ABSORB)
    photons = photons.replace(flags=flags)

    command = torch.where(absorbs, BREAK,
                          torch.where(transmits, PASS, CONTINUE))
    return photons, command


def propagate_at_angular(photons, state, pool, surfaces,
                         use_weights=False):
    """Angular-table surface: transmit/reflect probabilities by incidence
    angle (reference: photon.h:909-951)."""
    s = torch.clamp(state.surface, min=0).to(torch.int64)
    aidx = torch.clamp(surfaces.angular_index[s], min=0).to(torch.int64)

    incident_angle = get_theta(state.normal, -photons.dir)
    iidx, frac = _interp_angle_rows(surfaces.angular_angles,
                                    surfaces.angular_nangles, aidx,
                                    incident_angle)

    def lerp(table):
        lo = table[aidx, iidx]
        hi = table[aidx, iidx + 1]
        return lo + frac * (hi - lo)

    transmit_prob = lerp(surfaces.angular_transmit)
    rspec_prob = lerp(surfaces.angular_reflect_specular)
    rdiff_prob = lerp(surfaces.angular_reflect_diffuse)
    absorb_prob = 1.0 - transmit_prob - rspec_prob - rdiff_prob

    weight = photons.weight
    if use_weights:
        weight, absorb_prob, (transmit_prob, rspec_prob, rdiff_prob) = \
            _weight_out_absorption(photons, absorb_prob, transmit_prob,
                                   rspec_prob, rdiff_prob)

    u = pool.draw()
    absorbs = u < absorb_prob
    transmits = ~absorbs & (u < absorb_prob + transmit_prob)
    speculars = (~absorbs & ~transmits
                 & (u < absorb_prob + transmit_prob + rspec_prob))
    diffuses = ~absorbs & ~transmits & ~speculars

    reflected = _reflect_either(photons, state, pool, diffuses)
    photons = select(speculars | diffuses, reflected, photons)

    flags = photons.flags
    flags = flags | _flag(absorbs, SURFACE_ABSORB)
    flags = flags | _flag(transmits, SURFACE_TRANSMIT)
    photons = photons.replace(flags=flags, weight=weight)

    command = torch.where(absorbs, BREAK,
                          torch.where(transmits, PASS, CONTINUE))
    return photons, command


def propagate_at_surface(photons, state, pool, geometry, use_weights=False):
    """Dispatch over the five surface models (reference:
    photon.h:953-1037). Every model present in the geometry is evaluated
    for every lane, in the JAX order, and each lane keeps the result of
    its own surface's model."""
    surfaces = geometry.surfaces
    mats = geometry.materials
    wl0, wl_step = mats.wavelength0, mats.wavelength_step
    sidx = torch.clamp(state.surface, min=0).to(torch.int64)
    model = surfaces.model[sidx]
    thickness = surfaces.thickness[sidx]
    transmissive = surfaces.transmissive[sidx] != 0

    srows = wavelength_lerp_rows(surfaces.props_wl, photons.wavelength,
                                 wl0, wl_step)
    sp = select_rows(srows, sidx)                   # (N,8)

    present = surfaces.models_present
    out_ph = photons
    out_cmd = torch.full((len(photons),), PASS, dtype=torch.int64,
                         device=sidx.device)
    if SURFACE_DEFAULT in present:
        out_ph, out_cmd = propagate_at_default_surface(
            photons, state, pool, sp, use_weights)
    specials = []
    if SURFACE_COMPLEX in present:
        specials.append((SURFACE_COMPLEX, propagate_complex(
            photons, state, pool, sp, thickness, transmissive,
            use_weights)))
    if SURFACE_WLS in present:
        specials.append((SURFACE_WLS, propagate_at_wls(
            photons, state, pool, sp, surfaces, wl0, wl_step,
            use_weights)))
    if SURFACE_DICHROIC in present:
        specials.append((SURFACE_DICHROIC, propagate_at_dichroic(
            photons, state, pool, geometry)))
    if SURFACE_ANGULAR in present:
        specials.append((SURFACE_ANGULAR, propagate_at_angular(
            photons, state, pool, surfaces, use_weights)))
    for model_id, (ph_m, cmd_m) in specials:
        is_m = model == model_id
        out_ph = select(is_m, ph_m, out_ph)
        out_cmd = torch.where(is_m, cmd_m, out_cmd)
    return out_ph, out_cmd


# ---------------------------------------------------------------------------
# one full step
# ---------------------------------------------------------------------------

def propagate_step(photons, geometry, pool, use_weights=False,
                   scatter_first=0, prune=True):
    """One propagation step for the whole batch (reference:
    chroma/cuda/propagate.cu:300-338), drawing from the DrawPool `pool`.
    Termination is recorded in the history flags.

    The absorption and scattering uniforms are drawn before the geometry
    query. With `prune` (and no weights, and CHROMA_PRUNE_TRAVERSAL on),
    for lanes whose medium is tracked (cur_mat >= 0) the sampled
    interaction distance bounds the BVH traversal; the biasing modes need
    the true boundary distance, so propagate() turns pruning off for
    scatter_first, as chroma_tpu.ops.propagate does."""
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

    prune = prune and not use_weights and PRUNE_TRAVERSAL
    mrows = wavelength_lerp_rows(mats.props_wl, photons.wavelength,
                                 mats.wavelength0, mats.wavelength_step)
    if prune:
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
    else:
        pre_props = pruned = limit = None

    photons, state = fill_state(photons, geometry, active, limit, pruned,
                                pre_props, mrows)
    active = active & state.hit

    moved, cmd_bulk = propagate_to_boundary(photons, state, pool, u_abs,
                                            u_scat, mats, use_weights,
                                            scatter_first)
    photons = select(active, moved, photons)
    at_boundary = active & (cmd_bulk == PASS)

    has_surface = state.surface != -1
    surf_lanes = at_boundary & has_surface
    ph_surf, cmd_surf = propagate_at_surface(photons, state, pool, geometry,
                                             use_weights)
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
