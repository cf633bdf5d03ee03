"""The reference's photon transport: Chroma's physics as plain torch.

One photon at a time in effect, vectorised over the live photons: find
the nearest surface, draw absorption and Rayleigh scattering distances
in the current medium, move, then at a surface play its roulette
(absorb, detect, diffuse or specular reflection, else pass) and at a
bare boundary Fresnel's polarised reflection or refraction. History
flags are Chroma's bits. The arithmetic runs in the scene's dtype, so
float32 is the reference and bfloat16 the lower-precision control.
"""
from __future__ import annotations

import math

import torch

from bench_h100.reference import scene as sc

NO_HIT = 1 << 0
BULK_ABSORB = 1 << 1
SURFACE_DETECT = 1 << 2
SURFACE_ABSORB = 1 << 3
RAYLEIGH_SCATTER = 1 << 4
REFLECT_DIFFUSE = 1 << 5
REFLECT_SPECULAR = 1 << 6
TERMINAL = NO_HIT | BULK_ABSORB | SURFACE_DETECT | SURFACE_ABSORB
REDIRECTS = RAYLEIGH_SCATTER | REFLECT_DIFFUSE | REFLECT_SPECULAR
SPEED_OF_LIGHT = 299.792458  # mm/ns


def _unit(x):
    return x / torch.clamp(x.norm(dim=-1, keepdim=True), min=1e-30)


def _dot(a, b):
    return (a * b).sum(-1)


def _frame(axis):
    "Two unit vectors completing `axis` (N, 3) to an orthonormal frame."
    helper = torch.zeros_like(axis)
    small = axis[:, 0].abs() < 0.9
    helper[:, 0] = torch.where(small, 1.0, 0.0).to(axis.dtype)
    helper[:, 1] = torch.where(small, 0.0, 1.0).to(axis.dtype)
    a = _unit(torch.linalg.cross(axis, helper))
    return a, torch.linalg.cross(axis, a)


def _around(axis, cos_t, phi):
    "Directions at polar angle acos(cos_t), azimuth phi about `axis`."
    a, b = _frame(axis)
    sin_t = torch.sqrt(torch.clamp(1 - cos_t * cos_t, min=0))
    return _unit(cos_t[:, None] * axis
                 + (sin_t * torch.cos(phi))[:, None] * a
                 + (sin_t * torch.sin(phi))[:, None] * b)


def _uniform(gen, n, dev, dt):
    "U(0, 1] draws."
    return (1.0 - torch.rand(n, generator=gen, device=dev)).to(dt)


def _perp_pol(gen, direction):
    "A polarisation uniformly around `direction`."
    n = direction.shape[0]
    phi = 2 * math.pi * torch.rand(n, generator=gen, device=direction.device)
    a, b = _frame(direction)
    phi = phi.to(direction.dtype)
    return _unit(torch.cos(phi)[:, None] * a + torch.sin(phi)[:, None] * b)


def rayleigh(gen, direction, pol):
    """A dipole's scattering: the new direction at angle theta from the
    old polarisation with density sin^2(theta), the new polarisation the
    old one's part perpendicular to the new direction."""
    n = direction.shape[0]
    dev, dt = direction.device, direction.dtype
    u = torch.rand(n, generator=gen, device=dev)
    # inverse of the cdf (2 + 3x - x^3) / 4 of x = cos(theta)
    cos_t = 2 * torch.cos((torch.arccos(1 - 2 * u) - 2 * math.pi) / 3)
    cos_t = torch.clamp(cos_t, -1, 1).to(dt)
    phi = (2 * math.pi * torch.rand(n, generator=gen, device=dev)).to(dt)
    new_dir = _around(pol, cos_t, phi)
    new_pol = pol - cos_t[:, None] * new_dir
    flat = new_pol.norm(dim=1) < 1e-6
    new_pol = torch.where(flat[:, None], _perp_pol(gen, new_dir), new_pol)
    return new_dir, _unit(new_pol)


def fresnel(gen, direction, pol, normal, n1, n2):
    """Chroma's boundary: s or p polarisation chosen by the share of the
    polarisation across the plane of incidence, reflection with that
    polarisation's Fresnel coefficient (always past the critical angle),
    else refraction by Snell's law. `normal` faces the incoming photon.
    Returns (dir, pol, reflected)."""
    n = direction.shape[0]
    dev, dt = direction.device, direction.dtype
    cos_i = torch.clamp(-_dot(direction, normal), 0, 1)
    sin_i = torch.sqrt(torch.clamp(1 - cos_i * cos_i, min=0))
    eta = n1 / n2
    sin_t = sin_i * eta
    tir = sin_t > 1
    cos_t = torch.sqrt(torch.clamp(1 - sin_t * sin_t, min=0))
    ipn = torch.linalg.cross(direction, normal)
    ipn_len = ipn.norm(dim=1)
    head_on = ipn_len < 1e-6
    ipn = torch.where(head_on[:, None], pol,
                      ipn / torch.where(head_on, 1.0, ipn_len)[:, None])
    s_frac = _dot(pol, ipn) ** 2
    s_pol = torch.rand(n, generator=gen, device=dev).to(dt) < s_frac
    r_s = (n1 * cos_i - n2 * cos_t) / (n1 * cos_i + n2 * cos_t)
    r_p = (n2 * cos_i - n1 * cos_t) / (n2 * cos_i + n1 * cos_t)
    r = torch.where(s_pol, r_s, r_p)
    reflects = (torch.rand(n, generator=gen, device=dev).to(dt) < r * r) | tir
    refl = direction + 2 * cos_i[:, None] * normal
    trans = eta[:, None] * direction + (eta * cos_i - cos_t)[:, None] * normal
    new_dir = _unit(torch.where(reflects[:, None], refl, trans))
    p_pol = _unit(torch.linalg.cross(ipn, new_dir))
    new_pol = torch.where(s_pol[:, None], ipn, p_pol)
    return new_dir, new_pol, reflects


def _cosine_hemisphere(gen, normal):
    n = normal.shape[0]
    dev, dt = normal.device, normal.dtype
    u1 = torch.rand(n, generator=gen, device=dev)
    phi = (2 * math.pi * torch.rand(n, generator=gen, device=dev)).to(dt)
    return _around(normal, torch.sqrt(u1).to(dt), phi)


def propagate(scene, photons, gen, max_steps=1000):
    """Transport `photons` (a dict of (N, ...) tensors: pos, dir, pol, t,
    medium (int64)) to termination or `max_steps` steps. Returns the end
    state: pos, dir, pol, t, flags, last_hit (global triangle or
    -1), steps (the steps each photon took)."""
    dt = scene.dtype
    dev = photons['pos'].device
    n = photons['pos'].shape[0]
    st = dict(pos=photons['pos'].to(dt).clone(),
              dir=photons['dir'].to(dt).clone(),
              pol=photons['pol'].to(dt).clone(),
              t=photons['t'].to(dt).clone(),
              medium=photons['medium'].clone().long(),
              flags=torch.zeros(n, dtype=torch.int64, device=dev),
              last=torch.full((n,), -1, dtype=torch.int64, device=dev),
              steps=torch.zeros(n, dtype=torch.int64, device=dev))
    mats = scene.t_materials.to(dt)
    surfs = scene.t_surfaces
    live = torch.arange(n, device=dev)
    for _ in range(max_steps):
        if live.numel() == 0:
            break
        s = {k: v[live] for k, v in st.items()}
        m = live.numel()
        hit = sc.query(scene, s['pos'], s['dir'], excl=s['last'])
        n1 = mats[s['medium'], 0]
        d_abs = -mats[s['medium'], 1] * torch.log(_uniform(gen, m, dev, dt))
        d_scat = -mats[s['medium'], 2] * torch.log(_uniform(gen, m, dev, dt))
        d_hit = hit.t.to(dt)
        absorbed = (d_abs <= d_scat) & (d_abs <= d_hit)
        scattered = ~absorbed & (d_scat <= d_hit)
        missed = ~absorbed & ~scattered & torch.isinf(hit.t)
        boundary = ~absorbed & ~scattered & ~missed
        dist = torch.where(absorbed, d_abs, torch.where(scattered, d_scat,
                                                        d_hit))
        dist = torch.where(missed, torch.zeros_like(dist), dist)
        pos = s['pos'] + dist[:, None] * s['dir']
        t = s['t'] + dist * n1 / SPEED_OF_LIGHT
        flags = s['flags'] | torch.where(missed, NO_HIT, 0) \
            | torch.where(absorbed, BULK_ABSORB, 0) \
            | torch.where(scattered, RAYLEIGH_SCATTER, 0)
        last = torch.where(boundary, hit.tri, -1)
        direction, pol, medium = s['dir'], s['pol'], s['medium']

        sdir, spol = rayleigh(gen, direction, pol)
        direction = torch.where(scattered[:, None], sdir, direction)
        pol = torch.where(scattered[:, None], spol, pol)

        # the boundary's sides as the photon meets it
        face = hit.normal.to(dt)
        outside = _dot(face, -direction) > 0
        normal = torch.where(outside[:, None], face, -face)
        m1 = torch.where(outside, hit.m_out, hit.m_in)
        m2 = torch.where(outside, hit.m_in, hit.m_out)
        has_surf = boundary & (hit.surf >= 0)
        props = surfs[torch.clamp(hit.surf, min=0)]
        u = torch.rand(m, generator=gen, device=dev)
        detect, absorb = props[:, 0], props[:, 1]
        rdiff, rspec = props[:, 2], props[:, 3]
        s_abs = has_surf & (u < absorb)
        s_det = has_surf & ~s_abs & (u < absorb + detect)
        s_dif = has_surf & ~s_abs & ~s_det & (u < absorb + detect + rdiff)
        s_spe = (has_surf & ~s_abs & ~s_det & ~s_dif
                 & (u < absorb + detect + rdiff + rspec))
        s_pass = has_surf & ~s_abs & ~s_det & ~s_dif & ~s_spe
        flags = flags | torch.where(s_abs, SURFACE_ABSORB, 0) \
            | torch.where(s_det, SURFACE_DETECT, 0) \
            | torch.where(s_dif, REFLECT_DIFFUSE, 0) \
            | torch.where(s_spe, REFLECT_SPECULAR, 0)
        ddir = _cosine_hemisphere(gen, normal)
        dpol = _perp_pol(gen, ddir)
        direction_s = torch.where(s_dif[:, None], ddir, direction)
        pol_s = torch.where(s_dif[:, None], dpol, pol)
        cos_i = -_dot(direction, normal)
        mirror = _unit(direction + 2 * cos_i[:, None] * normal)
        direction_s = torch.where(s_spe[:, None], mirror, direction_s)

        bare = boundary & ((hit.surf < 0) | s_pass)
        fdir, fpol, frefl = fresnel(gen, direction, pol, normal,
                                    mats[torch.clamp(m1, min=0), 0],
                                    mats[torch.clamp(m2, min=0), 0])
        direction = torch.where(bare[:, None], fdir, direction_s)
        pol = torch.where(bare[:, None], fpol, pol_s)
        flags = flags | torch.where(bare & frefl, REFLECT_SPECULAR, 0)
        crossed = boundary & (_dot(direction, normal) < 0)
        medium = torch.where(crossed, m2, torch.where(boundary, m1, medium))

        for k, v in (('pos', pos), ('dir', direction), ('pol', pol),
                     ('t', t), ('flags', flags), ('last', last),
                     ('medium', medium), ('steps', s['steps'] + 1)):
            st[k][live] = v
        live = live[(flags & TERMINAL) == 0]
    return st
