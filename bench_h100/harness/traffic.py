"""The benchmark's one event generator: photon bombs and charged tracks'
light made on the device from the seed, as a traffic mix
(traffic/<mix>.json) and a configuration's vertex region describe them."""
from __future__ import annotations

import math

import numpy as np
import torch

EVENT_SITE = 0xB0B
SPEED_OF_LIGHT_MM_NS = 299.792458


def stream_seed(*parts):
    "A 63-bit torch seed from non-negative ints (any size)."
    state = np.random.SeedSequence([int(p) % (1 << 64) for p in parts]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(device, *parts):
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(*parts))
    return gen


def vertex(region, gen, device):
    "One point uniform in the region: a ball about the origin or a box."
    if 'ball_radius_mm' in region:
        r = region['ball_radius_mm'] * float(
            torch.rand((), generator=gen, device=device)) ** (1 / 3)
        d = torch.randn(3, generator=gen, device=device, dtype=torch.float64)
        return (d / d.norm() * r).float()
    half = torch.tensor(region['box_half_mm'], dtype=torch.float64,
                        device=device)
    u = torch.rand(3, generator=gen, device=device, dtype=torch.float64)
    return ((2 * u - 1) * half).float()


def bomb(mix, cfg, seed, index, device):
    """Event `index` of seed `seed`: an isotropic bomb of mix['photons']
    photons at mix['wavelength_nm'] from a vertex in the configuration's
    region, as a dict of (N, ...) device tensors (pos, dir, pol, t,
    wavelength, medium)."""
    gen = generator(device, seed, EVENT_SITE, index)
    n = int(mix['photons'])
    v = vertex(cfg['vertex_region'], gen, device)
    d = torch.randn((n, 3), generator=gen, device=device)
    d = d / d.norm(dim=1, keepdim=True)
    pol = torch.linalg.cross(torch.randn((n, 3), generator=gen,
                                         device=device), d)
    pol = pol / pol.norm(dim=1, keepdim=True)
    return dict(pos=v.expand(n, 3).contiguous(), dir=d, pol=pol,
                t=torch.zeros(n, device=device),
                wavelength=torch.full((n,), float(mix['wavelength_nm']),
                                      device=device),
                medium=torch.full((n,), int(cfg['vertex_medium']),
                                  dtype=torch.int64, device=device))


def direction(gen, device):
    "One direction uniform on the sphere (float64)."
    d = torch.randn(3, generator=gen, device=device, dtype=torch.float64)
    return d / d.norm()


def track(mix, vertex, axis, medium, gen, device):
    """The light of a charged track: mix['photons'] photons from points
    uniform along mix['track_mm'] of `axis` from `vertex`, at the angle
    whose cosine is mix['cos_cherenkov'] to the track, uniform in
    azimuth, polarised in the plane of the track and the photon, each
    emitted when the particle (at the speed of light) reaches its point,
    in `medium`; a dict of (N, ...) device tensors like bomb's."""
    n = int(mix['photons'])
    dt = torch.float64
    along = torch.rand(n, generator=gen, device=device, dtype=dt) \
        * float(mix['track_mm'])
    phi = 2 * math.pi * torch.rand(n, generator=gen, device=device,
                                   dtype=dt)
    axis = axis.to(device, dt)
    helper = torch.tensor([1.0, 0.0, 0.0] if abs(float(axis[0])) < 0.9
                          else [0.0, 1.0, 0.0], dtype=dt, device=device)
    a = torch.linalg.cross(axis, helper)
    a = a / a.norm()
    b = torch.linalg.cross(axis, a)
    cos = float(mix['cos_cherenkov'])
    sin = math.sqrt(1.0 - cos * cos)
    d = cos * axis + sin * (torch.cos(phi)[:, None] * a
                            + torch.sin(phi)[:, None] * b)
    pol = axis - cos * d
    pol = pol / pol.norm(dim=1, keepdim=True)
    pos = vertex.to(device, dt) + along[:, None] * axis
    return dict(pos=pos.float(), dir=d.float(), pol=pol.float(),
                t=(along / SPEED_OF_LIGHT_MM_NS).float(),
                wavelength=torch.full((n,), float(mix['wavelength_nm']),
                                      device=device),
                medium=torch.full((n,), int(medium),
                                  dtype=torch.int64, device=device))


def sample(n_total, k, seed, site, device='cpu'):
    "k distinct indices of range(n_total) drawn from the seed (sorted)."
    gen = generator('cpu', seed, site)
    k = min(k, n_total)
    return torch.randperm(n_total, generator=gen)[:k].sort().values.to(device)


def p95(values):
    """The 95th percentile by nearest rank: the smallest value with at
    least 95% of the values at or below it."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]
