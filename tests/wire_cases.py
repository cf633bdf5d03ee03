"""Wire-plane cases and the float64 wire solve they are held to, shared by
the CPU tests of the wire walk (tests/test_torch_wire_kernel.py,
tests/test_torch_wireplane.py and the step tests) and the card tests of K3
(tests/test_torch_cuda.py). Imports neither JAX nor chroma_tpu.

`f64_walk` is the nearest wire hit over all planes in float64, from the
port's own f32 plane arrays: every wire of each plane is solved about
the ray's closest approach to its axis (Chroma's f64 formulation,
photon.h:115-135), with no candidate window. Where the JAX package's f32
quadratic and the port disagree, this decides.
"""
import numpy as np
import torch

from chroma_tpu_torch.geometry import (Geometry, Material, Solid, Surface,
                                       WirePlane, vacuum)
from chroma_tpu_torch.make import box

T_MIN = 1e-4    # the walk's self-hit epsilon, mm


def microboone_planes(half=1000.0):
    """Three absorbing anode planes at MicroBooNE's pitch and wire size
    (U/V at +-60 degrees, Y at 0, 3 mm apart at z = 0, 3, 6 mm; 3 mm
    pitch, 0.075 mm radius, 2 * half square) in an 8 m liquid-argon box."""
    lar = Material('lar')
    lar.set('refractive_index', 1.38)
    lar.set('absorption_length', 1e6)
    lar.set('scattering_length', 1e6)
    metal = Material('metal')
    metal.set('refractive_index', 1.5)
    metal.set('absorption_length', 1e-3)
    metal.set('scattering_length', 1e6)
    wire = Surface('wire')
    wire.set('absorb', 1.0)
    geo = Geometry(vacuum)
    geo.add_solid(Solid(box(8000.0, 8000.0, 8000.0), lar, vacuum))
    for i, deg in enumerate((60.0, -60.0, 0.0)):
        a = np.radians(deg)
        geo.add_wireplane(WirePlane(
            origin=(0.0, 0.0, 3.0 * i), u=(np.cos(a), np.sin(a), 0.0),
            v=(-np.sin(a), np.cos(a), 0.0), pitch=3.0, radius=0.075,
            umin=-half, umax=half, vmin=-half, vmax=half, surface=wire,
            material_inner=metal, material_outer=lar))
    geo.flatten()
    return geo


def far_rays(n, seed=7):
    """Rays that start 0.5 m to 3 m from the planes of microboone_planes,
    on either side, aimed at points spread over them and the gaps
    between: (pos, dir) f32 arrays."""
    rs = np.random.RandomState(seed)
    dist = rs.uniform(500.0, 3000.0, n)
    side = np.where(rs.rand(n) < 0.5, -1.0, 1.0)
    pos = np.column_stack([rs.uniform(-800.0, 800.0, (n, 2)),
                           3.0 + side * dist])
    aim = np.column_stack([rs.uniform(-900.0, 900.0, (n, 2)),
                           rs.uniform(-1.0, 7.0, n)])
    d = aim - pos
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return pos.astype(np.float32), d.astype(np.float32)


def f64_walk(pos, direction, wireplanes, active=None, chunk=256):
    """The nearest wire hit over all planes, in float64: (t, plane, vn, nn,
    clearance) numpy arrays per ray, t = inf and plane = -1 without a
    hit; (vn, nn) the hit point's offsets from the hit wire's axis; the
    clearance is the smallest |closest approach - radius| over every
    wire of every plane (how near the ray comes to grazing one)."""
    wp = wireplanes
    pos = torch.as_tensor(np.asarray(pos), dtype=torch.float64)
    d = torch.as_tensor(np.asarray(direction), dtype=torch.float64)
    n = pos.shape[0]
    best = torch.full((n,), np.inf, dtype=torch.float64)
    plane = torch.full((n,), -1, dtype=torch.int64)
    vn = torch.zeros(n, dtype=torch.float64)
    nn = torch.zeros(n, dtype=torch.float64)
    clear = torch.full((n,), np.inf, dtype=torch.float64)
    for ip in range(wp.pitch.shape[0]):
        def f(x):
            return x[ip].double()
        o, u, v, w = f(wp.origin), f(wp.u), f(wp.v), f(wp.w)
        pitch, r = float(wp.pitch[ip]), float(wp.radius[ip])
        v0 = float(wp.v0[ip])
        kmin = np.ceil((float(wp.vmin[ip]) - v0) / pitch)
        kmax = np.floor((float(wp.vmax[ip]) - v0) / pitch)
        q = pos - o
        wu, wv0, wn = q @ u, q @ v - v0, q @ w
        du, dv, dn = d @ u, d @ v, d @ w
        a = dv * dv + dn * dn
        safe = torch.where(a > 0, a, torch.ones_like(a))[:, None]
        for ks in torch.split(torch.arange(kmin, kmax + 1,
                                           dtype=torch.float64), chunk):
            wv = wv0[:, None] - ks[None] * pitch
            t0 = -(wv * dv[:, None] + wn[:, None] * dn[:, None]) / safe
            ev = wv + dv[:, None] * t0
            en = wn[:, None] + dn[:, None] * t0
            d2 = ev * ev + en * en
            clear = torch.minimum(clear, (d2.sqrt() - r).abs().min(1).values)
            half = torch.sqrt(torch.clamp((r * r - d2) / safe, min=0))
            outside = wv * wv + wn[:, None] ** 2 > r * r
            t = torch.where(outside, t0 - half, t0 + half)
            uc = wu[:, None] + du[:, None] * t
            ok = (a[:, None] > 0) & (d2 <= r * r) & (t > T_MIN) \
                & (uc >= float(wp.umin[ip])) & (uc <= float(wp.umax[ip]))
            t = torch.where(ok, t, np.inf)
            tk, kk = t.min(1)
            closer = tk < best
            rows = torch.arange(n)
            hit_vn = (wv + dv[:, None] * t)[rows, kk]
            hit_nn = (wn[:, None] + dn[:, None] * t)[rows, kk]
            best = torch.where(closer, tk, best)
            plane = torch.where(closer, ip, plane)
            vn = torch.where(closer, hit_vn, vn)
            nn = torch.where(closer, hit_nn, nn)
    if active is not None:
        active = torch.as_tensor(np.asarray(active))
        best = torch.where(active, best, np.inf)
        plane = torch.where(active, plane, -1)
    return (best.numpy(), plane.numpy(), vn.numpy(), nn.numpy(),
            clear.numpy())


def decided_by_f64(jax_t, port_t, pos, direction, wireplanes):
    """Rays (a step's start) on which the JAX package's wire test and the
    port's disagree and float64 sides with the port: a side agrees with
    float64 when both miss, or both hit at distances within 1e-5 of each
    other (relative, 1e-6 mm absolute). `jax_t` and `port_t` are each
    side's nearest wire distance, inf without a hit (numpy)."""
    t64 = f64_walk(np.asarray(pos), np.asarray(direction), wireplanes)[0]

    def agrees(t):
        t = np.asarray(t, np.float64)
        both = np.isfinite(t) & np.isfinite(t64)
        close = np.abs(np.where(both, t - t64, 0.0)) \
            <= 1e-5 * np.abs(np.where(both, t64, 0.0)) + 1e-6
        return np.where(both, close, np.isinf(t) & np.isinf(t64))
    return agrees(port_t) & ~agrees(jax_t)
