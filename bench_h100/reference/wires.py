"""The reference's wire planes: analytic wires beside the meshes.

A wire plane is a periodic array of parallel cylinders: the wires run
along u, lie at v = v0 + k * pitch for the integers k with vmin <= v <=
vmax, and are `radius` thick about the plane n = 0; a hit counts where
its u lies in [umin, umax]. Photons that end on a wire report the
triangle WIRE_TRI.

`wire_query` finds the nearest wire hit over all planes in float64 (in
the scene's dtype where that is below float32: the bfloat16 control),
testing every wire of a plane's extent that the ray's chord through the
slab |n| <= radius can reach, with no cap on their number: each about
the ray's closest approach to the wire's axis. `query` is the scene's
nearest hit with the wires in it, and `propagate`, `path_checks`,
`single_leg_breaks` and `tally_z` are reference/physics.py's transport
and reference/judge.py's readings with wires: the same physics and the
same checks, the wire being one more absorbing surface.

The counts the metric readers need come from the transport: the steps
each photon takes, the steps whose ray reaches a plane's slab before its
mesh hit (`wire_steps`), and the wires within the slab chords of each
step's ray over the whole ray (`k3_wires`), the wires a walk that does
not know the mesh hit has to test. Nothing here imports the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from bench_h100.reference import judge as jd
from bench_h100.reference import physics as ph
from bench_h100.reference import scene as sc

WIRE_TRI = -2          # the triangle a photon ended on a wire reports
CANDIDATES = 1 << 22   # (ray, wire) pairs tested at once


class WirePlane:
    """One plane: origin, the wires' axis u and the in-plane v (unit,
    orthogonal; n = u x v), pitch, radius, extents, v0, the surface and
    the inner (wire) and outer materials, as indices of the scene's
    tables."""

    def __init__(self, origin, u, v, pitch, radius, umin, umax, vmin, vmax,
                 surface, m_in, m_out, v0=0.0):
        u = np.asarray(u, np.float64)
        v = np.asarray(v, np.float64)
        self.u = u / np.linalg.norm(u)
        v = v - (v @ self.u) * self.u
        self.v = v / np.linalg.norm(v)
        self.n = np.cross(self.u, self.v)
        self.origin = np.asarray(origin, np.float64)
        self.pitch, self.radius = float(pitch), float(radius)
        self.umin, self.umax = float(umin), float(umax)
        self.vmin, self.vmax, self.v0 = float(vmin), float(vmax), float(v0)
        self.kmin = math.ceil((self.vmin - self.v0) / self.pitch)
        self.kmax = math.floor((self.vmax - self.v0) / self.pitch)
        self.surface, self.m_in, self.m_out = int(surface), int(m_in), \
            int(m_out)


class WireScene(sc.Scene):
    "A Scene that also holds wire planes."

    def __init__(self, *args, planes=(), **kwargs):
        super().__init__(*args, **kwargs)
        self.planes = list(planes)

    def to(self, device, dtype=torch.float32):
        super().to(device, dtype)
        self.wire_dtype = torch.float64 if dtype in (torch.float32,
                                                     torch.float64) else dtype
        return self


def _frame(scene, p, o, d):
    "(wu, wv, wn, du, dv, dn) of rays (o, d) in plane p's frame."
    wdt = scene.wire_dtype

    def vec(a):
        return torch.as_tensor(a, dtype=wdt, device=o.device)
    q = o.to(wdt) - vec(p.origin)
    dd = d.to(wdt)
    u, v, n = vec(p.u), vec(p.v), vec(p.n)
    return ((q * u).sum(-1), (q * v).sum(-1) - p.v0, (q * n).sum(-1),
            (dd * u).sum(-1), (dd * v).sum(-1), (dd * n).sum(-1))


def windows(scene, p, frame, tmin, tmax, exact=False):
    """The wires of plane p each ray's chord through the slab |n| <=
    radius can reach, within the plane's u extent and tmin < t < tmax:
    (first k, count) per ray, count 0 where none. Unless `exact` (a
    count), the bounds widen by a part in 1e6 and a wire on each side, so
    rounding never narrows them: the test of each wire decides."""
    wu, wv, wn, du, dv, dn = (x.double() for x in frame)
    r = p.radius
    inf = torch.full_like(wu, math.inf)
    flat_n = dn.abs() < 1e-12
    sn = torch.where(flat_n, torch.ones_like(dn), dn)
    ta, tb = (-r - wn) / sn, (r - wn) / sn
    lo = torch.where(flat_n, -inf, torch.minimum(ta, tb))
    hi = torch.where(flat_n, inf, torch.maximum(ta, tb))
    open_ = ~flat_n | (wn.abs() <= r)
    flat_u = du.abs() < 1e-12
    su = torch.where(flat_u, torch.ones_like(du), du)
    ua, ub = (p.umin - wu) / su, (p.umax - wu) / su
    lo = torch.maximum(lo, torch.where(flat_u, -inf, torch.minimum(ua, ub)))
    hi = torch.minimum(hi, torch.where(flat_u, inf, torch.maximum(ua, ub)))
    open_ &= ~flat_u | ((wu >= p.umin) & (wu <= p.umax))
    lo = torch.maximum(lo, torch.as_tensor(tmin, dtype=lo.dtype,
                                           device=lo.device))
    hi = torch.minimum(hi, tmax.double())
    if not exact:
        pad = 1e-6 * (lo.abs() + hi.abs()).nan_to_num(posinf=0.0) + 1e-6
        lo, hi = lo - pad, hi + pad
    open_ &= hi >= lo
    kmin = torch.full_like(wu, float(p.kmin))
    kmax = torch.full_like(wu, float(p.kmax))
    va = wv + dv * torch.where(torch.isfinite(lo), lo, 0.0)
    vb = wv + dv * torch.where(torch.isfinite(hi), hi, 0.0)
    # an endless chord (a ray in the slab's plane) reaches every wire
    endless = ~(torch.isfinite(lo) & torch.isfinite(hi)) & (dv != 0)
    if exact:
        k_lo = torch.ceil((torch.minimum(va, vb) - r) / p.pitch)
        k_hi = torch.floor((torch.maximum(va, vb) + r) / p.pitch)
    else:
        k_lo = torch.floor((torch.minimum(va, vb) - r) / p.pitch) - 1
        k_hi = torch.ceil((torch.maximum(va, vb) + r) / p.pitch) + 1
    k_lo = torch.where(endless, kmin, torch.maximum(k_lo, kmin))
    k_hi = torch.where(endless, kmax, torch.minimum(k_hi, kmax))
    count = torch.where(open_ & (k_hi >= k_lo), k_hi - k_lo + 1, 0.0)
    return k_lo.long(), count.long()


def chord_wires(scene, o, d, tmin=sc.T_MIN, tmax=None):
    """Wires within each ray's slab chords, summed over the planes (N,)
    int64: the whole ray, or up to tmax."""
    n = o.shape[0]
    if tmax is None:
        tmax = torch.full((n,), math.inf, device=o.device)
    total = torch.zeros(n, dtype=torch.int64, device=o.device)
    for p in scene.planes:
        total += windows(scene, p, _frame(scene, p, o, d), tmin, tmax,
                         exact=True)[1]
    return total


def wire_query(scene, o, d, tmin=sc.T_MIN, tmax=None):
    """Nearest wire hit of rays (o, d) over all planes with tmin < t <
    tmax: (t (N,) f32, inf where none; plane (N,) int64, -1 where none;
    the outward normal at the hit (N, 3) f32)."""
    n = o.shape[0]
    dev = o.device
    wdt = scene.wire_dtype
    if tmax is None:
        tmax = torch.full((n,), math.inf, device=dev)
    best = torch.full((n,), math.inf, dtype=torch.float64, device=dev)
    plane = torch.full((n,), -1, dtype=torch.int64, device=dev)
    normal = torch.zeros((n, 3), dtype=torch.float64, device=dev)
    for ip, p in enumerate(scene.planes):
        frame = _frame(scene, p, o, d)
        k_lo, count = windows(scene, p, frame, tmin, tmax)
        rays = torch.nonzero(count > 0)[:, 0]
        if rays.numel() == 0:
            continue
        cum = torch.cumsum(count[rays], 0)
        cuts = torch.searchsorted(
            cum, torch.arange(CANDIDATES, int(cum[-1]) + CANDIDATES,
                              CANDIDATES, device=dev), right=True).tolist()
        a = 0
        for b in cuts:
            b = max(b, a + 1)
            part = rays[a:b]
            a = b
            reps = count[part]
            ray = torch.repeat_interleave(part, reps)
            start = torch.cumsum(reps, 0) - reps
            k = k_lo[ray] + (torch.arange(ray.numel(), device=dev)
                             - torch.repeat_interleave(start, reps))
            t, ev, en = _wire_test(p, [x[ray] for x in frame], k, tmin,
                                   tmax[ray], wdt)
            win = torch.full((n,), math.inf, dtype=torch.float64,
                             device=dev)
            win.scatter_reduce_(0, ray, t, reduce='amin')
            closer = win < best
            take = (t == win[ray]) & closer[ray] & torch.isfinite(t)
            nv, nn = ev[take], en[take]
            length = torch.sqrt(nv * nv + nn * nn).clamp(min=1e-300)
            v = torch.as_tensor(p.v, dtype=torch.float64, device=dev)
            w = torch.as_tensor(p.n, dtype=torch.float64, device=dev)
            normal[ray[take]] = (nv / length)[:, None] * v \
                + (nn / length)[:, None] * w
            plane = torch.where(closer, ip, plane)
            best = torch.where(closer, win, best)
            if a >= rays.numel():
                break
        if a < rays.numel():
            raise RuntimeError('wire candidates left untested')
    return best.float(), plane, normal.float()


def _wire_test(p, frame, k, tmin, tmax, wdt):
    """Distance along each (ray, wire k) pair to where the ray enters the
    wire (leaves it, from inside): about the closest approach t0 of the
    ray to the wire's axis, the offsets (ev, en) there and the half-chord
    sqrt((r^2 - d^2) / a). Returns (t f64, inf where none; the hit's
    offsets from the axis along v and n, f64)."""
    wu, wv0, wn, du, dv, dn = frame
    r2 = p.radius * p.radius
    wv = wv0 - k.to(wdt) * p.pitch
    a = dv * dv + dn * dn
    safe = torch.where(a > 0, a, torch.ones_like(a))
    t0 = -(wv * dv + wn * dn) / safe
    ev, en = wv + dv * t0, wn + dn * t0
    d2 = ev * ev + en * en
    half = torch.sqrt(torch.clamp((r2 - d2) / safe, min=0))
    outside = wv * wv + wn * wn > r2
    t = torch.where(outside, t0 - half, t0 + half)
    uc = wu + du * t
    ok = (a > 0) & (d2 <= r2) & (t > tmin) & (t < tmax.to(wdt)) \
        & (uc >= p.umin) & (uc <= p.umax)
    t = torch.where(ok, t, torch.full_like(t, math.inf)).double()
    return t, (wv + dv * t).double(), (wn + dn * t).double()


def query(scene, o, d, excl=None, tmax=None, tmin=sc.T_MIN):
    """The nearest hit of rays (o, d), meshes and wires: scene.query's Hit
    where no wire is nearer, else the wire's (triangle WIRE_TRI, its
    outward normal, the plane's materials and surface)."""
    return with_wires(scene, sc.query(scene, o, d, excl=excl, tmax=tmax,
                                      tmin=tmin), o, d, tmin)


def with_wires(scene, hit, o, d, tmin=sc.T_MIN):
    "The mesh Hit `hit` of rays (o, d) with the wires nearer than it."
    if not scene.planes:
        return hit
    t, plane, normal = wire_query(scene, o, d, tmin=tmin, tmax=hit.t)
    wire = plane >= 0
    ip = torch.clamp(plane, min=0)

    def table(attr):
        return torch.as_tensor([getattr(p, attr) for p in scene.planes],
                               dtype=torch.int64, device=o.device)[ip]
    return sc.Hit(t=torch.where(wire, t, hit.t),
                  tri=torch.where(wire, WIRE_TRI, hit.tri),
                  normal=torch.where(wire[:, None], normal, hit.normal),
                  m_in=torch.where(wire, table('m_in'), hit.m_in),
                  m_out=torch.where(wire, table('m_out'), hit.m_out),
                  surf=torch.where(wire, table('surface'), hit.surf))


def wire_gap(scene, pos):
    """Distance (f64) from points (N, 3) to the nearest wire surface over
    the planes (inf outside every plane's u extent)."""
    best = torch.full((pos.shape[0],), math.inf, dtype=torch.float64,
                      device=pos.device)
    p64 = pos.double()
    for p in scene.planes:
        def vec(a):
            return torch.as_tensor(a, dtype=torch.float64, device=pos.device)
        q = p64 - vec(p.origin)
        wu, wv, wn = (q * vec(p.u)).sum(-1), (q * vec(p.v)).sum(-1) - p.v0, \
            (q * vec(p.n)).sum(-1)
        k = torch.clamp(torch.round(wv / p.pitch), p.kmin, p.kmax)
        gap = (torch.sqrt((wv - k * p.pitch) ** 2 + wn ** 2) - p.radius).abs()
        inside = (wu >= p.umin) & (wu <= p.umax)
        best = torch.minimum(best, torch.where(inside, gap, math.inf))
    return best


# -- the transport with wires (reference/physics.py's loop) ------------------

def propagate(scene, photons, gen, max_steps=1000):
    """physics.propagate with wires: the same state, draws and physics, the
    nearest hit from `query`. The end state also holds, per photon, the
    steps whose ray reached a wire plane's slab before its mesh hit
    (wire_steps) and the wires within the slab chords of its steps' rays
    (k3_wires)."""
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
              steps=torch.zeros(n, dtype=torch.int64, device=dev),
              wire_steps=torch.zeros(n, dtype=torch.int64, device=dev),
              k3_wires=torch.zeros(n, dtype=torch.int64, device=dev))
    mats = scene.t_materials.to(dt)
    surfs = scene.t_surfaces
    live = torch.arange(n, device=dev)
    for _ in range(max_steps):
        if live.numel() == 0:
            break
        s = {k: v[live] for k, v in st.items()}
        m = live.numel()
        mesh = sc.query(scene, s['pos'], s['dir'], excl=s['last'])
        reach = chord_wires(scene, s['pos'], s['dir'], tmax=mesh.t) > 0
        k3 = chord_wires(scene, s['pos'], s['dir'])
        hit = with_wires(scene, mesh, s['pos'], s['dir'])
        n1 = mats[s['medium'], 0]
        d_abs = -mats[s['medium'], 1] * torch.log(ph._uniform(gen, m, dev,
                                                              dt))
        d_scat = -mats[s['medium'], 2] * torch.log(ph._uniform(gen, m, dev,
                                                               dt))
        d_hit = hit.t.to(dt)
        absorbed = (d_abs <= d_scat) & (d_abs <= d_hit)
        scattered = ~absorbed & (d_scat <= d_hit)
        missed = ~absorbed & ~scattered & torch.isinf(hit.t)
        boundary = ~absorbed & ~scattered & ~missed
        dist = torch.where(absorbed, d_abs, torch.where(scattered, d_scat,
                                                        d_hit))
        dist = torch.where(missed, torch.zeros_like(dist), dist)
        pos = s['pos'] + dist[:, None] * s['dir']
        t = s['t'] + dist * n1 / ph.SPEED_OF_LIGHT
        flags = s['flags'] | torch.where(missed, ph.NO_HIT, 0) \
            | torch.where(absorbed, ph.BULK_ABSORB, 0) \
            | torch.where(scattered, ph.RAYLEIGH_SCATTER, 0)
        last = torch.where(boundary, hit.tri, -1)
        direction, pol, medium = s['dir'], s['pol'], s['medium']

        sdir, spol = ph.rayleigh(gen, direction, pol)
        direction = torch.where(scattered[:, None], sdir, direction)
        pol = torch.where(scattered[:, None], spol, pol)

        face = hit.normal.to(dt)
        outside = ph._dot(face, -direction) > 0
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
        flags = flags | torch.where(s_abs, ph.SURFACE_ABSORB, 0) \
            | torch.where(s_det, ph.SURFACE_DETECT, 0) \
            | torch.where(s_dif, ph.REFLECT_DIFFUSE, 0) \
            | torch.where(s_spe, ph.REFLECT_SPECULAR, 0)
        ddir = ph._cosine_hemisphere(gen, normal)
        dpol = ph._perp_pol(gen, ddir)
        direction_s = torch.where(s_dif[:, None], ddir, direction)
        pol_s = torch.where(s_dif[:, None], dpol, pol)
        cos_i = -ph._dot(direction, normal)
        mirror = ph._unit(direction + 2 * cos_i[:, None] * normal)
        direction_s = torch.where(s_spe[:, None], mirror, direction_s)

        bare = boundary & ((hit.surf < 0) | s_pass)
        fdir, fpol, frefl = ph.fresnel(gen, direction, pol, normal,
                                       mats[torch.clamp(m1, min=0), 0],
                                       mats[torch.clamp(m2, min=0), 0])
        direction = torch.where(bare[:, None], fdir, direction_s)
        pol = torch.where(bare[:, None], fpol, pol_s)
        flags = flags | torch.where(bare & frefl, ph.REFLECT_SPECULAR, 0)
        crossed = boundary & (ph._dot(direction, normal) < 0)
        medium = torch.where(crossed, m2, torch.where(boundary, m1, medium))

        for k, v in (('pos', pos), ('dir', direction), ('pol', pol),
                     ('t', t), ('flags', flags), ('last', last),
                     ('medium', medium), ('steps', s['steps'] + 1),
                     ('wire_steps', s['wire_steps'] + reach.long()),
                     ('k3_wires', s['k3_wires'] + k3)):
            st[k][live] = v
        live = live[(flags & ph.TERMINAL) == 0]
    return st


# -- the judge's readings with wires (reference/judge.py's) ------------------

def path_checks(scene, start, end):
    """judge.path_checks with wires: a photon that reports WIRE_TRI must
    end within the gap of a wire's surface, and that surface must do
    what its flag says; every ray query sees the wires."""
    flags, pos, d = end['flags'].long(), end['pos'].float(), end['dir'].float()
    t = end['t'].float()
    p0, d0, t0 = start['pos'].float(), start['dir'].float(), start['t'].float()
    surfs = scene.t_surfaces
    terminal = (flags & ph.TERMINAL) != 0
    surf_end = jd._flag(flags, ph.SURFACE_DETECT | ph.SURFACE_ABSORB)
    surf_end = surf_end & terminal
    bulk = jd._flag(flags, ph.BULK_ABSORB) & ~surf_end
    redirected = jd._flag(flags, ph.REDIRECTS)

    last = end['last'].long()
    gap = torch.full_like(t, math.inf)
    props = torch.zeros((len(t), 4), device=t.device)
    on_mesh = surf_end & (last >= 0)
    if bool(on_mesh.any()):
        idx = torch.nonzero(on_mesh)[:, 0]
        gap[idx] = jd.triangle_distance(scene, last[idx], pos[idx])
        surf = scene.triangle_props(last[idx])[2]
        props[idx] = torch.where((surf >= 0)[:, None],
                                 surfs[torch.clamp(surf, min=0)], 0.0)
    on_wire = surf_end & (last == WIRE_TRI)
    if bool(on_wire.any()):
        idx = torch.nonzero(on_wire)[:, 0]
        gap[idx] = wire_gap(scene, pos[idx]).float()
        near = _nearest_plane(scene, pos[idx])
        props[idx] = surfs[near]
    kind_ok = torch.where(jd._flag(flags, ph.SURFACE_DETECT),
                          props[:, 0] > 0, props[:, 1] > 0)
    end_gap = float(gap[surf_end].max()) if bool(surf_end.any()) else 0.0
    faults = surf_end & ~(kind_ok & (gap < jd.TOL_MM))

    # the first straight leg
    first = query(scene, p0, d0)
    v = pos - p0
    along = (v * d0).sum(-1)
    perp = (v - along[:, None] * d0).norm(dim=1)
    straight = ~redirected & (perp < jd.TOL_PERP_MM) & (along > -jd.TOL_MM)
    ends_first = straight & surf_end & ((first.t - along).abs() < jd.TOL_MM)
    in_bulk = straight & bulk & (along <= first.t + jd.TOL_MM)
    bare_first = (first.surf < 0) & torch.isfinite(first.t) \
        & (first.t < along + jd.TOL_MM)
    unturned = ~redirected & (surf_end | bulk)
    faults |= unturned & ~(ends_first | in_bulk | bare_first)

    # the last leg of a surface-ended photon that turned
    back = query(scene, pos, -d, excl=last, tmin=jd.BACK_TMIN_MM)
    bp = surfs[torch.clamp(back.surf, min=0)]
    bare = torch.isfinite(back.t) & ((back.surf < 0)
                                     | (bp.sum(-1) < 1 - 1e-6))
    mirror = (back.surf >= 0) & (bp[:, 3] > 0) \
        & jd._flag(flags, ph.REFLECT_SPECULAR)
    diffuse = (back.surf >= 0) & (bp[:, 2] > 0) \
        & jd._flag(flags, ph.REFLECT_DIFFUSE)
    scattered = jd._flag(flags, ph.RAYLEIGH_SCATTER)
    turned_ok = bare | mirror | diffuse | scattered
    faults |= surf_end & ~ends_first & ~turned_ok

    # times of straight photons
    rindex = scene.t_materials[start['medium'].long(), 0]
    timed = ends_first | (straight & bulk & (along < first.t - jd.TOL_MM))
    dt = (t - t0 - along * rindex / ph.SPEED_OF_LIGHT).abs()
    faults |= timed & (dt > jd.TOL_NS)
    counts = dict(photons=int(flags.shape[0]), surface=int(surf_end.sum()),
                  on_wire=int(on_wire.sum()), straight=int(timed.sum()),
                  faults=int(faults.sum()),
                  time_gap_ns=float(dt[timed].max()) if bool(timed.any())
                  else 0.0)
    return int(faults.sum()), end_gap, counts


def _nearest_plane(scene, pos):
    "The surface index of the plane nearest each point (along its n)."
    dist = torch.stack([
        ((pos.double() - torch.as_tensor(p.origin, device=pos.device))
         @ torch.as_tensor(p.n, device=pos.device)).abs()
        for p in scene.planes], 1)
    surf = torch.as_tensor([p.surface for p in scene.planes],
                           dtype=torch.int64, device=pos.device)
    return surf[dist.argmin(1)]


def single_leg_breaks(scene, start, end):
    """judge.single_leg_breaks with wires: the way back from the end point
    stops at a wire as at any surface that stops every photon."""
    flags = end['flags'].long()
    ended = ((flags & ph.TERMINAL) != 0) & jd._flag(
        flags, ph.SURFACE_DETECT | ph.SURFACE_ABSORB | ph.BULK_ABSORB)
    once = ended & jd._flag(flags, ph.RAYLEIGH_SCATTER) \
        & ~jd._flag(flags, ph.REFLECT_DIFFUSE | ph.REFLECT_SPECULAR)
    out = torch.zeros_like(once)
    idx = torch.nonzero(once)[:, 0]
    if idx.numel() == 0:
        return out
    pos, d = end['pos'][idx].double(), end['dir'][idx].double()
    p0 = start['pos'][idx].double()
    n = scene.t_materials[start['medium'][idx].long(), 0].double()
    length = (end['t'][idx].double() - start['t'][idx].double()) \
        * ph.SPEED_OF_LIGHT / n
    w = pos - p0
    ww = (w * w).sum(-1)
    gap = length - (w * d).sum(-1)
    safe = torch.where(gap > 0, gap, torch.ones_like(gap))
    leg = (length * length - ww) / (2 * safe)
    slack = jd.TOL_LEG_MM + jd.DL_MM * (length - leg).abs() / safe
    on_surface = jd._flag(flags[idx], ph.SURFACE_DETECT | ph.SURFACE_ABSORB)
    excl = torch.where(on_surface, end['last'][idx].long(), sc.NO_TRI)
    o, back_d = end['pos'][idx].float(), -end['dir'][idx].float()
    behind = torch.zeros(len(idx), dtype=torch.float64, device=o.device)
    stops = torch.zeros(len(idx), dtype=torch.bool, device=o.device)
    open_ = torch.ones_like(stops)
    for _ in range(jd.BACK_CROSSINGS):
        hit = query(scene, o, back_d, excl=excl, tmin=jd.BACK_TMIN_MM)
        found = open_ & torch.isfinite(hit.t)
        props = scene.t_surfaces[torch.clamp(hit.surf, min=0)]
        stop = found & (hit.surf >= 0) & (props.sum(-1) >= 1 - 1e-6)
        behind = torch.where(found, behind + hit.t.double(), behind)
        stops |= stop
        open_ = found & ~stop
        o = torch.where(found[:, None], o + hit.t[:, None] * back_d, o)
        excl = torch.where(found, hit.tri, excl)
        if not bool(open_.any()):
            break
    crosses = stops & (gap > 0) & (leg > behind + slack)
    too_fast = length < ww.sqrt() - jd.DL_MM
    out[idx] = crosses | too_fast
    return out


def tally_z(a, b):
    """judge.tally_z and one more history class: photons that ended on a
    wire (absorbed there, reporting WIRE_TRI)."""
    z = jd.tally_z(a, b)
    na, nb = a['flags'].shape[0], b['flags'].shape[0]

    def wired(side):
        return int(((side['last'].long() == WIRE_TRI)
                    & jd._flag(side['flags'].long(),
                               ph.SURFACE_ABSORB)).sum())
    ka, kb = wired(a), wired(b)
    if ka + kb >= jd.MIN_TALLY:
        p = (ka + kb) / (na + nb)
        sd = math.sqrt(p * (1 - p) * (1 / na + 1 / nb))
        if sd > 0:
            z = max(z, abs(ka / na - kb / nb) / sd)
    return z
