"""The comparison that decides `correct`: the numbers read from what the
timed path produced, against the reference.

Four kinds of reading, each one number with a limit of its own:

* path_faults -- photons whose end state no path in the reference's
  geometry allows: a photon that ended on a surface must end on the one
  it reports (its triangle id) within TOL_MM of it, and that surface
  must do what its flag says (detect, absorb); a photon that was never
  scattered or reflected must
  not have passed a surface that would have stopped it on its first
  straight leg (the reference's nearest hit from its start); the last
  leg of a photon that ended on a surface must start where something
  turned it (a bare boundary, a mirror it was flagged to have met, a
  scatter); the time of a photon that went straight from its start to
  its end must be its path over the medium's speed;
* end_gap_mm -- the widest distance between a surface-ended photon's end
  point and the surface it reports;
* tally_z -- the widest z of the share of photons in each history class
  (detected, absorbed on a surface or in the bulk, scattered, reflected,
  never ended; the scattered photons by how they ended; the scattered
  photons whose last leg cannot be the one leg after a single scatter,
  `single_leg_breaks`) and of the detected photons' mean time, between
  the program and the reference's own transport of the same photons;
* daq_time_gap_ns, daq_charge_gap -- the widest gap, over channels,
  between the program's readout and the reference's readout of the
  program's photons (a channel hit on one side only reads inf).
"""
from __future__ import annotations

import math

import torch

from bench_h100.reference import physics as ph
from bench_h100.reference import scene as sc

BACK_TMIN_MM = 0.01  # a surface this near an end point is its own edge
TOL_MM = 0.05        # a leg's length, an end point's gap may differ by this
TOL_PERP_MM = 0.05   # a straight photon lies this near its first ray
TOL_NS = 1e-3        # a straight photon's time may differ by this much
MIN_TALLY = 20       # classes with fewer photons on both sides are left out
TOL_LEG_MM = 1.0     # a single scatter's leg may reach this far past a surface
DL_MM = 0.5          # path a time may overstate (glass at water's speed)
BACK_CROSSINGS = 4   # bare boundaries a last leg is followed back through


def _flag(flags, bit):
    return (flags & bit) != 0


def path_checks(scene, start, end):
    """(path_faults, end_gap_mm, counts) of photons whose
    start (pos, dir, t, medium) and end (pos, dir, t, flags, last) are
    given as (S, ...) tensors on the scene's device."""
    flags, pos, d = end['flags'].long(), end['pos'].float(), end['dir'].float()
    t = end['t'].float()
    p0, d0, t0 = start['pos'].float(), start['dir'].float(), start['t'].float()
    surfs = scene.t_surfaces
    terminal = (flags & ph.TERMINAL) != 0
    surf_end = _flag(flags, ph.SURFACE_DETECT | ph.SURFACE_ABSORB)
    surf_end = surf_end & terminal
    bulk = _flag(flags, ph.BULK_ABSORB) & ~surf_end
    redirected = _flag(flags, ph.REDIRECTS)

    # the surface the photon claims to have ended on: the triangle whose
    # id it reports (the reference's triangles are the program's, in its
    # order)
    last = end['last'].long()
    gap = torch.full_like(t, math.inf)
    props = torch.zeros((len(t), 4), device=t.device)
    on_mesh = surf_end & (last >= 0)
    if bool(on_mesh.any()):
        idx = torch.nonzero(on_mesh)[:, 0]
        gap[idx] = triangle_distance(scene, last[idx], pos[idx])
        surf = scene.triangle_props(last[idx])[2]
        props[idx] = torch.where((surf >= 0)[:, None],
                                 surfs[torch.clamp(surf, min=0)], 0.0)
    kind_ok = torch.where(_flag(flags, ph.SURFACE_DETECT), props[:, 0] > 0,
                          props[:, 1] > 0)
    end_gap = float(gap[surf_end].max()) if bool(surf_end.any()) else 0.0
    faults = surf_end & ~(kind_ok & (gap < TOL_MM))

    # the first straight leg
    first = sc.query(scene, p0, d0)
    v = pos - p0
    along = (v * d0).sum(-1)
    perp = (v - along[:, None] * d0).norm(dim=1)
    straight = ~redirected & (perp < TOL_PERP_MM) & (along > -TOL_MM)
    ends_first = straight & surf_end & ((first.t - along).abs() < TOL_MM)
    in_bulk = straight & bulk & (along <= first.t + TOL_MM)
    bare_first = (first.surf < 0) & torch.isfinite(first.t) \
        & (first.t < along + TOL_MM)
    unturned = ~redirected & (surf_end | bulk)
    faults |= unturned & ~(ends_first | in_bulk | bare_first)

    # the last leg of a surface-ended photon that turned: from its end
    # point backwards, its own triangle left out
    back = sc.query(scene, pos, -d, excl=last, tmin=BACK_TMIN_MM)
    bp = surfs[torch.clamp(back.surf, min=0)]
    bare = torch.isfinite(back.t) & ((back.surf < 0)
                                     | (bp.sum(-1) < 1 - 1e-6))
    mirror = (back.surf >= 0) & (bp[:, 3] > 0) \
        & _flag(flags, ph.REFLECT_SPECULAR)
    diffuse = (back.surf >= 0) & (bp[:, 2] > 0) \
        & _flag(flags, ph.REFLECT_DIFFUSE)
    scattered = _flag(flags, ph.RAYLEIGH_SCATTER)
    turned_ok = bare | mirror | diffuse | scattered
    faults |= surf_end & ~ends_first & ~turned_ok

    # times of straight photons
    rindex = scene.t_materials[start['medium'].long(), 0]
    timed = ends_first | (straight & bulk & (along < first.t - TOL_MM))
    dt = (t - t0 - along * rindex / ph.SPEED_OF_LIGHT).abs()
    faults |= timed & (dt > TOL_NS)
    counts = dict(photons=int(flags.shape[0]), surface=int(surf_end.sum()),
                  straight=int(timed.sum()), faults=int(faults.sum()),
                  time_gap_ns=float(dt[timed].max()) if bool(timed.any())
                  else 0.0)
    return int(faults.sum()), end_gap, counts


def triangle_distance(scene, tri, p):
    "Distance (f64) from points p (N, 3) to global triangles `tri`."
    v0, e1, e2 = (x.double() for x in scene.triangle_world(tri))
    p = p.double()
    a, b, c = v0, v0 + e1, v0 + e2
    n = torch.linalg.cross(e1, e2)
    n = n / torch.clamp(n.norm(dim=1, keepdim=True), min=1e-300)
    plane = ((p - a) * n).sum(-1)
    q = p - plane[:, None] * n
    inside = torch.ones_like(plane, dtype=torch.bool)
    for u, w in ((a, b), (b, c), (c, a)):
        inside &= (torch.linalg.cross(w - u, q - u) * n).sum(-1) >= 0
    edge = torch.full_like(plane, math.inf)
    for u, w in ((a, b), (b, c), (c, a)):
        seg = w - u
        s = torch.clamp(((p - u) * seg).sum(-1)
                        / torch.clamp((seg * seg).sum(-1), min=1e-300), 0, 1)
        edge = torch.minimum(edge, (p - u - s[:, None] * seg).norm(dim=1))
    return torch.where(inside, plane.abs(), edge).float()


def single_leg_breaks(scene, start, end):
    """Photons that ended on a surface or in the bulk after a scatter and no
    reflection, whose last leg cannot be the one leg after a single scatter:
    their time (the path's length at the start medium's speed) puts that
    scatter beyond the first surface behind the end point that stops every
    photon (followed back through bare boundaries), or is shorter than the
    straight way. A photon scattered once lies on that leg; one scattered
    twice, or bent by a boundary, may not, so the reference's own
    transport is read the same way and only the shares are compared
    (tally_z)."""
    flags = end['flags'].long()
    ended = ((flags & ph.TERMINAL) != 0) & _flag(
        flags, ph.SURFACE_DETECT | ph.SURFACE_ABSORB | ph.BULK_ABSORB)
    once = ended & _flag(flags, ph.RAYLEIGH_SCATTER) \
        & ~_flag(flags, ph.REFLECT_DIFFUSE | ph.REFLECT_SPECULAR)
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
    slack = TOL_LEG_MM + DL_MM * (length - leg).abs() / safe
    on_surface = _flag(flags[idx], ph.SURFACE_DETECT | ph.SURFACE_ABSORB)
    excl = torch.where(on_surface, end['last'][idx].long(), sc.NO_TRI)
    # backwards to the first surface that stops every photon, through
    # bare boundaries (a photon may have crossed them, bent a little)
    o, back_d = end['pos'][idx].float(), -end['dir'][idx].float()
    behind = torch.zeros(len(idx), dtype=torch.float64, device=o.device)
    stops = torch.zeros(len(idx), dtype=torch.bool, device=o.device)
    open_ = torch.ones_like(stops)
    for _ in range(BACK_CROSSINGS):
        hit = sc.query(scene, o, back_d, excl=excl, tmin=BACK_TMIN_MM)
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
    too_fast = length < ww.sqrt() - DL_MM
    out[idx] = crosses | too_fast
    return out


def tally_z(a, b):
    """The widest |z| between two transports of the same photons, each a
    dict of flags, t and leg (single_leg_breaks): each history class's
    share (two binomials) and the detected photons' mean time."""
    def classes(side):
        f = side['flags'].long()
        scat = _flag(f, ph.RAYLEIGH_SCATTER)
        return [_flag(f, ph.SURFACE_DETECT), _flag(f, ph.SURFACE_ABSORB),
                _flag(f, ph.BULK_ABSORB), scat,
                _flag(f, ph.REFLECT_SPECULAR), _flag(f, ph.REFLECT_DIFFUSE),
                _flag(f, ph.NO_HIT), (f & ph.TERMINAL) == 0,
                scat & _flag(f, ph.SURFACE_DETECT),
                scat & _flag(f, ph.SURFACE_ABSORB),
                scat & _flag(f, ph.BULK_ABSORB),
                scat & _flag(f, ph.NO_HIT), side['leg']]
    na, nb = a['flags'].shape[0], b['flags'].shape[0]
    zs = []
    for ca, cb in zip(classes(a), classes(b)):
        ka, kb = int(ca.sum()), int(cb.sum())
        if ka + kb < MIN_TALLY:
            continue
        p = (ka + kb) / (na + nb)
        sd = math.sqrt(p * (1 - p) * (1 / na + 1 / nb))
        zs.append(abs(ka / na - kb / nb) / sd if sd > 0 else 0.0)
    da = _flag(a['flags'].long(), ph.SURFACE_DETECT)
    db = _flag(b['flags'].long(), ph.SURFACE_DETECT)
    if int(da.sum()) >= MIN_TALLY and int(db.sum()) >= MIN_TALLY:
        ta, tb = a['t'][da].double(), b['t'][db].double()
        se = math.sqrt(float(ta.var()) / len(ta) + float(tb.var()) / len(tb))
        if se > 0:
            zs.append(abs(float(ta.mean() - tb.mean())) / se)
    return max(zs) if zs else 0.0


def daq_gaps(prog, ref, unit):
    """(time gap ns, charge gap in charge units) over channels between
    the program's readout and the reference's; inf where one side alone
    has a hit."""
    hit_p, t_p, q_p = prog
    hit_r, t_r, q_r = ref
    if bool((hit_p != hit_r).any()):
        return math.inf, math.inf
    if not bool(hit_r.any()):
        return 0.0, 0.0
    dt = (t_p[hit_r] - t_r[hit_r]).abs().max()
    dq = (q_p - q_r).abs().max() / unit
    return float(dt), float(dq)
