"""The reference's ray queries: nearest triangle along each ray.

A scene holds local meshes, each with a bounding-volume tree of its own
(worked out here, top-down median splits of the triangles' centroids,
every leaf at the same depth), instances of them (rotation, translation,
first global triangle id). `query` walks the
trees breadth first: candidate (ray, instance) pairs cut by bounding
spheres, then (pair, node) candidates level by level, then the leaves'
triangles by Moller-Trumbore. Everything is plain torch, in the scene's
dtype, so the same code is the float32 reference and the bfloat16
control.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

T_MIN = 1e-4          # a hit nearer than this is the ray's own start, mm
BARY_EPS = 1e-6       # barycentric slack at shared edges
NO_TRI = -1


class Mesh:
    """One local mesh: triangles (f64 build, stored in the scene's dtype)
    with inner and outer material, surface (-1: none) and its tree."""

    def __init__(self, vertices, triangles, m_in, m_out, surf,
                 color=0x33ffffff, leaf=32, fanout=16):
        tri = np.asarray(vertices, np.float64)[np.asarray(triangles)]
        n = len(tri)
        self.n = n
        self.v0 = tri[:, 0]
        self.e1 = tri[:, 1] - tri[:, 0]
        self.e2 = tri[:, 2] - tri[:, 0]
        self.m_in = np.broadcast_to(np.asarray(m_in), (n,)).astype(np.int64)
        self.m_out = np.broadcast_to(np.asarray(m_out), (n,)).astype(np.int64)
        self.surf = np.broadcast_to(np.asarray(surf), (n,)).astype(np.int64)
        self.color = np.broadcast_to(np.asarray(color, np.int64),
                                     (n,)).astype(np.int64)
        lo, hi, cen = tri.min(1), tri.max(1), tri.mean(1)
        perm = np.arange(n)
        ranges = [(0, n)]
        children = []
        levels = [ranges]
        while max(b - a for a, b in ranges) > leaf:
            new, kids = [], []
            for a, b in ranges:
                idx = perm[a:b]
                c = cen[idx]
                ax = int(np.argmax(c.max(0) - c.min(0)))
                perm[a:b] = idx[np.argsort(c[:, ax], kind='stable')]
                k = min(fanout, -(-(b - a) // leaf))
                cut = np.linspace(a, b, k + 1).round().astype(np.int64)
                kids.append((len(new), k))
                new += [(int(cut[i]), int(cut[i + 1])) for i in range(k)]
            children.append(kids)
            ranges = new
            levels.append(ranges)
        self.perm = perm
        self.levels = []
        for i, rng in enumerate(levels):
            lo_n = np.array([lo[perm[a:b]].min(0) for a, b in rng])
            hi_n = np.array([hi[perm[a:b]].max(0) for a, b in rng])
            if i < len(children):
                first = np.array([c[0] for c in children[i]])
                count = np.array([c[1] for c in children[i]])
            else:
                first = np.array([a for a, b in rng])
                count = np.array([b - a for a, b in rng])
            self.levels.append((lo_n, hi_n, first, count))
        centre = (lo.min(0) + hi.max(0)) / 2
        self.centre = centre
        self.radius = float(np.sqrt(((tri - centre) ** 2).sum(-1)).max())


class Scene:
    """Meshes, their instances, and the optics tables at the
    photons' wavelength: materials (M, 3) = (refractive index, absorption
    length, scattering length), surfaces (S, 4) = (detect, absorb,
    diffuse, specular), and the channel of each instance (-1: none)."""

    def __init__(self, meshes, inst_mesh, inst_rot, inst_pos, materials,
                 surfaces, inst_channel=None):
        self.meshes = meshes
        self.inst_mesh = np.asarray(inst_mesh, np.int64)
        self.inst_rot = np.asarray(inst_rot, np.float64)
        self.inst_pos = np.asarray(inst_pos, np.float64)
        sizes = np.array([meshes[m].n for m in self.inst_mesh])
        self.inst_base = np.r_[0, np.cumsum(sizes)[:-1]].astype(np.int64)
        self.n_triangles = int(sizes.sum())
        self.materials = np.asarray(materials, np.float64)
        self.surfaces = np.asarray(surfaces, np.float64)
        k = len(self.inst_mesh)
        self.inst_channel = np.full(k, -1, np.int64) if inst_channel is None \
            else np.asarray(inst_channel, np.int64)
        self.device = None

    def to(self, device, dtype=torch.float32):
        "Tensors of every table on `device`, in `dtype` for geometry."
        def f(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        def i(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                   device=device)
        self.device, self.dtype = torch.device(device), dtype
        self.t_meshes = []
        for m in self.meshes:
            levels = [(f(lo), f(hi), i(first), i(count))
                      for lo, hi, first, count in m.levels]
            self.t_meshes.append(dict(
                v0=f(m.v0), e1=f(m.e1), e2=f(m.e2), perm=i(m.perm),
                m_in=i(m.m_in), m_out=i(m.m_out), surf=i(m.surf),
                color=i(m.color), levels=levels))
        self.t_rot = f(self.inst_rot)
        self.t_pos = f(self.inst_pos)
        self.t_base = i(self.inst_base)
        self.t_inst_mesh = i(self.inst_mesh)
        centre = np.array([self.inst_rot[k] @ self.meshes[m].centre
                           + self.inst_pos[k]
                           for k, m in enumerate(self.inst_mesh)])
        self.t_centre = f(centre)
        self.t_radius = f([self.meshes[m].radius for m in self.inst_mesh])
        self.t_channel = i(self.inst_channel)
        self.t_materials = torch.as_tensor(self.materials,
                                           dtype=torch.float32, device=device)
        self.t_surfaces = torch.as_tensor(self.surfaces, dtype=torch.float32,
                                          device=device)
        return self

    # -- per-triangle tables of global ids ----------------------------------
    def locate(self, tri):
        "(instance, local index) of global triangle ids (>= 0)."
        k = torch.searchsorted(self.t_base, tri, right=True) - 1
        return k, tri - self.t_base[k]

    def triangle_props(self, tri):
        """(m_in, m_out, surface, instance) of global triangle ids; rows of
        ids < 0 give -1 for all four."""
        ok = tri >= 0
        k, loc = self.locate(torch.where(ok, tri, 0))
        out = [torch.full_like(tri, -1) for _ in range(3)]
        for mi, m in enumerate(self.t_meshes):
            sel = ok & (self.t_inst_mesh[k] == mi)
            li = torch.where(sel, loc, 0).clamp(max=len(m['m_in']) - 1)
            for o, key in zip(out, ('m_in', 'm_out', 'surf')):
                o[sel] = m[key][li][sel]
        return out[0], out[1], out[2], torch.where(ok, k, -1)

    def triangle_color(self, tri):
        "Packed ARGB colour of global triangle ids (>= 0)."
        k, loc = self.locate(tri)
        out = torch.zeros_like(tri)
        for mi, m in enumerate(self.t_meshes):
            sel = self.t_inst_mesh[k] == mi
            out[sel] = m['color'][loc[sel]]
        return out

    def triangle_world(self, tri):
        "World (v0, e1, e2) of global triangle ids (>= 0), in f32."
        k, loc = self.locate(tri)
        v0 = torch.zeros(tri.shape + (3,), device=tri.device)
        e1, e2 = v0.clone(), v0.clone()
        for mi, m in enumerate(self.t_meshes):
            sel = self.t_inst_mesh[k] == mi
            if not bool(sel.any()):
                continue
            li = loc[sel]
            r = self.t_rot[k[sel]].float()
            v0[sel] = (torch.einsum('nij,nj->ni', r, m['v0'][li].float())
                       + self.t_pos[k[sel]].float())
            e1[sel] = torch.einsum('nij,nj->ni', r, m['e1'][li].float())
            e2[sel] = torch.einsum('nij,nj->ni', r, m['e2'][li].float())
        return v0, e1, e2


@dataclasses.dataclass
class Hit:
    t: torch.Tensor        # (N,) distance, inf where none
    tri: torch.Tensor      # (N,) global triangle id, or NO_TRI
    normal: torch.Tensor   # (N, 3) unit: the face's winding
    m_in: torch.Tensor     # outward radial; materials / surface of the hit
    m_out: torch.Tensor
    surf: torch.Tensor


def _slab(lo, hi, o, inv, tmax):
    "Entry distance of rays into boxes, inf where they miss."
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    tn = torch.minimum(t1, t2).amax(-1)
    tf = torch.maximum(t1, t2).amin(-1)
    hit = (tf >= torch.clamp(tn, min=0)) & (tn <= tmax)
    return hit


def _inv(d):
    tiny = torch.full_like(d, 1e-30)
    safe = torch.where(d.abs() < 1e-30, torch.where(d < 0, -tiny, tiny), d)
    return 1.0 / safe


def _mesh_pairs(mesh, o, d, tmax, excl, base, tmin):
    """Nearest hit of local rays (o, d) (P, 3) in `mesh`: (t (P,), local
    triangle (P,)); triangles whose global id base + local equals `excl`
    are skipped."""
    p = o.shape[0]
    dev = o.device
    inv = _inv(d)
    cand_p = torch.arange(p, device=dev)
    cand_n = torch.zeros(p, dtype=torch.int64, device=dev)
    levels = mesh['levels']
    for li, (lo, hi, first, count) in enumerate(levels):
        ok = _slab(lo[cand_n], hi[cand_n], o[cand_p], inv[cand_p],
                   tmax[cand_p][:, None].squeeze(-1))
        cand_p, cand_n = cand_p[ok], cand_n[ok]
        width = int(count.max()) if li < len(levels) else 0
        j = torch.arange(width, device=dev)
        keep = j[None, :] < count[cand_n][:, None]
        idx = first[cand_n][:, None] + j[None, :]
        cand_p = cand_p[:, None].expand(-1, width)[keep]
        cand_n = idx[keep]
        if li == len(levels) - 1:
            break
    # cand_n now indexes positions of perm: triangles
    tri = mesh['perm'][cand_n]
    v0, e1, e2 = mesh['v0'][tri], mesh['e1'][tri], mesh['e2'][tri]
    oo, dd = o[cand_p], d[cand_p]
    h = torch.linalg.cross(dd, e2)
    a = (e1 * h).sum(-1)
    parallel = a.abs() <= 1.2e-7 * (e1.abs().amax(-1) * e2.abs().amax(-1))
    f = 1.0 / torch.where(parallel, torch.ones_like(a), a)
    s = oo - v0
    u = f * (s * h).sum(-1)
    q = torch.linalg.cross(s, e1)
    v = f * (dd * q).sum(-1)
    t = f * (e2 * q).sum(-1)
    ok = (~parallel & (u >= -BARY_EPS) & (u <= 1 + BARY_EPS)
          & (v >= -BARY_EPS) & (u + v <= 1 + BARY_EPS) & (t > tmin)
          & torch.isfinite(t) & (base[cand_p] + tri != excl[cand_p]))
    t = torch.where(ok, t.float(), torch.full_like(t, math.inf).float())
    best = torch.full((p,), math.inf, device=dev)
    best.scatter_reduce_(0, cand_p, t, reduce='amin')
    win = ok & (t == best[cand_p])
    best_tri = torch.full((p,), -1, dtype=torch.int64, device=dev)
    best_tri[cand_p[win]] = tri[win]
    return best, best_tri


def _pairs(scene, o, d, tmax):
    "Candidate (ray, instance) pairs whose bounding spheres the rays cross."
    n, k = o.shape[0], scene.t_centre.shape[0]
    rays, insts = [], []
    step = max(1, (1 << 24) // max(k, 1))
    for a in range(0, n, step):
        oc, dc = o[a:a + step].float(), d[a:a + step].float()
        c = scene.t_centre.float()[None] - oc[:, None]
        b = (c * dc[:, None]).sum(-1)
        c2 = (c * c).sum(-1)
        r2 = scene.t_radius.float()[None] ** 2
        disc = b * b - c2 + r2
        far = b + torch.sqrt(torch.clamp(disc, min=0))
        near = b - torch.sqrt(torch.clamp(disc, min=0))
        hit = (disc >= 0) & (far > 0) & (near <= tmax[a:a + step, None])
        r, i = torch.nonzero(hit, as_tuple=True)
        rays.append(r + a)
        insts.append(i)
    return torch.cat(rays), torch.cat(insts)


def query(scene, o, d, excl=None, tmax=None, tmin=T_MIN, chunk=1 << 18):
    """Nearest hit of world rays (o, d) (N, 3) in the scene, skipping the
    global triangle `excl` of each ray (its last hit). Rays go through in
    chunks; the geometry runs in the scene's dtype, distances come back
    as f32."""
    n = o.shape[0]
    dev = o.device
    if excl is None:
        excl = torch.full((n,), NO_TRI, dtype=torch.int64, device=dev)
    if tmax is None:
        tmax = torch.full((n,), math.inf, device=dev)
    parts = [_query(scene, o[a:a + chunk], d[a:a + chunk],
                    excl[a:a + chunk].long(), tmax[a:a + chunk], tmin)
             for a in range(0, n, chunk)]
    return Hit(*[torch.cat([getattr(p, f.name) for p in parts])
                 for f in dataclasses.fields(Hit)])


def _query(scene, o, d, excl, tmax, tmin):
    dt = scene.dtype
    n = o.shape[0]
    dev = o.device
    o, d = o.to(dt), d.to(dt)
    best = torch.full((n,), math.inf, device=dev)
    tri = torch.full((n,), NO_TRI, dtype=torch.int64, device=dev)
    rays, insts = _pairs(scene, o, d, tmax.to(dt))
    for mi, mesh in enumerate(scene.t_meshes):
        sel = scene.t_inst_mesh[insts] == mi
        r_i, k_i = rays[sel], insts[sel]
        if r_i.numel() == 0:
            continue
        rot = scene.t_rot[k_i]
        lo = torch.einsum('nji,nj->ni', rot, o[r_i] - scene.t_pos[k_i])
        ld = torch.einsum('nji,nj->ni', rot, d[r_i])
        t, loc = _mesh_pairs(mesh, lo, ld, tmax[r_i].to(dt), excl[r_i],
                             scene.t_base[k_i], tmin)
        # reduce the pairs onto their rays
        win = torch.full((n,), math.inf, device=dev)
        win.scatter_reduce_(0, r_i, t, reduce='amin')
        closer = win < best
        take = (t == win[r_i]) & closer[r_i] & torch.isfinite(t)
        tri[r_i[take]] = scene.t_base[k_i[take]] + loc[take]
        best = torch.where(closer, win, best)
    m_in, m_out, surf, _ = scene.triangle_props(tri)
    normal = torch.zeros((n, 3), device=dev)
    has = tri >= 0
    if bool(has.any()):
        _, e1, e2 = scene.triangle_world(tri[has])
        nrm = torch.linalg.cross(e1, e2)
        normal[has] = nrm / torch.clamp(nrm.norm(dim=1, keepdim=True),
                                        min=1e-30)
    return Hit(best, tri, normal, m_in, m_out, surf)
