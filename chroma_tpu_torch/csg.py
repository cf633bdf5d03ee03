"""Constructive solid geometry on closed triangle meshes.

Host-side mesh booleans (union / subtraction / intersection) for the GDML
loader, built on BSP-tree polygon clipping — the classic solid-modeling
recipe (Thibault & Naylor style, as popularized by csg.js). The reference
delegates this to gmsh/OpenCASCADE (reference: chroma/gdml/gen_mesh.py:39-70);
here it is a dependency-free numpy implementation, adequate for the
few-thousand-triangle solids that appear in detector GDML files.

Input meshes must be closed and consistently wound (outward normals).
Output triangles keep outward winding; coplanar faces are assigned to the
side their normal agrees with, matching the usual CSG convention.
"""
from __future__ import annotations

import numpy as np

from chroma_tpu_torch.geometry import Mesh

# plane-classification tolerance, in mesh length units (mm)
EPS = 1e-5

_COPLANAR, _FRONT, _BACK, _SPAN = 0, 1, 2, 3


class _Poly(object):
    "A convex polygon with a cached support plane."
    __slots__ = ('pts', 'normal', 'offset')

    def __init__(self, pts, normal=None, offset=None):
        self.pts = pts                      # (k, 3) float array
        if normal is None:
            n = np.cross(pts[1] - pts[0], pts[2] - pts[0])
            ln = np.linalg.norm(n)
            normal = n / ln if ln > 0 else n
            offset = float(np.dot(normal, pts[0]))
        self.normal = normal
        self.offset = offset

    def flipped(self):
        return _Poly(self.pts[::-1].copy(), -self.normal, -self.offset)


def _classify(poly, normal, offset):
    "Side of `poly` relative to the plane; per-vertex signs also returned."
    d = poly.pts @ normal - offset
    front = d > EPS
    back = d < -EPS
    if not front.any() and not back.any():
        return _COPLANAR, d
    if not back.any():
        return _FRONT, d
    if not front.any():
        return _BACK, d
    return _SPAN, d


def _split(poly, normal, offset, d):
    "Split a spanning polygon; returns (front _Poly or None, back or None)."
    pts = poly.pts
    k = len(pts)
    fpts, bpts = [], []
    for i in range(k):
        j = (i + 1) % k
        di, dj = d[i], d[j]
        if di >= -EPS:
            fpts.append(pts[i])
        if di <= EPS:
            bpts.append(pts[i])
        if (di > EPS and dj < -EPS) or (di < -EPS and dj > EPS):
            t = di / (di - dj)
            cut = pts[i] + t * (pts[j] - pts[i])
            fpts.append(cut)
            bpts.append(cut)
    front = _Poly(np.asarray(fpts), poly.normal, poly.offset) \
        if len(fpts) >= 3 else None
    back = _Poly(np.asarray(bpts), poly.normal, poly.offset) \
        if len(bpts) >= 3 else None
    return front, back


class _BSP(object):
    "A BSP tree of polygons representing a solid's boundary."
    __slots__ = ('normal', 'offset', 'polys', 'front', 'back')

    def __init__(self, polys=None):
        self.normal = None
        self.polys = []
        self.front = None
        self.back = None
        if polys:
            self.insert(polys)

    def insert(self, polys):
        "Add polygons to this subtree, splitting as needed."
        stack = [(self, polys)]
        while stack:
            node, batch = stack.pop()
            if not batch:
                continue
            if node.normal is None:
                node.normal = batch[0].normal
                node.offset = batch[0].offset
            here, fronts, backs = [], [], []
            for p in batch:
                side, d = _classify(p, node.normal, node.offset)
                if side == _COPLANAR:
                    here.append(p)
                elif side == _FRONT:
                    fronts.append(p)
                elif side == _BACK:
                    backs.append(p)
                else:
                    f, b = _split(p, node.normal, node.offset, d)
                    if f is not None:
                        fronts.append(f)
                    if b is not None:
                        backs.append(b)
            node.polys.extend(here)
            if fronts:
                if node.front is None:
                    node.front = _BSP()
                stack.append((node.front, fronts))
            if backs:
                if node.back is None:
                    node.back = _BSP()
                stack.append((node.back, backs))

    def invert(self):
        "Flip the solid inside-out in place."
        stack = [self]
        while stack:
            node = stack.pop()
            if node.normal is None:
                continue
            node.polys = [p.flipped() for p in node.polys]
            node.normal = -node.normal
            node.offset = -node.offset
            node.front, node.back = node.back, node.front
            if node.front is not None:
                stack.append(node.front)
            if node.back is not None:
                stack.append(node.back)

    def _clip_polys(self, polys):
        """Drop the parts of `polys` inside this tree's solid (iterative —
        BSP trees over curved surfaces get deeper than the Python
        recursion limit)."""
        if self.normal is None:
            return list(polys)
        out = []
        stack = [(self, polys)]
        while stack:
            node, batch = stack.pop()
            here_f, here_b = [], []
            for p in batch:
                side, d = _classify(p, node.normal, node.offset)
                if side == _FRONT:
                    here_f.append(p)
                elif side == _BACK:
                    here_b.append(p)
                elif side == _COPLANAR:
                    # keep coplanar polys facing the same way as the plane
                    if np.dot(p.normal, node.normal) > 0:
                        here_f.append(p)
                    else:
                        here_b.append(p)
                else:
                    f, b = _split(p, node.normal, node.offset, d)
                    if f is not None:
                        here_f.append(f)
                    if b is not None:
                        here_b.append(b)
            if node.front is not None:
                if here_f:
                    stack.append((node.front, here_f))
            else:
                out.extend(here_f)          # outside the solid: kept
            if node.back is not None and here_b:
                stack.append((node.back, here_b))
            # no back child: inside the solid, clipped away
        return out

    def clip_to(self, other):
        "Remove the parts of this tree's polygons inside `other`."
        stack = [self]
        while stack:
            node = stack.pop()
            node.polys = other._clip_polys(node.polys)
            if node.front is not None:
                stack.append(node.front)
            if node.back is not None:
                stack.append(node.back)

    def all_polys(self):
        out = []
        stack = [self]
        while stack:
            node = stack.pop()
            out.extend(node.polys)
            if node.front is not None:
                stack.append(node.front)
            if node.back is not None:
                stack.append(node.back)
        return out


def _mesh_polys(mesh):
    tri = np.asarray(mesh.vertices, dtype=float)[
        np.asarray(mesh.triangles)]
    out = []
    for t in tri:
        n = np.cross(t[1] - t[0], t[2] - t[0])
        ln = np.linalg.norm(n)
        if ln < 1e-300:
            continue        # degenerate input triangle
        out.append(_Poly(t.copy(), n / ln,
                         float(np.dot(n / ln, t[0]))))
    return out


def _polys_to_mesh(polys):
    verts = []
    tris = []
    for p in polys:
        k = len(p.pts)
        base = len(verts)
        verts.extend(p.pts)
        for i in range(1, k - 1):           # fan triangulation
            tris.append((base, base + i, base + i + 1))
    if not tris:
        return Mesh(np.zeros((0, 3)), np.zeros((0, 3), dtype=int))
    return Mesh(np.asarray(verts, dtype=np.float32),
                np.asarray(tris, dtype=np.int32), remove_duplicate_vertices=True)


def mesh_union(a, b):
    "Boolean union of two closed meshes."
    ta, tb = _BSP(_mesh_polys(a)), _BSP(_mesh_polys(b))
    ta.clip_to(tb)
    tb.clip_to(ta)
    tb.invert()
    tb.clip_to(ta)          # drop b-surface coplanar duplicates inside a
    tb.invert()
    return _polys_to_mesh(ta.all_polys() + tb.all_polys())


def mesh_subtract(a, b):
    "Boolean difference a - b of two closed meshes."
    ta, tb = _BSP(_mesh_polys(a)), _BSP(_mesh_polys(b))
    ta.invert()
    ta.clip_to(tb)
    tb.clip_to(ta)
    tb.invert()
    tb.clip_to(ta)
    tb.invert()
    ta.insert(tb.all_polys())
    ta.invert()
    return _polys_to_mesh(ta.all_polys())


def mesh_intersect(a, b):
    "Boolean intersection of two closed meshes."
    ta, tb = _BSP(_mesh_polys(a)), _BSP(_mesh_polys(b))
    ta.invert()
    tb.clip_to(ta)
    tb.invert()
    ta.clip_to(tb)
    tb.clip_to(ta)
    ta.insert(tb.all_polys())
    ta.invert()
    return _polys_to_mesh(ta.all_polys())


def mesh_boolean(op, a, b):
    "Dispatch by op name: 'union' | 'subtraction' | 'intersection'."
    try:
        fn = {'union': mesh_union, 'subtraction': mesh_subtract,
              'intersection': mesh_intersect}[op]
    except KeyError:
        raise ValueError('unknown boolean op %r' % op)
    return fn(a, b)


def mesh_volume(mesh):
    "Signed volume via the divergence theorem (positive when outward-wound)."
    tri = np.asarray(mesh.vertices, dtype=float)[
        np.asarray(mesh.triangles)]
    return float(np.einsum('ij,ij->', tri[:, 0],
                           np.cross(tri[:, 1], tri[:, 2])) / 6.0)
