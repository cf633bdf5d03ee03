"""Instanced (TLAS/BLAS) wide BVH builder, host numpy, for the torch port.

A jax-free copy of the instanced-table builder in chroma_tpu.bvh.wide (that
module imports jax at its top, so the port cannot import it on a machine
without JAX). The table it builds is bit-for-bit the JAX builder's; only
the container differs: `InstancedBVH.rows` is a torch tensor.

Row layout (v4; see chroma_tpu.bvh.wide.InstancedBVH), width W =
pad8(max(INST_B0 + bounds + 1, 11K, 15) + 1):
  internal (tag 0): [.. 14 unused .., bounds block, first_child_row i32]
  leaf     (tag 1): [(v0, e1, e2, local_tri i32, mat code u32) x K]
  instance (tag 2): [R_world->local (9), displacement (3), tri_base i32,
                     instance_id i32, BLAS-root bounds block,
                     first_child_row i32]
  last column: row tag (bitcast i32). Root is row 0.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from chroma_tpu.bvh.build import morton_codes_3d
from chroma_tpu.log import logger

# default shape knobs, the same environment overrides as chroma_tpu
FANOUT = int(os.environ.get('CHROMA_BVH_FANOUT', '16'))
LEAF_SIZE = int(os.environ.get('CHROMA_BVH_LEAF', '8'))
MAX_DEPTH = 16
PACKED_FANOUT = int(os.environ.get('CHROMA_BVH_PACKED_FANOUT', '32'))

TAG_INTERNAL = 0
TAG_LEAF = 1
TAG_INSTANCE = 2

# column where the child-bounds block starts on internal and instance rows
INST_B0 = 14

LEAF_STRIDE = 11   # floats per triangle in a leaf row

BF16_NAN = np.uint16(0x7FC0)


def _pad8(w):
    "Row widths are padded to a multiple of 8 (the JAX table's layout)."
    return (w + 7) & ~7


def _bf16_dir_bits(x, up):
    """Directed-rounding f32 -> bf16 bit patterns (uint16): the largest
    bf16 <= x (up=False) or smallest bf16 >= x (up=True), so packed boxes
    only grow."""
    x = np.asarray(x, np.float32)
    u = x.view(np.uint32) if x.flags['C_CONTIGUOUS'] \
        else np.ascontiguousarray(x).view(np.uint32)
    t = u & np.uint32(0xFFFF0000)
    tv = t.view(np.float32)
    need = (tv < x) if up else (tv > x)
    t = np.where(need, t + np.uint32(0x10000), t)
    return (t >> 16).astype(np.uint16)


def _pack_bounds_words(lo, hi, pf):
    """Pack per-child AABB bounds into bf16-pair words: (..., pf, 3) f32
    (NaN marks empty) -> (..., 6 * pf // 2) f32 words [lo_x, lo_y, lo_z,
    hi_x, hi_y, hi_z]; word w holds child w in the low 16 bits and child
    w + pf//2 in the high 16 bits."""
    pw = pf // 2
    lo16 = np.where(np.isnan(lo), np.uint32(BF16_NAN),
                    _bf16_dir_bits(lo, up=False).astype(np.uint32))
    hi16 = np.where(np.isnan(hi), np.uint32(BF16_NAN),
                    _bf16_dir_bits(hi, up=True).astype(np.uint32))
    parts = []
    for arr in (lo16, hi16):
        for ax in range(3):
            parts.append(arr[..., :pw, ax] | (arr[..., pw:, ax] << 16))
    words = np.ascontiguousarray(
        np.concatenate(parts, axis=-1).astype(np.uint32))
    return words.view(np.float32)


def _pack_bounds_q8(lo, hi, pf):
    """Pack per-child AABB bounds as bytes quantized against the node's own
    box: 3 f32 anchors, 3 f32 scales, then 6 groups of pf/4 words with one
    byte per child (child c in word c >> 2, byte c & 3). lo rounds down and
    hi up, with one extra quantum each side; empty slots encode lo=255,
    hi=0 (an inverted interval)."""
    empty = np.isnan(lo[..., 0])
    anchor = np.nanmin(np.where(empty[..., None], np.inf, lo), axis=-2)
    top = np.nanmax(np.where(empty[..., None], -np.inf, hi), axis=-2)
    anchor = np.where(np.isfinite(anchor), anchor, 0.0).astype(np.float32)
    top = np.where(np.isfinite(top), top, 1.0).astype(np.float32)
    scale = np.maximum((top - anchor) / 255.0, 1e-30).astype(np.float32)

    rel_lo = (lo - anchor[..., None, :]) / scale[..., None, :]
    rel_hi = (hi - anchor[..., None, :]) / scale[..., None, :]
    q_lo = np.clip(np.floor(rel_lo) - 1, 0, 255)
    q_hi = np.clip(np.ceil(rel_hi) + 1, 0, 255)
    q_lo = np.where(empty[..., None], 255.0, q_lo).astype(np.uint32)
    q_hi = np.where(empty[..., None], 0.0, q_hi).astype(np.uint32)

    parts = [anchor, scale]
    for arr in (q_lo, q_hi):
        for ax in range(3):
            b = arr[..., ax]
            w = (b[..., 0::4] | (b[..., 1::4] << 8)
                 | (b[..., 2::4] << 16) | (b[..., 3::4] << 24))
            parts.append(np.ascontiguousarray(w.astype(np.uint32))
                         .view(np.float32))
    return np.concatenate(
        [p.astype(np.float32, copy=False) for p in parts], axis=-1)


def bounds_cols(fmt, fanout):
    "Number of row columns the child-bounds block occupies."
    if fmt == 'q8':
        return 6 + 6 * (fanout // 4)
    if fmt == 'bf16':
        return 3 * fanout
    return 6 * fanout


def pack_bounds(fmt, lo, hi, fanout):
    "Dispatch to the format's packer (f32 writes are done by callers)."
    if fmt == 'q8':
        return _pack_bounds_q8(lo, hi, fanout)
    return _pack_bounds_words(lo, hi, fanout)


@dataclasses.dataclass
class InstancedBVH:
    """The tagged two-level row table (layout in the module docstring)."""
    rows: torch.Tensor        # (R, W) f32
    max_depth: int
    fanout: int
    leaf_size: int
    n_instances: int
    packed: bool = False
    bounds_fmt: str = None    # 'f32' | 'bf16' | 'q8'; None: from `packed`

    def to(self, device):
        return dataclasses.replace(self, rows=self.rows.to(device))


def fmt_of(wide):
    "Resolved child-bounds format of an instanced table."
    fmt = getattr(wide, 'bounds_fmt', None)
    if fmt:
        return fmt
    return 'bf16' if getattr(wide, 'packed', False) else 'f32'


def _area_rows(alo, ahi):
    d = np.maximum(ahi - alo, 0.0)
    return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]


def _prefix_groups(codes, max_size, target_mean):
    """Group Morton-sorted codes into runs of equal (shifted) codes of at
    most max_size elements. Returns (first, count, parent_codes)."""
    codes = codes.copy()
    n = len(codes)
    nunique = int((np.ediff1d(codes) > 0).sum()) + 1
    while nunique > 1 and n / nunique < target_mean:
        codes >>= np.uint64(1)
        nunique = int((np.ediff1d(codes) > 0).sum()) + 1

    change = np.ediff1d(codes, to_begin=np.uint64(1)).astype(np.uint64) > 0
    first = np.flatnonzero(change).astype(np.int64)
    count = np.ediff1d(first, to_end=n - first[-1]).astype(np.int64)
    group_codes = codes[first]

    oversized = count > max_size
    if oversized.any():
        nsplits = np.where(oversized, -(-count // max_size), 1)
        new_first = np.repeat(first, nsplits)
        ends = np.cumsum(nsplits)
        intra = np.arange(ends[-1]) - np.repeat(ends - nsplits, nsplits)
        first = new_first + intra * max_size
        group_codes = np.repeat(group_codes, nsplits)
        count = np.ediff1d(first, to_end=n - first[-1]).astype(np.int64)
    return first, count, group_codes


def _morton_wide_rows(mesh, fanout, leaf_size, material_codes):
    """Morton-prefix wide BVH over one mesh, as an untagged f32 row table
    (the host half of chroma_tpu.bvh.wide.build_wide_bvh). Serves BLASes of
    meshes too large for the SAH build. Returns (rows, leaf_base,
    max_depth)."""
    internal_target_mean = max(fanout // 2, 4)
    vertices = mesh.vertices.astype(np.float32)
    triangles = mesh.triangles.astype(np.int64)
    tri = vertices[triangles]
    ntri = len(triangles)

    world_origin = vertices.min(axis=0)
    world_scale = max(float((vertices.max(axis=0) - world_origin).max())
                      / (2 ** 16 - 2), 1e-12)
    from chroma_tpu import native
    codes = native.morton_codes(tri, world_origin, world_scale) \
        if ntri > 100000 else None
    if codes is None:
        centroid = tri.mean(axis=1)
        q = ((centroid - world_origin) / world_scale).astype(np.uint32)
        codes = morton_codes_3d(q)
    order = native.argsort_u64(codes) if ntri > 100000 else None
    if order is None:
        order = np.argsort(codes)
    tri = tri[order]
    tri_index = order.astype(np.int32)
    codes = codes[order]
    mat_codes = np.asarray(material_codes, np.uint32)[order]

    tri_lo = tri.min(axis=1)
    tri_hi = tri.max(axis=1)

    first, count, group_codes = _prefix_groups(codes, leaf_size,
                                               target_mean=leaf_size)
    nblocks = len(first)
    leaf_rows = np.zeros((nblocks, leaf_size, LEAF_STRIDE),
                         dtype=np.float32)
    leaf_rows[:, :, 9] = np.float32(np.int32(-1).view(np.float32))
    slot = np.arange(ntri) - np.repeat(first, count)
    block = np.repeat(np.arange(nblocks), count)
    leaf_rows[block, slot, 0:3] = tri[:, 0]
    leaf_rows[block, slot, 3:6] = tri[:, 1] - tri[:, 0]
    leaf_rows[block, slot, 6:9] = tri[:, 2] - tri[:, 0]
    leaf_rows[block, slot, 9] = tri_index.view(np.float32)
    leaf_rows[block, slot, 10] = mat_codes.view(np.float32)
    starts = first.astype(np.intp)
    block_lo = np.minimum.reduceat(tri_lo, starts, axis=0)
    block_hi = np.maximum.reduceat(tri_hi, starts, axis=0)

    levels = []
    child_lo, child_hi, child_codes = block_lo, block_hi, group_codes
    depth_guard = 0
    while len(child_lo) > 1:
        first, count, child_codes = _prefix_groups(
            child_codes, fanout, target_mean=internal_target_mean)
        starts = first.astype(np.intp)
        lo = np.minimum.reduceat(child_lo, starts, axis=0)
        hi = np.maximum.reduceat(child_hi, starts, axis=0)
        levels.append((first, count, lo, hi))
        child_lo, child_hi = lo, hi
        depth_guard += 1
        if depth_guard > MAX_DEPTH:
            raise RuntimeError('wide BVH build did not converge')

    levels.reverse()
    n_internal = sum(len(lv[0]) for lv in levels)
    width = _pad8(max(6 * fanout + 2, LEAF_STRIDE * leaf_size))

    rows = np.zeros((n_internal + nblocks, width), dtype=np.float32)
    rows[:n_internal, :6 * fanout] = np.nan
    leaf_base = n_internal

    level_start = np.cumsum([0] + [len(lv[0]) for lv in levels])
    for i, (first, count, lo, hi) in enumerate(levels):
        base = level_start[i]
        npar = len(first)
        child_base = (level_start[i + 1] if i + 1 < len(levels)
                      else leaf_base)
        r = rows[base:base + npar]
        child_slot = np.arange(count.sum()) - np.repeat(
            np.cumsum(count) - count, count)
        parent_of = np.repeat(np.arange(npar), count)
        if i + 1 < len(levels):
            clo, chi = levels[i + 1][2], levels[i + 1][3]
        else:
            clo, chi = block_lo, block_hi
        for ax in range(3):
            r[parent_of, ax * fanout + child_slot] = clo[:, ax]
            r[parent_of, (3 + ax) * fanout + child_slot] = chi[:, ax]
        r[:, 6 * fanout] = (child_base
                            + first).astype(np.int32).view(np.float32)

    rows[leaf_base:, :LEAF_STRIDE * leaf_size] = \
        leaf_rows.reshape(nblocks, -1)
    return rows, int(leaf_base), len(levels) + 1


def _binary_sah_build(lo, hi, max_leaf, nbins=16, sweep=None):
    """Binned-SAH binary BVH over primitive AABBs (exhaustive sweep below
    300k primitives). Returns dict(left, right, start, count, lo, hi,
    perm)."""
    P = len(lo)
    if sweep is None:
        sweep = P <= 300000 and \
            os.environ.get('CHROMA_BVH_SWEEP_SAH', '1') != '0'
    cent = (lo + hi) * 0.5
    perm = np.arange(P, dtype=np.int64)
    L, R, S, C, NLo, NHi = [], [], [], [], [], []

    def alloc():
        L.append(-1)
        R.append(-1)
        S.append(0)
        C.append(0)
        NLo.append(None)
        NHi.append(None)
        return len(L) - 1

    stack = [(0, P, alloc())]
    while stack:
        s, e, nid = stack.pop()
        idx = perm[s:e]
        plo = lo[idx]
        phi = hi[idx]
        NLo[nid] = plo.min(axis=0)
        NHi[nid] = phi.max(axis=0)
        n = e - s
        if n <= max_leaf:
            S[nid] = s
            C[nid] = n
            continue

        c = cent[idx]
        best_cost, best = np.inf, None

        if sweep:
            for ax in range(3):
                o = np.argsort(c[:, ax], kind='stable')
                slo = plo[o]
                shi = phi[o]
                l_lo = np.minimum.accumulate(slo, axis=0)
                l_hi = np.maximum.accumulate(shi, axis=0)
                r_lo = np.minimum.accumulate(slo[::-1], axis=0)[::-1]
                r_hi = np.maximum.accumulate(shi[::-1], axis=0)[::-1]
                nl = np.arange(1, n)
                cost = (nl * _area_rows(l_lo[:-1], l_hi[:-1])
                        + (n - nl) * _area_rows(r_lo[1:], r_hi[1:]))
                i = int(np.argmin(cost))
                if cost[i] < best_cost:
                    best_cost = float(cost[i])
                    best = (ax, o, i + 1)
            if best is not None:
                ax, o, mid_local = best
                perm[s:e] = idx[o]
                mid = s + mid_local
            else:
                mid = s + n // 2
        else:
            for ax in range(3):
                cmin = c[:, ax].min()
                cmax = c[:, ax].max()
                if cmax <= cmin:
                    continue
                scale = nbins * (1.0 - 1e-7) / (cmax - cmin)
                b = ((c[:, ax] - cmin) * scale).astype(np.int64)
                counts = np.bincount(b, minlength=nbins)
                o = np.argsort(b, kind='stable')
                occupied = counts > 0
                starts = np.searchsorted(b[o], np.flatnonzero(occupied))
                binlo = np.full((nbins, 3), np.inf, np.float32)
                binhi = np.full((nbins, 3), -np.inf, np.float32)
                binlo[occupied] = np.minimum.reduceat(plo[o], starts,
                                                      axis=0)
                binhi[occupied] = np.maximum.reduceat(phi[o], starts,
                                                      axis=0)

                l_lo = np.minimum.accumulate(binlo, axis=0)
                l_hi = np.maximum.accumulate(binhi, axis=0)
                r_lo = np.minimum.accumulate(binlo[::-1], axis=0)[::-1]
                r_hi = np.maximum.accumulate(binhi[::-1], axis=0)[::-1]
                nl = np.cumsum(counts)
                nr = n - nl

                cost = (nl[:-1] * _area_rows(l_lo[:-1], l_hi[:-1])
                        + nr[:-1] * _area_rows(r_lo[1:], r_hi[1:]))
                cost = np.where((nl[:-1] == 0) | (nr[:-1] == 0),
                                np.inf, cost)
                i = int(np.argmin(cost))
                if cost[i] < best_cost:
                    best_cost = float(cost[i])
                    best = (ax, cmin, scale, i)

            if best is None:
                mid = s + n // 2
            else:
                ax, cmin, scale, i = best
                b = ((c[:, ax] - cmin) * scale).astype(np.int64)
                left_mask = b <= i
                o = np.argsort(~left_mask, kind='stable')
                perm[s:e] = idx[o]
                mid = s + int(left_mask.sum())
                if mid == s or mid == e:
                    mid = s + n // 2

        lc = alloc()
        rc = alloc()
        L[nid] = lc
        R[nid] = rc
        stack.append((s, mid, lc))
        stack.append((mid, e, rc))

    return dict(left=np.asarray(L, np.int64), right=np.asarray(R, np.int64),
                start=np.asarray(S, np.int64), count=np.asarray(C, np.int64),
                lo=np.asarray(NLo, np.float32),
                hi=np.asarray(NHi, np.float32), perm=perm)


def _collapse_tables(left, right, area, fanout):
    """Optimal BVH2 -> wide collapse DP tables (native kit when available,
    numpy otherwise). Returns (forcost (n, F+1) f64, jch (n, F+1) u8)."""
    from chroma_tpu import native
    out = native.collapse_dp(left, right, area, fanout)
    if out is not None:
        return out
    n = len(left)
    S = fanout + 1
    INF = 1e300
    forcost = np.zeros((n, S), np.float64)
    jch = np.zeros((n, S), np.uint8)
    idx = np.arange(1, fanout)
    for v in range(n - 1, -1, -1):
        if left[v] < 0:
            continue
        fl = forcost[left[v]]
        fr = forcost[right[v]]
        M = fl[1:fanout, None] + fr[None, 1:fanout]
        conv = np.full(S, INF)
        js = np.zeros(S, np.uint8)
        for i in range(2, S):
            jj = idx[:i - 1]
            vals = M[jj - 1, i - jj - 1]
            b = int(np.argmin(vals))
            conv[i] = vals[b]
            js[i] = jj[b]
        Cv = area[v] + conv[fanout]
        forcost[v, 0] = INF
        forcost[v, 1] = Cv
        better = conv < Cv
        forcost[v, 2:] = np.where(better[2:], conv[2:], Cv)
        jch[v, 2:] = np.where(better[2:], js[2:], 0)
    return forcost, jch


def _emit_wide_rows(bn, fanout, width, make_leaf_row, b0=0, fmt='f32'):
    """Collapse a binary SAH tree into tagged wide rows; children of each
    wide node form one contiguous block whose first row the parent
    stores. Returns (rows, leaf_row_of_binary_leaf, max_push_depth)."""
    left, right = bn['left'], bn['right']
    blo, bhi = bn['lo'], bn['hi']
    d = np.maximum(bhi - blo, 0.0)
    areas = (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
             + d[:, 2] * d[:, 0]).astype(np.float64)

    nnode = len(left)
    use_dp = os.environ.get('CHROMA_BVH_COLLAPSE', 'dp') != 'greedy'
    if use_dp:
        forcost, jch = _collapse_tables(left, right, areas, fanout)
    else:
        leafcount = np.ones(nnode, np.int64)
        for v in range(nnode - 1, -1, -1):
            if left[v] >= 0:
                leafcount[v] = leafcount[left[v]] + leafcount[right[v]]

    def _forest(u, i):
        j = int(jch[u, i]) if left[u] >= 0 else 0
        if j == 0:
            return [u]
        return _forest(int(left[u]), j) + _forest(int(right[u]), i - j)

    def _cut(bid):
        if use_dp:
            fl = forcost[left[bid]]
            fr = forcost[right[bid]]
            cand = fl[1:fanout] + fr[fanout - 1:0:-1]
            bj = 1 + int(np.argmin(cand))
            return (_forest(int(left[bid]), bj)
                    + _forest(int(right[bid]), fanout - bj))
        ch = [int(left[bid]), int(right[bid])]
        while len(ch) < fanout:
            bi, bk = -1, (1, -1.0)
            for j, c in enumerate(ch):
                k = (int(leafcount[c]), float(areas[c]))
                if left[c] >= 0 and k > bk:
                    bk, bi = k, j
            if bi < 0:
                break
            c = ch.pop(bi)
            ch.extend((int(left[c]), int(right[c])))
        return ch

    rows = []
    leaf_row_index = {}
    max_push_depth = 0

    def alloc_row():
        rows.append(np.zeros(width, np.float32))
        return len(rows) - 1

    root = 0
    if left[root] < 0:
        r = alloc_row()
        rows[r] = make_leaf_row(root)
        leaf_row_index[root] = r
        return np.stack(rows), leaf_row_index, 0

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        queue = [(root, alloc_row(), 0)]
        while queue:
            bid, rid, depth = queue.pop()
            max_push_depth = max(max_push_depth, depth)
            ch = _cut(bid)

            row = np.zeros(width, np.float32)
            clo = np.full((fanout, 3), np.nan, np.float32)
            chi = np.full((fanout, 3), np.nan, np.float32)
            if fmt == 'f32':
                row[b0:b0 + 6 * fanout] = np.nan
            first = None
            for j, c in enumerate(ch):
                crid = alloc_row()
                if first is None:
                    first = crid
                if fmt != 'f32':
                    clo[j] = blo[c]
                    chi[j] = bhi[c]
                else:
                    for ax in range(3):
                        row[b0 + ax * fanout + j] = blo[c][ax]
                        row[b0 + (3 + ax) * fanout + j] = bhi[c][ax]
                if left[c] >= 0:
                    queue.append((c, crid, depth + 1))
                else:
                    rows[crid] = make_leaf_row(c)
                    leaf_row_index[c] = crid
            nw = bounds_cols(fmt, fanout)
            if fmt != 'f32':
                row[b0:b0 + nw] = pack_bounds(fmt, clo, chi, fanout)
            row[b0 + nw] = np.int32(first).view(np.float32)
            row[width - 1] = np.int32(TAG_INTERNAL).view(np.float32)
            rows[rid] = row
    finally:
        sys.setrecursionlimit(old_limit)
    return np.stack(rows), leaf_row_index, max_push_depth


def _tri_leaf_row_maker(bn, tri, width, leaf_size, codes):
    "Leaf-row factory for triangle BLASes (local frame, local tri ids)."
    perm, start, count = bn['perm'], bn['start'], bn['count']

    def make(node_id):
        row = np.zeros(width, np.float32)
        block = row[:LEAF_STRIDE * leaf_size].reshape(leaf_size,
                                                      LEAF_STRIDE)
        block[:, 9] = np.float32(np.int32(-1).view(np.float32))
        ids = perm[start[node_id]:start[node_id] + count[node_id]]
        t = tri[ids]
        block[:len(ids), 0:3] = t[:, 0]
        block[:len(ids), 3:6] = t[:, 1] - t[:, 0]
        block[:len(ids), 6:9] = t[:, 2] - t[:, 0]
        block[:len(ids), 9] = ids.astype(np.int32).view(np.float32)
        block[:len(ids), 10] = codes[ids].view(np.float32)
        row[width - 1] = np.int32(TAG_LEAF).view(np.float32)
        return row

    return make


def _blas_rows(mesh, fanout, leaf_size, width, sah_threshold, codes,
               b0=0, fmt='f32'):
    """Local-frame BLAS rows for one unique mesh (codes: per-local-tri
    packed u32). Returns (rows (R, width) f32, max_push_depth)."""
    vertices = mesh.vertices.astype(np.float32)
    tri = vertices[mesh.triangles.astype(np.int64)]
    ntri = len(tri)
    if codes is None:
        codes = np.zeros(ntri, np.uint32)

    if ntri <= sah_threshold:
        bn = _binary_sah_build(tri.min(axis=1), tri.max(axis=1),
                               max_leaf=leaf_size)
        rows, _, depth = _emit_wide_rows(
            bn, fanout, width, _tri_leaf_row_maker(bn, tri, width,
                                                   leaf_size, codes),
            b0=b0, fmt=fmt)
        return rows, depth

    # very large unique mesh: Morton-leveled build at the f32 base fanout,
    # then tag the rows (repacking bounds into the compressed layout)
    base_fanout = fanout if fmt == 'f32' else FANOUT
    src, nb, max_depth = _morton_wide_rows(mesh, base_fanout, leaf_size,
                                           codes)
    rows = np.zeros((len(src), width), np.float32)
    if fmt != 'f32':
        bb = src[:nb, :6 * base_fanout].reshape(nb, 6, base_fanout)
        clo = np.full((nb, fanout, 3), np.nan, np.float32)
        chi = np.full((nb, fanout, 3), np.nan, np.float32)
        for ax in range(3):
            clo[:, :base_fanout, ax] = bb[:, ax]
            chi[:, :base_fanout, ax] = bb[:, 3 + ax]
        nw = bounds_cols(fmt, fanout)
        rows[:nb, b0:b0 + nw] = pack_bounds(fmt, clo, chi, fanout)
        rows[:nb, b0 + nw] = src[:nb, 6 * base_fanout]
    else:
        nw = 6 * fanout
        rows[:nb, b0:b0 + nw + 1] = src[:nb, :nw + 1]
    rows[nb:, :LEAF_STRIDE * leaf_size] = \
        src[nb:, :LEAF_STRIDE * leaf_size]
    rows[:nb, width - 1] = np.int32(TAG_INTERNAL).view(np.float32)
    rows[nb:, width - 1] = np.int32(TAG_LEAF).view(np.float32)
    return rows, max_depth


def table_stats(rows, fanout, leaf_size, fmt='bf16'):
    """Tree-quality statistics of an instanced row table (host numpy): row
    counts by type, TLAS/BLAS split, mean/min children per internal node,
    mean triangles per leaf and the expected-visit proxy (sum of internal
    box areas over the root area)."""
    rows = np.asarray(rows)
    w = rows.shape[1]
    tags = rows[:, w - 1].view(np.int32)
    internal = np.flatnonzero(tags == TAG_INTERNAL)
    leaf = np.flatnonzero(tags == TAG_LEAF)
    inst = np.flatnonzero(tags == TAG_INSTANCE)

    stats = {'rows': int(rows.shape[0]), 'width': int(w),
             'internal': int(len(internal)), 'leaf': int(len(leaf)),
             'instance': int(len(inst))}

    b = rows[internal]
    if fmt == 'bf16':
        pw = fanout // 2
        wd = b[:, INST_B0:INST_B0 + 3 * fanout].view(np.uint32)

        def _grp(g, half):
            words = wd[:, g * pw:(g + 1) * pw]
            bits = ((words & 0xFFFF) << 16) if half == 0 \
                else (words & np.uint32(0xFFFF0000))
            return bits.astype(np.uint32).view(np.float32)

        lo = np.concatenate(
            [np.stack([_grp(ax, h) for ax in range(3)], -1)
             for h in (0, 1)], axis=1)
        hi = np.concatenate(
            [np.stack([_grp(3 + ax, h) for ax in range(3)], -1)
             for h in (0, 1)], axis=1)
    elif fmt == 'f32':
        bb = b[:, INST_B0:INST_B0 + 6 * fanout].reshape(-1, 6, fanout)
        lo = np.moveaxis(bb[:, 0:3], 1, 2)
        hi = np.moveaxis(bb[:, 3:6], 1, 2)
    else:
        qw = fanout // 4
        anchor = b[:, INST_B0:INST_B0 + 3]
        scale = b[:, INST_B0 + 3:INST_B0 + 6]
        qwords = b[:, INST_B0 + 6:INST_B0 + 6 + 6 * qw].view(np.uint32)
        qb = np.stack([(qwords >> (8 * k)) & 0xFF for k in range(4)],
                      -1).reshape(len(b), 6, fanout // 4 * 4)[..., :fanout]
        lo = (anchor[:, None, :]
              + np.moveaxis(qb[:, 0:3].astype(np.float32), 1, 2)
              * scale[:, None, :])
        hi = (anchor[:, None, :]
              + np.moveaxis(qb[:, 3:6].astype(np.float32), 1, 2)
              * scale[:, None, :])
        lo = np.where((qb[:, 0:3] <= qb[:, 3:6]).transpose(0, 2, 1),
                      lo, np.nan)

    occupied = ~np.isnan(lo[..., 0])
    if fmt != 'q8':
        occupied &= ~np.isnan(hi[..., 0])
    occ = occupied.sum(axis=1)
    stats['mean_children'] = float(occ.mean()) if len(occ) else 0.0
    stats['min_children'] = int(occ.min()) if len(occ) else 0

    nlo = np.where(occupied[..., None], lo, np.inf).min(axis=1)
    nhi = np.where(occupied[..., None], hi, -np.inf).max(axis=1)
    d = np.maximum(nhi - nlo, 0.0)
    areas = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
    root_area = areas[internal == 0].sum() if (len(internal)
                                               and internal[0] == 0) \
        else (areas.max() if len(areas) else 1.0)
    stats['visit_proxy'] = float(areas.sum() / max(root_area, 1e-30))

    if len(inst):
        fc_col = INST_B0 + bounds_cols(fmt, fanout)
        roots = rows[inst, fc_col].view(np.int32)
        blas0 = int(roots.min())
        stats['tlas_internal'] = int((internal < blas0).sum())
        stats['blas_rows'] = int(rows.shape[0] - blas0)

    if len(leaf):
        tri = np.stack([rows[leaf, LEAF_STRIDE * k + 9].view(np.int32)
                        for k in range(leaf_size)], axis=1)
        stats['mean_leaf_tris'] = float((tri >= 0).sum(axis=1).mean())
    return stats


def check_table_stats(stats, fanout):
    """Loose sanity bounds on table_stats output; returns a list of
    violation strings (empty = healthy)."""
    bad = []
    if stats.get('internal', 0) >= 64:
        mc = stats.get('mean_children', 0.0)
        if mc < max(fanout * 0.25, 4.0):
            bad.append('under-filled wide nodes: mean %.1f children of '
                       '%d slots' % (mc, fanout))
        proxy = stats.get('visit_proxy', 0.0)
        if proxy > 60.0:
            bad.append('expected-visit proxy %.1f (healthy tables '
                       'measure <= ~30)' % proxy)
    if stats.get('leaf', 0) >= 64:
        if stats.get('mean_leaf_tris', 0.0) < 2.0:
            bad.append('nearly-empty leaves: mean %.2f triangles'
                       % stats.get('mean_leaf_tris', 0.0))
    return bad


def build_instanced_bvh(instances, fanout=None, leaf_size=LEAF_SIZE,
                        sah_threshold=200000, want_meta=False,
                        material_codes=None, packed_fanout=None,
                        bounds_fmt=None):
    """Build the two-level (TLAS/BLAS) tagged wide BVH; same arguments and
    result as chroma_tpu.bvh.wide.build_instanced_bvh, with the rows as a
    CPU torch tensor.

    instances: list of (mesh, rotation, displacement, tri_base), mapping
    local to world as x_w = rotation @ x_l + displacement. Non-rigid
    placements are baked into a world-frame copy of the mesh.
    material_codes: flat per-triangle packed u32 codes, baked into the BLAS
    leaf rows. want_meta=True also returns the dict the lean instance
    arrays are built from (ops.types.build_instance_arrays)."""
    if packed_fanout is None:
        packed_fanout = PACKED_FANOUT if fanout is None else 0
    packed = bool(packed_fanout)
    if fanout is None:
        fanout = FANOUT
    if packed:
        if packed_fanout % 2 or not 2 <= packed_fanout <= 32:
            raise ValueError('packed_fanout must be even and in [2, 32]')
        fanout = packed_fanout
    if bounds_fmt is None:
        bounds_fmt = os.environ.get('CHROMA_BVH_BOUNDS', 'bf16') \
            if packed else 'f32'
    if bounds_fmt == 'q8' and fanout % 4:
        raise ValueError('q8 bounds need fanout divisible by 4')
    fmt = bounds_fmt
    bound_cols = bounds_cols(fmt, fanout)
    width = _pad8(max(INST_B0 + bound_cols + 1, LEAF_STRIDE * leaf_size,
                      15) + 1)
    fc_col = INST_B0 + bound_cols
    ident = np.identity(3, np.float32)

    unique = []
    unique_codes = []
    mesh_index = {}
    inst = []              # (mesh_idx, rot_w2l (3,3), disp (3,), tri_base)
    for mesh, rot, disp, tri_base in instances:
        rot = ident if rot is None else np.asarray(rot, np.float32)
        disp = np.zeros(3, np.float32) if disp is None \
            else np.asarray(disp, np.float32)
        rigid = np.allclose(rot @ rot.T, ident, atol=1e-4)
        if not rigid:
            from chroma_tpu.geometry import Mesh
            mesh = Mesh(np.inner(mesh.vertices, rot) + disp,
                        mesh.triangles, remove_duplicate_vertices=False,
                        remove_null_triangles=False)
            rot, disp = ident, np.zeros(3, np.float32)
        if material_codes is None:
            codes = None
            key = (id(mesh), None)
        else:
            codes = np.asarray(
                material_codes[tri_base:tri_base + len(mesh.triangles)],
                np.uint32)
            key = (id(mesh), codes.tobytes())
        if key not in mesh_index:
            mesh_index[key] = len(unique)
            unique.append(mesh)
            unique_codes.append(codes)
        inst.append((mesh_index[key], rot.T.astype(np.float32),
                     disp.astype(np.float32), int(tri_base)))
    meta = dict(
        unique_meshes=unique,
        mesh_index=np.asarray([i[0] for i in inst], np.int32),
        rot_l2w=np.stack([i[1].T for i in inst]).astype(np.float32),
        tri_base=np.asarray([i[3] for i in inst], np.int64),
    ) if want_meta else None

    blas = [_blas_rows(m, fanout, leaf_size, width, sah_threshold, c,
                       b0=INST_B0, fmt=fmt)
            for m, c in zip(unique, unique_codes)]
    # exact instance world AABBs (min/max over the transformed vertices)
    n_inst = len(inst)
    ilo = np.empty((n_inst, 3), np.float32)
    ihi = np.empty((n_inst, 3), np.float32)
    rot_all = np.stack([i[1] for i in inst])
    disp_all = np.stack([i[2] for i in inst])
    mi_all = np.asarray([i[0] for i in inst])
    for mi in range(len(unique)):
        sel = np.flatnonzero(mi_all == mi)
        verts = unique[mi].vertices.astype(np.float32)
        for s in range(0, len(sel), 512):
            blk = sel[s:s + 512]
            wv = np.einsum('vk,iko->ivo', verts, rot_all[blk],
                           optimize=True)
            ilo[blk] = wv.min(axis=1) + disp_all[blk]
            ihi[blk] = wv.max(axis=1) + disp_all[blk]

    bn = _binary_sah_build(ilo, ihi, max_leaf=1)
    perm = bn['perm']

    def make_instance_row(node_id):
        iid = int(perm[bn['start'][node_id]])
        mi, r_w2l, disp, tri_base = inst[iid]
        row = np.zeros(width, np.float32)
        row[0:9] = r_w2l.reshape(-1)
        row[9:12] = disp
        row[12] = np.int32(tri_base).view(np.float32)
        row[13] = np.int32(iid).view(np.float32)
        # mesh index parked in the first-child column until the patch
        # below embeds the BLAS root
        row[fc_col] = np.int32(mi).view(np.float32)
        row[width - 1] = np.int32(TAG_INSTANCE).view(np.float32)
        return row

    tlas_rows, _, tlas_depth = _emit_wide_rows(
        bn, fanout, width, make_instance_row, b0=INST_B0, fmt=fmt)
    tlas_n = len(tlas_rows)

    # concatenate [TLAS | BLAS_0 | BLAS_1 | ...], fixing pointers
    offsets = np.cumsum([tlas_n] + [len(b[0]) for b in blas])[:-1] \
        if blas else np.array([], np.int64)
    all_rows = [tlas_rows]
    for off, (rows, _d) in zip(offsets, blas):
        rows = rows.copy()
        tags = rows[:, width - 1].view(np.int32)
        internal = tags == TAG_INTERNAL
        ptr = rows[internal, fc_col].view(np.int32) + np.int32(off)
        rows[internal, fc_col] = ptr.view(np.float32)
        all_rows.append(rows)
    table = np.concatenate(all_rows, axis=0)

    # instance rows embed their BLAS root's child bounds + pointer; a root
    # that is itself a leaf gets one synthetic box (the mesh's local AABB)
    tags = table[:, width - 1].view(np.int32)
    inst_rows = np.flatnonzero(tags == TAG_INSTANCE)
    mi_of = table[inst_rows, fc_col].view(np.int32)
    roots = offsets[mi_of]
    root_internal = tags[roots] == TAG_INTERNAL
    span = slice(INST_B0, fc_col + 1)
    table[inst_rows[root_internal], span] = \
        table[roots[root_internal], span]
    for mi in np.unique(mi_of[~root_internal]):
        v = unique[mi].vertices.astype(np.float32)
        clo = np.full((fanout, 3), np.nan, np.float32)
        chi = np.full((fanout, 3), np.nan, np.float32)
        clo[0] = v.min(axis=0)
        chi[0] = v.max(axis=0)
        sel = inst_rows[(~root_internal) & (mi_of == mi)]
        if fmt != 'f32':
            table[np.ix_(sel, np.arange(INST_B0, fc_col))] = \
                pack_bounds(fmt, clo, chi, fanout)
        else:
            table[np.ix_(sel, np.arange(INST_B0, fc_col))] = \
                np.concatenate([clo[:, 0], clo[:, 1], clo[:, 2],
                                chi[:, 0], chi[:, 1], chi[:, 2]])
        table[sel, fc_col] = offsets[mi].astype(np.int32) \
            .view(np.float32)

    blas_depth = max((d for _r, d in blas), default=0)
    max_depth = tlas_depth + 1 + blas_depth + 1

    stats = table_stats(table, fanout, leaf_size, fmt)
    logger.info('instanced BVH: %d rows (%d tlas-internal, %d instance, '
                '%d blas), mean children %.1f, visit proxy %.1f',
                stats['rows'], stats.get('tlas_internal', 0),
                stats['instance'], stats.get('blas_rows', 0),
                stats['mean_children'], stats['visit_proxy'])
    for v in check_table_stats(stats, fanout):
        logger.warning('instanced BVH quality: %s', v)

    built = InstancedBVH(
        rows=torch.from_numpy(table),
        max_depth=int(max_depth),
        fanout=fanout,
        leaf_size=leaf_size,
        n_instances=n_inst,
        packed=packed,
        bounds_fmt=fmt,
    )
    if want_meta:
        return built, meta
    return built
