"""Instanced wide-BVH traversal in plain PyTorch (counterpart of the
instanced part of chroma_tpu.ops.mesh_wide).

This is the plain version of the CUDA visit kernel
(chroma_tpu_torch.ops.visit_kernel): the lockstep visit loop of the JAX
package, one fat-row gather per visit, vectorised over the lanes that are
still walking. Each visit sweeps all F children of an internal or
instance row (slab test on f32, bf16-pair or q8 bounds) and all K
triangles of a leaf row (Moller-Trumbore), descends nearest-first and
pops the highest pending sibling group. Instance rows rotate the world ray
into the instance frame; popping above the instance's depth restores the
world registers.

Lane registers are (N,) tensors; the (base, pending-mask) stacks are
(N, D). u32 words (bitmasks, codes) are int32 bit patterns; shifts that
reach bit 31 are done in int64 and wrapped back. The per-child and
per-triangle loops of the JAX body become (N, F) and (N, K) tensors: the
nearest child and the closest triangle are the first minimum, which is
what the sequential strict-less scans select.
"""
from __future__ import annotations

import torch

from chroma_tpu_torch.bvh.wide import (TAG_INTERNAL, TAG_LEAF, TAG_INSTANCE,
                                       INST_B0, LEAF_STRIDE, bounds_cols,
                                       fmt_of)

EPSILON = 1e-6
FLT_EPSILON = 1.19209290e-07

IBIG = 127  # d_inst sentinel: lane is in the world frame

_Q8_SHIFTS = (0, 8, 16, 24)


def safe_inv(direction):
    """1/direction with exactly-zero components nudged to 1e-25 first, so
    the inverse is finite on every axis and the slab test needs no
    zero-direction fallback."""
    return 1.0 / torch.where(direction == 0.0, 1e-25, direction)


def _wrap32(x):
    "int64 holding a 32-bit word -> int32 with two's-complement wrap."
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _ctz32_i32(m):
    """Index of the lowest set bit of an int32 bitmask (32 for m == 0), by
    the float-exponent trick: the isolated low bit is a power of two, exact
    in f32 up to bit 31."""
    u = m.to(torch.int64) & 0xFFFFFFFF
    low = (u & -u).to(torch.float32)
    e = ((low.view(torch.int32) >> 23) & 0xFF) - 127
    return torch.where(m == 0, 32, e).to(torch.int32)


def _child_bounds(gi, g, f, fmt, b0):
    """Decoded child bounds (M, 6, F) f32 [lo_x, lo_y, lo_z, hi_x, hi_y,
    hi_z] of f32 / bf16-pair rows; empty bf16 slots decode NaN."""
    m = g.shape[0]
    if fmt == 'bf16':
        pw = f // 2
        words = gi[:, b0:b0 + 3 * f].reshape(m, 6, pw)
        lo = _wrap32(words.to(torch.int64) << 16).view(torch.float32)
        hi = (words & -65536).view(torch.float32)
        return torch.cat([lo, hi], dim=2)
    return g[:, b0:b0 + 6 * f].reshape(m, 6, f)


def _child_sweep(g, gi, f, org, inv, neg, best_d, active, fmt, b0):
    """Slab test of all F children of the fetched rows. org/inv/neg: (M, 3)
    frame-local origin, finite inverse direction and -origin*inverse.
    Returns (hitmask (M,) int64 holding the u32 bitmask, nearest hit child
    (M,) int32). Padding children carry NaN bounds: NaN propagates through
    torch.minimum/maximum and every comparison is false."""
    m = g.shape[0]
    valid = None
    if fmt == 'q8':
        qw = f // 4
        anc = g[:, b0:b0 + 3]
        scl = g[:, b0 + 3:b0 + 6]
        q_s = (scl * inv)[:, :, None]
        q_a = (anc * inv + neg)[:, :, None]
        words = gi[:, b0 + 6:b0 + 6 + 6 * qw].reshape(m, 6, qw, 1)
        shifts = torch.tensor(_Q8_SHIFTS, dtype=torch.int32,
                              device=g.device)
        qb = ((words >> shifts) & 0xFF).reshape(m, 6, f).to(torch.float32)
        valid = qb[:, 0] <= qb[:, 3]
        t0 = qb[:, 0:3] * q_s + q_a
        t1 = qb[:, 3:6] * q_s + q_a
    else:
        b = _child_bounds(gi, g, f, fmt, b0)
        t0 = b[:, 0:3] * inv[:, :, None] + neg[:, :, None]
        t1 = b[:, 3:6] * inv[:, :, None] + neg[:, :, None]
    sm = torch.minimum(t0, t1)
    bg = torch.maximum(t0, t1)
    zero = torch.zeros((), dtype=torch.float32, device=g.device)
    tmin = torch.maximum(torch.maximum(sm[:, 0], sm[:, 1]),
                         torch.maximum(sm[:, 2], zero))
    tmax = torch.minimum(torch.minimum(bg[:, 0], bg[:, 1]), bg[:, 2])
    hit = (tmin <= tmax) & (tmin <= best_d[:, None]) & active[:, None]
    if valid is not None:
        hit = hit & valid
    bits = torch.arange(f, dtype=torch.int64, device=g.device)
    hitmask = (hit.to(torch.int64) << bits).sum(dim=1)
    nearest = torch.where(hit, tmin, torch.inf).argmin(dim=1)
    return hitmask, nearest.to(torch.int32)


def _leaf_sweep(g, gi, k, org, dirn, last_hit, active, tbase, iid, best):
    """Moller-Trumbore over all K triangles of the fetched leaf rows
    (stride 11: v0, e1, e2, local tri, material code). best = (tri, dist,
    code, normal (M, 3), iid) of the lanes so far; returns it updated with
    the closest valid hit nearer than dist."""
    m = g.shape[0]
    blk = g[:, :LEAF_STRIDE * k].reshape(m, k, LEAF_STRIDE)
    iblk = gi[:, :LEAF_STRIDE * k].reshape(m, k, LEAF_STRIDE)
    v0x, v0y, v0z = blk[..., 0], blk[..., 1], blk[..., 2]
    e1x, e1y, e1z = blk[..., 3], blk[..., 4], blk[..., 5]
    e2x, e2y, e2z = blk[..., 6], blk[..., 7], blk[..., 8]
    tri = iblk[..., 9]
    code = iblk[..., 10]
    tri_g = tri + tbase[:, None]
    ox, oy, oz = org[:, 0:1], org[:, 1:2], org[:, 2:3]
    dx, dy, dz = dirn[:, 0:1], dirn[:, 1:2], dirn[:, 2:3]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    parallel = torch.abs(a) <= FLT_EPSILON
    finv = 1.0 / torch.where(parallel, 1.0, a)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = finv * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = finv * (dx * qx + dy * qy + dz * qz)
    t = finv * (e2x * qx + e2y * qy + e2z * qz)
    ok = (~parallel
          & (u >= -EPSILON) & (u <= 1.0 + EPSILON)
          & (v >= -EPSILON) & (u + v <= 1.0 + EPSILON)
          & (t > EPSILON) & torch.isfinite(t)
          & (tri >= 0)
          & (tri_g != last_hit[:, None])
          & active[:, None])
    tk = torch.where(ok, t, torch.inf)
    kb = tk.argmin(dim=1, keepdim=True)
    t_b = tk.gather(1, kb)[:, 0]

    def at(x):
        return x.gather(1, kb)[:, 0]

    b_tri, b_d, b_code, b_n, b_iid = best
    closer = t_b < b_d
    e1 = [at(e1x), at(e1y), at(e1z)]
    e2 = [at(e2x), at(e2y), at(e2z)]
    nrm = torch.stack([e1[1] * e2[2] - e1[2] * e2[1],
                       e1[2] * e2[0] - e1[0] * e2[2],
                       e1[0] * e2[1] - e1[1] * e2[0]], dim=1)
    return (torch.where(closer, at(tri_g), b_tri),
            torch.where(closer, t_b, b_d),
            torch.where(closer, at(code), b_code),
            torch.where(closer[:, None], nrm, b_n),
            torch.where(closer, iid, b_iid))


def traverse(inst, origin, direction, last_hit=None, mask=None,
             best_limit=None):
    """Run the instanced traversal to completion on any device.

    origin/direction: (N, 3) f32 world rays; last_hit: (N,) i32 excluded
    triangle; mask: (N,) bool lanes to trace; best_limit: (N,) f32 initial
    bound on the hit distance. Returns (tri (N,) i32 -1 = miss, dist (N,)
    f32 (+inf or best_limit on a miss), code (N,) i32 packed material code
    (u32 bits), normal (N, 3) unnormalised in the winning instance's local
    frame, iid (N,) i32 owning instance, visits (N,) i32)."""
    dev = origin.device
    n = origin.shape[0]
    rows = inst.rows
    width = rows.shape[1]
    f = inst.fanout
    k = inst.leaf_size
    d_max = inst.max_depth
    fmt = fmt_of(inst)
    fc_col = INST_B0 + bounds_cols(fmt, f)
    i32 = dict(dtype=torch.int32, device=dev)

    if last_hit is None:
        last_hit = torch.full((n,), -1, **i32)
    world = torch.cat([origin, direction], dim=1).to(torch.float32)
    cur = torch.zeros(n, **i32)
    if mask is not None:
        cur = torch.where(mask, cur, -1)
    depth = torch.zeros(n, **i32)
    bases = torch.zeros((n, d_max), **i32)
    masks = torch.zeros((n, d_max), **i32)
    loc = world.clone()
    d_inst = torch.full((n,), IBIG, **i32)
    tbase = torch.zeros(n, **i32)
    iid = torch.zeros(n, **i32)
    b_tri = torch.full((n,), -1, **i32)
    b_d = torch.full((n,), torch.inf, dtype=torch.float32, device=dev)
    if best_limit is not None:
        b_d = best_limit.to(torch.float32).clone()
    b_code = torch.zeros(n, **i32)
    b_n = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    b_iid = torch.zeros(n, **i32)
    visits = torch.zeros(n, **i32)
    slots = torch.arange(d_max, **i32)[None, :]

    while True:
        a = torch.nonzero(cur >= 0)[:, 0]
        if a.numel() == 0:
            break
        visits[a] += 1
        c_a, dep_a = cur[a], depth[a]
        st_b, st_m = bases[a], masks[a]
        w_a, loc_a = world[a], loc[a]
        di_a, tb_a, id_a = d_inst[a], tbase[a], iid[a]

        g = rows[c_a.to(torch.int64)]
        gi = g.view(torch.int32)
        tag = gi[:, width - 1]
        internal = tag == TAG_INTERNAL
        at_leaf = tag == TAG_LEAF
        is_inst = tag == TAG_INSTANCE

        # instance entry: rotate the world ray into the instance frame;
        # the instance row embeds its BLAS root's child bounds, so entry
        # and root sweep happen in this visit
        px = w_a[:, 0] - g[:, 9]
        py = w_a[:, 1] - g[:, 10]
        pz = w_a[:, 2] - g[:, 11]
        wdx, wdy, wdz = w_a[:, 3], w_a[:, 4], w_a[:, 5]
        entered = torch.stack(
            [g[:, 0] * px + g[:, 1] * py + g[:, 2] * pz,
             g[:, 3] * px + g[:, 4] * py + g[:, 5] * pz,
             g[:, 6] * px + g[:, 7] * py + g[:, 8] * pz,
             g[:, 0] * wdx + g[:, 1] * wdy + g[:, 2] * wdz,
             g[:, 3] * wdx + g[:, 4] * wdy + g[:, 5] * wdz,
             g[:, 6] * wdx + g[:, 7] * wdy + g[:, 8] * wdz], dim=1)
        sweep_loc = torch.where(is_inst[:, None], entered, loc_a)
        o_cc, d_cc = sweep_loc[:, 0:3], sweep_loc[:, 3:6]
        inv = safe_inv(d_cc)
        neg = -o_cc * inv

        sweeping = internal | is_inst
        hitmask, nearest = _child_sweep(g, gi, f, o_cc, inv, neg, b_d[a],
                                        sweeping, fmt, INST_B0)
        best = _leaf_sweep(g, gi, k, o_cc, d_cc, last_hit[a], at_leaf,
                           tb_a, id_a,
                           (b_tri[a], b_d[a], b_code[a], b_n[a], b_iid[a]))
        first_child = gi[:, fc_col]

        # descend to the nearest hit child; instance-frame registers commit
        # only when the entry actually descends
        will = sweeping & (hitmask != 0)
        ei = is_inst & will
        loc_a = torch.where(ei[:, None], entered, loc_a)
        di_a = torch.where(ei, dep_a, di_a)
        tb_a = torch.where(ei, gi[:, 12], tb_a)
        id_a = torch.where(ei, gi[:, 13], id_a)
        rest = torch.where(
            will, _wrap32(hitmask & ~(1 << nearest.to(torch.int64))), 0)
        push = will[:, None] & (slots == dep_a[:, None])
        st_b = torch.where(push, first_child[:, None], st_b)
        st_m = torch.where(push, rest[:, None], st_m)
        c_a = torch.where(will, first_child + nearest, c_a)
        dep_a = torch.where(will, dep_a + 1, dep_a)

        # pop: jump straight to the highest pending sibling group
        need = ~will
        cand = (st_m != 0) & (slots < dep_a[:, None])
        top = torch.where(cand.any(dim=1),
                          d_max - 1 - cand.flip(1).to(torch.uint8)
                          .argmax(dim=1), -1).to(torch.int32)
        found = need & (top >= 0)
        tsel = slots == top[:, None]
        pm = torch.where(tsel, st_m, 0).sum(dim=1, dtype=torch.int32)
        pm64 = pm.to(torch.int64) & 0xFFFFFFFF
        st_m = torch.where(found[:, None] & tsel,
                           _wrap32(pm64 & (pm64 - 1))[:, None], st_m)
        base_at_top = torch.where(tsel, st_b, 0).sum(dim=1,
                                                     dtype=torch.int32)
        c_a = torch.where(found, base_at_top + _ctz32_i32(pm),
                          torch.where(need & (top < 0), -1, c_a))
        dep_a = torch.where(found, top + 1, dep_a)

        # leaving the instance: restore the world-frame registers
        leaving = (di_a != IBIG) & (dep_a <= di_a)
        loc_a = torch.where(leaving[:, None], w_a, loc_a)
        tb_a = torch.where(leaving, 0, tb_a)
        di_a = torch.where(leaving, IBIG, di_a)

        cur[a], depth[a] = c_a, dep_a
        bases[a], masks[a] = st_b, st_m
        loc[a], d_inst[a], tbase[a], iid[a] = loc_a, di_a, tb_a, id_a
        b_tri[a], b_d[a], b_code[a], b_n[a], b_iid[a] = best

    return b_tri, b_d, b_code, b_n, b_iid, visits


def intersect_mesh_instanced(origin, direction, inst,
                             last_hit_triangle=None, mask=None,
                             best_limit=None, want_context=False):
    """Nearest-triangle query against an InstancedBVH, plain PyTorch (the
    contract of chroma_tpu.ops.mesh_wide.intersect_mesh_instanced without
    staging). Returns (tri, dist), or with want_context=True (tri, dist,
    code (u32 bits as i32), normal (N, 3) local-frame unnormalised,
    iid)."""
    tri, dist, code, normal, iid, _ = traverse(
        inst, origin, direction, last_hit_triangle, mask, best_limit)
    if want_context:
        return tri, dist, code, normal, iid
    return tri, dist


def traversal_visits(origin, direction, inst, last_hit_triangle=None,
                     mask=None, best_limit=None):
    """Per-lane traversal visit counts: (visits (N,) i32, tri, dist)."""
    tri, dist, _, _, _, visits = traverse(
        inst, origin, direction, last_hit_triangle, mask, best_limit)
    return visits, tri, dist
