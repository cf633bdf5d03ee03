"""Analytic wire-plane intersection for the torch port (counterpart of
chroma_tpu.ops.wireplane): a periodic array of parallel cylinders.

The f32 reformulation of the JAX package is kept: the (u, v, n) wire frame
is orthonormalised on the host (chroma_tpu_torch.ops.types), positions are
taken relative to the plane origin, and the candidate wire's centre
(k * pitch) is subtracted before any squaring.

JAX walks each photon's candidate-wire window [k_lo, k_hi] in a lockstep
while_loop that runs while any lane is still inside its window. Eager torch
would pay a host sync per wire for that condition, so the loop here reads
the batch's widest window once per plane (one sync) and runs that many
masked iterations: every lane sees the same k sequence, so the result is
the same.

The quadratic in the loop cancels badly for rays far from the plane
(b^2 against a*c), so its rounding decides hits near a wire's edge. XLA
on the CPU contracts `x * y + z` into fused multiply-adds there, and the
port computes the same FMAs (in f64, exact for f32 products, then one
rounding), which makes it bit-equal to the JAX function on the CPU. On
the card every one of these ops is correctly rounded too, so CPU and
CUDA results are equal.
"""
from __future__ import annotations

import dataclasses

import torch

from chroma_tpu_torch.ops.linalg import dot, fma


def _fma_dot(a, b):
    "The sum over the 3 components, contracted as XLA contracts it."
    return fma(a[..., 2], b[..., 2],
               fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


T_MIN = 1e-4        # self-hit epsilon, mm (reference: photon.h:225)
PAD_EPS = 1e-6
MAX_WINDOW = 4096.0  # candidate wires per plane beyond the first


@dataclasses.dataclass
class WirePlaneHit:
    hit: torch.Tensor                # (N,) bool
    distance: torch.Tensor           # (N,) f32
    normal: torch.Tensor             # (N,3) f32, faces the incoming photon
    material1: torch.Tensor          # (N,) i32
    material2: torch.Tensor          # (N,) i32
    surface: torch.Tensor            # (N,) i32
    inside_to_outside: torch.Tensor  # (N,) bool


def _plane_window(pos, direction, wp, ip, active):
    """Per-lane set-up of plane `ip`: the u-extent slab, the candidate
    window in t and in wire index k (reference: photon.h:137-213)."""
    u_ax, v_ax, n_ax = wp.u[ip], wp.v[ip], wp.w[ip]
    pitch, radius = wp.pitch[ip], wp.radius[ip]
    umin, umax = wp.umin[ip], wp.umax[ip]
    vmin, vmax = wp.vmin[ip], wp.vmax[ip]
    v0 = wp.v0[ip]

    w = pos - wp.origin[ip]
    du = _fma_dot(direction, u_ax)
    dv = _fma_dot(direction, v_ax)
    dn = _fma_dot(direction, n_ax)
    wu = _fma_dot(w, u_ax)
    wv0 = _fma_dot(w, v_ax) - v0
    wn0 = _fma_dot(w, n_ax)

    pad = 0.5 * (2.0 * radius) + PAD_EPS

    parallel_u = torch.abs(du) < 1e-12
    inv_du = 1.0 / torch.where(parallel_u, 1.0, du)
    tu1 = (umin - wu) * inv_du
    tu2 = (umax - wu) * inv_du
    t_in = torch.where(parallel_u, -torch.inf, torch.minimum(tu1, tu2))
    t_out = torch.where(parallel_u, torch.inf, torch.maximum(tu1, tu2))
    valid = torch.where(parallel_u, (wu >= umin) & (wu <= umax),
                        t_in <= t_out) & active

    kmin = torch.ceil((vmin - v0) / pitch)
    kmax = torch.floor((vmax - v0) / pitch)

    t_lo = torch.clamp(t_in, min=T_MIN)
    t_hi = t_out

    parallel_n = torch.abs(dn) <= 1e-9
    inv_dn = 1.0 / torch.where(parallel_n, 1.0, dn)
    tn1 = (-pad - wn0) * inv_dn
    tn2 = (pad - wn0) * inv_dn
    t_lo = torch.where(parallel_n, t_lo,
                       torch.maximum(t_lo, torch.minimum(tn1, tn2)))
    t_hi = torch.where(parallel_n, t_hi,
                       torch.minimum(t_hi, torch.maximum(tn1, tn2)))
    valid = valid & (~parallel_n | (torch.abs(wn0) <= pad))
    valid = valid & (t_hi >= t_lo)

    # grazing in-plane rays only need to look one period ahead
    grazing = parallel_n & (torch.abs(dv) > 1e-9)
    span = (pitch + 2.0 * radius) / torch.clamp(torch.abs(dv), min=1e-12)
    t_hi = torch.where(grazing, torch.minimum(t_hi, t_lo + span), t_hi)

    v_entry = fma(dv, t_lo, wv0)
    v_exit = fma(dv, t_hi, wv0)
    v_lo = torch.minimum(torch.minimum(v_entry, v_exit), wv0) - pad
    v_hi = torch.maximum(torch.maximum(v_entry, v_exit), wv0) + pad

    k_lo = torch.maximum(torch.floor(v_lo / pitch), kmin)
    k_hi = torch.minimum(torch.ceil(v_hi / pitch), kmax)
    valid = valid & (k_lo <= k_hi)
    # a finite iteration count even for degenerate rays
    k_hi = torch.minimum(k_hi, k_lo + MAX_WINDOW)
    return (valid, k_lo, k_hi, t_in, t_out, du, dv, dn, wu, wv0, wn0,
            pitch, radius, umin, umax)


def candidate_windows(pos, direction, geometry, active):
    """Candidate wires each lane visits, per plane: a list of (N,) i64
    tensors, 0 where the lane cannot meet the plane."""
    wp = geometry.wireplanes
    out = []
    for ip in range(wp.pitch.shape[0]):
        valid, k_lo, k_hi = _plane_window(pos, direction, wp, ip, active)[:3]
        out.append(torch.where(valid, k_hi - k_lo + 1.0, 0.0)
                   .to(torch.int64))
    return out


def _intersect_one_plane(pos, direction, wp, ip, active):
    """Nearest wire hit for plane `ip`: (t, vn, nn), t = +inf without a
    hit; (vn, nn) are the hit point's transverse coordinates about the hit
    wire's axis, which give the outward cylinder normal."""
    n = pos.shape[0]
    (valid, k_lo, k_hi, t_in, t_out, du, dv, dn, wu, wv0, wn0, pitch,
     radius, umin, umax) = _plane_window(pos, direction, wp, ip, active)

    a_coef = fma(dv, dv, dn * dn)
    r2 = radius * radius
    eps0 = torch.clamp(1e-6 * r2, min=1e-12)
    inv_a = 1.0 / torch.where(a_coef > 0.0, a_coef, 1.0)

    best_t = torch.full((n,), torch.inf, dtype=torch.float32,
                        device=pos.device)
    best_vn = torch.zeros(n, dtype=torch.float32, device=pos.device)
    best_nn = torch.zeros(n, dtype=torch.float32, device=pos.device)
    # the batch's widest window: the lockstep loop's trip count (one sync)
    iters = int(torch.where(valid, k_hi - k_lo + 1.0, 0.0).max()) if n else 0
    k = torch.where(valid, k_lo, k_hi + 1.0)
    for _ in range(iters):
        live = valid & (k <= k_hi)
        wv = fma(-k, pitch, wv0)
        b_coef = fma(wv, dv, wn0 * dn)
        r2_0 = fma(wv, wv, wn0 * wn0)
        c_coef = r2_0 - r2
        disc = fma(b_coef, b_coef, -(a_coef * c_coef))
        ok = live & (disc >= 0.0) & (a_coef > 0.0)
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t_small = (-b_coef - sq) * inv_a
        t_large = (-b_coef + sq) * inv_a

        outside = r2_0 > r2 + eps0
        inside = r2_0 < r2 - eps0
        t = torch.where(outside, t_small,
                        torch.where(inside, t_large, T_MIN))
        ok = ok & torch.where(outside, t_small > T_MIN,
                              torch.where(inside, t_large > T_MIN, True))

        uc = fma(du, t, wu)
        ok = ok & (uc >= umin) & (uc <= umax)
        ok = ok & (t >= t_in) & (t <= t_out)
        ok = ok & (t < best_t)

        best_t = torch.where(ok, t, best_t)
        best_vn = torch.where(ok, fma(dv, t, wv), best_vn)
        best_nn = torch.where(ok, fma(dn, t, wn0), best_nn)
        k = k + 1.0
    return best_t, best_vn, best_nn


def intersect_wireplanes(pos, direction, geometry, active):
    """Nearest analytic wire hit over all planes, with material and surface
    classification (reference: photon.h:272-354)."""
    wp = geometry.wireplanes
    n = pos.shape[0]
    dev = pos.device

    best_t = torch.full((n,), torch.inf, dtype=torch.float32, device=dev)
    best_plane = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_vn = torch.zeros(n, dtype=torch.float32, device=dev)
    best_nn = torch.zeros(n, dtype=torch.float32, device=dev)

    for ip in range(wp.pitch.shape[0]):
        t, vn, nn = _intersect_one_plane(pos, direction, wp, ip, active)
        closer = t < best_t
        best_t = torch.where(closer, t, best_t)
        best_plane = torch.where(closer, ip, best_plane)
        best_vn = torch.where(closer, vn, best_vn)
        best_nn = torch.where(closer, nn, best_nn)

    hit = best_plane >= 0
    plane = torch.clamp(best_plane, min=0)

    # outward cylinder normal in world coordinates
    length = torch.sqrt(fma(best_vn, best_vn, best_nn * best_nn))
    inv_len = 1.0 / torch.where(length > 0, length, 1.0)
    n_world = fma((best_vn * inv_len)[:, None], wp.v[plane],
                  (best_nn * inv_len)[:, None] * wp.w[plane])

    outside_now = dot(n_world, -direction) > 0.0
    mat_in = wp.material_inner_index[plane]
    mat_out = wp.material_outer_index[plane]
    return WirePlaneHit(
        hit=hit, distance=best_t,
        normal=torch.where(outside_now[:, None], n_world, -n_world),
        material1=torch.where(outside_now, mat_out, mat_in),
        material2=torch.where(outside_now, mat_in, mat_out),
        surface=wp.surface_index[plane],
        inside_to_outside=~outside_now)
