"""Ray-traced geometry rendering on a device (counterpart of
chroma_tpu.ops.render; device analog of chroma/cuda/render.cu and
hybrid_render.cu).

Per pixel, the `alpha_depth` nearest surface crossings along the ray are
collected by depth peeling and their cosine-shaded triangle colors are
alpha-composited front to back: each layer re-traces from the previous hit,
excluding the triangle it sits on, with the traversal the simulation uses
(chroma_tpu_torch.ops.visit_kernel.traverse: the CUDA kernel on CUDA
tensors, the plain walk on CPU tensors). Rays that missed are masked out of
the later layers, and the peeling stops once no ray is left, which changes
no pixel: a layer without hits adds nothing.

Packed ARGB words (triangle colors, pixels) are int32 bit patterns, as
everywhere in the port; `pixels_to_host` hands the host their uint32 view.
The compositing follows the JAX package's CPU rounding where a floor()
would turn an ulp into a count: `pos + dist * direction` and the
background's `f + scale * bg` are fused multiply-adds.
"""
from __future__ import annotations

import numpy as np
import torch

from chroma_tpu_torch.event import REFLECT_DIFFUSE, TERMINAL_FLAGS
from chroma_tpu_torch.ops import visit_kernel
from chroma_tpu_torch.ops.linalg import cross, dot, fma, normalize
from chroma_tpu_torch.ops.mesh_wide import _wrap32
from chroma_tpu_torch.ops.photon import (PhotonState, i32, propagate_step,
                                         select)
from chroma_tpu_torch.ops.sample import DrawPool, make_generator
from chroma_tpu_torch.profiler import profiler

# generator id of a hybrid-render batch's photon source: (seed, batch,
# SOURCE_SITE), beside its steps' (seed, batch, step)
SOURCE_SITE = 6000


def _unit(direction):
    """Contiguous f32 unit vectors of (N,3) ray directions. The squares are
    summed by fused multiply-adds in index order, each rounded once, so the
    CPU and a card give the same bits (a library norm may not), and almost
    always those of the JAX package's CPU norm. From a camera on a
    detector's axis whole rows of rays run along the meridian edges of its
    sphere, where an ulp of the direction decides between two triangles."""
    direction = direction.to(torch.float32)
    x, y, z = direction[:, 0], direction[:, 1], direction[:, 2]
    length = torch.sqrt(fma(z, z, fma(y, y, x * x)))
    return (direction / length[:, None]).contiguous()


def pixels_to_host(pixels):
    "(N,) int32 ARGB bit patterns on any device -> numpy uint32."
    return pixels.cpu().numpy().view(np.uint32)


def _channels(rgba):
    "The (a, r, g, b) bytes of packed ARGB int32 words, as f32."
    return tuple(((rgba >> s) & 0xFF).to(torch.float32)
                 for s in (24, 16, 8, 0))


def _shade(direction, normal, rgba):
    "Cosine-shaded color + alpha from a packed ARGB color (render.cu:12-33)."
    cos_theta = torch.abs(dot(normal, -direction))
    a0, r0, g0, b0 = _channels(rgba)
    alpha = (255.0 - a0) / 255.0
    return r0 * cos_theta, g0 * cos_theta, b0 * cos_theta, alpha


def _dense(geometry):
    "Raise unless the geometry carries its per-triangle normals and colors."
    if geometry.tri_normals is None or geometry.colors is None:
        raise ValueError(
            'rendering needs the per-triangle normals and colors, which a '
            'lean geometry leaves out: build it dense (CHROMA_LEAN=0) or '
            'load the geocache with lean=False')


def peel(origin, direction, geometry, alpha_depth):
    """The depth layers of `render`: yields (tri, dist) of each layer's
    nearest crossing, tri -1 where the ray (or an earlier layer of it)
    missed. `direction` is normalized. Stops early when no ray is left."""
    n = origin.shape[0]
    dev = origin.device
    pos = origin
    last_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    for layer in range(alpha_depth):
        tri, dist, _, _, _, _ = visit_kernel.traverse(
            geometry.wide, pos, direction, last_tri,
            mask=None if layer == 0 else active)
        yield tri, dist
        hit = tri >= 0
        if not bool(hit.any()):
            return
        pos = torch.where(hit[:, None],
                          fma(dist[:, None], direction, pos), pos)
        last_tri = torch.where(hit, tri, last_tri)
        active = active & hit


def render(origin, direction, geometry, alpha_depth=10,
           bg_color=0xFFFFFFFF):
    """Render rays against the geometry.

    origin/direction: (N,3) f32 on the geometry's device (direction need
    not be normalized). Returns (N,) int32 ARGB pixels (u32 bit patterns).
    """
    _dense(geometry)
    with profiler.region('render.peel'):
        n = origin.shape[0]
        dev = origin.device
        origin = origin.to(torch.float32).contiguous()
        direction = _unit(direction)

        fr = torch.zeros(n, dtype=torch.float32, device=dev)
        fg = torch.zeros_like(fr)
        fb = torch.zeros_like(fr)
        scale = torch.ones_like(fr)
        hits = torch.zeros(n, dtype=torch.int32, device=dev)

        for tri, _ in peel(origin, direction, geometry, alpha_depth):
            hit = tri >= 0
            safe = torch.where(hit, tri, 0).to(torch.int64)
            r, g, b, alpha = _shade(direction, geometry.tri_normals[safe],
                                    geometry.colors[safe])
            fr = fr + torch.where(hit, scale * r * alpha, 0.0)
            fg = fg + torch.where(hit, scale * g * alpha, 0.0)
            fb = fb + torch.where(hit, scale * b * alpha, 0.0)
            scale = torch.where(hit, scale * (1.0 - alpha), scale)
            hits = hits + hit.to(torch.int32)

        # composite the background
        bg = int(bg_color) & 0xFFFFFFFF
        bga = np.float32((bg >> 24) & 0xFF) / np.float32(255.0)
        bgr, bgg, bgb = (np.float32((bg >> s) & 0xFF) for s in (16, 8, 0))
        fr = fma(scale, torch.full_like(scale, bgr * bga), fr)
        fg = fma(scale, torch.full_like(scale, bgg * bga), fg)
        fb = fma(scale, torch.full_like(scale, bgb * bga), fb)
        scale = scale * float(np.float32(1.0) - bga)

        denom = torch.clamp(1.0 - scale, min=1e-20)
        a_out = torch.where(hits < alpha_depth,
                            torch.floor(255.0 * (1.0 - scale)), 255.0)
        red = torch.floor(fr / denom)
        green = torch.floor(fg / denom)
        blue = torch.floor(fb / denom)

        pixel = _wrap32(a_out.to(torch.int64) << 24
                        | red.to(torch.int64) << 16
                        | green.to(torch.int64) << 8
                        | blue.to(torch.int64))
        return torch.where(hits > 0, pixel, i32(bg))


def distances(origin, direction, geometry):
    "Per-ray distance to the first surface (inf for misses)."
    direction = _unit(direction)
    tri, dist, _, _, _, _ = visit_kernel.traverse(
        geometry.wide, origin.to(torch.float32).contiguous(), direction)
    return torch.where(tri >= 0, dist, torch.inf)


# ---------------------------------------------------------------------------
# hybrid rendering: progressive photon mapping
# (device analog of chroma/cuda/hybrid_render.cu)
# ---------------------------------------------------------------------------

def _parked(photons):
    return (photons.flags & i32(REFLECT_DIFFUSE | TERMINAL_FLAGS)) != 0


def to_diffuse(photons, geometry, seed, max_steps=10, blocks=None):
    """Propagate photons until their first diffuse reflection (or
    termination), leaving them parked on the diffuse surface
    (reference: hybrid_render.cu:19-58 to_diffuse). Step i draws from a
    generator seeded by (seed, i), or from `blocks(i, b)`, which injects
    its (8, N) uniform blocks; the batch is never compacted, so lane k
    keeps stream k through every step."""
    n, dev = len(photons), photons.pos.device
    for i in range(max_steps):
        parked = _parked(photons)
        if bool(parked.all()):
            break
        if blocks is None:
            pool = DrawPool(n, dev, generator=make_generator(dev, seed, i))
        else:
            pool = DrawPool(n, dev, blocks=lambda b, i=i: blocks(i, b))
        stepped = propagate_step(photons, geometry, pool)
        photons = select(parked, photons, stepped)
    return photons


def update_xyz_lookup(photons, geometry, xyz_lookup):
    """Accumulate photon radiance (CIE-weighted by wavelength) onto the
    triangles where photons came to rest (reference:
    hybrid_render.cu:63-131 update_xyz_lookup; index_add_ replaces the
    atomic float adds, so the summation order on a card is not fixed).
    Returns the new (T, 3) lookup."""
    landed = (((photons.flags & i32(REFLECT_DIFFUSE)) != 0)
              & (photons.last_hit_triangle >= 0))
    tri = torch.where(landed, photons.last_hit_triangle, 0).to(torch.int64)

    # coarse CIE-like response from the wavelength (device-side analytic
    # approximation of chroma_tpu_torch.color.map_wavelength)
    wl = photons.wavelength
    r = torch.exp(-0.5 * ((wl - 600.0) / 50.0) ** 2)
    g = torch.exp(-0.5 * ((wl - 550.0) / 40.0) ** 2)
    b = torch.exp(-0.5 * ((wl - 450.0) / 40.0) ** 2)
    rgb = torch.stack([r, g, b], dim=1) * photons.weight[:, None]
    rgb = torch.where(landed[:, None], rgb, 0.0)
    return xyz_lookup.index_add(0, tri, rgb)


def update_xyz_image(origin, direction, geometry, xyz_lookup, image):
    """Add the radiance of the first surface each camera ray sees
    (reference: hybrid_render.cu:133-166)."""
    direction = _unit(direction)
    tri, _, _, _, _, _ = visit_kernel.traverse(
        geometry.wide, origin.to(torch.float32).contiguous(), direction)
    hit = tri >= 0
    radiance = xyz_lookup[torch.where(hit, tri, 0).to(torch.int64)]
    return image + torch.where(hit[:, None], radiance, 0.0)


def process_image(image):
    """Tone-map an accumulated float image to ARGB pixels (int32 bit
    patterns; reference: hybrid_render.cu:168-200)."""
    peak = torch.clamp(image.max(), min=1e-20)
    scaled = torch.clamp(image / peak, 0.0, 1.0)
    rgb = (scaled * 255.0).to(torch.int64)
    return _wrap32(0xFF000000 | (rgb[:, 0] << 16) | (rgb[:, 1] << 8)
                   | rgb[:, 2])


def _batch_seed(rng, device):
    """The (seed, counter) pair a hybrid render seeds its batches from:
    `rng` itself when it is such a pair (or an int), else one draw from
    the torch.Generator `rng`."""
    if isinstance(rng, torch.Generator):
        return (int(torch.randint(2 ** 62, (1,), generator=rng,
                                  device=rng.device)), 0)
    return rng


def camera_photons(cam, nphotons, generator):
    """`nphotons` photons leaving the point `cam` (3,) isotropically, with
    random polarization and a flat 380-680 nm spectrum, drawn from the
    torch.Generator: the light source of `hybrid_render`."""
    dev = cam.device
    pool = DrawPool(nphotons, dev, generator=generator)
    dirs = pool.uniform_sphere()
    pols = normalize(cross(pool.uniform_sphere(), dirs))
    wl = pool.draw(380.0, 680.0)
    zeros = torch.zeros(nphotons, dtype=torch.float32, device=dev)
    izeros = torch.zeros(nphotons, dtype=torch.int32, device=dev)
    return PhotonState(
        pos=cam[None, :].repeat(nphotons, 1), dir=dirs, pol=pols,
        wavelength=wl, t=zeros, weight=torch.ones_like(zeros),
        flags=izeros, last_hit_triangle=torch.full_like(izeros, -1),
        evidx=izeros.clone(), cur_mat=torch.full_like(izeros, -1))


def hybrid_render(origin, direction, geometry, rng, nphotons=100000,
                  nbatches=4, max_steps=10):
    """Progressive photon-map render: fire isotropic photon batches from
    the camera position, park them on diffuse surfaces, accumulate their
    radiance per triangle, then composite along the camera rays
    (reference: camera.py hybrid render loop + hybrid_render.cu). `rng` is
    a torch.Generator on the rays' device, or the (seed, counter) pair (or
    int seed) that Simulation seeds its generators from. The photons start
    with no known medium and track it from their first step on, as
    Simulation's do."""
    _dense(geometry)
    dev = origin.device
    seed = _batch_seed(rng, dev)
    n_tri = geometry.triangles.shape[0]
    xyz = torch.zeros((n_tri, 3), dtype=torch.float32, device=dev)

    cam = origin[0].to(torch.float32)
    for b in range(nbatches):
        ph = camera_photons(cam, nphotons,
                            make_generator(dev, seed, b, SOURCE_SITE))
        ph = to_diffuse(ph, geometry, (seed, b), max_steps=max_steps)
        xyz = update_xyz_lookup(ph, geometry, xyz)

    image = torch.zeros((origin.shape[0], 3), dtype=torch.float32,
                        device=dev)
    image = update_xyz_image(origin, direction, geometry, xyz, image)
    return process_image(image)
