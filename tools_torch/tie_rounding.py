#!/usr/bin/env python3
"""Where two triangles tie at a shared edge: how the JAX package and the
port's plain walk round the triangle test, and which triangle each picks.

    JAX_PLATFORMS=cpu python3 tools_torch/tie_rounding.py

On demo.tiny() from the camera's default pose (64 x 48 rays) and on 8,192
random rays, it runs the JAX walk compiled (jax.jit), the interpreted
Pallas visit kernel, the JAX walk under jax.disable_jit(), and the port's
plain walk twice: as it is (rounding `a*b - c*d` and three-term dots as
XLA's CPU code does, one fused multiply-add each) and with plain
products and sums. It prints how many rays differ from the compiled JAX
walk in triangle, distance bits, normal bits and instance, and, for every
camera ray where the plain rounding picks another triangle, both
candidates' distances in f64 and f32 (numpy, world frame) and each walk's
f32 distance. Runs on the CPU in about a minute; imports both packages.
"""
import os
import sys

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chroma_tpu import demo as jdemo  # noqa: E402
from chroma_tpu.ops import mesh_wide as jmw, types as jtypes  # noqa: E402
from chroma_tpu.ops import visit_kernel as jvk  # noqa: E402
from chroma_tpu_torch import camera, demo as tdemo  # noqa: E402
from chroma_tpu_torch.ops import mesh_wide as tmw, render  # noqa: E402
from chroma_tpu_torch.ops import types as ttypes  # noqa: E402
from chroma_tpu_torch.tools import from_film  # noqa: E402


def rays(geo):
    "The default pose's 64 x 48 rays, then 8,192 random ones."
    pose, _, _ = camera._scene_pose(geo)
    o, d = from_film(pose.position, axis1=pose.axis1, axis2=pose.axis2,
                     size=(64, 48), width=camera.FILM_WIDTH,
                     focal_length=camera.FOCAL_LENGTH)
    rs = np.random.RandomState(5)
    o = np.concatenate([o, rs.uniform(-2500, 2500, (8192, 3))])
    d = np.concatenate([d, rs.randn(8192, 3)])
    d = render._unit(torch.from_numpy(d.astype(np.float32))).numpy()
    return o.astype(np.float32), d


def jax_walk(wide, o, d):
    return [np.asarray(x) for x in jax.jit(
        lambda oo, dd: jmw.intersect_mesh_wide(
            oo, dd, wide, two_phase=False, want_context=True))(o, d)]


def port_walk(wide, o, d, fused):
    saved = tmw._cross_term, tmw._dot3
    if not fused:
        tmw._cross_term = lambda a, b, c, e: a * b - c * e
        tmw._dot3 = lambda a, b, c, e, f, g: a * b + c * e + f * g
    try:
        out = tmw.traverse(wide, torch.from_numpy(o), torch.from_numpy(d))
    finally:
        tmw._cross_term, tmw._dot3 = saved
    return [x.numpy() for x in out[:5]]


def moller_trumbore(v, tri, o, d, dtype):
    "Distance of one ray to one triangle, in dtype, numpy."
    v0, v1, v2 = (v[tri[i]].astype(dtype) for i in range(3))
    e1, e2 = v1 - v0, v2 - v0
    o, d = o.astype(dtype), d.astype(dtype)
    h = np.cross(d, e2)
    q = np.cross(o - v0, e1)
    return (e2 @ q) / (e1 @ h)


def main():
    gj, gt = jdemo.tiny(), tdemo.tiny()
    gj.flatten()
    gt.flatten()
    gaj = jtypes.build_geometry_arrays(gj)
    gat = ttypes.build_geometry_arrays(gt)
    o, d = rays(gt)
    cam = slice(0, 3072)
    ref = jax_walk(gaj.wide, o, d)
    jvk.PALLAS_VISIT, jvk.TB = 'force', 8
    pallas = jax_walk(gaj.wide, o, d)
    jvk.PALLAS_VISIT = '0'
    try:
        with jax.disable_jit():
            jmw.intersect_mesh_wide(jnp.asarray(o[:128]),
                                    jnp.asarray(d[:128]), gaj.wide,
                                    two_phase=False)
        print('jax.disable_jit(): the walk ran')
    except Exception as exc:  # reported: the uncompiled walk cannot run
        print('jax.disable_jit(): the walk cannot run (%s: %s)'
              % (type(exc).__name__, exc))
    runs = {'interpreted Pallas kernel': pallas,
            'port, XLA rounding': port_walk(gat.wide, o, d, True),
            'port, plain rounding': port_walk(gat.wide, o, d, False)}
    hit = ref[0] >= 0
    for name, (tri, dist, code, nrm, iid) in runs.items():
        code = code.view(np.uint32) if code.dtype == np.int32 else code
        for label, sel in (('camera rays', cam),
                           ('random rays', slice(3072, None))):
            h = hit[sel]
            print('%-26s %s: triangle %d, distance bits %d, code %d, '
                  'normal bits %d, instance %d differ' % (
                      name, label, (tri[sel] != ref[0][sel]).sum(),
                      (dist[sel].view(np.int32)
                       != ref[1][sel].view(np.int32)).sum(),
                      (code[sel] != ref[2][sel].view(np.uint32)).sum(),
                      (nrm[sel][h].view(np.int32)
                       != ref[3][sel][h].view(np.int32)).any(axis=1).sum(),
                      (iid[sel][h] != ref[4][sel][h]).sum()))
    tri_p, dist_p = runs['port, plain rounding'][:2]
    tri_f, dist_f = runs['port, XLA rounding'][:2]
    v, t = gt.mesh.vertices, gt.mesh.triangles
    for k in np.flatnonzero(tri_p[cam] != ref[0][cam]):
        line = 'ray %4d: jax %6d (%.9g), port XLA rounding %6d (%.9g), ' \
               'plain %6d (%.9g) |' % (k, ref[0][k], ref[1][k], tri_f[k],
                                       dist_f[k], tri_p[k], dist_p[k])
        for c in sorted({int(ref[0][k]), int(tri_p[k])} - {-1}):
            line += ' tri %d: f64 %.17g f32 %.9g;' % (
                c, moller_trumbore(v, t[c], o[k], d[k], np.float64),
                moller_trumbore(v, t[c], o[k], d[k], np.float32))
        print(line)


if __name__ == '__main__':
    main()
