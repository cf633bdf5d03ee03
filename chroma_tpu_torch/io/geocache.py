"""On-disk cache of the port's device-ready GeometryArrays, in the file
layout of chroma_tpu.io.geocache.

A geometry is stored as <path>.npz (plain numpy arrays, keyed by field
path, e.g. 'ga.wide.rows') and <path>.json (class names, static fields,
None fields, format version, the instanced table's quality stats). The
layout and dtypes are the JAX package's, so a geocache saved by either
package loads in the other:

  * fields the JAX package stores as u32 (packed material codes, colors,
    the lean soup's codes) are written as u32 and read back as the port's
    int32 bit patterns;
  * the JAX GeometryArrays also carries the classic BVH's DFS arrays
    (nodes, escape, world_origin, world_scale, n_nodes), which the port
    does not build: a save writes the placeholders the JAX builder writes
    for a geometry without a classic BVH, and a load skips them.

A lean instanced detector reloads quickly whatever its triangle count,
because nothing O(triangles) is stored; lean=True also drops the
per-triangle world arrays of a dense cache before they become tensors.
Loading returns CPU tensors; `.to(device)` moves them.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from chroma_tpu_torch import perfcache
from chroma_tpu_torch.bvh import wide as W
from chroma_tpu_torch.log import logger
from chroma_tpu_torch.ops import types as T

FORMAT_VERSION = 4   # chroma_tpu.io.geocache's current version

_REGISTRY = {cls.__name__: cls for cls in (
    T.GeometryArrays, T.MaterialTables, T.SurfaceTables, T.WirePlaneArrays,
    T.DetectorArrays, T.InstanceArrays, W.InstancedBVH)}

# fields stored as u32, as the JAX package stores them
_U32_KEYS = ('ga.material_codes', 'ga.colors', 'ga.inst.codes_u')

# the O(triangles) world-frame "soup" fields, unused by the device path of
# an instanced geometry
_SOUP_KEYS = ('ga.vertices', 'ga.triangles', 'ga.tri_normals',
              'ga.material_codes', 'ga.colors', 'ga.solid_id')


def _flatten(obj, prefix, arrays, meta):
    meta[prefix + '.__class__'] = type(obj).__name__
    for f in dataclasses.fields(obj):
        key = prefix + '.' + f.name
        v = getattr(obj, f.name)
        if v is None:
            meta[key] = None
        elif dataclasses.is_dataclass(v):
            _flatten(v, key, arrays, meta)
        elif isinstance(v, torch.Tensor):
            a = v.detach().cpu().numpy()
            arrays[key] = a.view(np.uint32) if key in _U32_KEYS else a
        else:  # static field: int/float/bool/str/tuple
            meta[key] = ['static', list(v) if isinstance(v, tuple) else v]


def _unflatten(prefix, arrays, meta):
    cls = _REGISTRY[meta[prefix + '.__class__']]
    kwargs = {}
    for f in dataclasses.fields(cls):
        key = prefix + '.' + f.name
        if key in arrays:
            kwargs[f.name] = T._t(arrays[key])
        elif key + '.__class__' in meta:
            kwargs[f.name] = _unflatten(key, arrays, meta)
        elif key in meta:
            v = meta[key]
            if v is None:
                kwargs[f.name] = None
            else:
                kwargs[f.name] = tuple(v[1]) if isinstance(v[1], list) \
                    else v[1]
        # fields absent from the sidecar keep the dataclass default
    return cls(**kwargs)


def _bounds_fmt(meta):
    "(packed, bounds format) of the stored instanced table."
    packed = bool(meta.get('ga.wide.packed', [None, False])[1])
    return packed, (meta.get('ga.wide.bounds_fmt')
                    or [None, 'bf16' if packed else 'f32'])[1]


def _table_stats(arrays, meta):
    "Quality stats of the stored instanced table (chroma_tpu's sidecar)."
    fmt = _bounds_fmt(meta)[1]
    fanout = int(meta['ga.wide.fanout'][1])
    return W.table_stats(arrays['ga.wide.rows'], fanout,
                         int(meta['ga.wide.leaf_size'][1]), fmt), fanout


def save_geometry_arrays(path, ga):
    "Persist a GeometryArrays as <path>.npz + <path>.json."
    arrays = {}
    meta = {'__version__': FORMAT_VERSION}
    _flatten(ga, 'ga', arrays, meta)
    # the JAX layout's classic-BVH fields, as its builder fills them for
    # a geometry without a classic BVH (chroma_tpu/ops/types.py:552-556)
    arrays['ga.nodes'] = np.zeros((1, 4), dtype=np.uint32)
    arrays['ga.escape'] = np.ones(1, dtype=np.int32)
    arrays['ga.world_origin'] = (
        arrays['ga.vertices'].min(axis=0) if 'ga.vertices' in arrays
        else np.zeros(3, np.float32)).astype(np.float32)
    arrays['ga.world_scale'] = np.float32(1.0)
    meta['ga.n_nodes'] = ['static', 1]
    meta['ga.wide.__stats__'] = _table_stats(arrays, meta)[0]
    np.savez(path + '.npz', **arrays)
    with open(path + '.json', 'w') as f:
        json.dump(meta, f)


def load_geometry_arrays(path, lean=False):
    """Load a GeometryArrays saved by either package's
    save_geometry_arrays, as CPU tensors (None when the files are missing
    or of another format version). A version-3 cache's instanced table is
    upgraded to the version-4 layout on the host, as chroma_tpu's loader
    does (bvh.wide.upgrade_instanced_rows_v3), instead of a re-mesh. With
    lean=True the per-triangle world arrays of an instanced geometry are
    dropped before conversion."""
    if not (os.path.exists(path + '.npz')
            and os.path.exists(path + '.json')):
        return None
    with open(path + '.json') as f:
        meta = json.load(f)
    if meta.get('__version__') not in (3, FORMAT_VERSION):
        return None
    if meta.get('ga.wide.__class__') != 'InstancedBVH':
        raise NotImplementedError('the torch port traverses instanced wide '
                                  'BVHs only')
    with np.load(path + '.npz') as zf:
        arrays = {k: zf[k] for k in zf.files
                  if not (lean and 'ga.inst.__class__' in meta
                          and k in _SOUP_KEYS)}
    if meta['__version__'] == 3:
        arrays['ga.wide.rows'] = W.upgrade_instanced_rows_v3(
            arrays['ga.wide.rows'], int(meta['ga.wide.fanout'][1]),
            int(meta['ga.wide.leaf_size'][1]),
            bool(meta.get('ga.wide.packed', [None, False])[1]))
    if lean and 'ga.inst.__class__' in meta:
        meta.update({k: None for k in _SOUP_KEYS})
    stats, fanout = _table_stats(arrays, meta)
    for v in W.check_table_stats(stats, fanout):
        logger.warning('cached instanced BVH quality (%s): %s', path, v)
    # the builder's fingerprint definition (bvh.wide), so a schedule tuned
    # on a built geometry applies to it loaded from the cache (perfcache)
    packed, fmt = _bounds_fmt(meta)
    fp = perfcache.fingerprint_rows(
        arrays['ga.wide.rows'],
        extra=(int(meta['ga.wide.fanout'][1]),
               int(meta['ga.wide.leaf_size'][1]), packed,
               int(meta['ga.wide.n_instances'][1]), fmt))
    ga = _unflatten('ga', arrays, meta)
    perfcache.register(ga.wide, fp)
    return ga
