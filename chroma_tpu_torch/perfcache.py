"""Persisted learned performance state, keyed by geometry CONTENT (the
port's copy of chroma_tpu.perfcache).

The propagation driver learns the probe-tuned fused compaction schedule
from a geometry's first bomb. Keeping it only in a process-local dict
would make every cold start pay a probe bomb again, and a recycled id()
after GC could alias a stale entry onto a new geometry.

This module gives hot objects a CONTENT fingerprint (sha1 over a
deterministic sample of the wide-BVH row table plus its shape), registered
at build/load time while the rows are still host numpy, and persists the
learned entries as JSON under <cache root>/perf_torch/<fp>.json, where the
cache root is CHROMA_CACHE_DIR or ~/.chroma_tpu_torch (the port's
chroma_tpu_torch.cache root). The JAX package writes <root>/perf/<fp>.json
under the same CHROMA_CACHE_DIR with the same fingerprints; its schedules
were tuned with another device's cost model, so the port never reads them:
its entries live in their own directory.

A tuned schedule's key names the step cost it was tuned on
(ops.propagate.SCHED_KEY): when the step changes its cost model, entries
tuned on the old one are no longer read.

Fingerprints intentionally cover the geometry (BVH content, table shape)
and not the optics tables: an optics-only change reuses the schedule
tuned for the same shapes, which is safe (schedules are performance
hints; lanes that overflow a stage's slice stay at a wider width) and almost
always desirable (the survival curve is geometry-dominated).
"""
from __future__ import annotations

import hashlib
import json
import os
import weakref

import numpy as np

# id(obj) -> (weakref to obj, fingerprint). The weakref guards against
# id reuse after GC: a hit only counts when the referent is still obj.
_REG = {}

_DISK = {}           # fingerprint -> loaded JSON dict (memoized)
_SAMPLE_ROWS = 4096  # rows hashed from large tables (deterministic stride)
PERF_DIR = 'perf_torch'   # the JAX package's entries are in 'perf'


def fingerprint_rows(rows, extra=()):
    """Content fingerprint of a wide-BVH row table (host numpy (R, W)
    f32). Large tables hash a deterministic strided sample plus the full
    shape — collisions would need two geometries agreeing on shape AND
    every sampled row."""
    rows = np.asarray(rows)
    h = hashlib.sha1()
    h.update(repr(rows.shape).encode())
    stride = max(1, len(rows) // _SAMPLE_ROWS)
    h.update(np.ascontiguousarray(rows[::stride]).tobytes())
    for e in extra:
        h.update(repr(e).encode())
    return h.hexdigest()[:16]


def register(obj, fp):
    "Attach a fingerprint to a (weakref-able) object."
    try:
        _REG[id(obj)] = (weakref.ref(obj), fp)
    except TypeError:      # object type without weakref support
        pass


def carry(src, dst):
    """Register `dst` (a copy of `src` on another device) under src's
    fingerprint, when src has one."""
    key = key_of(src)
    if persistent(key):
        register(dst, key)


def key_of(obj):
    """The perf-cache key for obj: its registered content fingerprint,
    falling back to the id-based session key for unregistered objects
    (never persisted)."""
    ent = _REG.get(id(obj))
    if ent is not None and ent[0]() is obj:
        return ent[1]
    # derive from a registered .wide (GeometryArrays built elsewhere)
    wide = getattr(obj, 'wide', None)
    if wide is not None:
        went = _REG.get(id(wide))
        if went is not None and went[0]() is wide:
            fp = went[1] + '-ga'
            register(obj, fp)
            return fp
    return 'id%x' % id(obj)


def persistent(key):
    "True when `key` is a content fingerprint (persist-worthy)."
    return not key.startswith('id')


def _perf_dir():
    base = os.environ.get('CHROMA_CACHE_DIR',
                          os.path.expanduser('~/.chroma_tpu_torch'))
    return os.path.join(base, PERF_DIR)


def _path(fp):
    return os.path.join(_perf_dir(), fp + '.json')


def load(fp):
    "The persisted perf dict for a fingerprint ({} when absent)."
    if fp in _DISK:
        return _DISK[fp]
    data = {}
    try:
        with open(_path(fp)) as f:
            data = json.load(f)
    except (OSError, ValueError):
        data = {}
    _DISK[fp] = data
    return data


def update(fp, patch):
    "Merge-write persisted entries for a fingerprint (best-effort)."
    if not persistent(fp):
        return
    data = dict(load(fp))
    data.update(patch)
    _DISK[fp] = data
    try:
        os.makedirs(_perf_dir(), exist_ok=True)
        tmp = _path(fp) + '.tmp.%d' % os.getpid()
        with open(tmp, 'w') as f:
            json.dump(data, f)
        os.replace(tmp, _path(fp))
    except OSError:
        pass


def as_tuples(v):
    "JSON round-trip restores lists; schedules are compared as tuples."
    if isinstance(v, list):
        return tuple(as_tuples(x) for x in v)
    return v
