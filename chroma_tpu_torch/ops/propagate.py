"""Propagation driver for the torch port (counterpart of the chunked
driver in chroma_tpu.ops.propagate).

Steps run in chunks; between chunks the survivors are front-packed into a
power-of-two batch (`_ps_compact_perm`), and when few are left the rest of
the steps run in one chunk (reference heuristic: gpu/photon.py:259-264).
Step `s` draws from a generator seeded by (seed, s), so for a fixed batch
layout any chunking gives identical histories; a compaction reorders
lanes and with them the draws, as in the JAX driver.

The JAX package's fused static schedule, probe, pilot and tuners exist to
keep XLA shapes static and host syncs few; eager PyTorch needs neither, so
they are not ported. The profiler's regions and counters carry the JAX
driver's names (propagate.chunk[n=...], propagate.steps,
propagate.lane_steps, propagate.alive_after_chunk) and read only the alive
count the driver already fetches at each chunk.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chroma_tpu_torch import event
from chroma_tpu_torch.log import logger
from chroma_tpu_torch.ops.photon import PhotonState, i32, propagate_step
from chroma_tpu_torch.ops.sample import DrawPool, make_generator
from chroma_tpu_torch.profiler import profiler

MIN_BATCH = 256
CHUNK_GROWTH = 2
CHUNK_CAP = 32


def photon_state_from_host(photons, device):
    "Upload an event.Photons batch to a PhotonState on `device`."
    def _norm(v):
        v = np.asarray(v, dtype=np.float32)
        n = np.linalg.norm(v, axis=-1, keepdims=True)
        return v / np.where(n > 0, n, 1.0)

    def t(a, dtype):
        a = np.asarray(a, dtype=dtype)
        if dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return PhotonState(
        pos=t(photons.pos, np.float32),
        dir=t(_norm(photons.dir), np.float32),
        pol=t(_norm(photons.pol), np.float32),
        wavelength=t(photons.wavelengths, np.float32),
        t=t(photons.t, np.float32),
        weight=t(photons.weights, np.float32),
        flags=t(photons.flags, np.uint32),
        last_hit_triangle=t(photons.last_hit_triangles, np.int32),
        evidx=t(photons.evidx, np.uint32),
        # medium unknown until the first geometry query resolves it
        cur_mat=torch.full((len(photons.pos),), -1, dtype=torch.int32,
                           device=device),
    )


def photon_state_to_host(state, channel=None):
    "Download a PhotonState to an event.Photons batch."
    h = state.map(lambda a: a.cpu().numpy())
    return event.Photons(
        pos=h.pos, dir=h.dir, pol=h.pol, wavelengths=h.wavelength, t=h.t,
        last_hit_triangles=h.last_hit_triangle,
        flags=h.flags.view(np.uint32), weights=h.weight,
        evidx=h.evidx.view(np.uint32), channel=channel)


def run_steps(photons, geometry, seed, start_step, nsteps, blocks=None,
              use_weights=False, scatter_first=0):
    """Run up to `nsteps` steps from absolute step `start_step`, stopping
    early once every photon has terminated. Step s draws from a generator
    seeded by (seed, s), or from `blocks(s, b)`, which injects its (8, N)
    uniform blocks (tests). scatter_first applies at absolute step 0 only
    (reference: propagate.cu:319), and any biasing turns traversal pruning
    off, as in chroma_tpu.ops.propagate. Returns (photons, steps_done, alive
    count)."""
    done = 0
    alive = int(photons.alive.sum())
    n, dev = len(photons), photons.pos.device
    prune = scatter_first == 0
    while done < nsteps and alive:
        step = start_step + done
        if blocks is None:
            pool = DrawPool(n, dev, generator=make_generator(dev, seed, step))
        else:
            pool = DrawPool(n, dev, blocks=lambda b: blocks(step, b))
        photons = propagate_step(
            photons, geometry, pool, use_weights=use_weights,
            scatter_first=scatter_first if step == 0 else 0, prune=prune)
        done += 1
        alive = int(photons.alive.sum())
    return photons, done, alive


def _next_pow2(x):
    return max(MIN_BATCH, 1 << int(np.ceil(np.log2(max(x, 1)))))


def _ps_compact_perm(active):
    "Stable front-pack permutation (dest, perm); O(N), no sort."
    act = active.to(torch.int64)
    n_act = act.sum()
    fwd = torch.cumsum(act, 0) - 1
    bwd = n_act + torch.cumsum(1 - act, 0) - 1
    dest = torch.where(active, fwd, bwd)
    perm = torch.empty_like(dest)
    perm[dest] = torch.arange(dest.shape[0], device=dest.device)
    return dest, perm


def _write_back(final, orig_idx, current):
    "final[orig_idx] = current, field by field (in place)."
    for f in dataclasses.fields(final):
        getattr(final, f.name)[orig_idx] = getattr(current, f.name)


def propagate(photons, geometry, seed, max_steps=100, step_chunk='auto',
              use_weights=False, scatter_first=0, track_steps=False):
    """Propagate a PhotonState to termination or `max_steps`; returns the
    final PhotonState in the input's lane order.

    step_chunk='auto' compacts after step 1 and then doubles the chunk (up
    to CHUNK_CAP steps) at every boundary; an int fixes it. use_weights
    and scatter_first select the weighted transport of the likelihood
    biasing modes (see ops.photon.propagate_to_boundary).

    track_steps=True returns (final, tracking): after every chunk, one
    host snapshot (orig_idx numpy array, PhotonState of CPU tensors) of
    the chunk's lanes, taken after the chunk's steps as the JAX driver
    takes it (chroma_tpu/ops/propagate.py:1262-1264)."""
    n = len(photons)
    orig_idx = torch.arange(n, device=photons.pos.device)
    final = photons.map(torch.clone)
    tracking = []
    step = 0
    current = photons
    chunk = 1 if step_chunk == 'auto' else int(step_chunk)
    n_alive = None
    while step < max_steps:
        if step_chunk == 'auto':
            chunk = min(CHUNK_CAP, max(1, chunk * CHUNK_GROWTH)) \
                if step > 0 else 1
        nsteps = min(chunk, max_steps - step)
        if step > 0:
            # few survivors: finish their remaining steps in one chunk
            if n_alive <= max(len(current) // 16, MIN_BATCH // 4):
                nsteps = max_steps - step
            bucket = _next_pow2(n_alive)
        else:
            bucket = n
        with profiler.region('propagate.chunk[n=%d]'
                             % min(bucket, len(current))):
            if bucket < len(current):
                _write_back(final, orig_idx, current)
                _, perm = _ps_compact_perm(current.alive)
                sel = perm[:bucket]
                current = current.map(lambda a: a[sel])
                orig_idx = orig_idx[sel]
            current, _, n_alive = run_steps(current, geometry, seed, step,
                                            nsteps, use_weights=use_weights,
                                            scatter_first=scatter_first)
        step += nsteps
        profiler.count('propagate.steps', nsteps)
        profiler.count('propagate.lane_steps', nsteps * len(current))
        profiler.count('propagate.alive_after_chunk', n_alive)
        if track_steps:
            tracking.append((orig_idx.cpu().numpy().copy(), current.map(
                lambda a: a.to('cpu', copy=True))))
        if n_alive == 0:
            break

    _write_back(final, orig_idx, current)
    if bool(((final.flags & i32(event.NAN_ABORT)) != 0).any()):
        logger.warning('ABORTED PHOTONS')
    if track_steps:
        return final, tracking
    return final
