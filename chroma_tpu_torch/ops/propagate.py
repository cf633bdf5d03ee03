"""Propagation driver for the torch port (counterpart of
chroma_tpu.ops.propagate).

Two routes, chosen as the JAX driver chooses them, on every device:

  * the fused bomb (`_fused_bomb`, the default: compaction on, no
    tracking, an int scatter_first, CHROMA_FUSED not 0): the whole bomb
    follows a STATIC compaction schedule of (steps, width) stages. Each
    stage runs a bounded step loop that stops once every lane is
    terminated, front-packs the survivors and recurses on a prefix slice
    of the schedule's width. Where the survivors overflow that slice, the
    boundary keeps them at the narrowest wider width a boundary before it
    skipped, or skips itself and keeps the stage's width: an overflow
    costs one stage at a wider width, never a second tail of its own, so
    a bomb whose photons outlive the probe's does the same steps.
    The first bomb of a (geometry, batch, max_steps) runs the
    conservative PROBE_SCHEDULE and records its survival curve step by
    step; `_tune_schedule` derives the schedule of every later bomb from
    it by dynamic programming over a ladder of widths, and the schedule is
    kept in the session and in the perf cache (chroma_tpu_torch.perfcache)
    under the geometry's content fingerprint. CHROMA_FUSED_SCHEDULE
    overrides it ('none': no compaction).
    On a CUDA device each stage's step runs as a CUDA graph captured at
    the stage's static width (ops.graphs), its kernels (K1, K2, and K3 on
    a wire-plane geometry) inside it; on the CPU the same driver runs the
    same step eagerly. No step reads a device value on the host: each
    step's alive count is copied to pinned memory behind an event, the
    driver polls the events and stops a stage once a finished step left
    no lane alive, and it waits for the step POLL_LAG steps back before
    queueing another (the card keeps that many steps queued). One
    blocking read a stage boundary (the alive count: early exit and
    overflow) and one at the end (the NaN-abort flag) remain.
  * the chunked driver (tracking, compact=False, CHROMA_FUSED=0): steps
    run in chunks; between chunks the survivors are front-packed into a
    power-of-two batch, and when few are left the rest of the steps run
    in one chunk (reference heuristic: gpu/photon.py:259-264).

Step `s` of a stream `key` draws from a generator seeded by (key, s), so
for a fixed batch layout any chunking gives identical histories; a
compaction reorders lanes and with them the draws, as in the JAX driver.
Lane moves gather each field separately (the JAX driver moves one packed
row matrix): a per-field gather on the card reads each byte once, where
packing, gathering and unpacking into the contiguous fields the step needs
would pass over the state three times.

Not ported: the visit-distribution pilot and the traversal-staging tuners
(`_tune_stages`, `stages_for`, `pstages:` entries), which set the lockstep
staging of chroma_tpu.ops.mesh_wide that K1's walk replaced.

The profiler's spans carry the JAX driver's names where it has them
(propagate.fused[n=...], propagate.probe[n=...], propagate.chunk[n=...])
and mark the fused route's layers: propagate.stage (one _steps call: its
graph lookups, replays or eager steps, pushes and polls), propagate.wait
(each host block on the card: the throttle, a stage's alive count, the
end's abort flag), propagate.compact (the front-pack's permutation and
gathers, and the reassembly). Its counters, each
counted once a call from counts the driver already holds on the host:
propagate.steps and propagate.lane_steps, wire.walked (the lane-steps K3
walks: lane_steps again, on a geometry with wire planes only),
propagate.tail_steps (steps of the stages that end the schedule),
propagate.overflow_lanes (survivors beyond a stage's slice, kept at a
wider width),
propagate.blocking_reads, propagate.throttle_waits, and the graph route's
graphs.captures and graphs.replays.
"""
from __future__ import annotations

import dataclasses
import math
import os
import sys
from functools import lru_cache

import numpy as np
import torch

from chroma_tpu_torch import event, perfcache
from chroma_tpu_torch.log import logger
from chroma_tpu_torch.ops import graphs
from chroma_tpu_torch.ops.photon import PhotonState, i32, propagate_step
from chroma_tpu_torch.ops.sample import DrawPool, make_generator
from chroma_tpu_torch.profiler import profiler

MIN_BATCH = 256
CHUNK_GROWTH = 2
CHUNK_CAP = 32

# steps a fused stage keeps queued on the card ahead of the host's early-
# exit poll (see _Poll)
POLL_LAG = 4


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


# the fields of a readback block, in its order: (PhotonState field,
# event.Photons field, dtype, lane width); cur_mat stays on the device
_READBACK = (('pos', 'pos', torch.float32, 3),
             ('dir', 'dir', torch.float32, 3),
             ('pol', 'pol', torch.float32, 3),
             ('wavelength', 'wavelengths', torch.float32, 1),
             ('t', 't', torch.float32, 1),
             ('weight', 'weights', torch.float32, 1),
             ('flags', 'flags', torch.int32, 1),
             ('last_hit_triangle', 'last_hit_triangles', torch.int32, 1),
             ('evidx', 'evidx', torch.int32, 1))
_UNSIGNED = ('flags', 'evidx', 'channel')


def _pinned_blocks(pinned):
    "Blocks the pinned pool has made so far; 0 unless counting on a card."
    if pinned and profiler.enabled:
        return torch.cuda.host_memory_stats()['num_host_alloc']
    return 0


def photon_state_to_host(state, channel=None):
    """Download a PhotonState to an event.Photons batch.

    The fields Photons keeps (60 B a photon), and a device channel (4 B
    more), are copied into one host block: pinned, from torch's caching
    host allocator, when the state is on a CUDA device, so each field is
    one non-blocking DMA and one stream sync ends them; a plain host
    tensor otherwise. Each array is a view of the block and keeps it
    alive; once the last one is dropped the block returns to the pool,
    and the next readback of that size reuses it. A device channel (-1:
    none) is clamped at 0 there and read as uint32; a host channel is
    passed through. Counts readback.calls, readback.bytes and
    readback.new_blocks (readbacks that grew the pinned pool)."""
    n, dev = len(state), state.pos.device
    fields = [(name, getattr(state, src), dtype, width)
              for src, name, dtype, width in _READBACK]
    if isinstance(channel, torch.Tensor):
        fields.append(('channel', channel.clamp_min(0), torch.int32, 1))
    nbytes = 4 * n * sum(width for *_, width in fields)
    pinned = dev.type == 'cuda'
    before = _pinned_blocks(pinned)
    block = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned)
    grown = _pinned_blocks(pinned) - before
    host, off = {}, 0
    for name, a, dtype, width in fields:
        size = 4 * n * width
        dst = block[off:off + size].view(dtype).view(a.shape)
        dst.copy_(a, non_blocking=True)
        host[name] = dst.numpy()
        if name in _UNSIGNED:
            host[name] = host[name].view(np.uint32)
        off += size
    if pinned:
        torch.cuda.current_stream(dev).synchronize()
    profiler.count('readback.calls')
    profiler.count('readback.bytes', nbytes)
    profiler.count('readback.new_blocks', grown)
    host.setdefault('channel', channel)
    return event.Photons(**host)


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


def _cat(a, b):
    "Lanes of PhotonState a followed by those of b."
    return PhotonState(**{f.name: torch.cat([getattr(a, f.name),
                                             getattr(b, f.name)])
                          for f in dataclasses.fields(a)})


def _aborted(photons):
    "Whether a lane carries NAN_ABORT (one blocking read on the card)."
    with profiler.region('propagate.wait'):
        return bool(((photons.flags & i32(event.NAN_ABORT)) != 0).any())


# ---------------------------------------------------------------------------
# compaction schedules (copied from chroma_tpu.ops.propagate)
# ---------------------------------------------------------------------------

def _parse_schedule(spec):
    if not spec or spec in ('none', 'off', '0'):
        return ()
    return tuple(tuple(int(x) for x in part.split(':'))
                 for part in spec.split(','))


# width below which compaction stops paying (per-step cost is dominated
# by the step's fixed cost, not lane count)
SCHED_FLOOR = 2048

# conservative first-bomb schedule: divisor 2 everywhere tolerates up to
# ~50% single-stage survival; its per-step alive counts feed the tuner
PROBE_SCHEDULE = ((1, 2), (2, 2), (2, 2), (4, 2), (8, 2), (16, 2))


def _resolve_width(width, ent):
    """Next-stage lane count for a schedule entry at current `width`.

    A schedule entry is (steps, w) where w < 1024 is a DIVISOR of the
    current width (the original pow2-bucket form, batch-size portable)
    and w >= 1024 is an ABSOLUTE lane count (emitted by the cost-model
    tuner, which picks non-pow2 bucket widths — survivor decay is
    gradual, and rounding every bucket up to a power of two wastes up to
    2x the lane-steps; schedules with absolute widths are only cached
    per (geometry, batch) so the widths always match their batch)."""
    d = int(ent[1])
    return min(d, width) if d >= 1024 else width // d


def _trim_schedule(sched, n):
    out = []
    width = n
    pending = 0          # spans of dropped no-op boundaries
    for ent in sched:
        steps = int(ent[0]) + pending
        pending = 0
        m = _resolve_width(width, ent)
        if m >= width:   # no-op boundary (absolute width >= current)
            pending = steps
            continue
        if m < max(SCHED_FLOOR, MIN_BATCH):
            break
        out.append((steps, int(ent[1])))
        width = m
    return tuple(out)


def _boundary_steps(sched, max_steps):
    "Cumulative step index at each stage boundary of a schedule."
    out, c = [], 0
    for steps, _ in sched:
        c = min(c + steps, max_steps)
        out.append(c)
    return out


def _survival_fn(n, boundary_steps, alive_counts):
    """Geometric interpolation of a probe bomb's measured survival curve
    ((step, alive count) points) -> alive_fraction(step)."""
    pts = [(0, 1.0)]
    for s, a in zip(boundary_steps, alive_counts):
        pts.append((s, max(float(a) / n, 0.25 / n)))

    def alive_at(step):
        if step <= 0:
            return 1.0
        for (s0, f0), (s1, f1) in zip(pts, pts[1:]):
            if step <= s1:
                w = (step - s0) / max(s1 - s0, 1)
                return f0 * (f1 / f0) ** w
        # extrapolate past the probe with the last segment's decay rate
        (s0, f0), (s1, f1) = pts[-2], pts[-1]
        rate = min((f1 / f0) ** (1.0 / max(s1 - s0, 1)), 0.97)
        return f1 * rate ** (step - s1)

    return alive_at


def _round_lanes(w):
    "Round a lane count UP to a multiple of 1024 (layout-friendly)."
    return max(((int(w) + 1023) // 1024) * 1024, 1024)


# The tuner's cost model, in LANE-STEP units (one lane for one step), on
# the card the port runs on: a step of width w costs w + SCHED_FLOOR_LANES
# and a compaction boundary at width w costs SCHED_BOUNDARY_FRAC * w +
# SCHED_BOUNDARY_LANES. Measured by chip_smoke.py phase 12a on an NVIDIA
# H100 80GB HBM3 at 700 W with the step of the uniform blocks, k2_pre, K1,
# K3 and the regrouped k2_post: graph-replayed
# quick-detector steps from 2^11 to 2^20 lanes fit t = 9.46e-7 ms * w +
# 0.0733 ms (0.070 ms at 2^11, 1.06 ms at 2^20), so SCHED_FLOOR_LANES =
# 0.0733 / 9.46e-7; a boundary (its blocking read, front-pack and lane
# moves, timed on the host) fits 7.86e-8 ms * w + 1.04 ms, so
# SCHED_BOUNDARY_FRAC = 7.86e-8 / 9.46e-7 and SCHED_BOUNDARY_LANES =
# 1.04 / 9.46e-7 (PERF.md section 6).
SCHED_FLOOR_LANES = 77500
SCHED_BOUNDARY_FRAC = 0.083
SCHED_BOUNDARY_LANES = 1098000
SCHED_MAX_STAGES = int(os.environ.get('CHROMA_SCHED_MAX_STAGES', '12'))


def _tune_schedule(n, boundary_steps, alive_counts, max_steps,
                   floor_lanes=SCHED_FLOOR_LANES,
                   boundary_frac=SCHED_BOUNDARY_FRAC,
                   boundary_lanes=SCHED_BOUNDARY_LANES):
    """Derive a compaction schedule from a measured survival curve
    ((step, alive count) points from a probe bomb) by dynamic
    programming over a width ladder, for the cost model (floor_lanes,
    boundary_frac, boundary_lanes) described above SCHED_FLOOR_LANES.

    The ladder holds NON-pow2 widths ({n/2^k} U {3n/2^(k+2)} U
    {5n/2^(k+3)}): survivor decay is gradual, so pow2-only buckets would
    run far below full occupancy. The DP walks the modeled per-step cost
    (width + floor) and boundary cost, choosing when to compact and to
    which ladder width; a margin over the measured survivors keeps
    overflow (a skipped boundary) rare. Emitted entries carry ABSOLUTE
    widths (see _resolve_width)."""
    if not len(alive_counts):
        return ()
    # the margin covers run-to-run survival jitter (< 12.5%, the count
    # quantization below); overflow lanes stay at a wider width
    margin = float(os.environ.get('CHROMA_SCHED_MARGIN', '1.15'))
    # quantize the measured counts to a 3-bit mantissa (round UP): raw
    # counts jitter a few % run to run, and a stable schedule keeps the
    # cached graphs of its widths; the <12.5% slack is inside the margin
    alive_counts = [0 if a <= 0 else
                    int(math.ceil(a / (1 << max(int(a).bit_length() - 4, 0)))
                        * (1 << max(int(a).bit_length() - 4, 0)))
                    for a in (int(a) for a in alive_counts)]
    alive_at = _survival_fn(n, boundary_steps, alive_counts)
    floor_w = max(SCHED_FLOOR, MIN_BATCH)

    # three rungs per octave (1, 3/4, 5/8)
    ws = set()
    for k in range(0, 14):
        if (n >> k) < floor_w:
            break
        ws.add(_round_lanes(n >> k))
        for num, den in ((3, 4), (5, 8)):
            w = _round_lanes(num * (n >> k) // den)
            if floor_w <= w < n:
                ws.add(w)
    ladder = sorted((w for w in ws if w <= n), reverse=True)
    if not ladder or ladder[0] != n:
        ladder = [n] + [w for w in ladder if w < n]
    nl = len(ladder)

    F = min(floor_lanes, 0.05 * n)
    H = int(max_steps)

    horizon = int(boundary_steps[-1]) if len(boundary_steps) else 0

    @lru_cache(maxsize=None)
    def need(s):
        # past the measured horizon the curve is extrapolated at the
        # last segment's decay rate, but the surviving tail is exactly
        # the long-lived minority whose decay SLOWS — double the margin
        # out there rather than risk an overflow
        m = margin * (2.0 if s > horizon else 1.0)
        return max(alive_at(s) * m * n, MIN_BATCH)

    @lru_cache(maxsize=None)
    def V(s, i, nb):
        "Min modeled cost of steps s..H at width ladder[i], nb stages left."
        if s >= H:
            return 0.0
        w = ladder[i]
        best = (w + F) + V(s + 1, i, nb)
        if nb > 0 and s > 0:
            # compact to the smallest ladder width holding margin*alive
            j = None
            for cand in range(nl - 1, i, -1):
                if ladder[cand] >= need(s):
                    j = cand
                    break
            if j is not None:
                cost = (boundary_frac * w + boundary_lanes
                        + V(s, j, nb - 1))
                if cost < best:
                    best = cost
        return best

    # reconstruct: walk forward, emitting (span, absolute width) entries.
    # V(s,...) recurses to the horizon before the cache warms, so the
    # recursion limit must cover H frames
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 2 * H + 500))
    try:
        sched = []
        s, i, nb, span = 0, 0, SCHED_MAX_STAGES, 0
        while s < H:
            w = ladder[i]
            here = V(s, i, nb)
            stepped = (w + F) + V(s + 1, i, nb)
            if abs(here - stepped) < 1e-6 * max(here, 1.0):
                s += 1
                span += 1
                continue
            for cand in range(nl - 1, i, -1):
                if ladder[cand] >= need(s):
                    sched.append((span, int(ladder[cand])))
                    i, nb, span = cand, nb - 1, 0
                    break
            else:                  # pragma: no cover — defensive
                s += 1
                span += 1
    finally:
        sys.setrecursionlimit(old_limit)
    return tuple(sched)


# ---------------------------------------------------------------------------
# the fused bomb
# ---------------------------------------------------------------------------

class _Poll:
    """Alive counts of a stage's steps, read on the host without a
    blocking read: on the card each count is copied to pinned memory and
    an event recorded behind it; on the CPU the count is read at once."""

    def __init__(self, device, nsteps):
        self.cuda = device.type == 'cuda'
        self.counts = torch.zeros(nsteps, dtype=torch.int64,
                                  pin_memory=self.cuda)
        self.events = []
        self.known = 0      # leading steps whose counts the host has
        self.waits = 0      # pushes that waited for the card

    def push(self, alive):
        "Record the 0-d alive count of the next step."
        i = len(self.events)
        if not self.cuda:
            self.counts[i] = alive
            self.events.append(None)
            self.known = i + 1
            return
        self.counts[i].copy_(alive, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self.events.append(ev)
        if i - POLL_LAG >= self.known:
            # keep POLL_LAG steps queued, no more: the card stays busy
            with profiler.region('propagate.wait'):
                self.events[i - POLL_LAG].synchronize()
            self.waits += 1

    def dead(self):
        "Whether a finished step left no lane alive."
        while self.known < len(self.events):
            ev = self.events[self.known]
            if ev is not None and not ev.query():
                break
            self.known += 1
        return self.known > 0 and int(self.counts[self.known - 1]) == 0

    def last(self):
        """The alive count after the last step pushed (None before any);
        a blocking read when the host does not have it yet."""
        n = len(self.events)
        if not n:
            return None
        if self.known < n:
            with profiler.region('propagate.wait'):
                self.events[-1].synchronize()
            self.known = n
            profiler.count('propagate.blocking_reads')
        return int(self.counts[n - 1])


def _steps(photons, geometry, key, start, nsteps, use_weights,
           scatter_first, prune, use_graphs):
    """Up to `nsteps` steps of `photons` from absolute step `start` on
    stream `key`, stopping once a finished step left no lane alive.
    Returns (photons, _Poll of the steps run)."""
    n, dev = len(photons), photons.pos.device
    replays = captures = 0
    with profiler.region('propagate.stage'):
        poll = _Poll(dev, max(nsteps, 0))
        graph = None        # the graph whose static state holds the lanes
        for i in range(nsteps):
            if poll.dead():
                break
            step = start + i
            sf = scatter_first if step == 0 else 0
            g = graphs.lookup(geometry, photons, use_weights, sf, prune) \
                if use_graphs else None
            if g is None:
                if graph is not None:
                    photons, graph = graph.output(), None
                pool = DrawPool(n, dev,
                                generator=make_generator(dev, key, step))
                photons = propagate_step(photons, geometry, pool,
                                         use_weights=use_weights,
                                         scatter_first=sf, prune=prune)
                alive = photons.alive.sum()
                if use_graphs:
                    # the step just run loaded every kernel it launches:
                    # capture it for this width's later steps
                    graphs.capture(geometry, photons, use_weights, sf,
                                   prune)
                    captures += 1
            else:
                if g is not graph:
                    g.load(photons if graph is None else graph.state)
                    graph = g
                graph.replay(key, step)
                replays += 1
                alive = graph.alive
            poll.push(alive)
        if graph is not None:
            photons = graph.output()
    steps = len(poll.events)
    profiler.count('propagate.steps', steps)
    profiler.count('propagate.lane_steps', steps * n)
    if geometry.has_wireplanes:
        profiler.count('wire.walked', steps * n)
    profiler.count('propagate.throttle_waits', poll.waits)
    if use_graphs:
        profiler.count('graphs.captures', captures)
        profiler.count('graphs.replays', replays)
    return photons, poll


def graph_route(photons):
    """Whether the fused bomb replays its steps from CUDA graphs: on a CUDA
    device, for every geometry (no step reads the host, wire planes'
    included)."""
    return photons.pos.is_cuda


def _fused_bomb(photons, geometry, seed, schedule, max_steps,
                use_weights=False, scatter_first=0, prune=True,
                report=False, use_graphs=None):
    """The whole bomb by a static compaction schedule (see the module
    docstring). Returns (final PhotonState in the input's lane order, the
    probe's per-step survival curve as a numpy int array when `report`,
    else None, the NaN-abort flag).

    use_graphs: run each stage's step as a CUDA graph (ops.graphs); None
    means on a CUDA device (graph_route), False runs every step eagerly."""
    if use_graphs is None:
        use_graphs = graph_route(photons)
    curves = []
    opts = (use_weights, scatter_first, prune, use_graphs)

    def tail(poll):
        "Count a stage's steps that no compaction follows."
        profiler.count('propagate.tail_steps', len(poll.events))

    def to_end(ph, key, start):
        "The steps left, with no compaction after them."
        ph, poll = _steps(ph, geometry, key, start, max_steps - start, *opts)
        tail(poll)
        return ph

    def stage(ph, start, sched, wider=()):
        """The schedule's stages from absolute step `start` on `ph`.
        `wider`: the widths of boundaries skipped before this stage, each
        wider than the next entry's."""
        n = len(ph)
        if not sched or start >= max_steps:
            return to_end(ph, seed, start)
        nsteps = min(sched[0][0], max_steps - start)
        ph, poll = _steps(ph, geometry, seed, start, nsteps, *opts)
        if report:
            curves.append(poll.counts)    # complete after the final read
        start2 = start + nsteps
        m = _resolve_width(n, sched[0])
        if start2 >= max_steps or m < MIN_BATCH or m >= n:
            tail(poll)
            return ph
        n_alive = poll.last()
        if n_alive == 0:
            tail(poll)
            # every later stage would run no step; the probe's curve
            # still gets their (zero) counts, as JAX's does
            for ent in sched[1:] if report else ():
                if start2 >= max_steps:
                    break
                k = min(int(ent[0]), max_steps - start2)
                curves.append(torch.zeros(k, dtype=torch.int64))
                start2 += k
            return ph
        if n_alive > m:
            # the survivors overflow the slice: keep them at the narrowest
            # skipped width that holds them, else skip this boundary
            profiler.count('propagate.overflow_lanes', n_alive - m)
            fits = [w for w in wider if n_alive <= w < n]
            if not fits:
                return stage(ph, start2, sched[1:], wider + (m,))
            m = min(fits)
        with profiler.region('propagate.compact'):
            dest, perm = _ps_compact_perm(ph.alive)
            php = ph.map(lambda a: a[perm])
        prefix = stage(php.map(lambda a: a[:m]), start2, sched[1:],
                       tuple(w for w in wider if w < m))
        with profiler.region('propagate.compact'):
            return _cat(prefix, php.map(lambda a: a[m:])).map(
                lambda a: a[dest])

    out = stage(photons, 0, tuple(schedule))
    abort = _aborted(out)         # the end's read: also syncs the curves
    if out.pos.is_cuda:
        profiler.count('propagate.blocking_reads')
    curve = None
    if report:
        curve = (torch.cat(curves).numpy() if curves
                 else np.zeros(0, np.int64))
    return out, curve, abort


# ---------------------------------------------------------------------------
# learned schedules
# ---------------------------------------------------------------------------

# Learned performance state, keyed by the geometry's CONTENT fingerprint
# (chroma_tpu_torch.perfcache; a session id-key for geometries built
# outside the registered paths). Tuned entries write through to the perf
# cache, so a cold process reuses the probe's work.

# per-(geometry, batch, max_steps) tuned schedules
_SCHED_CACHE = {}

# the perf-cache key of a tuned schedule, by (batch, max_steps). Its
# version names the step cost the tuner's constants were measured on
# (k2pre: a step of the uniform blocks, k2_pre, K1, K3 and the regrouped
# k2_post); entries tuned on another cost model (the step of some 2,000
# torch ops, key 'sched:'; the prologue's torch ops with the first K2, key
# 'sched/k2:') are never read.
SCHED_KEY = 'sched/k2pre:%d:%d'

# per-(geometry, batch) raw probe survival curves (diagnostics)
_PROBE_COUNTS = {}


def perf_key(geometry):
    "Content-fingerprint cache key of a geometry (see perfcache)."
    return perfcache.key_of(geometry)


def _sched_lookup(geometry, n, max_steps):
    """Tuned schedule for this (geometry, batch, max_steps) — session
    cache first, then the persisted perf entry; None before any probe
    has run."""
    pk = perf_key(geometry)
    ck = (pk, n, int(max_steps))
    if ck in _SCHED_CACHE:
        return _SCHED_CACHE[ck]
    if perfcache.persistent(pk):
        sched = perfcache.load(pk).get(SCHED_KEY % (n, int(max_steps)))
        if sched is not None:
            sched = perfcache.as_tuples(sched)
            _SCHED_CACHE[ck] = sched
            return sched
    return None


def schedule_for(geometry, n, max_steps=100):
    """The fused-compaction schedule propagate() will use for this
    (geometry, batch length): the env override, the probe-tuned entry,
    or — before any probe has run — the conservative probe schedule."""
    spec = os.environ.get('CHROMA_FUSED_SCHEDULE')
    if spec is not None:
        return _trim_schedule(_parse_schedule(spec), n)
    cached = _sched_lookup(geometry, n, max_steps)
    if cached is not None:
        return cached
    return _trim_schedule(PROBE_SCHEDULE, n)


def use_fused():
    "Whether propagate() takes the fused route (CHROMA_FUSED not '0')."
    return os.environ.get('CHROMA_FUSED', '1') != '0'


def _propagate_fused(photons, geometry, seed, max_steps, use_weights,
                     scatter_first, prune, tune):
    """The fused route of propagate(): tuned bomb, or the probe and tune
    (tune=False: schedule_for's schedule, never a probe)."""
    n = len(photons)
    max_steps = int(max_steps)
    if not tune or os.environ.get('CHROMA_FUSED_SCHEDULE') is not None:
        sched = schedule_for(geometry, n, max_steps)
    else:
        sched = _sched_lookup(geometry, n, max_steps)
    args = (max_steps, bool(use_weights), int(scatter_first), prune)
    if sched is not None:
        with profiler.region('propagate.fused[n=%d]' % n):
            result, _, abort = _fused_bomb(photons, geometry, seed, sched,
                                           *args)
    else:
        # first bomb on this (geometry, batch): run the conservative
        # probe schedule, recording the alive count after every step,
        # and tune the schedule of all later bombs from that curve
        probe = _trim_schedule(PROBE_SCHEDULE, n)
        with profiler.region('propagate.probe[n=%d]' % n):
            result, counts, abort = _fused_bomb(photons, geometry, seed,
                                                probe, *args, report=True)
        counts = np.maximum(counts, 0)
        pk = perf_key(geometry)
        _PROBE_COUNTS[(pk, n)] = counts
        bsteps = list(range(1, len(counts) + 1))
        tuned = _tune_schedule(n, bsteps, counts, max_steps)
        _SCHED_CACHE[(pk, n, max_steps)] = tuned
        perfcache.update(pk, {SCHED_KEY % (n, max_steps): tuned,
                              'counts:%d:%d' % (n, max_steps):
                              [int(c) for c in counts]})
    if abort:
        logger.warning('ABORTED PHOTONS')
    return result


def propagate(photons, geometry, seed, max_steps=100, step_chunk='auto',
              use_weights=False, scatter_first=0, track_steps=False,
              compact=True, tune=True):
    """Propagate a PhotonState to termination or `max_steps`; returns the
    final PhotonState in the input's lane order.

    With compaction on, no tracking and an int scatter_first (and
    CHROMA_FUSED not '0'), the bomb takes the fused route (see the module
    docstring). Otherwise the chunked driver runs: step_chunk='auto'
    compacts after step 1 and then doubles the chunk (up to CHUNK_CAP
    steps) at every boundary; an int fixes it; compact=False never
    compacts. use_weights and scatter_first select the weighted transport
    of the likelihood biasing modes (see ops.photon.propagate_to_boundary).
    tune=False keeps the fused route from probing: it runs
    schedule_for's schedule (a sharded rank's bomb, as in
    chroma_tpu.parallel.sharding).

    track_steps=True returns (final, tracking): after every chunk, one
    host snapshot (orig_idx numpy array, PhotonState of CPU tensors) of
    the chunk's lanes, taken after the chunk's steps as the JAX driver
    takes it (chroma_tpu/ops/propagate.py:1262-1264)."""
    # traversal pruning needs the true boundary distance to be irrelevant;
    # any scatter_first biasing computes weights from it, so turn it off
    prune = isinstance(scatter_first, int) and scatter_first == 0
    if (compact and not track_steps and isinstance(scatter_first, int)
            and use_fused()):
        return _propagate_fused(photons, geometry, seed, max_steps,
                                use_weights, scatter_first, prune, tune)

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
        if not compact:
            bucket = len(current)
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
        if geometry.has_wireplanes:
            profiler.count('wire.walked', nsteps * len(current))
        if track_steps:
            tracking.append((orig_idx.cpu().numpy().copy(), current.map(
                lambda a: a.to('cpu', copy=True))))
        if n_alive == 0:
            break

    _write_back(final, orig_idx, current)
    if _aborted(final):
        logger.warning('ABORTED PHOTONS')
    if track_steps:
        return final, tracking
    return final
