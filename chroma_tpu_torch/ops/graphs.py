"""CUDA graphs of the propagation step: the port's counterpart of `jax.jit`
on the fused-bomb path of chroma_tpu.ops.propagate (no module twin in the
JAX package).

A step on the card is the uniform blocks' torch ops (one `uniform_` a
block of eight streams) and a launch each of K2's k2_pre (the prologue's
NaN guard and pruning limit), K1 (the geometry query), K3 (the wire walk,
on wire-plane geometries) and K2's k2_post (everything after the query),
each dispatched from the host. A `StepGraph` captures `propagate_step`
once for a static lane count, the kernels' launches included (they are
ctypes launches on torch's current stream, which is the capture stream),
and then replays the capture once per step: one host call a step.

What a replay must not bake in:
  * the random draws. Each graph owns a torch.Generator registered with
    it (`CUDAGraph.register_generator_state`); before every replay the
    generator is re-seeded on the host with the step's seed, so step s
    reads the Philox seed and offset that an eager step with
    `make_generator(device, key, s)` starts from, and both draw the same
    numbers bit for bit;
  * the state. The capture reads and writes the graph's own static
    buffers (`state`): `load` copies lanes in, a replay advances them by
    one step in place, `output` clones them out;
  * host reads and table builds. Nothing in the captured step reads a
    device value on the host (a step that did would raise during
    capture), and K2's and K3's geometry tables are packed before the
    capture begins.

The kernels' launch counters (visit_kernel.launches,
step_kernel.launches for k2_post and step_kernel.pre_launches for k2_pre,
wire_kernel.launches) move while the step is captured, for launches that
are only recorded; the capture takes them back, and every replay adds the
launches the graph holds (`k1`, `k2`, `k2_pre`, `k3`).

Graphs are cached per geometry by (lane count, use_weights, scatter_first
of the step, prune), as XLA caches compiled programs by static
arguments. A geometry keeps its MAX_GRAPHS most recently used graphs:
batch sizes that do not repeat (the likelihood's events) would otherwise
add a graph and its static lanes at every new width. Evicted graphs, and
those of a freed geometry, are destroyed outside any capture (a graph
destroyed while another is captured invalidates that capture, so the
garbage collector is off during a capture too). All of them allocate
from one memory pool per device: a graph's outputs are copied into
buffers allocated outside the pool before its replay ends, so no graph
keeps live data in the pool and any order of replays is safe.

The first step at a new width runs eagerly (ops.propagate) and the
graph is captured right after it, from the lanes it left: that step
loads every kernel the capture records. So a bomb launches each kernel
once a step whichever way the step runs: replays times its count in the
graph plus one eager step a capture.

The profiler's graphs.capture span times each capture, outside the
captured region; the driver counts captures and replays (graphs.captures,
graphs.replays) once a stage (ops.propagate).
"""
from __future__ import annotations

import dataclasses
import gc
import weakref
from collections import OrderedDict

import torch

from chroma_tpu_torch.ops import step_kernel, visit_kernel, wire_kernel
from chroma_tpu_torch.ops.photon import propagate_step
from chroma_tpu_torch.ops.sample import DrawPool, mix_seed
from chroma_tpu_torch.profiler import profiler

# the kernels whose launches a graph records: (attribute, module, the
# module's counter)
KERNELS = (('k1', visit_kernel, 'launches'), ('k2', step_kernel, 'launches'),
           ('k2_pre', step_kernel, 'pre_launches'),
           ('k3', wire_kernel, 'launches'))

# graphs kept per geometry: well above the widths of one bomb (at most
# CHROMA_SCHED_MAX_STAGES + 1 stages and step 0's own graph under
# scatter_first), so that a repeated bomb replays them all
MAX_GRAPHS = 64

_GRAPHS = {}     # id(geometry) -> (weakref to it, OrderedDict
                 # {(width, use_weights, sf, prune): graph}, least
                 # recently used first)
_DEAD = []       # evicted graphs and graph dicts of freed geometries,
                 # destroyed before the next capture: destroying a graph
                 # during a capture (a garbage collection inside it)
                 # would invalidate it
_POOLS = {}      # device index -> shared graph memory pool
_ANCHORS = {}    # device index -> the first graph captured into its pool,
                 # kept for the process's life: a pool whose graphs were
                 # all destroyed is released, and a capture into its id
                 # would then fail
_STREAMS = {}    # device index -> side stream that captures run on


class StepGraph:
    """One propagation step of `width` lanes on `geometry`, captured as a
    CUDA graph (see the module docstring), from a PhotonState of that
    width on a CUDA device whose lanes it holds afterwards. The caller
    has just run the same step eagerly at this width, so every kernel the
    capture records is loaded already: nothing is loaded or initialised
    during the capture, and no step runs only to warm up."""

    def __init__(self, geometry, photons, use_weights, scatter_first,
                 prune):
        dev = photons.pos.device
        # the kernels and their geometry tables, before the capture
        visit_kernel.build()
        step_kernel.build()
        step_kernel.tables(geometry)
        if geometry.has_wireplanes:
            wire_kernel.build()
            wire_kernel.planes(geometry)
        current = torch.cuda.current_stream(dev)
        self.state = photons.map(torch.clone)
        self.alive = torch.zeros((), dtype=torch.int64, device=dev)
        self.generator = torch.Generator(device=dev)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(self.generator)
        side = _STREAMS.setdefault(dev.index, torch.cuda.Stream(dev))
        side.wait_stream(current)
        before = {name: getattr(mod, ctr) for name, mod, ctr in KERNELS}
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                self.graph.capture_begin(pool=_pool(dev))
                try:
                    pool = DrawPool(len(photons), dev,
                                    generator=self.generator)
                    out = propagate_step(self.state, geometry, pool,
                                         use_weights=use_weights,
                                         scatter_first=scatter_first,
                                         prune=prune)
                    for f in dataclasses.fields(out):
                        getattr(self.state, f.name).copy_(
                            getattr(out, f.name))
                    self.alive.copy_(out.alive.sum())
                    del out, pool
                except BaseException:
                    # end the broken capture so that the stream is usable
                    # again; the original error is the one raised. The
                    # caching allocator keeps the pool of a capture that
                    # failed marked as recording, and a capture into it
                    # would fail: later captures take a new pool and side
                    # stream
                    try:
                        self.graph.capture_end()
                    except RuntimeError:
                        pass
                    for held in (_POOLS, _STREAMS, _ANCHORS):
                        held.pop(dev.index, None)
                    raise
                self.graph.capture_end()
            current.wait_stream(side)
            _ANCHORS.setdefault(dev.index, self.graph)
            # the launches the capture recorded run only when replayed
            for name, mod, ctr in KERNELS:
                setattr(self, name, getattr(mod, ctr) - before[name])
        finally:
            for name, mod, ctr in KERNELS:
                setattr(mod, ctr, before[name])
            if collecting:
                gc.enable()

    def load(self, photons):
        "Copy a PhotonState of this graph's width into its static state."
        for f in dataclasses.fields(photons):
            getattr(self.state, f.name).copy_(getattr(photons, f.name))

    def replay(self, *seed):
        """One step of the loaded lanes, drawing as an eager step with
        make_generator(device, *seed) does. `alive` then holds the count of
        lanes alive after it (on the device)."""
        self.generator.manual_seed(mix_seed(*seed))
        self.graph.replay()
        for name, mod, ctr in KERNELS:
            setattr(mod, ctr, getattr(mod, ctr) + getattr(self, name))

    def output(self):
        "A copy of the lanes, which the next load or replay overwrites."
        return self.state.map(torch.clone)


def _pool(dev):
    if dev.index not in _POOLS:
        _POOLS[dev.index] = torch.cuda.graph_pool_handle()
    return _POOLS[dev.index]


def _key(photons, use_weights, scatter_first, prune):
    return (len(photons), bool(use_weights), int(scatter_first), bool(prune))


def _graphs_of(geometry):
    "The graph dict of `geometry`, freed with it."
    ent = _GRAPHS.get(id(geometry))
    if ent is None or ent[0]() is not geometry:
        ent = (weakref.ref(geometry), OrderedDict())
        _GRAPHS[id(geometry)] = ent
        weakref.finalize(geometry, _retire, id(geometry))
    return ent[1]


def _retire(key):
    "A geometry died: keep its graphs until the next capture starts."
    ent = _GRAPHS.pop(key, None)
    if ent is not None:
        _DEAD.append(ent[1])


def lookup(geometry, photons, use_weights, scatter_first, prune):
    """The cached StepGraph of `geometry` for photons' width and these
    options (now its most recently used), or None when none is cached."""
    cached = _graphs_of(geometry)
    key = _key(photons, use_weights, scatter_first, prune)
    g = cached.get(key)
    if g is not None:
        cached.move_to_end(key)
    return g


def capture(geometry, photons, use_weights, scatter_first, prune):
    """Capture and cache the StepGraph of `geometry` for photons' width
    and these options, holding photons' lanes; the geometry's least
    recently used graphs beyond MAX_GRAPHS - 1 are destroyed first."""
    cached = _graphs_of(geometry)
    while len(cached) >= MAX_GRAPHS:
        _DEAD.append(cached.popitem(last=False)[1])
    _DEAD.clear()
    with profiler.region('graphs.capture'):
        g = StepGraph(geometry, photons, use_weights, scatter_first, prune)
    cached[_key(photons, use_weights, scatter_first, prune)] = g
    return g
