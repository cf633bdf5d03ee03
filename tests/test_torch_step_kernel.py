"""K2's plain twin and what K2 is given, on the CPU.

K2 (chroma_tpu_torch/csrc/step_kernel.cu) runs only on the card; here its
plain twin step_kernel.after_query_plain and its inputs are held:

  * the draw-site table (step_kernel.draw_sites) against the stream
    sequence the plain step actually draws: a DrawPool whose `draw`
    records every stream with its range and the chain of plain functions
    that drew it, for every subset of the five surface models x
    use_weights x scatter_first in {-1, 0, 1} x bulk reemission on or
    off (one case each);
  * the packed tables read back at sampled indices against the
    geometry's tensors, and their order against the kernel source's
    `enum Table` and `enum Site`;
  * the prologue, the plain walk and after_query_plain composed by hand
    against propagate_step bit for bit, and against the JAX package's
    propagate_step with the JAX pool's blocks injected: on demo.tiny(),
    the all-models detector of tests/test_torch_surfaces.py (every surface
    model, bulk reemission, a wire plane) and a three-plane wire box.
    Integer fields equal on at least 99.9% of the lanes (the others
    printed: an ulp of XLA's against torch's transcendental functions can
    move a roulette draw across its threshold), floats to rtol 1e-5;
  * the fused driver's route: a wire-plane geometry takes the graph route
    on a CUDA device (replayed here by a CPU stand-in for the graph), with
    the same result as eager steps.
"""
import itertools
import math
import re
import sys
import types

import numpy as np
import pytest
import torch
import jax

from chroma_tpu.ops import photon as jphoton
from chroma_tpu.ops import propagate as jprop
from chroma_tpu.ops import types as jtypes
from chroma_tpu.ops.sample import make_key
from chroma_tpu_torch.ops import graphs, photon, step_kernel, wireplane
from chroma_tpu_torch.ops import propagate as P
from chroma_tpu_torch.ops import types as ttypes
from chroma_tpu_torch.ops import visit_kernel
from chroma_tpu_torch.ops.sample import DrawPool, make_generator

from test_torch_host import (J, T, fresh_perf_cache,  # noqa: F401
                             same_native_kit)
from test_torch_photon import FLOAT_FIELDS, INT_FIELDS, jax_blocks
from test_torch_photon import torch_state
from test_torch_surfaces import (all_models_detector, assert_lanes_agree,
                                 bomb, wire_verdicts)
from test_torch_wireplane import lartpc

torch.set_num_threads(2)

N = 2048
MODELS = (0, 1, 2, 3, 4)
SUBSETS = [c for k in range(1, 6) for c in itertools.combinations(MODELS, k)]


def _geometry(h, kind):
    if kind == 'tiny':
        geo = h.demo.tiny()
        geo.flatten()
        return geo
    if kind == 'all_models':
        return all_models_detector(h)
    return lartpc(h, (0.0, 60.0, -60.0))


@pytest.fixture(scope='module')
def port_all_models():
    return ttypes.build_geometry_arrays(all_models_detector(T))


def _draw_range(name):
    "The U(low, high] a site's stream is mapped to (DrawPool.draw)."
    if name.endswith('_phi'):
        return 0.0, 2.0 * math.pi
    if name.endswith('dir_u') or name.endswith('pol_u'):
        return -1.0, 1.0
    return 0.0, 1.0


@pytest.mark.parametrize(
    'models,use_weights,scatter_first,reemission',
    list(itertools.product(SUBSETS, (False, True), (-1, 0, 1),
                           (False, True))),
    ids=lambda v: 'm' + ''.join(map(str, v)) if isinstance(v, tuple)
    else str(v))
def test_draw_sites_match_plain_draws(port_all_models, monkeypatch, models,
                                      use_weights, scatter_first,
                                      reemission):
    """Every stream the plain step draws, in order, is the stream the
    table gives its site, with the site's range and drawn by the site's
    chain of plain functions; the table's total is the step's draw
    count."""
    import dataclasses
    ga = dataclasses.replace(
        port_all_models,
        surfaces=dataclasses.replace(port_all_models.surfaces,
                                     models_present=models),
        materials=dataclasses.replace(port_all_models.materials,
                                      has_reemission=reemission))
    record = []
    draw = DrawPool.draw

    def recording(self, low=0.0, high=1.0):
        chain = []
        frame = sys._getframe(1)
        while frame is not None:
            if frame.f_code.co_filename == photon.__file__:
                chain.append(frame.f_code.co_name)
            frame = frame.f_back
        stop = min(chain.index(f) for f in ('finish_step', 'propagate_step')
                   if f in chain)
        record.append((self._count, low, high, tuple(chain[:stop])))
        return draw(self, low, high)
    monkeypatch.setattr(DrawPool, 'draw', recording)

    # the draws do not depend on the lanes: a few, heading straight up
    # (a short window of candidate wires)
    host_bomb = bomb(16, 1)
    host_bomb.dir[:] = (0.0, 0.0, 1.0)
    state = P.photon_state_from_host(host_bomb, 'cpu')
    pool = DrawPool(16, 'cpu', generator=make_generator('cpu', 1))
    photon.propagate_step(state, ga, pool, use_weights=use_weights,
                          scatter_first=scatter_first,
                          prune=scatter_first == 0)
    sites, total = step_kernel.draw_sites(models, reemission)
    assert [r[0] for r in record] == list(range(total))
    assert pool._count == total
    assert step_kernel.n_draws(ga) == total
    by_stream = {k: r for k, r in enumerate(record)}
    for (name, _, chain), k in zip(step_kernel.SITES, sites):
        if k < 0:
            continue
        _, low, high, got_chain = by_stream[k]
        assert (low, high) == _draw_range(name), name
        assert got_chain == chain, (name, got_chain)
    assert sorted(k for k in sites if k >= 0) == list(range(total))


@pytest.mark.parametrize('kind', ['tiny', 'all_models', 'wires'])
def test_packed_tables_read_back(kind):
    """Every table K2 reads, read back from the pack at sampled indices by
    the kernel's offset arithmetic, equals the geometry's tensor."""
    ga = ttypes.build_geometry_arrays(_geometry(T, kind))
    pack = step_kernel.pack_tables(ga)
    src = step_kernel.table_sources(ga)
    assert set(pack.offsets) == set(step_kernel.TABLES_F32
                                    + step_kernel.TABLES_I32)
    assert pack.f32.dtype == torch.float32 and pack.i32.dtype == torch.int32
    rs = np.random.RandomState(0)
    checked = 0
    for name, t in src.items():
        assert pack.shapes[name] == tuple(t.shape), name
        if t.numel() == 0:
            continue
        for _ in range(16):
            idx = tuple(int(rs.randint(d)) for d in t.shape)
            got, want = pack.read(name, idx), t[idx]
            assert got.item() == want.item() or (
                math.isinf(want.item()) and got.item() == want.item()), \
                (name, idx)
            checked += 1
    assert checked > 100
    assert (ga.inst is not None) == (src['rot'].numel() > 0)
    assert ga.has_wireplanes == (src['wire_v'].numel() > 0)


def test_kernel_source_orders_match():
    """The kernel's `enum Table` and `enum Site` list the wrapper's tables
    and draw sites in the wrapper's order, and StepArgs its fields."""
    with open(step_kernel.SOURCE) as fh:
        src = fh.read()

    def enum(name):
        body = re.search(r'enum %s \{(.*?)\};' % name, src, re.S).group(1)
        return [w.strip() for w in body.replace('\n', ' ').split(',')
                if w.strip() and not w.strip().startswith('N_')]
    assert enum('Table') == ['T_' + n.upper() for n in
                             step_kernel.TABLES_F32 + step_kernel.TABLES_I32]
    assert enum('Site') == ['S_' + n.upper() for n in step_kernel.SITE_NAMES]
    body = re.search(r'struct StepArgs \{(.*?)\n\};', src, re.S).group(1)
    body = re.sub(r'//[^\n]*', '', body)
    fields = re.findall(r'(\w+)(?:\[\w+\])?\s*[;,]', body)
    assert fields == [f for f, _ in step_kernel._Args._fields_]


def _composed(ps, ga, pool, use_weights=False, scatter_first=0, prune=True):
    "The step by hand: prologue, plain walk, plain wire walk, plain twin."
    ph, active, blocks, pruned, limit = photon.step_prologue(
        ps, ga, pool, use_weights, prune)
    query = visit_kernel.traverse(ga.wide, ph.pos, ph.dir,
                                  ph.last_hit_triangle, mask=active,
                                  best_limit=limit)[:5]
    wires = wireplane.walk_plain(ph.pos, ph.dir, ga, active) \
        if ga.has_wireplanes else None
    return step_kernel.after_query_plain(ph, ga, blocks, active, pruned,
                                         query, wires, use_weights,
                                         scatter_first)


@pytest.mark.parametrize('kind', ['tiny', 'all_models', 'wires'])
def test_plain_twin_is_the_step_and_matches_jax(kind):
    """Three steps from each JAX state: the composed plain step equals
    propagate_step bit for bit (same generator seed) and the JAX step with
    the JAX pool's blocks injected."""
    ga = jtypes.build_geometry_arrays(_geometry(J, kind))
    ta = ttypes.build_geometry_arrays(_geometry(T, kind))
    np.random.seed(11)
    host_bomb = bomb(N, 5) if kind != 'tiny' else \
        J.photon_bomb(N, 400.0, (0, 0, 0))
    if kind == 'wires':
        host_bomb = _upward(host_bomb)
    js = jprop.photon_state_from_host(host_bomb)
    step = jax.jit(jphoton.propagate_step)
    key = make_key(6)
    for s in range(3):
        step_key = jax.random.fold_in(key, s)
        ts0 = torch_state(js)
        mine = _composed(ts0, ta, DrawPool(N, 'cpu', generator=make_generator(
            'cpu', 4, s)))
        ref = photon.propagate_step(ts0, ta, DrawPool(
            N, 'cpu', generator=make_generator('cpu', 4, s)))
        for name in INT_FIELDS + FLOAT_FIELDS:
            assert torch.equal(getattr(mine, name), getattr(ref, name)), name
        injected = _composed(ts0, ta, DrawPool(N, 'cpu',
                                               blocks=jax_blocks(step_key, N)))
        js = step(js, ga, step_key)
        agree = assert_lanes_agree(js, injected,
                                   decided=wire_verdicts(ga, ta, ts0))
        print(kind, 'step', s, 'lanes differing from JAX:',
              int((~agree).sum()))
    if kind == 'wires':
        assert (np.asarray(js.last_hit_triangle) == -2).any()


def _upward(photons):
    """`photons` moved 40 mm below the wire planes and turned to head up
    into them, none grazing (the plain wire walk loops over the batch's
    widest window of candidate wires: a grazing ray's is thousands)."""
    photons.pos[:, 2] = -40.0
    d = photons.dir
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    photons.dir = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)
    pol = np.cross(photons.dir, np.array([1.0, 0.0, 0.0]))
    photons.pol = (pol / np.linalg.norm(pol, axis=1, keepdims=True)).astype(
        np.float32)
    return photons


class _EagerGraph:
    """A CPU stand-in for graphs.StepGraph: it holds its lanes and runs the
    step eagerly on `replay`, as the graph would replay it."""

    made = []
    replays = 0

    def __init__(self, geometry, photons, use_weights, sf, prune):
        self.geometry, self.opts = geometry, (use_weights, sf, prune)
        self.state = photons
        _EagerGraph.made.append(self)

    def load(self, photons):
        self.state = photons

    def replay(self, *seed):
        _EagerGraph.replays += 1
        n = len(self.state)
        uw, sf, prune = self.opts
        self.state = photon.propagate_step(
            self.state, self.geometry,
            DrawPool(n, 'cpu', generator=make_generator('cpu', *seed)),
            use_weights=uw, scatter_first=sf, prune=prune)
        self.alive = self.state.alive.sum()

    def output(self):
        return self.state


def test_wire_planes_take_the_graph_route(port_all_models, monkeypatch):
    """On a CUDA device the fused bomb replays graphs for every geometry,
    wire planes included (graph_route); with the graphs stood in for on
    the CPU, a wire-plane bomb captures and replays, and its result equals
    the eager bomb's bit for bit."""
    on_card = types.SimpleNamespace(pos=types.SimpleNamespace(is_cuda=True))
    assert P.graph_route(on_card)
    ta = port_all_models
    assert ta.has_wireplanes
    state = P.photon_state_from_host(bomb(1024, 8), 'cpu')
    sched = ((1, 2), (2, 2))     # halve the lanes twice
    eager, _, _ = P._fused_bomb(state, ta, 5, sched, 8, use_graphs=False)

    cache = {}

    def lookup(geometry, photons, uw, sf, prune):
        return cache.get((len(photons), uw, sf, prune))

    def capture(geometry, photons, uw, sf, prune):
        g = _EagerGraph(geometry, photons, uw, sf, prune)
        cache[(len(photons), uw, sf, prune)] = g
        return g
    monkeypatch.setattr(graphs, 'lookup', lookup)
    monkeypatch.setattr(graphs, 'capture', capture)
    monkeypatch.setattr(P, 'graph_route', lambda photons: True)
    routed, _, _ = P._fused_bomb(state, ta, 5, sched, 8)
    assert _EagerGraph.made and _EagerGraph.replays
    for name in INT_FIELDS + FLOAT_FIELDS:
        assert torch.equal(getattr(routed, name), getattr(eager, name)), name
    assert ((routed.last_hit_triangle == -2).any()
            or ((routed.flags & photon.i32(T.event.SURFACE_ABSORB)) != 0)
            .any())
