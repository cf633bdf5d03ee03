"""The plain reference against the program on the CPU, at a small size:
its meshes are the program's triangles in the program's order, its ray
queries find what the program's plain traversal and wire walk find, and
its transport agrees with the program's in every history class."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from bench_h100.harness import cell, traffic
from bench_h100.reference import judge, physics, scene as sc
from bench_h100.tests.bench_fixtures import TINY_QUICK, small, small_judge  # noqa: F401


def quick_cfg():
    cfg = json.load(open(os.path.join(cell.BENCH, 'configs', 'quick.json')))
    cfg.update(TINY_QUICK)
    return cfg


@pytest.fixture(scope='module')
def tiny():
    "(reference scene, the program's flat tiny detector)."
    from chroma_tpu_torch import demo
    from chroma_tpu_torch.loader import as_flat_geometry
    mod = cell.load_module(os.path.join(cell.BENCH, 'configs', 'quick.py'),
                           'bench_h100.configs.quick')
    scene = mod.reference_scene(quick_cfg(), 400.0).to('cpu')
    geo = as_flat_geometry(demo.detector(2000.0, 2500.0, 700.0))
    return scene, geo


def test_mesh_is_the_programs(tiny):
    scene, geo = tiny
    ids = torch.arange(scene.n_triangles)
    v0, e1, e2 = scene.triangle_world(ids)
    ref = torch.stack([v0, v0 + e1, v0 + e2], 1).numpy()
    prog = geo.mesh.vertices[geo.mesh.triangles]
    assert ref.shape == prog.shape
    assert np.abs(ref - prog).max() < 1e-3
    m_in, m_out, surf, inst = scene.triangle_props(ids)
    names = [m.name for m in geo.unique_materials]
    snames = [s.name if s is not None else None for s in geo.unique_surfaces]
    ref_m = ['water', 'glass', 'vacuum']
    ref_s = ['black_surface', 'r7081hqe_photocathode', 'shiny_surface']
    assert [names[i] for i in geo.material1_index] == \
        [ref_m[i] for i in m_in.tolist()]
    assert [names[i] for i in geo.material2_index] == \
        [ref_m[i] for i in m_out.tolist()]
    assert [snames[i] if i >= 0 else None for i in geo.surface_index] == \
        [ref_s[i] if i >= 0 else None for i in surf.tolist()]
    # channel i is the i-th PMT, solid i + 1 after the sphere
    det = geo.solid_id_to_channel_index
    assert (scene.t_channel.numpy() == np.asarray(det)).all()


def test_query_finds_the_programs_nearest_triangle(tiny):
    from chroma_tpu_torch.ops import mesh_wide
    from chroma_tpu_torch.ops.types import build_geometry_arrays
    scene, geo = tiny
    ga = build_geometry_arrays(geo)
    gen = torch.Generator().manual_seed(5)
    n = 4096
    o = (torch.rand((n, 3), generator=gen) - 0.5) * 3000
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen),
                                      dim=1)
    mine = sc.query(scene, o, d)
    tri, dist = mesh_wide.traverse(ga.wide, o, d)[:2]
    same = (mine.tri == tri.long())
    assert same.float().mean() > 0.995
    assert (mine.t[same] - dist[same]).abs().max() < 1e-2


@pytest.mark.parametrize('workload,photons', [('quick.bomb', 1 << 15)])
def test_transport_agrees_with_the_program(workload, photons, tmp_path):
    from chroma_tpu_torch.sim import Simulation
    from bench_h100.entries.simulate import Entry
    ctx = cell.context(workload, 77, 'cpu', overrides=small(workload,
                                                            photons),
                       cache_dir=str(tmp_path))
    entry = Entry(ctx)
    entry.setup()
    assert isinstance(entry.sim, Simulation)
    state = entry._state(0)
    prog = next(entry.sim.simulate(state, keep_photons_end=True,
                                   max_steps=1000,
                                   photons_per_batch=photons - 1))
    end = prog.photons_end
    scene = ctx.config_module.reference_scene(ctx.cfg, 400.0).to('cpu')
    ev = traffic.bomb(ctx.mix, ctx.cfg, 77, 0, 'cpu')
    ref = physics.propagate(scene, ev, traffic.generator('cpu', 3), 1000)
    mine = {'pos': torch.as_tensor(end.pos), 'dir': torch.as_tensor(end.dir),
            't': torch.as_tensor(end.t),
            'flags': torch.as_tensor(end.flags.view('int32')).long(),
            'last': torch.as_tensor(end.last_hit_triangles).long()}
    ref['t'] = ref['t'].float()
    for side in (mine, ref):
        side['leg'] = judge.single_leg_breaks(scene, ev, side)
    z = judge.tally_z(mine, ref)
    assert z < cell.limits(workload)['tally_z']
    faults, gap, counts = judge.path_checks(scene, ev, mine)
    assert faults <= cell.limits(workload)['path_faults']
    assert gap < cell.limits(workload)['end_gap_mm']
    assert counts['straight'] > 0


def _single_scatters(scene, cfg, n, seed):
    """Photons of a bomb each scattered once in the water, 100-600 mm from
    the vertex, in a direction drawn at random: (start, the leg's first
    hit from the scatter point, end state had that hit ended them)."""
    mix = {'photons': n, 'wavelength_nm': 400.0}
    start = traffic.bomb(mix, cfg, seed, 0, 'cpu')
    gen = traffic.generator('cpu', seed, 9)
    s1 = 100.0 + 500.0 * torch.rand(n, generator=gen)
    q = start['pos'] + s1[:, None] * start['dir']
    d1 = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen),
                                       dim=1)
    hit = sc.query(scene, q, d1)
    water = float(scene.t_materials[0, 0])
    end = {'pos': q + hit.t[:, None] * d1, 'dir': d1,
           't': (s1 + hit.t) * water / physics.SPEED_OF_LIGHT,
           'flags': torch.full((n,), physics.RAYLEIGH_SCATTER
                               | physics.SURFACE_ABSORB),
           'last': hit.tri.clone()}
    return start, hit, end


def test_a_scattered_photon_through_a_pmt_breaks_its_single_leg():
    """A fault that only scattered photons carry and that the checks of
    each photon's end (path_faults, end_gap_mm) cannot see: photons whose
    leg after their one scatter meets a PMT are reported absorbed on the
    black sphere behind it, end point, triangle, time and flag agreeing
    with one another. single_leg_breaks finds them, and the share of such
    photons fails tally_z against the same photons ended where their leg
    first meets a surface (the PMT's glass)."""
    cfg = quick_cfg()
    mod = cell.load_module(os.path.join(cell.BENCH, 'configs', 'quick.py'),
                           'bench_h100.configs.quick')
    scene = mod.reference_scene(cfg, 400.0).to('cpu')
    start, hit, sound = _single_scatters(scene, cfg, 1 << 13, 5)
    black = (hit.surf >= 0) & (scene.t_surfaces[
        torch.clamp(hit.surf, min=0)][:, 1] >= 1)
    pmt = torch.isfinite(hit.t) & ~black
    assert int(black.sum()) > 1000 and int(pmt.sum()) > 100
    on_sphere = {k: v[black] for k, v in sound.items()}
    first = {k: v[black] for k, v in start.items()}
    assert int(judge.single_leg_breaks(scene, first, on_sphere).sum()) == 0
    # the fault: on through the PMT to the sphere
    idx = torch.nonzero(pmt)[:, 0]
    pos, d, last = sound['pos'][idx], sound['dir'][idx], sound['last'][idx]
    run = hit.t[idx].clone()
    done = torch.zeros(len(idx), dtype=torch.bool)
    for _ in range(8):
        h = sc.query(scene, pos, d, excl=last)
        go = torch.isfinite(h.t) & ~done
        pos = torch.where(go[:, None], pos + h.t[:, None] * d, pos)
        run = run + torch.where(go, h.t, 0.0)
        last = torch.where(go, h.tri, last)
        done |= go & (h.surf >= 0) & (scene.t_surfaces[
            torch.clamp(h.surf, min=0)][:, 1] >= 1)
    water = float(scene.t_materials[0, 0])
    s1 = sound['t'][idx] * physics.SPEED_OF_LIGHT / water - hit.t[idx]
    bad = {k: v.clone() for k, v in sound.items()}
    bad['pos'][idx], bad['last'][idx] = pos, last
    bad['t'][idx] = (s1 + run) * water / physics.SPEED_OF_LIGHT
    lim = cell.limits('quick.bomb')
    moved = idx[done]
    faults, gap, _ = judge.path_checks(
        scene, {k: v[moved] for k, v in start.items()},
        {k: v[moved] for k, v in bad.items()})
    assert faults == 0 and gap < lim['end_gap_mm']
    breaks = judge.single_leg_breaks(scene, start, bad)
    assert int(breaks[moved].sum()) > 0.9 * len(moved)
    # the program's photons against the reference's, which end on the glass
    ended = black | pmt
    ref = {k: v[ended] for k, v in sound.items()}
    prog = {k: v[ended] for k, v in bad.items()}
    first = {k: v[ended] for k, v in start.items()}
    ref['leg'] = judge.single_leg_breaks(scene, first, ref)
    prog['leg'] = judge.single_leg_breaks(scene, first, prog)
    assert judge.tally_z(prog, ref) > lim['tally_z']
