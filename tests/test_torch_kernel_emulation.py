"""K2 (k2_pre, k2_post) and K3 built for the host and held to their twins.

csrc/step_kernel.cu and csrc/wire_walk.cu run only on the card, but
tools_torch/kernel_emulation.py compiles them for the host with g++
behind a CUDA shim in which a block's threads are real threads, with
__syncthreads(), the warp's shuffles and ballots and the shared-memory
atomics honoured. So the regrouping of k2_post (ballots, a block-wide
scan, shared memory between two phases) and K3's warp walk (shuffled
scans, 64-bit atomicMin) run here on CPU tensors, against:

  * step_prologue (k2_pre): flags and masks equal, limits to rtol 1e-5;
  * after_query_plain (k2_post) on demo.tiny(), the all-models box of
    tests/test_torch_cuda.py and three wire planes, at a width that is not
    a multiple of the block and at two block sizes, with a block that
    holds every boundary class: integer fields equal and floats to rtol
    1e-5 on all but 0.1% of the lanes (glibc's transcendentals are not
    libdevice's, nor torch's);
  * walk_plain (K3): equal bit for bit on three wire planes, and on rays
    0.5-3 m from three MicroBooNE-pitch planes (where the window is the
    slab chord and the origin lies far outside it); on rays that force
    ties (coinciding planes, rays through a wire's axis) walk_plain's
    planes;
  * chroma_tpu.ops.photon.propagate_step on demo.tiny(): a step of the
    host-built k2_pre, the plain walk and the host-built k2_post, with the
    JAX pool's blocks injected, agrees with the JAX step as
    tests/test_torch_step_kernel.py holds the twins.

Every test needs g++ and skips with a reason, decided inside the test,
where it is missing.
"""
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import jax

from chroma_tpu.ops import photon as jphoton
from chroma_tpu.ops import propagate as jprop
from chroma_tpu.ops import types as jtypes
from chroma_tpu.ops.sample import make_key
from chroma_tpu_torch.ops import (cuda_build, photon, step_kernel,
                                  visit_kernel, wire_kernel, wireplane)
from chroma_tpu_torch.ops import types as ttypes
from chroma_tpu_torch.ops.sample import DrawPool, make_generator

from test_torch_cuda import (_device_bomb, _optics_box, _tie_box, _wire_box,
                             tie_rays)
from test_torch_host import J, T
from test_torch_photon import jax_blocks, torch_state
from test_torch_surfaces import assert_lanes_agree
from wire_cases import far_rays, microboone_planes

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tools_torch'))
import kernel_emulation  # noqa: E402

torch.set_num_threads(2)

N = 3001        # lanes: a multiple of no block size


@pytest.fixture(scope='module')
def host():
    """The host builds of K2 and K3 in place of the card's for the
    module's tests (step_kernel's and wire_kernel's launches run them on
    CPU tensors)."""
    if shutil.which('g++') is None:
        pytest.skip('needs g++ to build the kernels for the host')
    with kernel_emulation.host_kernels():
        yield


@pytest.fixture(scope='module')
def geometries():
    tiny = T.demo.tiny()
    tiny.flatten()
    return {'tiny': ttypes.build_geometry_arrays(tiny),
            'all_models': ttypes.build_geometry_arrays(_optics_box()),
            'wires': ttypes.build_geometry_arrays(
                _wire_box((0.0, 60.0, -60.0)))}


def _state(ga, kind, n, seed, steps=1):
    """A bomb stepped `steps` times on the CPU (media known, so lanes
    prune); the wire bomb starts 40 mm below its planes."""
    state = _device_bomb(n, seed, 'cpu')
    if kind == 'wires':
        state = state.replace(pos=state.pos + torch.tensor([0.0, 0.0,
                                                            -40.0]))
    for s in range(steps):
        state = photon.propagate_step(state, ga, DrawPool(
            n, 'cpu', generator=make_generator('cpu', seed, s)))
    return state


def test_mask_bytes_views_and_rejects():
    """The wrappers' masks: a bool mask is viewed as its bytes (same
    storage, no copy), a u8 mask passes, anything else raises."""
    mask = torch.rand(64) > 0.5
    got = cuda_build.mask_bytes(mask, 64, mask.device)
    assert got.dtype == torch.uint8 and got.data_ptr() == mask.data_ptr()
    assert torch.equal(got.bool(), mask)
    u8 = mask.to(torch.uint8)
    assert cuda_build.mask_bytes(u8, 64, mask.device) is u8
    for bad in (mask.float(), mask[:32], torch.stack([mask, mask], 1)[:, 0]):
        with pytest.raises(ValueError):
            cuda_build.mask_bytes(bad, 64, mask.device)


def test_block_size_follows_width_and_models():
    """k2_post's block: 64 lanes below WIDE_FROM, then 128 on a geometry
    with one surface model and 256 with several; always a multiple of 32
    the kernel takes (at most 256)."""
    for n in (1, 2048, step_kernel.WIDE_FROM - 1):
        assert step_kernel.block_for(n, 5) == step_kernel.block_for(n) == 64
    for n in (step_kernel.WIDE_FROM, 1 << 20):
        assert step_kernel.block_for(n) == 128
        assert step_kernel.block_for(n, 2) == 256
    assert all(b % 32 == 0 and b <= 256 for b in (
        step_kernel.BLOCK_NARROW, step_kernel.BLOCK_WIDE,
        step_kernel.BLOCK_MODELS))


@pytest.mark.parametrize('kind,opts', [
    ('tiny', {}), ('all_models', {}), ('all_models', {'prune': False}),
    ('all_models', {'use_weights': True}), ('wires', {})])
def test_prologue_kernel_matches_plain(host, geometries, kind, opts):
    """k2_pre against step_prologue on lanes after a step, with NaN lanes
    and finished lanes among them: flags, active and pruned lanes equal;
    limits to rtol 1e-5 (glibc's logf against torch's log)."""
    ga = geometries[kind]
    state = _state(ga, kind, N, 21)
    pos, d = state.pos.clone(), state.dir.clone()
    pos[7::97, 1] = float('nan')
    d[11::101, 2] = float('nan')
    state = state.replace(pos=pos, dir=d)
    ref = photon.step_prologue(state, ga, DrawPool(
        N, 'cpu', generator=make_generator('cpu', 22)), **opts)
    prune = ref[3] is not None
    assert prune == (not opts)
    before = cuda_build.launches['k2_pre']
    got = step_kernel.launch_pre(state, ga, ref[2], prune)
    assert cuda_build.launches['k2_pre'] == before + 1
    assert torch.equal(got[0].flags, ref[0].flags)
    assert torch.equal(got[1], ref[1]) and got[1].dtype == torch.bool
    assert int((ref[0].flags & photon.i32(T.event.NAN_ABORT) != 0).sum()) > 0
    if prune:
        assert torch.equal(got[3], ref[3]) and int(ref[3].sum()) > 0
        torch.testing.assert_close(got[4], ref[4], rtol=1e-5, atol=0.0)
    else:
        assert got[3] is None and got[4] is None


def boundary_classes(ph, ga, blocks, active, pruned, query, wires):
    """Each lane's class in k2_post's phase B, from the plain functions:
    its surface model, 5 for Fresnel alone (no surface), -1 for a lane
    whose step ends before the boundary (every model present)."""
    pool = DrawPool.over(blocks)
    u_abs, u_scat = pool.draw(), pool.draw()
    mats = ga.materials
    mrows = photon.wavelength_lerp_rows(mats.props_wl, ph.wavelength,
                                        mats.wavelength0,
                                        mats.wavelength_step)
    pre = None if pruned is None else photon.medium_props(mrows,
                                                           ph.cur_mat)
    wp = None if wires is None else wireplane.classify(wires, ph.dir,
                                                       ga.wireplanes)
    ph, state = photon.decode_state(ph, ga, active, pruned, pre, mrows,
                                    query, wp)
    _, cmd = photon.propagate_to_boundary(ph, state, pool, u_abs, u_scat,
                                          mats)
    at = active & state.hit & (cmd == photon.PASS)
    model = ga.surfaces.model[torch.clamp(state.surface, min=0).long()]
    cls = torch.where(state.surface == -1, 5, model)
    return torch.where(at, cls, -1)


@pytest.mark.parametrize('block', [64, 256])
@pytest.mark.parametrize('kind', ['tiny', 'all_models', 'wires'])
def test_post_kernel_matches_plain(host, geometries, kind, block):
    """k2_post against after_query_plain on the inputs of a step (the
    prologue, the plain walk, the plain wire walk): integer fields equal
    and floats to rtol 1e-5 on all but 0.1% of the lanes. On the
    all-models box one block holds every class of phase B."""
    ga = geometries[kind]
    state = _state(ga, kind, N, 23)
    ph, active, blocks, pruned, limit = photon.step_prologue(
        state, ga, DrawPool(N, 'cpu', generator=make_generator('cpu', 24)))
    query = visit_kernel.traverse(ga.wide, ph.pos, ph.dir,
                                  ph.last_hit_triangle, mask=active,
                                  best_limit=limit)[:5]
    wires = wireplane.walk_plain(ph.pos, ph.dir, ga, active) \
        if ga.has_wireplanes else None
    args = (ph, ga, blocks, active, pruned, query, wires)
    ref = step_kernel.after_query_plain(*args)
    before = cuda_build.launches['k2_post']
    got = step_kernel.launch(*args, block=block)
    assert cuda_build.launches['k2_post'] == before + 1
    bad = kernel_emulation.differing(got, ref)
    print(kind, block, 'lanes differing from the twin:', bad)
    assert bad <= 0.001 * N
    cls = boundary_classes(*args)
    assert int((cls >= 0).sum()) > 0
    if kind == 'all_models':
        per_block = [set(cls[b:b + block].tolist()) - {-1}
                     for b in range(0, N, block)]
        assert max(map(len, per_block)) == 6, per_block


@pytest.mark.parametrize('kind', ['wires', 'far', 'ties'])
def test_wire_kernel_matches_plain(host, geometries, kind):
    """K3's warp walk against walk_plain. Three U/V/Y planes, rays 40 mm
    below them, and three MicroBooNE-pitch planes 2 m square, rays 0.5 m
    to 3 m from them: equal bit for bit. Rays that force ties (two coinciding
    planes, rays through a wire's axis, rays from inside a wire): planes
    equal to walk_plain's and floats to rtol 1e-6 -- torch's CPU sqrt is not
    correctly rounded (an ulp off on a few of these rays), glibc's and the
    card's are."""
    if kind == 'wires':
        ga = geometries['wires']
        state = _state(ga, kind, N, 25, steps=0)
        pos, d = state.pos, state.dir
        active = torch.rand(N, generator=torch.Generator().manual_seed(26)) \
            > 0.1
    elif kind == 'far':
        ga = ttypes.build_geometry_arrays(microboone_planes())
        pos, d = (torch.from_numpy(x) for x in far_rays(N, seed=30))
        active = torch.rand(N, generator=torch.Generator().manual_seed(31)) \
            > 0.1
    else:
        ga = ttypes.build_geometry_arrays(_tie_box())
        pos, d, active = (torch.from_numpy(x) for x in tie_rays(N, 27))
    table = wire_kernel.planes(ga)
    before = cuda_build.launches['k3']
    got = wire_kernel.launch(pos, d, table, active)
    assert cuda_build.launches['k3'] == before + 1
    ref = wireplane.walk_plain(pos, d, ga, active)
    assert torch.equal(got[1], ref[1]) and int((ref[1] >= 0).sum()) > 50
    for a, b in zip(got[::2] + got[3:], ref[::2] + ref[3:]):
        if kind != 'ties':
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0.0)
    if kind == 'ties':
        assert int((ref[1] == 1).sum()) == 0 and int((ref[1] == 0).sum()) \
            > 100


def test_recording_diverts_launches(host, geometries):
    """The seam's launch count (ops.cuda_build): a launch counts once under
    its kernel's name in cuda_build.launches, a launch inside recording()
    only in the Counter it yields, and a step on CPU tensors (the plain
    twins) launches nothing."""
    ga = geometries['wires']
    state = _state(ga, 'wires', N, 28, steps=0)
    args = (state.pos, state.dir, wire_kernel.planes(ga), None)
    before = cuda_build.launches.copy()
    photon.propagate_step(state, ga, DrawPool(
        N, 'cpu', generator=make_generator('cpu', 29)))
    assert cuda_build.launches == before
    with cuda_build.recording() as recorded:
        wire_kernel.launch(*args)
        wire_kernel.launch(*args)
        step_kernel.launch_pre(state, ga, torch.rand(
            step_kernel.n_blocks(ga) * step_kernel.BLOCK, N), True)
    assert recorded == {'k3': 2, 'k2_pre': 1}
    assert cuda_build.launches == before
    wire_kernel.launch(*args)
    assert cuda_build.launches - before == {'k3': 1}


def test_emulated_step_matches_jax(host):
    """On demo.tiny(), with the JAX pool's blocks injected, steps of the
    host-built k2_pre, the plain walk and the host-built k2_post agree
    with chroma_tpu.ops.photon.propagate_step on at least 99.9% of the
    lanes (integer fields equal, floats to rtol 1e-5), as
    tests/test_torch_step_kernel.py holds the plain twins."""
    n = 2048
    geo_j, geo_t = J.demo.tiny(), T.demo.tiny()
    geo_j.flatten()
    geo_t.flatten()
    ga = jtypes.build_geometry_arrays(geo_j)
    ta = ttypes.build_geometry_arrays(geo_t)
    np.random.seed(11)
    js = jprop.photon_state_from_host(J.photon_bomb(n, 400.0, (0, 0, 0)))
    step = jax.jit(jphoton.propagate_step)
    key = make_key(6)
    before = cuda_build.launches.copy()
    for s in range(3):
        step_key = jax.random.fold_in(key, s)
        ts = torch_state(js)
        pool = DrawPool(n, 'cpu', blocks=jax_blocks(step_key, n))
        blocks = pool.stacked(step_kernel.n_draws(ta))
        ph, active, blocks, pruned, limit = step_kernel.launch_pre(
            ts, ta, blocks, photon.PRUNE_TRAVERSAL)
        query = visit_kernel.traverse(ta.wide, ph.pos, ph.dir,
                                      ph.last_hit_triangle, mask=active,
                                      best_limit=limit)[:5]
        mine = step_kernel.launch(ph, ta, blocks, active, pruned, query,
                                  None)
        js = step(js, ga, step_key)
        agree = assert_lanes_agree(js, mine)
        print('step', s, 'lanes differing from JAX:', int((~agree).sum()))
    assert cuda_build.launches - before == {'k2_pre': 3, 'k2_post': 3}
