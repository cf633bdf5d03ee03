"""K3's plain twin and what K3 is given, on the CPU.

K3 (chroma_tpu_torch/csrc/wire_walk.cu) runs only on the card; here its
plain twin wireplane.walk_plain is held against the JAX package's wire
walk: per lane the nearest plane and, on it, the nearest wire's distance
and transverse coordinates, as chroma_tpu.ops.wireplane's per-plane
while_loop (_intersect_one_plane, compiled) gives them and
intersect_wireplanes reduces them over the planes (the plane index
exactly, the floats to rtol 1e-5). The plane table K3 reads holds the
planes' fields in its documented columns, `walk` dispatches to the plain
twin on the CPU without counting a launch, and intersect_wireplanes is
the classification of the walk."""
import numpy as np
import pytest
import torch
import jax

from chroma_tpu.ops import types as jtypes
from chroma_tpu.ops import wireplane as jwire
from chroma_tpu_torch.ops import types as ttypes
from chroma_tpu_torch.ops import wire_kernel, wireplane

from test_torch_host import J, T, same_native_kit  # noqa: F401
from test_torch_wireplane import _rays, lartpc

torch.set_num_threads(2)


@pytest.fixture(scope='module', params=['single', 'uvy'])
def planes(request):
    "The planes as each package builds them: (JAX, port arrays)."
    angles = (0.0,) if request.param == 'single' else (0.0, 60.0, -60.0)
    return (jtypes.build_geometry_arrays(lartpc(J, angles)),
            ttypes.build_geometry_arrays(lartpc(T, angles)))


def _jax_walk(ga, pos, d, active):
    "JAX's per-plane walks reduced over the planes as intersect_wireplanes."
    wp = ga.wireplanes
    n = len(pos)
    best_t = np.full(n, np.inf, np.float32)
    best_plane = np.full(n, -1, np.int32)
    best_vn = np.zeros(n, np.float32)
    best_nn = np.zeros(n, np.float32)
    for ip in range(wp.pitch.shape[0]):
        t, vn, nn = (np.asarray(x) for x in jax.jit(
            lambda p, q, a, ip=ip: jwire._intersect_one_plane(
                p, q, wp, ip, a))(pos, d, active))
        closer = t < best_t
        best_t = np.where(closer, t, best_t)
        best_plane = np.where(closer, ip, best_plane)
        best_vn = np.where(closer, vn, best_vn)
        best_nn = np.where(closer, nn, best_nn)
    return best_t, best_plane, best_vn, best_nn


@pytest.mark.parametrize('kind', ['oblique', 'isotropic'])
def test_walk_plain_matches_jax(planes, kind):
    ga, ta = planes
    pos, d = _rays(kind)
    active = np.ones(len(pos), bool)
    active[::11] = False
    want = _jax_walk(ga, pos, d, active)
    got = [x.numpy() for x in wireplane.walk_plain(
        torch.from_numpy(pos), torch.from_numpy(d), ta,
        torch.from_numpy(active))]
    assert got[1].dtype == np.int32
    np.testing.assert_array_equal(got[1], want[1])
    hit = want[1] >= 0
    assert hit.sum() > 0 and not hit[~active].any()
    assert np.isinf(got[0][~hit]).all()
    for name, a, b in zip(('t', 'vn', 'nn'), (got[0], got[2], got[3]),
                          (want[0], want[2], want[3])):
        np.testing.assert_allclose(a[hit], b[hit], rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_plane_table_holds_the_planes(planes):
    """K3's plane table: origin, u, v, w, pitch, radius, umin, umax, vmin,
    vmax, v0 in that column order, one row a plane."""
    _, ta = planes
    wp = ta.wireplanes
    table = wire_kernel.planes(ta)
    assert table is wire_kernel.planes(ta)       # packed once
    assert table.shape == (wp.pitch.shape[0], wire_kernel.PLANE_WORDS)
    cols = [wp.origin, wp.u, wp.v, wp.w] + [
        getattr(wp, f)[:, None] for f in ('pitch', 'radius', 'umin', 'umax',
                                          'vmin', 'vmax', 'v0')]
    assert torch.equal(table, torch.cat(cols, dim=1))


def test_walk_on_the_cpu_is_the_plain_twin(planes):
    """`walk` on CPU tensors runs walk_plain and launches nothing, and
    intersect_wireplanes classifies the walk."""
    _, ta = planes
    pos, d = (torch.from_numpy(x) for x in _rays('isotropic', 1024))
    active = torch.ones(1024, dtype=torch.bool)
    before = wire_kernel.launches
    got = wire_kernel.walk(pos, d, ta, active)
    want = wireplane.walk_plain(pos, d, ta, active)
    assert wire_kernel.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    hit = wireplane.intersect_wireplanes(pos, d, ta, active)
    ref = wireplane.classify(want, d, ta.wireplanes)
    for name in ('hit', 'distance', 'normal', 'material1', 'material2',
                 'surface', 'inside_to_outside'):
        assert torch.equal(getattr(hit, name), getattr(ref, name)), name
    with pytest.raises(ValueError):
        wire_kernel.launch(pos[:, :2].contiguous(), d, wire_kernel.planes(ta),
                           active)
