"""CUDA kernels of the torch port against their plain PyTorch versions.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one:
a CUDA kernel has no CPU mode. The file imports no JAX, so it runs on a
machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from chroma_tpu.geometry import Geometry, Solid
from chroma_tpu.demo.optics import water, glass
from chroma_tpu.make import box, sphere
from chroma_tpu_torch.bvh.wide import build_instanced_bvh
from chroma_tpu_torch.ops import mesh_wide, visit_kernel
from chroma_tpu_torch.ops.types import pack_material_codes

torch.set_num_threads(2)

FORMATS = {'f32': (0, 'f32'), 'bf16': (32, 'bf16'), 'q8': (32, 'q8')}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


def _table(fmt):
    "The tests/test_visit_kernel.py fixture geometry, as a port table."
    geo = Geometry(water)
    geo.add_solid(Solid(box(100.0, 80.0, 60.0), glass, water))
    geo.add_solid(Solid(sphere(30.0, nsteps=24), glass, water),
                  displacement=(120.0, 0.0, 0.0))
    geo.add_solid(Solid(box(40.0, 40.0, 40.0), glass, water),
                  displacement=(-120.0, 30.0, 0.0))
    geo.flatten()
    codes = pack_material_codes(geo.material1_index, geo.material2_index,
                                geo.surface_index)
    tri_base = np.cumsum([0] + [len(s.mesh.triangles) for s in geo.solids])
    instances = [(s.mesh, geo.solid_rotations[i], geo.solid_displacements[i],
                  int(tri_base[i])) for i, s in enumerate(geo.solids)]
    pf, bf = FORMATS[fmt]
    return build_instanced_bvh(instances, material_codes=codes,
                               packed_fanout=pf, bounds_fmt=bf)


@pytest.mark.cuda
@pytest.mark.parametrize('fmt', ['f32', 'bf16', 'q8'])
def test_visit_kernel_matches_plain(cuda, fmt):
    tw = _table(fmt).to(cuda)
    n = 8192
    rs = np.random.RandomState(7)
    o = rs.uniform(-200, 200, (n, 3)).astype(np.float32)
    d = (rs.uniform((-150, -50, -40), (150, 50, 40), (n, 3)) - o)
    d[:16, 1:] = 0.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    mask = rs.uniform(size=n) >= 0.1
    limit = np.where(rs.uniform(size=n) < 0.25, rs.uniform(10, 300, n),
                     np.inf).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda) for x in (o, d)]
    first = mesh_wide.traverse(tw, *args)[0]
    last = torch.where(torch.from_numpy(rs.uniform(size=n) < 0.5).to(cuda),
                       first, -1).to(torch.int32)
    extra = (last, torch.from_numpy(mask).to(cuda),
             torch.from_numpy(limit).to(cuda))

    ref = [x.cpu().numpy() for x in mesh_wide.traverse(tw, *args, *extra)]
    before = visit_kernel.launches
    got = [x.cpu().numpy()
           for x in visit_kernel.traverse(tw, *args, *extra)]
    torch.cuda.synchronize()
    assert visit_kernel.launches == before + 1

    tri, dist, code, normal, iid, visits = ref
    assert (tri >= 0).sum() > n // 4
    for name, a, b in (('tri', got[0], tri), ('code', got[2], code),
                       ('iid', got[4], iid), ('visits', got[5], visits)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    hit = tri >= 0
    np.testing.assert_array_equal(got[1][~hit], dist[~hit])
    np.testing.assert_allclose(got[1][hit], dist[hit], rtol=1e-5)
    np.testing.assert_allclose(got[3][hit], normal[hit], rtol=1e-5,
                               atol=1e-5 * np.abs(normal[hit]).max())


@pytest.mark.cuda
def test_visit_kernel_rejects_bad_input(cuda):
    tw = _table('bf16').to(cuda)
    o = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError):
        visit_kernel.traverse(tw, o, o.double())
