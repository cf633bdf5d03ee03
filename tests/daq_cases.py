"""The DAQ readout's test cases, shared by the card tests of K4
(tests/test_torch_cuda.py) and its host-built and plain-twin tests
(tests/test_torch_daq.py). Imports neither JAX nor chroma_tpu."""
import dataclasses
import os

import numpy as np
import torch

from chroma_tpu_torch import demo, event
from chroma_tpu_torch.ops.photon import PhotonState
from chroma_tpu_torch.ops.types import build_geometry_arrays


# K4's cases, on the card and host-built: the replicas, global_weight,
# detection_state, photons, and the geometry (instanced, per-triangle
# solid ids, CDF tables too wide to stage)
DAQ_CASES = {
    'ndaq1': dict(ndaq=1),
    'ndaq8': dict(ndaq=8),
    'ndaq50': dict(ndaq=50),
    'weight0.7': dict(ndaq=9, global_weight=0.7),
    'absorb': dict(ndaq=3, detection_state=event.SURFACE_ABSORB),
    'few-photons': dict(ndaq=8, n=200),
    'per-triangle-solids': dict(ndaq=8, geometry='flat'),
    'wide-tables': dict(ndaq=8, geometry='wide-tables'),
}


def daq_geometries():
    """demo.tiny() as the DAQ tests read it: instanced, flat (a solid id a
    triangle) and instanced with 8,001-point time and charge CDFs, more
    than K4 stages in shared memory; 'ntri' its triangle count."""
    geo = demo.tiny()
    geo.flatten()
    inst = build_geometry_arrays(geo)
    os.environ['CHROMA_NO_INSTANCING'] = '1'
    try:
        flat = build_geometry_arrays(geo)
    finally:
        del os.environ['CHROMA_NO_INSTANCING']
    assert inst.inst is not None and flat.inst is None
    x = np.linspace(-6.0, 6.0, 8001)
    cdf = np.concatenate([[0.0], np.cumsum(np.exp(-0.5 * (x[1:] / 1.2)
                                                  ** 2))])
    x, cdf = (torch.from_numpy(a.astype(np.float32))
              for a in (x, cdf / cdf[-1]))
    wide = dataclasses.replace(inst, detector=dataclasses.replace(
        inst.detector, time_cdf_x=x, time_cdf_y=cdf,
        charge_cdf_x=x + 7.0, charge_cdf_y=cdf))
    return {'inst': inst, 'flat': flat, 'wide-tables': wide,
            'ntri': len(geo.mesh.triangles)}


def daq_photons(ntri, n, seed, device):
    """n end states on demo.tiny()'s `ntri` triangles for the DAQ: a tenth
    on no triangle and some on a wire (-2), flags with SURFACE_DETECT,
    SURFACE_ABSORB and bit 31 among others, weights 0.5 or 1, times from
    -3 to 60 ns so that the earliest times cross zero."""
    rs = np.random.RandomState(seed)
    tri = np.where(rs.uniform(size=n) < 0.1, -1, rs.randint(0, ntri, n))
    tri[::11] = -2
    flags = rs.choice([0, 2, 4, 4 | 16, 4 | 32, 8, 8 | 32, 4 | (1 << 31)],
                      n).astype(np.uint32).view(np.int32)
    z = torch.zeros((n, 3), device=device)
    return PhotonState(
        pos=z, dir=z, pol=z, wavelength=torch.full((n,), 400.0,
                                                   device=device),
        t=torch.from_numpy(rs.uniform(-3.0, 60.0, n).astype(np.float32))
        .to(device),
        weight=torch.from_numpy(np.where(rs.uniform(size=n) < 0.2, 0.5, 1.0)
                                .astype(np.float32)).to(device),
        flags=torch.from_numpy(flags).to(device),
        last_hit_triangle=torch.from_numpy(tri.astype(np.int32)).to(device),
        evidx=torch.zeros(n, dtype=torch.int32, device=device),
        cur_mat=torch.zeros(n, dtype=torch.int32, device=device))


def daq_uniforms(block, site, shape):
    "Injected U[0, 1) draws of a block and site, the same every call."
    rs = np.random.RandomState(3 * block + site)
    return rs.uniform(size=shape).astype(np.float32)


def daq_case(geometries, name, device):
    """(photons, geometry, run_daq's keywords with injected uniforms) of
    the DAQ_CASES entry `name`, on `device`."""
    case = dict(DAQ_CASES[name])
    ga = geometries[case.pop('geometry', 'inst')].to(device)
    photons = daq_photons(geometries['ntri'], case.pop('n', 3001), 17,
                          device)
    return photons, ga, dict(case, uniforms=daq_uniforms)


def channel_arrays_equal(got, ref):
    "Earliest times, charges and histories equal bit for bit."
    for name in ('earliest_time', 'charge', 'histories'):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
