"""chroma_tpu_torch: the PyTorch / CUDA port of chroma_tpu.

The Simulation path (instanced wide-BVH traversal, every surface model,
bulk reemission, wire planes, flat hits and DAQ) and the hybrid-MC
PDF / likelihood path on torch tensors, with the traversal as a
hand-written CUDA kernel for Hopper (csrc/visit_kernel.cu) and a plain
PyTorch version of it for the CPU. The host side -- geometry, meshes,
detectors, PMT builders, the demo detector and its data, event containers,
generators and the likelihood facade -- is the port's own copy of
chroma_tpu's host modules, at the same module paths (chroma_tpu_torch.event
for chroma_tpu.event, ...), with the native geometry kit
(csrc/geometry_kit.cpp) built into build/ at first use. The user entry
points are the port's too: the geometry loader and its caches (loader,
cache, stl, the classic BVH in bvh/), event files and the device-ready
geocache (io/), the chroma.gpu-style facade (gpu), the profiler, the
ZeroMQ services (server/) and the command-line tools (cli/). This package
imports neither jax nor chroma_tpu.
"""

__version__ = '0.1.0'

from chroma_tpu_torch import event  # noqa: F401
from chroma_tpu_torch.event import (Photons, Vertex, Event,  # noqa: F401
                                    Channels)
from chroma_tpu_torch.geometry import (  # noqa: F401
    Mesh, Solid, Material, Surface, Geometry, DichroicProps, AngularProps,
    WirePlane, vacuum, standard_wavelengths)
from chroma_tpu_torch.detector import Detector  # noqa: F401
from chroma_tpu_torch import make  # noqa: F401
from chroma_tpu_torch.stl import mesh_from_stl  # noqa: F401
from chroma_tpu_torch.loader import (  # noqa: F401
    load_geometry_from_string, create_geometry_from_obj, load_bvh)
from chroma_tpu_torch.cache import Cache  # noqa: F401
from chroma_tpu_torch.log import logger  # noqa: F401


def __getattr__(name):
    # the device side loads on first use, so that host-only use (geometry
    # building, caches, cli.geo, cli.bvh) starts no device library
    if name == 'Simulation':
        from chroma_tpu_torch.sim import Simulation
        return Simulation
    if name == 'Likelihood':
        from chroma_tpu_torch.likelihood import Likelihood
        return Likelihood
    raise AttributeError('module %r has no attribute %r' % (__name__, name))
