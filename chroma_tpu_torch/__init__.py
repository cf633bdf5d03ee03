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
(csrc/geometry_kit.cpp) built into build/ at first use. This package
imports neither jax nor chroma_tpu.
"""
from chroma_tpu_torch.sim import Simulation  # noqa: F401
from chroma_tpu_torch.likelihood import Likelihood  # noqa: F401
