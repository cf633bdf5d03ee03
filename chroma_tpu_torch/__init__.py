"""chroma_tpu_torch: the PyTorch / CUDA port of chroma_tpu.

The photon-bomb Simulation path (instanced wide-BVH traversal, default
surface optics, flat hits and DAQ) on torch tensors, with the traversal as
a hand-written CUDA kernel for Hopper (csrc/visit_kernel.cu) and a plain
PyTorch version of it for the CPU. Host geometry, meshes, detectors and
event containers come from the jax-free modules of chroma_tpu. This
package never imports jax.
"""
from chroma_tpu_torch.sim import Simulation  # noqa: F401
