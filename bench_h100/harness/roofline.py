"""Peaks of the card and the bytes a photon-step needs at each kernel's
interface, whatever implements it.

A photon-step is one interaction of one live photon (a boundary reached,
a scatter, an absorption): the reference counts the steps each photon of
a sample takes to terminate, and the window's photons times that mean is
the work the cell's inputs fix. Each byte a step needs is read once or
written once: the photon's state (position, direction, polarisation as
3 f32 each; wavelength, time, weight as f32; history flags and last
triangle as i32), the ray (origin, direction) and the hit record
(triangle id i32, distance f32).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # NVIDIA H100 SXM 80 GB, at a 700 W limit
PHOTON_STATE_BYTES = 3 * 12 + 3 * 4 + 2 * 4
RAY_BYTES = 2 * 12
HIT_BYTES = 4 + 4

K1_BYTES = RAY_BYTES + HIT_BYTES                        # traversal
K2_BYTES = 2 * PHOTON_STATE_BYTES + HIT_BYTES           # step around it

K1_KERNELS = ('visit_warp_kernel', 'visit_thread_kernel')
K2_KERNELS = ('pre_kernel', 'step_kernel', 'step_thread_kernel')


def photon_steps(run):
    """The photon-steps the window's photons need, by the reference's
    count (None without one)."""
    facts = run.facts or {}
    per = facts.get('steps_per_photon')
    if not per:
        return None
    return per * sum(c['photons'] for c in run.calls)


def share(run, work, bytes_per_item, kernels):
    """Percent of the byte bound: `work` items (photon-steps, ray layers)
    x bytes / peak bandwidth over the kernels' device seconds in the
    trace (None without the work or without those kernels)."""
    if run.trace is None or work is None:
        return None
    seconds = run.trace.kernel_seconds(kernels)
    if seconds <= 0:
        return None
    return 100.0 * work * bytes_per_item / HBM_BYTES_PER_S / seconds


def ray_layers(run):
    """The traversal queries the window's frames need: each pixel's
    layers until its ray leaves the scene or the depth is reached, by
    the reference's count on a sample of pixels (None without one)."""
    facts = run.facts or {}
    per = facts.get('queries_per_pixel')
    if not per:
        return None
    return per * sum(c['pixels'] for c in run.calls)

