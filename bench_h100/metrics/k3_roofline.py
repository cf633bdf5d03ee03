"""k3_roofline: share of K3's bound over K3's device time in the trace
(kernels whose names contain `wire_walk`), in percent. The bound is the
larger of its bytes and its operations on the work the window's photons
need, by the reference's counts (nothing K3 chooses: not its window, not
its lanes): a ray (24 B) and a mask byte read and a 16 B result written
each photon-step, at the card's bandwidth; 30 f32 operations a wire
within the slab chords of a step's ray over the whole ray, and 70 a
plane a photon-step to set up, at the card's f32 peak."""
from bench_h100.harness import roofline as rl

K3_KERNELS = ('wire_walk',)
K3_BYTES = 24 + 1 + 16
K3_WIRE_OPS = 30
K3_PLANE_OPS = 70
FP32_OPS_PER_S = 67e12    # NVIDIA H100 SXM, non-tensor f32


def bound_s(run):
    "K3's bound in seconds on the window's work (None without counts)."
    steps = rl.photon_steps(run)
    wires = (run.facts or {}).get('k3_wires_per_photon')
    if steps is None or wires is None:
        return None
    photons = sum(c['photons'] for c in run.calls)
    planes = len(run.ctx.cfg['planes'])
    ops = wires * photons * K3_WIRE_OPS + steps * planes * K3_PLANE_OPS
    return max(steps * K3_BYTES / rl.HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def read(run):
    if run.trace is None:
        return None
    bound = bound_s(run)
    seconds = run.trace.kernel_seconds(K3_KERNELS)
    if bound is None or seconds <= 0:
        return None
    return 100.0 * bound / seconds
