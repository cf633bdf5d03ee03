"""k1_roofline.sim: share of K1's byte bound on the photon-steps of the
window (a ray read, a hit written each) over K1's device time in the
trace, in percent."""
from bench_h100.harness import roofline as rl


def read(run):
    return rl.share(run, rl.photon_steps(run), rl.K1_BYTES, rl.K1_KERNELS)
