"""k2_roofline: share of K2's byte bound (a photon state read and written
and a hit read, each photon-step of the window) over the device time of
k2_pre and k2_post in the trace, in percent."""
from bench_h100.harness import roofline as rl


def read(run):
    return rl.share(run, rl.photon_steps(run), rl.K2_BYTES, rl.K2_KERNELS)
