"""k1_roofline.render: share of K1's byte bound on the ray layers the
window's frames need (a ray read, a hit written each; the reference's
count of layers a pixel) over K1's device time in the trace, in percent."""
from bench_h100.harness import roofline as rl


def read(run):
    return rl.share(run, rl.ray_layers(run), rl.K1_BYTES, rl.K1_KERNELS)
