"""lane_efficiency: the photon-steps the window's photons need (the
reference's count) over the lane-steps the driver launched (the program's
counter propagate.lane_steps: steps x launched width), in percent."""
from bench_h100.harness.roofline import photon_steps


def read(run):
    lanes = (run.counters or {}).get("propagate.lane_steps")
    steps = photon_steps(run)
    if not lanes or steps is None:
        return None
    return 100.0 * steps / lanes
