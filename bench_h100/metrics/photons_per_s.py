"""photons_per_s: photons propagated to termination in the window over
the window's wall (host clock, all calls, all of the window)."""


def read(run):
    return sum(c["photons"] for c in run.calls) / run.window_s
