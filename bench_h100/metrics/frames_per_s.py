"""frames_per_s: frames delivered to the host in the window over the
window's wall (host clock, every frame, all of the window)."""


def read(run):
    return sum(c["frames"] for c in run.calls) / run.window_s
