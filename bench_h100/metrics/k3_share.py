"""k3_share: K3's device time (kernels whose names contain `wire_walk`)
over the device's busy time in the trace, in percent."""

K3_KERNELS = ('wire_walk',)


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    seconds = run.trace.kernel_seconds(K3_KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * seconds / run.trace.busy_s
