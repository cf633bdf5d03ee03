"""daq_share: device time of the operations launched inside the
benchmark's bench.daq span (around the program's run_daq) over the
device's busy time, in percent."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    daq = run.trace.span_s.get("bench.daq")
    if not daq:
        return None
    return 100.0 * daq / run.trace.busy_s
