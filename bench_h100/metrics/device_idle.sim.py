"""device_idle.sim: the share of the traced window in which no kernel,
copy or memset ran on the card, in percent."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
