"""graph_captures: CUDA graphs the driver captured in the window (the
program's counter graphs.captures) per 100 calls."""


def read(run):
    captures = (run.counters or {}).get("graphs.captures")
    if captures is None or not run.calls:
        return None
    return 100.0 * captures / len(run.calls)
