"""event_p95_ms: 95th percentile (nearest rank) over every call of the
window of one event's wall, from its submission to its results on the
host (host clock)."""
from bench_h100.harness.traffic import p95


def read(run):
    return 1e3 * p95([c["latency_s"] for c in run.calls])
