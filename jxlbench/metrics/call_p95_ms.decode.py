"""95th percentile of the harness's span around each ``decode_many``
call in the traced run (the entry layer's latency, profiler on)."""

from jxlbench import window as _w


def read(run):
    return _w.p95_ms([c.latency_s for c in run.calls])
