"""Seconds from the host pool's spawn to its last worker's imports, in
set-up: the first ``host_pool.spawn`` span's start to the last
``host.import`` span's end."""

from jxlbench import spans as _s

_s.arm()    # the recorder on from set-up (jxlbench/spans.py)


def read(run):
    got = _s.collect(run)
    if got is None:
        return None
    spawn = _s.named(got[0], "host_pool.spawn")
    imports = _s.named(got[0], "host.import")
    if not spawn or not imports:
        return None
    return (max(s.end_ns for s in imports) -
            min(s.start_ns for s in spawn)) / 1e9
