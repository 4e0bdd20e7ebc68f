"""What the host pool adds to the longest task of a call: the median over
the traced window's calls of ``decode_many.host_wait`` less the longest
``host.task`` under it (handing out, pickling both ways, queueing)."""

import statistics

from jxlbench import spans as _s

_s.arm()    # the recorder on from set-up (jxlbench/spans.py)


def read(run):
    got = _s.collect(run)
    if got is None:
        return None
    window = got[1]
    longest: dict = {}
    for t in _s.named(window, "host.task"):
        longest[t.parent] = max(longest.get(t.parent, 0),
                                t.end_ns - t.start_ns)
    extra = [(w.end_ns - w.start_ns - longest[w.id]) / 1e6
             for w in _s.named(window, "decode_many.host_wait")
             if w.id in longest]
    return statistics.median(extra) if extra else None
