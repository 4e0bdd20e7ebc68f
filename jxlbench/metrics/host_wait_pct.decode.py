"""Share of the traced window in which ``decode_many`` waited on its host
pool (the program's ``decode_many.host_wait`` spans: from handing the
streams to the pool to its last result)."""

from jxlbench import spans as _s

_s.arm()    # the recorder on from set-up (jxlbench/spans.py)


def read(run):
    return _s.window_pct(run, "decode_many.host_wait")
