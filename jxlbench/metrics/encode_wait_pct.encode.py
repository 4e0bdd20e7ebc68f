"""Share of the traced window in which ``encode_lossless_many`` waited on
its splice threads (the program's ``encode.wait`` spans) after the last
device pass of a call."""

from jxlbench import spans as _s

_s.arm()    # the recorder on from set-up (jxlbench/spans.py)


def read(run):
    return _s.window_pct(run, "encode.wait")
