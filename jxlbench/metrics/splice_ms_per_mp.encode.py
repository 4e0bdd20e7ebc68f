"""The lossless encode's host splice (the program's ``encode.splice``
spans, on its splice threads), summed, per megapixel encoded in the
traced window."""

from jxlbench import spans as _s

_s.arm()    # the recorder on from set-up (jxlbench/spans.py)


def read(run):
    return _s.ms_per_mp(run, "encode.splice")
