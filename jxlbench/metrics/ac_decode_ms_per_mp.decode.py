"""The native AC decode's time in the pool's workers (the program's
``host.ac_decode`` spans), summed over the workers, per megapixel
decoded in the traced window."""

from jxlbench import spans as _s

_s.arm()    # the recorder on from set-up (jxlbench/spans.py)


def read(run):
    return _s.ms_per_mp(run, "host.ac_decode")
