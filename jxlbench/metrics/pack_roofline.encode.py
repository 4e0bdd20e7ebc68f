"""The pack kernel's share of its roofline over the traced window: each
image's launch costs ``roofline/pack.py``, with its residuals read once
(every position of its padded groups) and its words counted at the bits
its stream carries; the time is the device time of
``pack_chunks_kernel``."""

from jxlbench import window as _w


def read(run):
    cost = run.roofline("pack").cost
    costs = [cost(it["h"], it["w"], it["c"], it["bytes"])
             for it in run.items]
    return _w.roofline_pct(run, "pack_chunks_kernel", costs)
