"""The Gaborish kernel's share of its roofline over the traced window:
each frame with Gaborish on costs ``roofline/gaborish.py`` at its shape
(from the corpus manifest); the time is the device time of the kernels
named ``gab_kernel``."""

from jxlbench import window as _w


def read(run):
    cost = run.roofline("gaborish").cost
    costs = [cost(it["h"], it["w"]) for it in run.items if it["gab"]]
    return _w.roofline_pct(run, "gab_kernel", costs)
