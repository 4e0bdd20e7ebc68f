"""The EPF kernels' share of their roofline over the traced window: each
frame costs ``roofline/epf.py`` for every pass its header asks for (1:
pass 1; 2: passes 1 and 2; 3: passes 0, 1 and 2), at its shape from the
corpus manifest; the time is the device time of the kernels whose name
holds ``epf`` (``epf_plus_kernel<0|1>``, ``epf2_kernel``)."""

from jxlbench import window as _w

PASSES = {0: (), 1: (1,), 2: (1, 2), 3: (0, 1, 2)}


def read(run):
    cost = run.roofline("epf").cost
    costs = [cost(it["h"], it["w"], p) for it in run.items
             for p in PASSES[it["epf_iters"]]]
    return _w.roofline_pct(run, "epf", costs)
