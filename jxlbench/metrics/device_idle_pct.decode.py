"""Share of the traced window in which no kernel, copy or set ran on
the card."""

from jxlbench import window as _w


def read(run):
    return _w.idle_pct(run)
