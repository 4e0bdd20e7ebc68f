"""Megapixels of every frame that came back as pixels, over the window
(host clock, first call's start to the end of the call that crossed the
window's length)."""

from jxlbench import window as _w


def read(run):
    return _w.rate_mp_s(run)
