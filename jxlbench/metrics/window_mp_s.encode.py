"""Megapixels of every image whose stream came back, over the traced
window (host clock, first call's start to the end of the call that
crossed the window's length): the encode rate, read per layer."""

from jxlbench import window as _w


def read(run):
    return _w.rate_mp_s(run)
