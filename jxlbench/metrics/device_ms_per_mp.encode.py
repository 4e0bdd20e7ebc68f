"""Device busy time (the union of the card's kernel, copy and set
intervals in the traced window, ``torch.profiler``) per megapixel."""

from jxlbench import window as _w


def read(run):
    return _w.device_ms_per_mp(run)
