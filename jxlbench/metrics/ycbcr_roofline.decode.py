"""The chroma upsampling and YCbCr kernel's share of its roofline over the
traced window: each frame costs ``roofline/ycbcr.py`` at its shape (from
the set's manifest); the time is the device time of the kernels whose
name holds ``ycbcr`` (``ycbcr420_kernel``, ``csrc/ycbcr.cu``). A program
without the kernel reads nothing."""

from jxlbench import window as _w


def read(run):
    cost = run.roofline("ycbcr").cost
    return _w.roofline_pct(run, "ycbcr",
                           [cost(it["h"], it["w"]) for it in run.items])
