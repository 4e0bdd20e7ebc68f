"""Bytes and operations one Gaborish pass needs (``csrc/filters.cu``
``gab_kernel``): three float32 planes read once and written once, and a
3x3 weighted sum a sample (9 multiplies, 8 adds; 33 a pixel over the
three planes). At 3840x2160: 199.1 MB."""


def cost(h: int, w: int) -> tuple[int, int]:
    px = h * w
    return 3 * 4 * px * 2, 33 * px
