"""Bytes and operations one EPF pass needs (``csrc/filters.cu``
``epf_plus_kernel<0|1>``, ``epf2_kernel``): three float32 planes read
once and written once, plus the float32 inverse-sigma field of the 8x8
blocks, read once; operations a pixel per pass as counted for the
kernels' weights and sums (pass 0: 305, pass 1: 105, pass 2: 89). At
3840x2160: 199.6 MB."""

FLOPS_PER_PX = {0: 305, 1: 105, 2: 89}


def cost(h: int, w: int, pass_id: int) -> tuple[int, int]:
    px = h * w
    sigma = 4 * (-(-h // 8)) * (-(-w // 8))
    return 3 * 4 * px * 2 + sigma, FLOPS_PER_PX[pass_id] * px
