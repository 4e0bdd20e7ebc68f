"""Bytes and operations one frame of the chroma upsampling and YCbCr
kernel needs (``csrc/ycbcr.cu`` ``ycbcr420_kernel``): the float32 Y plane
read once, the two float32 chroma planes at 4:2:0 (ceil(h / 2) x
ceil(w / 2) each) read once, and 3 bytes a pixel written; operations a
pixel as the kernel counts them: 2 x 3 for each chroma sample's two taps
(horizontal and vertical, shared over none), 9 for YCbCr to RGB with the
luma offset and 3 for the scale to 255 (the rounding and clamping not
counted). At 4032x3024: 109.7 MB, 32.7 us at 3.35 TB/s."""

FLOPS_PER_PX = 2 * 2 * 3 + 9 + 3


def cost(h: int, w: int) -> tuple[int, int]:
    px = h * w
    chroma = (-(-h // 2)) * (-(-w // 2))
    return 4 * px + 2 * 4 * chroma + 3 * px, FLOPS_PER_PX * px
