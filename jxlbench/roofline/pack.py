"""Bytes one pack launch needs for one image (``csrc/pack_kernel.cu``
``pack_chunks_kernel``): every int32 residual of the image's padded
256x256 groups read once (chunks of 128), the words written at the bits
the stream carries (its bytes, which also hold the few header bytes),
and one int32 bit count a chunk. Integer work only: no float bound."""

GROUP = 256
CHUNK = 128


def cost(h: int, w: int, channels: int, stream_bytes: int) -> tuple[int, int]:
    groups = (-(-h // GROUP)) * (-(-w // GROUP))
    tokens = groups * channels * GROUP * GROUP
    chunks = tokens // CHUNK
    return 4 * tokens + stream_bytes + 4 * chunks, 0
