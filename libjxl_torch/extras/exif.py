"""Exif helpers (reference ``lib/extras/exif.cc``, ``base/exif.h``):
read and reset the TIFF orientation tag inside an Exif blob, and the
pixel-level orientation transforms (metadata.orientation 1-8,
``image_metadata.h`` Orientation / ``dec_external_image``)."""

from __future__ import annotations

import struct

import numpy as np

K_EXIF_ORIENTATION_TAG = 274


def _tiff_layout(exif: bytes):
    """Return (bigendian, ifd_offset) or None if not a TIFF header."""
    if len(exif) < 12:
        return None
    head = struct.unpack("<I", exif[:4])[0]
    if head == 0x2A004D4D:
        big = True
    elif head == 0x002A4949:
        big = False
    else:
        return None
    fmt = ">I" if big else "<I"
    off = struct.unpack(fmt, exif[4:8])[0]
    if len(exif) < 12 + off + 2 or off < 8:
        return None
    return big, off


def _iter_tags(exif: bytes):
    lay = _tiff_layout(exif)
    if lay is None:
        return
    big, off = lay
    e = ">" if big else "<"
    pos = off                  # IFD offset is from the TIFF header start
    ntags = struct.unpack(e + "H", exif[pos:pos + 2])[0]
    pos += 2
    for _ in range(ntags):
        if pos + 12 > len(exif):
            return
        tag, typ = struct.unpack(e + "HH", exif[pos:pos + 4])
        count = struct.unpack(e + "I", exif[pos + 4:pos + 8])[0]
        yield pos, tag, typ, count, e
        pos += 12


def get_exif_orientation(exif: bytes) -> int | None:
    """InterpretExif: the orientation value (1..8) or None."""
    for pos, tag, typ, count, e in _iter_tags(exif):
        if tag == K_EXIF_ORIENTATION_TAG and typ == 3 and count == 1:
            v = struct.unpack(e + "H", exif[pos + 8:pos + 10])[0]
            return v if 1 <= v <= 8 else None
    return None


def reset_exif_orientation(exif: bytes) -> bytes:
    """ResetExifOrientation (exif.cc:17-56): set the tag to 1 (the
    codestream carries orientation; a double-rotation must not occur)."""
    out = bytearray(exif)
    for pos, tag, typ, count, e in _iter_tags(exif):
        if tag == K_EXIF_ORIENTATION_TAG:
            if typ == 3 and count == 1:
                out[pos + 8:pos + 10] = struct.pack(e + "H", 1)
            break
    return bytes(out)


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """Apply metadata orientation (1..8) to an (h, w, c) or (h, w)
    image — the decoder-side transform the reference runs unless
    keep_orientation is set (image_metadata.h Orientation)."""
    if orientation <= 1 or orientation > 8:
        return img
    if orientation == 2:                       # flip horizontal
        return img[:, ::-1]
    if orientation == 3:                       # rotate 180
        return img[::-1, ::-1]
    if orientation == 4:                       # flip vertical
        return img[::-1]
    axes = (1, 0, 2) if img.ndim == 3 else (1, 0)
    t = img.transpose(axes)                    # 5..8 involve transpose
    if orientation == 5:                       # transpose
        return t
    if orientation == 6:                       # rotate 90 cw
        return t[:, ::-1]
    if orientation == 7:                       # anti-transpose
        return t[::-1, ::-1]
    return t[::-1]                             # 8: rotate 90 ccw
