"""Minimal OpenEXR scanline codec (reference ``lib/extras/dec/exr.cc``
and ``enc/exr.cc``, which delegate to the OpenEXR library; this image
has no OpenEXR, so the subset the reference actually uses is
implemented directly).

Supported: single-part scanline files, HALF/FLOAT channels, NONE and
ZIP/ZIPS compression (OpenEXR's byte-reorder + delta predictor over
zlib, ImfZip.cpp), R/G/B/A channel sets, increasing line order. This
covers files produced by the common HDR tool chains; tiled/deep files
raise ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x76\x2f\x31\x01"
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_C_NONE, _C_RLE, _C_ZIPS, _C_ZIP = 0, 1, 2, 3


def _zip_predict_inverse(buf: bytes) -> bytes:
    """ImfZip.cpp uncompress post-pass: undo delta, de-interleave."""
    b = bytearray(buf)
    for i in range(1, len(b)):
        b[i] = (b[i - 1] + b[i] - 128) & 0xFF
    n = len(b)
    half = (n + 1) // 2
    out = bytearray(n)
    out[0::2] = b[:half]
    out[1::2] = b[half:half + n // 2]
    return bytes(out)


def _zip_predict_forward(buf: bytes) -> bytes:
    """ImfZip.cpp compress pre-pass: interleave-split, then delta."""
    b = np.frombuffer(buf, np.uint8)
    n = len(b)
    half = (n + 1) // 2
    re = np.empty(n, np.uint8)
    re[:half] = b[0::2]
    re[half:] = b[1::2]
    d = re.astype(np.int16)
    d[1:] = d[1:] - re[:-1].astype(np.int16) + 128
    return (d & 0xFF).astype(np.uint8).tobytes()


def _read_attrs(data: bytes, pos: int):
    attrs = {}
    while True:
        end = data.index(b"\0", pos)
        name = data[pos:end].decode("latin1")
        pos = end + 1
        if not name:
            return attrs, pos
        end = data.index(b"\0", pos)
        typ = data[pos:end].decode("latin1")
        pos = end + 1
        size = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        attrs[name] = (typ, data[pos:pos + size])
        pos += size


def _parse_chlist(raw: bytes):
    chans = []
    pos = 0
    while raw[pos] != 0:
        end = raw.index(b"\0", pos)
        name = raw[pos:end].decode("latin1")
        pos = end + 1
        ptype, = struct.unpack_from("<I", raw, pos)
        xs, ys = struct.unpack_from("<II", raw, pos + 8)
        pos += 16
        if xs != 1 or ys != 1:
            raise ValueError("subsampled EXR channels unsupported")
        chans.append((name, ptype))
    return chans


def read_exr(data: bytes) -> np.ndarray:
    """Decode an EXR byte string to (h, w, c) float32, channels in
    R,G,B[,A] order (gray for a single Y/R channel)."""
    if data[:4] != _MAGIC:
        raise ValueError("not an EXR file")
    version = struct.unpack_from("<I", data, 4)[0]
    if version & 0x200 or version & 0x800:
        raise ValueError("tiled/deep/multi-part EXR unsupported")
    attrs, pos = _read_attrs(data, 8)
    chans = _parse_chlist(attrs["channels"][1])
    comp = attrs["compression"][1][0]
    if comp not in (_C_NONE, _C_ZIPS, _C_ZIP):
        raise ValueError(f"EXR compression {comp} unsupported")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    lpb = 16 if comp == _C_ZIP else 1
    n_blocks = -(-h // lpb)
    offsets = struct.unpack_from(f"<{n_blocks}Q", data, pos)
    # channels are stored in the (alphabetical) chlist order per line
    dtypes = {_PT_HALF: np.float16, _PT_FLOAT: np.float32,
              _PT_UINT: np.uint32}
    planes = {name: np.zeros((h, w), np.float32) for name, _ in chans}
    for off in offsets:
        y, size = struct.unpack_from("<iI", data, off)
        raw = data[off + 8:off + 8 + size]
        ny = min(lpb, y1 - y + 1)
        row_bytes = sum(w * np.dtype(dtypes[pt]).itemsize
                        for _, pt in chans)
        if comp != _C_NONE and len(raw) != row_bytes * ny:
            # (chunks whose zlib output would be larger are stored raw;
            # detected by size, OpenEXR convention)
            raw = zlib.decompress(raw)
            if len(raw) != row_bytes * ny:
                raise ValueError("EXR block size mismatch")
            raw = _zip_predict_inverse(raw)
        p = 0
        for dy in range(ny):
            for name, pt in chans:
                dt = dtypes[pt]
                nb = w * np.dtype(dt).itemsize
                row = np.frombuffer(raw[p:p + nb], dt)
                planes[name][y - y0 + dy] = row.astype(np.float32)
                p += nb
    names = [n for n, _ in chans]
    order = [n for n in ("R", "G", "B", "A") if n in planes]
    if not order:
        order = names[:1]
    return np.stack([planes[n] for n in order], axis=-1)


def write_exr(img: np.ndarray, pixel_type: str = "half",
              compression: str = "zip") -> bytes:
    """Encode (h, w, c) float to EXR bytes (c = 1/3/4 -> Y / RGB /
    RGBA), scanline storage."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    names = {1: ["Y"], 3: ["B", "G", "R"], 4: ["A", "B", "G", "R"]}[c]
    src = {1: [0], 3: [2, 1, 0], 4: [3, 2, 1, 0]}[c]
    pt = _PT_HALF if pixel_type == "half" else _PT_FLOAT
    dt = np.float16 if pt == _PT_HALF else np.float32
    comp = {"none": _C_NONE, "zip": _C_ZIP, "zips": _C_ZIPS}[compression]

    def attr(name, typ, val):
        return (name.encode() + b"\0" + typ.encode() + b"\0" +
                struct.pack("<I", len(val)) + val)

    chl = b""
    for n in names:
        chl += (n.encode() + b"\0" + struct.pack("<I", pt) +
                b"\0\0\0\0" + struct.pack("<II", 1, 1))
    chl += b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    hdr = _MAGIC + struct.pack("<I", 2)
    hdr += attr("channels", "chlist", chl)
    hdr += attr("compression", "compression", bytes([comp]))
    hdr += attr("dataWindow", "box2i", box)
    hdr += attr("displayWindow", "box2i", box)
    hdr += attr("lineOrder", "lineOrder", b"\0")
    hdr += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    hdr += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    hdr += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    hdr += b"\0"

    lpb = 16 if comp == _C_ZIP else 1
    n_blocks = -(-h // lpb)
    chunks = []
    for b in range(n_blocks):
        y = b * lpb
        ny = min(lpb, h - y)
        rows = []
        for dy in range(ny):
            for s in src:
                rows.append(img[y + dy, :, s].astype(dt).tobytes())
        raw = b"".join(rows)
        if comp != _C_NONE:
            z = zlib.compress(_zip_predict_forward(raw))
            raw = z if len(z) < len(raw) else raw
        chunks.append(struct.pack("<iI", y, len(raw)) + raw)
    table_pos = len(hdr)
    data_pos = table_pos + 8 * n_blocks
    offs = []
    p = data_pos
    for ch in chunks:
        offs.append(p)
        p += len(ch)
    return (hdr + struct.pack(f"<{n_blocks}Q", *offs) + b"".join(chunks))
