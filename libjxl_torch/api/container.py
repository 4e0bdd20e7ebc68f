"""ISOBMFF container (box) layer (reference ``lib/jxl/decode.cc:1670-2040``
``lib/jxl/box_content_decoder.cc``, ``encode.cc:838-892``).

Boxes: 4-byte BE size + 4-byte type (+8-byte extended size if size==1).
Codestream lives in a single ``jxlc`` box or ordered ``jxlp`` partial boxes
(4-byte index, high bit marks the last). ``brob`` wraps a Brotli-compressed
payload whose real type is its first 4 bytes.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

CONTAINER_SIGNATURE = bytes.fromhex("0000000C4A584C200D0A870A")


@dataclass
class Box:
    type: bytes
    data: bytes


from libjxl_torch.core.fields import FormatError


class ContainerError(FormatError):
    """Malformed ISOBMFF container (still a FormatError so one except
    clause covers every invalid-input failure)."""


def is_container(data: bytes) -> bool:
    return data[:12] == CONTAINER_SIGNATURE


def parse_boxes(data: bytes) -> list[Box]:
    boxes = []
    pos = 0
    n = len(data)
    while pos + 8 <= n:
        size = struct.unpack(">I", data[pos:pos + 4])[0]
        btype = data[pos + 4:pos + 8]
        header = 8
        if size == 1:
            if pos + 16 > n:
                raise ContainerError("truncated extended box")
            size = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            header = 16
        if size == 0:
            payload = data[pos + header:]
            pos = n
        else:
            if size < header or pos + size > n:
                raise ContainerError("bad box size")
            payload = data[pos + header:pos + size]
            pos += size
        boxes.append(Box(btype, payload))
    return boxes


def extract_codestream(data: bytes) -> bytes:
    """Return the raw codestream whether bare or boxed."""
    if data[:2] == b"\xff\x0a":
        return data
    if not is_container(data):
        raise ContainerError("not a JXL file")
    boxes = parse_boxes(data)
    parts = []
    jxlp = []
    for box in boxes:
        if box.type == b"jxlc":
            return box.data
        if box.type == b"jxlp":
            if len(box.data) < 4:
                raise ContainerError("short jxlp box")
            (index,) = struct.unpack(">I", box.data[:4])
            jxlp.append((index & 0x7FFFFFFF, box.data[4:]))
    if jxlp:
        jxlp.sort()
        return b"".join(p for _, p in jxlp)
    raise ContainerError("no codestream box found")


def wrap_container(codestream: bytes, level: int | None = None,
                   extra_boxes=None) -> bytes:
    """Minimal container: signature + ftyp + [jxll] + extras + jxlc.

    ``extra_boxes``: list of (type, payload) written before the codestream
    (e.g. the ``jbrd`` JPEG-reconstruction box; encode.cc:838-892)."""
    def box(btype: bytes, payload: bytes) -> bytes:
        return struct.pack(">I", 8 + len(payload)) + btype + payload

    out = [CONTAINER_SIGNATURE, box(b"ftyp", b"jxl \x00\x00\x00\x00jxl ")]
    if level is not None and level != 5:
        out.append(box(b"jxll", bytes([level])))
    for btype, payload in (extra_boxes or []):
        out.append(box(btype, payload))
    out.append(box(b"jxlc", codestream))
    return b"".join(out)


def encode_frame_index_box(entries, tnum: int = 1000,
                           tden: int = 1) -> bytes:
    """``jxli`` frame-index payload (encode.cc:668-741
    EncodeFrameIndexBox; layout doc encode_internal.h:40-76):
    LEB128 NF, BE32 TNUM/TDEN, then per indexed frame the codestream
    byte offset OFFi (delta vs the previously indexed frame), the
    start tick Ti and the frame-count delta Fi, all LEB128.

    ``entries``: [(to_be_indexed, duration_ticks, codestream_offset)]
    for every frame, first frame included (it is always recorded)."""
    def varint(v: int) -> bytes:
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            out.append(b | (0x80 if v else 0))
            if not v:
                return bytes(out)

    nf = sum(1 for i, e in enumerate(entries) if i == 0 or e[0])
    out = bytearray(varint(nf))
    out += struct.pack(">II", tnum, tden)
    prev_prev = -1
    prev = 0
    t_prev = 0
    t = 0
    for i in range(1, len(entries)):
        if entries[i][0]:
            offi = entries[prev][2]
            if prev_prev != -1:
                offi -= entries[prev_prev][2]
            out += varint(offi) + varint(t_prev) + varint(i - prev)
            prev_prev = prev
            prev = i
            t_prev = t
            t += entries[i][1]
    i = len(entries)
    offi = entries[prev][2]
    if prev_prev != -1:
        offi -= entries[prev_prev][2]
    out += varint(offi) + varint(t_prev) + varint(i - prev)
    return bytes(out)


def decode_frame_index_box(payload: bytes):
    """Parse a ``jxli`` payload back to (tnum, tden,
    [(OFFi_delta, Ti, Fi)]) for jxlinfo display."""
    pos = 0

    def varint():
        nonlocal pos
        v = shift = 0
        while True:
            b = payload[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7

    nf = varint()
    tnum, tden = struct.unpack_from(">II", payload, pos)
    pos += 8
    recs = [(varint(), varint(), varint()) for _ in range(nf)]
    return tnum, tden, recs
