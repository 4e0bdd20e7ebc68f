"""HDR gain-map bundle codec (reference ``include/jxl/gain_map.h:94``,
``lib/extras/gain_map.cc``): the jhgm-box payload carrying an ISO
21496-1 gain map plus its color encoding / ICC profile.

Layout (gain_map.cc:104-157, all sizes big-endian):
  u8   jhgm_version
  u16  gain_map_metadata_size | metadata bytes
  u8   color_encoding_size    | Bundle-coded ColorEncoding bits
  u32  alt_icc_size           | RAW icc bytes (compressed form)
  ...  gain map codestream (to the end of the buffer)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from libjxl_torch.core.fields import FieldReader, FieldWriter, FormatError
from libjxl_torch.utils.bits import BitReader, BitWriter


@dataclass
class GainMapBundle:
    jhgm_version: int = 0
    gain_map_metadata: bytes = b""    # ISO 21496-1 blob
    color_encoding: object = None     # core.headers.ColorEncoding | None
    alt_icc: bytes = b""              # compressed ICC (color/icc.py form)
    gain_map: bytes = b""             # the gain-map image (e.g. JXL/JPEG)


def write_gain_map_bundle(bundle: GainMapBundle) -> bytes:
    """JxlGainMapWriteBundle."""
    ce_bytes = b""
    if bundle.color_encoding is not None:
        bw = BitWriter()
        bundle.color_encoding.visit(FieldWriter(bw))
        bw.zero_pad_to_byte()
        ce_bytes = bw.to_bytes()
        if len(ce_bytes) > 255:
            raise FormatError("color encoding too large for bundle")
    if len(bundle.gain_map_metadata) > 0xFFFF:
        raise FormatError("gain map metadata too large")
    out = bytearray()
    out.append(bundle.jhgm_version & 0xFF)
    out += struct.pack(">H", len(bundle.gain_map_metadata))
    out += bundle.gain_map_metadata
    out.append(len(ce_bytes))
    out += ce_bytes
    out += struct.pack(">I", len(bundle.alt_icc))
    out += bundle.alt_icc
    out += bundle.gain_map
    return bytes(out)


def read_gain_map_bundle(data: bytes) -> GainMapBundle:
    """JxlGainMapReadBundle."""
    from libjxl_torch.core.headers import ColorEncoding

    def take(n: int) -> bytes:
        nonlocal pos
        if pos + n > len(data):
            raise FormatError("truncated gain map bundle")
        chunk = data[pos:pos + n]
        pos += n
        return chunk

    pos = 0
    b = GainMapBundle()
    b.jhgm_version = take(1)[0]
    meta_size = struct.unpack(">H", take(2))[0]
    b.gain_map_metadata = take(meta_size)
    ce_size = take(1)[0]
    if ce_size:
        ce = ColorEncoding()
        ce.visit(FieldReader(BitReader(take(ce_size))))
        b.color_encoding = ce
    icc_size = struct.unpack(">I", take(4))[0]
    b.alt_icc = take(icc_size)
    b.gain_map = data[pos:]
    return b


def gain_map_bundle_size(bundle: GainMapBundle) -> int:
    """JxlGainMapGetBundleSize."""
    return len(write_gain_map_bundle(bundle))
