"""Codestream-level parsing: headers through TOC/sections.

Mirrors the reference decode flow (``lib/jxl/decode.cc:1081-1136``,
``lib/jxl/dec_frame.cc:135``): signature, SizeHeader, ImageMetadata,
CustomTransformData, [ICC], byte-align, then per frame: FrameHeader, TOC,
byte-aligned sections.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from libjxl_torch.core.fields import FieldReader, FormatError
from libjxl_torch.core.frame_header import FrameEncoding, FrameHeader
from libjxl_torch.core.geometry import FrameDimensions
from libjxl_torch.core.headers import (
    CustomTransformData, ImageMetadata, SizeHeader, read_bundle,
    read_signature,
)
from libjxl_torch.core.toc import num_toc_entries, read_toc
from libjxl_torch.utils.bits import BitReader


@dataclass
class CodecMetadata:
    """SizeHeader + ImageMetadata + CustomTransformData
    (image_metadata.h:380-391)."""

    size: SizeHeader = field(default_factory=SizeHeader)
    m: ImageMetadata = field(default_factory=ImageMetadata)
    transform_data: CustomTransformData = field(
        default_factory=CustomTransformData)

    @property
    def xsize(self) -> int:
        return self.size.xsize

    @property
    def ysize(self) -> int:
        return self.size.ysize


@dataclass
class FrameSections:
    """One frame's header plus the raw bytes of each TOC section."""

    header: FrameHeader
    dims: FrameDimensions
    toc_sizes: np.ndarray
    toc_permutation: np.ndarray | None
    sections: list              # list[bytes|None] by LOGICAL section index
    partial: bool = False       # input truncated: None entries are missing


def read_codec_metadata(r: BitReader) -> CodecMetadata:
    read_signature(r)
    meta = CodecMetadata()
    read_bundle(r, meta.size)
    read_bundle(r, meta.m)
    meta.transform_data.xyb_encoded = meta.m.xyb_encoded
    read_bundle(r, meta.transform_data)
    # Expose image size for FrameHeader partial-frame logic.
    meta.m.nonserialized_xsize = meta.size.xsize
    meta.m.nonserialized_ysize = meta.size.ysize
    if meta.m.color_encoding.want_icc:
        from libjxl_torch.color.icc import read_encoded_icc
        meta.m.color_encoding.icc = read_encoded_icc(r)
    if not r.jump_to_byte_boundary():
        raise FormatError("nonzero padding after headers")
    return meta


def read_frame_sections(r: BitReader, meta: CodecMetadata,
                        allow_partial: bool = False,
                        is_preview: bool = False) -> FrameSections:
    """Parse one frame's header + TOC and slice its sections (byte level).

    With ``allow_partial`` a truncated stream yields ``None`` for the
    missing sections instead of raising (dec_frame.cc kSkipped).
    ``is_preview``: this is the preview frame that precedes the first
    regular frame when ImageMetadata.have_preview — its dimensions come
    from the preview header (dec_frame.cc nonserialized_is_preview)."""
    fh = FrameHeader()
    fh.visit(FieldReader(r), meta.m)
    fh.nonserialized_is_preview = is_preview
    cs = fh.chroma_subsampling
    maxhs, maxvs = cs.max_hshift, cs.max_vshift
    if is_preview:
        dims = FrameDimensions(meta.m.preview_size.xsize,
                               meta.m.preview_size.ysize,
                               fh.group_dim, maxhs, maxvs)
    elif fh.custom_size_or_origin:
        dims = FrameDimensions(fh.frame_xsize, fh.frame_ysize, fh.group_dim,
                               maxhs, maxvs)
    else:
        xsize, ysize = meta.xsize, meta.ysize
        if fh.upsampling > 1:
            xsize = -(-xsize // fh.upsampling)
            ysize = -(-ysize // fh.upsampling)
        if fh.dc_level > 0:
            # DC frames are stored at 1/8 per level (frame_header.h)
            div = 1 << (3 * fh.dc_level)
            xsize = -(-xsize // div)
            ysize = -(-ysize // div)
        dims = FrameDimensions(xsize, ysize, fh.group_dim, maxhs, maxvs)
    n = num_toc_entries(dims.num_groups, dims.num_dc_groups,
                        fh.passes.num_passes)
    sizes, offsets, perm = read_toc(r, n)
    assert r.bits_consumed % 8 == 0
    # sizes/offsets are by LOGICAL section index (read_toc un-permutes);
    # slice the payload by offset so permuted TOCs resolve correctly
    total = int(sizes.sum())
    avail = (r.total_bits() - r.bits_consumed) // 8
    take = min(total, avail)
    payload = r.read_bytes(take)
    if r.overflow or (avail < total and not allow_partial):
        raise FormatError("truncated frame sections")
    sections = []
    for i in range(n):
        o, s = int(offsets[i]), int(sizes[i])
        sections.append(payload[o:o + s] if o + s <= take else None)
    return FrameSections(fh, dims, sizes, perm, sections,
                         partial=avail < total)


def parse_codestream(data: bytes):
    """Parse all frames; returns (metadata, [FrameSections])."""
    r = BitReader(data)
    meta = read_codec_metadata(r)
    frames = []
    if getattr(meta.m, "have_preview", False):
        # the preview frame precedes the first regular frame; parse and
        # keep it (marked) so composition can skip it
        frames.append(read_frame_sections(r, meta, is_preview=True))
    while True:
        fs = read_frame_sections(r, meta)
        frames.append(fs)
        if fs.header.is_last:
            break
    return meta, frames
