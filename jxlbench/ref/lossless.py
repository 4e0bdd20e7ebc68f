"""Plain reference decode of a lossless modular codestream: the copied
host modules parse the headers and sections, the frame's groups decode
one after another, and the channels come back as the integer image."""

from __future__ import annotations

import numpy as np

from jxlbench.ref.jxl.api.codestream import parse_codestream
from jxlbench.ref.jxl.core.fields import FormatError, read_f16
from jxlbench.ref.jxl.core.frame_header import FrameEncoding, FrameFlags
from jxlbench.ref.jxl.core.toc import ac_group_index
from jxlbench.ref.jxl.modular.frame import (
    ModularFrameDecoder, get_downsampling_bracket, stream_id_modular_ac,
    stream_id_modular_dc,
)
from jxlbench.ref.jxl.utils.bits import BitReader


def _skip_dequant_dc(r: BitReader) -> None:
    if r.read(1) != 1:
        for _ in range(3):
            read_f16(r)


def decode(data: bytes, groups=None) -> np.ndarray:
    """The (h, w, c) integer image of a one-frame lossless modular stream
    without image features; anything else raises ``FormatError``. With
    ``groups`` (indices of AC groups) only those groups are decoded and
    the rest of the image is left 0."""
    meta, frames = parse_codestream(data)
    if len(frames) != 1:
        raise FormatError(f"{len(frames)} frames, the reference takes one")
    frame = frames[0]
    fh, fd = frame.header, frame.dims
    if fh.encoding != FrameEncoding.MODULAR or meta.m.xyb_encoded or \
            fh.flags & (FrameFlags.PATCHES | FrameFlags.SPLINES |
                        FrameFlags.NOISE) or fh.upsampling != 1:
        raise FormatError("not a plain lossless modular frame")
    dec = ModularFrameDecoder(fh, meta.m, fd)
    secs = frame.sections
    if any(s is None for s in secs):
        raise FormatError("truncated stream")
    r = BitReader(secs[0])
    _skip_dequant_dc(r)
    dec.decode_global_info(r)
    full = (0, 0, fd.group_dim, fd.group_dim)
    if len(secs) == 1:
        dec.decode_group(r, (0, 0, fd.dc_group_dim, fd.dc_group_dim), 3,
                         1000, stream_id_modular_dc(fd, 0))
        for p in range(fh.passes.num_passes):
            lo, hi = get_downsampling_bracket(fh.passes, p)
            dec.decode_group(r, full, lo, hi, stream_id_modular_ac(fd, 0, p))
    else:
        for g in range(fd.num_dc_groups):
            gx, gy = g % fd.xsize_dc_groups, g // fd.xsize_dc_groups
            dec.decode_group(BitReader(secs[1 + g]),
                             (gx * fd.dc_group_dim, gy * fd.dc_group_dim,
                              fd.dc_group_dim, fd.dc_group_dim), 3, 1000,
                             stream_id_modular_dc(fd, g))
        for p in range(fh.passes.num_passes):
            lo, hi = get_downsampling_bracket(fh.passes, p)
            for g in (range(fd.num_groups) if groups is None else groups):
                gx, gy = g % fd.xsize_groups, g // fd.xsize_groups
                sec = secs[ac_group_index(p, g, fd.num_groups,
                                          fd.num_dc_groups)]
                dec.decode_group(BitReader(sec),
                                 (gx * fd.group_dim, gy * fd.group_dim,
                                  fd.group_dim, fd.group_dim), lo, hi,
                                 stream_id_modular_ac(fd, g, p))
    fi = dec.finalize()
    bits = meta.m.bit_depth.bits_per_sample
    planes = [ch.plane[:fd.ysize, :fd.xsize] for ch in fi.channel]
    out = np.stack(planes, axis=-1)
    if out.min() < 0 or out.max() >= 1 << bits:
        raise FormatError("decoded samples outside the bit depth")
    return out.astype(np.uint8 if bits <= 8 else np.uint16)
