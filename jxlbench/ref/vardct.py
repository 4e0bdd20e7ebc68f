"""Plain reference decode of a region of a VarDCT codestream.

The copied host modules (float32 reconstruction, float64 filters, as the
repository's reference decoder computes them) decode the DC groups that
hold the region, the AC global section and the region's AC groups only;
the restoration filters and the output conversion to 8-bit sRGB then run
on the region. The DC groups within a block of the region are decoded
whole (DC smoothing reads the blocks around each block, and reaches
through a varblock's low frequencies over all of it); the filters read
a few pixels beyond the region, whose neighbouring AC groups are not
decoded, so the pixels within ``MARGIN`` of a region edge that is not an
image edge are not compared.

``cast``, when given, rounds the intermediate image after each stage
(reconstruction, Gaborish, EPF, linear RGB): the benchmark's control runs
the reference at a lower precision through it."""

from __future__ import annotations

import numpy as np

from jxlbench.ref.jxl.api.codestream import parse_codestream
from jxlbench.ref.jxl.color.xyb import linear_to_srgb, xyb_to_linear
from jxlbench.ref.jxl.core.fields import FormatError
from jxlbench.ref.jxl.core.frame_header import FrameEncoding, FrameFlags
from jxlbench.ref.jxl.core.headers import (
    ColorSpace, Primaries, TransferFunction, WhitePoint,
)
from jxlbench.ref.jxl.core.toc import ac_group_index
from jxlbench.ref.jxl.render.filters import (
    compute_sigma, epf_step0, epf_step1, epf_step2, gaborish,
)
from jxlbench.ref.jxl.utils.bits import BitReader
from jxlbench.ref.jxl.vardct.ac_strategy import NUM_STRATEGIES
from jxlbench.ref.jxl.vardct.frame_dec import VarDCTFrameDecoder

MARGIN = 16   # Gaborish (1) + EPF passes (3 + 2 + 1), rounded up to blocks


def tf32(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to TF32's 10-bit mantissa (to nearest, ties to even),
    as float32: the control's ``cast``."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    bias = np.uint32(0x0FFF) + ((u >> np.uint32(13)) & np.uint32(1))
    return ((u + bias) & np.uint32(0xFFFFE000)).view(np.float32)


def frame_info(data: bytes) -> dict:
    """Shape, group layout and loop filters of a one-frame stream."""
    meta, frames = parse_codestream(data)
    fh, fd = frames[0].header, frames[0].dims
    return dict(h=fd.ysize, w=fd.xsize, group_dim=fd.group_dim,
                dc_group_dim=fd.dc_group_dim, xgroups=fd.xsize_groups,
                ygroups=fd.ysize_groups, gab=bool(fh.loop_filter.gab),
                epf_iters=int(fh.loop_filter.epf_iters))


def _srgb_like(ce) -> bool:
    return (not ce.want_icc and ce.color_space == ColorSpace.RGB and
            ce.white_point == WhitePoint.D65 and
            ce.primaries == Primaries.SRGB and not ce.tf.have_gamma and
            ce.tf.transfer_function in (TransferFunction.SRGB,
                                        TransferFunction.UNKNOWN))


def decode_region(data: bytes, gx0: int, gy0: int, ngx: int, ngy: int,
                  cast=None):
    """Decode AC groups [gx0, gx0 + ngx) x [gy0, gy0 + ngy) of a
    one-frame, 4:4:4, sRGB VarDCT stream without image features.

    Returns (pixels, box): ``pixels`` is the region's (h, w, 3) uint8
    output and ``box`` = (y0, y1, x0, x1) the part of it to compare, in
    image coordinates."""
    cast = cast or (lambda a: a)
    meta, frames = parse_codestream(data)
    if len(frames) != 1:
        raise FormatError(f"{len(frames)} frames, the reference takes one")
    frame = frames[0]
    fh, fd = frame.header, frame.dims
    if fh.encoding != FrameEncoding.VARDCT or not meta.m.xyb_encoded or \
            fh.flags & (FrameFlags.PATCHES | FrameFlags.SPLINES |
                        FrameFlags.NOISE | FrameFlags.USE_DC_FRAME) or \
            fh.upsampling != 1 or not fh.chroma_subsampling.is_444 or \
            not _srgb_like(meta.m.color_encoding) or \
            meta.m.num_extra_channels or fh.passes.num_passes != 1:
        raise FormatError("not a plain one-pass 4:4:4 sRGB VarDCT frame")
    if any(s is None for s in frame.sections):
        raise FormatError("truncated stream")
    gd = fd.group_dim
    y0, x0 = gy0 * gd, gx0 * gd
    y1 = min((gy0 + ngy) * gd, fd.ysize)
    x1 = min((gx0 + ngx) * gd, fd.xsize)
    if not (0 <= y0 < y1 and 0 <= x0 < x1):
        raise ValueError("region outside the frame")
    dec = VarDCTFrameDecoder(fh, meta.m, fd)
    dec.reference_frames = [None] * 4
    secs = frame.sections
    if len(secs) == 1:
        r = BitReader(secs[0])
        dec.decode_dc_global(r)
        dec.decode_dc_group(r, 0)
        dec.finalize_dc()
        dec.decode_ac_global(r)
        dec.decode_ac_group([r], 0, 1)
    else:
        dec.decode_dc_global(BitReader(secs[0]))
        # every DC group within a block of the region: adaptive DC
        # smoothing reads the 3 x 3 blocks around each block, and a
        # varblock's low frequencies come from its blocks' smoothed DC
        dgd = fd.dc_group_dim
        ey0, ex0 = max(y0 - 8, 0), max(x0 - 8, 0)
        ey1, ex1 = min(y1 + 8, fd.ysize), min(x1 + 8, fd.xsize)
        for dgy in range(ey0 // dgd, (ey1 - 1) // dgd + 1):
            for dgx in range(ex0 // dgd, (ex1 - 1) // dgd + 1):
                g = dgy * fd.xsize_dc_groups + dgx
                dec.decode_dc_group(BitReader(secs[1 + g]), g)
        dec.finalize_dc()
        # orders of every strategy, whether or not the decoded DC groups
        # use it (the section is parsed the same either way)
        dec.used_acs = (1 << NUM_STRATEGIES) - 1
        dec.decode_ac_global(BitReader(secs[1 + fd.num_dc_groups]))
        for gy in range(gy0, gy0 + ngy):
            for gx in range(gx0, gx0 + ngx):
                g = gy * fd.xsize_groups + gx
                sec = secs[ac_group_index(0, g, fd.num_groups,
                                          fd.num_dc_groups)]
                dec.decode_ac_group([BitReader(sec)], g, 1)
    img = cast(dec.pixels[:, y0:y1, x0:x1].astype(np.float32))
    lf = fh.loop_filter
    if lf.gab:
        img = cast(gaborish(img, lf))
    if lf.epf_iters > 0:
        inv_sigma = compute_sigma(lf, dec.acs_raw, dec.acs_anchor,
                                  dec.raw_quant, dec.epf_sharpness,
                                  dec.quantizer.scale)
        inv_sigma = inv_sigma[y0 // 8:(y1 + 7) // 8, x0 // 8:(x1 + 7) // 8]
        if lf.epf_iters >= 3:
            img = epf_step0(img, inv_sigma, lf)
        img = epf_step1(img, inv_sigma, lf)
        if lf.epf_iters >= 2:
            img = epf_step2(img, inv_sigma, lf)
        img = cast(img)
    linear = cast(xyb_to_linear(
        img, intensity_target=meta.m.tone_mapping.intensity_target))
    srgb = linear_to_srgb(linear)
    out = np.clip(np.round(np.moveaxis(srgb, 0, -1) * 255), 0, 255)
    box = (y0 + (MARGIN if y0 > 0 else 0),
           y1 - (MARGIN if y1 < fd.ysize else 0),
           x0 + (MARGIN if x0 > 0 else 0),
           x1 - (MARGIN if x1 < fd.xsize else 0))
    return out.astype(np.uint8), box
