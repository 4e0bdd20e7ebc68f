"""Plain reference decode of a region of a recompressed JPEG's frame.

A recompressed JPEG (``cjxl --lossless_jpeg=1``) is one VarDCT frame in
YCbCr with chroma subsampled 4:2:0, every block DCT8, the JPEG's own
quantization tables sent RAW, and no filters. Its decode to 8-bit RGB,
step by step, each its own:

1. token decode: the copied host modules under ``jxlbench/ref/jxl``
   (headers, TOC, DC groups, AC global section; then the AC groups'
   tokens in Python, their quantized coefficients collected per channel
   at each channel's block grid, as the frame decoder's JPEG mode keeps
   them);
2. dequantization by the stream's table: AdjustQuantBias (quantizer-inl.h),
   then table x (inverse global scale / quant field) x the channel's
   qm-scale multiplier, and the block's DC (not smoothed; no chroma from
   luma under subsampling) into its lowest slot;
3. the 8x8 IDCT of every block, per plane at its own size;
4. chroma upsampling (stage_chroma_upsampling.cc): each chroma plane cut to
   its visible size (ceil(h / 2), ceil(w / 2)), then 2x horizontally and
   2x vertically with the taps 3/4 (the sample) and 1/4 (its neighbour on
   the output's side), the edge repeating its last sample;
5. YCbCr to RGB (stage_ycbcr.cc: full-range BT.601, buffer order Cb, Y,
   Cr, luma offset 128/255);
6. x 255, rounded half to even, clamped to 0..255.

Steps 2 to 6 are plain torch in float32 (TF32 off), one operation at a
time, with no batching and no cache. Departures from the specification:
the IDCT is a product with the float32 cosine matrix rather than a fast
transform (the same sums, in another order); and a region edge that is
not an image edge has no neighbouring chroma samples decoded, so its
upsampling repeats the edge sample there, and the ``MARGIN`` pixels next
to such an edge are not compared.

``cast``, when given, rounds each stage's output (dequantized
coefficients, the IDCT's planes, the upsampled planes, RGB): the
benchmark's control runs the reference at a lower precision through it
(``tf32``).
"""

from __future__ import annotations

import numpy as np
import torch

from jxlbench.ref.jxl.api.codestream import parse_codestream
from jxlbench.ref.jxl.core.fields import FormatError
from jxlbench.ref.jxl.core.frame_header import (
    ColorTransform, FrameEncoding, FrameFlags,
)
from jxlbench.ref.jxl.core.toc import ac_group_index
from jxlbench.ref.jxl.utils.bits import BitReader
from jxlbench.ref.jxl.vardct.ac_strategy import NUM_STRATEGIES
from jxlbench.ref.jxl.vardct.frame_dec import K_BIASES, VarDCTFrameDecoder
from jxlbench.ref.vardct import _srgb_like

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MARGIN = 2    # the upsampling's reach (one chroma sample), in pixels
F32 = torch.float32


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32's 10-bit mantissa (to nearest, ties to
    even), as float32: the control's ``cast``."""
    u = t.contiguous().to(F32).view(torch.int32).to(torch.int64)
    u = (u + 0x0FFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 1 << 31, u - (1 << 32), u)
    return u.to(torch.int32).view(F32)


def codestream(data: bytes) -> bytes:
    """The codestream of a stream: ``data`` itself, or the ``jxlc`` box
    (or the ``jxlp`` boxes in turn) of a container (ISO/IEC 18181-2)."""
    if data[:2] == b"\xff\x0a":
        return data
    if data[4:8] != b"JXL ":
        raise FormatError("neither a codestream nor a container")
    out, pos = [], 0
    while pos + 8 <= len(data):
        size = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        head = 8
        if size == 1:
            size = int.from_bytes(data[pos + 8:pos + 16], "big")
            head = 16
        elif size == 0:
            size = len(data) - pos
        if size < head or pos + size > len(data):
            raise FormatError("truncated container box")
        body = data[pos + head:pos + size]
        if kind == b"jxlc":
            return body
        if kind == b"jxlp":
            out.append(body[4:])
        pos += size
    if not out:
        raise FormatError("no codestream box")
    return b"".join(out)


def frame_info(data: bytes) -> dict:
    """Shape, group layout and loop filters of a one-frame stream."""
    meta, frames = parse_codestream(codestream(data))
    fh, fd = frames[0].header, frames[0].dims
    return dict(h=fd.ysize, w=fd.xsize, group_dim=fd.group_dim,
                dc_group_dim=fd.dc_group_dim, xgroups=fd.xsize_groups,
                ygroups=fd.ysize_groups, gab=bool(fh.loop_filter.gab),
                epf_iters=int(fh.loop_filter.epf_iters))


def _check_frame(meta, frames) -> None:
    if len(frames) != 1:
        raise FormatError(f"{len(frames)} frames, the reference takes one")
    fh = frames[0].header
    cs = fh.chroma_subsampling
    if fh.encoding != FrameEncoding.VARDCT or meta.m.xyb_encoded or \
            fh.color_transform != ColorTransform.YCBCR or \
            fh.flags & (FrameFlags.PATCHES | FrameFlags.SPLINES |
                        FrameFlags.NOISE | FrameFlags.USE_DC_FRAME) or \
            fh.upsampling != 1 or fh.loop_filter.gab or \
            fh.loop_filter.epf_iters or \
            tuple(cs.hshift(c) for c in range(3)) != (1, 0, 1) or \
            tuple(cs.vshift(c) for c in range(3)) != (1, 0, 1) or \
            not _srgb_like(meta.m.color_encoding) or \
            meta.m.bit_depth.bits_per_sample != 8 or \
            meta.m.num_extra_channels or fh.passes.num_passes != 1:
        raise FormatError("not a one-pass 4:2:0 YCbCr VarDCT frame "
                          "without filters")
    if any(s is None for s in frames[0].sections):
        raise FormatError("truncated stream")


def _tokens(frame, meta, blocks):
    """Step 1 over the luma block box ``blocks`` = (by0, by1, bx0, bx1)
    (whole AC groups): the frame decoder after the AC groups of the box,
    with ``jpeg_coeffs`` (per channel (rows, cols, 64) int32 at its own
    block grid, the box's blocks filled) and its dequantized DC."""
    fh, fd = frame.header, frame.dims
    by0, by1, bx0, bx1 = blocks
    dec = VarDCTFrameDecoder(fh, meta.m, fd)
    dec.reference_frames = [None] * 4
    secs = frame.sections
    gdb = fd.group_dim // 8
    groups = [gy * fd.xsize_groups + gx
              for gy in range(by0 // gdb, -(-by1 // gdb))
              for gx in range(bx0 // gdb, -(-bx1 // gdb))]
    if len(secs) == 1:
        r = BitReader(secs[0])
        dec.decode_dc_global(r)
        dec.decode_dc_group(r, 0)
        readers = {0: r}
        dec.decode_ac_global(r)
    else:
        dec.decode_dc_global(BitReader(secs[0]))
        dgd = fd.dc_group_dim // 8
        for dgy in range(by0 // dgd, (by1 - 1) // dgd + 1):
            for dgx in range(bx0 // dgd, (bx1 - 1) // dgd + 1):
                g = dgy * fd.xsize_dc_groups + dgx
                dec.decode_dc_group(BitReader(secs[1 + g]), g)
        dec.used_acs = (1 << NUM_STRATEGIES) - 1
        dec.decode_ac_global(BitReader(secs[1 + fd.num_dc_groups]))
        readers = {g: BitReader(secs[ac_group_index(
            0, g, fd.num_groups, fd.num_dc_groups)]) for g in groups}
    # the DC is dequantized above; the tokens' integers are then kept as
    # they are (the decoder's JPEG mode)
    dec.jpeg_mode = True
    dec.jpeg_coeffs = [np.zeros((fd.ysize_blocks >> dec.vs[c],
                                 fd.xsize_blocks >> dec.hs[c], 64), np.int32)
                       for c in range(3)]
    for g in groups:
        dec.decode_ac_group([readers[g]], g, 1)
    return dec


def _plane(dec, c: int, blocks, cast) -> torch.Tensor:
    """Steps 2 and 3 for channel ``c`` over the luma block box: the
    channel's pixels at its own resolution."""
    by0, by1, bx0, bx1 = blocks
    vs, hs = dec.vs[c], dec.hs[c]
    rows = slice(by0 >> vs, -(-by1 >> vs))
    cols = slice(bx0 >> hs, -(-bx1 >> hs))
    q = torch.from_numpy(dec.jpeg_coeffs[c][rows, cols]).to(F32)
    nby, nbx = q.shape[:2]
    # AdjustQuantBias (quantizer-inl.h:35-60)
    absq = q.abs()
    biased = q - K_BIASES[3] / torch.where(q == 0, 1.0, q)
    biased = torch.where(absq < 0.5, 0.0, biased)
    biased = torch.where((absq > 0.5) & (absq < 1.5),
                         torch.sign(q) * K_BIASES[c], biased)
    # dequant by the stream's DCT8 table and the block's quant field
    # (the luma block at the chroma block's position)
    table = torch.from_numpy(np.ascontiguousarray(
        dec.matrices.table_for_strategy(0), np.float32).reshape(3, 64)[c])
    qf = torch.from_numpy(dec.raw_quant[by0:by1:1 << vs, bx0:bx1:1 << hs]
                          .astype(np.float32))
    inv_gs = torch.tensor(dec.quantizer.inv_global_scale, dtype=F32)
    qm_scale = {0: dec.fh.x_qm_scale, 2: dec.fh.b_qm_scale}
    dm = (1 / 1.25) ** (qm_scale[c] - 2.0) if c in qm_scale else 1.0
    step = inv_gs / qf
    dq = biased * ((table * step[..., None]) * torch.tensor(dm, dtype=F32))
    dq[..., 0] = torch.from_numpy(np.asarray(dec.dc[c], np.float32)
                                  [rows, cols])
    dq = cast(dq)
    # the 8x8 IDCT: the stored block is the coefficient grid transposed
    # (rows index the horizontal frequency)
    n = torch.arange(8, dtype=torch.float64)
    m = torch.cos((n[:, None] + 0.5) * n[None, :] * np.pi / 8) * np.sqrt(2)
    m[:, 0] /= np.sqrt(2)
    m = m.to(F32)
    coef = dq.reshape(nby, nbx, 8, 8).transpose(-1, -2)
    pix = m @ coef @ m.T
    return cast(pix.permute(0, 2, 1, 3).reshape(nby * 8, nbx * 8))


def _upsample2(p: torch.Tensor, dim: int) -> torch.Tensor:
    """Step 4 along ``dim``: 2x with the 3/4-1/4 taps, the edge sample
    repeated."""
    n = p.shape[dim]
    idx = torch.arange(n)
    prev = p.index_select(dim, (idx - 1).clamp_min(0))
    nxt = p.index_select(dim, (idx + 1).clamp_max(n - 1))
    even = 0.75 * p + 0.25 * prev
    odd = 0.75 * p + 0.25 * nxt
    shape = list(p.shape)
    shape[dim] *= 2
    return torch.stack([even, odd], dim + 1).reshape(shape)


def decode_region(data: bytes, gx0: int, gy0: int, ngx: int, ngy: int,
                  cast=None):
    """Decode AC groups [gx0, gx0 + ngx) x [gy0, gy0 + ngy) of a
    recompressed JPEG's frame (see the module's docstring).

    Returns (pixels, box): ``pixels`` is the region's (h, w, 3) uint8
    output and ``box`` = (y0, y1, x0, x1) the part of it to compare, in
    image coordinates."""
    cast = cast or (lambda t: t)
    meta, frames = parse_codestream(codestream(data))
    _check_frame(meta, frames)
    frame = frames[0]
    fd = frame.dims
    gd = fd.group_dim
    y0, x0 = gy0 * gd, gx0 * gd
    y1 = min((gy0 + ngy) * gd, fd.ysize)
    x1 = min((gx0 + ngx) * gd, fd.xsize)
    if not (0 <= y0 < y1 and 0 <= x0 < x1):
        raise ValueError("region outside the frame")
    blocks = (y0 // 8, min(-(-y1 // gd) * gd // 8, fd.ysize_blocks),
              x0 // 8, min(-(-x1 // gd) * gd // 8, fd.xsize_blocks))
    dec = _tokens(frame, meta, blocks)
    cb, y, cr = (_plane(dec, c, blocks, cast) for c in range(3))
    # the chroma samples of the region, cut at the frame's visible
    # chroma size
    ch, cw = -(-fd.ysize // 2), -(-fd.xsize // 2)
    h, w = y1 - y0, x1 - x0
    up = []
    for p in (cb, cr):
        p = p[:ch - y0 // 2, :cw - x0 // 2]
        up.append(cast(_upsample2(_upsample2(p, 1), 0))[:h, :w])
    cbu, cru = up
    yv = y[:h, :w] + 128.0 / 255
    r = 1.402 * cru + yv
    g = yv + (-0.114 * 1.772 / 0.587) * cbu + (-0.299 * 1.402 / 0.587) * cru
    b = 1.772 * cbu + yv
    rgb = cast(torch.stack([r, g, b], dim=-1))
    out = torch.round(rgb * 255).clamp(0, 255).to(torch.uint8).numpy()
    box = (y0 + (MARGIN if y0 > 0 else 0),
           y1 - (MARGIN if y1 < fd.ysize else 0),
           x0 + (MARGIN if x0 > 0 else 0),
           x1 - (MARGIN if x1 < fd.xsize else 0))
    return out, box
