"""Lossless JPEG recompression: JPEGData <-> VarDCT codestream.

Encode (reference ``lib/jxl/enc_frame.cc:787-1110``
ComputeJPEGTranscodingData): the JPEG's quantized DCT coefficients are
stored directly as a VarDCT frame — RAW quantization tables (the JPEG
tables), global_scale chosen so InvGlobalScale()==1, raw quant field all
ones, DCT8 everywhere, color transform YCbCr (or None for Adobe-RGB
JPEGs). The entropy-coder side information needed to reproduce the
original file byte-exactly travels in the ``jbrd`` container box.

Decode (reference ``lib/jxl/dec_group.cc:225-430`` jpeg path,
``lib/jxl/dec_frame.cc:222-252``): qblock integers are transposed back to
JPEG natural order, DC comes from the (unsmoothed, undequantized) DC
stream, and optional chroma-from-luma is undone in fixed point.
"""

from __future__ import annotations

import numpy as np

from libjxl_torch.core.fields import (
    FieldWriter, FormatError, round_f16, write_f16, write_u32,
)
from libjxl_torch.core.frame_header import (
    ColorTransform, FrameEncoding, FrameFlags, FrameHeader,
)
from libjxl_torch.core.geometry import FrameDimensions, cdiv
from libjxl_torch.core.headers import (
    BitDepth, ColorEncoding, CustomTransformData, ImageMetadata, SizeHeader,
    write_bundle, write_signature,
)
from libjxl_torch.core.toc import write_toc
from libjxl_torch.entropy.ans import (
    build_entropy_codes, tokens_to_array, write_entropy_codes, write_tokens,
)
from libjxl_torch.jpeg.data import (
    JPEG_NATURAL_ORDER, JPEG_ZIGZAG_ORDER, JPEGData,
)
from libjxl_torch.modular.codec import modular_encode
from libjxl_torch.modular.frame import stream_id_quant_table
from libjxl_torch.modular.image import Channel, ModularImage
from libjxl_torch.modular.predict import PREDICTOR_GRADIENT, PREDICTOR_ZERO
from libjxl_torch.modular.tree import TreeNode
from libjxl_torch.utils.bits import BitWriter
from libjxl_torch.vardct.ac_context import BlockCtxMap
from libjxl_torch.vardct.ac_strategy import natural_order
from libjxl_torch.vardct.cfl import (
    K_CFL_FIXED_POINT_PRECISION, K_COLOR_TILE_DIM_IN_BLOCKS,
    K_DEFAULT_COLOR_FACTOR, _COLOR_FACTOR_DIST,
)
from libjxl_torch.vardct.coeff_order import K_ORDER_ENC
from libjxl_torch.vardct.frame_dec import (
    K_GLOBAL_SCALE_DENOM, _GLOBAL_SCALE_DIST, _QUANT_DC_DIST,
)
from libjxl_torch.vardct.frame_enc import _tokenize_block

_NAT2ZZ = np.array(JPEG_ZIGZAG_ORDER)   # zz position for each raster index
_ZZ2NAT = np.array(JPEG_NATURAL_ORDER)  # raster index for each zz position
K_QTABLE_DEN = 1.0 / (8 * 255)


def _jpeg_order(ct: int, is_gray: bool):
    """JXL channel -> JPEG component index (frame_header.h:67-79)."""
    if is_gray:
        return (0, 0, 0)
    return (1, 0, 2) if ct == ColorTransform.YCBCR else (0, 1, 2)


def _color_transform_for(jd: JPEGData) -> int:
    """(enc_jpeg_data.cc:241-300): YCbCr unless an Adobe APP14 marker says
    RGB (transform byte 0) when no JFIF marker is present, or components
    are literally R,G,B."""
    if len(jd.components) == 1:
        return ColorTransform.YCBCR
    ids = [c.id for c in jd.components]
    if ids == [ord("R"), ord("G"), ord("B")]:
        return ColorTransform.NONE
    if 0xE0 not in jd.marker_order:
        app_idx = 0
        for m in jd.marker_order:
            if (m & 0xF0) == 0xE0:
                if m == 0xEE:
                    data = jd.app_data[app_idx]
                    if (len(data) == 15 and data[3:8] == b"Adobe" and
                            data[14] == 0):
                        return ColorTransform.NONE
                app_idx += 1
    return ColorTransform.YCBCR


def _natural_coeffs(comp) -> np.ndarray:
    """(nblocks, 64) zigzag-order coeffs -> natural raster order."""
    return np.asarray(comp.coeffs)[:, _NAT2ZZ]


def jpeg_data_to_codestream(jd: JPEGData) -> bytes:
    """Build the VarDCT codestream holding ``jd``'s DCT coefficients."""
    if not jd.components or len(jd.components) not in (1, 3):
        raise FormatError("JPEG must have 1 or 3 components")
    is_gray = len(jd.components) == 1
    ct = _color_transform_for(jd)
    w, h = jd.width, jd.height
    # chroma subsampling from the JPEG sampling factors
    # (enc_jpeg_data.cc:215-239)
    from libjxl_torch.core.frame_header import YCbCrChromaSubsampling
    cs = YCbCrChromaSubsampling()
    comps = jd.components if not is_gray else [jd.components[0]] * 3
    cs.set_sampling([c.h_samp_factor for c in comps],
                    [c.v_samp_factor for c in comps])
    hs = tuple(cs.hshift(c) for c in range(3))
    vs = tuple(cs.vshift(c) for c in range(3))
    fd = FrameDimensions(w, h, 256, cs.max_hshift, cs.max_vshift)
    xb, yb = fd.xsize_blocks, fd.ysize_blocks
    jmap = _jpeg_order(ct, is_gray)

    # --- quant tables (transposed into JXL stored layout) -----------------
    qt_stored = np.zeros((3, 64), dtype=np.int32)
    dc_quant_f16 = [0.0] * 3
    qt_dc = [1] * 3
    for c in range(3):
        comp = jd.components[jmap[c]]
        quant = np.asarray(jd.quant[_quant_table_index(jd, comp.quant_idx)]
                           .values, dtype=np.int64)
        qt_stored[c] = quant.reshape(8, 8).T.reshape(64)
        qt_dc[c] = int(quant[0])
        # decoded dc_quant must be quant[0]/(255*8) = 1/dcquantization
        dc_quant_f16[c] = round_f16(128.0 * quant[0] * K_QTABLE_DEN)
        if np.any(quant <= 0) or np.any(quant >= 65536):
            raise FormatError("invalid JPEG quantization table")

    # --- per-block coefficients in stored (transposed) layout -------------
    # stored[8x+y] = natural[8y+x]; chroma grids are subsampled
    stored = [np.zeros((yb >> vs[c], xb >> hs[c], 64), dtype=np.int32)
              for c in range(3)]
    dc_q = [np.zeros((yb >> vs[c], xb >> hs[c]), dtype=np.int32)
            for c in range(3)]
    dczero = ct == ColorTransform.YCBCR
    for c in range(3):
        if is_gray and c != 1:
            continue
        comp = jd.components[jmap[c]]
        xbc, ybc = xb >> hs[c], yb >> vs[c]
        if comp.width_in_blocks != xbc or comp.height_in_blocks != ybc:
            raise FormatError("JPEG component geometry mismatch")
        nat = _natural_coeffs(comp).reshape(ybc, xbc, 8, 8)
        stored[c] = nat.transpose(0, 1, 3, 2).reshape(ybc, xbc, 64) \
            .astype(np.int32)
        idc = nat[:, :, 0, 0].astype(np.int32)
        if not dczero:
            idc = idc + 1024 // qt_dc[c]
        dc_q[c] = idc

    # --- tokenize AC groups -----------------------------------------------
    bctx = BlockCtxMap()
    order = natural_order(0)
    qf = 1
    group_tokens = [[] for _ in range(fd.num_groups)]
    gdb = fd.group_dim // 8
    for gy in range(fd.ysize_groups):
        for gx in range(fd.xsize_groups):
            g = gy * fd.xsize_groups + gx
            toks = group_tokens[g]
            by0, bx0 = gy * gdb, gx * gdb
            gh = min(gdb, yb - by0)
            gw = min(gdb, xb - bx0)
            nzeros_img = [np.zeros((gh >> vs[c], gw >> hs[c]), np.int32)
                          for c in range(3)]
            for by in range(gh):
                for bx in range(gw):
                    y, x = by0 + by, bx0 + bx
                    for c in (1, 0, 2):
                        if ((x >> hs[c]) << hs[c] != x or
                                (y >> vs[c]) << vs[c] != y):
                            continue
                        _tokenize_block(toks,
                                        stored[c][y >> vs[c], x >> hs[c]],
                                        order, nzeros_img[c],
                                        bx >> hs[c], by >> vs[c],
                                        bctx, qf, c)
    codes = build_entropy_codes(
        [tokens_to_array(t) if t else np.zeros((0, 2), np.int64)
         for t in group_tokens],
        num_contexts=bctx.num_ac_contexts(), allow_clustering=True,
        histo_shift=11, max_clusters=32)

    # --- headers ----------------------------------------------------------
    bw = BitWriter()
    write_signature(bw)
    size = SizeHeader()
    size.set(w, h)
    write_bundle(bw, size)
    meta = ImageMetadata(xyb_encoded=False,
                         bit_depth=BitDepth(bits_per_sample=8),
                         color_encoding=ColorEncoding.srgb(gray=is_gray))
    write_bundle(bw, meta)
    ctd = CustomTransformData()
    ctd.xyb_encoded = False
    write_bundle(bw, ctd)
    bw.zero_pad_to_byte()

    fh = FrameHeader(encoding=FrameEncoding.VARDCT, color_transform=ct,
                     flags=FrameFlags.SKIP_ADAPTIVE_DC_SMOOTHING)
    fh.chroma_subsampling = cs
    fh.loop_filter.gab = False
    fh.loop_filter.epf_iters = 0
    meta.nonserialized_xsize = w
    meta.nonserialized_ysize = h
    fh.visit(FieldWriter(bw), meta)

    # --- sections ---------------------------------------------------------
    def dc_global(sw: BitWriter) -> None:
        sw.write(1, 0)                      # DC quants not all-default
        for c in range(3):
            write_f16(sw, dc_quant_f16[c])
        write_u32(sw, _GLOBAL_SCALE_DIST, K_GLOBAL_SCALE_DENOM)
        write_u32(sw, _QUANT_DC_DIST, 1)
        sw.write(1, 1)                      # BlockCtxMap default
        # no-op CfL map (base_correlation_b must be 0, not the default 1):
        # chroma_from_luma.cc EncodeDC non-default path.
        sw.write(1, 0)
        write_u32(sw, _COLOR_FACTOR_DIST, K_DEFAULT_COLOR_FACTOR)
        write_f16(sw, 0.0)                  # base_correlation_x
        write_f16(sw, 0.0)                  # base_correlation_b
        sw.write(8, 128)                    # ytox_dc + 128
        sw.write(8, 128)                    # ytob_dc + 128
        sw.write(1, 0)                      # has_global_tree = false

    def dc_group(sw: BitWriter, g: int) -> None:
        gx = g % fd.xsize_dc_groups
        gy = g // fd.xsize_dc_groups
        x0, y0 = gx * fd.group_dim, gy * fd.group_dim   # in blocks
        bwd = min(fd.group_dim, xb - x0)
        bhd = min(fd.group_dim, yb - y0)
        sw.write(2, 0)                      # extra_precision = 0
        img = ModularImage(bwd, bhd, 32)
        for src_c in (1, 0, 2):             # stream order [Y, X, B]
            yc, xc = y0 >> vs[src_c], x0 >> hs[src_c]
            img.channel.append(Channel(
                dc_q[src_c][yc:yc + (bhd >> vs[src_c]),
                            xc:xc + (bwd >> hs[src_c])].copy()))
        modular_encode(sw, img, group_id=1 + g,
                       tree=[TreeNode(-1, 0, 0, 0, PREDICTOR_GRADIENT, 0, 1)])
        # Modular DC group: no channels. AC metadata: all DCT8, qf=1.
        upper = bwd * bhd
        sw.write((upper - 1).bit_length() if upper > 1 else 0, upper - 1)
        cw = (bwd + 7) >> 3
        chh = (bhd + 7) >> 3
        am = ModularImage(bwd, bhd, 32)
        am.channel.append(Channel(np.zeros((chh, cw), np.int32), 3, 3))
        am.channel.append(Channel(np.zeros((chh, cw), np.int32), 3, 3))
        acs_qf = np.zeros((2, upper), np.int32)   # DCT8 strategy, qf-1 = 0
        am.channel.append(Channel(acs_qf))
        am.channel.append(Channel(np.zeros((bhd, bwd), np.int32)))
        modular_encode(sw, am, group_id=1 + 2 * fd.num_dc_groups + g,
                       tree=[TreeNode(-1, 0, 0, 0, PREDICTOR_ZERO, 0, 1)])

    def ac_global(sw: BitWriter) -> None:
        sw.write(1, 0)                      # dequant matrices NOT default
        # table 0 (DCT8): RAW mode (quant_weights.cc kQuantModeRAW)
        sw.write(3, 7)
        write_f16(sw, K_QTABLE_DEN, exact=False)
        qimg = ModularImage(8, 8, 8)
        for c in range(3):
            qimg.channel.append(Channel(qt_stored[c].reshape(8, 8).copy()))
        modular_encode(sw, qimg, group_id=stream_id_quant_table(fd, 0),
                       tree=[TreeNode(-1, 0, 0, 0, PREDICTOR_GRADIENT, 0,
                                      1)])
        for _ in range(1, 17):
            sw.write(3, 0)                  # Library(0); 0 predefined bits
        nbits = max((fd.num_groups - 1).bit_length(), 0)
        if nbits:
            sw.write(nbits, 0)              # num_histograms - 1 = 0
        write_u32(sw, K_ORDER_ENC, 0)       # used_orders = 0 (natural)
        write_entropy_codes(sw, codes)

    def ac_group(sw: BitWriter, g: int) -> None:
        arr = tokens_to_array(group_tokens[g]) if group_tokens[g] else \
            np.zeros((0, 2), np.int64)
        write_tokens(sw, arr, codes)

    def section(*parts) -> bytes:
        sw = BitWriter()
        for fn in parts:
            fn(sw)
        sw.zero_pad_to_byte()
        return sw.to_bytes()

    if fd.num_groups == 1:
        sections = [section(dc_global, lambda sw: dc_group(sw, 0),
                            ac_global, lambda sw: ac_group(sw, 0))]
    else:
        sections = [section(dc_global)]
        for g in range(fd.num_dc_groups):
            sections.append(section(lambda sw, g=g: dc_group(sw, g)))
        sections.append(section(ac_global))
        for g in range(fd.num_groups):
            sections.append(section(lambda sw, g=g: ac_group(sw, g)))

    write_toc(bw, [len(s) for s in sections])
    out = bytearray(bw.to_bytes())
    for s in sections:
        out.extend(s)
    return bytes(out)


def _quant_table_index(jd: JPEGData, quant_idx: int) -> int:
    """Map a component's DQT slot id to the jd.quant list position."""
    for i, qt in enumerate(jd.quant):
        if qt.index == quant_idx:
            return i
    raise FormatError(f"missing quant table {quant_idx}")


# ---------------------------------------------------------------------------
# High-level encode / decode
# ---------------------------------------------------------------------------

def encode_jpeg(jpeg_bytes: bytes) -> bytes:
    """Losslessly recompress a .jpg into a JXL container (jbrd + jxlc).

    The original JPEG file is reproducible byte-exactly via
    :func:`decode_to_jpeg`."""
    from libjxl_torch.api.container import wrap_container
    from libjxl_torch.jpeg.jbrd import serialize_jbrd
    from libjxl_torch.jpeg.reader import parse_jpeg

    jd = parse_jpeg(jpeg_bytes)
    cs = jpeg_data_to_codestream(jd)
    jbrd = serialize_jbrd(jd)
    return wrap_container(cs, extra_boxes=[(b"jbrd", jbrd)])


def decode_to_jpeg(data: bytes) -> bytes:
    """Reconstruct the original .jpg from a JXL container with a jbrd box."""
    from libjxl_torch.api.codestream import parse_codestream
    from libjxl_torch.api.container import extract_codestream, parse_boxes
    from libjxl_torch.jpeg.jbrd import parse_jbrd
    from libjxl_torch.jpeg.writer import write_jpeg

    jbrd_payload = None
    for box in parse_boxes(data[:0] if data[:2] == b"\xff\x0a" else data):
        if box.type == b"jbrd":
            jbrd_payload = box.data
    if jbrd_payload is None:
        raise FormatError("no jbrd box: not a recompressed JPEG")
    jd = parse_jbrd(jbrd_payload)

    meta, frames = parse_codestream(extract_codestream(data))
    frame = frames[-1]
    fh = frame.header
    if fh.encoding != FrameEncoding.VARDCT:
        raise FormatError("cannot output JPEG from a Modular frame")
    if meta.m.xyb_encoded:
        raise FormatError("cannot decode an XYB image to JPEG")
    from libjxl_torch.vardct.frame_dec import VarDCTFrameDecoder
    fd = frame.dims
    dec = VarDCTFrameDecoder(fh, meta.m, fd)
    dec.jpeg_mode = True
    dec.jpeg_coeffs = [
        np.zeros((fd.ysize_blocks >> dec.vs[c],
                  fd.xsize_blocks >> dec.hs[c], 64), dtype=np.int32)
        for c in range(3)]
    from libjxl_torch.core.toc import ac_group_index
    from libjxl_torch.utils.bits import BitReader
    if len(frame.sections) == 1:
        r = BitReader(frame.sections[0])
        dec.decode_dc_global(r)
        dec.decode_dc_group(r, 0)
        dec.finalize_dc()
        dec.decode_ac_global(r)
        dec.decode_ac_group([r], 0, fh.passes.num_passes)
    else:
        r = BitReader(frame.sections[0])
        dec.decode_dc_global(r)
        for g in range(fd.num_dc_groups):
            dec.decode_dc_group(BitReader(frame.sections[1 + g]), g)
        dec.finalize_dc()
        dec.decode_ac_global(BitReader(frame.sections[1 + fd.num_dc_groups]))
        for g in range(fd.num_groups):
            readers = [BitReader(frame.sections[ac_group_index(
                p, g, fd.num_groups, fd.num_dc_groups)])
                for p in range(fh.passes.num_passes)]
            dec.decode_ac_group(readers, g, fh.passes.num_passes)

    _fill_jpeg_coefficients(jd, dec, meta, fh, fd)
    return write_jpeg(jd)


def _fill_jpeg_coefficients(jd: JPEGData, dec, meta, fh,
                            fd: FrameDimensions) -> None:
    """dec_frame.cc:222-252 + dec_group.cc:225-430 (jpeg path)."""
    is_gray = len(jd.components) == 1
    jmap = _jpeg_order(fh.color_transform, is_gray)
    if not getattr(dec.matrices, "raw_qtables", None) or \
            0 not in dec.matrices.raw_qtables:
        raise FormatError("quantization table is not a JPEG table")
    den, qtable = dec.matrices.raw_qtables[0]     # qtable: (3, 8, 8) stored
    if abs(den - K_QTABLE_DEN) > 1e-8:
        raise FormatError("quantization table is not a JPEG table")
    qt = qtable.reshape(3, 64).astype(np.int64)

    jd.width, jd.height = meta.xsize, meta.ysize
    xb, yb = fd.xsize_blocks, fd.ysize_blocks
    cs = fh.chroma_subsampling

    # restore DQT values from the RAW table (stored layout -> natural)
    for i, qtab in enumerate(jd.quant):
        c = next(cc for cc in range(3)
                 if jd.components[jmap[cc]].quant_idx == qtab.index)
        qtab.values = qtable[c].T.reshape(64).astype(np.int32)

    dczero = fh.color_transform == ColorTransform.YCBCR
    cfl_any = (cs.is_444 and
               (np.any(dec.ytox_map) or np.any(dec.ytob_map)))
    # scaled_qtable in natural order (dec_group.cc:250-259)
    scaled_qt = ((1 << K_CFL_FIXED_POINT_PRECISION) * qt[1][None, :] //
                 qt).reshape(3, 8, 8).transpose(0, 2, 1).reshape(3, 64)

    for c in range(3):
        if is_gray and c != 1:
            continue
        comp = jd.components[jmap[c]]
        xbc, ybc = xb >> dec.hs[c], yb >> dec.vs[c]
        comp.h_samp_factor = 1 << (cs.max_hshift - dec.hs[c])
        comp.v_samp_factor = 1 << (cs.max_vshift - dec.vs[c])
        comp.width_in_blocks = xbc
        comp.height_in_blocks = ybc
        stored = dec.jpeg_coeffs[c]                     # (ybc, xbc, 64)
        nat = stored.reshape(ybc, xbc, 8, 8).transpose(0, 1, 3, 2)
        nat = nat.reshape(ybc, xbc, 64)
        if cfl_any and c != 1 and not is_gray:
            y_nat = dec.jpeg_coeffs[1].reshape(yb, xb, 8, 8) \
                .transpose(0, 1, 3, 2).reshape(yb, xb, 64).astype(np.int64)
            cmap = dec.ytox_map if c == 0 else dec.ytob_map
            # expand tile map to blocks
            factors = np.repeat(np.repeat(cmap, K_COLOR_TILE_DIM_IN_BLOCKS,
                                          axis=0),
                                K_COLOR_TILE_DIM_IN_BLOCKS, axis=1)
            factors = factors[:yb, :xb].astype(np.int64)
            # RatioJPEG: trunc division (C integer semantics)
            scale = ((factors * (1 << K_CFL_FIXED_POINT_PRECISION)) /
                     K_DEFAULT_COLOR_FACTOR).astype(np.int64)
            half = 1 << (K_CFL_FIXED_POINT_PRECISION - 1)
            coeff_scale = (scale[:, :, None] * scaled_qt[c][None, None] +
                           half) >> K_CFL_FIXED_POINT_PRECISION
            cfl_factor = (y_nat * coeff_scale + half) >> \
                K_CFL_FIXED_POINT_PRECISION
            nat = nat + cfl_factor.astype(np.int32)
        # DC from the (integer, unsmoothed) DC stream
        dcoff = 0 if dczero else 1024 // int(qt[c][0])
        dc = np.round(dec.dc[c]).astype(np.int64) - dcoff
        nat[:, :, 0] = dc
        if np.any(nat > 2047) or np.any(nat < -2047):
            raise FormatError("JPEG DCT coefficients out of range")
        comp.coeffs = nat.reshape(-1, 64)[:, _ZZ2NAT].astype(np.int16)
