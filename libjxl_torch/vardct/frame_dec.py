"""VarDCT frame decoder: sections -> XYB image
(reference ``lib/jxl/dec_frame.cc``, ``lib/jxl/dec_group.cc``,
``lib/jxl/dec_modular.cc:429-560``)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from libjxl_torch.core.fields import (
    BitsOffset, FormatError, U32Enc, read_u32, Val,
)
from libjxl_torch.core.frame_header import FrameFlags, FrameHeader
from libjxl_torch.core.geometry import FrameDimensions, cdiv
from libjxl_torch.core.headers import unpack_signed
from libjxl_torch.entropy.ans import ANSSymbolReader, decode_histograms
from libjxl_torch.modular.codec import ModularOptions, modular_decode
from libjxl_torch.modular.frame import (
    ModularFrameDecoder, stream_id_ac_metadata, stream_id_vardct_dc,
)
from libjxl_torch.modular.image import Channel, ModularImage
from libjxl_torch.utils.bits import BitReader
from libjxl_torch.vardct.ac_context import BlockCtxMap, zero_density_context
from libjxl_torch.vardct.ac_strategy import (
    COVERED_X, COVERED_Y, LOG2_COVERED, NUM_STRATEGIES, STRATEGY_ORDER,
)
from libjxl_torch.vardct.cfl import (
    ColorCorrelation, K_COLOR_TILE_DIM_IN_BLOCKS,
)
from libjxl_torch.vardct.coeff_order import decode_coeff_orders, \
    read_used_orders
from libjxl_torch.vardct.dct import (
    coeffs_stored_to_rc, idct2d, llf_from_dc,
)
from libjxl_torch.vardct.quant_weights import DequantMatrices

K_GLOBAL_SCALE_DENOM = 1 << 16
K_QUANT_MAX = 256
# kDefaultQuantBias (quantizer.h:52-57)
K_BIASES = (1.0 - 0.05465007330715401, 1.0 - 0.07005449891748593,
            1.0 - 0.049935103337343655, 0.145)

_GLOBAL_SCALE_DIST = U32Enc(BitsOffset(11, 1), BitsOffset(11, 2049),
                            BitsOffset(12, 4097), BitsOffset(16, 8193))
_QUANT_DC_DIST = U32Enc(Val(16), BitsOffset(5, 1), BitsOffset(8, 1),
                        BitsOffset(16, 1))


@dataclass
class Quantizer:
    global_scale: int = 1
    quant_dc: int = 1

    def read(self, r: BitReader) -> None:
        self.global_scale = read_u32(r, _GLOBAL_SCALE_DIST)
        self.quant_dc = read_u32(r, _QUANT_DC_DIST)

    @property
    def inv_global_scale(self) -> float:
        return 1.0 * K_GLOBAL_SCALE_DENOM / self.global_scale

    @property
    def scale(self) -> float:
        return self.global_scale / K_GLOBAL_SCALE_DENOM

    def mul_dc(self, dc_quant) -> tuple:
        inv_quant_dc = self.inv_global_scale / self.quant_dc
        return tuple(inv_quant_dc * q for q in dc_quant)


def adjust_quant_bias(q: np.ndarray, c: int) -> np.ndarray:
    """(quantizer-inl.h:35-60): 0 -> 0, +-1 -> +-bias_c,
    else q - bias3/q."""
    q = q.astype(np.float32)
    absq = np.abs(q)
    out = q - K_BIASES[3] / np.where(q == 0, 1.0, q)
    out = np.where(absq < 0.5, 0.0, out)
    out = np.where((absq > 0.5) & (absq < 1.5), np.sign(q) * K_BIASES[c],
                   out)
    return out


class VarDCTFrameDecoder:
    def __init__(self, fh: FrameHeader, metadata, dims: FrameDimensions):
        self.fh = fh
        self.meta = metadata
        self.fd = dims
        cs = fh.chroma_subsampling
        self.is_444 = cs.is_444
        self.hs = tuple(cs.hshift(c) for c in range(3))
        self.vs = tuple(cs.vshift(c) for c in range(3))
        self.quantizer = Quantizer()
        self.matrices = DequantMatrices()
        self.bctx = BlockCtxMap()
        self.cmap = ColorCorrelation()
        self.mfd = ModularFrameDecoder(fh, metadata, dims)
        xb, yb = dims.xsize_blocks, dims.ysize_blocks
        self.acs_raw = np.full((yb, xb), -1, dtype=np.int32)
        self.acs_anchor = np.zeros((yb, xb), dtype=bool)
        self.raw_quant = np.ones((yb, xb), dtype=np.int32)
        self.epf_sharpness = np.zeros((yb, xb), dtype=np.int32)
        self.quant_dc_idx = np.zeros((yb, xb), dtype=np.int32)
        if self.is_444:
            self.dc = np.zeros((3, yb, xb), dtype=np.float32)
        else:
            self.dc = [np.zeros((yb >> self.vs[c], xb >> self.hs[c]),
                                dtype=np.float32) for c in range(3)]
            # per-channel pixel planes at the subsampled resolutions
            self.pixels_c = [np.zeros(((yb >> self.vs[c]) * 8,
                                       (xb >> self.hs[c]) * 8),
                                      dtype=np.float32) for c in range(3)]
        tx = cdiv(xb, K_COLOR_TILE_DIM_IN_BLOCKS)
        ty = cdiv(yb, K_COLOR_TILE_DIM_IN_BLOCKS)
        self.ytox_map = np.zeros((ty, tx), dtype=np.int32)
        self.ytob_map = np.zeros((ty, tx), dtype=np.int32)
        self.pixels = np.zeros((3, yb * 8, xb * 8), dtype=np.float32)
        # banded (low-memory) mode: the driver replaces self.pixels with
        # a window buffer and sets pixel_row0 to the absolute pixel row
        # of buffer row 0 (low_memory_render_pipeline.cc model)
        self.pixel_row0 = 0
        self.num_histograms = 1
        self.coeff_orders = [None] * fh.passes.num_passes  # per pass
        self.codes = [None] * fh.passes.num_passes
        self.used_acs = 0
        # JPEG-reconstruction mode (dec_frame.cc:74, dec_group.cc:364-430):
        # DC stays undequantized and qblock integers are collected.
        self.jpeg_mode = False
        self.jpeg_coeffs = None

    # ---- DC global --------------------------------------------------------

    def decode_dc_global(self, r: BitReader) -> None:
        fh = self.fh
        if fh.flags & FrameFlags.PATCHES:
            from libjxl_torch.render.patches import decode_patches
            self.patches = decode_patches(
                r, self.fd.xsize_padded, self.fd.ysize_padded,
                self.meta.num_extra_channels,
                getattr(self, "reference_frames", [None] * 4))
        if fh.flags & FrameFlags.SPLINES:
            from libjxl_torch.render.splines import decode_splines
            self.splines = decode_splines(r, self.fd.xsize * self.fd.ysize)
        if fh.flags & FrameFlags.NOISE:
            from libjxl_torch.render.noise import decode_noise
            self.noise_lut = decode_noise(r)
        self.matrices.decode_dc(r)
        self.quantizer.read(r)
        self.bctx.read(r)
        self.cmap.decode_dc(r)
        self.mfd.decode_global_info(r)

    # ---- DC group ---------------------------------------------------------

    def decode_dc_group(self, r: BitReader, group_id: int) -> None:
        """(dec_modular.cc DecodeVarDCTDC + group + DecodeAcMetadata)."""
        fd = self.fd
        gx = group_id % fd.xsize_dc_groups
        gy = group_id // fd.xsize_dc_groups
        x0 = gx * fd.group_dim      # in blocks
        y0 = gy * fd.group_dim
        bw = min(fd.group_dim, fd.xsize_blocks - x0)
        bh = min(fd.group_dim, fd.ysize_blocks - y0)

        if not (self.fh.flags & FrameFlags.USE_DC_FRAME):
            extra_precision = r.read(2)
            mul = 1.0 / (1 << extra_precision)
            img = ModularImage(bw, bh, 32)
            # stream channel order [Y, X, B], per-channel subsampled dims
            # (dec_modular.cc:447-452)
            for c in (1, 0, 2):
                img.channel.append(Channel.create(bw >> self.hs[c],
                                                  bh >> self.vs[c]))
            modular_decode(r, img, group_id=stream_id_vardct_dc(fd, group_id),
                           options=ModularOptions(),
                           global_tree=self.mfd.tree,
                           global_code=self.mfd.code,
                           undo_transforms=True)
            # jpeg mode: ClearDCMul() — DC is not dequantized.
            dc_factors = (1.0, 1.0, 1.0) if self.jpeg_mode else \
                self.quantizer.mul_dc(self.matrices.dc_quant)
            cfl_x, _, cfl_b = self.cmap.dc_factors()
            qy = img.channel[0].plane.astype(np.float32)
            qx = img.channel[1].plane.astype(np.float32)
            qb = img.channel[2].plane.astype(np.float32)
            dcy = qy * (dc_factors[1] * mul)
            dcx = qx * (dc_factors[0] * mul)
            dcb = qb * (dc_factors[2] * mul)
            if self.is_444:   # CfL-DC only without subsampling
                dcx = dcx + cfl_x * dcy
                dcb = dcb + cfl_b * dcy
            for c, dcp in ((0, dcx), (1, dcy), (2, dcb)):
                yc, xc = y0 >> self.vs[c], x0 >> self.hs[c]
                self.dc[c][yc:yc + dcp.shape[0],
                           xc:xc + dcp.shape[1]] = dcp
            # dc context buckets (compressed_dc.cc:252-293)
            if self.bctx.num_dc_ctxs > 1:
                qxp = img.channel[1].plane
                qyp = img.channel[0].plane
                qbp = img.channel[2].plane
                for yy in range(bh):
                    for xx in range(bw):
                        self.quant_dc_idx[y0 + yy, x0 + xx] = \
                            self.bctx.dc_context(qxp[yy, xx], qyp[yy, xx],
                                                 qbp[yy, xx])

        # Modular DC group (channels with shift >= 3)
        self.mfd.decode_group(r, (x0 * 8, y0 * 8, fd.dc_group_dim,
                                  fd.dc_group_dim), 3, 1000,
                              _mdc_stream_id(fd, group_id))
        self._decode_ac_metadata(r, group_id, x0, y0, bw, bh)

    def _decode_ac_metadata(self, r: BitReader, group_id: int, x0, y0,
                            bw, bh) -> None:
        upper = bw * bh
        count = r.read((upper - 1).bit_length() if upper > 1 else 0) + 1
        cw = (bw + 7) >> 3
        ch_ = (bh + 7) >> 3
        img = ModularImage(bw, bh, 32)
        img.channel.append(Channel.create(cw, ch_, 3, 3))   # ytox
        img.channel.append(Channel.create(cw, ch_, 3, 3))   # ytob
        img.channel.append(Channel.create(count, 2, 0, 0))  # acs + qf
        img.channel.append(Channel.create(bw, bh, 0, 0))    # epf sharpness
        modular_decode(r, img, group_id=stream_id_ac_metadata(self.fd,
                                                              group_id),
                       options=ModularOptions(),
                       global_tree=self.mfd.tree, global_code=self.mfd.code,
                       undo_transforms=True)
        tx0 = x0 >> 3
        ty0 = y0 >> 3
        self.ytox_map[ty0:ty0 + ch_, tx0:tx0 + cw] = img.channel[0].plane
        self.ytob_map[ty0:ty0 + ch_, tx0:tx0 + cw] = img.channel[1].plane
        acs_vals = img.channel[2].plane[0]
        qf_vals = img.channel[2].plane[1]
        sharp = img.channel[3].plane
        if self._acs_paint_native(acs_vals, qf_vals, count, sharp,
                                  x0, y0, bw, bh):
            return
        num = 0
        for iy in range(bh):
            for ix in range(bw):
                y, x = y0 + iy, x0 + ix
                s = int(sharp[iy, ix])
                if not (0 <= s < 8):
                    raise FormatError("corrupt sharpness")
                self.epf_sharpness[y, x] = s
                if self.acs_raw[y, x] >= 0:
                    continue
                if num >= count:
                    raise FormatError("corrupt AC metadata")
                raw = int(acs_vals[num])
                if not (0 <= raw < NUM_STRATEGIES):
                    raise FormatError("invalid AC strategy")
                cx, cy = COVERED_X[raw], COVERED_Y[raw]
                gdb = self.fd.group_dim // 8
                if (x % gdb) + cx > gdb or (y % gdb) + cy > gdb:
                    raise FormatError("AC strategy crosses group boundary")
                qf = 1 + max(0, min(K_QUANT_MAX - 1, int(qf_vals[num])))
                self.acs_raw[y:y + cy, x:x + cx] = raw
                self.raw_quant[y:y + cy, x:x + cx] = qf
                self.acs_anchor[y, x] = True
                self.used_acs |= 1 << raw
                num += 1

    def _acs_paint_native(self, acs_vals, qf_vals, count, sharp,
                          x0, y0, bw, bh) -> bool:
        """Native raster paint of acs/qf/sharpness (matches the
        reference's xlim/ylim overflow checks, dec_modular.cc:515-555)."""
        from libjxl_torch.utils import native
        from libjxl_torch.vardct.ac_strategy import COVERED_X, COVERED_Y
        lib = native.get_lib()
        if lib is None:
            return False
        if not hasattr(lib, "jxlt_acs_paint_bound"):
            import ctypes
            lib.jxlt_acs_paint.restype = ctypes.c_int64
            lib.jxlt_acs_paint.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p]
            lib.jxlt_acs_paint_bound = True
        acs_vals = np.ascontiguousarray(acs_vals, np.int32)
        qf_vals = np.ascontiguousarray(qf_vals, np.int32)
        sharp = np.ascontiguousarray(sharp, np.int32)
        acs_loc = np.ascontiguousarray(
            self.acs_raw[y0:y0 + bh, x0:x0 + bw], np.int32)
        qf_loc = np.ascontiguousarray(
            self.raw_quant[y0:y0 + bh, x0:x0 + bw], np.int32)
        anc_loc = np.zeros((bh, bw), np.uint8)
        shp_loc = np.zeros((bh, bw), np.int32)
        cov_x = np.asarray(COVERED_X, np.uint8)
        cov_y = np.asarray(COVERED_Y, np.uint8)
        num = lib.jxlt_acs_paint(
            acs_vals.ctypes.data, qf_vals.ctypes.data, count,
            sharp.ctypes.data, bw, bh, self.fd.group_dim // 8,
            cov_x.ctypes.data, cov_y.ctypes.data, acs_loc.ctypes.data,
            qf_loc.ctypes.data, anc_loc.ctypes.data, shp_loc.ctypes.data)
        if num < 0:
            raise FormatError("corrupt AC metadata")
        for raw in np.unique(acs_vals[:num]):
            self.used_acs |= 1 << int(raw)
        self.acs_raw[y0:y0 + bh, x0:x0 + bw] = acs_loc
        self.raw_quant[y0:y0 + bh, x0:x0 + bw] = qf_loc
        self.epf_sharpness[y0:y0 + bh, x0:x0 + bw] = shp_loc
        self.acs_anchor[y0:y0 + bh, x0:x0 + bw] |= anc_loc.astype(bool)
        return True

    # ---- DC finalize ------------------------------------------------------

    def finalize_dc(self) -> None:
        fh = self.fh
        if (fh.flags & FrameFlags.SKIP_ADAPTIVE_DC_SMOOTHING) or \
                (fh.flags & FrameFlags.USE_DC_FRAME) or not self.is_444:
            return
        self.dc = adaptive_dc_smoothing(
            self.dc, self.quantizer.mul_dc(self.matrices.dc_quant))

    # ---- AC global --------------------------------------------------------

    def decode_ac_global(self, r: BitReader) -> None:
        self.matrices.decode(r, self.mfd)
        num_histo_bits = max((self.fd.num_groups - 1).bit_length(), 0)
        self.num_histograms = 1 + (r.read(num_histo_bits)
                                   if num_histo_bits else r.read(0))
        for i in range(self.fh.passes.num_passes):
            used_orders = read_used_orders(r)
            self.coeff_orders[i] = decode_coeff_orders(r, used_orders,
                                                       self.used_acs)
            num_contexts = self.num_histograms * self.bctx.num_ac_contexts()
            self.codes[i] = decode_histograms(r, num_contexts)

    # ---- AC group: native fast path --------------------------------------

    def _flat_code_tables(self, p: int):
        """Flatten pass-p ANS tables for the native decoder (cached)."""
        if not hasattr(self, "_flat_cache"):
            self._flat_cache = {}
        if p in self._flat_cache:
            return self._flat_cache[p]
        code = self.codes[p]
        nh = len(code.alias_symbols)
        alias_sym = np.ascontiguousarray(
            np.stack([np.asarray(a, np.int32) for a in code.alias_symbols]))
        alias_off = np.ascontiguousarray(
            np.stack([np.asarray(a, np.int32) for a in code.alias_offsets]))
        freqs = np.zeros((nh, 256), np.int32)
        for i, f in enumerate(code.alias_freqs):
            f = np.asarray(f, np.int32)
            freqs[i, :len(f)] = f
        cfgs = np.array([[c.split_exponent, c.msb_in_token, c.lsb_in_token]
                         for c in code.uint_configs], np.int32)
        ctx_map = np.ascontiguousarray(code.context_map, dtype=np.int32)
        res = (alias_sym, alias_off, freqs, cfgs, ctx_map)
        self._flat_cache[p] = res
        return res

    def _flat_orders(self, p: int):
        if not hasattr(self, "_ord_cache"):
            self._ord_cache = {}
        if p in self._ord_cache:
            return self._ord_cache[p]
        parts = []
        offs = np.zeros(13 * 3, np.int64)
        pos = 0
        for (ordb, c), arr in self.coeff_orders[p].items():
            offs[ordb * 3 + c] = pos
            parts.append(np.asarray(arr, np.int32))
            pos += len(parts[-1])
        flat = (np.concatenate(parts) if parts
                else np.zeros(1, np.int32))
        res = (np.ascontiguousarray(flat), offs)
        self._ord_cache[p] = res
        return res

    def _block_ctx3(self, bx0, by0, w_, h_):
        """Vectorized BlockCtxMap.context for every block of the group."""
        from libjxl_torch.vardct.ac_strategy import STRATEGY_ORDER
        bctx = self.bctx
        acs = np.maximum(self.acs_raw[by0:by0 + h_, bx0:bx0 + w_], 0)
        ordb = np.asarray(STRATEGY_ORDER, np.int32)[acs]
        qf = self.raw_quant[by0:by0 + h_, bx0:bx0 + w_]
        qf_idx = np.zeros_like(qf)
        for t in bctx.qf_thresholds:
            qf_idx += (qf > t).astype(np.int32)
        dc_idx = self.quant_dc_idx[by0:by0 + h_, bx0:bx0 + w_]
        nqf = len(bctx.qf_thresholds) + 1
        cmap_np = np.asarray(bctx.ctx_map, np.int32)
        out = np.empty((3, h_, w_), np.int32)
        for c in range(3):
            idx = (c ^ 1) if c < 2 else 2
            idx = (idx * 13 + ordb) * nqf + qf_idx
            idx = idx * bctx.num_dc_ctxs + dc_idx
            out[c] = cmap_np[idx]
        return np.ascontiguousarray(out)

    def decode_ac_frame_native(self, sections: dict, n_threads: int = 0,
                               dense_buf: np.ndarray | None = None,
                               sparse: bool = False, planes=None):
        """Decode ALL single-pass AC group sections concurrently in ONE
        native call (std::threads inside — the dec_frame.cc:726
        RunOnPool-over-groups analog without per-group Python/GIL cost).

        ``sections`` maps group_id -> (bytes, start_bit). Returns
        {group_id: (bx0, by0, w, h, acs, anchors, coeffs)} with the same
        per-group run-packed coefficient layout as
        :meth:`_decode_ac_group_native`, or None when the stream shape
        needs another path (prefix codes, LZ77, subsampling).

        ``dense_buf``: for all-8x8 streams, a zeroed (3, fhb, fwb, 64)
        int32 frame buffer the decoder fills in place (no per-group
        copy); per-group coeffs in the result are then views of it.

        ``planes``: for a subsampled all-DCT8 frame (a recompressed
        JPEG's), the three int16 coefficient planes of
        ``utils.host_stage.ac_decode_subsampled``, which decodes into
        them and returns them (None where it cannot); without them such
        a frame gets None."""
        import ctypes

        from libjxl_torch.utils import native
        from libjxl_torch.vardct.ac_strategy import (
            COVERED_X, COVERED_Y, LOG2_COVERED, STRATEGY_ORDER,
        )
        if not native.available():
            return None
        if not self.is_444:
            if planes is None:
                return None
            from libjxl_torch.utils.host_stage import ac_decode_subsampled
            return ac_decode_subsampled(self, sections, planes, n_threads)
        code = self.codes[0]
        if code.use_prefix_code or code.lz77.enabled:
            return None
        lib = native.get_lib()
        if not hasattr(lib, "jxlt_ac_frame_decode_bound"):
            P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            lib.jxlt_ac_frame_decode.restype = I64
            lib.jxlt_ac_frame_decode.argtypes = (
                [P, P, P, P, I64, P, P, P, P] +       # data, secs, rects
                [P, P, P, P, P, I64, I32, I32, I32] +  # tables, selector
                [P, I64, I64, P, P, P, P, P, P, P, P] +  # frame planes
                [I32, I32, I32, P, P, I32, I32, P] +   # flags, out
                [I32, I64, I64] +                      # dense mode
                [P, P, I64, P])                        # sparse mode
            lib.jxlt_ac_frame_decode_bound = True

        fd = self.fd
        fwb, fhb = fd.xsize_blocks, fd.ysize_blocks
        gids = sorted(sections)
        n = len(gids)
        rects = []
        gdb = fd.group_dim // 8
        for g in gids:
            gx, gy = g % fd.xsize_groups, g // fd.xsize_groups
            bx0, by0 = gx * gdb, gy * gdb
            rects.append((bx0, by0, min(gdb, fwb - bx0),
                          min(gdb, fhb - by0)))
        bufs = [np.frombuffer(sections[g][0], np.uint8) for g in gids]
        lens = np.array([len(b) for b in bufs], np.int64)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        data = np.empty(offs[-1], np.uint8)
        for i, b in enumerate(bufs):
            data[offs[i]:offs[i + 1]] = b
        start_bits = np.array([sections[g][1] for g in gids], np.int64)
        gx0 = np.array([r[0] for r in rects], np.int64)
        gy0 = np.array([r[1] for r in rects], np.int64)
        gw = np.array([r[2] for r in rects], np.int64)
        gh = np.array([r[3] for r in rects], np.int64)
        sp_idx = sp_val = sp_counts = None
        sp_cap = 0
        if sparse:
            # sparse emission: the decoder records (frame-dense flat
            # index, value) pairs as it reads tokens — no dense buffer,
            # no sparsify rescan. Capacity sized for d>=0.5-class
            # streams; overflow (-5) falls back to the dense path.
            out = np.zeros(1, np.int32)
            out_cstride = fhb * fwb * 64
            out_rstride = fwb * 64
            out_off = gy0 * out_rstride + gx0 * 64
            dense = 1
            sp_cap = int(3 * gw.max() * gh.max() * 10)
            sp_idx = np.empty(n * sp_cap, np.int32)
            sp_val = np.empty(n * sp_cap, np.int32)
            sp_counts = np.zeros(n, np.int64)
        elif dense_buf is not None:
            out = dense_buf
            out_cstride = fhb * fwb * 64
            out_rstride = fwb * 64
            out_off = gy0 * out_rstride + gx0 * 64
            dense = 1
        else:
            out_sizes = 3 * gw * gh * 64
            out_off = np.zeros(n + 1, np.int64)
            np.cumsum(out_sizes, out=out_off[1:])
            out = np.zeros(out_off[-1], np.int32)
            out_cstride = out_rstride = 0
            dense = 0
        end_bits = np.zeros(n, np.int64)

        acs_f = np.ascontiguousarray(self.acs_raw, np.int8)
        anchors_f = np.ascontiguousarray(self.acs_anchor, np.uint8)
        block_ctx3 = self._block_ctx3(0, 0, fwb, fhb)
        alias_sym, alias_off, freqs, cfgs, ctx_map = \
            self._flat_code_tables(0)
        orders, order_off = self._flat_orders(0)
        cov_x = np.asarray(COVERED_X, np.uint8)
        cov_y = np.asarray(COVERED_Y, np.uint8)
        l2cov = np.asarray(LOG2_COVERED, np.uint8)
        strat_ord = np.asarray(STRATEGY_ORDER, np.uint8)
        selector_bits = ((self.num_histograms - 1).bit_length()
                         if self.num_histograms > 1 else 0)
        shift = self.fh.passes.shift[0] if self.fh.passes.shift else 0
        if n_threads <= 0:
            import threading
            if threading.current_thread() is not threading.main_thread():
                # called from a stream-batch worker (decode_many /
                # serving): the outer pool already owns the cores —
                # nested std::thread fan-out thrashes (measured: 3
                # workers x 4 inner threads dropped the host entropy
                # stage from ~200 to 73 MP/s on a 4-core host)
                n_threads = 1
            else:
                n_threads = min(n, os.cpu_count() or 1)
        err = lib.jxlt_ac_frame_decode(
            data.ctypes.data, offs.ctypes.data, lens.ctypes.data,
            start_bits.ctypes.data, n, gx0.ctypes.data, gy0.ctypes.data,
            gw.ctypes.data, gh.ctypes.data, alias_sym.ctypes.data,
            alias_off.ctypes.data, freqs.ctypes.data, cfgs.ctypes.data,
            ctx_map.ctypes.data, len(ctx_map), selector_bits,
            self.num_histograms, self.bctx.num_ac_contexts(),
            block_ctx3.ctypes.data, fwb, fhb, acs_f.ctypes.data,
            anchors_f.ctypes.data, cov_x.ctypes.data, cov_y.ctypes.data,
            l2cov.ctypes.data, orders.ctypes.data, order_off.ctypes.data,
            strat_ord.ctypes.data, self.bctx.num_ctxs, 1, shift,
            out.ctypes.data, out_off.ctypes.data, 0, n_threads,
            end_bits.ctypes.data, dense, out_cstride, out_rstride,
            sp_idx.ctypes.data if sp_idx is not None else None,
            sp_val.ctypes.data if sp_val is not None else None,
            sp_cap,
            sp_counts.ctypes.data if sp_counts is not None else None)
        if sparse:
            if err == -5:
                return None          # capacity overflow: caller retries dense
            if err < 0:
                raise FormatError(f"AC frame native decode error {err}")
            total = int(sp_counts.sum())
            idx = np.empty(total, np.int32)
            vals = np.empty(total, np.int32)
            pos = 0
            for i in range(n):
                c = int(sp_counts[i])
                idx[pos:pos + c] = sp_idx[i * sp_cap:i * sp_cap + c]
                vals[pos:pos + c] = sp_val[i * sp_cap:i * sp_cap + c]
                pos += c
            return idx, vals
        if err < 0:
            raise FormatError(f"AC frame native decode error {err}")
        res = {}
        for i, g in enumerate(gids):
            bx0, by0, w_, h_ = rects[i]
            coeffs = (out[:, by0:by0 + h_, bx0:bx0 + w_] if dense
                      else out[out_off[i]:out_off[i + 1]].reshape(3, -1))
            res[g] = (bx0, by0, w_, h_,
                      acs_f[by0:by0 + h_, bx0:bx0 + w_],
                      anchors_f[by0:by0 + h_, bx0:bx0 + w_], coeffs)
        return res

    def _decode_ac_group_native(self, readers, group_id: int,
                                num_passes: int, bx0, by0,
                                xsize_blocks, ysize_blocks) -> bool:
        """Whole-section token decode in C++; batched reconstruction.
        Returns False if this stream shape needs the python path."""
        from libjxl_torch.utils import native
        from libjxl_torch.vardct.ac_strategy import (
            COVERED_X, COVERED_Y, LOG2_COVERED, STRATEGY_ORDER,
        )
        if not native.available() or not self.is_444:
            return False
        for p in range(num_passes):
            code = self.codes[p]
            if code.use_prefix_code or code.lz77.enabled:
                return False
        lib = native.get_lib()
        if not hasattr(lib, "jxlt_ac_group_decode_bound"):
            import ctypes
            lib.jxlt_ac_group_decode.restype = ctypes.c_int64
            lib.jxlt_ac_group_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_int32]
            lib.jxlt_ac_group_decode_bound = True

        w_, h_ = xsize_blocks, ysize_blocks
        acs = np.ascontiguousarray(
            self.acs_raw[by0:by0 + h_, bx0:bx0 + w_], np.int8)
        anchors = np.ascontiguousarray(
            self.acs_anchor[by0:by0 + h_, bx0:bx0 + w_], np.uint8)
        block_ctx3 = self._block_ctx3(bx0, by0, w_, h_)
        cov_x = np.asarray(COVERED_X, np.uint8)
        cov_y = np.asarray(COVERED_Y, np.uint8)
        l2cov = np.asarray(LOG2_COVERED, np.uint8)
        strat_ord = np.asarray(STRATEGY_ORDER, np.uint8)
        coeffs = np.zeros((3, h_ * w_ * 64), np.int32)
        selector_bits = ((self.num_histograms - 1).bit_length()
                         if self.num_histograms > 1 else 0)
        for p in range(num_passes):
            r = readers[p]
            sel = r.read(selector_bits) if selector_bits else 0
            if sel >= self.num_histograms:
                raise FormatError("invalid histogram selector")
            ctx_offset = sel * self.bctx.num_ac_contexts()
            alias_sym, alias_off, freqs, cfgs, ctx_map = \
                self._flat_code_tables(p)
            orders, order_off = self._flat_orders(p)
            shift = self.fh.passes.shift[p] if self.fh.passes.shift else 0
            data = np.frombuffer(r._data, dtype=np.uint8)
            end = lib.jxlt_ac_group_decode(
                data.ctypes.data, len(data), r.bits_consumed,
                alias_sym.ctypes.data, alias_off.ctypes.data,
                freqs.ctypes.data, cfgs.ctypes.data, ctx_map.ctypes.data,
                len(ctx_map), ctx_offset, block_ctx3.ctypes.data,
                acs.ctypes.data, anchors.ctypes.data,
                cov_x.ctypes.data, cov_y.ctypes.data, l2cov.ctypes.data,
                orders.ctypes.data, order_off.ctypes.data,
                strat_ord.ctypes.data, self.bctx.num_ctxs, w_, h_,
                1, shift, coeffs.ctypes.data, 1)
            if end < 0:
                raise FormatError(f"AC group native decode error {end}")
            r.skip(int(end) - r.bits_consumed)
        if getattr(self, "_collect_runs", None) is not None:
            # var-block device-reconstruction mode: keep the per-anchor
            # coefficient runs; models/vardct_decode.py batches them per
            # strategy class on device
            self._collect_runs.append((bx0, by0, w_, h_, acs.copy(),
                                       anchors.copy(), coeffs))
            return True
        if getattr(self, "_collect_coeffs", None) is not None:
            # device-reconstruction mode: stash raw quantized coefficients
            # (models/vardct_decode.py runs dequant+CfL+IDCT on TPU)
            self._collect_coeffs[:, by0:by0 + h_, bx0:bx0 + w_, :] = \
                coeffs.reshape(3, h_, w_, 64)
            return True
        self._reconstruct_group_batched(bx0, by0, w_, h_, acs, anchors,
                                        coeffs)
        return True

    def _reconstruct_group_batched(self, bx0, by0, w_, h_, acs, anchors,
                                   coeffs) -> None:
        """Vectorized dequant + CfL + LLF + IDCT over all anchors, one
        strategy class at a time (dec_group.cc:156-181 batched)."""
        from libjxl_torch.vardct.ac_strategy import COVERED_X, COVERED_Y
        from libjxl_torch.vardct.dct import (
            dct_matrix, idct_matrix, resample_scales,
        )
        anchors_b = anchors.astype(bool)
        sizes = np.where(
            anchors_b,
            np.asarray(COVERED_X)[np.maximum(acs, 0)].astype(np.int64) *
            np.asarray(COVERED_Y)[np.maximum(acs, 0)] * 64, 0)
        offs = np.concatenate([[0], np.cumsum(sizes.ravel())[:-1]]) \
            .reshape(h_, w_)
        if self.jpeg_mode:
            if (acs[anchors_b] != 0).any():
                raise FormatError(
                    "can only decode to JPEG if only DCT-8 is used")
            for c in range(3):
                q = coeffs[c].reshape(h_, w_, 64)
                self.jpeg_coeffs[c][by0:by0 + h_, bx0:bx0 + w_] = q
            return
        inv_gs = self.quantizer.inv_global_scale
        x_dm = (1 / 1.25) ** (self.fh.x_qm_scale - 2.0)
        b_dm = (1 / 1.25) ** (self.fh.b_qm_scale - 2.0)
        dms = (x_dm, 1.0, b_dm)
        quant_g = self.raw_quant[by0:by0 + h_, bx0:bx0 + w_]
        tdimb = K_COLOR_TILE_DIM_IN_BLOCKS
        for strat in np.unique(acs[anchors_b]):
            strat = int(strat)
            sel = anchors_b & (acs == strat)
            ys, xs = np.nonzero(sel)
            n = len(ys)
            cx, cy = COVERED_X[strat], COVERED_Y[strat]
            size = cx * cy * 64
            q = coeffs[:, offs[ys, xs][:, None] +
                       np.arange(size)[None, :]]        # (3, N, size)
            Y, X = by0 + ys, bx0 + xs
            scaled_dequant = inv_gs / quant_g[ys, xs]   # (N,)
            tflat = self.matrices.table_for_strategy(strat).reshape(3, -1)
            tx = X // tdimb
            ty = Y // tdimb
            x_cc = self.cmap.ytox_ratio_arr(self.ytox_map[ty, tx])
            b_cc = self.cmap.ytob_ratio_arr(self.ytob_map[ty, tx])
            dq = np.empty((3, n, size), np.float32)
            for c in range(3):
                dq[c] = adjust_quant_bias(q[c], c) * \
                    (tflat[c][None, :] * dms[c]) * \
                    scaled_dequant[:, None]
            dq[0] += x_cc[:, None] * dq[1]
            dq[2] += b_cc[:, None] * dq[1]
            if strat in (1, 2, 3, 12, 13, 14, 15, 16, 17):
                from libjxl_torch.vardct.transforms_small import \
                    special_to_pixels
                for i in range(n):
                    for c in range(3):
                        st = dq[c, i].reshape(8, 8).copy()
                        st[0, 0] = self.dc[c, Y[i], X[i]]
                        pix = special_to_pixels(strat, st)
                        yo = Y[i] * 8 - self.pixel_row0
                        self.pixels[c, yo:yo + 8,
                                    X[i] * 8:X[i] * 8 + 8] = pix
                continue
            mn, mx = min(cx, cy), max(cx, cy)
            stored = dq.reshape(3, n, mn * 8, mx * 8)
            # LLF from DC (batched, f32 matmul)
            ay = np.arange(cy)
            ax = np.arange(cx)
            dcb = self.dc[:, (Y[:, None, None] + ay[None, :, None]),
                          (X[:, None, None] + ax[None, None, :])]
            dmy = dct_matrix(cy).astype(np.float32)
            dmx = dct_matrix(cx).astype(np.float32)
            llf = dmy[None, None] @ dcb.astype(np.float32) @ dmx.T
            llf = llf / resample_scales(cy).astype(np.float32)[:, None] \
                      / resample_scales(cx).astype(np.float32)[None, :]
            llf_stored = llf.transpose(0, 1, 3, 2) if cy >= cx else llf
            stored[:, :, :llf_stored.shape[2], :llf_stored.shape[3]] = \
                llf_stored
            R, C = cy * 8, cx * 8
            rc = stored.transpose(0, 1, 3, 2) if R >= C else stored
            imy = idct_matrix(R).astype(np.float32)
            imx = idct_matrix(C).astype(np.float32)
            pix = imy[None, None] @ np.ascontiguousarray(rc) @ imx.T
            ry = np.arange(R)
            rx = np.arange(C)
            yy = (Y * 8 - self.pixel_row0)[:, None, None] \
                + ry[None, :, None]
            xx = (X * 8)[:, None, None] + rx[None, None, :]
            for c in range(3):
                self.pixels[c, yy, xx] = pix[c]

    # ---- AC group ---------------------------------------------------------

    def decode_ac_group(self, readers, group_id: int,
                        num_passes: int) -> None:
        fd = self.fd
        gx = group_id % fd.xsize_groups
        gy = group_id // fd.xsize_groups
        bx0 = gx * (fd.group_dim // 8)
        by0 = gy * (fd.group_dim // 8)
        xsize_blocks = min(fd.group_dim // 8, fd.xsize_blocks - bx0)
        ysize_blocks = min(fd.group_dim // 8, fd.ysize_blocks - by0)

        if self._decode_ac_group_native(readers, group_id, num_passes,
                                        bx0, by0, xsize_blocks,
                                        ysize_blocks):
            self._finish_ac_group_modular(readers, group_id, bx0, by0,
                                          num_passes)
            return

        selector_bits = ((self.num_histograms - 1).bit_length()
                         if self.num_histograms > 1 else 0)
        decoders = []
        ctx_offsets = []
        for p in range(num_passes):
            sel = readers[p].read(selector_bits) if selector_bits else 0
            if sel >= self.num_histograms:
                raise FormatError("invalid histogram selector")
            ctx_offsets.append(sel * self.bctx.num_ac_contexts())
            decoders.append(ANSSymbolReader(self.codes[p], readers[p]))

        # per-pass, per-channel nzeros images (subsampled group block dims)
        hs, vs = self.hs, self.vs
        nzeros = [[np.zeros((ysize_blocks >> vs[c], xsize_blocks >> hs[c]),
                            dtype=np.int32) for c in range(3)]
                  for _ in range(num_passes)]

        for by in range(ysize_blocks):
            ty = (by0 + by) // K_COLOR_TILE_DIM_IN_BLOCKS
            for bx in range(xsize_blocks):
                y, x = by0 + by, bx0 + bx
                if not self.acs_anchor[y, x]:
                    continue
                raw = int(self.acs_raw[y, x])
                if raw != 0 and not self.is_444:
                    raise FormatError(
                        "subsampled chroma requires DCT-8 only")
                cx, cy = COVERED_X[raw], COVERED_Y[raw]
                log2_cov = LOG2_COVERED[raw]
                covered = cx * cy
                size = covered * 64
                qblock = np.zeros((3, size), dtype=np.int64)
                for p in range(num_passes):
                    shift = self.fh.passes.shift[p] if \
                        self.fh.passes.shift else 0
                    for c in (1, 0, 2):
                        # subsampled chroma: code only aligned blocks
                        # (dec_group.cc:370-376)
                        if ((bx >> hs[c]) << hs[c] != bx or
                                (by >> vs[c]) << vs[c] != by):
                            continue
                        self._decode_ac_block(
                            readers[p], decoders[p], ctx_offsets[p],
                            self.coeff_orders[p], nzeros[p][c], c,
                            bx >> hs[c], by >> vs[c], x, y,
                            raw, covered, log2_cov, qblock[c], shift)
                self._reconstruct_block(x, y, raw, qblock, ty)
        for p in range(num_passes):
            if not decoders[p].check_final_state():
                raise FormatError("AC group ANS checksum failed")
        self._finish_ac_group_modular(readers, group_id, bx0, by0,
                                      num_passes)

    def _finish_ac_group_modular(self, readers, group_id, bx0, by0,
                                 num_passes) -> None:
        """Modular AC data (extra channels) follows the AC tokens
        (dec_frame.cc ProcessACGroup -> ModularFrameDecoder::DecodeGroup)."""
        fd = self.fd
        if self.mfd.full_image is not None and self.mfd.full_image.channel:
            from libjxl_torch.modular.frame import (
                get_downsampling_bracket, stream_id_modular_ac,
            )
            for p in range(num_passes):
                mins, maxs = get_downsampling_bracket(self.fh.passes, p)
                self.mfd.decode_group(
                    readers[p],
                    (bx0 * 8, by0 * 8, fd.group_dim, fd.group_dim),
                    mins, maxs, stream_id_modular_ac(fd, group_id, p))

    def _decode_ac_block(self, r, decoder, ctx_offset, orders, nz,
                         c, bx, by, x, y, raw, covered, log2_cov, qcoef,
                         shift) -> None:
        """(dec_group.cc DecodeACVarBlock:470-545). ``bx``/``by`` are
        channel-local (subsampled) coords; ``x``/``y`` luma-grid coords."""
        size = covered * 64
        if bx == 0:
            predicted = nz[by - 1, bx] if by > 0 else 32
        elif by == 0:
            predicted = nz[by, bx - 1]
        else:
            predicted = (nz[by - 1, bx] + nz[by, bx - 1] + 1) // 2
        ord_ = STRATEGY_ORDER[raw]
        order = orders[(ord_, c)]
        block_ctx = self.bctx.context(int(self.quant_dc_idx[y, x]),
                                      int(self.raw_quant[y, x]), ord_, c)
        nzero_ctx = self.bctx.nonzero_context(int(predicted), block_ctx) + \
            ctx_offset
        nzeros = decoder.read_hybrid_uint(nzero_ctx, r)
        if nzeros > size - covered:
            raise FormatError("invalid AC nzeros")
        cxv, cyv = COVERED_X[raw], COVERED_Y[raw]
        nz[by:by + cyv, bx:bx + cxv] = (nzeros + covered - 1) >> log2_cov
        histo_offset = ctx_offset + self.bctx.zero_density_offset(block_ctx)
        prev = 0 if nzeros > size // 16 else 1
        k = covered
        while k < size and nzeros != 0:
            ctx = histo_offset + zero_density_context(nzeros, k, covered,
                                                      log2_cov, prev)
            u = decoder.read_hybrid_uint(ctx, r)
            coeff = unpack_signed(u) << shift
            qcoef[order[k]] += coeff
            prev = 1 if u else 0
            nzeros -= prev
            k += 1
        if nzeros != 0:
            raise FormatError("invalid AC: trailing nzeros")

    def _reconstruct_block(self, x, y, raw, qblock, ty) -> None:
        """Dequant + CfL + LLF-from-DC + IDCT (dec_group.cc:156-181,452)."""
        if self.jpeg_mode:
            if raw != 0:
                raise FormatError(
                    "can only decode to JPEG if only DCT-8 is used")
            for c in range(3):
                if ((x >> self.hs[c]) << self.hs[c] != x or
                        (y >> self.vs[c]) << self.vs[c] != y):
                    continue
                self.jpeg_coeffs[c][y >> self.vs[c],
                                    x >> self.hs[c]] = qblock[c]
            return
        if not self.is_444:
            # DCT8-only (enforced in decode_ac_group): per-channel planes
            inv_gs = self.quantizer.inv_global_scale
            quant = int(self.raw_quant[y, x])
            scaled_dequant = inv_gs / quant
            x_dm = (1 / 1.25) ** (self.fh.x_qm_scale - 2.0)
            b_dm = (1 / 1.25) ** (self.fh.b_qm_scale - 2.0)
            dms = (x_dm, 1.0, b_dm)
            tflat = self.matrices.table_for_strategy(0).reshape(3, -1)
            for c in range(3):
                if ((x >> self.hs[c]) << self.hs[c] != x or
                        (y >> self.vs[c]) << self.vs[c] != y):
                    continue
                xc, yc = x >> self.hs[c], y >> self.vs[c]
                dq = adjust_quant_bias(qblock[c], c) * \
                    (tflat[c] * scaled_dequant * dms[c])
                st = dq.reshape(8, 8).copy()
                st[0, 0] = self.dc[c][yc, xc]
                pix = idct2d(coeffs_stored_to_rc(st, 8, 8))
                self.pixels_c[c][yc * 8:(yc + 1) * 8,
                                 xc * 8:(xc + 1) * 8] = pix
            return
        cx, cy = COVERED_X[raw], COVERED_Y[raw]
        size = cx * cy * 64
        inv_gs = self.quantizer.inv_global_scale
        quant = int(self.raw_quant[y, x])
        scaled_dequant = inv_gs / quant
        x_dm = (1 / 1.25) ** (self.fh.x_qm_scale - 2.0)
        b_dm = (1 / 1.25) ** (self.fh.b_qm_scale - 2.0)
        table = self.matrices.table_for_strategy(raw)  # (3, rows, cols)
        tx = x // K_COLOR_TILE_DIM_IN_BLOCKS
        x_cc = self.cmap.ytox_ratio(int(self.ytox_map[ty, tx]))
        b_cc = self.cmap.ytob_ratio(int(self.ytob_map[ty, tx]))

        tflat = table.reshape(3, -1)
        dq_x = adjust_quant_bias(qblock[0], 0) * (tflat[0] * scaled_dequant *
                                                  x_dm)
        dq_y = adjust_quant_bias(qblock[1], 1) * (tflat[1] * scaled_dequant)
        dq_b = adjust_quant_bias(qblock[2], 2) * (tflat[2] * scaled_dequant *
                                                  b_dm)
        dq_x = dq_x + x_cc * dq_y
        dq_b = dq_b + b_cc * dq_y
        block = np.stack([dq_x, dq_y, dq_b])
        # stored layout (min*8, max*8)
        mn, mx = min(cx, cy), max(cx, cy)
        stored = block.reshape(3, mn * 8, mx * 8)
        if raw in (1, 2, 3, 12, 13, 14, 15, 16, 17):
            from libjxl_torch.vardct.transforms_small import special_to_pixels
            for c in range(3):
                st = stored[c].copy()
                st[0, 0] = self.dc[c, y, x]
                pix = special_to_pixels(raw, st)
                yo = y * 8 - self.pixel_row0
                self.pixels[c, yo:yo + 8, x * 8:(x + 1) * 8] = pix
            return
        for c in range(3):
            dcb = self.dc[c, y:y + cy, x:x + cx]
            llf = llf_from_dc(dcb, cy, cx)          # (cy, cx) grid
            # stored rows index the horizontal frequency when cy >= cx
            llf_stored = llf.T if cy >= cx else llf
            st = stored[c].copy()
            st[:llf_stored.shape[0], :llf_stored.shape[1]] = llf_stored
            rc = coeffs_stored_to_rc(st, cy * 8, cx * 8)
            pix = idct2d(rc)
            yo = y * 8 - self.pixel_row0
            self.pixels[c, yo:yo + cy * 8, x * 8:(x + cx) * 8] = pix


def _mdc_stream_id(fd: FrameDimensions, g: int) -> int:
    from libjxl_torch.modular.frame import stream_id_modular_dc
    return stream_id_modular_dc(fd, g)


def adaptive_dc_smoothing(dc: np.ndarray, dc_factors) -> np.ndarray:
    """(compressed_dc.cc:47-127)."""
    _, h, w = dc.shape
    if h <= 2 or w <= 2:
        return dc
    w1 = 0.20345139757231578
    w2 = 0.0334829185968739
    w0 = 1.0 - 4.0 * (w1 + w2)
    out = dc.astype(np.float64).copy()
    cc = dc[:, 1:-1, 1:-1].astype(np.float64)
    tl = dc[:, :-2, :-2]
    tc = dc[:, :-2, 1:-1]
    tr = dc[:, :-2, 2:]
    ml = dc[:, 1:-1, :-2]
    mr = dc[:, 1:-1, 2:]
    bl = dc[:, 2:, :-2]
    bc = dc[:, 2:, 1:-1]
    br = dc[:, 2:, 2:]
    sm = (w0 * cc + w1 * (ml + mr + tc + bc) + w2 * (tl + tr + bl + br))
    gap = np.full((h - 2, w - 2), 0.5)
    for c in range(3):
        gap = np.maximum(gap, np.abs((cc[c] - sm[c]) / dc_factors[c]))
    factor = np.maximum(3.0 - 4.0 * gap, 0.0)
    out[:, 1:-1, 1:-1] = (sm - cc) * factor[None] + cc
    return out.astype(np.float32)
