"""Lossless encode entry points of the port (``libjxl_tpu/api/encoder.py``,
the device paths).

The serving path is ``encode_lossless_many(imgs, EncodeOptions(
use_device=True, entropy="prefix-device"))``: same-shape images are
stacked along the group axis in ~4 MP sub-batches; sub-batch 0's
histogram probe gives the prefix code of its whole shape-group, and each
sub-batch is then residual-coded and packed on the device in one pass
(``lossless_pack_fused``). The host builds the code, fetches the dense
words and splices them into sections with the native host library.

The code choice follows the reference rule for rule, so the streams are
byte-identical to ``libjxl_tpu``'s:

* a shape-group whose probe says ``resid_better`` codes every sub-batch
  two-pass, each with the code of its own histogram;
* a sub-batch whose dense words exceed the reference's fixed capacity
  estimate (``_fused_capacity``) is redone two-pass with its own code.

``use_device=False`` runs the host encoder, the port's copy of
``libjxl_tpu``'s (``EncodeOptions`` through ``encode_lossless_streaming``
and ``_prefix_code_state`` are that module's text).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from itertools import groupby

import numpy as np
import torch

from libjxl_torch.config import resolve_device
from libjxl_torch.core.fields import FieldWriter
from libjxl_torch.core.frame_header import (
    ColorTransform, FrameEncoding, FrameHeader,
)
from libjxl_torch.core.geometry import FrameDimensions
from libjxl_torch.core.headers import (
    BitDepth, ColorEncoding, CustomTransformData, ExtraChannelInfo,
    ImageMetadata, SizeHeader, write_bundle, write_signature,
)
from libjxl_torch.core.toc import num_toc_entries, write_toc
from libjxl_torch.entropy.ans import build_entropy_codes, tokens_to_array, \
    write_entropy_codes, write_tokens
from libjxl_torch.models.lossless import (
    PACK_NW, PACK_T, chunk_pack_device, encode_image_device,
    encode_image_device_collect, encode_image_device_dispatch,
    frame_groups_host, lossless_hist_device, lossless_pack_fused,
    lossless_tokens_device, prefix_state_to_device, upload_groups,
)
from libjxl_torch.modular.codec import GroupHeader, ModularOptions, \
    encode_modular_channel_tokens
from libjxl_torch.modular.frame import (
    stream_id_global, stream_id_modular_ac, stream_id_modular_dc,
)
from libjxl_torch.modular.image import Channel, ModularImage
from libjxl_torch.modular.predict import PREDICTOR_GRADIENT
from libjxl_torch.modular.transforms import Transform, TransformId, fwd_rct
from libjxl_torch.modular.tree import TreeNode, write_tree
from libjxl_torch.utils import native, prof
from libjxl_torch.utils.bits import BitWriter


@dataclass
class EncodeOptions:
    effort: int = 2
    use_rct: bool = True           # YCoCg for RGB
    group_size_shift: int = 1      # 256x256 groups
    use_device: bool = False       # JAX/TPU group-parallel compute path
    entropy: str = "ans"           # "ans" (host rANS) or "prefix-device"
                                   # (Huffman packed ON the TPU)
    palette: int = 512             # max colors for the palette transform
                                   # (0 disables; enc_heuristics palette)
    lz77: bool = True              # RLE-mode LZ77 when runs dominate
    squeeze: bool = False          # squeeze transform (responsive mode)
    orientation: int = 1           # Exif orientation 1..8 stored in the
                                   # metadata (decoder re-orients)
    _zero_tree: bool = False       # internal: fixed Zero-predictor tree
                                   # (pure-LZ77 mode, enc_ans.cc:1377)
    preview: object = None         # (h, w, c) uint8: embed a preview
                                   # frame (ImageMetadata.have_preview)
    color_encoding: object = None  # ColorEncoding to signal (None =
                                   # sRGB); want_icc profiles are
                                   # embedded entropy-coded (the cjxl
                                   # keep-input-profile behavior)
    distance: float = 0.0          # >0: LOSSY modular — squeeze-residual
                                   # quantization (cjxl -m -d N;
                                   # enc_modular.cc QuantizeChannel)
    faster_decoding: int = 0       # decoding-speed tier: >= 2 drops to
                                   # 128px groups so the decoder's group
                                   # parallelism quadruples
                                   # (enc_frame.cc GetGroupSizeShift)

    def __post_init__(self):
        if self.faster_decoding >= 2 or (
                self.faster_decoding >= 1 and self.squeeze and
                self.distance == 0.0):
            self.group_size_shift = 0


def _image_from_pixels(pixels: np.ndarray) -> tuple[ModularImage, int, int]:
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    h, w, nch = pixels.shape
    if pixels.dtype == np.uint8:
        bits = 8
    elif pixels.dtype == np.uint16:
        bits = 16
    elif pixels.dtype == np.float32:
        # float samples ride as their binary32 bit patterns
        # (enc_modular.cc float_to_int, bits == 32 fast path)
        bits = 32
    elif pixels.dtype == np.float16:
        bits = 16                # IEEE half bit patterns (exp_bits 5)
    else:
        raise ValueError("lossless encode expects uint8/uint16/float")
    img = ModularImage(w, h, bits)
    for c in range(nch):
        plane = pixels[:, :, c]
        if pixels.dtype == np.float32:
            plane = plane.view(np.int32)
        elif pixels.dtype == np.float16:
            plane = plane.view(np.uint16)
        img.channel.append(Channel(plane.astype(np.int32), component=c))
    return img, bits, nch


def _prepare_lossless_patches(pixels: np.ndarray, options):
    """Patch dictionary for the lossless path (enc_modular.cc:710-717):
    detect repeated text/glyph shapes, encode the integer diff atlas as
    a REFERENCE_ONLY modular frame, subtract the occurrences from the
    color planes. Returns (pdict, atlas_bytes, subtracted (h,w,c) int32)
    or None."""
    from libjxl_torch.core.frame_header import FrameType
    from libjxl_torch.render.enc_patches import (
        PATCH_FRAME_REF_ID, find_lossless_patches, subtract_patches_int,
    )
    num_extra = 1 if pixels.shape[2] in (2, 4) else 0
    found = find_lossless_patches(pixels, num_extra)
    if found is None:
        return None
    pdict, atlas_int = found
    meta, _ = _modular_headers(pixels, options)
    ah, aw = atlas_int.shape[1:]
    bits = 16 if pixels.dtype == np.uint16 else 8
    atlas_img = ModularImage(aw, ah, bits)
    for c in range(3):
        atlas_img.channel.append(Channel(atlas_int[c].copy(),
                                         component=c))
    for _ in range(num_extra):
        # zero-filled placeholder extra channels (RoundtripPatchFrame:
        # frame channel count must match the codestream metadata)
        atlas_img.channel.append(Channel(np.zeros((ah, aw), np.int32)))

    def customize(fh):
        fh.frame_type = FrameType.REFERENCE_ONLY
        fh.save_as_reference = PATCH_FRAME_REF_ID
        fh.save_before_color_transform = True
        fh.custom_size_or_origin = True
        fh.frame_origin_x0 = fh.frame_origin_y0 = 0
        fh.frame_xsize, fh.frame_ysize = aw, ah

    import dataclasses
    aopt = dataclasses.replace(options, preview=None, squeeze=False,
                               distance=0.0, _zero_tree=False)
    atlas_bytes = _modular_frame_bytes(atlas_img, aopt, meta,
                                       is_last=False, customize=customize)
    sub = np.moveaxis(pixels[:, :, :3], -1, 0).astype(np.int32)
    subtract_patches_int(sub, pdict, atlas_int)
    out = np.empty(pixels.shape[:2] + (pixels.shape[2],), np.int32)
    out[:, :, :3] = np.moveaxis(sub, 0, -1)
    if pixels.shape[2] > 3:
        out[:, :, 3:] = pixels[:, :, 3:]
    return pdict, atlas_bytes, out


def encode_lossless(pixels: np.ndarray,
                    options: EncodeOptions | None = None, device=None, *,
                    _try_both_palette: bool = True,
                    _patches=None) -> bytes:
    """Encode an (h, w, c) uint8/uint16 array to a JXL codestream. The
    device paths run on ``device``; ``use_device=False`` is the host
    encoder."""
    options = options or EncodeOptions()
    if isinstance(pixels, np.ndarray) and pixels.dtype.byteorder == ">":
        # big-endian view (16-bit PNM memmap from open_image_chunked):
        # normalize just the slice being encoded
        pixels = pixels.astype(pixels.dtype.newbyteorder("="))
    if options.use_device:
        if options.entropy == "prefix-device":
            return encode_lossless_device_prefix(pixels, options, device)
        return encode_lossless_device(pixels, options, device)
    if (_patches is None and options.effort >= 5 and not options.squeeze
            and getattr(options, "distance", 0.0) == 0
            and isinstance(pixels, np.ndarray) and pixels.ndim == 3
            and pixels.shape[2] >= 3
            and pixels.dtype in (np.uint8, np.uint16)):
        _patches = _prepare_lossless_patches(pixels, options) or False
    if options.effort >= 5 and _try_both_palette:
        # candidate product (enc_ans.cc kOptimal spirit): the learned-
        # tree encode competes against the pure-LZ77 Zero-predictor
        # mode ("No predictor requires LZ77", enc_ans.cc:1372-1380) —
        # raw sample sequences repeat exactly on tiled/screenshot
        # content where prediction residuals break at tile seams — and,
        # at e9, against palette on/off; the smallest stream wins. The
        # zero-tree candidate runs from e5: it costs ~2% of the learned
        # encode (no tree learning) and wins 3x on screenshots
        # (measured r4: 8431 -> 2760 B vs libjxl e5's 6560).
        import dataclasses
        cands = [options, dataclasses.replace(options, _zero_tree=True)]
        if options.effort >= 9 and options.palette:
            cands.append(dataclasses.replace(options, palette=0))
            cands.append(dataclasses.replace(options, palette=0,
                                             _zero_tree=True))
        from libjxl_torch.api import stats as _stats
        if _stats.active() is not None:
            # only the EMITTED stream's bits may land in the stats
            # accounting: probe candidates silently, re-encode the
            # winner with recording on
            with _stats.suppress():
                outs = [encode_lossless(pixels, c,
                                        _try_both_palette=False,
                                        _patches=_patches)
                        for c in cands]
            best = min(range(len(outs)), key=lambda i: len(outs[i]))
            return encode_lossless(pixels, cands[best],
                                   _try_both_palette=False,
                                   _patches=_patches)
        if len(cands) > 1:
            # candidates are independent full encodes — thread them
            # (numpy + native release the GIL for most of the work)
            from libjxl_torch.parallel.runner import default_runner
            outs = list(default_runner().map(
                lambda c: encode_lossless(pixels, c,
                                          _try_both_palette=False,
                                          _patches=_patches),
                cands))
        else:
            outs = [encode_lossless(pixels, c, _try_both_palette=False,
                                    _patches=_patches)
                    for c in cands]
        return min(outs, key=len)
    meta, header_bytes = _modular_headers(pixels, options)
    from libjxl_torch.api import stats as _stats
    _stats.record("header", len(header_bytes) * 8)
    out = bytearray(header_bytes)
    if options.preview is not None:
        # the preview frame precedes the first regular frame
        # (dec_frame.cc nonserialized_is_preview); its dimensions come
        # from the preview header, not the frame header
        import dataclasses
        popt = dataclasses.replace(options, preview=None, effort=2)
        out.extend(_modular_frame_bytes(np.asarray(options.preview),
                                        popt, meta, is_last=False))
    if _patches:
        pdict, atlas_bytes, sub = _patches
        out.extend(atlas_bytes)
        bits = 16 if pixels.dtype == np.uint16 else 8
        img = ModularImage(sub.shape[1], sub.shape[0], bits)
        for c in range(sub.shape[2]):
            img.channel.append(Channel(sub[:, :, c].copy(), component=c))
        out.extend(_modular_frame_bytes(img, options, meta,
                                        patches=pdict))
    else:
        out.extend(_modular_frame_bytes(pixels, options, meta))
    return bytes(out)


def _modular_headers(pixels: np.ndarray, options,
                     animation=None) -> tuple:
    """Signature + SizeHeader + ImageMetadata + CustomTransformData bytes
    for a modular-lossless codestream."""
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    h, w, nch = pixels.shape
    is_float = pixels.dtype in (np.float32, np.float16)
    bits = (32 if pixels.dtype == np.float32 else
            16 if pixels.dtype in (np.uint16, np.float16) else 8)
    gray = nch <= 2
    has_alpha = nch in (2, 4)
    bw = BitWriter()
    write_signature(bw)
    size = SizeHeader()
    size.set(w, h)
    write_bundle(bw, size)
    from libjxl_torch.core.headers import ExtraChannelInfo
    depth = BitDepth(bits_per_sample=bits)
    if is_float:
        depth.floating_point_sample = True
        depth.exponent_bits_per_sample = 8 if bits == 32 else 5
    eci = [ExtraChannelInfo(bit_depth=depth)] \
        if has_alpha else []
    meta = ImageMetadata(
        xyb_encoded=False,
        bit_depth=depth,
        color_encoding=(getattr(options, "color_encoding", None) or
                        ColorEncoding.srgb(gray=gray)),
        modular_16_bit_buffer_sufficient=bits <= 12,
        extra_channel_info=eci,
    )
    if animation is not None:
        meta.have_animation = True
        meta.animation = animation
    if getattr(options, "orientation", 1) != 1:
        meta.orientation = options.orientation
    pv = getattr(options, "preview", None)
    if pv is not None:
        from libjxl_torch.core.headers import PreviewHeader
        meta.have_preview = True
        meta.preview_size = PreviewHeader(xsize=pv.shape[1],
                                          ysize=pv.shape[0])
    write_bundle(bw, meta)
    ctd = CustomTransformData()
    ctd.xyb_encoded = False
    write_bundle(bw, ctd)
    if meta.color_encoding.want_icc:
        from libjxl_torch.color.icc import write_encoded_icc
        write_encoded_icc(bw, meta.color_encoding.icc)
    bw.zero_pad_to_byte()
    meta.nonserialized_xsize = w
    meta.nonserialized_ysize = h
    return meta, bw.to_bytes()


def xyb_reference_frame_bytes(channels: list, meta, save_slot: int,
                              options=None) -> bytes:
    """A modular-XYB REFERENCE_ONLY frame (the patch atlas carrier;
    RoundtripPatchFrame, enc_patch_dictionary.cc:812-900).

    ``channels`` are the quantized integer planes in stored order
    (Y, X, B-Y; api/decoder.py:404-412 is the matching reader)."""
    from libjxl_torch.core.frame_header import FrameType

    options = options or EncodeOptions(effort=3, use_rct=False,
                                       palette=0, lz77=False)
    h, w = channels[0].shape
    img = ModularImage(w, h, 32)
    for ch in channels:
        img.channel.append(Channel(np.asarray(ch, np.int32)))

    def customize(fh):
        fh.frame_type = FrameType.REFERENCE_ONLY
        fh.color_transform = ColorTransform.XYB
        fh.save_as_reference = save_slot
        fh.save_before_color_transform = True
        fh.custom_size_or_origin = True
        fh.frame_origin_x0 = fh.frame_origin_y0 = 0
        fh.frame_xsize, fh.frame_ysize = w, h

    return _modular_frame_bytes(img, options, meta, is_last=False,
                                customize=customize)


def _rct_candidate_cost(planes) -> float:
    """Cheap bits estimate for a channel set: entropy of hybrid-uint
    tokens of packed clamped-gradient residuals plus their extra bits
    (enc_modular.cc EstimateCost's role in the RCT search)."""
    total = 0.0
    for p in planes:
        p = p.astype(np.int64)
        w_ = np.empty_like(p)
        w_[:, 1:] = p[:, :-1]
        w_[1:, 0] = p[:-1, 0]
        w_[0, 0] = 0
        n = np.empty_like(p)
        n[1:] = p[:-1]
        n[0] = w_[0]
        nw = np.empty_like(p)
        nw[1:, 1:] = p[:-1, :-1]
        nw[0] = w_[0]
        nw[1:, 0] = w_[1:, 0]
        pred = np.clip(w_ + n - nw, np.minimum(w_, n), np.maximum(w_, n))
        res = p - pred
        packed = np.where(res >= 0, 2 * res, -2 * res - 1)
        # hybrid(4,2,0) token ids + extra-bit counts
        big = packed >= 16
        bl = np.frexp(packed.astype(np.float64))[1] - 1   # floor(log2)
        tok = np.where(big, 16 + (bl - 4) * 4 +
                       ((packed >> np.maximum(bl - 2, 0)) & 3), packed)
        nbits = np.where(big, np.maximum(bl - 2, 0), 0)
        hist = np.bincount(tok.reshape(-1), minlength=1)
        nz = hist[hist > 0]
        tot = nz.sum()
        total += float(-(nz * np.log2(nz / tot)).sum() + nbits.sum())
    return total


def _search_rct(img: ModularImage, effort: int) -> int:
    """Global RCT selection (enc_modular.cc:1444-1520): try the
    reference's deduplicated candidate list (first N by speed tier),
    rank by estimated residual entropy, return the winner (0 = none)."""
    tries = {5: 4, 6: 5, 7: 7, 8: 9}.get(effort, 19 if effort >= 9 else 0)
    candidates = [0, 6, 5, 1 * 7 + 3, 3 * 7 + 5, 5 * 7 + 5, 1 * 7 + 5,
                  2 * 7 + 5, 1 * 7 + 1, 4, 1 * 7 + 2, 2 * 7 + 1, 2 * 7 + 2,
                  2 * 7 + 3, 4 * 7 + 4, 4 * 7 + 5, 2, 1, 3][:tries]
    if len(candidates) <= 1:
        return 6
    orig = [img.channel[c].plane for c in range(3)]
    best_cost, best = None, 0
    cost6 = None
    for t in candidates:
        if t == 0:
            cost = _rct_candidate_cost(orig)
        else:
            probe = ModularImage(img.w, img.h, img.bitdepth)
            for p in orig:
                probe.channel.append(Channel(p.copy()))
            fwd_rct(probe, 0, t)
            cost = _rct_candidate_cost(
                [probe.channel[c].plane for c in range(3)])
        if t == 6:
            cost6 = cost
        if best_cost is None or cost < best_cost:
            best_cost, best = cost, t
    # The gradient-entropy proxy can't see tree/LZ77 effects, so its
    # small margins are noise (a screenshot measured 0.8% "better"
    # without RCT but encoded 37% larger); stay on YCoCg unless a
    # candidate is clearly ahead.
    if best != 6 and cost6 is not None and best_cost >= 0.98 * cost6:
        return 6
    return best


def _modular_frame_bytes(pixels, options, meta,
                         is_last: bool = True, duration: int = 0,
                         origin: tuple | None = None,
                         customize=None, patches=None) -> bytes:
    """One modular frame: FrameHeader + TOC + sections (byte-aligned).

    ``origin=(x0, y0)`` emits a cropped sub-frame at that position
    (enc_frame.cc streaming mode: stripes composited by REPLACE blend).
    ``pixels`` may be a prebuilt ModularImage; ``customize(fh)`` hooks
    frame-header edits (reference-only frames, XYB transform, ...)."""
    if isinstance(pixels, ModularImage):
        img = pixels
        bits = img.bitdepth
        nch = len(img.channel)
    else:
        img, bits, nch = _image_from_pixels(pixels)
    h, w = img.h, img.w

    # ---- frame header ----------------------------------------------------
    bw = BitWriter()
    fh = FrameHeader(encoding=FrameEncoding.MODULAR,
                     color_transform=ColorTransform.NONE,
                     group_size_shift=options.group_size_shift)
    fh.loop_filter.gab = False
    fh.loop_filter.epf_iters = 0
    fh.is_last = is_last
    fh.animation_frame.duration = duration
    if origin is not None:
        fh.custom_size_or_origin = True
        fh.frame_origin_x0, fh.frame_origin_y0 = origin
        fh.frame_xsize, fh.frame_ysize = w, h
    if customize is not None:
        customize(fh)
    if patches is not None:
        from libjxl_torch.core.frame_header import FrameFlags
        fh.flags |= FrameFlags.PATCHES
    fh.visit(FieldWriter(bw), meta)

    fd = FrameDimensions(w, h, fh.group_dim)

    # ---- modular planning ------------------------------------------------
    transforms = []
    palettized = False
    # 32-bit (float-bit-pattern) samples: RCT/palette would need 33+
    # bits (the reference's max_bitdepth gate also skips them there)
    wide32 = bits >= 32 or getattr(
        pixels, "dtype", None) == np.float16
    if options.palette and nch >= 1 and not options.use_device and \
            not wide32:
        # global palette when few distinct colors (enc_heuristics.cc /
        # enc_palette.cc): replaces RCT entirely
        from libjxl_torch.modular.transforms import fwd_palette
        t = fwd_palette(img, 0, nch - 1, options.palette)
        if t is not None:
            transforms.append(t)
            palettized = True
    if options.use_rct and nch >= 3 and not palettized and not wide32:
        rct_type = 6                 # global YCoCg at fast tiers
        if options.effort >= 5:
            rct_type = _search_rct(img, options.effort)
        if rct_type:
            fwd_rct(img, 0, rct_type)
            transforms.append(Transform(id=TransformId.RCT, begin_c=0,
                                        rct_type=rct_type))
    lossy_mod = getattr(options, "distance", 0.0) > 0
    if options.squeeze or lossy_mod:
        from libjxl_torch.modular.transforms import fwd_squeeze
        fwd_squeeze(img, [])    # default parameters, signalled empty
        transforms.append(Transform(id=TransformId.SQUEEZE, squeezes=[]))
    if lossy_mod:
        # modular lossy (cjxl -m with -d > 0): quantize the squeeze
        # residuals; the emitted stream is still plain modular
        from libjxl_torch.modular.transforms import quantize_squeeze
        quantize_squeeze(img, options.distance, (1 << bits) - 1,
                         chroma_rct=any(
                             int(t.id) == int(TransformId.RCT)
                             for t in transforms),
                         responsive=True)
    # WP mode search (enc_modular.cc:1525-1541: 2 presets at kitten e8,
    # 5 at tortoise e9+), signaled through the stream's WPHeader
    wp_header = GroupHeader().wp_header
    if options.effort >= 8 and not options._zero_tree:
        # a Zero-predictor tree never evaluates WP: searching and
        # signaling a custom WP header would only add header bytes
        from libjxl_torch.modular.predict import (
            search_wp_mode, wp_mode_header,
        )
        mode = search_wp_mode(
            [img.channel[i].plane for i in range(len(img.channel))],
            2 if options.effort == 8 else 5)
        if mode:
            wp_header = wp_mode_header(mode)
    learned = options.effort >= 5 and not options._zero_tree

    # Stream channel assignment (dec_modular.cc DecodeGlobalInfo/Group):
    # the prefix of channels with w,h <= group_dim goes to the global
    # stream; from the first larger channel on, channels are carved into
    # per-group slices -- shift >= 3 into DC groups, else AC groups.
    beginc = len(img.channel)
    for i, ch in enumerate(img.channel):
        if i >= img.nb_meta_channels and (ch.w > fd.group_dim or
                                          ch.h > fd.group_dim):
            beginc = i
            break
    global_chans = list(range(beginc))
    group_chans = list(range(beginc, len(img.channel)))

    def slice_sub(rect, mins, maxs):
        """Mirror of ModularFrameDecoder.decode_group channel selection."""
        x0, y0, rw, rh = rect
        sub = ModularImage(0, 0, img.bitdepth)
        for i in group_chans:
            ch = img.channel[i]
            shift = min(ch.hshift, ch.vshift)
            if shift > maxs or shift < mins:
                continue
            cx0, cy0 = x0 >> ch.hshift, y0 >> ch.vshift
            cw = min(rw >> ch.hshift, ch.w - cx0)
            chh = min(rh >> ch.vshift, ch.h - cy0)
            if cw <= 0 or chh <= 0:
                continue
            sub.channel.append(Channel(
                ch.plane[cy0:cy0 + chh, cx0:cx0 + cw].copy(),
                ch.hshift, ch.vshift))
        return sub

    def stream_tokens(sub, sid):
        if learned:
            from libjxl_torch.modular.enc_ma import tokenize_with_tree
            return tokenize_with_tree(
                [(ci, sub.channel[ci].plane) for ci in
                 range(len(sub.channel))], tree, sid,
                wp_header=wp_header
                if not wp_header.is_all_default() else None)
        arrs = [tokens_to_array(encode_modular_channel_tokens(
            sub, ci, sid, tree, wp_header))
            for ci in range(len(sub.channel))]
        arrs = [a for a in arrs if len(a)]
        if not arrs:
            return np.zeros((0, 2), dtype=np.int64)
        return np.concatenate(arrs)

    def dc_group_sub(gidx: int):
        gx = gidx % fd.xsize_dc_groups
        gy = gidx // fd.xsize_dc_groups
        return slice_sub((gx * fd.dc_group_dim, gy * fd.dc_group_dim,
                          fd.dc_group_dim, fd.dc_group_dim), 3, 1000)

    def ac_group_sub(gidx: int):
        gx = gidx % fd.xsize_groups
        gy = gidx // fd.xsize_groups
        return slice_sub((gx * fd.group_dim, gy * fd.group_dim,
                          fd.group_dim, fd.group_dim), 0, 2)

    empty = np.zeros((0, 2), dtype=np.int64)
    dc_subs = [dc_group_sub(g) for g in range(fd.num_dc_groups)] \
        if group_chans else []
    ac_subs = [ac_group_sub(g) for g in range(fd.num_groups)] \
        if group_chans else []

    if options._zero_tree:
        from libjxl_torch.modular.predict import PREDICTOR_ZERO
        tree = [TreeNode(-1, 0, 0, 0, PREDICTOR_ZERO, 0, 1)]
    elif learned:
        # MA tree learning (enc_ma.cc LearnTree / ComputeTree): ONE
        # global tree, but the samples come from the per-group streams
        # exactly as they will be tokenized (local coordinates, stream
        # id as the group-id property, per-stream channel references) —
        # enc_modular.cc:1859 stream-per-group tree learning.
        from libjxl_torch.modular.enc_ma import learn_tree_streams
        streams = []
        if global_chans:
            streams.append((stream_id_global(),
                            [(ci, img.channel[ci].plane)
                             for ci in global_chans]))
        for g, sub in enumerate(dc_subs):
            if sub.channel:
                streams.append((stream_id_modular_dc(fd, g),
                                [(ci, sub.channel[ci].plane)
                                 for ci in range(len(sub.channel))]))
        for g, sub in enumerate(ac_subs):
            if sub.channel:
                streams.append((stream_id_modular_ac(fd, g, 0),
                                [(ci, sub.channel[ci].plane)
                                 for ci in range(len(sub.channel))]))
        # sample budget by tier (enc_modular.cc options.nb_repeats
        # spirit): e5/e6 learn on a subsample — measured <0.2% density
        # cost for ~2x tree-learning time on 1 MP inputs
        tree = learn_tree_streams(
            streams,
            max_leaves=48 if options.effort < 8 else 96,
            sample_limit=(1 << 17 if options.effort <= 6
                          else 1 << 18 if options.effort <= 8
                          else 1 << 19),
            wp_header=wp_header
            if not wp_header.is_all_default() else None)
    else:
        tree = [TreeNode(-1, 0, 0, 0, PREDICTOR_GRADIENT, 0, 1)]
    num_ctx = (len(tree) + 1) // 2

    global_toks = []
    if learned and global_chans:
        # ONE call over the whole channel list: prev-channel reference
        # properties (16+) see the same neighbors the decoder computes
        from libjxl_torch.modular.enc_ma import tokenize_with_tree
        global_toks.append(tokenize_with_tree(
            [(ci, img.channel[ci].plane) for ci in global_chans], tree,
            stream_id_global(),
            wp_header=wp_header
            if not wp_header.is_all_default() else None))
    elif global_chans:
        for ci in global_chans:
            t = encode_modular_channel_tokens(img, ci, stream_id_global(),
                                              tree, wp_header)
            global_toks.append(tokens_to_array(t))
    global_arr = (np.concatenate(global_toks) if global_toks
                  else np.zeros((0, 2), dtype=np.int64))
    def _dc_tok(g):
        sub = dc_subs[g]
        return stream_tokens(sub, stream_id_modular_dc(fd, g)) \
            if sub.channel else empty

    def _ac_tok(g):
        sub = ac_subs[g]
        return stream_tokens(sub, stream_id_modular_ac(fd, g, 0)) \
            if sub.channel else empty

    if len(ac_subs) > 2:
        # groups are the reference's parallel axis (enc_frame.cc
        # RunOnPool over groups); numpy/native tokenization releases
        # the GIL enough for threads to pay
        from libjxl_torch.parallel.runner import default_runner
        runner = default_runner()
        dc_arrs = list(runner.map(_dc_tok, range(len(dc_subs))))
        group_arrs = list(runner.map(_ac_tok, range(len(ac_subs))))
    else:
        dc_arrs = [_dc_tok(g) for g in range(len(dc_subs))]
        group_arrs = [_ac_tok(g) for g in range(len(ac_subs))]

    all_arrs = [global_arr] + dc_arrs + group_arrs
    codes = build_entropy_codes(all_arrs, num_ctx)

    # ---- sections --------------------------------------------------------
    def dc_global_section(codes, global_arr) -> bytes:
        sw = BitWriter()
        if patches is not None:
            # image features precede the dequant matrices in DC global
            # (dec_frame.cc ProcessDCGlobal order)
            from libjxl_torch.render.enc_patches import serialize_patches
            serialize_patches(sw, patches,
                              len(meta.extra_channel_info))
        sw.write(1, 1)          # DequantMatrices::DecodeDC all_default
        sw.write(1, 1)          # has global tree
        write_tree(sw, tree)
        write_entropy_codes(sw, codes)
        gh = GroupHeader(use_global_tree=True, transforms=transforms)
        gh.wp_header = wp_header
        gh.write(sw)
        if global_arr.size:
            write_tokens(sw, global_arr, codes)
        sw.zero_pad_to_byte()
        return sw.to_bytes()

    def stream_section(codes, arr, nonempty: bool) -> bytes:
        if not nonempty:
            return b""
        sw = BitWriter()
        gh = GroupHeader(use_global_tree=True)
        gh.wp_header = wp_header
        gh.write(sw)
        write_tokens(sw, arr, codes)
        sw.zero_pad_to_byte()
        return sw.to_bytes()

    single = fd.num_groups == 1 and fh.passes.num_passes == 1

    def assemble(codes, global_arr, dc_arrs, group_arrs) -> list:
        if single:
            # DC group + AC group streams are empty (no channels); nothing
            # follows in the single section.
            return [dc_global_section(codes, global_arr)]
        sections = [dc_global_section(codes, global_arr)]
        for g in range(fd.num_dc_groups):
            sections.append(stream_section(
                codes, dc_arrs[g], bool(dc_subs and dc_subs[g].channel)))
        sections.append(b"")          # AC global: nothing for modular
        for g in range(fd.num_groups):
            sections.append(stream_section(
                codes, group_arrs[g],
                bool(ac_subs and ac_subs[g].channel)))
        return sections

    sections = assemble(codes, global_arr, dc_arrs, group_arrs)
    if options.lz77:
        # LZ77 method by speed tier (enc_ans.cc:1355-1370): RLE up to
        # e7, hash-chain match search at e8, both (pick smaller) at e9+
        # — each candidate kept only if the final bitstream shrinks.
        from libjxl_torch.entropy.ans import (
            LZ77Params, lz77_match_transform, lz77_rle_transform,
        )

        def try_streams(t_arrs):
            nonlocal sections
            lz = LZ77Params(enabled=True)
            codes_lz = build_entropy_codes(t_arrs, num_ctx, lz77=lz)
            sec_lz = assemble(codes_lz, t_arrs[0],
                              t_arrs[1:1 + len(dc_arrs)],
                              t_arrs[1 + len(dc_arrs):])
            if sum(map(len, sec_lz)) < sum(map(len, sections)):
                sections = sec_lz

        # per-stream distance multiplier = max channel width, mirroring
        # the decoder's ANSSymbolReader setup (modular/codec.py:269-278)
        def _mult(chans):
            return max((c.w for c in chans if c.w and c.h), default=0)
        mults = ([_mult([img.channel[i] for i in global_chans])]
                 + [_mult(s.channel) for s in dc_subs]
                 + [_mult(s.channel) for s in ac_subs])
        if options.effort < 8 or options.effort >= 9 or options._zero_tree:
            # the zero-tree candidate always competes RLE against the
            # hash-chain search: its candidate set must be a superset of
            # the e5 ladder's, or e8 can lose to e5 on run-heavy content
            lz = LZ77Params(enabled=True)
            t_arrs = [lz77_rle_transform(a, num_ctx, lz,
                                         distance_multiplier=1)
                      for a in all_arrs]
            n_plain = sum(len(a) for a in all_arrs)
            if n_plain - sum(len(a) for a in t_arrs) > 0.1 * n_plain:
                try_streams(t_arrs)
        if options.effort >= 8 or options._zero_tree:
            t_arrs = lz77_match_transform(
                all_arrs, num_ctx, LZ77Params(enabled=True), mults)
            if t_arrs is not None:
                try_streams(t_arrs)

    from libjxl_torch.api import stats as _stats
    if _stats.active() is not None:
        # bit accounting (enc_aux_out.h layers for the modular path)
        _stats.record("header", bw.bits_written)
        _stats.record_count("num_base_pixels", w * h)
        tw = BitWriter()
        write_tree(tw, tree)
        _stats.record("modular_tree", tw.bits_written)
        _stats.record("modular_global", len(sections[0]) * 8 -
                      tw.bits_written)
        for s in sections[1:1 + fd.num_dc_groups]:
            _stats.record("modular_dc_group", len(s) * 8)
        for s in sections[1 + fd.num_dc_groups + 1:]:
            _stats.record("modular_ac_group", len(s) * 8)
    toc0 = bw.bits_written
    write_toc(bw, [len(s) for s in sections])
    _stats.record("toc", bw.bits_written - toc0)
    out = bytearray(bw.to_bytes())
    for s in sections:
        out.extend(s)
    return bytes(out)


def encode_animation(frames, durations=None,
                     options: EncodeOptions | None = None,
                     tps: tuple = (10, 1), num_loops: int = 0,
                     per_frame_options: list | None = None,
                     frame_indexing: str | None = None) -> bytes:
    """Encode a modular animation: a list of (h, w, c) frames with
    per-frame durations in ticks (``tps`` = ticks per second as
    numerator/denominator; frame_header.h duration semantics).

    Every frame is a REPLACE-blended regular frame, matching the
    reference encoder's default animation path. ``per_frame_options``
    allows MIXED lossless/lossy-modular frames in one stream: the
    container stays non-XYB (the reference likewise forbids lossless
    frames in an xyb_encoded codestream, encode.cc:1573-1576), and each
    frame's distance selects lossless (0) or squeeze-residual lossy
    modular coding.

    ``frame_indexing``: cjxl --frame_indexing pattern ('1'/'0' per
    frame, first char must be '1'): emits a container with a ``jxli``
    frame-index box recording codestream offsets of the marked
    keyframes (encode_internal.h:40-76, encode.cc:1128-1133)."""
    options = options or EncodeOptions()
    if not frames:
        raise ValueError("animation needs at least one frame")
    first = frames[0]
    if any(f.shape != first.shape or f.dtype != first.dtype
           for f in frames):
        raise ValueError("all frames must have the same shape and dtype")
    from libjxl_torch.core.headers import AnimationHeader
    anim = AnimationHeader(tps_numerator=tps[0], tps_denominator=tps[1],
                           num_loops=num_loops)
    meta, header_bytes = _modular_headers(first, options, animation=anim)
    if durations is None:
        durations = [1] * len(frames)
    out = bytearray(header_bytes)
    offsets = []
    for i, (f, d) in enumerate(zip(frames, durations)):
        o = per_frame_options[i] if per_frame_options else options
        offsets.append(len(out))
        out.extend(_modular_frame_bytes(f, o, meta,
                                        is_last=(i == len(frames) - 1),
                                        duration=int(d)))
    if frame_indexing:
        if len(frame_indexing) != len(frames) or \
                frame_indexing[0] != "1" or \
                set(frame_indexing) - {"0", "1"}:
            raise ValueError("frame_indexing must be a '0'/'1' string "
                             "per frame starting with '1'")
        from libjxl_torch.api.container import (
            encode_frame_index_box, wrap_container,
        )
        jxli = encode_frame_index_box(
            [(frame_indexing[i] == "1", int(durations[i]), offsets[i])
             for i in range(len(frames))], tps[0], tps[1])
        return wrap_container(bytes(out),
                              extra_boxes=[(b"jxli", jxli)])
    return bytes(out)


class _StreamingLayout:
    """Shared state of the spec streaming schedule (enc_frame.cc:2045
    EncodeFrameStreaming, ComputePermutationForStreaming :1867): frame
    header writer, DC-group-major TOC permutation, self-contained
    section production. One instance serves both the single-host
    generator (:func:`encode_lossless_streaming`) and the multi-host
    DC-band-sharded encoder (:mod:`libjxl_torch.parallel.multihost`) —
    identical per-section bytes by construction."""

    def __init__(self, h, w, nch, dtype, options: EncodeOptions):
        self.options = options
        self.nch = nch
        self.bits = 16 if dtype == np.uint16 else 8
        self.meta, self.header_bytes = _modular_headers(
            np.empty((h, w) if nch == 1 else (h, w, nch), dtype), options)
        bw = BitWriter()
        fh = FrameHeader(encoding=FrameEncoding.MODULAR,
                         color_transform=ColorTransform.NONE,
                         group_size_shift=options.group_size_shift)
        fh.loop_filter.gab = False
        fh.loop_filter.epf_iters = 0
        fh.is_last = True
        fh.visit(FieldWriter(bw), self.meta)
        self.frame_bw = bw
        self.fd = fd = FrameDimensions(w, h, fh.group_dim)
        self.use_rct = options.use_rct and nch >= 3
        self.transforms = [Transform(id=TransformId.RCT, begin_c=0,
                                     rct_type=6)] if self.use_rct else []
        self.tree_fixed = [TreeNode(-1, 0, 0, 0, PREDICTOR_GRADIENT,
                                    0, 1)]
        # section permutation (DC-group-major file order)
        num_dc, num_g = fd.num_dc_groups, fd.num_groups
        n_sections = 2 + num_dc + num_g
        perm = np.zeros(n_sections, np.int64)
        new_ix = 0
        perm[0] = new_ix
        new_ix += 1
        gxs, gys = fd.xsize_groups, fd.ysize_groups
        for dcy in range(fd.ysize_dc_groups):
            for dcx in range(fd.xsize_dc_groups):
                dc_ix = dcy * fd.xsize_dc_groups + dcx
                perm[1 + dc_ix] = new_ix
                new_ix += 1
                for gy in range(dcy * 8, min(gys, dcy * 8 + 8)):
                    for gx in range(dcx * 8, min(gxs, dcx * 8 + 8)):
                        perm[2 + num_dc + gy * gxs + gx] = new_ix
                        new_ix += 1
        perm[1 + num_dc] = new_ix   # AC global is last in the file
        new_ix += 1
        assert new_ix == n_sections
        self.perm = perm

    def dc_global_section(self) -> bytes:
        sw = BitWriter()
        sw.write(1, 1)              # DequantMatrices::DecodeDC all_default
        sw.write(1, 0)              # no global tree: groups self-contained
        gh = GroupHeader(use_global_tree=False, transforms=self.transforms)
        gh.write(sw)
        sw.zero_pad_to_byte()
        return sw.to_bytes()

    def group_section(self, band, band_y0, gy: int, gx: int) -> bytes:
        """Self-contained AC-group section: local tree + codes + tokens."""
        fd, nch, options = self.fd, self.nch, self.options
        y0 = gy * fd.group_dim - band_y0
        x0 = gx * fd.group_dim
        sub_px = band[y0:y0 + fd.group_dim, x0:x0 + fd.group_dim]
        sub = ModularImage(sub_px.shape[1], sub_px.shape[0], self.bits)
        for c in range(nch):
            sub.channel.append(Channel(sub_px[:, :, c].astype(np.int32)))
        if self.use_rct:
            fwd_rct(sub, 0, 6)
        sid = stream_id_modular_ac(fd, gy * fd.xsize_groups + gx, 0)
        if options.effort >= 5:
            from libjxl_torch.modular.enc_ma import (
                learn_tree, tokenize_with_tree,
            )
            tree = learn_tree(
                [(ci, sub.channel[ci].plane) for ci in range(nch)],
                max_leaves=24)
            arr = tokenize_with_tree(
                [(ci, sub.channel[ci].plane) for ci in range(nch)],
                tree, sid)
        else:
            tree = self.tree_fixed
            arrs = [tokens_to_array(encode_modular_channel_tokens(
                sub, ci, sid, tree, GroupHeader().wp_header))
                for ci in range(nch)]
            arrs = [a for a in arrs if len(a)]
            arr = np.concatenate(arrs) if arrs else \
                np.zeros((0, 2), dtype=np.int64)
        num_ctx = (len(tree) + 1) // 2
        codes = build_entropy_codes([arr], num_ctx)
        ssw = BitWriter()
        GroupHeader(use_global_tree=False).write(ssw)
        write_tree(ssw, tree)
        write_entropy_codes(ssw, codes)
        if arr.size:
            write_tokens(ssw, arr, codes)
        ssw.zero_pad_to_byte()
        return ssw.to_bytes()

    def dc_band_sections(self, pixels, dcy: int) -> list:
        """All file-order sections of one DC-group row band (bounded
        pixel state: only rows [dcy*2048, dcy*2048+2048) are read)."""
        fd = self.fd
        band_y0 = dcy * fd.dc_group_dim
        band = np.asarray(pixels[band_y0:band_y0 + fd.dc_group_dim])
        if band.dtype.byteorder == ">":
            # 16-bit PNM memmap (open_image_chunked): normalize the
            # band slice only — the full image stays on disk
            band = band.astype(band.dtype.newbyteorder("="))
        if band.ndim == 2:
            band = band[:, :, None]
        gxs, gys = fd.xsize_groups, fd.ysize_groups
        out = []
        for dcx in range(fd.xsize_dc_groups):
            out.append(b"")         # DC group: no shift>=3 channels
            for gy in range(dcy * 8, min(gys, dcy * 8 + 8)):
                for gx in range(dcx * 8, min(gxs, dcx * 8 + 8)):
                    out.append(self.group_section(band, band_y0, gy, gx))
        return out

    def assemble(self, file_sections: list):
        """TOC + section bytes, given the complete file-order list
        (dc_global first, AC-global b'' last)."""
        from libjxl_torch.core.toc import write_toc_permuted
        write_toc_permuted(self.frame_bw, [len(s) for s in file_sections],
                           self.perm)
        yield self.frame_bw.to_bytes()
        for s in file_sections:
            if s:
                yield s


def encode_lossless_streaming(pixels: np.ndarray,
                              options: EncodeOptions | None = None):
    """Spec streaming encode (enc_frame.cc:2045 EncodeFrameStreaming,
    ComputePermutationForStreaming :1867): ONE regular frame whose
    sections are produced and laid out DC-group by DC-group, with a
    Lehmer-coded TOC permutation mapping them back to spec order. Every
    group section is self-contained (local MA tree + histograms,
    GroupHeader.use_global_tree=0), so encoder pixel/token state is
    bounded by one 2048-row band — the image is never materialized.

    The reference patches the TOC through a seekable output processor;
    here the (small) compressed section bytes are buffered and the
    codestream is yielded as chunks once the TOC is known. Input
    ``pixels`` may be any object supporting ``pixels[y0:y1]`` row
    slicing (e.g. a memory-mapped file). Palette/squeeze are global
    transforms and are disabled in streaming mode (the reference's
    streaming tier makes the same restriction)."""
    options = options or EncodeOptions()
    first = np.asarray(pixels[0:1])
    native_dt = first.dtype.newbyteorder("=")
    h = len(pixels)
    w = first.shape[1]
    nch = 1 if first.ndim == 2 else first.shape[2]
    group_dim = 128 << options.group_size_shift
    if h <= group_dim and w <= group_dim:
        # single group: one-shot encode is already streaming-shaped
        yield encode_lossless(np.asarray(pixels[0:h]), options)
        return
    lay = _StreamingLayout(h, w, nch, native_dt, options)
    yield lay.header_bytes
    file_sections = [lay.dc_global_section()]
    for dcy in range(lay.fd.ysize_dc_groups):
        file_sections.extend(lay.dc_band_sections(pixels, dcy))
    file_sections.append(b"")       # AC global: nothing for modular
    yield from lay.assemble(file_sections)


def _prefix_code_state(buf: np.ndarray, groups_shape, dtype) -> dict:
    """Build the shape-group's prefix code from a histogram-probe
    payload; also decides stream-vs-residual wire mode and the expected
    stream density used to size fused-pack buffers and fetches."""
    from libjxl_torch.entropy.ans import build_prefix_codes_from_histogram
    from libjxl_torch.utils import native

    ng_total = groups_shape[0]
    gmax = buf[:4 * ng_total].view(np.uint32)
    hist = buf[4 * ng_total:].view(np.uint32).astype(np.int64)
    codes = build_prefix_codes_from_histogram(hist)
    lengths = np.asarray(codes.prefix_depths[0], dtype=np.int32)
    cbits = np.asarray(codes.prefix_bits[0], dtype=np.uint32)
    lut_len = np.zeros(256, np.int32)
    lut_bits = np.zeros(256, np.uint32)
    lut_len[:len(lengths)] = lengths
    lut_bits[:len(cbits)] = cbits
    toks = np.arange(len(hist))
    tok_nbits = np.where(toks < 16, 0, ((toks - 16) >> 2) + 2)
    total_bits = int(np.sum(hist * (lut_len[:len(hist)] + tok_nbits)))
    n_tokens = int(np.prod(groups_shape))
    bits = 8 if dtype == np.uint8 else 16
    resid_better = (total_bits // 8 >= n_tokens and bits == 8
                    and native.available())
    return dict(codes=codes, lut_bits=lut_bits, lut_len=lut_len,
                gmax=gmax, total_bits=total_bits,
                words_per_token=total_bits / 32 / max(n_tokens, 1),
                resid_better=resid_better)


def _hwc(im: np.ndarray) -> np.ndarray:
    return im[:, :, None] if im.ndim == 2 else im


def encode_lossless_device(pixels: np.ndarray,
                           options: EncodeOptions | None = None,
                           device=None) -> bytes:
    """Device residuals + histogram, host rANS emission (entropy="ans")."""
    options = options or EncodeOptions()
    pixels = _hwc(pixels)
    collected = encode_image_device(
        pixels, group_dim=128 << options.group_size_shift,
        use_rct=options.use_rct and pixels.shape[2] >= 3, device=device)
    return _assemble_lossless_device(pixels, options, collected)


def encode_lossless_many(images, options: EncodeOptions | None = None,
                         device=None) -> list:
    """Batch encode (BASELINE config 5, the serving mode); one codestream
    per image, in input order."""
    options = options or EncodeOptions()
    if not options.use_device:
        return [encode_lossless(im, options) for im in images]
    device = resolve_device(device)
    imgs = [_hwc(im) for im in images]
    with prof.stage("encode_lossless_many", images=len(imgs)):
        if options.entropy == "prefix-device":
            return _encode_prefix_many(imgs, options, device)
        group_dim = 128 << options.group_size_shift
        handles = [encode_image_device_dispatch(
            im, group_dim, options.use_rct and im.shape[2] >= 3, device)
            for im in imgs]
        return [_assemble_lossless_device(
            im, options, encode_image_device_collect(hd))
            for im, hd in zip(imgs, handles)]


def _encode_prefix_many(imgs: list, options: EncodeOptions, device) -> list:
    """``encode_lossless_many``'s prefix-device path."""
    def key(i):
        return imgs[i].shape, str(imgs[i].dtype)

    shape_groups = []
    for _, grp in groupby(sorted(range(len(imgs)), key=key), key=key):
        idxs = list(grp)
        px = imgs[idxs[0]].shape[0] * imgs[idxs[0]].shape[1]
        per = max(1, (4 << 20) // max(px, 1))
        shape_groups.append([idxs[j:j + per]
                             for j in range(0, len(idxs), per)])
    out: list = [None] * len(imgs)
    native_lib()
    ctx = prof.context()
    # host splicing of sub-batch k overlaps the device work of k+1
    with ThreadPoolExecutor(2) as pool:
        pending = []
        for batches in shape_groups:
            part0 = [imgs[i] for i in batches[0]]
            with prof.stage("encode.upload", images=len(part0)):
                staged0 = _prefix_upload(part0, options, device)
            groups0, dims = staged0
            with prof.stage("encode.probe", images=len(part0)):
                payload = lossless_hist_device(
                    groups0, dims["h"], dims["w"], gx=dims["gx"],
                    per_image=dims["per_image"] if len(part0) > 1 else 0)
                cst = _prefix_code_state(payload.cpu().numpy(),
                                         tuple(groups0.shape),
                                         part0[0].dtype)
            if cst["resid_better"]:
                for k, part in enumerate(batches):
                    with prof.stage("encode.device", images=len(part)):
                        st = _prefix_pass2(_prefix_pass1(
                            [imgs[i] for i in part], options, device,
                            staged0 if k == 0 else None))
                    pending.append((part, pool.submit(_splice, st, ctx)))
                continue
            lut = prefix_state_to_device(cst, device)
            for k, part in enumerate(batches):
                with prof.stage("encode.device", images=len(part)):
                    st = _prefix_fused([imgs[i] for i in part], options, cst,
                                       lut, staged0 if k == 0 else None,
                                       device)
                pending.append((part, pool.submit(_splice, st, ctx)))
            del staged0, groups0
        with prof.stage("encode.wait"):
            for idxs, fut in pending:
                for i, stream in zip(idxs, fut.result()):
                    out[i] = stream
    return out


def _splice(st: dict, ctx) -> list:
    """``_prefix_assemble`` on a splice thread, under a span whose parent
    is the caller's trace context ``ctx``."""
    with prof.stage("encode.splice", parent=ctx, images=st["n_images"],
                    threads=_splice_threads(st["ng"])) as sp:
        streams = _prefix_assemble(st)
        sp.set(bytes=sum(len(s) for s in streams))
    return streams


def encode_lossless_device_prefix(pixels: np.ndarray,
                                  options: EncodeOptions | None = None,
                                  device=None) -> bytes:
    """Two-pass encode of one image: residuals + histogram on the device,
    the prefix code on the host, then the words packed on the device."""
    st = _prefix_pass1([pixels], options or EncodeOptions(), device)
    return _prefix_assemble(_prefix_pass2(st))[0]


def _prefix_upload(batch_imgs: list, options: EncodeOptions, device):
    """Stage a same-shape image batch on the device as one stacked group
    tensor (narrow dtype); returns (tensor, dims dict)."""
    imgs = [_hwc(im) for im in batch_imgs]
    h, w, nch = imgs[0].shape
    group_dim = 128 << options.group_size_shift
    devs = [upload_groups(frame_groups_host(im, group_dim)[0], device)
            for im in imgs]
    groups = devs[0] if len(devs) == 1 else torch.cat(devs)
    return groups, dict(h=h, w=w, nch=nch, gx=-(-w // group_dim),
                        per_image=devs[0].shape[0])


def _batch_state(imgs: list, options: EncodeOptions, dims: dict,
                 n_groups_total: int) -> dict:
    return dict(options=options, h=dims["h"], w=dims["w"], nch=dims["nch"],
                n_images=len(imgs),
                bits=8 if imgs[0].dtype == np.uint8 else 16,
                ng=dims["per_image"], n_groups_total=n_groups_total)


def _prefix_pass1(batch_imgs: list, options: EncodeOptions, device=None,
                  staged=None) -> dict:
    """Pass 1 (residuals + histogram) for a batch of same-shape images
    stacked along the group axis; ``staged`` is the batch's
    ``_prefix_upload`` result when it is on the device already."""
    imgs = [_hwc(im) for im in batch_imgs]
    groups, dims = staged or _prefix_upload(imgs, options, device)
    shards = [groups]
    from libjxl_torch.config import config as _cfg
    if _cfg.shard_encode:
        # multi-device: split the group axis over the mesh's slots; the
        # histogram is the sum of the shards' (the reference's psum)
        from libjxl_torch.parallel.mesh import make_mesh, shard_groups
        mesh = make_mesh(_cfg.mesh_slots, groups.device)
        if mesh.size > 1 and groups.shape[0] % mesh.size == 0:
            shards = shard_groups(mesh, groups)
    parts = [lossless_tokens_device(
        g, dims["h"], dims["w"], gx=dims["gx"],
        per_image=dims["per_image"] if len(imgs) > 1 else 0,
        g0=i * g.shape[0]) for i, g in enumerate(shards)]
    st = _batch_state(imgs, options, dims, groups.shape[0])
    st.update(wide=[p[0] for p in parts], valid=[p[1] for p in parts],
              payload=_shard_payload([p[2] for p in parts], shards),
              groups_shape=tuple(groups.shape), dtype=imgs[0].dtype)
    return st


def _shard_payload(payloads: list, shards: list) -> torch.Tensor:
    """One probe payload from the shards' (per-group maxes in group
    order, then the summed histogram), on the first shard's device."""
    if len(payloads) == 1:
        return payloads[0]
    dev = payloads[0].device
    gmax = [p[:4 * g.shape[0]].to(dev) for p, g in zip(payloads, shards)]
    hist = sum(p[4 * g.shape[0]:].view(torch.int32).to(dev)
               for p, g in zip(payloads, shards))
    return torch.cat(gmax + [hist.view(torch.uint8)])


def _prefix_pass2(st: dict) -> dict:
    """Build the prefix code from pass 1's own histogram and pack the
    words on the device with it, one pack per shard of pass 1, the
    shards' words and chunk bits spliced in group order. (The reference
    may instead fetch the residuals and pack on the host; the bitstream
    is the same.)"""
    cst = _prefix_code_state(st["payload"].cpu().numpy(),
                             st["groups_shape"], st["dtype"])
    packed = [chunk_pack_device(wide, valid,
                                prefix_state_to_device(cst, wide.device))
              for wide, valid in zip(st["wide"], st["valid"])]
    dev = st["wide"][0].device
    words, chunk_bits = (torch.cat([p[k].to(dev) for p in packed])
                         for k in (0, 1))
    out = {k: v for k, v in st.items()
           if k not in ("wide", "valid", "payload")}
    out.update(codes=cst["codes"], words_dev=words,
               chunk_bits_dev=chunk_bits)
    return out


def _fused_capacity(n_tokens: int, n_chunks: int,
                    words_per_token: float) -> int:
    """The reference's dense-word capacity for a fused sub-batch
    (libjxl_tpu/api/encoder.py:_prefix_fused): 1.3x the probe's density
    plus row slack, in 512Ki-word buckets. A sub-batch whose words exceed
    it is re-coded two-pass there, so it is here too."""
    worst = n_chunks * PACK_NW
    est = int(n_tokens * words_per_token * 1.3) + n_chunks * 8 + 8192
    cap_words = min(worst, max(est, 1 << 16))
    return ((cap_words + (1 << 19) - 1) >> 19) << 19


def _prefix_fused(batch_imgs: list, options: EncodeOptions, cst: dict,
                  lut, staged=None, device=None) -> dict:
    """One fused pass for a serving sub-batch with the shape-group's code
    ``cst`` (``lut``: its pack table on the device); ``staged`` is the
    sub-batch's ``_prefix_upload`` result when it is on the device
    already. Returns an assemble-ready state, or the two-pass state when
    the words overflow the reference's capacity estimate."""
    imgs = [_hwc(im) for im in batch_imgs]
    groups, dims = staged or _prefix_upload(imgs, options, device)
    n_tokens = groups.numel()
    cap_words = _fused_capacity(n_tokens, n_tokens // PACK_T,
                                cst["words_per_token"])
    words, chunk_bits = lossless_pack_fused(
        groups, dims["h"], dims["w"], lut, gx=dims["gx"],
        per_image=dims["per_image"] if len(imgs) > 1 else 0)
    if words.shape[0] > cap_words:
        del words, chunk_bits
        return _prefix_pass2(_prefix_pass1(imgs, options, groups.device,
                                           (groups, dims)))
    st = _batch_state(imgs, options, dims, groups.shape[0])
    st.update(codes=cst["codes"], words_dev=words, chunk_bits_dev=chunk_bits)
    return st


def _frame_headers(h: int, w: int, bits: int, nch: int,
                   options: EncodeOptions):
    """Signature, size, metadata and frame header of a lossless modular
    stream; returns (BitWriter, FrameDimensions).

    2 and 4 channels are gray or RGB plus alpha, declared as an extra
    channel as the host encoder does (``_modular_headers``). The
    reference's device paths declare no extra channel, so their 2- and
    4-channel streams do not decode to their input; 1- and 3-channel
    headers are the reference's bit for bit."""
    bw = BitWriter()
    write_signature(bw)
    size = SizeHeader()
    size.set(w, h)
    write_bundle(bw, size)
    depth = BitDepth(bits_per_sample=bits)
    meta = ImageMetadata(
        xyb_encoded=False,
        bit_depth=depth,
        color_encoding=ColorEncoding.srgb(gray=nch <= 2),
        modular_16_bit_buffer_sufficient=bits <= 12,
        extra_channel_info=([ExtraChannelInfo(bit_depth=depth)]
                            if nch in (2, 4) else []),
    )
    write_bundle(bw, meta)
    ctd = CustomTransformData()
    ctd.xyb_encoded = False
    write_bundle(bw, ctd)
    bw.zero_pad_to_byte()
    fh = FrameHeader(encoding=FrameEncoding.MODULAR,
                     color_transform=ColorTransform.NONE,
                     group_size_shift=options.group_size_shift)
    fh.loop_filter.gab = False
    fh.loop_filter.epf_iters = 0
    meta.nonserialized_xsize = w
    meta.nonserialized_ysize = h
    fh.visit(FieldWriter(bw), meta)
    return bw, FrameDimensions(w, h, fh.group_dim)


def _global_bits(codes, use_rct: bool) -> tuple[bytes, int]:
    """DC-global section bits before the group data: tree + codes +
    the global group header (with the RCT when used)."""
    sw = BitWriter()
    sw.write(1, 1)
    sw.write(1, 1)
    write_tree(sw, [TreeNode(-1, 0, 0, 0, PREDICTOR_GRADIENT, 0, 1)])
    write_entropy_codes(sw, codes)
    transforms = ([Transform(id=TransformId.RCT, begin_c=0, rct_type=6)]
                  if use_rct else [])
    GroupHeader(use_global_tree=True, transforms=transforms).write(sw)
    return sw.to_bytes(), sw.bits_written


def _stream(header_bytes: bytes, header_bits: int, fd: FrameDimensions,
            dc_section: bytes, group_sections: list) -> bytes:
    """TOC + sections after the frame header's last bit. With one group
    the DC-global section carries the group data itself."""
    if fd.num_groups == 1:
        sections = [dc_section]
    else:
        sections = ([dc_section] + [b""] * fd.num_dc_groups + [b""]
                    + list(group_sections))
    tw = BitWriter()
    tw.append_packed(header_bytes, header_bits)
    write_toc(tw, [len(s) for s in sections])
    return tw.to_bytes() + b"".join(sections)


def native_lib():
    """The native host library, built on first call. Call it before
    handing work to threads: a thread that asks while another builds is
    told the library is missing."""
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError("the native host library (native/jxl_host.cc) "
                           "is needed to splice device-packed words")
    return lib


def _prefix_assemble(st: dict) -> list:
    """Host half: fetch the dense words and chunk bit counts, splice the
    per-group sections natively, emit headers and TOC. Returns one
    codestream per image of the batch."""
    native_lib()
    options = st["options"]
    h, w, nch = st["h"], st["w"], st["nch"]
    words = st["words_dev"].cpu().numpy().view(np.uint32)
    chunk_bits = st["chunk_bits_dev"].cpu().numpy().astype(np.uint16)
    # chunks start PACK_ROW-word aligned in the dense stream; the splice
    # reads exactly chunk_bits bits of each, so the slack never lands
    nw = ((chunk_bits.astype(np.int64) + 255) >> 8) << 3
    word_start = np.concatenate([[0], np.cumsum(nw)]).astype(np.int64)
    bw, fd = _frame_headers(h, w, st["bits"], nch, options)
    header_bytes, header_bits = bw.to_bytes(), bw.bits_written
    gd = fd.group_dim
    chunks_per_group = nch * gd * gd // PACK_T
    chunks_per_image = st["ng"] * chunks_per_group
    dc_bytes, dc_bits = _global_bits(st["codes"],
                                     options.use_rct and nch >= 3)
    ghw = BitWriter()
    GroupHeader(use_global_tree=True).write(ghw)
    gh_bytes, gh_bits = ghw.to_bytes(), ghw.bits_written

    def section(prefix_bytes: bytes, prefix_nbits: int, i: int, g: int):
        c0 = i * chunks_per_image + g * chunks_per_group
        return native.splice_section(prefix_bytes, prefix_nbits, words,
                                     word_start, chunk_bits, c0,
                                     c0 + chunks_per_group)

    if fd.num_groups == 1:
        return [_stream(header_bytes, header_bits, fd,
                        section(dc_bytes, dc_bits, i, 0), [])
                for i in range(st["n_images"])]
    sw = BitWriter()
    sw.append_packed(dc_bytes, dc_bits)
    sw.zero_pad_to_byte()
    dc_section = sw.to_bytes()
    jobs = [(i, g) for i in range(st["n_images"])
            for g in range(fd.num_groups)]
    with ThreadPoolExecutor(_splice_threads(fd.num_groups)) as ex:
        flat = list(ex.map(lambda ig: section(gh_bytes, gh_bits, *ig),
                           jobs))
    n = fd.num_groups
    return [_stream(header_bytes, header_bits, fd, dc_section,
                    flat[i * n:(i + 1) * n])
            for i in range(st["n_images"])]


def _splice_threads(n_groups: int) -> int:
    """Threads of one image's splice: the native splice releases the
    GIL, so more than one group is spliced across threads."""
    return 1 if n_groups == 1 else min(8, os.cpu_count() or 1)


def _assemble_lossless_device(pixels: np.ndarray, options: EncodeOptions,
                              collected) -> bytes:
    """Host half of the ANS device path: headers + per-group rANS
    emission of the device residuals (``libjxl_tpu``'s function of the
    same name, which leaves the WP header of its group headers at the
    default)."""
    from libjxl_torch.entropy.ans import (
        build_entropy_codes_from_histogram, write_tokens_pretokenized,
    )
    from libjxl_torch.entropy.hybrid import DEFAULT_UINT_CONFIG

    h, w, nch = pixels.shape
    packed, mask, hist = collected
    codes = build_entropy_codes_from_histogram(hist)
    bw, fd = _frame_headers(h, w, 8 if pixels.dtype == np.uint8 else 16,
                            nch, options)

    def group_stream(sw: BitWriter, g: int) -> None:
        gx, gy = g % fd.xsize_groups, g // fd.xsize_groups
        gw_v = min(fd.group_dim, w - gx * fd.group_dim)
        gh_v = min(fd.group_dim, h - gy * fd.group_dim)
        res = native.lossless_group_encode(
            packed[g], gw_v, gh_v, codes.counts[0], codes.slot_starts[0],
            codes.slots[0])
        if res is not None:
            sw.append_packed(*res)
            return
        m = np.broadcast_to(mask[g], packed[g].shape)
        t, nb, b = DEFAULT_UINT_CONFIG.encode_array(packed[g][m])
        write_tokens_pretokenized(sw, t, nb, b, codes)

    def dc_section() -> bytes:
        sw = BitWriter()
        sw.append_packed(*_global_bits(codes, options.use_rct and nch >= 3))
        if fd.num_groups == 1:
            group_stream(sw, 0)
        sw.zero_pad_to_byte()
        return sw.to_bytes()

    def ac_group_section(g: int) -> bytes:
        sw = BitWriter()
        GroupHeader(use_global_tree=True).write(sw)
        group_stream(sw, g)
        sw.zero_pad_to_byte()
        return sw.to_bytes()

    groups = []
    if fd.num_groups > 1:
        native.get_lib()     # build/bind once before the pool
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
            groups = list(ex.map(ac_group_section, range(fd.num_groups)))
    return _stream(bw.to_bytes(), bw.bits_written, fd, dc_section(), groups)
