"""High-level decoder: codestream -> pixels.

Full multi-frame flow (reference ``lib/jxl/dec_frame.cc``,
``render_pipeline/stage_blending.cc``): frames are decoded to float
channel stacks, composited onto a canvas with the header blend mode,
and stored into reference-frame slots for patches/animation reuse.

The port's copy of ``libjxl_tpu/api/decoder.py``: ``decode`` is the host
decoder, with the numpy (float64) restoration filters at every size.
``decode_many`` reconstructs DCT8 4:4:4 frames on the device
(``models/vardct_decode.py``). ``decode_exact`` checks many lossless
streams against their images in spawned worker processes, because the
host decoder reads prefix-coded modular streams symbol by symbol in
Python (several microseconds a symbol).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from libjxl_torch.api.codestream import (
    CodecMetadata, parse_codestream, read_codec_metadata,
)
from libjxl_torch.core.fields import FormatError, read_f16
from libjxl_torch.core.frame_header import (
    ColorTransform, FrameEncoding, FrameFlags, FrameType,
)
from libjxl_torch.core.geometry import FrameDimensions
from libjxl_torch.core.toc import ac_group_index
from libjxl_torch.modular.frame import (
    ModularFrameDecoder, get_downsampling_bracket, stream_id_modular_ac,
    stream_id_modular_dc,
)
from libjxl_torch.utils.bits import BitReader


def _decode_dequant_dc(r: BitReader) -> tuple:
    """DequantMatrices::DecodeDC (quant_weights.cc:513-528)."""
    all_default = r.read(1) == 1
    dc_quant = [1.0 / 4096, 1.0 / 512, 1.0 / 256]  # kDCQuant defaults
    if not all_default:
        dc_quant = [read_f16(r) / 128.0 for _ in range(3)]
    return dc_quant


def decode_modular_frame(meta: CodecMetadata, frame,
                         return_dc_quant: bool = False,
                         reference_frames=None):
    """Decode one modular frame's sections into channel data.

    Image features (patches/splines/noise) signaled on modular frames
    are parsed from the DC-global section (dec_frame.cc ProcessDCGlobal
    order) and returned on the finalized image as ``features`` for the
    render stage to apply."""
    fh = frame.header
    fd = frame.dims
    dec = ModularFrameDecoder(fh, meta.m, fd)
    dc_quant = None
    features = {}

    def read_features(r: BitReader) -> None:
        if fh.flags & FrameFlags.PATCHES:
            from libjxl_torch.render.patches import decode_patches
            features["patches"] = decode_patches(
                r, fd.xsize_padded, fd.ysize_padded,
                meta.m.num_extra_channels,
                reference_frames or [None] * 4)
        if fh.flags & FrameFlags.SPLINES:
            from libjxl_torch.render.splines import decode_splines
            features["splines"] = decode_splines(r, fd.xsize * fd.ysize)
        if fh.flags & FrameFlags.NOISE:
            from libjxl_torch.render.noise import decode_noise
            features["noise"] = decode_noise(r)

    single = len(frame.sections) == 1
    if single:
        if frame.sections[0] is None:
            raise FormatError("truncated stream")
        r = BitReader(frame.sections[0])
        read_features(r)
        dc_quant = _decode_dequant_dc(r)
        dec.decode_global_info(r)
        dec.decode_group(r, (0, 0, fd.dc_group_dim, fd.dc_group_dim), 3,
                         1000, stream_id_modular_dc(fd, 0))
        for pass_idx in range(fh.passes.num_passes):
            mins, maxs = get_downsampling_bracket(fh.passes, pass_idx)
            dec.decode_group(r, (0, 0, fd.group_dim, fd.group_dim), mins,
                             maxs, stream_id_modular_ac(fd, 0, pass_idx))
    else:
        if frame.sections[0] is None:
            raise FormatError("truncated stream: DC global missing")
        r = BitReader(frame.sections[0])
        read_features(r)
        dc_quant = _decode_dequant_dc(r)
        dec.decode_global_info(r)
        for g in range(fd.num_dc_groups):
            if frame.sections[1 + g] is None:
                continue        # partial: channel region stays zero
            r = BitReader(frame.sections[1 + g])
            gx = g % fd.xsize_dc_groups
            gy = g // fd.xsize_dc_groups
            dec.decode_group(
                r, (gx * fd.dc_group_dim, gy * fd.dc_group_dim,
                    fd.dc_group_dim, fd.dc_group_dim), 3, 1000,
                stream_id_modular_dc(fd, g))
        # AC global section: nothing for modular frames.
        # Groups are independent sections (TOC random access); fan them
        # out through the runner — the native channel decoder releases
        # the GIL, so threads scale.
        for pass_idx in range(fh.passes.num_passes):
            mins, maxs = get_downsampling_bracket(fh.passes, pass_idx)

            def _group(g: int, pass_idx=pass_idx, mins=mins, maxs=maxs):
                sec = ac_group_index(pass_idx, g, fd.num_groups,
                                     fd.num_dc_groups)
                if frame.sections[sec] is None:
                    return      # partial: later passes/groups missing
                r = BitReader(frame.sections[sec])
                gx = g % fd.xsize_groups
                gy = g // fd.xsize_groups
                dec.decode_group(
                    r, (gx * fd.group_dim, gy * fd.group_dim,
                        fd.group_dim, fd.group_dim), mins, maxs,
                    stream_id_modular_ac(fd, g, pass_idx))

            if fd.num_groups > 2:
                from libjxl_torch.parallel.runner import default_runner
                list(default_runner().map(_group, range(fd.num_groups)))
            else:
                for g in range(fd.num_groups):
                    _group(g)
    fi = dec.finalize()
    fi.features = features
    if return_dc_quant:
        return fi, dc_quant
    return fi


def _cms_output(linear: np.ndarray, ce, intensity: float) -> np.ndarray:
    """Linear sRGB planes -> signal in the stream's color encoding
    (the decoder's default output space, like djxl). sRGB-enum streams
    keep the fast path; ICC-described color falls back to sRGB with an
    explicit call-out (full ICC parsing is the cms/jxl_cms.cc surface
    not yet covered)."""
    from libjxl_torch.core.headers import (
        ColorSpace, Primaries, TransferFunction, WhitePoint,
    )
    from libjxl_torch.color.xyb import linear_to_srgb

    if ce.want_icc:
        # matrix/TRC ICC profiles get true color management
        # (color/icc_profile.py; the jxl_cms.cc surface); LUT-based
        # profiles fall back to sRGB output with a call-out
        try:
            from libjxl_torch.color.icc_profile import linear_srgb_to_icc
            return linear_srgb_to_icc(np.asarray(linear, np.float64),
                                      ce.icc).astype(np.float32)
        except ValueError as e:
            import warnings
            warnings.warn(
                f"ICC profile not color-managed ({e}); output is sRGB",
                stacklevel=3)
            return linear_to_srgb(linear)
    if _is_srgb_like(ce):
        return linear_to_srgb(linear)
    from libjxl_torch.color.cms import linear_srgb_to_encoding
    return linear_srgb_to_encoding(linear, ce, intensity)


def _is_srgb_like(ce) -> bool:
    """True when the output encoding is plain sRGB (the fast path both
    on host and in the fused device output program)."""
    from libjxl_torch.core.headers import (
        ColorSpace, Primaries, TransferFunction, WhitePoint,
    )
    return (not ce.want_icc and
            ce.color_space == ColorSpace.RGB and
            ce.white_point == WhitePoint.D65 and
            ce.primaries == Primaries.SRGB and
            not ce.tf.have_gamma and
            ce.tf.transfer_function in (TransferFunction.SRGB,
                                        TransferFunction.UNKNOWN))


def _group_pool():
    """Per-group decode fan-out goes through the pluggable runner seam
    (parallel/runner.py; the reference threads a JxlParallelRunner
    through every such loop, parallel_runner.h)."""
    from libjxl_torch.parallel.runner import default_runner
    return default_runner()


def decode_vardct_frame(meta: CodecMetadata, frame,
                        reference_frames=None,
                        dc_image=None, _return_prefilter=False):
    """Decode one VarDCT frame to a float XYB image, then apply the
    restoration filters, patches/splines, frame upsampling and noise;
    returns (3, H, W) XYB (pre-color-transform). Stage order per
    dec_cache.cc:142-217: gaborish -> EPF -> patches -> splines ->
    upsampling -> noise."""
    from libjxl_torch.vardct.frame_dec import VarDCTFrameDecoder
    from libjxl_torch.render.filters import compute_sigma, epf_step0, \
        epf_step1, epf_step2, gaborish

    fh = frame.header
    fd = frame.dims
    dec = VarDCTFrameDecoder(fh, meta.m, fd)
    dec.reference_frames = reference_frames or [None] * 4
    if fh.flags & FrameFlags.USE_DC_FRAME:
        if dc_image is None:
            raise FormatError("frame needs a DC frame that is missing")
        # the stored DC frame is the 8x-downsampled image (dec_frame.cc:352)
        yb, xb = fd.ysize_blocks, fd.xsize_blocks
        dec.dc = dc_image[:, :yb, :xb].astype(np.float32)
    single = len(frame.sections) == 1
    if single:
        if frame.sections[0] is None:
            raise FormatError("truncated stream")
        r = BitReader(frame.sections[0])
        dec.decode_dc_global(r)
        dec.decode_dc_group(r, 0)
        dec.finalize_dc()
        dec.decode_ac_global(r)
        dec.decode_ac_group([r], 0, fh.passes.num_passes)
    else:
        allow_partial = frame.partial
        if frame.sections[0] is None:
            raise FormatError("truncated stream: DC global missing")
        r = BitReader(frame.sections[0])
        dec.decode_dc_global(r)
        missing_ac = set()
        for g in range(fd.num_dc_groups):
            sec = frame.sections[1 + g]
            if sec is None:
                continue    # DC stays zero; covered AC blocks skipped
            dec.decode_dc_group(BitReader(sec), g)
        dec.finalize_dc()
        ac_gl = frame.sections[1 + fd.num_dc_groups]
        if ac_gl is None:
            missing_ac.update(range(fd.num_groups))
        else:
            dec.decode_ac_global(BitReader(ac_gl))

        def _ac(g: int) -> None:
            secs = [frame.sections[ac_group_index(
                p, g, fd.num_groups, fd.num_dc_groups)]
                for p in range(fh.passes.num_passes)]
            # progressive robustness: decode the complete prefix of
            # passes; a missing LATER pass still renders the earlier ones
            npass = 0
            while npass < len(secs) and secs[npass] is not None:
                npass += 1
            if npass == 0:
                missing_ac.add(g)
                return
            try:
                dec.decode_ac_group([BitReader(s) for s in secs[:npass]],
                                    g, npass)
            except (FormatError, ValueError, IndexError):
                if not allow_partial:
                    raise
                missing_ac.add(g)   # e.g. its DC group was truncated

        # AC groups are independent by design (TOC random access,
        # doc/format_overview.md:180-193); the native token decoder
        # releases the GIL, so host threads parallelize them. Extra-
        # channel modular data shares decoder state -> sequential then.
        no_ec = (dec.mfd.full_image is None or
                 not dec.mfd.full_image.channel)
        groups_todo = [g for g in range(fd.num_groups)
                       if g not in missing_ac]
        done = False
        if no_ec and fh.passes.num_passes == 1 and not missing_ac:
            # one native call decodes every AC section concurrently
            secs = {g: (frame.sections[ac_group_index(
                0, g, fd.num_groups, fd.num_dc_groups)], 0)
                for g in groups_todo}
            decoded = None
            if all(s[0] is not None for s in secs.values()):
                decoded = dec.decode_ac_frame_native(secs)
            if decoded is not None:
                recon = list(decoded.values())
                if len(recon) > 3:
                    list(_group_pool().map(
                        lambda a: dec._reconstruct_group_batched(*a),
                        recon))
                else:
                    for a in recon:
                        dec._reconstruct_group_batched(*a)
                done = True
        if not done:
            if no_ec and len(groups_todo) > 3:
                list(_group_pool().map(_ac, groups_todo))
            else:
                for g in groups_todo:
                    _ac(g)
        if missing_ac and not allow_partial:
            raise FormatError("truncated stream: AC sections missing")
        if missing_ac and dec.is_444:
            # forced draw from DC (dec_frame.cc:735 Flush): missing
            # groups render as the 8x-upsampled DC image
            gdb = fd.group_dim // 8
            for g in missing_ac:
                gx, gy = g % fd.xsize_groups, g // fd.xsize_groups
                bx0, by0 = gx * gdb, gy * gdb
                bw = min(gdb, fd.xsize_blocks - bx0)
                bh = min(gdb, fd.ysize_blocks - by0)
                dcb = dec.dc[:, by0:by0 + bh, bx0:bx0 + bw]
                up = np.repeat(np.repeat(dcb, 8, axis=1), 8, axis=2)
                dec.pixels[:, by0 * 8:(by0 + bh) * 8,
                           bx0 * 8:(bx0 + bw) * 8] = up

    if not dec.is_444:
        # chroma upsampling is the first render stage (dec_cache.cc:142)
        from libjxl_torch.color.xyb import chroma_upsample
        from libjxl_torch.core.geometry import cdiv
        planes = []
        for c in range(3):
            p = dec.pixels_c[c]
            # crop to the visible subsampled size first: the pipeline
            # mirrors at the image edge rather than using padding blocks
            p = p[:cdiv(fd.ysize, 1 << dec.vs[c]),
                  :cdiv(fd.xsize, 1 << dec.hs[c])]
            for _ in range(dec.hs[c]):
                p = chroma_upsample(p, horizontal=True)
            for _ in range(dec.vs[c]):
                p = chroma_upsample(p, horizontal=False)
            planes.append(p[:fd.ysize, :fd.xsize])
        dec.pixels = np.stack(planes)
    xyb = dec.pixels[:, :fd.ysize, :fd.xsize]
    lf = fh.loop_filter
    if _return_prefilter:
        # encoder hook (EPF sharpness search, enc_heuristics.cc:892):
        # the pre-filter reconstruction + decoder state lets the caller
        # re-run gaborish/EPF with candidate sharpness fields locally
        return xyb, dec, lf
    from libjxl_torch.render.pipeline import (
        build_render_pipeline, run_render_pipeline,
    )
    stages = build_render_pipeline(fh, meta, dec)
    ctx = dict(dec=dec, fh=fh, meta=meta, fd=fd, lf=lf)
    xyb = run_render_pipeline(stages, xyb, ctx)
    if dec.mfd.full_image is not None and dec.mfd.full_image.channel:
        fi = dec.mfd.finalize()
        xyb = np.asarray(xyb)
        try:
            xyb._ec_planes = [ch.plane for ch in fi.channel]
        except AttributeError:   # plain ndarray: wrap in a subclass
            class _ArrWithEC(np.ndarray):
                pass
            xyb = xyb.view(_ArrWithEC)
            xyb._ec_planes = [ch.plane for ch in fi.channel]
    return xyb


@dataclass
class DecodedFrame:
    header: object
    pixels: np.ndarray          # (h, w, 3+nec) float in output space
    duration: int = 0


def _frame_to_float(meta: CodecMetadata, fs, refs, dc_store=None):
    """Decode one frame to float channels.

    Returns (output_space_image, pre_ct_image): output is (3+nec, h, w)
    sRGB-encoded floats; pre_ct is the pre-color-transform image (for
    save_before_color_transform reference slots)."""
    from libjxl_torch.color.xyb import linear_to_srgb, xyb_to_linear

    fh = fs.header
    nec = meta.m.num_extra_channels
    bits = meta.m.bit_depth.bits_per_sample
    maxval = float((1 << min(bits, 16)) - 1)
    if fh.encoding != FrameEncoding.MODULAR:
        dc_image = (dc_store or {}).get(fh.dc_level + 1)
        xyb = decode_vardct_frame(meta, fs, refs, dc_image)
        if not isinstance(xyb, np.ndarray):
            xyb = np.asarray(xyb)      # multi-frame compositing is host
        pre_ct = xyb
        if fh.color_transform == ColorTransform.YCBCR:
            from libjxl_torch.color.xyb import ycbcr_to_rgb
            out = np.stack(ycbcr_to_rgb(xyb[0], xyb[1],
                                        xyb[2])).astype(np.float32)
        else:
            intensity = meta.m.tone_mapping.intensity_target
            linear = xyb_to_linear(xyb, intensity_target=intensity)
            out = linear_to_srgb(linear).astype(np.float32)
        ec = []
        mfd_img = getattr(xyb, "_ec_planes", None)
        for i in range(nec):
            if mfd_img is not None and i < len(mfd_img):
                plane = mfd_img[i]
                ecups = (fh.extra_channel_upsampling[i]
                         if fh.extra_channel_upsampling else 1)
                if ecups > 1:
                    # EC planes decode at 1/ecups and upsample in their
                    # own render stage (stage_upsampling.cc on ECs)
                    from libjxl_torch.render.upsample import upsample_image
                    plane = upsample_image(
                        plane.astype(np.float32)[None],
                        ecups.bit_length() - 1,
                        meta.transform_data)[0]
                ec.append(plane[:out.shape[1], :out.shape[2]].astype(
                    np.float32) / maxval)
            else:
                ec.append(np.ones(out.shape[1:], np.float32))
        if ec:
            from libjxl_torch.render.pipeline import apply_spot_colors
            out = apply_spot_colors(out, ec, meta.m.extra_channel_info)
        img = np.concatenate([out] + [e[None] for e in ec]) if ec else out
        return img, pre_ct
    if fh.color_transform == ColorTransform.XYB:
        # XYB modular: channels are quantized Y, X, (B-Y), scaled by the
        # DC quants (dec_modular.cc:575-633)
        fi, dc_quant = decode_modular_frame(meta, fs, return_dc_quant=True)
        chy = fi.channel[0].plane.astype(np.float32)
        chx = fi.channel[1].plane.astype(np.float32)
        chb = fi.channel[2].plane.astype(np.float32)
        xyb = np.stack([chx * dc_quant[0], chy * dc_quant[1],
                        (chb + chy) * dc_quant[2]])
        intensity = meta.m.tone_mapping.intensity_target
        out = linear_to_srgb(xyb_to_linear(
            xyb, intensity_target=intensity)).astype(np.float32)
        return out, xyb
    fi = decode_modular_frame(meta, fs, reference_frames=refs)
    planes = [ch.plane.astype(np.float32) / maxval for ch in fi.channel]
    if fh.color_transform == ColorTransform.YCBCR:
        planes = _ycbcr_planes_to_rgb(planes, fh)
    if len(planes) == 1 + nec and meta.m.color_encoding.channels == 1:
        # grayscale frame: the internal compositing representation is
        # always (3 + nec) channels (blending/patches are per-channel
        # identical); the output stage re-collapses to one channel
        planes = [planes[0], planes[0], planes[0]] + planes[1:]
    if len(planes) < 3 + nec:
        raise FormatError("frame is missing channels")
    if nec:
        from libjxl_torch.render.pipeline import apply_spot_colors
        color = apply_spot_colors(np.stack(planes[:3]), planes[3:],
                                  meta.m.extra_channel_info)
        planes = [color[0], color[1], color[2]] + planes[3:]
    img = np.stack(planes)
    feats = getattr(fi, "features", {})
    if feats.get("patches") is not None:
        from libjxl_torch.render.patches import apply_patches
        img = apply_patches(img, feats["patches"], refs,
                            meta.m.extra_channel_info)
    if feats.get("splines") is not None:
        # modular frames carry no cmap; splines draw with the default
        # base correlations (splines.cc draw-time cmap defaults)
        from libjxl_torch.render.splines import render_splines
        from libjxl_torch.vardct.cfl import ColorCorrelation
        cc = ColorCorrelation()
        color = render_splines(img[:3], feats["splines"],
                               cc.ytox_ratio(0), cc.ytob_ratio(0))
        img = np.concatenate([color, img[3:]]) if img.shape[0] > 3 \
            else color
    if feats.get("noise") is not None:
        from libjxl_torch.render.noise import add_noise
        from libjxl_torch.vardct.cfl import ColorCorrelation
        cc = ColorCorrelation()
        color = add_noise(img[:3], feats["noise"], fh.group_dim,
                          base_correlation_x=cc.base_correlation_x,
                          base_correlation_b=cc.base_correlation_b)
        img = np.concatenate([color, img[3:]]) if img.shape[0] > 3 \
            else color
    return img, img


def decode_rows(data: bytes, gy_range: tuple | None = None):
    """Low-memory banded decode (low_memory_render_pipeline.cc /
    dec_group_border.h halo model): yields ``(y0, band_u8)`` tuples of
    output rows top-to-bottom, with PIXEL memory bounded by three group
    rows (the current 256-row band plus an 8-px halo on each side) —
    the full frame is never materialized. A one-band delay provides the
    bottom halo so the restoration filters are exact everywhere.

    ``gy_range``: optional (a, b) group-row window — only bands
    a..b-1 are produced (each boundary decodes one extra neighbor band
    for its filter halo; output bytes are identical to the full run).
    This is the per-process unit of the multi-host sharded decode
    (parallel/multihost.decode_multihost).

    Supported on single-frame 4:4:4 VarDCT streams without
    patches/splines/noise/upsampling/extra channels; other streams fall
    back to a whole-frame decode sliced into identical yields.
    (Compressed section bytes are held in memory — the same concession
    the spec streaming encoder makes.)"""
    from libjxl_torch.api.container import extract_codestream
    from libjxl_torch.color.xyb import linear_to_srgb, xyb_to_linear
    from libjxl_torch.render.filters import (
        compute_sigma, epf_step0, epf_step1, epf_step2, gaborish,
    )
    from libjxl_torch.vardct.frame_dec import VarDCTFrameDecoder

    meta, frames = parse_codestream(extract_codestream(data))
    fs = frames[-1]
    fh = fs.header
    fd = fs.dims
    # feature frames (patch atlases, LF pyramids) preceding the displayed
    # frame are small and decode whole; the DISPLAYED frame streams
    # banded. Patches/splines/noise render band-windowed (the feature
    # renderers are window-exact).
    refs = [None] * 4
    pre_ok = all(f.header.frame_type in (FrameType.REFERENCE_ONLY,)
                 and not getattr(f.header, "nonserialized_is_preview",
                                 False)
                 for f in frames[:-1])
    banded_ok = (
        pre_ok and fh.encoding == FrameEncoding.VARDCT and
        not (fh.flags & FrameFlags.USE_DC_FRAME) and
        not fh.custom_size_or_origin and
        fh.upsampling == 1 and meta.m.num_extra_channels == 0 and
        fh.chroma_subsampling.max_hshift == 0 and
        fh.chroma_subsampling.max_vshift == 0 and
        len(fs.sections) > 1)
    if banded_ok and len(frames) > 1:
        for f in frames[:-1]:
            img, pre_ct = _frame_to_float(meta, f, refs)
            refs[f.header.save_as_reference] = \
                pre_ct if f.header.save_before_color_transform else img
    if not banded_ok:
        fs = frames[0]
        fh = fs.header
        fd = fs.dims
        mod = _modular_banded_plan(meta, fs)
        if mod is not None:
            yield from _decode_rows_modular(meta, fs, *mod)
            return
        full = decode(data)
        gd = 256
        for y0 in range(0, full.shape[0], gd):
            yield y0, full[y0:y0 + gd]
        return

    dec = VarDCTFrameDecoder(fh, meta.m, fd)
    dec.reference_frames = refs
    dec.pixels = None                       # no full-frame buffer
    if fs.sections[0] is None:
        raise FormatError("truncated stream: DC global missing")
    dec.decode_dc_global(BitReader(fs.sections[0]))
    for g in range(fd.num_dc_groups):
        sec = fs.sections[1 + g]
        if sec is None:
            raise FormatError("truncated stream: DC group missing")
        dec.decode_dc_group(BitReader(sec), g)
    dec.finalize_dc()
    dec.decode_ac_global(BitReader(fs.sections[1 + fd.num_dc_groups]))

    lf = fh.loop_filter
    gd = fd.group_dim
    margin = 8                              # > gaborish(1) + EPF(<=6)
    w8 = fd.xsize_blocks * 8
    intensity = meta.m.tone_mapping.intensity_target

    def decode_band(gy: int) -> np.ndarray:
        rows = min(gd, fd.ysize_blocks * 8 - gy * gd)
        dec.pixels = np.zeros((3, rows, w8), np.float32)
        dec.pixel_row0 = gy * gd
        for gx in range(fd.xsize_groups):
            g = gy * fd.xsize_groups + gx
            secs = [fs.sections[ac_group_index(
                p, g, fd.num_groups, fd.num_dc_groups)]
                for p in range(fh.passes.num_passes)]
            if any(s is None for s in secs):
                raise FormatError("truncated stream: AC section missing")
            dec.decode_ac_group([BitReader(s) for s in secs],
                                g, fh.passes.num_passes)
        # crop to the visible image NOW: the whole-frame path filters
        # the cropped image, so mirror boundaries must sit at the image
        # edge, not the block-padded edge
        return dec.pixels[:, :min(gd, fd.ysize - gy * gd), :fd.xsize]

    def filter_band(prev_tail, band, next_head, gy: int):
        parts = [p for p in (prev_tail, band, next_head) if p is not None]
        ext = np.concatenate(parts, axis=1)
        top = 0 if prev_tail is None else prev_tail.shape[1]
        if lf.gab or lf.epf_iters > 0:
            # block-row slice of the per-block fields covering ext
            br0 = (gy * gd - top) // 8
            br1 = br0 + -(-ext.shape[1] // 8)
            if lf.epf_iters > 0:
                inv_sigma = compute_sigma(
                    lf, dec.acs_raw[br0:br1], dec.acs_anchor[br0:br1],
                    dec.raw_quant[br0:br1], dec.epf_sharpness[br0:br1],
                    dec.quantizer.scale)
            if lf.gab:
                ext = gaborish(ext, lf)
            if lf.epf_iters > 0:
                if lf.epf_iters >= 3:
                    ext = epf_step0(ext, inv_sigma, lf)
                ext = epf_step1(ext, inv_sigma, lf)
                if lf.epf_iters >= 2:
                    ext = epf_step2(ext, inv_sigma, lf)
        return ext[:, top:top + band.shape[1]]

    maxval = float((1 << min(meta.m.bit_depth.bits_per_sample, 16)) - 1)
    out_dtype = np.uint8 if maxval <= 255 else np.uint16

    def feature_band(xyb_band: np.ndarray, row0: int) -> np.ndarray:
        """Band-windowed image features, same order as the render
        pipeline (dec_cache.cc:142-217: patches -> splines -> noise);
        each renderer is window-exact."""
        if fh.flags & FrameFlags.PATCHES:
            from libjxl_torch.render.patches import apply_patches_band
            xyb_band = apply_patches_band(
                xyb_band, row0, dec.patches, refs,
                meta.m.extra_channel_info)
        if fh.flags & FrameFlags.SPLINES:
            from libjxl_torch.render.splines import render_splines
            xyb_band = render_splines(
                xyb_band, dec.splines, dec.cmap.ytox_ratio(0),
                dec.cmap.ytob_ratio(0), row0=row0, h_total=fd.ysize)
        if fh.flags & FrameFlags.NOISE:
            from libjxl_torch.render.noise import add_noise_band
            xyb_band = add_noise_band(
                xyb_band, dec.noise_lut, fh.group_dim, row0, fd.ysize,
                base_correlation_x=dec.cmap.base_correlation_x,
                base_correlation_b=dec.cmap.base_correlation_b)
        return xyb_band

    def to_output(xyb_band: np.ndarray) -> np.ndarray:
        linear = xyb_to_linear(xyb_band, intensity_target=intensity)
        srgb = linear_to_srgb(linear)
        u = np.clip(np.round(srgb * maxval), 0, maxval).astype(out_dtype)
        return np.moveaxis(u, 0, -1)

    n_gy = fd.ysize_groups
    a, b = (0, n_gy) if gy_range is None else gy_range
    a, b = max(0, a), min(n_gy, b)
    # each output band filters with its neighbors' pre-filter margins
    # (decoded once via a 3-band cache) — for a partial range this
    # decodes one extra band per boundary, keeping the output
    # bit-identical to the full run (the multi-host halo model)
    cache: dict = {}

    def get_band(gy: int):
        if gy < 0 or gy >= n_gy:
            return None
        if gy not in cache:
            cache[gy] = decode_band(gy)
        return cache[gy]

    for gy in range(a, b):
        bandm = get_band(gy - 1)
        band = get_band(gy)
        bandp = get_band(gy + 1)
        done = filter_band(
            None if bandm is None else bandm[:, -margin:], band,
            None if bandp is None else bandp[:, :margin], gy)
        y0 = gy * gd
        if y0 < fd.ysize:
            done = feature_band(done, y0)
            yield y0, to_output(done)
        cache.pop(gy - 1, None)


def _modular_banded_plan(meta, fs):
    """Gate + global-stream parse for the banded modular decode:
    returns (tree, code, header, nb) when every group row can be
    decoded and inverse-transformed independently (full-size integer
    channels, global transforms all per-pixel RCTs), else None."""
    fh = fs.header
    fd = fs.dims
    if not (fh.encoding == FrameEncoding.MODULAR and
            fh.color_transform == ColorTransform.NONE and
            not (fh.flags & (FrameFlags.PATCHES | FrameFlags.SPLINES |
                             FrameFlags.NOISE)) and
            fh.upsampling == 1 and meta.m.num_extra_channels == 0 and
            getattr(meta.m, "orientation", 1) == 1 and
            fh.passes.num_passes == 1 and len(fs.sections) > 1 and
            not meta.m.bit_depth.floating_point_sample and
            fs.sections[0] is not None and
            all(s is not None for s in fs.sections)):
        return None
    from libjxl_torch.entropy.ans import decode_histograms
    from libjxl_torch.modular.codec import ModularOptions, modular_decode
    from libjxl_torch.modular.image import ModularImage
    from libjxl_torch.modular.transforms import TransformId
    from libjxl_torch.modular.tree import decode_tree
    nb = 1 if meta.m.color_encoding.channels == 1 else 3
    r0 = BitReader(fs.sections[0])
    _decode_dequant_dc(r0)
    has_tree = r0.read(1) == 1
    tree = code = None
    if has_tree:
        tree = decode_tree(r0)
        code = decode_histograms(r0, (len(tree) + 1) // 2)
    gi = ModularImage.create(fd.xsize, fd.ysize,
                             meta.m.bit_depth.bits_per_sample, nb)
    header = modular_decode(
        r0, gi, group_id=0,
        options=ModularOptions(max_chan_size=fd.group_dim),
        global_tree=tree, global_code=code, undo_transforms=False)
    for t in header.transforms:
        if int(t.id) == int(TransformId.RCT):
            continue             # per-pixel: invertible band-locally
        if int(t.id) == int(TransformId.PALETTE) and \
                t.nb_deltas == 0 and t.predictor == 0:
            continue             # pure index->color lookup, per-pixel
        return None              # squeeze / delta palette need
        #                          whole-image sequential state
    if any(c.w <= fd.group_dim and c.h <= fd.group_dim
           for c in gi.channel[gi.nb_meta_channels:]):
        return None              # pixel channels ride the global stream
    return tree, code, header, nb, gi


def _decode_rows_modular(meta, fs, tree, code, header, nb: int, gi):
    """Banded modular decode: each group row decodes its (independent)
    sections into a band, the global transforms invert per band (RCTs
    and zero-predictor palettes are per-pixel; the palette meta channel
    comes from the already-parsed global stream), and the band converts
    straight to integers."""
    from libjxl_torch.modular.codec import modular_decode
    from libjxl_torch.modular.image import Channel, ModularImage
    from libjxl_torch.parallel.runner import default_runner

    fh = fs.header
    fd = fs.dims
    bits = meta.m.bit_depth.bits_per_sample
    gd = fd.group_dim
    n_meta = gi.nb_meta_channels
    n_enc = len(gi.channel) - n_meta       # channels per AC group
    for gy in range(fd.ysize_groups):
        rows = min(gd, fd.ysize - gy * gd)
        band = np.zeros((n_enc, rows, fd.xsize), np.int32)

        def _group(gx: int, gy=gy, rows=rows, band=band):
            g = gy * fd.xsize_groups + gx
            sec = fs.sections[ac_group_index(
                0, g, fd.num_groups, fd.num_dc_groups)]
            x0 = gx * gd
            cw = min(gd, fd.xsize - x0)
            sub = ModularImage(cw, rows, bits)
            for _ in range(n_enc):
                sub.channel.append(Channel.create(cw, rows))
            modular_decode(BitReader(sec), sub,
                           group_id=stream_id_modular_ac(fd, g, 0),
                           global_tree=tree, global_code=code,
                           undo_transforms=True)
            for c in range(n_enc):
                band[c, :, x0:x0 + cw] = sub.channel[c].plane

        if fd.xsize_groups > 2:
            list(default_runner().map(_group, range(fd.xsize_groups)))
        else:
            for gx in range(fd.xsize_groups):
                _group(gx)
        bimg = ModularImage(fd.xsize, rows, bits)
        bimg.nb_meta_channels = n_meta
        for c in range(n_meta):            # shared palette channel(s)
            src = gi.channel[c]
            bimg.channel.append(Channel(src.plane, src.hshift, src.vshift))
        for c in range(n_enc):
            bimg.channel.append(Channel(band[c]))
        for t in reversed(header.transforms):
            t.inverse(bimg, header.wp_header)
        out = np.stack([c.plane for c in bimg.channel], axis=-1)
        maxv = (1 << min(bits, 16)) - 1
        out = np.clip(out, 0, maxv)
        yield gy * gd, out.astype(np.uint8 if bits <= 8 else np.uint16)


def _decode_prefilter(data: bytes):
    """Encoder-internal: decode the first regular VarDCT frame of
    ``data`` up to (not including) the restoration filters. Returns
    (xyb, dec_state, loop_filter). Reference/DC frames before it are
    decoded normally (patch atlases etc.)."""
    from libjxl_torch.api.container import extract_codestream
    meta, frames = parse_codestream(extract_codestream(data))
    refs = [None] * 4
    dc_store = {}
    for fs in frames:
        fh = fs.header
        if getattr(fh, "nonserialized_is_preview", False):
            continue
        if fh.frame_type == FrameType.REFERENCE_ONLY:
            img, pre_ct = _frame_to_float(meta, fs, refs, dc_store)
            refs[fh.save_as_reference] = \
                pre_ct if fh.save_before_color_transform else img
            continue
        if fh.frame_type == FrameType.DC_FRAME:
            _, pre_ct = _frame_to_float(meta, fs, refs, dc_store)
            dc_store[fh.dc_level] = pre_ct
            continue
        if fh.encoding != FrameEncoding.VARDCT:
            raise FormatError("prefilter decode expects a VarDCT frame")
        return decode_vardct_frame(meta, fs, refs,
                                   dc_store.get(fh.dc_level + 1),
                                   _return_prefilter=True)
    raise FormatError("no regular frame found")


def decode_frames(data: bytes):
    """Decode ALL frames (animation / layered images): returns
    (CodecMetadata, [DecodedFrame]) with blending applied."""
    from libjxl_torch.api.container import extract_codestream
    meta, frames = parse_codestream(extract_codestream(data))
    nec = meta.m.num_extra_channels
    H, W = meta.ysize, meta.xsize
    refs = [None] * 4
    dc_store = {}
    canvas = np.zeros((3 + nec, H, W), np.float32)
    displayed = []
    for fs in frames:
        fh = fs.header
        if getattr(fh, "nonserialized_is_preview", False):
            continue             # preview frame: not part of the image
        img, pre_ct = _frame_to_float(meta, fs, refs, dc_store)
        if fh.frame_type == FrameType.REFERENCE_ONLY:
            slot = fh.save_as_reference
            refs[slot] = pre_ct if fh.save_before_color_transform else img
            continue
        if fh.frame_type == FrameType.DC_FRAME:
            dc_store[fh.dc_level] = pre_ct
            continue
        # composite onto the canvas
        x0 = fh.frame_origin_x0 if fh.custom_size_or_origin else 0
        y0 = fh.frame_origin_y0 if fh.custom_size_or_origin else 0
        canvas = _blend_frame(canvas, img, fh, x0, y0, meta, refs)
        if fh.save_as_reference != 0:
            refs[fh.save_as_reference] = \
                pre_ct if fh.save_before_color_transform else canvas.copy()
        duration = fh.animation_frame.duration if meta.m.have_animation \
            else 0
        displayed.append(DecodedFrame(
            fh, np.moveaxis(canvas.copy(), 0, -1), duration))
        if fh.is_last:
            break
    return meta, displayed


def _blend_frame(canvas, img, fh, x0, y0, meta, refs=None):
    """(stage_blending.cc): composite ``img`` at (x0, y0). The blending
    background is the source reference slot when populated, else the
    running canvas."""
    from libjxl_torch.render.blending import blend_rect, \
        frame_blend_to_patch_mode
    bi0 = fh.blending_info
    if refs is not None and bi0.source != 0 and \
            refs[bi0.source] is not None and \
            refs[bi0.source].shape == canvas.shape:
        canvas = refs[bi0.source]
    H, W = canvas.shape[1:]
    fh_h, fh_w = img.shape[1:]
    # clip to canvas
    cx0, cy0 = max(0, x0), max(0, y0)
    cx1 = min(W, x0 + fh_w)
    cy1 = min(H, y0 + fh_h)
    if cx1 <= cx0 or cy1 <= cy0:
        return canvas
    sub = img[:, cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0]
    if sub.shape[0] < canvas.shape[0]:
        pad = np.ones((canvas.shape[0] - sub.shape[0],) + sub.shape[1:],
                      np.float32)
        sub = np.concatenate([sub, pad])
    bi = fh.blending_info
    mode = frame_blend_to_patch_mode(bi.mode)
    color_blending = (mode, bi.alpha_channel, bool(bi.clamp))
    ec_blending = []
    for eb in (fh.extra_channel_blending_info or []):
        ec_blending.append((frame_blend_to_patch_mode(eb.mode),
                            eb.alpha_channel, bool(eb.clamp)))
    while len(ec_blending) < canvas.shape[0] - 3:
        ec_blending.append(color_blending)
    out = canvas.copy()
    out[:, cy0:cy1, cx0:cx1] = blend_rect(
        canvas[:, cy0:cy1, cx0:cx1], sub, color_blending, ec_blending,
        meta.m.extra_channel_info)
    return out


def _device_decode_inputs(data: bytes):
    """Host half of the device decode: parse + native entropy decode one
    stream into a FrameRecon (all-DCT8) or a FrameReconVar (variable
    block sizes; models/vardct_decode.py), plus the batch key (shape,
    filters, bit depth, and for a var frame "var" and its strategy
    classes). Returns None when the stream needs the general path
    (features, extra channels, AC tables other than the defaults, ...)."""
    from libjxl_torch.api.container import extract_codestream
    from libjxl_torch.models.vardct_decode import FrameRecon, FrameReconVar
    from libjxl_torch.utils import native
    from libjxl_torch.vardct.frame_dec import VarDCTFrameDecoder

    if not native.available():
        return None
    meta, frames = parse_codestream(extract_codestream(data))
    if len(frames) != 1:
        return None
    frame = frames[0]
    fh = frame.header
    bits = meta.m.bit_depth.bits_per_sample
    if (fh.encoding == FrameEncoding.MODULAR or
            fh.color_transform != ColorTransform.XYB or
            fh.custom_size_or_origin or fh.upsampling != 1 or
            fh.passes.num_passes != 1 or
            (fh.flags & (FrameFlags.PATCHES | FrameFlags.SPLINES |
                         FrameFlags.NOISE | FrameFlags.USE_DC_FRAME)) or
            meta.m.num_extra_channels > 0 or
            meta.m.bit_depth.floating_point_sample or bits > 16 or
            meta.m.orientation != 1 or
            not _is_srgb_like(meta.m.color_encoding)):
        return None
    fd = frame.dims
    dec = VarDCTFrameDecoder(fh, meta.m, fd)
    if not dec.is_444:
        return None
    yb, xb = fd.ysize_blocks, fd.xsize_blocks
    if frame.partial or any(s is None for s in frame.sections):
        return None
    if len(frame.sections) == 1:
        r = BitReader(frame.sections[0])
        dec.decode_dc_global(r)
        dec.decode_dc_group(r, 0)
        dec.finalize_dc()
        dec.decode_ac_global(r)
        sections = {0: (frame.sections[0], r.bits_consumed)}
    else:
        r = BitReader(frame.sections[0])
        dec.decode_dc_global(r)
        for g in range(fd.num_dc_groups):
            dec.decode_dc_group(BitReader(frame.sections[1 + g]), g)
        dec.finalize_dc()
        dec.decode_ac_global(BitReader(
            frame.sections[1 + fd.num_dc_groups]))
        sections = {g: (frame.sections[ac_group_index(
            0, g, fd.num_groups, fd.num_dc_groups)], 0)
            for g in range(fd.num_groups)}
    if dec.jpeg_mode:
        return None
    # the device dequantizes with the default AC tables (one table for
    # the whole batch): a stream that signals its own goes to the host
    if not dec.matrices.encodings_default:
        return None
    lf = fh.loop_filter
    key = (meta.ysize, meta.xsize, yb, xb, bool(lf.gab), int(lf.epf_iters),
           bits)
    is_var = bool((dec.acs_raw[dec.acs_anchor] != 0).any())
    # all-8x8 stream: the native decoder emits (flat idx, value)
    # pairs directly — no dense (3, yb, xb, 64) buffer, no
    # sparsify rescan (halves the stage's memory traffic)
    sparse_pairs = None if is_var else dec.decode_ac_frame_native(
        sections, sparse=True)
    if sparse_pairs is None:
        dense_buf = None if is_var else np.zeros((3, yb, xb, 64), np.int32)
        # all AC sections in ONE native call (std::threads over groups)
        groups = dec.decode_ac_frame_native(sections, dense_buf=dense_buf)
        if groups is None:
            return None
    if dec.mfd.full_image is not None and dec.mfd.full_image.channel:
        return None
    x_dm = (1 / 1.25) ** (fh.x_qm_scale - 2.0)
    b_dm = (1 / 1.25) ** (fh.b_qm_scale - 2.0)
    if is_var:
        classes = _var_classes([groups[g] for g in sorted(groups)],
                               dec.raw_quant)
        fr = FrameReconVar(
            classes=classes,
            dc=dec.dc.astype(np.float32),
            raw_quant=dec.raw_quant, sharpness=dec.epf_sharpness,
            x_cc=dec.cmap.ytox_ratio_arr(dec.ytox_map),
            b_cc=dec.cmap.ytob_ratio_arr(dec.ytob_map),
            inv_gs=np.float32(dec.quantizer.inv_global_scale),
            dms=np.asarray([x_dm, 1.0, b_dm], np.float32),
            quant_scale=np.float32(dec.quantizer.scale),
            intensity=np.float32(meta.m.tone_mapping.intensity_target))
        return fr, key + ("var", tuple(sorted(classes))), lf
    if sparse_pairs is not None:
        nz, vals = sparse_pairs
    else:
        nz, vals = native.sparsify_i32(dense_buf)
    if len(vals) and np.abs(vals).max() > 32767:
        return None           # host path for absurd coefficients
    fr = FrameRecon(
        coeff_vals=vals.astype(np.int16),
        coeff_idx=nz,
        dc=dec.dc.astype(np.float32),
        raw_quant=dec.raw_quant,
        sharpness=dec.epf_sharpness,
        x_cc=dec.cmap.ytox_ratio_arr(dec.ytox_map),
        b_cc=dec.cmap.ytob_ratio_arr(dec.ytob_map),
        inv_gs=np.float32(dec.quantizer.inv_global_scale),
        dms=np.asarray([x_dm, 1.0, b_dm], np.float32),
        table=dec.matrices.table_for_strategy(0).reshape(3, 64).astype(
            np.float32),
        quant_scale=np.float32(dec.quantizer.scale),
        intensity=np.float32(meta.m.tone_mapping.intensity_target),
    )
    return fr, key, lf


def _var_classes(runs: list, raw_quant: np.ndarray) -> dict:
    """The nonzero quantized coefficients of a variable-block frame, per
    AC strategy class, from the native decoder's run-packed groups
    ``(bx0, by0, w, h, acs, anchors, coeffs)``: ``{s: (vals, idx, qf, fy,
    fx)}``. A class's blocks are numbered group by group, in raster order
    within a group (the reference's order); ``idx`` is the flat index of
    each value in that class's dense (n, 3, 64 * covered blocks) array in
    the stored layout, and ``vals`` is int16 unless a value of the class
    exceeds it. Most of a photo's coefficients are zero at the usual
    distances, so this is far smaller than the dense classes."""
    from libjxl_torch.utils import native
    from libjxl_torch.vardct.ac_strategy import COVERED_X, COVERED_Y

    cover = np.asarray(COVERED_X, np.int64) * np.asarray(COVERED_Y) * 64
    blk_s, blk_y, blk_x = [], [], []
    nz_blk, nz_ch, nz_k, nz_v = [], [], [], []
    n_blk = 0
    for (bx0, by0, _, _, acs_g, anc_g, coeffs) in runs:
        ys, xs = np.nonzero(anc_g)
        s = acs_g[ys, xs]
        off = np.cumsum(cover[s]) - cover[s]  # each block's first coeff
        flat, v = native.sparsify_i32(coeffs, n_threads=1)
        ch, pos = np.divmod(flat.astype(np.int64), coeffs.shape[1])
        b = np.searchsorted(off, pos, "right") - 1
        nz_blk.append(b + n_blk)
        nz_ch.append(ch)
        nz_k.append(pos - off[b])
        nz_v.append(v)
        blk_s.append(s)
        blk_y.append(by0 + ys)
        blk_x.append(bx0 + xs)
        n_blk += len(s)
    blk_s = np.concatenate(blk_s)
    blk_y = np.concatenate(blk_y).astype(np.int32)
    blk_x = np.concatenate(blk_x).astype(np.int32)
    nz_blk, nz_ch, nz_k, nz_v = (np.concatenate(a) for a in
                                 (nz_blk, nz_ch, nz_k, nz_v))
    # number each block within its class, keeping the blocks' order
    order = np.argsort(blk_s, kind="stable")
    present, first, count = np.unique(blk_s[order], return_index=True,
                                      return_counts=True)
    rank = np.empty(n_blk, np.int64)
    rank[order] = np.arange(n_blk) - np.repeat(first, count)
    nz_s = blk_s[nz_blk]
    classes = {}
    for s, f0, n in zip(present.tolist(), first, count):
        blocks = order[f0:f0 + n]
        sel = nz_s == s
        vals = nz_v[sel]
        if np.abs(vals).max(initial=0) <= 32767:
            vals = vals.astype(np.int16)
        idx = (rank[nz_blk[sel]] * 3 + nz_ch[sel]) * cover[s] + nz_k[sel]
        fy, fx = blk_y[blocks], blk_x[blocks]
        classes[s] = (vals, idx, raw_quant[fy, fx], fy, fx)
    return classes


def _group_rect(fd, g: int):
    gdb = fd.group_dim // 8
    gx, gy = g % fd.xsize_groups, g // fd.xsize_groups
    bx0, by0 = gx * gdb, gy * gdb
    return bx0, by0, min(gdb, fd.xsize_blocks - bx0), \
        min(gdb, fd.ysize_blocks - by0)


def decode_many(streams, workers: int | None = None, device=None,
                fetch: bool = True) -> list:
    """Serving-mode decode of a batch of independent codestreams.

    The host half (parse + native AC decode, ``_device_decode_inputs``)
    runs on a pool of ``workers`` spawned processes, one a core by
    default (``parallel/host_pool.py``: the pool persists across calls,
    and a failure of the pool raises). Frames of one shape, filter
    setting and bit depth are then reconstructed on ``device`` in chunks
    of 8 by ``models.vardct_decode.decode_frames_device`` (all-DCT8
    frames) or ``decode_frames_device_var`` (variable block sizes: every
    effort >= 5 encode, whatever strategy classes each frame uses), and
    only the integer images come back. ``decode_many.device_frames``
    counts the frames the device reconstructed. Streams the device
    program does not take (modular, not 4:4:4, image features, extra
    channels, AC tables other than the defaults, ...) decode on the host
    with ``decode``, on the same pool.

    With ``fetch=False`` a device frame is returned as its (h, w, 3)
    device tensor (see ``decode_frames_device``)."""
    import os

    from libjxl_torch.config import resolve_device
    from libjxl_torch.models.vardct_decode import (
        decode_frames_device, decode_frames_device_var,
    )
    from libjxl_torch.parallel import host_pool

    if not streams:
        return []
    device = resolve_device(device)
    workers = workers or os.cpu_count() or 1
    prepped = host_pool.map_decode_inputs(streams, workers)
    # frames of one shape, filters and bit depth go together; var frames
    # of different strategy classes too (each class runs over the chunk)
    by_key: dict = {}
    for i, p in enumerate(prepped):
        if p is not None:
            by_key.setdefault(p[1][:8], []).append(i)
    results: list = [None] * len(streams)
    chunk_n = 8
    for key, idxs in by_key.items():
        h, w, yb, xb, gab, epf_iters, bits = key[:7]
        fn = decode_frames_device_var if key[7:8] == ("var",) \
            else decode_frames_device
        lf = prepped[idxs[0]][2]
        # every chunk is enqueued before the first fetch, so the device
        # works on chunk i+1 while chunk i's image is copied back
        pending = []
        for c0 in range(0, len(idxs), chunk_n):
            chunk = idxs[c0:c0 + chunk_n]
            pending.append((chunk, fn(
                [prepped[i][0] for i in chunk], lf, gab, epf_iters, h, w,
                maxval=(1 << bits) - 1, device=device, fetch=False)))
            decode_many.device_frames += len(chunk)
        for chunk, out in pending:
            if fetch:
                out = out.cpu().numpy()
                if bits > 8:
                    out = out.view(np.uint16)
            for j, i in enumerate(chunk):
                results[i] = out[j]
    rest = [i for i, p in enumerate(prepped) if p is None]
    if rest:
        host = host_pool.get_pool(workers).map(decode,
                                               [streams[i] for i in rest])
        for i, o in zip(rest, host):
            results[i] = o
    return results


decode_many.device_frames = 0


def decode(data: bytes) -> np.ndarray:
    """Decode a JXL codestream to an (h, w, c) numpy array.

    Integer output at the metadata bit depth (uint8/uint16); for
    animations this is the final composited frame (use
    :func:`decode_frames` for all of them). Metadata orientation is
    applied (lib/extras exif.h semantics: the decoder rotates unless
    the caller keeps orientation)."""
    from libjxl_torch.api.container import extract_codestream
    meta = read_codec_metadata(BitReader(extract_codestream(data)))
    from libjxl_torch.config import config as _cfg
    if meta.xsize * meta.ysize > _cfg.auto_band_pixels:
        # huge frames: stream through the banded decoder so pixel
        # intermediates stay bounded by ~3 group rows instead of the
        # whole frame (low_memory_render_pipeline.cc default); output
        # bands land directly in the preallocated result
        try:
            out = None
            for y0, band in decode_rows(data):
                if out is None:
                    out = np.empty(
                        (meta.ysize, meta.xsize) + band.shape[2:],
                        band.dtype)
                out[y0:y0 + band.shape[0]] = band[:, :meta.xsize]
            if out is not None:
                if meta.m.orientation != 1:
                    from libjxl_torch.extras.exif import apply_orientation
                    out = np.ascontiguousarray(
                        apply_orientation(out, meta.m.orientation))
                return out
        except Exception:  # noqa: BLE001  (fall back to whole-frame)
            pass
    out = _decode_unoriented(data)
    if meta.m.orientation != 1:
        from libjxl_torch.extras.exif import apply_orientation
        out = np.ascontiguousarray(
            apply_orientation(out, meta.m.orientation))
    return out


def _decode_unoriented(data: bytes) -> np.ndarray:
    from libjxl_torch.api.container import extract_codestream
    meta, frames = parse_codestream(extract_codestream(data))
    if frames and getattr(frames[0].header, "nonserialized_is_preview",
                          False) and len(frames) > 1:
        frames = frames[1:]      # preview precedes the real image
    multi = len(frames) > 1 or frames[0].header.custom_size_or_origin
    if frames[0].header.encoding == FrameEncoding.MODULAR and \
            (frames[0].header.flags & (FrameFlags.PATCHES |
                                       FrameFlags.SPLINES |
                                       FrameFlags.NOISE)):
        # modular frames with image features go through the full float
        # render path (features apply after channel reconstruction)
        multi = True
    bits = meta.m.bit_depth.bits_per_sample
    if multi:
        _, displayed = decode_frames(data)
        out = displayed[-1].pixels
        if meta.m.color_encoding.channels == 1 and out.shape[2] >= 3:
            # the compositing representation is always 3+nec channels;
            # collapse back to grayscale for output
            out = np.concatenate([out[:, :, :1], out[:, :, 3:]], axis=2)
        maxv = (1 << min(bits, 16)) - 1
        out = np.clip(np.round(out * maxv), 0, maxv)
        return out.astype(np.uint8 if bits <= 8 else np.uint16)

    # single-frame fast paths (no float conversion for modular)
    frame = frames[0]
    fh = frame.header
    if fh.encoding != FrameEncoding.MODULAR:
        from libjxl_torch.color.xyb import (
            linear_to_srgb, xyb_to_linear, ycbcr_to_rgb,
        )
        xyb = decode_vardct_frame(meta, frame)
        ec_planes = getattr(xyb, "_ec_planes", None)
        xyb = xyb[:, :meta.ysize, :meta.xsize]
        ce = meta.m.color_encoding
        if fh.color_transform == ColorTransform.YCBCR:
            srgb = np.stack(ycbcr_to_rgb(xyb[0], xyb[1], xyb[2]))
        else:
            intensity = meta.m.tone_mapping.intensity_target
            linear = xyb_to_linear(xyb, intensity_target=intensity)
            srgb = _cms_output(linear, ce, intensity)
        out = np.moveaxis(srgb, 0, -1)
        if meta.m.bit_depth.floating_point_sample:
            out = out.astype(np.float32)
        else:
            maxv = (1 << bits) - 1 if bits <= 16 else 255
            out = np.clip(np.round(out * maxv), 0, maxv)
            out = out.astype(np.uint8 if bits <= 8 else np.uint16)
        if ec_planes:
            if fh.extra_channel_upsampling and \
                    any(u > 1 for u in fh.extra_channel_upsampling):
                # EC planes decode at 1/ecups (stage_upsampling.cc ECs)
                from libjxl_torch.render.upsample import upsample_image
                ec_planes = [
                    upsample_image(np.asarray(p, np.float32)[None],
                                   u.bit_length() - 1,
                                   meta.transform_data)[0]
                    if (u := (fh.extra_channel_upsampling[i]
                              if i < len(fh.extra_channel_upsampling)
                              else 1)) > 1 else p
                    for i, p in enumerate(ec_planes)]
            ec = np.stack([p[:meta.ysize, :meta.xsize] for p in ec_planes],
                          axis=-1)
            out = np.concatenate(
                [out, np.clip(ec, 0, maxv).astype(out.dtype)], axis=-1)
        return out
    if fh.color_transform == ColorTransform.XYB:
        raise FormatError("XYB modular (lossy) not yet supported")
    fi = decode_modular_frame(meta, frame)
    planes = [ch.plane for ch in fi.channel]
    if fh.color_transform == ColorTransform.YCBCR:
        maxval = float((1 << min(bits, 16)) - 1)
        planes = [p.astype(np.float32) / maxval for p in planes]
        planes = _ycbcr_planes_to_rgb(planes, fh)
        out = np.stack([p * maxval for p in planes], axis=-1)
        out = np.clip(np.round(out), 0, maxval)
        return out.astype(np.uint8 if bits <= 8 else np.uint16)
    if meta.m.bit_depth.floating_point_sample:
        # custom-float samples ride as integer bit patterns
        # (dec_modular.cc int_to_float)
        exp_bits = meta.m.bit_depth.exponent_bits_per_sample
        planes = [_int_plane_to_float(p, bits, exp_bits) for p in planes]
        return np.stack(planes, axis=-1)
    out = np.stack(planes, axis=-1)
    if bits <= 8:
        out = np.clip(out, 0, 255).astype(np.uint8)
    elif bits <= 16:
        out = np.clip(out, 0, 65535).astype(np.uint16)
    return out


def _int_plane_to_float(plane: np.ndarray, bits: int,
                        exp_bits: int) -> np.ndarray:
    """dec_modular.cc:128-187 int_to_float: the modular integers are a
    [bits]-bit custom float's bit pattern; rebuild binary32."""
    if bits == 32:
        if exp_bits != 8:
            raise FormatError("32-bit float must have 8 exponent bits")
        return plane.astype(np.int32).view(np.float32)
    exp_bias = (1 << (exp_bits - 1)) - 1
    sign_shift = bits - 1
    mant_bits = bits - exp_bits - 1
    mant_shift = 23 - mant_bits
    f = plane.astype(np.int64) & ((1 << bits) - 1)
    signbit = (f >> sign_shift).astype(np.uint32)
    f = f & ((1 << sign_shift) - 1)
    exp = (f >> mant_bits).astype(np.int64)
    mant = (f & ((1 << mant_bits) - 1)).astype(np.int64)
    naninf = exp == (1 << exp_bits) - 1
    mant32 = mant << mant_shift
    # subnormals: normalize while the implicit bit is absent
    if exp_bits < 8:
        sub = (exp == 0) & (f != 0)
        m = mant32.copy()
        e = exp.copy()
        for _ in range(24):
            go = sub & ((m & 0x800000) == 0)
            if not go.any():
                break
            m = np.where(go, m << 1, m)
            e = np.where(go, e - 1, e)
        m = np.where(sub, m & 0x7FFFFF, mant32)
        e = np.where(sub, e + 1, exp)
    else:
        m, e = mant32, exp
    e32 = np.clip(e - exp_bias + 127, 0, 255).astype(np.uint32)
    out = (signbit << 31) | (e32 << 23) | m.astype(np.uint32)
    out = np.where(f == 0, signbit << 31, out)
    out = np.where(naninf, (signbit << 31) | (np.uint32(0xFF) << 23) |
                   (mant << mant_shift).astype(np.uint32), out)
    return out.astype(np.uint32).view(np.float32)


def _ycbcr_planes_to_rgb(planes, fh):
    """Chroma-upsample subsampled planes, then YCbCr->RGB
    (stage_chroma_upsampling.cc + stage_ycbcr.cc)."""
    from libjxl_torch.color.xyb import chroma_upsample, ycbcr_to_rgb
    cs = fh.chroma_subsampling
    color = list(planes[:3])
    target_h = max(p.shape[0] for p in color)
    target_w = max(p.shape[1] for p in color)
    for c in range(3):
        for _ in range(cs.hshift(c)):
            color[c] = chroma_upsample(color[c], horizontal=True)
        for _ in range(cs.vshift(c)):
            color[c] = chroma_upsample(color[c], horizontal=False)
        color[c] = color[c][:target_h, :target_w]
    r, g, b = ycbcr_to_rgb(color[0], color[1], color[2])
    return [r, g, b] + list(planes[3:])


def _decodes_exactly(job) -> bool:
    stream, img = job
    out = decode(stream)
    return out.size == img.size and np.array_equal(out.reshape(img.shape),
                                                   img)


def decode_exact(streams, images, workers: int = 4) -> list:
    """One bool per stream: does ``decode`` give back its image exactly.
    Runs in up to ``workers`` spawned processes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    jobs = list(zip(streams, images))
    with ProcessPoolExecutor(
            max_workers=max(1, min(workers, len(jobs))),
            mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(_decodes_exactly, jobs))
