"""FrameHeader and nested bundles (reference ``lib/jxl/frame_header.cc``,
``lib/jxl/loop_filter.cc``)."""

from __future__ import annotations

from dataclasses import dataclass, field

from jxlbench.ref.jxl.core.fields import Bits, BitsOffset, FormatError, Val
from jxlbench.ref.jxl.core.headers import Bundle, _visit_name, pack_signed, \
    unpack_signed


class FrameType:
    REGULAR = 0
    DC_FRAME = 1
    REFERENCE_ONLY = 2
    SKIP_PROGRESSIVE = 3


class FrameEncoding:
    VARDCT = 0
    MODULAR = 1


class ColorTransform:
    XYB = 0
    NONE = 1
    YCBCR = 2


class BlendMode:
    REPLACE = 0
    ADD = 1
    BLEND = 2
    ALPHA_WEIGHTED_ADD = 3
    MUL = 4


class FrameFlags:
    NOISE = 1
    PATCHES = 2
    SPLINES = 16
    USE_DC_FRAME = 32
    SKIP_ADAPTIVE_DC_SMOOTHING = 128


@dataclass(eq=True)
class BlendingInfo(Bundle):
    """(frame_header.cc:65-95)."""

    mode: int = BlendMode.REPLACE
    alpha_channel: int = 0
    clamp: bool = False
    source: int = 0

    def visit(self, v, num_extra_channels: int, is_partial_frame: bool) -> None:
        self.mode = v.u32(Val(BlendMode.REPLACE), Val(BlendMode.ADD),
                          Val(BlendMode.BLEND), BitsOffset(2, 3), self.mode)
        if self.mode > BlendMode.MUL:
            raise FormatError("invalid blend mode")
        uses_alpha = self.mode in (BlendMode.BLEND,
                                   BlendMode.ALPHA_WEIGHTED_ADD)
        if num_extra_channels > 0 and uses_alpha:
            self.alpha_channel = v.u32(Val(0), Val(1), Val(2),
                                       BitsOffset(3, 3), self.alpha_channel)
            if v.is_reading and self.alpha_channel >= num_extra_channels:
                raise FormatError("invalid alpha channel for blending")
        if (num_extra_channels > 0 and uses_alpha) or self.mode == \
                BlendMode.MUL:
            self.clamp = v.bool(self.clamp)
        if self.mode != BlendMode.REPLACE or is_partial_frame:
            self.source = v.u32(Val(0), Val(1), Val(2), Val(3), self.source)


@dataclass(eq=True)
class AnimationFrame(Bundle):
    """(frame_header.cc:120-135)."""

    duration: int = 0
    timecode: int = 0

    def visit(self, v, have_animation: bool, have_timecodes: bool) -> None:
        if have_animation:
            self.duration = v.u32(Val(0), Val(1), Bits(8), Bits(32),
                                  self.duration)
        if have_timecodes:
            self.timecode = v.bits(32, self.timecode)


# Channel-mode -> (hshift, vshift), JPEG-style (frame_header.cc:30-31).
_K_HSHIFT = (0, 1, 1, 0)
_K_VSHIFT = (0, 1, 0, 1)


@dataclass(eq=True)
class YCbCrChromaSubsampling(Bundle):
    """Per-channel 2-bit subsample mode, order X(Cb) Y B(Cr)
    (frame_header.h:87-94)."""

    channel_mode: tuple = (0, 0, 0)

    def visit(self, v) -> None:
        self.channel_mode = tuple(v.bits(2, m) for m in self.channel_mode)

    @property
    def max_hshift(self) -> int:
        return max(_K_HSHIFT[m] for m in self.channel_mode)

    @property
    def max_vshift(self) -> int:
        return max(_K_VSHIFT[m] for m in self.channel_mode)

    def hshift(self, c: int) -> int:
        return self.max_hshift - _K_HSHIFT[self.channel_mode[c]]

    def vshift(self, c: int) -> int:
        return self.max_vshift - _K_VSHIFT[self.channel_mode[c]]

    @property
    def is_444(self) -> bool:
        return all(self.hshift(c) == 0 and self.vshift(c) == 0
                   for c in range(3))

    def set_sampling(self, hsample, vsample) -> None:
        """From JPEG per-component sampling factors (Y, Cb, Cr order);
        (frame_header.h:103-120)."""
        modes = []
        for c in range(3):
            cjpeg = c ^ 1 if c < 2 else c
            for i in range(4):
                if (1 << _K_HSHIFT[i] == hsample[cjpeg] and
                        1 << _K_VSHIFT[i] == vsample[cjpeg]):
                    modes.append(i)
                    break
            else:
                raise FormatError("invalid subsample mode")
        self.channel_mode = tuple(modes)


@dataclass(eq=True)
class Passes(Bundle):
    """Progressive passes (frame_header.cc:137-180)."""

    num_passes: int = 1
    num_downsample: int = 0
    shift: tuple = ()
    downsample: tuple = ()
    last_pass: tuple = ()

    def visit(self, v) -> None:
        self.num_passes = v.u32(Val(1), Val(2), Val(3), BitsOffset(3, 4),
                                self.num_passes)
        if self.num_passes != 1:
            self.num_downsample = v.u32(Val(0), Val(1), Val(2),
                                        BitsOffset(1, 3), self.num_downsample)
            if self.num_downsample > self.num_passes:
                raise FormatError("num_downsample > num_passes")
            if v.is_reading:
                self.shift = tuple(
                    v.bits(2) for _ in range(self.num_passes - 1)) + (0,)
                self.downsample = tuple(
                    v.u32(Val(1), Val(2), Val(4), Val(8))
                    for _ in range(self.num_downsample))
                self.last_pass = tuple(
                    v.u32(Val(0), Val(1), Val(2), Bits(3))
                    for _ in range(self.num_downsample))
            else:
                for i in range(self.num_passes - 1):
                    v.bits(2, self.shift[i])
                for d in self.downsample:
                    v.u32(Val(1), Val(2), Val(4), Val(8), d)
                for lp in self.last_pass:
                    v.u32(Val(0), Val(1), Val(2), Bits(3), lp)
            for i in range(1, self.num_downsample):
                if self.downsample[i] >= self.downsample[i - 1]:
                    raise FormatError("downsample must decrease")
                if self.last_pass[i] <= self.last_pass[i - 1]:
                    raise FormatError("last_pass must increase")
            for lp in self.last_pass:
                if lp >= self.num_passes:
                    raise FormatError("last_pass >= num_passes")
        else:
            self.num_downsample = 0
            self.shift = (0,)
            self.downsample = ()
            self.last_pass = ()


_GAB_W1 = 1.1 * 0.104699568
_GAB_W2 = 1.1 * 0.055680538


@dataclass(eq=True)
class LoopFilter(Bundle):
    """Gaborish + EPF parameters (loop_filter.cc:18-100)."""

    gab: bool = True
    gab_custom: bool = False
    gab_x_weight1: float = _GAB_W1
    gab_x_weight2: float = _GAB_W2
    gab_y_weight1: float = _GAB_W1
    gab_y_weight2: float = _GAB_W2
    gab_b_weight1: float = _GAB_W1
    gab_b_weight2: float = _GAB_W2
    epf_iters: int = 2
    epf_sharp_custom: bool = False
    epf_sharp_lut: tuple = tuple(i / 7.0 for i in range(8))
    epf_weight_custom: bool = False
    epf_channel_scale: tuple = (40.0, 5.0, 3.5)
    epf_pass1_zeroflush: float = 0.45
    epf_pass2_zeroflush: float = 0.6
    epf_sigma_custom: bool = False
    epf_quant_mul: float = 0.46
    epf_pass0_sigma_scale: float = 0.9
    epf_pass2_sigma_scale: float = 6.5
    epf_border_sad_mul: float = 2.0 / 3.0
    epf_sigma_for_modular: float = 1.0
    extensions: int = 0

    def visit(self, v, is_modular: bool) -> None:
        if v.all_default(self.is_all_default()):
            self.set_default()
            return
        self.gab = v.bool(self.gab)
        if self.gab:
            self.gab_custom = v.bool(self.gab_custom)
            if self.gab_custom:
                self.gab_x_weight1 = v.f16(self.gab_x_weight1)
                self.gab_x_weight2 = v.f16(self.gab_x_weight2)
                self.gab_y_weight1 = v.f16(self.gab_y_weight1)
                self.gab_y_weight2 = v.f16(self.gab_y_weight2)
                self.gab_b_weight1 = v.f16(self.gab_b_weight1)
                self.gab_b_weight2 = v.f16(self.gab_b_weight2)
        self.epf_iters = v.bits(2, self.epf_iters)
        if self.epf_iters > 0:
            if not is_modular:
                self.epf_sharp_custom = v.bool(self.epf_sharp_custom)
                if self.epf_sharp_custom:
                    self.epf_sharp_lut = tuple(
                        v.f16(x) for x in self.epf_sharp_lut)
            self.epf_weight_custom = v.bool(self.epf_weight_custom)
            if self.epf_weight_custom:
                self.epf_channel_scale = tuple(
                    v.f16(x) for x in self.epf_channel_scale)
                self.epf_pass1_zeroflush = v.f16(self.epf_pass1_zeroflush)
                self.epf_pass2_zeroflush = v.f16(self.epf_pass2_zeroflush)
            self.epf_sigma_custom = v.bool(self.epf_sigma_custom)
            if self.epf_sigma_custom:
                if not is_modular:
                    self.epf_quant_mul = v.f16(self.epf_quant_mul)
                self.epf_pass0_sigma_scale = v.f16(self.epf_pass0_sigma_scale)
                self.epf_pass2_sigma_scale = v.f16(self.epf_pass2_sigma_scale)
                self.epf_border_sad_mul = v.f16(self.epf_border_sad_mul)
            if is_modular:
                self.epf_sigma_for_modular = v.f16(self.epf_sigma_for_modular)
        if v.is_reading:
            self.extensions = v.begin_extensions()
            v.end_extensions()
        else:
            v.begin_extensions(self.extensions)
            v.end_extensions()


@dataclass(eq=True)
class FrameHeader(Bundle):
    """(frame_header.cc:215-436). ``visit`` needs the ImageMetadata for
    conditional fields (xyb_encoded, animation, extra channels)."""

    frame_type: int = FrameType.REGULAR
    encoding: int = FrameEncoding.VARDCT
    flags: int = 0
    color_transform: int = ColorTransform.XYB
    chroma_subsampling: YCbCrChromaSubsampling = field(
        default_factory=YCbCrChromaSubsampling)
    upsampling: int = 1
    extra_channel_upsampling: tuple = ()
    group_size_shift: int = 1
    x_qm_scale: int = 3
    b_qm_scale: int = 2
    passes: Passes = field(default_factory=Passes)
    dc_level: int = 0
    custom_size_or_origin: bool = False
    frame_origin_x0: int = 0
    frame_origin_y0: int = 0
    frame_xsize: int = 0
    frame_ysize: int = 0
    blending_info: BlendingInfo = field(default_factory=BlendingInfo)
    extra_channel_blending_info: list = field(default_factory=list)
    animation_frame: AnimationFrame = field(default_factory=AnimationFrame)
    is_last: bool = True
    save_as_reference: int = 0
    save_before_color_transform: bool = False
    name: str = ""
    loop_filter: LoopFilter = field(default_factory=LoopFilter)
    extensions: int = 0

    @property
    def group_dim(self) -> int:
        return 128 << self.group_size_shift

    def can_be_referenced(self) -> bool:
        # Order-of-operations per reference: zero-duration regular frames and
        # reference-only frames can be stored (frame_header.h:411-416).
        return self.save_as_reference != 0

    def visit(self, v, metadata) -> None:
        if v.all_default(self.is_all_default()):
            self.set_default()
            return
        self.frame_type = v.u32(Val(FrameType.REGULAR), Val(FrameType.DC_FRAME),
                                Val(FrameType.REFERENCE_ONLY),
                                Val(FrameType.SKIP_PROGRESSIVE),
                                self.frame_type)
        is_modular = v.bool(self.encoding == FrameEncoding.MODULAR)
        self.encoding = (FrameEncoding.MODULAR if is_modular
                         else FrameEncoding.VARDCT)
        self.flags = v.u64(self.flags)

        xyb_encoded = metadata is None or metadata.xyb_encoded
        if xyb_encoded:
            self.color_transform = ColorTransform.XYB
        else:
            alternate = v.bool(self.color_transform == ColorTransform.YCBCR)
            self.color_transform = (ColorTransform.YCBCR if alternate
                                    else ColorTransform.NONE)

        if (self.color_transform == ColorTransform.YCBCR and
                (self.flags & FrameFlags.USE_DC_FRAME) == 0):
            self.chroma_subsampling.visit(v)

        num_extra = metadata.num_extra_channels if metadata else 0

        if (self.flags & FrameFlags.USE_DC_FRAME) == 0:
            self.upsampling = v.u32(Val(1), Val(2), Val(4), Val(8),
                                    self.upsampling)
            if metadata is not None and num_extra != 0:
                ecu = []
                for i, eci in enumerate(metadata.extra_channel_info):
                    cur = (self.extra_channel_upsampling[i]
                           if i < len(self.extra_channel_upsampling) else 1)
                    val = v.u32(Val(1), Val(2), Val(4), Val(8),
                                cur >> eci.dim_shift)
                    val <<= eci.dim_shift
                    if val < self.upsampling:
                        raise FormatError("EC upsampling < color upsampling")
                    if val > 8:
                        raise FormatError("EC upsampling too large")
                    ecu.append(val)
                self.extra_channel_upsampling = tuple(ecu)
            else:
                self.extra_channel_upsampling = ()

        if self.encoding == FrameEncoding.MODULAR:
            self.group_size_shift = v.bits(2, self.group_size_shift)
        if (self.encoding == FrameEncoding.VARDCT and
                self.color_transform == ColorTransform.XYB):
            self.x_qm_scale = v.bits(3, self.x_qm_scale)
            self.b_qm_scale = v.bits(3, self.b_qm_scale)
        else:
            self.x_qm_scale = self.b_qm_scale = 2

        if self.frame_type != FrameType.REFERENCE_ONLY:
            self.passes.visit(v)

        if self.frame_type == FrameType.DC_FRAME:
            self.dc_level = v.u32(Val(1), Val(2), Val(3), Val(4),
                                  self.dc_level)
        else:
            self.dc_level = 0

        is_partial_frame = False
        if self.frame_type != FrameType.DC_FRAME:
            self.custom_size_or_origin = v.bool(self.custom_size_or_origin)
            if self.custom_size_or_origin:
                enc = (Bits(8), BitsOffset(11, 256), BitsOffset(14, 2304),
                       BitsOffset(30, 18688))
                if self.frame_type in (FrameType.REGULAR,
                                       FrameType.SKIP_PROGRESSIVE):
                    ux0 = v.u32(*enc, pack_signed(self.frame_origin_x0))
                    uy0 = v.u32(*enc, pack_signed(self.frame_origin_y0))
                    self.frame_origin_x0 = unpack_signed(ux0)
                    self.frame_origin_y0 = unpack_signed(uy0)
                self.frame_xsize = v.u32(*enc, self.frame_xsize)
                self.frame_ysize = v.u32(*enc, self.frame_ysize)
                if self.frame_xsize == 0 or self.frame_ysize == 0:
                    raise FormatError("zero frame crop")
                if self.frame_type in (FrameType.REGULAR,
                                       FrameType.SKIP_PROGRESSIVE):
                    # Partial if crop doesn't cover the full image.
                    img_x = metadata_xsize(metadata)
                    img_y = metadata_ysize(metadata)
                    is_partial_frame = (
                        self.frame_origin_x0 > 0 or self.frame_origin_y0 > 0 or
                        self.frame_xsize + self.frame_origin_x0 < img_x or
                        self.frame_ysize + self.frame_origin_y0 < img_y)

        if self.frame_type in (FrameType.REGULAR, FrameType.SKIP_PROGRESSIVE):
            self.blending_info.visit(v, num_extra, is_partial_frame)
            if v.is_reading or len(self.extra_channel_blending_info) != \
                    num_extra:
                self.extra_channel_blending_info = [
                    BlendingInfo() for _ in range(num_extra)]
            for bi in self.extra_channel_blending_info:
                bi.visit(v, num_extra, is_partial_frame)
            if metadata is not None and metadata.have_animation:
                self.animation_frame.visit(
                    v, True, metadata.animation.have_timecodes)
            self.is_last = v.bool(self.is_last)
        else:
            self.is_last = False

        if self.frame_type != FrameType.DC_FRAME and not self.is_last:
            self.save_as_reference = v.u32(Val(0), Val(1), Val(2), Val(3),
                                           self.save_as_reference)

        if self.frame_type != FrameType.DC_FRAME:
            can_reference = (
                not self.is_last and
                (self.animation_frame.duration == 0 or
                 self.save_as_reference != 0) and
                self.frame_type != FrameType.DC_FRAME)
            if (can_reference and
                    self.blending_info.mode == BlendMode.REPLACE and
                    not is_partial_frame and
                    self.frame_type in (FrameType.REGULAR,
                                        FrameType.SKIP_PROGRESSIVE)):
                self.save_before_color_transform = v.bool(
                    self.save_before_color_transform)
            elif self.frame_type == FrameType.REFERENCE_ONLY:
                self.save_before_color_transform = v.bool(True)
        else:
            self.save_before_color_transform = True

        self.name = _visit_name(v, self.name)
        self.loop_filter.visit(v, is_modular)
        if v.is_reading:
            self.extensions = v.begin_extensions()
            v.end_extensions()
        else:
            v.begin_extensions(self.extensions)
            v.end_extensions()


def metadata_xsize(metadata) -> int:
    return getattr(metadata, "nonserialized_xsize", 0)


def metadata_ysize(metadata) -> int:
    return getattr(metadata, "nonserialized_ysize", 0)
