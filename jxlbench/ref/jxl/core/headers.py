"""Codestream headers: SizeHeader, ImageMetadata, ColorEncoding, etc.

Each header is a dataclass with a ``visit(v)`` method that both reads and
writes through the Visitor protocol in ``core.fields`` — the same
single-source layout trick as the reference's ``VisitFields``
(``lib/jxl/headers.cc``, ``lib/jxl/image_metadata.cc``,
``lib/jxl/color_encoding_internal.cc``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from jxlbench.ref.jxl.core.fields import (
    Bits, BitsOffset, FieldReader, FieldWriter, FormatError, Val,
)
from jxlbench.ref.jxl.utils.bits import BitReader, BitWriter

SIGNATURE = b"\xff\x0a"

# --- enums (values are bitstream enum codes) -------------------------------


class ColorSpace:
    RGB = 0
    GRAY = 1
    XYB = 2
    UNKNOWN = 3


class WhitePoint:
    D65 = 1
    CUSTOM = 2
    E = 10
    DCI = 11


class Primaries:
    SRGB = 1
    CUSTOM = 2
    BT2100 = 9
    P3 = 11


class TransferFunction:
    BT709 = 1
    UNKNOWN = 2
    LINEAR = 8
    SRGB = 13
    PQ = 16
    DCI = 17
    HLG = 18


class RenderingIntent:
    PERCEPTUAL = 0
    RELATIVE = 1
    SATURATION = 2
    ABSOLUTE = 3


class ExtraChannelType:
    ALPHA = 0
    DEPTH = 1
    SPOT_COLOR = 2
    SELECTION_MASK = 3
    BLACK = 4
    CFA = 5
    THERMAL = 6
    UNKNOWN = 15
    OPTIONAL = 16


def pack_signed(v: int) -> int:
    """X>=0 -> 2X; -X -> 2X-1 (lib/jxl/pack_signed.h:18)."""
    return (v << 1) if v >= 0 else ((-v) << 1) - 1


def unpack_signed(u: int) -> int:
    return (u >> 1) if (u & 1) == 0 else -((u + 1) >> 1)


# --- aspect-ratio table (headers.cc:35-46) ---------------------------------

_RATIOS = [(1, 1), (12, 10), (4, 3), (3, 2), (16, 9), (5, 4), (2, 1)]


def _ratio_xsize(ratio: int, ysize: int) -> int:
    num, den = _RATIOS[ratio - 1]
    return ysize * num // den


def _find_aspect_ratio(xsize: int, ysize: int) -> int:
    for r in range(1, 8):
        if xsize == _ratio_xsize(r, ysize):
            return r
    return 0


class Bundle:
    """Base for header bundles with default-tracking."""

    def is_all_default(self) -> bool:
        return self == type(self)()

    def set_default(self) -> None:
        fresh = type(self)()
        for f in dataclasses.fields(self):
            if f.compare:
                setattr(self, f.name, getattr(fresh, f.name))


@dataclass(eq=True)
class SizeHeader(Bundle):
    """Image dimensions (headers.cc:131-156)."""

    xsize: int = 0
    ysize: int = 0

    def set(self, xsize: int, ysize: int) -> None:
        if xsize == 0 or ysize == 0:
            raise FormatError("empty image")
        self.xsize, self.ysize = xsize, ysize

    def visit(self, v) -> None:
        if v.is_reading:
            small = v.bool()
            if small:
                ysize = (v.bits(5) + 1) * 8
            else:
                ysize = v.u32(BitsOffset(9, 1), BitsOffset(13, 1),
                              BitsOffset(18, 1), BitsOffset(30, 1))
            ratio = v.bits(3)
            if ratio != 0:
                xsize = _ratio_xsize(ratio, ysize)
            elif small:
                xsize = (v.bits(5) + 1) * 8
            else:
                xsize = v.u32(BitsOffset(9, 1), BitsOffset(13, 1),
                              BitsOffset(18, 1), BitsOffset(30, 1))
            self.xsize, self.ysize = xsize, ysize
        else:
            xsize, ysize = self.xsize, self.ysize
            ratio = _find_aspect_ratio(xsize, ysize)
            small = (ysize <= 256 and ysize % 8 == 0 and
                     (ratio != 0 or (xsize <= 256 and xsize % 8 == 0)))
            v.bool(small)
            if small:
                v.bits(5, ysize // 8 - 1)
            else:
                v.u32(BitsOffset(9, 1), BitsOffset(13, 1),
                      BitsOffset(18, 1), BitsOffset(30, 1), ysize)
            v.bits(3, ratio)
            if ratio == 0:
                if small:
                    v.bits(5, xsize // 8 - 1)
                else:
                    v.u32(BitsOffset(9, 1), BitsOffset(13, 1),
                          BitsOffset(18, 1), BitsOffset(30, 1), xsize)


@dataclass(eq=True)
class PreviewHeader(Bundle):
    """Preview dimensions (headers.cc:157-182)."""

    xsize: int = 0
    ysize: int = 0

    def visit(self, v) -> None:
        div8_enc = (Val(16), Val(32), BitsOffset(5, 1), BitsOffset(9, 33))
        full_enc = (BitsOffset(6, 1), BitsOffset(8, 65), BitsOffset(10, 321),
                    BitsOffset(12, 1345))
        if v.is_reading:
            div8 = v.bool()
            ysize = v.u32(*div8_enc) * 8 if div8 else v.u32(*full_enc)
            ratio = v.bits(3)
            if ratio != 0:
                xsize = _ratio_xsize(ratio, ysize)
            elif div8:
                xsize = v.u32(*div8_enc) * 8
            else:
                xsize = v.u32(*full_enc)
            self.xsize, self.ysize = xsize, ysize
        else:
            xsize, ysize = self.xsize, self.ysize
            div8 = xsize % 8 == 0 and ysize % 8 == 0
            ratio = _find_aspect_ratio(xsize, ysize)
            v.bool(div8)
            if div8:
                v.u32(*div8_enc, ysize // 8)
            else:
                v.u32(*full_enc, ysize)
            v.bits(3, ratio)
            if ratio == 0:
                if div8:
                    v.u32(*div8_enc, xsize // 8)
                else:
                    v.u32(*full_enc, xsize)


@dataclass(eq=True)
class AnimationHeader(Bundle):
    tps_numerator: int = 1
    tps_denominator: int = 1
    num_loops: int = 0
    have_timecodes: bool = False

    def visit(self, v) -> None:
        self.tps_numerator = v.u32(Val(100), Val(1000), BitsOffset(10, 1),
                                   BitsOffset(30, 1), self.tps_numerator)
        self.tps_denominator = v.u32(Val(1), Val(1001), BitsOffset(8, 1),
                                     BitsOffset(10, 1), self.tps_denominator)
        self.num_loops = v.u32(Val(0), Bits(3), Bits(16), Bits(32),
                               self.num_loops)
        self.have_timecodes = v.bool(self.have_timecodes)


@dataclass(eq=True)
class BitDepth(Bundle):
    """Sample bit depth (image_metadata.cc:26-65)."""

    floating_point_sample: bool = False
    bits_per_sample: int = 8
    exponent_bits_per_sample: int = 0

    def visit(self, v) -> None:
        self.floating_point_sample = v.bool(self.floating_point_sample)
        if not self.floating_point_sample:
            self.bits_per_sample = v.u32(
                Val(8), Val(10), Val(12), BitsOffset(6, 1),
                self.bits_per_sample)
            self.exponent_bits_per_sample = 0
            if self.bits_per_sample > 31:
                raise FormatError("bits_per_sample too large")
        else:
            self.bits_per_sample = v.u32(
                Val(32), Val(16), Val(24), BitsOffset(6, 1),
                self.bits_per_sample)
            self.exponent_bits_per_sample = v.bits(
                4, self.exponent_bits_per_sample - 1) + 1
            if not (2 <= self.exponent_bits_per_sample <= 8):
                raise FormatError("invalid exponent bits")
            mant = self.bits_per_sample - self.exponent_bits_per_sample - 1
            if not (2 <= mant <= 23):
                raise FormatError("invalid mantissa bits")


def _visit_name(v, name: str) -> str:
    """Length-prefixed UTF-8 string (frame_header.h:35-49)."""
    data = name.encode("utf-8")
    n = v.u32(Val(0), Bits(4), BitsOffset(5, 16), BitsOffset(10, 48),
              len(data))
    if v.is_reading:
        return bytes(v.bits(8) for _ in range(n)).decode("utf-8",
                                                         errors="replace")
    for b in data:
        v.bits(8, b)
    return name


@dataclass(eq=True)
class ExtraChannelInfo(Bundle):
    """(image_metadata.cc:221-262)."""

    type: int = ExtraChannelType.ALPHA
    bit_depth: BitDepth = field(default_factory=BitDepth)
    dim_shift: int = 0
    name: str = ""
    alpha_associated: bool = False
    spot_color: tuple = (0.0, 0.0, 0.0, 0.0)
    cfa_channel: int = 1

    def visit(self, v) -> None:
        if v.all_default(self.is_all_default()):
            self.set_default()
            return
        self.type = v.enum(self.type)
        self.bit_depth.visit(v)
        self.dim_shift = v.u32(Val(0), Val(3), Val(4), BitsOffset(3, 1),
                               self.dim_shift)
        self.name = _visit_name(v, self.name)
        if self.type == ExtraChannelType.ALPHA:
            self.alpha_associated = v.bool(self.alpha_associated)
        if self.type == ExtraChannelType.SPOT_COLOR:
            self.spot_color = tuple(v.f16(c) for c in self.spot_color)
        if self.type == ExtraChannelType.CFA:
            self.cfa_channel = v.u32(Val(1), Bits(2), BitsOffset(4, 3),
                                     BitsOffset(8, 19), self.cfa_channel)


@dataclass(eq=True)
class Customxy(Bundle):
    """Signed fixed-point chromaticity (color_encoding_internal.cc:101)."""

    x: int = 0
    y: int = 0

    def visit(self, v) -> None:
        enc = (Bits(19), BitsOffset(19, 524288), BitsOffset(20, 1048576),
               BitsOffset(21, 2097152))
        ux = v.u32(*enc, pack_signed(self.x))
        uy = v.u32(*enc, pack_signed(self.y))
        if v.is_reading:
            self.x, self.y = unpack_signed(ux), unpack_signed(uy)


@dataclass(eq=True)
class CustomTransferFunction(Bundle):
    """(color_encoding_internal.cc:116-140)."""

    have_gamma: bool = False
    gamma: int = 10000000       # gamma * 1e7
    transfer_function: int = TransferFunction.SRGB

    def visit(self, v, color_space: int) -> None:
        if color_space == ColorSpace.XYB:
            # Implicit gamma 1/3 (color_encoding_internal.cc:26-32).
            self.have_gamma = True
            self.gamma = 10000000 // 3
            return
        self.have_gamma = v.bool(self.have_gamma)
        if self.have_gamma:
            self.gamma = v.bits(24, self.gamma)
            if self.gamma > 10000000 or self.gamma == 0:
                raise FormatError("invalid gamma")
        else:
            self.transfer_function = v.enum(self.transfer_function)


@dataclass(eq=True)
class ColorEncoding(Bundle):
    """(color_encoding_internal.cc:144-215)."""

    want_icc: bool = False
    color_space: int = ColorSpace.RGB
    white_point: int = WhitePoint.D65
    white: Customxy = field(default_factory=Customxy)
    primaries: int = Primaries.SRGB
    red: Customxy = field(default_factory=Customxy)
    green: Customxy = field(default_factory=Customxy)
    blue: Customxy = field(default_factory=Customxy)
    tf: CustomTransferFunction = field(default_factory=CustomTransferFunction)
    rendering_intent: int = RenderingIntent.RELATIVE

    @property
    def has_primaries(self) -> bool:
        return self.color_space not in (ColorSpace.GRAY, ColorSpace.XYB)

    @property
    def channels(self) -> int:
        return 1 if self.color_space == ColorSpace.GRAY else 3

    @classmethod
    def srgb(cls, gray: bool = False) -> "ColorEncoding":
        return cls(color_space=ColorSpace.GRAY if gray else ColorSpace.RGB)

    @classmethod
    def linear_srgb(cls, gray: bool = False) -> "ColorEncoding":
        return cls(color_space=ColorSpace.GRAY if gray else ColorSpace.RGB,
                   tf=CustomTransferFunction(
                       transfer_function=TransferFunction.LINEAR))

    def visit(self, v) -> None:
        if v.all_default(self.is_all_default()):
            self.set_default()
            return
        self.want_icc = v.bool(self.want_icc)
        self.color_space = v.enum(self.color_space)
        if not self.want_icc:
            if self.color_space != ColorSpace.XYB:
                self.white_point = v.enum(self.white_point)
                if self.white_point == WhitePoint.CUSTOM:
                    self.white.visit(v)
            else:
                self.white_point = WhitePoint.D65
            if self.has_primaries:
                self.primaries = v.enum(self.primaries)
                if self.primaries == Primaries.CUSTOM:
                    self.red.visit(v)
                    self.green.visit(v)
                    self.blue.visit(v)
            self.tf.visit(v, self.color_space)
            self.rendering_intent = v.enum(self.rendering_intent)
            if self.color_space == ColorSpace.UNKNOWN or (
                    not self.tf.have_gamma and
                    self.tf.transfer_function == TransferFunction.UNKNOWN):
                raise FormatError("no ICC but unknown colorspace/tf")


@dataclass(eq=True)
class ToneMapping(Bundle):
    """(image_metadata.cc:385-415)."""

    intensity_target: float = 255.0
    min_nits: float = 0.0
    relative_to_max_display: bool = False
    linear_below: float = 0.0

    def visit(self, v) -> None:
        if v.all_default(self.is_all_default()):
            self.set_default()
            return
        self.intensity_target = v.f16(self.intensity_target)
        if self.intensity_target <= 0:
            raise FormatError("invalid intensity target")
        self.min_nits = v.f16(self.min_nits)
        self.relative_to_max_display = v.bool(self.relative_to_max_display)
        self.linear_below = v.f16(self.linear_below)


@dataclass(eq=True)
class OpsinInverseMatrix(Bundle):
    """(image_metadata.cc:359-383); defaults in cms/opsin_params.h:44-63."""

    inverse_matrix: tuple = (
        (11.031566901960783, -9.866943921568629, -0.16462299647058826),
        (-3.254147380392157, 4.418770392156863, -0.16462299647058826),
        (-3.6588512862745097, 2.7129230470588235, 1.9459282392156863))
    opsin_biases: tuple = (-0.0037930732552754493,) * 3
    quant_biases: tuple = (1.0 - 0.05465007330715401, 1.0 - 0.07005449891748593,
                           1.0 - 0.049935103337343655, 0.145)

    def visit(self, v) -> None:
        if v.all_default(self.is_all_default()):
            self.set_default()
            return
        self.inverse_matrix = tuple(
            tuple(v.f16(x) for x in row) for row in self.inverse_matrix)
        self.opsin_biases = tuple(v.f16(x) for x in self.opsin_biases)
        self.quant_biases = tuple(v.f16(x) for x in self.quant_biases)


@dataclass(eq=True)
class CustomTransformData(Bundle):
    """Opsin matrix override + custom upsampling weights
    (image_metadata.cc:78-200). Weight tables kept as None = spec defaults."""

    opsin_inverse_matrix: OpsinInverseMatrix = field(
        default_factory=OpsinInverseMatrix)
    custom_weights_mask: int = 0
    upsampling2_weights: tuple | None = None
    upsampling4_weights: tuple | None = None
    upsampling8_weights: tuple | None = None
    # not serialized:
    xyb_encoded: bool = field(default=True, compare=False)

    def visit(self, v) -> None:
        if v.all_default(self.is_all_default()):
            self.set_default()
            return
        if self.xyb_encoded:
            self.opsin_inverse_matrix.visit(v)
        self.custom_weights_mask = v.bits(3, self.custom_weights_mask)
        for bit, name, count in ((1, "upsampling2_weights", 15),
                                 (2, "upsampling4_weights", 55),
                                 (4, "upsampling8_weights", 210)):
            if self.custom_weights_mask & bit:
                cur = getattr(self, name) or (0.0,) * count
                setattr(self, name, tuple(v.f16(x) for x in cur))


@dataclass(eq=True)
class ImageMetadata(Bundle):
    """(image_metadata.cc:283-357)."""

    orientation: int = 1
    have_intrinsic_size: bool = False
    intrinsic_size: SizeHeader = field(default_factory=SizeHeader)
    have_preview: bool = False
    preview_size: PreviewHeader = field(default_factory=PreviewHeader)
    have_animation: bool = False
    animation: AnimationHeader = field(default_factory=AnimationHeader)
    bit_depth: BitDepth = field(default_factory=BitDepth)
    modular_16_bit_buffer_sufficient: bool = True
    extra_channel_info: list = field(default_factory=list)
    xyb_encoded: bool = True
    color_encoding: ColorEncoding = field(default_factory=ColorEncoding)
    tone_mapping: ToneMapping = field(default_factory=ToneMapping)
    extensions: int = 0

    @property
    def num_extra_channels(self) -> int:
        return len(self.extra_channel_info)

    def find_alpha_channel(self):
        for i, eci in enumerate(self.extra_channel_info):
            if eci.type == ExtraChannelType.ALPHA:
                return i, eci
        return None, None

    def visit(self, v) -> None:
        if v.all_default(self.is_all_default()):
            self.set_default()
            return
        extra_fields = (self.orientation != 1 or self.have_preview or
                        self.have_animation or self.have_intrinsic_size or
                        not self.tone_mapping.is_all_default())
        extra_fields = v.bool(extra_fields)
        if extra_fields:
            self.orientation = v.bits(3, self.orientation - 1) + 1
            self.have_intrinsic_size = v.bool(self.have_intrinsic_size)
            if self.have_intrinsic_size:
                self.intrinsic_size.visit(v)
            self.have_preview = v.bool(self.have_preview)
            if self.have_preview:
                self.preview_size.visit(v)
            self.have_animation = v.bool(self.have_animation)
            if self.have_animation:
                self.animation.visit(v)
        else:
            self.orientation = 1
            self.have_intrinsic_size = False
            self.have_preview = False
            self.have_animation = False
        self.bit_depth.visit(v)
        self.modular_16_bit_buffer_sufficient = v.bool(
            self.modular_16_bit_buffer_sufficient)
        nec = v.u32(Val(0), Val(1), BitsOffset(4, 2), BitsOffset(12, 1),
                    self.num_extra_channels)
        if v.is_reading:
            self.extra_channel_info = [ExtraChannelInfo() for _ in range(nec)]
        for eci in self.extra_channel_info:
            eci.visit(v)
        self.xyb_encoded = v.bool(self.xyb_encoded)
        self.color_encoding.visit(v)
        if extra_fields:
            self.tone_mapping.visit(v)
        if v.is_reading:
            self.extensions = v.begin_extensions()
            v.end_extensions()
        else:
            v.begin_extensions(self.extensions)
            v.end_extensions()


def read_bundle(r: BitReader, bundle):
    bundle.visit(FieldReader(r))
    if r.overflow:
        raise FormatError("truncated header")
    return bundle


def write_bundle(w: BitWriter, bundle) -> None:
    bundle.visit(FieldWriter(w))


def read_signature(r: BitReader) -> None:
    if r.read_bytes(2) != SIGNATURE:
        raise FormatError("bad JXL codestream signature")


def write_signature(w: BitWriter) -> None:
    w.write_bytes(SIGNATURE)
