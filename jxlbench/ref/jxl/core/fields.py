"""Declarative header field codec (the reference's Fields/Bundle system).

JPEG XL headers are serialized via per-field variable-width integer codes:
  * U32: 2-bit selector choosing one of four distributions, each either a
    direct value or ``offset + extra-bits`` (reference ``lib/jxl/fields.h:51-67``,
    ``lib/jxl/field_encodings.h:44-90``).
  * U64: selector + varint groups of 12/8/.../4 bits
    (``lib/jxl/fields.cc:494-520``).
  * F16: IEEE binary16, NaN/Inf rejected (``lib/jxl/fields.cc:550-574``).
  * Enum: fixed U32Enc ``Val(0), Val(1), BitsOffset(4,2), BitsOffset(6,18)``
    (``lib/jxl/fields.h:205-216``).

Instead of the reference's virtual-visitor C++, each header dataclass
implements ``visit(self, v)`` against a small Visitor protocol; the same
method serializes, deserializes, and computes defaults depending on the
visitor passed (same single-source-of-truth trick as ``VisitFields``).
"""

from __future__ import annotations

from dataclasses import dataclass

from jxlbench.ref.jxl.utils.bits import BitReader, BitWriter

__all__ = [
    "Val", "Bits", "BitsOffset", "U32Enc",
    "read_u32", "write_u32", "read_u64", "write_u64",
    "read_f16", "write_f16",
    "FieldReader", "FieldWriter",
]


class FormatError(ValueError):
    """Invalid or unsupported codestream construct."""


# ---------------------------------------------------------------------------
# U32 distributions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Distr:
    direct: int | None = None     # direct value, or None
    bits: int = 0                 # extra bits
    offset: int = 0

    def max_value(self) -> int:
        if self.direct is not None:
            return self.direct
        return self.offset + (1 << self.bits) - 1


def Val(v: int) -> _Distr:
    return _Distr(direct=v)


def BitsOffset(bits: int, offset: int) -> _Distr:
    return _Distr(direct=None, bits=bits, offset=offset)


def Bits(bits: int) -> _Distr:
    return BitsOffset(bits, 0)


class U32Enc:
    def __init__(self, d0: _Distr, d1: _Distr, d2: _Distr, d3: _Distr):
        self.d = (d0, d1, d2, d3)


ENUM_ENC = U32Enc(Val(0), Val(1), BitsOffset(4, 2), BitsOffset(6, 18))


def read_u32(r: BitReader, enc: U32Enc) -> int:
    sel = r.read(2)
    d = enc.d[sel]
    if d.direct is not None:
        return d.direct
    return d.offset + r.read(d.bits)


def write_u32(w: BitWriter, enc: U32Enc, value: int) -> None:
    # Choose the cheapest selector that can represent the value
    # (reference ChooseSelector: first direct match, else smallest range).
    best = None
    for sel, d in enumerate(enc.d):
        if d.direct is not None:
            if d.direct == value:
                w.write(2, sel)
                return
        else:
            if d.offset <= value <= d.max_value():
                cost = 2 + d.bits
                if best is None or cost < best[0]:
                    best = (cost, sel, d)
    if best is None:
        raise FormatError(f"U32 value {value} not encodable")
    _, sel, d = best
    w.write(2, sel)
    w.write(d.bits, value - d.offset)


def read_u64(r: BitReader) -> int:
    sel = r.read(2)
    if sel == 0:
        return 0
    if sel == 1:
        return 1 + r.read(4)
    if sel == 2:
        return 17 + r.read(8)
    result = r.read(12)
    shift = 12
    while r.read(1):
        if shift == 60:
            result |= r.read(4) << shift
            break
        result |= r.read(8) << shift
        shift += 8
    return result


def write_u64(w: BitWriter, value: int) -> None:
    if value == 0:
        w.write(2, 0)
    elif value <= 16:
        w.write(2, 1)
        w.write(4, value - 1)
    elif value <= 272:
        w.write(2, 2)
        w.write(8, value - 17)
    else:
        w.write(2, 3)
        w.write(12, value & 0xFFF)
        value >>= 12
        shift = 12
        while value > 0 and shift < 60:
            w.write(1, 1)
            w.write(8, value & 0xFF)
            value >>= 8
            shift += 8
        if value > 0:
            # Only reachable at shift == 60: final 4-bit group.
            w.write(1, 1)
            w.write(4, value & 0xF)
        else:
            w.write(1, 0)


def read_f16(r: BitReader) -> float:
    bits16 = r.read(16)
    sign = bits16 >> 15
    biased_exp = (bits16 >> 10) & 0x1F
    mantissa = bits16 & 0x3FF
    if biased_exp == 31:
        raise FormatError("F16 NaN/Inf not allowed")
    if biased_exp == 0:
        v = (1.0 / 16384) * (mantissa / 1024.0)
    else:
        v = (1.0 + mantissa / 1024.0) * 2.0 ** (biased_exp - 15)
    return -v if sign else v


def write_f16(w: BitWriter, value: float, exact: bool = True) -> None:
    import struct
    import math
    if math.isnan(value) or math.isinf(value):
        raise FormatError("cannot store NaN/Inf as F16")
    import numpy as np
    h = np.float16(value)
    if exact and float(h) != value:
        raise FormatError(f"value {value} not exactly representable as F16")
    (bits,) = struct.unpack("<H", h.tobytes())
    w.write(16, int(bits))


def round_f16(value: float) -> float:
    """Nearest-F16 value (for encoder fields that are stored as F16)."""
    import numpy as np
    return float(np.float16(value))


# ---------------------------------------------------------------------------
# Visitors
# ---------------------------------------------------------------------------

class FieldReader:
    """Deserializing visitor: each method reads and returns the value."""

    is_reading = True

    def __init__(self, r: BitReader):
        self.r = r

    def bits(self, n: int, default: int = 0) -> int:
        return self.r.read(n)

    def bool(self, default: bool = False) -> bool:
        return self.r.read(1) == 1

    def u32(self, d0, d1, d2, d3, default: int = 0) -> int:
        return read_u32(self.r, U32Enc(d0, d1, d2, d3))

    def u64(self, default: int = 0) -> int:
        return read_u64(self.r)

    def f16(self, default: float = 0.0) -> float:
        return read_f16(self.r)

    def enum(self, default: int = 0) -> int:
        v = read_u32(self.r, ENUM_ENC)
        if v >= 64:
            raise FormatError(f"enum value {v} out of range")
        return v

    def all_default(self, default: bool = True) -> bool:
        return self.bool(default)

    def begin_extensions(self) -> int:
        ext = self.u64()
        self._ext_bits = []
        rem = ext
        while rem:
            self._ext_bits.append(self.u64())
            rem &= rem - 1
        self._pos_after_ext_size = self.r.bits_consumed
        self._total_ext_bits = sum(self._ext_bits)
        return ext

    def end_extensions(self) -> None:
        if getattr(self, "_total_ext_bits", 0):
            consumed = self.r.bits_consumed - self._pos_after_ext_size
            remaining = self._total_ext_bits - consumed
            if remaining < 0:
                raise FormatError("read past extension bits")
            self.r.skip(remaining)


class FieldWriter:
    """Serializing visitor: each method writes the passed value."""

    is_reading = False

    def __init__(self, w: BitWriter):
        self.w = w

    def bits(self, n: int, value: int) -> int:
        self.w.write(n, value)
        return value

    def bool(self, value: bool) -> bool:
        self.w.write_bool(value)
        return value

    def u32(self, d0, d1, d2, d3, value: int) -> int:
        write_u32(self.w, U32Enc(d0, d1, d2, d3), value)
        return value

    def u64(self, value: int) -> int:
        write_u64(self.w, value)
        return value

    def f16(self, value: float) -> float:
        write_f16(self.w, value)
        return value

    def enum(self, value: int) -> int:
        write_u32(self.w, ENUM_ENC, value)
        return value

    def all_default(self, value: bool) -> bool:
        self.w.write_bool(value)
        return value

    def begin_extensions(self, extensions: int = 0) -> int:
        write_u64(self.w, extensions)
        if extensions:
            raise FormatError("writing extensions is not supported")
        return extensions

    def end_extensions(self) -> None:
        pass
