"""ICC profile codec (reference ``lib/jxl/icc_codec.cc``,
``icc_codec_common.{h,cc}``, ``enc_icc_codec.cc``).

Encoded ICC = byte-wise ANS stream (41 contexts keyed on the previous two
bytes' classes) of a predicted representation: varint sizes, a command
stream (tag-list and content commands) and a data stream. Decode fully
reverses the reference's prediction; encode uses the always-valid
insert-everything command form (header still predicted)."""

from __future__ import annotations

import numpy as np

from libjxl_torch.core.fields import FormatError, read_u64, write_u64
from libjxl_torch.entropy.ans import ANSSymbolReader, decode_histograms

K_ICC_HEADER_SIZE = 128
K_NUM_ICC_CONTEXTS = 41

_TAG_STRINGS = [b"cprt", b"wtpt", b"bkpt", b"rXYZ", b"gXYZ", b"bXYZ",
                b"kXYZ", b"rTRC", b"gTRC", b"bTRC", b"kTRC", b"chad",
                b"desc", b"chrm", b"dmnd", b"dmdd", b"lumi"]
_TYPE_STRINGS = [b"XYZ ", b"desc", b"text", b"mluc", b"para", b"curv",
                 b"sf32", b"gbd "]

_CMD_TAG_UNKNOWN = 1
_CMD_TAG_TRC = 2
_CMD_TAG_XYZ = 3
_CMD_TAG_STRING_FIRST = 4
_CMD_INSERT = 1
_CMD_SHUFFLE2 = 2
_CMD_SHUFFLE4 = 3
_CMD_PREDICT = 4
_CMD_XYZ = 10
_CMD_TYPE_START_FIRST = 16
_FLAG_BIT_OFFSET = 64
_FLAG_BIT_SIZE = 128

_INITIAL_HEADER = (
    bytes([0, 0, 0, 0, 0, 0, 0, 0, 4, 0, 0, 0]) +      # 0..11
    b"mntrRGB XYZ " +                                  # 12..23
    bytes(12) +                                        # 24..35
    b"acsp" +                                          # 36..39
    bytes(30) +                                        # 40..69
    bytes([246, 214, 0, 1, 0, 0, 0, 0, 211, 45]) +     # 70..79
    bytes(48))                                         # 80..127
assert len(_INITIAL_HEADER) == K_ICC_HEADER_SIZE


def _byte_kind1(b: int) -> int:
    if 97 <= b <= 122 or 65 <= b <= 90:
        return 0
    if 48 <= b <= 57 or b in (0x2E, 0x2C):
        return 1
    if b == 0:
        return 2
    if b == 1:
        return 3
    if b < 16:
        return 4
    if b == 255:
        return 6
    if b > 240:
        return 5
    return 7


def _byte_kind2(b: int) -> int:
    if 97 <= b <= 122 or 65 <= b <= 90:
        return 0
    if 48 <= b <= 57 or b in (0x2E, 0x2C):
        return 1
    if b < 16:
        return 2
    if b > 240:
        return 3
    return 4


def icc_context(i: int, b1: int, b2: int) -> int:
    if i <= 128:
        return 0
    return 1 + _byte_kind1(b1) + _byte_kind2(b2) * 8


def _decode_varint(data: bytes, pos: int) -> tuple[int, int]:
    ret = 0
    for i in range(10):
        if pos >= len(data):
            raise FormatError("ICC varint truncated")
        b = data[pos]
        pos += 1
        ret |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return ret, pos
    raise FormatError("ICC varint too long")


def _encode_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _initial_header_prediction(osize: int) -> bytearray:
    h = bytearray(_INITIAL_HEADER)
    h[0:4] = osize.to_bytes(4, "big")
    return h


def _predict_header(icc: bytes, header: bytearray, pos: int) -> None:
    """(icc_codec_common.cc ICCPredictHeader)."""
    size = len(icc)
    if pos == 8 and size >= 8:
        header[80:84] = icc[4:8]
    if pos == 41 and size >= 41:
        if icc[40:41] == b"A":
            header[41:44] = b"PPL"
        if icc[40:41] == b"M":
            header[41:44] = b"SFT"
    if pos == 42 and size >= 42:
        if icc[40:42] == b"SG":
            header[42:44] = b"I "
        if icc[40:42] == b"SU":
            header[42:44] = b"NW"


def _shuffle(data: bytearray, width: int) -> bytearray:
    """(icc_codec.cc Shuffle): de-interleave scanline-order transform."""
    size = len(data)
    height = (size + width - 1) // width
    out = bytearray(size)
    s = 0
    j = 0
    for i in range(size):
        out[i] = data[j]
        j += height
        if j >= size:
            s += 1
            j = s
    return out


def _predict_value(p1, p2, p3, order):
    if order == 0:
        return p1
    if order == 1:
        return 2 * p1 - p2
    return 3 * p1 - 3 * p2 + p3


def _linear_predict(data: bytearray, start: int, i: int, stride: int,
                    width: int, order: int) -> int:
    pos = start + i
    if width == 1:
        return _predict_value(data[pos - stride], data[pos - 2 * stride],
                              data[pos - 3 * stride], order) & 0xFF

    def be(p, n):
        if p + n > pos:
            return 0
        return int.from_bytes(data[p:p + n], "big")
    if width == 2:
        p = start + (i & ~1)
        pred = _predict_value(be(p - stride, 2), be(p - 2 * stride, 2),
                              be(p - 3 * stride, 2), order)
        return (pred & 0xFF) if (i & 1) else ((pred >> 8) & 0xFF)
    p = start + (i & ~3)
    pred = _predict_value(be(p - stride, 4), be(p - 2 * stride, 4),
                          be(p - 3 * stride, 4), order)
    shiftbytes = 3 - (i & 3)
    return (pred >> (shiftbytes * 8)) & 0xFF


def unpredict_icc(enc: bytes) -> bytes:
    """(icc_codec.cc:119-337 UnpredictICC)."""
    pos = 0
    osize, pos = _decode_varint(enc, pos)
    csize, pos = _decode_varint(enc, pos)
    cpos = pos
    commands_end = cpos + csize
    if commands_end > len(enc):
        raise FormatError("ICC commands out of bounds")
    pos = commands_end

    result = bytearray()
    header = _initial_header_prediction(osize)
    for i in range(K_ICC_HEADER_SIZE + 1):
        if len(result) == osize:
            if cpos != commands_end or pos != len(enc):
                raise FormatError("ICC: unused data")
            return bytes(result)
        if i == K_ICC_HEADER_SIZE:
            break
        _predict_header(bytes(result), header, i)
        if pos >= len(enc):
            raise FormatError("ICC out of bounds")
        result.append((enc[pos] + header[i]) & 0xFF)
        pos += 1
    if cpos >= commands_end:
        raise FormatError("ICC out of bounds")

    numtags, cpos = _decode_varint(enc, cpos)
    if numtags != 0:
        numtags -= 1
        result += numtags.to_bytes(4, "big")
        prevtagstart = K_ICC_HEADER_SIZE + numtags * 12
        prevtagsize = 0
        while True:
            if len(result) > osize:
                raise FormatError("ICC invalid result size")
            if cpos > commands_end:
                raise FormatError("ICC out of bounds")
            if cpos == commands_end:
                break
            command = enc[cpos]
            cpos += 1
            tagcode = command & 63
            if tagcode == 0:
                break
            if tagcode == _CMD_TAG_UNKNOWN:
                tag = enc[pos:pos + 4]
                pos += 4
            elif tagcode == _CMD_TAG_TRC:
                tag = b"rTRC"
            elif tagcode == _CMD_TAG_XYZ:
                tag = b"rXYZ"
            else:
                if tagcode - _CMD_TAG_STRING_FIRST >= len(_TAG_STRINGS):
                    raise FormatError("ICC unknown tagcode")
                tag = _TAG_STRINGS[tagcode - _CMD_TAG_STRING_FIRST]
            result += tag
            tagsize = prevtagsize
            if tag in (b"rXYZ", b"gXYZ", b"bXYZ", b"kXYZ", b"wtpt",
                       b"bkpt", b"lumi"):
                tagsize = 20
            if command & _FLAG_BIT_OFFSET:
                tagstart, cpos = _decode_varint(enc, cpos)
            else:
                tagstart = prevtagstart + prevtagsize
            result += tagstart.to_bytes(4, "big")
            if command & _FLAG_BIT_SIZE:
                tagsize, cpos = _decode_varint(enc, cpos)
            result += tagsize.to_bytes(4, "big")
            prevtagstart, prevtagsize = tagstart, tagsize
            if tagcode == _CMD_TAG_TRC:
                for t in (b"gTRC", b"bTRC"):
                    result += t + tagstart.to_bytes(4, "big") + \
                        tagsize.to_bytes(4, "big")
            if tagcode == _CMD_TAG_XYZ:
                result += b"gXYZ" + (tagstart + tagsize).to_bytes(4, "big") \
                    + tagsize.to_bytes(4, "big")
                result += b"bXYZ" + \
                    (tagstart + 2 * tagsize).to_bytes(4, "big") + \
                    tagsize.to_bytes(4, "big")

    while True:
        if len(result) > osize:
            raise FormatError("ICC invalid result size")
        if cpos > commands_end:
            raise FormatError("ICC out of bounds")
        if cpos == commands_end:
            break
        command = enc[cpos]
        cpos += 1
        if command == _CMD_INSERT:
            num, cpos = _decode_varint(enc, cpos)
            if pos + num > len(enc):
                raise FormatError("ICC out of bounds")
            result += enc[pos:pos + num]
            pos += num
        elif command in (_CMD_SHUFFLE2, _CMD_SHUFFLE4):
            num, cpos = _decode_varint(enc, cpos)
            if pos + num > len(enc):
                raise FormatError("ICC out of bounds")
            width = 2 if command == _CMD_SHUFFLE2 else 4
            result += _shuffle(bytearray(enc[pos:pos + num]), width)
            pos += num
        elif command == _CMD_PREDICT:
            flags = enc[cpos]
            cpos += 1
            width = (flags & 3) + 1
            if width == 3:
                raise FormatError("ICC invalid width")
            order = (flags & 12) >> 2
            if order == 3:
                raise FormatError("ICC invalid order")
            stride = width
            if flags & 16:
                stride, cpos = _decode_varint(enc, cpos)
                if stride < width:
                    raise FormatError("ICC invalid stride")
            if not result or ((len(result) - 1) >> 2) < stride:
                raise FormatError("ICC invalid stride")
            num, cpos = _decode_varint(enc, cpos)
            if pos + num > len(enc):
                raise FormatError("ICC out of bounds")
            shuffled = bytearray(enc[pos:pos + num])
            if width > 1:
                shuffled = _shuffle(shuffled, width)
            start = len(result)
            for i in range(num):
                predicted = _linear_predict(result, start, i, stride,
                                            width, order)
                result.append((predicted + shuffled[i]) & 0xFF)
            pos += num
        elif command == _CMD_XYZ:
            result += b"XYZ " + bytes(4) + enc[pos:pos + 12]
            pos += 12
        elif _CMD_TYPE_START_FIRST <= command < \
                _CMD_TYPE_START_FIRST + len(_TYPE_STRINGS):
            result += _TYPE_STRINGS[command - _CMD_TYPE_START_FIRST] + \
                bytes(4)
        else:
            raise FormatError("ICC unknown command")
    if pos != len(enc) or len(result) != osize:
        raise FormatError("ICC decode mismatch")
    return bytes(result)


def read_encoded_icc(r) -> bytes:
    """(icc_codec.cc ICCReader): U64 size + ANS bytes + unprediction."""
    enc_size = read_u64(r)
    if enc_size > (1 << 28):
        raise FormatError("encoded ICC too large")
    code = decode_histograms(r, K_NUM_ICC_CONTEXTS)
    dec = ANSSymbolReader(code, r)
    data = bytearray()
    for i in range(enc_size):
        b1 = data[i - 1] if i > 0 else 0
        b2 = data[i - 2] if i > 1 else 0
        v = dec.read_hybrid_uint(icc_context(i, b1, b2), r)
        if v > 255:
            raise FormatError("ICC byte out of range")
        data.append(v)
    if not dec.check_final_state():
        raise FormatError("ICC ANS checksum failed")
    return unpredict_icc(bytes(data))


def predict_icc_simple(icc: bytes) -> bytes:
    """Minimal valid PredictICC: header delta + insert-everything."""
    osize = len(icc)
    header = _initial_header_prediction(osize)
    data = bytearray()
    for i in range(min(K_ICC_HEADER_SIZE, osize)):
        _predict_header(icc[:i], header, i)
        data.append((icc[i] - header[i]) & 0xFF)
    rest = icc[K_ICC_HEADER_SIZE:]
    commands = bytearray(_encode_varint(0))      # no tag-list handling
    if rest:
        commands += bytes([_CMD_INSERT]) + _encode_varint(len(rest))
        data += rest
    return (_encode_varint(osize) + _encode_varint(len(commands)) +
            bytes(commands) + bytes(data))


def write_encoded_icc(w, icc: bytes) -> None:
    """Encoder counterpart of read_encoded_icc."""
    from libjxl_torch.entropy.ans import (
        build_entropy_codes, tokens_to_array, write_entropy_codes,
        write_tokens,
    )
    enc = predict_icc_simple(icc)
    write_u64(w, len(enc))
    toks = []
    for i, b in enumerate(enc):
        b1 = enc[i - 1] if i > 0 else 0
        b2 = enc[i - 2] if i > 1 else 0
        toks.append((icc_context(i, b1, b2), b))
    arr = tokens_to_array(toks)
    codes = build_entropy_codes([arr], K_NUM_ICC_CONTEXTS,
                                allow_clustering=True)
    write_entropy_codes(w, codes)
    write_tokens(w, arr, codes)
