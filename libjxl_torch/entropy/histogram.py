"""ANS histogram (population counts) bitstream codec.

Decode follows ``ReadHistogram`` (``lib/jxl/dec_ans.cc:58-191``); encode
follows ``EncodeCounts``/``NormalizeCounts`` (``lib/jxl/enc_ans.cc``).
Counts always sum to ANS_TAB_SIZE = 4096.
"""

from __future__ import annotations

import numpy as np

from libjxl_torch.core.fields import FormatError
from libjxl_torch.utils.bits import BitReader, BitWriter

ANS_LOG_TAB_SIZE = 12
ANS_TAB_SIZE = 1 << ANS_LOG_TAB_SIZE
ANS_MAX_ALPHABET_SIZE = 256
ANS_SIGNATURE = 0x13
PREFIX_MAX_BITS = 15
PREFIX_MAX_ALPHABET_SIZE = 4096


def decode_varlen_uint8(r: BitReader) -> int:
    """1-11 bits -> [0..255] (dec_ans.cc:33-43)."""
    if r.read(1):
        nbits = r.read(3)
        if nbits == 0:
            return 1
        return r.read(nbits) + (1 << nbits)
    return 0


def encode_varlen_uint8(w: BitWriter, value: int) -> None:
    if value == 0:
        w.write(1, 0)
        return
    w.write(1, 1)
    nbits = value.bit_length() - 1
    w.write(3, nbits)
    if nbits:
        w.write(nbits, value - (1 << nbits))


def decode_varlen_uint16(r: BitReader) -> int:
    """1-21 bits -> [0..65535] (dec_ans.cc:46-56)."""
    if r.read(1):
        nbits = r.read(4)
        if nbits == 0:
            return 1
        return r.read(nbits) + (1 << nbits)
    return 0


def encode_varlen_uint16(w: BitWriter, value: int) -> None:
    if value == 0:
        w.write(1, 0)
        return
    w.write(1, 1)
    nbits = value.bit_length() - 1
    w.write(4, nbits)
    if nbits:
        w.write(nbits, value - (1 << nbits))


def create_flat_histogram(length: int, total: int) -> list[int]:
    """(ans_common.h:38-49)."""
    count = total // length
    rem = total % length
    return [count + 1] * rem + [count] * (length - rem)


def get_population_count_precision(logcount: int, shift: int) -> int:
    """(ans_common.h:26-33)."""
    r = min(logcount, shift - ((ANS_LOG_TAB_SIZE - logcount) >> 1))
    return max(r, 0)


# Static prefix code for logcount symbols: symbol -> (nbits, code-value-LSB).
# Derived from the decode table at dec_ans.cc:110-125 (7-bit peek).
# Mapping from peek-index to (bits consumed, logcount+1 symbol).
_HUFF_DEC = None


def _build_huff_dec():
    global _HUFF_DEC
    if _HUFF_DEC is not None:
        return _HUFF_DEC
    table = {}
    rows = [
        (3, 10), (7, 12), (3, 7), (4, 3), (3, 6), (3, 8), (3, 9), (4, 5),
        (3, 10), (4, 4), (3, 7), (4, 1), (3, 6), (3, 8), (3, 9), (4, 2),
        (3, 10), (5, 0), (3, 7), (4, 3), (3, 6), (3, 8), (3, 9), (4, 5),
        (3, 10), (4, 4), (3, 7), (4, 1), (3, 6), (3, 8), (3, 9), (4, 2),
        (3, 10), (6, 11), (3, 7), (4, 3), (3, 6), (3, 8), (3, 9), (4, 5),
        (3, 10), (4, 4), (3, 7), (4, 1), (3, 6), (3, 8), (3, 9), (4, 2),
        (3, 10), (5, 0), (3, 7), (4, 3), (3, 6), (3, 8), (3, 9), (4, 5),
        (3, 10), (4, 4), (3, 7), (4, 1), (3, 6), (3, 8), (3, 9), (4, 2),
        (3, 10), (7, 13), (3, 7), (4, 3), (3, 6), (3, 8), (3, 9), (4, 5),
        (3, 10), (4, 4), (3, 7), (4, 1), (3, 6), (3, 8), (3, 9), (4, 2),
        (3, 10), (5, 0), (3, 7), (4, 3), (3, 6), (3, 8), (3, 9), (4, 5),
        (3, 10), (4, 4), (3, 7), (4, 1), (3, 6), (3, 8), (3, 9), (4, 2),
        (3, 10), (6, 11), (3, 7), (4, 3), (3, 6), (3, 8), (3, 9), (4, 5),
        (3, 10), (4, 4), (3, 7), (4, 1), (3, 6), (3, 8), (3, 9), (4, 2),
        (3, 10), (5, 0), (3, 7), (4, 3), (3, 6), (3, 8), (3, 9), (4, 5),
        (3, 10), (4, 4), (3, 7), (4, 1), (3, 6), (3, 8), (3, 9), (4, 2),
    ]
    enc = {}
    for idx, (bits, value) in enumerate(rows):
        table[idx] = (bits, value)
        # encode: symbol -> (nbits, lsb-first code) = low `bits` of idx,
        # taking the first index that maps to the symbol.
        key = value
        code = idx & ((1 << bits) - 1)
        if key not in enc or enc[key][0] > bits:
            enc[key] = (bits, code)
    _HUFF_DEC = (rows, enc)
    return _HUFF_DEC


def read_histogram(r: BitReader, precision_bits: int = ANS_LOG_TAB_SIZE
                   ) -> list[int]:
    """Decode one ANS histogram; returns counts summing to 2**precision_bits
    (dec_ans.cc:58-191)."""
    rows, _ = _build_huff_dec()
    rng = 1 << precision_bits
    if r.read(1):  # simple code
        num_symbols = r.read(1) + 1
        symbols = [decode_varlen_uint8(r) for _ in range(num_symbols)]
        counts = [0] * (max(symbols) + 1)
        if num_symbols == 1:
            counts[symbols[0]] = rng
        else:
            if symbols[0] == symbols[1]:
                raise FormatError("corrupt simple histogram")
            counts[symbols[0]] = r.read(precision_bits)
            counts[symbols[1]] = rng - counts[symbols[0]]
        return counts
    if r.read(1):  # flat
        alphabet_size = decode_varlen_uint8(r) + 1
        if alphabet_size > rng:
            raise FormatError("flat histogram too large")
        return create_flat_histogram(alphabet_size, rng)
    # general code
    upper_bound_log = (ANS_LOG_TAB_SIZE + 1).bit_length() - 1
    log = 0
    while log < upper_bound_log:
        if r.read(1) == 0:
            break
        log += 1
    shift = (r.read(log) | (1 << log)) - 1
    if shift > ANS_LOG_TAB_SIZE + 1:
        raise FormatError("invalid shift")
    length = decode_varlen_uint8(r) + 3
    logcounts = [0] * length
    same = [0] * length
    omit_log, omit_pos = -1, -1
    i = 0
    while i < length:
        idx = r.peek(7)
        bits, value = rows[idx]
        r.skip(bits)
        logcounts[i] = value - 1
        if logcounts[i] == ANS_LOG_TAB_SIZE:
            rle_length = decode_varlen_uint8(r)
            same[i] = rle_length + 5
            i += rle_length + 4
            continue
        if logcounts[i] > omit_log:
            omit_log = logcounts[i]
            omit_pos = i
        i += 1
    if omit_pos < 0:
        raise FormatError("invalid histogram (no omit)")
    if omit_pos + 1 < length and logcounts[omit_pos + 1] == ANS_LOG_TAB_SIZE:
        raise FormatError("invalid histogram (rle after omit)")
    counts = [0] * length
    prev = 0
    numsame = 0
    total = 0
    for i in range(length):
        if same[i]:
            numsame = same[i] - 1
            prev = counts[i - 1] if i > 0 else 0
        if numsame > 0:
            counts[i] = prev
            numsame -= 1
        else:
            code = logcounts[i]
            if i == omit_pos or code < 0:
                continue
            elif shift == 0 or code == 0:
                counts[i] = 1 << code
            else:
                bitcount = get_population_count_precision(code, shift)
                counts[i] = (1 << code) + (r.read(bitcount) <<
                                           (code - bitcount))
        total += counts[i]
    counts[omit_pos] = rng - total
    if counts[omit_pos] <= 0:
        raise FormatError("invalid histogram counts")
    return counts


def quantize_histogram(counts, shift: int = ANS_LOG_TAB_SIZE + 1):
    """Round counts to values representable at `shift` precision while
    keeping the sum at ANS_TAB_SIZE (the largest entry absorbs the
    remainder, as the decoder derives it anyway)."""
    counts = [int(c) for c in counts]
    if sum(counts) != ANS_TAB_SIZE:
        raise ValueError("counts must sum to ANS_TAB_SIZE")
    nonzero = [i for i, c in enumerate(counts) if c]
    if len(nonzero) <= 2 or shift >= ANS_LOG_TAB_SIZE + 1:
        return counts
    omit = max(range(len(counts)), key=lambda i: counts[i])
    out = list(counts)
    for i, c in enumerate(counts):
        if c == 0 or i == omit:
            continue
        lc = c.bit_length() - 1
        bitcount = get_population_count_precision(lc, shift)
        step = 1 << (lc - bitcount)
        mant = (c - (1 << lc) + step // 2) // step
        if mant >= (1 << bitcount):
            mant = (1 << bitcount) - 1
        out[i] = (1 << lc) + mant * step
    rem = ANS_TAB_SIZE - sum(out[i] for i in range(len(out)) if i != omit)
    if rem <= 0:
        return counts  # cannot quantize safely; keep exact
    out[omit] = rem
    # the decoder picks omit as the first max-logcount entry; verify ours
    # still is, else fall back to exact counts
    logs = [v.bit_length() - 1 if v else -1 for v in out]
    if max(range(len(out)), key=lambda i: (logs[i], -i)) != omit:
        return counts
    return out


def write_histogram(w: BitWriter, counts,
                    precision_bits: int = ANS_LOG_TAB_SIZE,
                    shift: int = ANS_LOG_TAB_SIZE + 1) -> None:
    """Encode counts (must sum to 2**precision_bits; must be
    representable at `shift` — use quantize_histogram first for
    shift < 13). Mirrors ``EncodeCounts`` (enc_ans.cc)."""
    rng = 1 << precision_bits
    assert sum(counts) == rng, f"counts sum {sum(counts)} != {rng}"
    counts = [int(c) for c in counts]
    while counts and counts[-1] == 0:
        counts.pop()
    assert counts
    nonzero = [i for i, c in enumerate(counts) if c != 0]
    # Simple code with 1 or 2 symbols.
    if len(nonzero) == 1:
        w.write(1, 1)
        w.write(1, 0)
        encode_varlen_uint8(w, nonzero[0])
        return
    if len(nonzero) == 2:
        w.write(1, 1)
        w.write(1, 1)
        encode_varlen_uint8(w, nonzero[0])
        encode_varlen_uint8(w, nonzero[1])
        w.write(precision_bits, counts[nonzero[0]])
        return
    # Flat?
    if counts == create_flat_histogram(len(counts), rng):
        w.write(1, 0)
        w.write(1, 1)
        encode_varlen_uint8(w, len(counts) - 1)
        return
    # General code.
    _, enc = _build_huff_dec()
    w.write(1, 0)
    w.write(1, 0)
    # shift stored as: log unary prefix + remaining bits;
    # value stored is shift+1 with (1<<log) marker (dec_ans.cc:93-100).
    v = shift + 1
    log = v.bit_length() - 1
    upper_bound_log = (ANS_LOG_TAB_SIZE + 1).bit_length() - 1  # = 3
    for _ in range(log):
        w.write(1, 1)
    if log < upper_bound_log:
        w.write(1, 0)
    w.write(log, v - (1 << log))
    length = len(counts)
    encode_varlen_uint8(w, length - 3)
    # The decoder re-derives omit_pos as the FIRST index with the largest
    # logcount (dec_ans.cc:144-147), so pick the same one here.
    logcounts = [int(c).bit_length() - 1 if c > 0 else -1
                 for c in counts]
    omit_pos = max(range(length), key=lambda i: (logcounts[i], -i))
    # The decoder reads all logcount symbols first, then all mantissa bits
    # in a second pass (dec_ans.cc:132-184) — emit in the same two phases.
    for i, c in enumerate(counts):
        sym = 0 if (c == 0 and i != omit_pos) else logcounts[i] + 1
        bits, code = enc[sym]
        w.write(bits, code)
    for i, c in enumerate(counts):
        if i == omit_pos or c == 0:
            continue  # omitted count is derived from the remainder
        lc = logcounts[i]
        if shift != 0 and lc != 0:
            bitcount = get_population_count_precision(lc, shift)
            mantissa = (c - (1 << lc)) >> (lc - bitcount)
            assert (1 << lc) + (mantissa << (lc - bitcount)) == c, \
                "count not representable at this precision"
            w.write(bitcount, mantissa)
