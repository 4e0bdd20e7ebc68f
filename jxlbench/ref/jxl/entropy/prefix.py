"""Brotli-style canonical prefix codes (reference ``lib/jxl/dec_huffman.cc``,
``lib/jxl/enc_huffman.cc``).

Codes are transmitted as code lengths (themselves prefix-coded) and decoded
LSB-first: a symbol's bitstream code is the bit-reversal of its canonical
MSB-first code.
"""

from __future__ import annotations

import numpy as np

from jxlbench.ref.jxl.core.fields import FormatError
from jxlbench.ref.jxl.utils.bits import BitReader, BitWriter

K_CODE_LENGTH_CODES = 18
K_CODE_LENGTH_ORDER = (1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13,
                       14, 15)
K_DEFAULT_CODE_LENGTH = 8
K_REPEAT_PREV = 16        # repeat previous nonzero length 3-6+ times
K_REPEAT_ZERO = 17        # repeat zero 3-10+ times
MAX_BITS = 15

# Static prefix code for code-length code lengths (dec_huffman.cc:199-203):
# 4-bit peek table of (bits, value).
_STATIC_CLC = ((2, 0), (2, 4), (2, 3), (3, 2), (2, 0), (2, 4), (2, 3), (4, 1),
               (2, 0), (2, 4), (2, 3), (3, 2), (2, 0), (2, 4), (2, 3), (4, 5))
# encode side: value -> (nbits, lsb-first code)
_STATIC_CLC_ENC = {0: (2, 0b00), 4: (2, 0b01), 3: (2, 0b10), 2: (3, 0b011),
                   1: (4, 0b0111), 5: (4, 0b1111)}


def _reverse_bits(code: int, nbits: int) -> int:
    r = 0
    for _ in range(nbits):
        r = (r << 1) | (code & 1)
        code >>= 1
    return r


def canonical_codes(lengths) -> list[int]:
    """Canonical MSB-first codes for given lengths (0 = unused)."""
    max_len = max(lengths) if len(lengths) else 0
    bl_count = [0] * (max_len + 1)
    for ln in lengths:
        if ln:
            bl_count[ln] += 1
    code = 0
    next_code = [0] * (max_len + 2)
    for b in range(1, max_len + 1):
        code = (code + bl_count[b - 1]) << 1
        next_code[b] = code
    out = []
    for ln in lengths:
        if ln:
            out.append(next_code[ln])
            next_code[ln] += 1
        else:
            out.append(0)
    return out


class PrefixCode:
    """Decode-side prefix code: flat LSB-first lookup table."""

    def __init__(self, lengths):
        self.lengths = np.asarray(lengths, dtype=np.int32)
        nz = self.lengths[self.lengths > 0]
        if nz.size == 0:
            raise FormatError("empty prefix code")
        self.max_len = int(self.lengths.max())
        # Kraft check
        if nz.size > 1 and int(np.sum(1 << (MAX_BITS - nz))) != 1 << MAX_BITS:
            raise FormatError("prefix code not complete")
        codes = canonical_codes(self.lengths)
        size = 1 << self.max_len
        self.table_sym = np.zeros(size, dtype=np.int32)
        self.table_len = np.zeros(size, dtype=np.int32)
        if nz.size == 1:
            # single symbol: zero bits
            sym = int(np.nonzero(self.lengths)[0][0])
            self.table_sym[:] = sym
            self.table_len[:] = 0
            self.max_len = 0
            return
        for sym, (ln, code) in enumerate(zip(self.lengths, codes)):
            if ln == 0:
                continue
            key = _reverse_bits(code, int(ln))
            step = 1 << int(ln)
            self.table_sym[key::step] = sym
            self.table_len[key::step] = ln

    def read_symbol(self, r: BitReader) -> int:
        if self.max_len == 0:
            return int(self.table_sym[0])
        idx = r.peek(self.max_len)
        r.skip(int(self.table_len[idx]))
        return int(self.table_sym[idx])


def _read_simple_code(alphabet_size: int, r: BitReader) -> PrefixCode:
    """(dec_huffman.cc:94-180)."""
    max_bits = (alphabet_size - 1).bit_length() if alphabet_size > 1 else 0
    num_symbols = r.read(2) + 1
    symbols = [r.read(max_bits) for _ in range(num_symbols)]
    for s in symbols:
        if s >= alphabet_size:
            raise FormatError("bad simple prefix symbol")
    if len(set(symbols)) != num_symbols:
        raise FormatError("duplicate simple prefix symbols")
    if num_symbols == 4:
        num_symbols += r.read(1)
    lengths = [0] * alphabet_size
    if num_symbols == 1:
        lengths[symbols[0]] = 0
        pc = PrefixCode.__new__(PrefixCode)
        pc.lengths = np.array(lengths, dtype=np.int32)
        pc.max_len = 0
        pc.table_sym = np.array([symbols[0]], dtype=np.int32)
        pc.table_len = np.array([0], dtype=np.int32)
        return pc
    if num_symbols == 2:
        a, b = sorted(symbols[:2])
        lengths[a] = lengths[b] = 1
    elif num_symbols == 3:
        a = symbols[0]
        b, c = sorted(symbols[1:3])
        lengths[a] = 1
        lengths[b] = lengths[c] = 2
    elif num_symbols == 4:
        for s in sorted(symbols[:4]):
            lengths[s] = 2
    else:  # 5 => "4 symbols with tree-depth 3"
        a = symbols[0]
        b = symbols[1]
        c, d = sorted(symbols[2:4])
        lengths[a] = 1
        lengths[b] = 2
        lengths[c] = lengths[d] = 3
    # Canonical assignment must match the reference's explicit tables: the
    # reference assigns codes by the symbols' *given* order within each
    # length class after the sorts above, which equals canonical order.
    return PrefixCode(lengths)


def _read_code_lengths(clc_lengths, num_symbols: int, r: BitReader
                       ) -> np.ndarray:
    """(dec_huffman.cc:24-92)."""
    clc = PrefixCode(
        _expand_clc(clc_lengths))
    code_lengths = np.zeros(num_symbols, dtype=np.int32)
    symbol = 0
    prev_code_len = K_DEFAULT_CODE_LENGTH
    repeat = 0
    repeat_code_len = 0
    space = 32768
    while symbol < num_symbols and space > 0:
        code_len = clc.read_symbol(r)
        if code_len < K_REPEAT_PREV:
            repeat = 0
            code_lengths[symbol] = code_len
            symbol += 1
            if code_len != 0:
                prev_code_len = code_len
                space -= 32768 >> code_len
        else:
            extra_bits = code_len - 14
            new_len = prev_code_len if code_len == K_REPEAT_PREV else 0
            if repeat_code_len != new_len:
                repeat = 0
                repeat_code_len = new_len
            old_repeat = repeat
            if repeat > 0:
                repeat -= 2
                repeat <<= extra_bits
            repeat += r.read(extra_bits) + 3
            repeat_delta = repeat - old_repeat
            if symbol + repeat_delta > num_symbols:
                raise FormatError("prefix repeat overflow")
            code_lengths[symbol:symbol + repeat_delta] = repeat_code_len
            symbol += repeat_delta
            if repeat_code_len != 0:
                space -= repeat_delta << (15 - repeat_code_len)
    if space != 0:
        raise FormatError("prefix code lengths incomplete")
    return code_lengths


def _expand_clc(clc_lengths) -> list[int]:
    return list(clc_lengths)


def read_prefix_code(alphabet_size: int, r: BitReader) -> PrefixCode:
    """(dec_huffman.cc:183-244)."""
    if alphabet_size > (1 << MAX_BITS):
        raise FormatError("prefix alphabet too large")
    simple_or_skip = r.read(2)
    if simple_or_skip == 1:
        return _read_simple_code(alphabet_size, r)
    clc_lengths = [0] * K_CODE_LENGTH_CODES
    space = 32
    num_codes = 0
    i = simple_or_skip
    while i < K_CODE_LENGTH_CODES and space > 0:
        idx = r.peek(4)
        bits, v = _STATIC_CLC[idx]
        r.skip(bits)
        clc_lengths[K_CODE_LENGTH_ORDER[i]] = v
        if v != 0:
            space -= 32 >> v
            num_codes += 1
        i += 1
    if not (num_codes == 1 or space == 0):
        raise FormatError("invalid code length code")
    lengths = _read_code_lengths(clc_lengths, alphabet_size, r)
    return PrefixCode(lengths)


# ---------------------------------------------------------------------------
# Encode side
# ---------------------------------------------------------------------------

def build_prefix_lengths(counts, max_bits: int = MAX_BITS) -> np.ndarray:
    """Length-limited Huffman code lengths from symbol counts
    (package-merge; same role as enc_huffman_tree.cc)."""
    counts = np.asarray(counts, dtype=np.int64)
    n = len(counts)
    nz = np.nonzero(counts)[0]
    lengths = np.zeros(n, dtype=np.int32)
    if nz.size == 0:
        return lengths
    if nz.size == 1:
        lengths[nz[0]] = 1
        return lengths
    # package-merge
    items = [(int(counts[s]), (s,)) for s in nz]
    items.sort()
    packages = list(items)
    merged = list(items)
    for _ in range(max_bits - 1):
        # package pairs
        paired = []
        for i in range(0, len(merged) - 1, 2):
            w = merged[i][0] + merged[i + 1][0]
            syms = merged[i][1] + merged[i + 1][1]
            paired.append((w, syms))
        merged = sorted(items + paired)
    count_use = np.zeros(n, dtype=np.int64)
    for w, syms in merged[:2 * (nz.size - 1)]:
        for s in syms:
            count_use[s] += 1
    lengths[nz] = count_use[nz]
    return lengths


def write_prefix_code(w: BitWriter, lengths) -> None:
    """Serialize code lengths (enc_huffman.cc StoreHuffmanTree semantics;
    simplest valid form: simple codes when <=4 symbols, else raw
    code-length coding without RLE)."""
    lengths = np.asarray(lengths, dtype=np.int32)
    nz = np.nonzero(lengths)[0]
    alphabet_size = len(lengths)
    max_bits = (alphabet_size - 1).bit_length() if alphabet_size > 1 else 0
    if nz.size == 1:
        w.write(2, 1)          # simple
        w.write(2, 0)          # num_symbols-1 = 0
        w.write(max_bits, int(nz[0]))
        return
    if nz.size <= 4 and _is_simple_compatible(lengths, nz):
        w.write(2, 1)
        w.write(2, nz.size - 1)
        symbols = _simple_symbol_order(lengths, nz)
        for s in symbols:
            w.write(max_bits, int(s))
        if nz.size == 4:
            # tree-depth bit: 0 => all length 2; 1 => 1,2,3,3
            deep = int(lengths[nz].max() == 3)
            w.write(1, deep)
        return
    # Full serialization: write code-length-code, then lengths (no RLE —
    # valid, just not maximally dense). The decoder stops as soon as the
    # Kraft space hits zero (dec_huffman.cc:43-87), so emit exactly up to
    # that point and nothing after.
    emit = []
    space = 32768
    for sym in range(alphabet_size):
        if space <= 0:
            break
        ln = int(lengths[sym])
        emit.append(ln)
        if ln:
            space -= 32768 >> ln
    if space != 0:
        raise FormatError("incomplete prefix code")
    clc_counts = np.zeros(K_CODE_LENGTH_CODES, dtype=np.int64)
    for ln in emit:
        clc_counts[ln] += 1
    clc_lengths = build_prefix_lengths(clc_counts, max_bits=5)
    w.write(2, 0)  # no skip
    clc_codes = canonical_codes(clc_lengths)
    # The decoder stops reading CLC entries once its 5-bit Kraft space is
    # exhausted (dec_huffman.cc:205-218) — stop emitting at the same point.
    clc_space = 32
    for i in range(K_CODE_LENGTH_CODES):
        if clc_space <= 0:
            break
        v = int(clc_lengths[K_CODE_LENGTH_ORDER[i]])
        if v not in _STATIC_CLC_ENC:
            raise FormatError(f"clc length {v} > 5 unsupported")
        bits, code = _STATIC_CLC_ENC[v]
        w.write(bits, code)
        if v:
            clc_space -= 32 >> v
    single_clc = int(np.count_nonzero(clc_lengths)) == 1
    for ln in emit:
        if single_clc:
            continue  # decoder's single-code CLC table reads 0 bits
        w.write(int(clc_lengths[ln]),
                _reverse_bits(clc_codes[ln], int(clc_lengths[ln])))


def _is_simple_compatible(lengths, nz) -> bool:
    lens = sorted(int(lengths[s]) for s in nz)
    return ((len(nz) == 2 and lens == [1, 1]) or
            (len(nz) == 3 and lens == [1, 2, 2]) or
            (len(nz) == 4 and lens in ([2, 2, 2, 2], [1, 2, 3, 3])))


def _simple_symbol_order(lengths, nz):
    n = len(nz)
    if n == 2:
        return sorted(nz)
    if n == 3:
        one = [s for s in nz if lengths[s] == 1]
        twos = sorted(s for s in nz if lengths[s] == 2)
        return one + twos
    if int(lengths[nz].max()) == 2:
        return sorted(nz)
    one = [s for s in nz if lengths[s] == 1]
    two = [s for s in nz if lengths[s] == 2]
    threes = sorted(s for s in nz if lengths[s] == 3)
    return one + two + threes


def _complete_lengths(counts, lengths, max_bits):
    """Ensure Kraft equality (space == 0) for the CLC table."""
    lengths = np.array(lengths, dtype=np.int32)
    nz = np.nonzero(lengths)[0]
    if nz.size <= 1:
        return lengths
    # package-merge already yields a complete code for >=2 symbols
    return lengths
