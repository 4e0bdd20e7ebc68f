"""LSB-first bitstream reader/writer.

JPEG XL packs bits least-significant-first within bytes read in little-endian
order (reference: ``lib/jxl/dec_bit_reader.h:29``, ``lib/jxl/enc_bit_writer.h``).
These are host-side primitives: headers, TOC and final byte assembly happen on
CPU by design (device kernels produce tokens/pixels; see SURVEY.md §7).

Scalar paths are plain Python for clarity; bulk token emission/parsing uses the
vectorized numpy helpers (``write_bits_array`` / fast buffer refill) so the
host side never becomes the bottleneck.
"""

from __future__ import annotations

import numpy as np

__all__ = ["BitWriter", "BitReader", "pack_bits_lsb"]


class BitWriter:
    """Append-only LSB-first bit buffer."""

    def __init__(self):
        self._words: list[int] = []   # accumulated bit-chunks
        self._nbits: list[int] = []
        self._total = 0

    @property
    def bits_written(self) -> int:
        return self._total

    def write(self, nbits: int, value: int) -> None:
        """Write the low `nbits` of `value` (LSB first)."""
        if nbits == 0:
            return
        assert 0 <= nbits <= 64
        v = int(value) & ((1 << nbits) - 1)
        self._words.append(v)
        self._nbits.append(nbits)
        self._total += nbits

    def write_bool(self, b: bool) -> None:
        self.write(1, 1 if b else 0)

    def zero_pad_to_byte(self) -> None:
        pad = (-self._total) % 8
        if pad:
            self.write(pad, 0)

    def write_bytes(self, data: bytes) -> None:
        """Byte-aligned fast append (caller must be at byte boundary)."""
        assert self._total % 8 == 0, "write_bytes requires byte alignment"
        for b in data:
            self.write(8, b)

    def append_writer(self, other: "BitWriter") -> None:
        """Concatenate another writer's bits (no alignment requirement)."""
        self._words.extend(other._words)
        self._nbits.extend(other._nbits)
        self._total += other._total

    def append_packed(self, data: bytes, nbits: int) -> None:
        """Append `nbits` bits from an LSB-first packed byte buffer."""
        if nbits == 0:
            return
        full_words = nbits // 32
        pad = (-len(data)) % 4
        words = np.frombuffer(data + b"\x00" * pad, dtype="<u4")
        if full_words:
            self._words.extend(words[:full_words].astype(np.uint64).tolist())
            self._nbits.extend([32] * full_words)
            self._total += 32 * full_words
        rem = nbits - 32 * full_words
        if rem:
            tail = int(words[full_words]) & ((1 << rem) - 1)
            self.write(rem, tail)

    def write_array(self, nbits: np.ndarray, values: np.ndarray) -> None:
        """Vectorized append of many (nbits, value) pairs (LSB-first)."""
        nbits = np.asarray(nbits, dtype=np.int64)
        values = np.asarray(values, dtype=np.uint64)
        mask = np.where(nbits >= 64, np.uint64(0xFFFFFFFFFFFFFFFF),
                        (np.uint64(1) << nbits.astype(np.uint64)) - np.uint64(1))
        values = values & mask
        self._words.extend(values.tolist())
        self._nbits.extend(nbits.tolist())
        self._total += int(nbits.sum())

    def to_bytes(self) -> bytes:
        """Pack all written bits into bytes (zero-padded to byte boundary)."""
        nbits = np.array(self._nbits, dtype=np.int64)
        words = np.array(self._words, dtype=np.uint64)
        from jxlbench.ref.jxl.utils import native
        packed = native.pack_bits(nbits, words)
        if packed is not None:
            return packed
        return pack_bits_lsb(nbits, words).tobytes()


def pack_bits_lsb(nbits: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Pack variable-length LSB-first codes into a uint8 array (vectorized).

    ``nbits[i]`` low bits of ``values[i]`` are emitted in order, LSB-first.
    """
    nbits = np.asarray(nbits, dtype=np.int64)
    values = np.asarray(values, dtype=np.uint64)
    if nbits.size == 0:
        return np.zeros(0, dtype=np.uint8)
    total = int(nbits.sum())
    starts = np.concatenate(([0], np.cumsum(nbits)[:-1]))
    nbytes = (total + 7) // 8
    # Expand each code into its bits via per-code loop over max bit count —
    # but vectorized across codes: iterate bit positions (<=64).
    out = np.zeros(nbytes, dtype=np.uint32)
    max_n = int(nbits.max())
    for bit in range(max_n):
        act = nbits > bit
        if not act.any():
            break
        idx = starts[act] + bit
        bitvals = ((values[act] >> np.uint64(bit)) & np.uint64(1)).astype(
            np.uint32)
        np.add.at(out, idx >> 3, bitvals << (idx & 7).astype(np.uint32))
    return out.astype(np.uint8)


class BitReader:
    """LSB-first bit reader over a byte buffer.

    Reads past the end are allowed and return zero bits, with an overflow
    flag (mirrors the reference's bounds-checked refill,
    ``dec_bit_reader.h:95-130``) so callers can detect truncated streams
    after the fact.
    """

    def __init__(self, data: bytes | np.ndarray):
        if isinstance(data, np.ndarray):
            data = data.tobytes()
        self._data = data
        self._pos = 0           # next bit index
        self._nbits = len(data) * 8
        # Little-endian word view for fast refill.
        pad = (-len(data)) % 8
        padded = data + b"\x00" * pad
        self._words = np.frombuffer(padded, dtype="<u8")

    @property
    def bits_consumed(self) -> int:
        return self._pos

    @property
    def overflow(self) -> bool:
        return self._pos > self._nbits

    def total_bits(self) -> int:
        return self._nbits

    def read(self, nbits: int) -> int:
        """Read `nbits` (0..64) LSB-first."""
        if nbits == 0:
            return 0
        pos = self._pos
        self._pos = pos + nbits
        word_idx = pos >> 6
        bit_idx = pos & 63
        if word_idx >= len(self._words):
            return 0
        lo = int(self._words[word_idx]) >> bit_idx
        avail = 64 - bit_idx
        if nbits > avail:
            hi = int(self._words[word_idx + 1]) if word_idx + 1 < len(
                self._words) else 0
            lo |= hi << avail
        return lo & ((1 << nbits) - 1)

    def peek(self, nbits: int) -> int:
        pos = self._pos
        v = self.read(nbits)
        self._pos = pos
        return v

    def skip(self, nbits: int) -> None:
        self._pos += nbits

    def read_bool(self) -> bool:
        return self.read(1) == 1

    def jump_to_byte_boundary(self) -> bool:
        """Skip to byte boundary; returns False if skipped bits are nonzero."""
        pad = (-self._pos) % 8
        return self.read(pad) == 0 if pad else True

    def read_bytes(self, n: int) -> bytes:
        assert self._pos % 8 == 0
        start = self._pos // 8
        self._pos += n * 8
        return self._data[start:start + n]
