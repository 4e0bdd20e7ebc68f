"""Hybrid-uint token coding (reference ``lib/jxl/dec_ans.h:40-103``).

A value is either a small direct token (< 2**split_exponent) or a token
encoding (exponent, msb, lsb) plus raw mantissa bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class HybridUintConfig:
    split_exponent: int = 4
    msb_in_token: int = 2
    lsb_in_token: int = 0

    @property
    def split_token(self) -> int:
        return 1 << self.split_exponent

    def encode(self, value: int) -> tuple[int, int, int]:
        """value -> (token, nbits, bits)."""
        if value < self.split_token:
            return value, 0, 0
        n = value.bit_length() - 1
        m = value - (1 << n)
        token = (self.split_token +
                 ((n - self.split_exponent) <<
                  (self.msb_in_token + self.lsb_in_token)) +
                 ((m >> (n - self.msb_in_token)) << self.lsb_in_token) +
                 (m & ((1 << self.lsb_in_token) - 1)))
        nbits = n - self.msb_in_token - self.lsb_in_token
        bits = (value >> self.lsb_in_token) & ((1 << nbits) - 1)
        return token, nbits, bits

    def encode_array(self, values: np.ndarray):
        """Vectorized encode: values -> (tokens, nbits, bits) int32/uint32."""
        values = np.asarray(values, dtype=np.uint32)
        small = values < self.split_token
        safe = np.maximum(values, 1)
        # floor-log2 by bit twiddling (float log2 is unsafe near 2**24)
        n = np.zeros_like(values, dtype=np.int32)
        v = safe.astype(np.uint32).copy()
        for shift in (16, 8, 4, 2, 1):
            m = v >= (np.uint32(1) << np.uint32(shift))
            n = np.where(m, n + shift, n)
            v = np.where(m, v >> np.uint32(shift), v)
        mant = values - (np.uint32(1) << n.astype(np.uint32))
        mtok, ltok = self.msb_in_token, self.lsb_in_token
        token_big = (self.split_token +
                     (((n - self.split_exponent) << (mtok + ltok)).astype(
                         np.uint32)) +
                     ((mant >> np.maximum(n - mtok, 0).astype(np.uint32))
                      << np.uint32(ltok)) +
                     (mant & ((np.uint32(1) << np.uint32(ltok)) -
                              np.uint32(1))))
        nbits_big = n - mtok - ltok
        bits_big = (values >> np.uint32(ltok)) & (
            (np.uint32(1) << nbits_big.clip(0).astype(np.uint32)) -
            np.uint32(1))
        tokens = np.where(small, values, token_big).astype(np.int32)
        nbits = np.where(small, 0, nbits_big).astype(np.int32)
        bits = np.where(small, 0, bits_big).astype(np.uint32)
        return tokens, nbits, bits

    def decode(self, token: int, read_bits) -> int:
        """token + bit-reader callback -> value
        (ReadHybridUintConfig, dec_ans.h:228-262)."""
        if token < self.split_token:
            return token
        mtok, ltok = self.msb_in_token, self.lsb_in_token
        nbits = (self.split_exponent - (mtok + ltok) +
                 ((token - self.split_token) >> (mtok + ltok)))
        nbits &= 31
        low = token & ((1 << ltok) - 1)
        token >>= ltok
        bits = read_bits(nbits)
        return ((((1 << mtok) | (token & ((1 << mtok) - 1))) << nbits | bits)
                << ltok) | low


# Default config used in most token streams (dec_ans.h:95).
DEFAULT_UINT_CONFIG = HybridUintConfig(4, 2, 0)
