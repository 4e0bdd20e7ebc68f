"""Lehmer-coded permutations (reference ``lib/jxl/coeff_order.cc:44-100``,
``lib/jxl/lehmer_code.h``)."""

from __future__ import annotations

import numpy as np

from jxlbench.ref.jxl.core.fields import FormatError
from jxlbench.ref.jxl.entropy.ans import ANSSymbolReader, decode_histograms
from jxlbench.ref.jxl.entropy.hybrid import HybridUintConfig
from jxlbench.ref.jxl.utils.bits import BitReader

K_PERMUTATION_CONTEXTS = 8
_CFG000 = HybridUintConfig(0, 0, 0)


def coeff_order_context(val: int) -> int:
    token, _, _ = _CFG000.encode(val)
    return min(token, K_PERMUTATION_CONTEXTS - 1)


def decode_lehmer(lehmer: np.ndarray) -> np.ndarray:
    """Lehmer code -> permutation (lehmer_code.h DecodeLehmerCode)."""
    n = len(lehmer)
    remaining = list(range(n))
    out = np.zeros(n, dtype=np.int64)
    for i in range(n):
        idx = int(lehmer[i])
        if idx >= len(remaining):
            raise FormatError("invalid lehmer code")
        out[i] = remaining.pop(idx)
    return out


def encode_lehmer(perm) -> np.ndarray:
    n = len(perm)
    remaining = list(range(n))
    out = np.zeros(n, dtype=np.int64)
    for i, p in enumerate(perm):
        idx = remaining.index(int(p))
        out[i] = idx
        remaining.pop(idx)
    return out


def read_permutation_tokens(r: BitReader, reader: ANSSymbolReader,
                            size: int, skip: int) -> np.ndarray:
    """(coeff_order.cc:44-70). Returns the permutation array of `size`."""
    end = reader.read_hybrid_uint(coeff_order_context(size), r) + skip
    if end > size:
        raise FormatError("invalid permutation size")
    lehmer = np.zeros(size, dtype=np.int64)
    last = 0
    for i in range(skip, end):
        lehmer[i] = reader.read_hybrid_uint(coeff_order_context(last), r)
        last = int(lehmer[i])
        if lehmer[i] >= size - i:
            raise FormatError("invalid lehmer value")
    return decode_lehmer(lehmer)


def decode_permutation(r: BitReader, size: int, skip: int = 0) -> np.ndarray:
    """Standalone permutation (e.g. TOC), with its own histograms."""
    code = decode_histograms(r, K_PERMUTATION_CONTEXTS)
    reader = ANSSymbolReader(code, r)
    perm = read_permutation_tokens(r, reader, size, skip)
    if not reader.check_final_state():
        raise FormatError("invalid permutation ANS state")
    return perm


def encode_permutation(w, perm, skip: int = 0) -> None:
    """Standalone Lehmer-coded permutation with its own histograms
    (inverse of decode_permutation; coeff_order.cc EncodePermutation)."""
    from jxlbench.ref.jxl.entropy.ans import (
        build_entropy_codes, write_entropy_codes, write_tokens,
    )
    perm = np.asarray(perm)
    size = len(perm)
    lehmer = encode_lehmer(perm)
    end = size
    while end > skip and lehmer[end - 1] == 0:
        end -= 1                    # trailing zeros are implicit
    toks = [(coeff_order_context(size), end - skip)]
    last = 0
    for i in range(skip, end):
        toks.append((coeff_order_context(last), int(lehmer[i])))
        last = int(lehmer[i])
    arr = np.array(toks, dtype=np.int64).reshape(-1, 2)
    codes = build_entropy_codes([arr], K_PERMUTATION_CONTEXTS)
    write_entropy_codes(w, codes)
    write_tokens(w, arr, codes)
