"""Vectorised pieces of the reference's modular decode, for channels coded
with one prefix code and no LZ77 under a single-leaf tree (the fast
lossless encode's streams): the token walk is the only Python loop.

Every bit position of the section gets the token that would start there
and that token's length (code plus extra bits) in a few numpy passes;
the walk then follows the lengths from the channel's first bit. Values
are the hybrid-uint decode of (token, extra bits), as
``HybridUintConfig.decode`` computes one at a time."""

from __future__ import annotations

import numpy as np


def _hybrid_nbits(tok: np.ndarray, cfg) -> np.ndarray:
    split = 1 << cfg.split_exponent
    ml = cfg.msb_in_token + cfg.lsb_in_token
    nb = (cfg.split_exponent - ml + ((tok - split) >> ml)) & 31
    return np.where(tok < split, 0, nb)


def _hybrid_values(tok: np.ndarray, bits: np.ndarray, cfg) -> np.ndarray:
    split = 1 << cfg.split_exponent
    m, lsb = cfg.msb_in_token, cfg.lsb_in_token
    nb = _hybrid_nbits(tok, cfg)
    low = tok & ((1 << lsb) - 1)
    t = tok >> lsb
    big = ((((1 << m) | (t & ((1 << m) - 1))) << nb | bits) << lsb) | low
    return np.where(tok < split, tok, big)


def _windows(data: bytes, start: int, stop: int) -> np.ndarray:
    """64-bit LSB-first windows starting at every bit in [start, stop)."""
    buf = np.frombuffer(data + b"\x00" * 16, dtype=np.uint8)
    words = np.ndarray((len(data) + 9,), dtype="<u8", buffer=buf,
                       strides=(1,))
    pos = np.arange(start, stop, dtype=np.int64)
    return words[pos >> 3] >> (pos & 7).astype(np.uint64)


def _tables(r, ctx: int, pc, cfg):
    """Per bit position from ``start`` to the end of the section: the
    window, the token starting there, its code length and extra bits,
    made once per section and context."""
    cache = r.__dict__.setdefault("_prefix_fast", {})
    if ctx not in cache:
        start = r.bits_consumed
        w = _windows(r._data, start, r.total_bits() + 1)
        ml = pc.max_len
        if ml:
            idx = (w & np.uint64((1 << ml) - 1)).astype(np.int64)
            sym = pc.table_sym.astype(np.int64)[idx]
            clen = pc.table_len.astype(np.int64)[idx]
        else:
            sym = np.full(w.shape, int(pc.table_sym[0]), dtype=np.int64)
            clen = np.zeros(w.shape, dtype=np.int64)
        nb = _hybrid_nbits(sym, cfg)
        cache[ctx] = (start, w, sym, clen, nb, (clen + nb).tolist())
    return cache[ctx]


def decode_run(reader, r, ctx: int, n: int):
    """``n`` hybrid-uint values of clustered context ``ctx``, read from
    ``r`` with ``reader``'s prefix code; None where the stream is not of
    that shape (ANS, LZ77), so the caller takes the scalar path."""
    code = reader.code
    if not code.use_prefix_code or code.lz77.enabled or n <= 0:
        return None
    pc = code.prefix_codes[ctx]
    if pc is None:
        return None
    cfg = code.uint_configs[ctx]
    if pc.max_len + int(_hybrid_nbits(np.array([int(pc.table_sym.max())]),
                                      cfg)[0]) > 56:
        return None
    base, w, sym, clen, nb, step = _tables(r, ctx, pc, cfg)
    last = len(step) - 1
    at = [0] * n
    p = r.bits_consumed - base
    for k in range(n):
        if p > last:
            return None          # truncated: the scalar path raises
        at[k] = p
        p += step[p]
    at = np.asarray(at, dtype=np.int64)
    s, c, b = sym[at], clen[at], nb[at]
    bits = ((w[at] >> c.astype(np.uint64)) &
            ((np.uint64(1) << b.astype(np.uint64)) - np.uint64(1))
            ).astype(np.int64)
    r.skip(p + base - r.bits_consumed)
    return _hybrid_values(s, bits, cfg).astype(np.uint32)


_DIAGONALS: dict = {}


def _diagonals(h: int, w: int) -> list:
    """Flat indices of the interior pixels (y >= 1, x >= 1) of an (h, w)
    plane, one array per anti-diagonal, in order."""
    if (h, w) not in _DIAGONALS:
        yy, xx = np.mgrid[1:h, 1:w]
        d = (yy + xx).ravel()
        flat = (yy * w + xx).ravel()
        order = np.argsort(d, kind="stable")
        bounds = np.searchsorted(d[order], np.arange(2, h + w))
        _DIAGONALS[(h, w)] = np.split(flat[order], bounds[1:])
    return _DIAGONALS[(h, w)]


def gradient_reconstruct(vals: np.ndarray, h: int, w: int) -> np.ndarray:
    """Undo the clamped-gradient predictor over an (h, w) plane of packed
    residuals, with the edge rules of the scalar loop in
    ``modular/codec.py``: the first row predicts from the left and the
    first column from above (running sums), and the interior one
    anti-diagonal at a time, since a pixel needs only the two diagonals
    before it."""
    v = vals.reshape(h, w).astype(np.int64)
    res = (v >> 1) ^ -(v & 1)
    plane = np.zeros((h, w), dtype=np.int64)
    plane[0] = np.cumsum(res[0])
    plane[:, 0] = plane[0, 0] + np.concatenate([[0], np.cumsum(res[1:, 0])])
    flat, rflat = plane.reshape(-1), res.reshape(-1)
    for idx in _diagonals(h, w):
        top = flat[idx - w]
        left = flat[idx - 1]
        tl = flat[idx - w - 1]
        lo = np.minimum(top, left)
        hi = np.maximum(top, left)
        flat[idx] = rflat[idx] + np.clip(top + left - tl, lo, hi)
    return ((plane + 0x80000000) & 0xFFFFFFFF) - 0x80000000
