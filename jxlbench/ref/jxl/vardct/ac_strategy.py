"""AC strategy (transform shape) table — 27 strategies
(reference ``lib/jxl/ac_strategy.h:35-173``, ``lib/jxl/coeff_order.h:44-47``,
``lib/jxl/quant_weights.h:337-348``)."""

from __future__ import annotations

import functools

import numpy as np

NUM_STRATEGIES = 27

# name, covered_blocks_x, covered_blocks_y
_STRATEGIES = [
    ("DCT", 1, 1), ("IDENTITY", 1, 1), ("DCT2X2", 1, 1), ("DCT4X4", 1, 1),
    ("DCT16X16", 2, 2), ("DCT32X32", 4, 4), ("DCT16X8", 1, 2),
    ("DCT8X16", 2, 1), ("DCT32X8", 1, 4), ("DCT8X32", 4, 1),
    ("DCT32X16", 2, 4), ("DCT16X32", 4, 2), ("DCT4X8", 1, 1),
    ("DCT8X4", 1, 1), ("AFV0", 1, 1), ("AFV1", 1, 1), ("AFV2", 1, 1),
    ("AFV3", 1, 1), ("DCT64X64", 8, 8), ("DCT64X32", 4, 8),
    ("DCT32X64", 8, 4), ("DCT128X128", 16, 16), ("DCT128X64", 8, 16),
    ("DCT64X128", 16, 8), ("DCT256X256", 32, 32), ("DCT256X128", 16, 32),
    ("DCT128X256", 32, 16),
]

NAMES = tuple(s[0] for s in _STRATEGIES)
COVERED_X = tuple(s[1] for s in _STRATEGIES)
COVERED_Y = tuple(s[2] for s in _STRATEGIES)
LOG2_COVERED = tuple((cx * cy).bit_length() - 1
                     for _, cx, cy in _STRATEGIES)

# Strategy -> order bucket (coeff_order.h:44-47)
STRATEGY_ORDER = (0, 1, 1, 1, 2, 3, 4, 4, 5, 5, 6, 6, 1, 1,
                  1, 1, 1, 1, 7, 8, 8, 9, 10, 10, 11, 12, 12)

# Strategy -> quant table kind (quant_weights.h:338-348)
QUANT_KIND = (0, 1, 2, 3, 4, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 10, 10,
              11, 12, 12, 13, 14, 14, 15, 16, 16)


def is_valid(raw: int) -> bool:
    return 0 <= raw < NUM_STRATEGIES


def covered_blocks(raw: int) -> tuple[int, int]:
    """(cx, cy) for a strategy."""
    return COVERED_X[raw], COVERED_Y[raw]


@functools.lru_cache(maxsize=None)
def natural_order(raw: int) -> np.ndarray:
    """Generalized zig-zag order (ac_strategy.cc:29-80): order[k] gives the
    index into the (cy*8, cx*8)-layout coefficient array, after the
    cx>=cy swap."""
    cx, cy = COVERED_X[raw], COVERED_Y[raw]
    if cy > cx:
        cx, cy = cy, cx
    out = np.zeros(cx * cy * 64, dtype=np.int32)
    xs = cx // cy
    xsm = xs - 1
    xss = xs.bit_length() - 1
    cur = cx * cy
    for i in range(cx * 8):
        for j in range(i + 1):
            x, y = j, i - j
            if i % 2:
                x, y = y, x
            if y & xsm:
                continue
            y >>= xss
            if x < cx and y < cy:
                val = y * cx + x
            else:
                val = cur
                cur += 1
            out[val] = y * cx * 8 + x
    for ip in range(cx * 8 - 1, 0, -1):
        i = ip - 1
        for j in range(i + 1):
            x = cx * 8 - 1 - (i - j)
            y = cx * 8 - 1 - j
            if i % 2:
                x, y = y, x
            if y & xsm:
                continue
            y >>= xss
            out[cur] = y * cx * 8 + x
            cur += 1
    return out
