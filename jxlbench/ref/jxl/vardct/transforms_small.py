"""Small/special inverse transforms: IDENTITY, DCT2X2, DCT4X4,
DCT4X8/DCT8X4, AFV0-3 (reference ``lib/jxl/dec_transforms-inl.h:404-570``)
and their forward counterparts (``enc_transforms-inl.h``).

All operate on the stored 64-float coefficient layout of one 8x8 block
(transposed convention, see dct.py)."""

from __future__ import annotations

import numpy as np

from jxlbench.ref.jxl.vardct.afv_basis import AFV_BASIS
from jxlbench.ref.jxl.vardct.dct import coeffs_stored_to_rc, idct2d, dct2d, \
    coeffs_rc_to_stored

_AFV = np.array(AFV_BASIS, dtype=np.float64)        # [coef, pixel]


def _scaled_idct(stored: np.ndarray, r: int, c: int) -> np.ndarray:
    return idct2d(coeffs_stored_to_rc(stored, r, c))


def identity_to_pixels(co: np.ndarray) -> np.ndarray:
    """(dec_transforms-inl.h IDENTITY)."""
    pixels = np.zeros((8, 8))
    dcs = [co[0, 0] + co[0, 1] + co[1, 0] + co[1, 1],
           co[0, 0] + co[0, 1] - co[1, 0] - co[1, 1],
           co[0, 0] - co[0, 1] + co[1, 0] - co[1, 1],
           co[0, 0] - co[0, 1] - co[1, 0] + co[1, 1]]
    for y in range(2):
        for x in range(2):
            block_dc = dcs[y * 2 + x]
            residual_sum = 0.0
            for iy in range(4):
                for ix in range(4):
                    if ix == 0 and iy == 0:
                        continue
                    residual_sum += co[y + iy * 2, x + ix * 2]
            center = block_dc - residual_sum / 16.0
            pixels[4 * y + 1, 4 * x + 1] = center
            for iy in range(4):
                for ix in range(4):
                    if ix == 1 and iy == 1:
                        continue
                    pixels[y * 4 + iy, x * 4 + ix] = \
                        co[y + iy * 2, x + ix * 2] + center
            pixels[y * 4, x * 4] = co[y + 2, x + 2] + center
    return pixels


def _idct2_top(block: np.ndarray, s: int) -> np.ndarray:
    """IDCT2TopBlock<S> (dec_transforms-inl.h:66-93)."""
    out = block.copy()
    half = s // 2
    c00 = block[:half, :half]
    c01 = block[:half, half:s]
    c10 = block[half:s, :half]
    c11 = block[half:s, half:s]
    r00 = c00 + c01 + c10 + c11
    r01 = c00 + c01 - c10 - c11
    r10 = c00 - c01 + c10 - c11
    r11 = c00 - c01 - c10 + c11
    out[0:s:2, 0:s:2] = r00
    out[0:s:2, 1:s:2] = r01
    out[1:s:2, 0:s:2] = r10
    out[1:s:2, 1:s:2] = r11
    return out


def dct2x2_to_pixels(co: np.ndarray) -> np.ndarray:
    b = co.copy()
    b = _idct2_top(b, 2)
    b = _idct2_top(b, 4)
    b = _idct2_top(b, 8)
    return b


def dct4x4_to_pixels(co: np.ndarray) -> np.ndarray:
    pixels = np.zeros((8, 8))
    dcs = [co[0, 0] + co[0, 1] + co[1, 0] + co[1, 1],
           co[0, 0] + co[0, 1] - co[1, 0] - co[1, 1],
           co[0, 0] - co[0, 1] + co[1, 0] - co[1, 1],
           co[0, 0] - co[0, 1] - co[1, 0] + co[1, 1]]
    for y in range(2):
        for x in range(2):
            block = np.zeros((4, 4))
            block[0, 0] = dcs[y * 2 + x]
            for iy in range(4):
                for ix in range(4):
                    if ix == 0 and iy == 0:
                        continue
                    block[iy, ix] = co[y + iy * 2, x + ix * 2]
            pixels[y * 4:(y + 1) * 4, x * 4:(x + 1) * 4] = \
                _scaled_idct(block, 4, 4)
    return pixels


def dct4x8_to_pixels(co: np.ndarray) -> np.ndarray:
    """DCT4X8: two 4x8 IDCTs stacked vertically."""
    pixels = np.zeros((8, 8))
    dc0 = co[0, 0] + co[1, 0]
    dc1 = co[0, 0] - co[1, 0]
    for y, dc in ((0, dc0), (1, dc1)):
        block = np.zeros((4, 8))
        block[0, 0] = dc
        for iy in range(4):
            for ix in range(8):
                if ix == 0 and iy == 0:
                    continue
                block[iy, ix] = co[y + iy * 2, ix]
        pixels[y * 4:(y + 1) * 4, :] = _scaled_idct(block, 4, 8)
    return pixels


def dct8x4_to_pixels(co: np.ndarray) -> np.ndarray:
    """DCT8X4: two 8x4 IDCTs side by side."""
    pixels = np.zeros((8, 8))
    dc0 = co[0, 0] + co[1, 0]
    dc1 = co[0, 0] - co[1, 0]
    for x, dc in ((0, dc0), (1, dc1)):
        block = np.zeros((4, 8))
        block[0, 0] = dc
        for iy in range(4):
            for ix in range(8):
                if ix == 0 and iy == 0:
                    continue
                block[iy, ix] = co[x + iy * 2, ix]
        pixels[:, x * 4:(x + 1) * 4] = _scaled_idct(block, 8, 4)
    return pixels


def afv_to_pixels(co: np.ndarray, kind: int) -> np.ndarray:
    """AFV0-3 (dec_transforms-inl.h:399-452)."""
    afv_x = kind & 1
    afv_y = kind // 2
    pixels = np.zeros((8, 8))
    dcs = [(co[0, 0] + co[1, 0] + co[0, 1]) * 4.0,
           co[0, 0] + co[1, 0] - co[0, 1],
           co[0, 0] - co[1, 0]]
    # AFV quadrant
    coeff = np.zeros(16)
    coeff[0] = dcs[0]
    for iy in range(4):
        for ix in range(4):
            if ix == 0 and iy == 0:
                continue
            coeff[iy * 4 + ix] = co[iy * 2, ix * 2]
    afv_block = (coeff @ _AFV).reshape(4, 4)
    qy = afv_y * 4
    qx = afv_x * 4
    blk = afv_block
    if afv_y == 1:
        blk = blk[::-1, :]
    if afv_x == 1:
        blk = blk[:, ::-1]
    pixels[qy:qy + 4, qx:qx + 4] = blk
    # 4x4 DCT quadrant (same row, other column)
    block = np.zeros((4, 4))
    block[0, 0] = dcs[1]
    for iy in range(4):
        for ix in range(4):
            if ix == 0 and iy == 0:
                continue
            block[iy, ix] = co[iy * 2, ix * 2 + 1]
    px = 0 if afv_x == 1 else 4
    pixels[qy:qy + 4, px:px + 4] = _scaled_idct(block, 4, 4)
    # 4x8 DCT half (other row)
    block = np.zeros((4, 8))
    block[0, 0] = dcs[2]
    for iy in range(4):
        for ix in range(8):
            if ix == 0 and iy == 0:
                continue
            block[iy, ix] = co[1 + iy * 2, ix]
    py = 0 if afv_y == 1 else 4
    pixels[py:py + 4, :] = _scaled_idct(block, 4, 8)
    return pixels


def special_to_pixels(raw: int, stored: np.ndarray) -> np.ndarray:
    if raw == 1:
        return identity_to_pixels(stored)
    if raw == 2:
        return dct2x2_to_pixels(stored)
    if raw == 3:
        return dct4x4_to_pixels(stored)
    if raw == 12:
        return dct4x8_to_pixels(stored)
    if raw == 13:
        return dct8x4_to_pixels(stored)
    if 14 <= raw <= 17:
        return afv_to_pixels(stored, raw - 14)
    raise ValueError(raw)
