"""JPEG XL DCT semantics (numpy reference + matmul form for TPU).

The format's DCT is the orthogonal DCT-II family with these scalings
(reference ``lib/jxl/dct_for_test.h`` which the fast path must match):
  forward 1D: out[u] = alpha(u) * sqrt(2)/N * sum_y cos((y+.5) u pi/N) in[y]
  inverse 1D: out[y] = sqrt(2) * sum_u alpha(u) cos((y+.5) u pi/N) in[u]
with alpha(0)=1/sqrt(2).  DC equals the block mean.

Rectangular blocks (RxC pixels) store coefficients in a
(min, max)-shaped array with the long side as columns (the "cx >= cy"
coefficient layout, ``lib/jxl/ac_strategy.cc:29-80``); the 2D transform is
separable: pixels = M_R @ B @ M_C^T where B is the (R, C)-oriented view
(``lib/jxl/dct-inl.h:354-399``).

LLF resampling scales for DC <-> lowest frequencies of big blocks come
from ``lib/jxl/dct_scales.h`` and are generated here from their closed
form (see the comment at dct_scales.h:34-40).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def idct_matrix(n: int) -> np.ndarray:
    """M[y,u] = sqrt(2)*alpha(u)*cos((y+0.5) u pi / n)."""
    y = np.arange(n)[:, None]
    u = np.arange(n)[None, :]
    m = np.cos((y + 0.5) * u * np.pi / n) * np.sqrt(2.0)
    m[:, 0] *= 1.0 / np.sqrt(2.0)
    return m.astype(np.float64)


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Forward: D = (1/n) * M^T (so that D @ M = I)."""
    return (idct_matrix(n).T / n).astype(np.float64)


def dct2d(pixels: np.ndarray) -> np.ndarray:
    """Forward 2D DCT of an (R, C) block -> (R, C) coefficient grid."""
    r, c = pixels.shape
    return dct_matrix(r) @ pixels @ dct_matrix(c).T


def idct2d(coeffs_rc: np.ndarray) -> np.ndarray:
    """Inverse of dct2d on the (R, C)-oriented coefficient grid."""
    r, c = coeffs_rc.shape
    return idct_matrix(r) @ coeffs_rc @ idct_matrix(c).T


def coeffs_stored_to_rc(stored: np.ndarray, r: int, c: int) -> np.ndarray:
    """(min,max) stored layout -> (R, C) orientation.

    For R >= C (tall or square) the stored array is transposed:
    rows index the horizontal frequency (ComputeScaledIDCT, dct-inl.h:377)."""
    if r >= c:
        return stored.T
    return stored


def coeffs_rc_to_stored(rc: np.ndarray) -> np.ndarray:
    """(R, C) orientation -> (min,max) stored layout."""
    r, c = rc.shape
    return rc.T if r >= c else rc


@functools.lru_cache(maxsize=None)
def resample_scales(n: int) -> np.ndarray:
    """DCTResampleScales<8n, n> via the generator at dct_scales.h:34-40:
    scale[i] = cos(i pi / (2N)) * cos(i pi / N) * cos(i pi / (N/2)),
    with N = 8n the big transform size."""
    big = 8 * n
    i = np.arange(n, dtype=np.float64)
    return (np.cos(i * np.pi / (2 * big)) * np.cos(i * np.pi / big) *
            np.cos(i * np.pi / (big / 2)))


def llf_from_dc(dc_block: np.ndarray, covered_y: int, covered_x: int
                ) -> np.ndarray:
    """LowestFrequenciesFromDC (dec_transforms-inl.h:691-760): DCT the
    (cy, cx) DC block and scale to the big block's LLF coefficients.
    Returns the (cy, cx)-shaped LLF grid in (R,C) orientation."""
    cy, cx = covered_y, covered_x
    coeff = dct2d(dc_block.astype(np.float64))
    # ReinterpretingDCT multiplies by DCTResampleScales<n, 8n> — the
    # UPSAMPLING table, i.e. the reciprocal of resample_scales(n).
    sy = 1.0 / resample_scales(cy)
    sx = 1.0 / resample_scales(cx)
    return coeff * sy[:, None] * sx[None, :]


def dc_from_llf(llf: np.ndarray) -> np.ndarray:
    """Inverse of llf_from_dc (enc_transforms DCFromLowestFrequencies)."""
    cy, cx = llf.shape
    sy = 1.0 / resample_scales(cy)
    sx = 1.0 / resample_scales(cx)
    return idct2d(llf / sy[:, None] / sx[None, :])
