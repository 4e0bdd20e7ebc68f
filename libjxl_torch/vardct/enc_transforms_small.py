"""Forward 8x8 special transforms for the encoder (reference
``lib/jxl/enc_transforms-inl.h:464-621``).

Each special strategy (IDENTITY, DCT2X2, DCT4X4, DCT4X8, DCT8X4, AFV0-3)
is a bijective linear map between the 64 block pixels and the 64 stored
coefficients. We build the inverse matrix by probing the DECODER's
``special_to_pixels`` with unit vectors and invert it — the forward is
then exact against our own inverse by construction (and against the
reference decoder, whose inverse ours matches)."""

from __future__ import annotations

import functools

import numpy as np

from libjxl_torch.vardct.transforms_small import special_to_pixels

# strategy id -> relative cost multiplier (enc_ac_strategy.cc
# kTransforms8x8 entropy_mul values, relative to DCT's 0.8)
SMALL_STRATEGIES = {
    1: 1.0427542510634957 / 0.8,    # IDENTITY
    2: 0.95 / 0.8,                  # DCT2X2
    3: 1.08 / 0.8,                  # DCT4X4
    12: 0.85931637428340035 / 0.8,  # DCT4X8
    13: 0.85931637428340035 / 0.8,  # DCT8X4
    14: 0.81779489591359944 / 0.8,  # AFV0
    15: 0.81779489591359944 / 0.8,  # AFV1
    16: 0.81779489591359944 / 0.8,  # AFV2
    17: 0.81779489591359944 / 0.8,  # AFV3
}


@functools.lru_cache(maxsize=None)
def inverse_matrix(raw: int) -> np.ndarray:
    """(64, 64) M with pixels_flat = M @ stored_flat (raw=0 is the plain
    8x8 DCT, included so all candidates share pixel-domain distortion)."""
    from libjxl_torch.vardct.dct import coeffs_stored_to_rc, idct2d
    m = np.zeros((64, 64))
    for i in range(64):
        e = np.zeros(64)
        e[i] = 1.0
        if raw == 0:
            m[:, i] = idct2d(coeffs_stored_to_rc(
                e.reshape(8, 8), 8, 8)).reshape(64)
        else:
            m[:, i] = special_to_pixels(raw, e.reshape(8, 8)).reshape(64)
    return m


@functools.lru_cache(maxsize=None)
def forward_matrix(raw: int) -> np.ndarray:
    """(64, 64) F with stored_flat = F @ pixels_flat."""
    return np.linalg.inv(inverse_matrix(raw))
