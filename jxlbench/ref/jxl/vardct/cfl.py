"""Chroma-from-luma correlation (reference ``lib/jxl/chroma_from_luma.{h,cc}``)."""

from __future__ import annotations

import numpy as np

from jxlbench.ref.jxl.core.fields import (
    BitsOffset, FormatError, U32Enc, Val, read_f16,
)
from jxlbench.ref.jxl.utils.bits import BitReader

K_DEFAULT_COLOR_FACTOR = 84
K_CFL_FIXED_POINT_PRECISION = 11
K_COLOR_TILE_DIM = 64             # pixels; 8 blocks
K_COLOR_TILE_DIM_IN_BLOCKS = 8
K_YTOB_RATIO_DEFAULT = 1.0        # jxl::cms::kYToBRatio

_COLOR_FACTOR_DIST = U32Enc(Val(K_DEFAULT_COLOR_FACTOR), Val(256),
                            BitsOffset(8, 2), BitsOffset(16, 258))


class ColorCorrelation:
    """(chroma_from_luma.h:50-112)."""

    def __init__(self):
        self.color_factor = K_DEFAULT_COLOR_FACTOR
        self.base_correlation_x = 0.0
        self.base_correlation_b = K_YTOB_RATIO_DEFAULT
        self.ytox_dc = 0
        self.ytob_dc = 0

    @property
    def color_scale(self) -> float:
        return 1.0 / self.color_factor

    def ytox_ratio(self, factor: int) -> float:
        return self.base_correlation_x + factor * self.color_scale

    def ytob_ratio(self, factor: int) -> float:
        return self.base_correlation_b + factor * self.color_scale

    def ytox_ratio_arr(self, factors) -> "np.ndarray":
        import numpy as np
        return (self.base_correlation_x +
                np.asarray(factors, np.float32) * self.color_scale)

    def ytob_ratio_arr(self, factors) -> "np.ndarray":
        import numpy as np
        return (self.base_correlation_b +
                np.asarray(factors, np.float32) * self.color_scale)

    def dc_factors(self):
        return (self.ytox_ratio(self.ytox_dc), 0.0,
                self.ytob_ratio(self.ytob_dc))

    def decode_dc(self, r: BitReader) -> None:
        """(chroma_from_luma.cc:24-45)."""
        if r.read(1) == 1:
            return
        from jxlbench.ref.jxl.core.fields import read_u32
        self.color_factor = read_u32(r, _COLOR_FACTOR_DIST)
        self.base_correlation_x = read_f16(r)
        if abs(self.base_correlation_x) > 4.0:
            raise FormatError("base X correlation out of range")
        self.base_correlation_b = read_f16(r)
        if abs(self.base_correlation_b) > 4.0:
            raise FormatError("base B correlation out of range")
        self.ytox_dc = r.read(8) - 128
        self.ytob_dc = r.read(8) - 128
