"""XYB color space conversions (reference ``lib/jxl/dec_xyb-inl.h:39-86``,
``lib/jxl/enc_xyb.cc``, constants ``lib/jxl/cms/opsin_params.h``)."""

from __future__ import annotations

import numpy as np

OPSIN_ABSORBANCE = np.array([
    [0.30, 1.0 - 0.078 - 0.30, 0.078],
    [0.23, 1.0 - 0.078 - 0.23, 0.078],
    [0.24342268924547819, 0.20476744424496821,
     1.0 - 0.24342268924547819 - 0.20476744424496821]])

INVERSE_OPSIN = np.array([
    [11.031566901960783, -9.866943921568629, -0.16462299647058826],
    [-3.254147380392157, 4.418770392156863, -0.16462299647058826],
    [-3.6588512862745097, 2.7129230470588235, 1.9459282392156863]])

OPSIN_BIAS = 0.0037930732552754493
NEG_BIAS_CBRT = -(OPSIN_BIAS ** (1.0 / 3.0))


def xyb_to_linear(xyb: np.ndarray, intensity_target: float = 255.0
                  ) -> np.ndarray:
    """(3, H, W) XYB -> linear RGB (1.0 = intensity_target nits)."""
    ox, oy, ob = xyb[0], xyb[1], xyb[2]
    gamma_r = oy + ox - NEG_BIAS_CBRT
    gamma_g = oy - ox - NEG_BIAS_CBRT
    gamma_b = ob - NEG_BIAS_CBRT
    mixed_r = gamma_r * gamma_r * gamma_r - OPSIN_BIAS
    mixed_g = gamma_g * gamma_g * gamma_g - OPSIN_BIAS
    mixed_b = gamma_b * gamma_b * gamma_b - OPSIN_BIAS
    mixed = np.stack([mixed_r, mixed_g, mixed_b])
    inv = INVERSE_OPSIN * (255.0 / intensity_target)
    return np.einsum("ij,jhw->ihw", inv, mixed)


def linear_to_xyb(rgb: np.ndarray) -> np.ndarray:
    """Forward: linear RGB (1.0 = SDR white) -> XYB (enc_xyb.cc)."""
    mixed = np.einsum("ij,jhw->ihw", OPSIN_ABSORBANCE, rgb) + OPSIN_BIAS
    mixed = np.maximum(mixed, 1e-12)
    g = np.cbrt(mixed) + NEG_BIAS_CBRT
    x = 0.5 * (g[0] - g[1])
    y = 0.5 * (g[0] + g[1])
    b = g[2]
    return np.stack([x, y, b])


def srgb_to_linear(srgb: np.ndarray) -> np.ndarray:
    srgb = np.asarray(srgb, dtype=np.float64)
    return np.where(srgb <= 0.04045, srgb / 12.92,
                    ((srgb + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(linear: np.ndarray) -> np.ndarray:
    linear = np.asarray(linear)
    a = np.abs(linear)
    enc = np.where(a <= 0.0031308, a * 12.92,
                   1.055 * a ** (1 / 2.4) - 0.055)
    return np.sign(linear) * enc


def ycbcr_to_rgb(cb: "np.ndarray", y: "np.ndarray", cr: "np.ndarray"):
    """Full-range BT.601 (stage_ycbcr.cc; values in [0,1]-scale floats,
    buffer order Cb, Y, Cr)."""
    yv = y + 128.0 / 255
    r = 1.402 * cr + yv
    g = yv + (-0.114 * 1.772 / 0.587) * cb + (-0.299 * 1.402 / 0.587) * cr
    b = 1.772 * cb + yv
    return r, g, b


def chroma_upsample(plane: "np.ndarray", horizontal: bool) -> "np.ndarray":
    """2x chroma upsampling with the 3/4-1/4 kernel
    (stage_chroma_upsampling.cc)."""
    p = plane
    if not horizontal:
        p = p.T
    left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    out = np.empty((p.shape[0], p.shape[1] * 2), p.dtype)
    out[:, 0::2] = 0.75 * p + 0.25 * left
    out[:, 1::2] = 0.75 * p + 0.25 * right
    return out if horizontal else out.T
