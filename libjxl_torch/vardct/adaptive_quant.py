"""Adaptive quantization field (reference
``lib/jxl/enc_adaptive_quantization.cc`` AdaptiveQuantizationMap /
InitialQuantField / InitialQuantDC and ``lib/jxl/quantizer.cc``
SetQuantField).

Computes a per-8x8-block quantization multiplier from the XYB image:
a gamma-corrected Laplacian activity map, eroded towards local smooth
minima, then modulated per block by gamma/HF/blue content. Everything is
vectorized numpy (shapes are static; the same math runs under jnp for
the device path).
"""

from __future__ import annotations

import numpy as np

K_AC_QUANT = 0.765
K_DC_QUANT = 1.095924047623553
K_DC_QUANT_POW = 0.83
K_GLOBAL_SCALE_DENOM = 1 << 16
K_GLOBAL_SCALE_NUMERATOR = 4096
K_QUANT_MAX = 256

_K_SG_MUL = 226.77216153508914
_K_SG_MUL2 = 1.0 / 73.377132366608819
_K_SG_RET_MUL = _K_SG_MUL2 * 18.6580932135 * np.log(2.0)
_K_SG_V_OFFSET = 7.7825991679894591


def _ratio_cbrt_to_gamma(v, invert: bool, xp=np):
    """RatioOfDerivativesOfCubicRootToSimpleGamma
    (enc_adaptive_quantization.cc:120-146)."""
    eps = 1e-2
    v = xp.maximum(v, 0.0)
    num_mul = _K_SG_RET_MUL * 3 * _K_SG_MUL
    v_off = _K_SG_V_OFFSET * np.log(2.0) + eps
    den_mul = np.log(2.0) * _K_SG_MUL
    v2 = v * v
    num = num_mul * v2 + eps
    den = den_mul * v * v2 + v_off
    return num / den if invert else den / num


def _masking_sqrt(v, xp=np):
    k_log_offset = 27.505837037000106
    k_mul = 211.66567973503678
    return 0.25 * xp.sqrt(v * np.sqrt(k_mul * 1e8) + k_log_offset)


def _compute_mask(v, xp=np):
    """(enc_adaptive_quantization.cc:95-118)."""
    v1 = xp.maximum(v * 0.80061762862741759, 1e-3)
    v2 = 1.0 / (v1 + 302.59587815579727)
    v3 = 1.0 / (v1 * v1 + 3.7179635626140772)
    v4 = 1.0 / (v1 * v1 + 0.25 * 3.7179635626140772)
    return (-0.7647 + 9.4708735624378946 * v4 + 17.35036561631863 * v2 +
            6.7943250517376494 * v3)


def _blocks_sum(img, n):
    h, w = img.shape
    return img.reshape(h // n, n, w // n, n).sum(axis=(1, 3))


def _neighbor_stack(img, xp=np):
    """3x3 edge-clamped neighborhood stack: (9, H, W)."""
    p = xp.pad(img, 1, mode="edge")
    return xp.stack([p[1 + dy: 1 + dy + img.shape[0],
                       1 + dx: 1 + dx + img.shape[1]]
                     for dy in (-1, 0, 1) for dx in (-1, 0, 1)])


def _fuzzy_erosion(pre, d: float, xp=np):
    """(enc_adaptive_quantization.cc:389-478): weighted 4 smallest of each
    3x3 neighborhood, then 2x2-summed to per-block resolution."""
    k_mul_base = np.array([0.125, 0.1, 0.09, 0.06])
    k_mul_add = np.array([0.0, -0.1, -0.09, -0.06])
    mul = (2.0 - d) / 2.0 if d < 2.0 else 0.0
    k_mul = k_mul_base + mul * k_mul_add
    k_mul *= 0.29959705784054957 / k_mul.sum()
    stack = xp.sort(_neighbor_stack(pre, xp), axis=0)[:4]
    v = (xp.asarray(k_mul[:, None, None], stack.dtype) * stack).sum(axis=0)
    return _blocks_sum(v, 2)


def _gamma_modulation(xyb_x, xyb_y, base, xp=np):
    """(enc_adaptive_quantization.cc:179-211)."""
    bias = 0.16
    iny = xyb_y + bias
    r = _ratio_cbrt_to_gamma(iny - xyb_x, invert=True, xp=xp)
    g = _ratio_cbrt_to_gamma(iny + xyb_x, invert=True, xp=xp)
    overall = _blocks_sum(r + g, 8) * (0.5 / 64)
    return base + 0.1005613337192697 * xp.log2(overall)


def _hf_modulation(xyb_y, base, xp=np):
    """(enc_adaptive_quantization.cc:260-313): sum of clamped 4-connected
    |diffs| of Y within each block."""
    valmin = 0.0206
    h, w = xyb_y.shape
    dx = xp.minimum(xp.abs(xyb_y[:, 1:] - xyb_y[:, :-1]), valmin)
    dx = xp.pad(dx, ((0, 0), (0, 1)))
    # block-internal column diffs only (x+1 inside block for x<7)
    colmask = np.ones(w)
    colmask[7::8] = 0.0
    dx = dx * xp.asarray(colmask[None, :], dx.dtype)
    dy = xp.minimum(xp.abs(xyb_y[1:] - xyb_y[:-1]), valmin)
    dy = xp.pad(dy, ((0, 1), (0, 0)))
    rowmask = np.ones(h)
    rowmask[7::8] = 0.0   # dy==7 uses same row -> diff 0
    dy = dy * xp.asarray(rowmask[:, None], dy.dtype)
    s = _blocks_sum(dx + dy, 8)
    return base + (-0.38) * s + 0.42


def _blue_modulation(xyb_x, xyb_y, xyb_b, base, xp=np):
    """(enc_adaptive_quantization.cc:221-258)."""
    k_limit = 0.010474084867598155
    k_offset = 0.0031994768654636393
    p_y_eff = xyb_y + k_offset + xp.abs(xyb_x)
    contrib = xp.where(xyb_b > p_y_eff,
                       xp.minimum(xyb_b - p_y_eff, k_limit), 0.0)
    s = _blocks_sum(contrib, 8)
    s = xp.where(s >= 32 * k_limit, 64 * k_limit - s, s)
    s = xp.minimum(s, 15.463398341612438 * k_limit)
    return base + 0.90590804735610064 * s


def adaptive_quant_field(xyb, distance: float, rescale: float = 1.0,
                         xp=np):
    """xyb: (3, H, W) padded to 8x8 blocks. Returns (qf, masking) where
    ``qf`` is the per-block float quant field (InitialQuantField) and
    ``masking`` the AC-strategy mask (unused yet).

    ``xp=jnp`` runs the whole field on device (the math is pure array
    ops; shapes are static)."""
    scale = K_AC_QUANT / distance * rescale
    y = xyb[1]
    h, w = y.shape

    # gamma-scaled Laplacian activity, 4x4 box to quarter res
    match_gamma_offset = 0.019
    p = xp.pad(y, 1, mode="edge")
    base4 = 0.25 * (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])
    gammac = _ratio_cbrt_to_gamma(y + match_gamma_offset, invert=False,
                                  xp=xp)
    diff = (gammac * (y - base4)) ** 2
    diff = _masking_sqrt(xp.minimum(diff, 0.2), xp=xp)
    pre_erosion = _blocks_sum(diff, 4) * 0.25

    aq_map = _fuzzy_erosion(pre_erosion, distance, xp=xp)
    masking = 1.0 / (aq_map + 0.001)

    # per-block modulations (exponent space), then exponentiate
    val = _compute_mask(aq_map, xp=xp)
    val = _gamma_modulation(xyb[0], xyb[1], val, xp=xp)
    out_val = _hf_modulation(xyb[1], val, xp=xp)
    out_val = xp.minimum(out_val,
                         _blue_modulation(xyb[0], xyb[1], xyb[2], val,
                                          xp=xp))

    base_level = 0.48 * scale
    damp_start, damp_end = 2.0, 14.0
    dampen = 1.0
    if distance >= damp_start:
        dampen = max(0.0, 1.0 - (distance - damp_start) /
                     (damp_end - damp_start))
    mul = scale * dampen
    add = (1.0 - dampen) * base_level
    qf = xp.exp(out_val) * mul + add
    return qf.astype(xp.float32), masking.astype(xp.float32)


def initial_quant_dc(distance: float) -> float:
    """DC quant level (enc_adaptive_quantization.cc:1250-1263 shape),
    CALIBRATED against the system libjxl's effective DC quant
    (quant_dc_int * global_scale / 2^16, measured over d in [0.1, 4],
    round-4 notes): qdc = 1.12/d up to d=2 with a measured knee at
    d in (2, 4]. The reference-tree formula lands ~1.37x finer at d=2,
    which bloated smooth-gradient DC streams ~40% (sky +30% BD-rate)."""
    d = max(distance, 1e-4)
    if d <= 2.0:
        return min(1.12 / d, 50.0)
    # measured knee: qdc(3) = 0.3787, qdc(4) = 0.3215; log-log interp,
    # reference 0.83-power tail beyond the last measured point
    import math
    pts = ((2.0, 0.56), (3.0, 0.3787), (4.0, 0.3215))
    if d >= 4.0:
        return 0.3215 * (4.0 / d) ** K_DC_QUANT_POW
    for (d0, q0), (d1, q1) in zip(pts, pts[1:]):
        if d <= d1:
            t = (math.log(d) - math.log(d0)) / \
                (math.log(d1) - math.log(d0))
            return math.exp(math.log(q0) * (1 - t) + math.log(q1) * t)
    return 0.3215


def compute_scale_from_quant(quant_dc: float, quant_ac: float,
                             qf: np.ndarray):
    """ComputeGlobalScaleAndQuant with an explicit AC quant level (the
    encoder-heuristics path, enc_heuristics.cc:1116-1130) + quant field
    rasterization (quantizer.cc:78-88)."""
    return _scale_and_field(quant_dc, quant_ac, 0.0, qf)


def compute_global_scale_and_quant(quant_dc: float, qf: np.ndarray):
    """(quantizer.cc:45-116) -> (global_scale, quant_dc_int,
    raw_quant_field int array)."""
    data = np.sort(qf.ravel())
    quant_median = data[data.size // 2]
    deviations = np.sort(np.abs(data - quant_median))
    quant_median_absd = deviations[deviations.size // 2]
    return _scale_and_field(quant_dc, quant_median, quant_median_absd, qf)


def _scale_and_field(quant_dc, quant_median, quant_median_absd, qf):
    scale = (K_GLOBAL_SCALE_DENOM * (quant_median - quant_median_absd) / 5.0)
    scale = min(max(scale, 1.0), 1 << 15)
    global_scale = int(scale)
    scaled_quant_dc = int(quant_dc * K_GLOBAL_SCALE_NUMERATOR * 1.6)
    if global_scale > scaled_quant_dc:
        global_scale = max(scaled_quant_dc, 1)
    inv_global_scale = K_GLOBAL_SCALE_DENOM / global_scale
    quant_dc_int = int(min(1 << 16, quant_dc * inv_global_scale + 0.5))
    raw = np.clip((qf * inv_global_scale + 0.5).astype(np.int32), 1,
                  K_QUANT_MAX)
    return global_scale, quant_dc_int, raw
