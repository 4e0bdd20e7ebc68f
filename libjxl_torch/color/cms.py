"""Color management: transfer functions (PQ/HLG/709/DCI/gamma), RGB
primaries / white point math with chromatic adaptation, Rec.2408 tone
mapping, HLG OOTF and gamut mapping.

TPU-native re-design of the reference CMS (``lib/jxl/cms/jxl_cms.cc``,
``cms/transfer_functions.h``, ``cms/tone_mapping.h``): everything is a
vectorized array op over (3, H, W) planes (numpy here, identical code
path under jnp for on-device rendering) instead of lcms2/skcms per-pixel
callbacks. Signal values are unbounded and sign-mirrored
(f(-x) = -f(x)) exactly like the reference, so chromatic adaptation
out-of-range values round-trip.
"""

from __future__ import annotations

import numpy as np

from libjxl_torch.core.headers import (
    ColorSpace, Primaries, TransferFunction, WhitePoint,
)

# ---------------------------------------------------------------------------
# Transfer functions (cms/transfer_functions.h)
# ---------------------------------------------------------------------------

_PQ_M1 = 2610.0 / 16384
_PQ_M2 = (2523.0 / 4096) * 128
_PQ_C1 = 3424.0 / 4096
_PQ_C2 = (2413.0 / 4096) * 32
_PQ_C3 = (2392.0 / 4096) * 32

_HLG_A = 0.17883277
_HLG_B = 1 - 4 * _HLG_A
_HLG_C = 0.5599107295


def _mirror(fn):
    """Apply fn to |x| and restore sign (unbounded CMM convention)."""
    def wrapped(x, *a, **k):
        x = np.asarray(x)
        return np.sign(x) * fn(np.abs(x), *a, **k)
    return wrapped


@_mirror
def pq_display_from_encoded(e, intensity_target: float = 10000.0):
    """PQ EOTF (TF_PQ_Base::DisplayFromEncoded): signal -> display
    linear, normalized so 1.0 = ``intensity_target`` nits."""
    xp = np.power(e, 1.0 / _PQ_M2)
    num = np.maximum(xp - _PQ_C1, 0.0)
    den = _PQ_C2 - _PQ_C3 * xp
    d = np.power(num / den, 1.0 / _PQ_M1)
    return d * (10000.0 / intensity_target)


@_mirror
def pq_encoded_from_display(d, intensity_target: float = 10000.0):
    """PQ inverse EOTF (TF_PQ_Base::EncodedFromDisplay)."""
    xp = np.power(d * (intensity_target / 10000.0), _PQ_M1)
    return np.power((_PQ_C1 + xp * _PQ_C2) / (1.0 + xp * _PQ_C3), _PQ_M2)


@_mirror
def hlg_display_from_encoded(e):
    """HLG inverse OETF (TF_HLG_Base::InvOETF; OOTF is identity at the
    334-nit system gamma, see transfer_functions.h:66-76)."""
    lo = e * e * (1.0 / 3.0)
    hi = (np.exp((e - _HLG_C) / _HLG_A) + _HLG_B) * (1.0 / 12.0)
    return np.where(e <= 0.5, lo, hi)


@_mirror
def hlg_encoded_from_display(d):
    """HLG OETF (TF_HLG_Base::OETF)."""
    lo = np.sqrt(3.0 * np.maximum(d, 0.0))
    hi = _HLG_A * np.log(np.maximum(12.0 * d - _HLG_B, 1e-12)) + _HLG_C
    return np.where(d <= 1.0 / 12.0, lo, hi)


@_mirror
def tf709_encoded_from_display(d):
    """BT.709 OETF (TF_709, transfer_functions-inl.h)."""
    return np.where(d < 0.018, 4.5 * d,
                    1.099 * np.power(np.maximum(d, 1e-12), 0.45) - 0.099)


@_mirror
def tf709_display_from_encoded(e):
    return np.where(e < 4.5 * 0.018, e / 4.5,
                    np.power((e + 0.099) / 1.099, 1.0 / 0.45))


@_mirror
def srgb_encoded_from_display(d):
    return np.where(d <= 0.0031308, 12.92 * d,
                    1.055 * np.power(np.maximum(d, 1e-12), 1 / 2.4) - 0.055)


@_mirror
def srgb_display_from_encoded(e):
    return np.where(e <= 0.04045, e / 12.92,
                    np.power((e + 0.055) / 1.055, 2.4))


def apply_tf_encode(linear, ce, intensity_target: float = 255.0):
    """Display-linear -> signal for ColorEncoding ``ce``."""
    tf = ce.tf
    if tf.have_gamma:
        # encoded = linear^gamma (gamma stored x1e7; XYB's implicit 1/3).
        # Pure-gamma curves go through ICC tone curves in the reference
        # CMS, which clamp negatives (no sign mirroring).
        return np.power(np.maximum(linear, 0.0), tf.gamma / 1e7)
    t = tf.transfer_function
    if t == TransferFunction.LINEAR:
        return np.asarray(linear)
    if t == TransferFunction.SRGB:
        return srgb_encoded_from_display(linear)
    if t == TransferFunction.BT709:
        return tf709_encoded_from_display(linear)
    if t == TransferFunction.DCI:
        return np.power(np.maximum(linear, 0.0), 1 / 2.6)
    if t == TransferFunction.PQ:
        return pq_encoded_from_display(linear, intensity_target)
    if t == TransferFunction.HLG:
        return hlg_encoded_from_display(linear)
    raise ValueError(f"unsupported transfer function {t}")


def apply_tf_decode(signal, ce, intensity_target: float = 255.0):
    """Signal -> display-linear for ColorEncoding ``ce``."""
    tf = ce.tf
    if tf.have_gamma:
        return np.power(np.maximum(signal, 0.0), 1e7 / tf.gamma)
    t = tf.transfer_function
    if t == TransferFunction.LINEAR:
        return np.asarray(signal)
    if t == TransferFunction.SRGB:
        return srgb_display_from_encoded(signal)
    if t == TransferFunction.BT709:
        return tf709_display_from_encoded(signal)
    if t == TransferFunction.DCI:
        return np.power(np.maximum(signal, 0.0), 2.6)
    if t == TransferFunction.PQ:
        return pq_display_from_encoded(signal, intensity_target)
    if t == TransferFunction.HLG:
        return hlg_display_from_encoded(signal)
    raise ValueError(f"unsupported transfer function {t}")


# ---------------------------------------------------------------------------
# Primaries / white points / matrices (cms/jxl_cms.cc CIEXYZFromWhiteCIExy,
# PrimariesToXYZ; color_encoding_internal.cc enum tables)
# ---------------------------------------------------------------------------

_WHITE_XY = {
    WhitePoint.D65: (0.3127, 0.3290),
    WhitePoint.E: (1.0 / 3, 1.0 / 3),
    WhitePoint.DCI: (0.314, 0.351),
}

_PRIMARIES_XY = {
    Primaries.SRGB: ((0.639998686, 0.330010138), (0.300003784, 0.600003357),
                     (0.150002046, 0.059997204)),
    Primaries.BT2100: ((0.708, 0.292), (0.170, 0.797), (0.131, 0.046)),
    Primaries.P3: ((0.680, 0.320), (0.265, 0.690), (0.150, 0.060)),
}


def white_xy(ce) -> tuple:
    if ce.white_point in _WHITE_XY:
        return _WHITE_XY[ce.white_point]
    return (ce.white.x / 1e6, ce.white.y / 1e6)


def primaries_xy(ce) -> tuple:
    if ce.primaries in _PRIMARIES_XY:
        return _PRIMARIES_XY[ce.primaries]
    return ((ce.red.x / 1e6, ce.red.y / 1e6),
            (ce.green.x / 1e6, ce.green.y / 1e6),
            (ce.blue.x / 1e6, ce.blue.y / 1e6))


def _xy_to_xyz(x: float, y: float) -> np.ndarray:
    return np.array([x / y, 1.0, (1.0 - x - y) / y])


# Bradford chromatic adaptation (jxl_cms.cc AdaptToXYZD50 analog, but we
# adapt between arbitrary white points since XYB's reference is D65)
_BRADFORD = np.array([
    [0.8951, 0.2664, -0.1614],
    [-0.7502, 1.7135, 0.0367],
    [0.0389, -0.0685, 1.0296]])


def adapt_matrix(src_white_xy, dst_white_xy) -> np.ndarray:
    ws = _BRADFORD @ _xy_to_xyz(*src_white_xy)
    wd = _BRADFORD @ _xy_to_xyz(*dst_white_xy)
    return np.linalg.inv(_BRADFORD) @ np.diag(wd / ws) @ _BRADFORD


def rgb_to_xyz_matrix(ce) -> np.ndarray:
    """RGB(ce primaries, ce white) -> XYZ (ce white)."""
    r, g, b = primaries_xy(ce)
    m = np.stack([_xy_to_xyz(*r), _xy_to_xyz(*g), _xy_to_xyz(*b)], axis=1)
    w = _xy_to_xyz(*white_xy(ce))
    s = np.linalg.solve(m, w)
    return m * s[None, :]


def primaries_luminances(ce) -> np.ndarray:
    """Y contribution of each primary (tone mapping needs these)."""
    return rgb_to_xyz_matrix(ce)[1]


def rgb_conversion_matrix(src_ce, dst_ce) -> np.ndarray:
    """linear RGB in src space -> linear RGB in dst space (with
    Bradford adaptation between the white points)."""
    m_src = rgb_to_xyz_matrix(src_ce)
    m_dst = rgb_to_xyz_matrix(dst_ce)
    adapt = adapt_matrix(white_xy(src_ce), white_xy(dst_ce))
    return np.linalg.inv(m_dst) @ adapt @ m_src


def _apply_matrix(m: np.ndarray, planes: np.ndarray) -> np.ndarray:
    return np.einsum("ij,jhw->ihw", m.astype(np.float32),
                     planes.astype(np.float32))


# ---------------------------------------------------------------------------
# Tone mapping (cms/tone_mapping.h) — vectorized
# ---------------------------------------------------------------------------

def rec2408_tone_map(rgb: np.ndarray, luminances, source_range=(0.0, 255.0),
                     target_range=(0.0, 255.0)) -> np.ndarray:
    """Rec.2408 EETF (Rec2408ToneMapperBase::ToneMap), vectorized over a
    (3, H, W) linear image; ranges in nits."""
    lr, lg, lb = luminances
    inv_eotf = lambda lum: pq_encoded_from_display(  # noqa: E731
        lum, intensity_target=10000.0)
    pq_min = float(inv_eotf(source_range[0]))
    pq_max = float(inv_eotf(source_range[1]))
    pq_range = pq_max - pq_min
    min_lum = (float(inv_eotf(target_range[0])) - pq_min) / pq_range
    max_lum = (float(inv_eotf(target_range[1])) - pq_min) / pq_range
    ks = 1.5 * max_lum - 0.5
    inv_one_minus_ks = 1.0 / max(1e-6, 1.0 - ks)

    lum = source_range[1] * (lr * rgb[0] + lg * rgb[1] + lb * rgb[2])
    npq = np.minimum(1.0, (inv_eotf(lum) - pq_min) / pq_range)
    t_b = (npq - ks) * inv_one_minus_ks
    t_b2 = t_b * t_b
    t_b3 = t_b2 * t_b
    p = ((2 * t_b3 - 3 * t_b2 + 1) * ks +
         (t_b3 - 2 * t_b2 + t_b) * (1 - ks) +
         (-2 * t_b3 + 3 * t_b2) * max_lum)
    e2 = np.where(npq < ks, npq, p)
    one_minus_e2 = 1 - e2
    e3 = min_lum * one_minus_e2 ** 4 + e2
    e4 = e3 * pq_range + pq_min
    d4 = pq_display_from_encoded(e4, intensity_target=10000.0)
    new_lum = np.clip(d4, 0.0, target_range[1])
    min_luminance = 1e-6
    use_cap = lum <= min_luminance
    ratio = new_lum / np.maximum(lum, min_luminance)
    normalizer = source_range[1] / target_range[1]
    cap = new_lum / target_range[1]
    mult = ratio * normalizer
    return np.where(use_cap[None], cap[None].astype(rgb.dtype),
                    rgb * mult[None]).astype(rgb.dtype)


def hlg_ootf(rgb: np.ndarray, luminances, source_luminance: float,
             target_luminance: float) -> np.ndarray:
    """HlgOOTF_Base::Apply, vectorized."""
    gamma = np.power(1.111, np.log2(target_luminance / source_luminance))
    exponent = gamma - 1
    if -0.01 < exponent < 0.01:
        return rgb
    lr, lg, lb = luminances
    lum = np.maximum(lr * rgb[0] + lg * rgb[1] + lb * rgb[2], 1e-12)
    ratio = np.minimum(np.power(lum, exponent), 1e9)
    return (rgb * ratio[None]).astype(rgb.dtype)


def apply_hlg_ootf(rgb: np.ndarray, luminances, intensity_target: float,
                   forward: bool) -> np.ndarray:
    """ApplyHlgOotf (jxl_cms.cc:886-938): display-light scaling between
    HLG scene light and the target display luminance. Skipped near the
    300-nit reference display where gamma ~= 1."""
    if 295 <= intensity_target <= 305:
        return rgb
    gamma = 1.2 * np.power(1.111, np.log2(intensity_target * 1e-3))
    if not forward:
        gamma = 1.0 / gamma
    lr, lg, lb = luminances
    lum = lr * rgb[0] + lg * rgb[1] + lb * rgb[2]
    ratio = np.power(np.maximum(lum, 0.0), gamma - 1)
    ratio = np.where(np.isfinite(ratio), ratio, 1.0)
    out = rgb * ratio[None]
    if forward and gamma < 1:
        # renormalize highlights pushed out of gamut (hue-preserving)
        maximum = np.max(out, axis=0)
        norm = np.where(maximum > 1.0, 1.0 / maximum, 1.0)
        out = out * norm[None]
    return out.astype(rgb.dtype)


def gamut_map(rgb: np.ndarray, luminances,
              preserve_saturation: float = 0.1) -> np.ndarray:
    """GamutMapScalar vectorized: desaturate out-of-gamut pixels toward
    gray of the same luminance, mixing saturation/luminance preservation."""
    lr, lg, lb = luminances
    lum = (lr * rgb[0] + lg * rgb[1] + lb * rgb[2])[None]
    vmg = rgb - lum
    inv_vmg = 1.0 / np.where(vmg == 0.0, 1.0, vmg)
    vov = rgb * inv_vmg
    gray_sat = np.max(np.where(vmg < 0.0, vov, 0.0), axis=0)
    # NOTE: the reference consults the RUNNING saturation max inside its
    # channel loop (tone_mapping.h:159-163); we use the final max — the
    # only divergence is on pixels that are simultaneously out of gamut
    # on both sides, where this desaturates marginally more.
    gray_lum = np.max(np.where(vmg <= 0.0, gray_sat[None],
                               vov - inv_vmg), axis=0)
    gray_mix = np.clip(preserve_saturation * (gray_sat - gray_lum) +
                       gray_lum, 0.0, 1.0)
    out = rgb + gray_mix[None] * (lum - rgb)
    max_clr = np.maximum(1.0, np.max(out, axis=0))[None]
    return (out / max_clr).astype(rgb.dtype)


# ---------------------------------------------------------------------------
# High-level conversions against the XYB reference space (linear sRGB D65)
# ---------------------------------------------------------------------------

def _srgb_encoding():
    from libjxl_torch.core.headers import ColorEncoding
    return ColorEncoding.srgb()


def linear_srgb_to_encoding(linear: np.ndarray, ce,
                            intensity_target: float = 255.0) -> np.ndarray:
    """Linear sRGB(D65) planes -> signal in ColorEncoding ``ce``
    (decode-side CMS: the XYB->target write stage, stage_xyb.cc +
    stage_cms.cc)."""
    if ce.color_space == ColorSpace.GRAY:
        lum = primaries_luminances(_srgb_encoding())
        y = (lum[0] * linear[0] + lum[1] * linear[1] +
             lum[2] * linear[2])[None]
        return apply_tf_encode(y, ce, intensity_target)
    m = rgb_conversion_matrix(_srgb_encoding(), ce)
    rgb = _apply_matrix(m, linear)
    # NOTE: no gamut mapping here — the reference CMS emits out-of-range
    # values as-is on a straight decode (unbounded CMM); GamutMapScalar
    # only runs inside tone-mapping flows (stage_tone_mapping.cc).
    is_hlg = (not ce.tf.have_gamma and
              ce.tf.transfer_function == TransferFunction.HLG)
    if is_hlg:
        # linear display light -> HLG scene light (inverse OOTF,
        # jxl_cms.cc:198-206 forward=false)
        rgb = apply_hlg_ootf(rgb, primaries_luminances(ce),
                             intensity_target, forward=False)
    return apply_tf_encode(rgb, ce, intensity_target)


def encoding_to_linear_srgb(signal: np.ndarray, ce,
                            intensity_target: float = 255.0) -> np.ndarray:
    """Signal in ColorEncoding ``ce`` -> linear sRGB(D65) planes
    (encode-side CMS input normalization). ICC-described encodings go
    through the matrix/TRC profile CMS (color/icc_profile.py)."""
    if getattr(ce, "want_icc", False) and getattr(ce, "icc", None):
        from libjxl_torch.color.icc_profile import icc_to_linear_srgb
        return icc_to_linear_srgb(np.asarray(signal, np.float64), ce.icc)
    linear = apply_tf_decode(signal, ce, intensity_target)
    if ce.color_space == ColorSpace.GRAY:
        return np.broadcast_to(linear, (3,) + linear.shape[-2:]).copy()
    if not ce.tf.have_gamma and \
            ce.tf.transfer_function == TransferFunction.HLG:
        # HLG scene light -> display light (OOTF, jxl_cms.cc:134-143)
        linear = apply_hlg_ootf(linear, primaries_luminances(ce),
                                intensity_target, forward=True)
    m = rgb_conversion_matrix(ce, _srgb_encoding())
    return _apply_matrix(m, linear)
