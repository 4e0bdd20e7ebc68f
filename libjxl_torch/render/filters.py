"""Restoration filters: Gaborish + EPF as whole-image vectorized ops
(reference ``lib/jxl/render_pipeline/stage_gaborish.cc``,
``stage_epf.cc``, ``lib/jxl/epf.cc``).

Every function takes an ``xp`` module parameter (numpy, in float64):
the bodies are functional (no in-place mutation). These are the host
filters; the float32 device filters are ``render/filters_torch.py``
over the CUDA kernels of ``models/filter_kernels.py``. The group-border
halo is handled by mirror padding over the whole frame here."""

from __future__ import annotations

import numpy as np

K_INV_SIGMA_NUM = -1.1715728752538099024
K_MIN_SIGMA = -3.90524291751269967465540850526868


def _mirror_pad(img, n: int, xp=np):
    """JXL edge rule = mirror with edge duplication ('symmetric')."""
    return xp.pad(img, [(0, 0)] * (img.ndim - 2) + [(n, n), (n, n)],
                  mode="symmetric")


def _shift(img, dx: int, dy: int, pad: int):
    """View of mirror-padded image shifted by (dx, dy)."""
    h, w = img.shape[-2] - 2 * pad, img.shape[-1] - 2 * pad
    return img[..., pad + dy:pad + dy + h, pad + dx:pad + dx + w]


def _f(xp):
    """Working float dtype: f64 on host numpy, f32 on device."""
    return np.float64 if xp is np else xp.float32


def gaborish(xyb, lf, xp=np):
    """3x3 smoothing (stage_gaborish.cc:31-54). xyb: (3, H, W)."""
    ft = _f(xp)
    w1 = xp.asarray([lf.gab_x_weight1, lf.gab_y_weight1, lf.gab_b_weight1],
                    dtype=ft)
    w2 = xp.asarray([lf.gab_x_weight2, lf.gab_y_weight2, lf.gab_b_weight2],
                    dtype=ft)
    div = 1.0 + 4.0 * (w1 + w2)
    w0 = (1.0 / div)[:, None, None]
    w1 = (w1 / div)[:, None, None]
    w2 = (w2 / div)[:, None, None]
    p = _mirror_pad(xyb.astype(ft), 1, xp)
    sh = lambda dy, dx: _shift(p, dx, dy, 1)  # noqa: E731
    out = (w0 * sh(0, 0) +
           w1 * (sh(-1, 0) + sh(1, 0) + sh(0, -1) + sh(0, 1)) +
           w2 * (sh(-1, -1) + sh(-1, 1) + sh(1, -1) + sh(1, 1)))
    return out.astype(xyb.dtype)


def compute_sigma(lf, acs_raw, anchors, raw_quant, epf_sharpness,
                  quant_scale: float, xp=np):
    """Per-8x8-block 1/sigma (epf.cc:39-110). All inputs in block units.

    acs anchors propagate their quant value over covered blocks; callers
    pass raw_quant already propagated."""
    ft = _f(xp)
    sigma_quant = lf.epf_quant_mul / (quant_scale *
                                      raw_quant.astype(ft) *
                                      K_INV_SIGMA_NUM)
    lut = xp.asarray(lf.epf_sharp_lut, dtype=ft)
    sigma = sigma_quant * lut[epf_sharpness]
    sigma = xp.minimum(sigma, -1e-4)
    return 1.0 / sigma


_PLUS = ((0, -1), (-1, 0), (0, 0), (1, 0), (0, 1))  # (dx, dy)
_NEIGHBORS1 = ((0, -1), (-1, 0), (1, 0), (0, 1))
_NEIGHBORS0 = ((0, -2), (-1, -1), (0, -1), (1, -1), (-2, 0), (-1, 0),
               (1, 0), (2, 0), (-1, 1), (0, 1), (1, 1), (0, 2))


def _sad_mul(h: int, w: int, sm: float, bsm: float, xp=np):
    """Per-pixel SAD multiplier: block-border rows/cols get ``bsm``."""
    ix = xp.arange(w) % 8
    iy = xp.arange(h) % 8
    xb = (ix == 0) | (ix == 7)
    yb = (iy == 0) | (iy == 7)
    xmul = xp.where(xb, bsm, sm)
    return xp.where(yb[:, None], bsm, xmul[None, :])


def _upsample8(block, h, w, xp=np):
    return xp.repeat(xp.repeat(block, 8, 0), 8, 1)[:h, :w]


def _epf_pass(xyb, inv_sigma_block, lf, neighbors, sigma_scale: float,
              plus_sad: bool, xp=np):
    """Shared EPF machinery (stage_epf.cc EPF0/1/2)."""
    ft = _f(xp)
    _, h, w = xyb.shape
    pad = 4 if plus_sad else 2
    x64 = xyb.astype(ft)
    p = _mirror_pad(x64, pad, xp)
    scales = xp.asarray(lf.epf_channel_scale, dtype=ft)[:, None, None]

    sm = sigma_scale * 1.65
    bsm = sm * lf.epf_border_sad_mul
    sad_mul = _sad_mul(h, w, sm, bsm, xp)
    inv_sigma = _upsample8(inv_sigma_block.astype(ft), h, w, xp)
    skip = inv_sigma < K_MIN_SIGMA
    isig = inv_sigma * sad_mul

    wsum = xp.ones((h, w), dtype=ft)
    acc = x64
    for dx, dy in neighbors:
        if plus_sad:
            # |x(p+n+o) - x(p+o)| == AD(n) evaluated at p+o, so the
            # plus-SAD is a 5-tap box over ONE per-neighbor abs-diff
            # plane (3 abs-diffs instead of 15)
            y0, x0 = pad - 2, pad - 2
            a = p[:, y0 + dy:y0 + dy + h + 4, x0 + dx:x0 + dx + w + 4]
            b = p[:, y0:y0 + h + 4, x0:x0 + w + 4]
            ad = (scales * xp.abs(a - b)).sum(axis=0)
            sad = xp.zeros((h, w), dtype=ft)
            for ox, oy in _PLUS:
                sad = sad + ad[2 + oy:2 + oy + h, 2 + ox:2 + ox + w]
        else:
            sad = (scales * xp.abs(_shift(p, dx, dy, pad) - x64)).sum(axis=0)
        weight = xp.maximum(1.0 + sad * isig, 0.0)
        wsum = wsum + weight
        acc = acc + weight[None] * _shift(p, dx, dy, pad)
    out = acc / wsum
    return xp.where(skip[None, :, :], xyb, out.astype(xyb.dtype))


def epf_step1(xyb, inv_sigma_block, lf, xp=np):
    """EPF pass 1 (3x3-plus kernel, 5x5 support; stage_epf.cc:197-380)."""
    return _epf_pass(xyb, inv_sigma_block, lf, _NEIGHBORS1, 1.0, True, xp)


def epf_step2(xyb, inv_sigma_block, lf, xp=np):
    """EPF pass 2 (3x3 kernel with single-pixel SADs; stage_epf.cc EPF2)."""
    return _epf_pass(xyb, inv_sigma_block, lf, _NEIGHBORS1,
                     lf.epf_pass2_sigma_scale, False, xp)


def epf_step0(xyb, inv_sigma_block, lf, xp=np):
    """EPF pass 0 (5x5 diamond kernel with plus-shaped SADs;
    stage_epf.cc EPF0Stage). Runs before passes 1 and 2 when
    epf_iters == 3."""
    return _epf_pass(xyb, inv_sigma_block, lf, _NEIGHBORS0,
                     lf.epf_pass0_sigma_scale, True, xp)


def gaborish_inverse(xyb, xp=np):
    """Approximate inverse-gaborish sharpening applied by the encoder when
    the gaborish loop filter is on (enc_gaborish.cc:21-75): Symmetric5
    with the butteraugli-tuned kGaborish weights, normalized."""
    kg = (-0.09495815671340026, -0.041031725066768575,
          0.013710004822696948, 0.006510206083837737,
          -0.0014789063378272242)
    s = 1.0 + 4 * (kg[0] + kg[1] + kg[2] + kg[4] + 2 * kg[3])
    n = 1.0 / s
    # quadrant layout c r R / r d L / R L D (convolve.h WeightsSymmetric5)
    w_c, w_r, w_R = n, n * kg[0], n * kg[2]
    w_d, w_D, w_L = n * kg[1], n * kg[4], n * kg[3]
    h, w = xyb.shape[1:]
    p = _mirror_pad(xyb, 2, xp)

    def sh(dy, dx):
        return p[:, 2 + dy:2 + dy + h, 2 + dx:2 + dx + w]

    return (w_c * sh(0, 0) +
            w_r * (sh(0, -1) + sh(0, 1) + sh(-1, 0) + sh(1, 0)) +
            w_R * (sh(0, -2) + sh(0, 2) + sh(-2, 0) + sh(2, 0)) +
            w_d * (sh(-1, -1) + sh(-1, 1) + sh(1, -1) + sh(1, 1)) +
            w_D * (sh(-2, -2) + sh(-2, 2) + sh(2, -2) + sh(2, 2)) +
            w_L * (sh(-1, -2) + sh(-2, -1) + sh(-2, 1) + sh(-1, 2) +
                   sh(1, -2) + sh(2, -1) + sh(2, 1) + sh(1, 2)))
