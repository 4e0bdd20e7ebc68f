"""The effort >= 5 VarDCT encode heuristics on the device (port of
``libjxl_tpu/models/vardct_heuristics.py``, which the JAX package fuses
with XLA; it has no Pallas kernel).

Two device stages, plain torch, float32 with TF32 off:

1. ``front_device``: sRGB -> XYB (pre-Gaborish, padded to the block
   grid), the adaptive quantization field (InitialQuantField,
   enc_adaptive_quantization.cc) and the Gaborish-inverse sharpened
   encoder input. The host fetches the small (yb, xb) field, derives the
   integer global scale, and reads the sharpened image for the merge
   pass; the device copy stays for the grids and the transform.

2. ``acs_grids_device``: the AC-strategy cost grids: for every candidate
   transform class, a batched whole-frame DCT over all aligned
   positions, dead-zone quantization, rate estimate and weighted
   distortion, reduced to one cost per aligned position
   (enc_ac_strategy.cc:618's per-tile loop). The host runs only the
   merge decisions on the fetched grids.

The math is that of the JAX package's ``xp=jax.numpy`` branches of
``vardct/adaptive_quant.py`` (``adaptive_quant_field``),
``render/filters.py`` (``gaborish_inverse``) and ``vardct/enc_acs.py``
(``compute_mask1x1``, ``strategy_rate_loss``), written for torch: their
numpy copies in this package stay as they are for the host path. Every
division has two tensor operands (``rdiv``, ``tdiv``): torch computes a
Python number over a tensor as the tensor's reciprocal times the number,
and on the card a tensor over a Python number with the number's float32
reciprocal. Integer powers are repeated squarings, as JAX computes them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from libjxl_torch.config import resolve_device
from libjxl_torch.metrics.butteraugli import rdiv, tdiv
from libjxl_torch.models.filter_kernels import mirror_pad
from libjxl_torch.models.vardct_pipeline import (
    _adjust_quant_bias, srgb_to_xyb_device,
)
from libjxl_torch.vardct.ac_strategy import COVERED_X, COVERED_Y
from libjxl_torch.vardct.adaptive_quant import (
    K_AC_QUANT, _K_SG_MUL, _K_SG_RET_MUL, _K_SG_V_OFFSET,
)
from libjxl_torch.vardct.dct import dct_matrix
from libjxl_torch.vardct.enc_acs import (
    _CH_MUL, _MASK1X1_KER, _MASKU_OFF, _thresholds, acs_cost_params,
)

_f32 = torch.float32


def ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x ** n`` for a power of two ``n`` by repeated squaring (JAX's
    integer_pow order)."""
    while n > 1:
        x = x * x
        n //= 2
    return x


def _edge_pad(x: torch.Tensor, top: int, bottom: int, left: int,
              right: int) -> torch.Tensor:
    """Pad the last two axes by repeating the edge (numpy "edge")."""
    lead = x.shape[:-2]
    y = F.pad(x.reshape((1, -1) + x.shape[-2:]),
              (left, right, top, bottom), mode="replicate")
    return y.reshape(lead + y.shape[-2:])


# ---------------------------------------------------------------------------
# adaptive quantization field (vardct/adaptive_quant.py, xp=jnp)
# ---------------------------------------------------------------------------

def _ratio_cbrt_to_gamma(v, invert: bool):
    """RatioOfDerivativesOfCubicRootToSimpleGamma
    (enc_adaptive_quantization.cc:120-146)."""
    eps = 1e-2
    v = v.clamp_min(0.0)
    num_mul = float(_K_SG_RET_MUL * 3 * _K_SG_MUL)
    v_off = float(_K_SG_V_OFFSET * np.log(2.0) + eps)
    den_mul = float(np.log(2.0) * _K_SG_MUL)
    v2 = v * v
    num = num_mul * v2 + eps
    den = den_mul * v * v2 + v_off
    return num / den if invert else den / num


def _masking_sqrt(v):
    k_log_offset = 27.505837037000106
    k_mul = 211.66567973503678
    return 0.25 * torch.sqrt(v * float(np.sqrt(k_mul * 1e8)) + k_log_offset)


def _compute_mask(v):
    """(enc_adaptive_quantization.cc:95-118)."""
    v1 = (v * 0.80061762862741759).clamp_min(1e-3)
    v2 = rdiv(1.0, v1 + 302.59587815579727)
    v3 = rdiv(1.0, v1 * v1 + 3.7179635626140772)
    v4 = rdiv(1.0, v1 * v1 + 0.25 * 3.7179635626140772)
    return (-0.7647 + 9.4708735624378946 * v4 + 17.35036561631863 * v2 +
            6.7943250517376494 * v3)


def _blocks_sum(img, n):
    h, w = img.shape
    return img.reshape(h // n, n, w // n, n).sum(dim=(1, 3))


def _aq_fuzzy_erosion(pre, d: float):
    """(enc_adaptive_quantization.cc:389-478): weighted 4 smallest of each
    3x3 neighborhood, then 2x2-summed to per-block resolution."""
    k_mul_base = np.array([0.125, 0.1, 0.09, 0.06])
    k_mul_add = np.array([0.0, -0.1, -0.09, -0.06])
    mul = (2.0 - d) / 2.0 if d < 2.0 else 0.0
    k_mul = k_mul_base + mul * k_mul_add
    k_mul *= 0.29959705784054957 / k_mul.sum()
    h, w = pre.shape
    p = _edge_pad(pre, 1, 1, 1, 1)
    stack = torch.stack([p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    stack = torch.sort(stack, dim=0).values[:4]
    k = torch.tensor(k_mul[:, None, None], dtype=_f32, device=pre.device)
    return _blocks_sum((k * stack).sum(dim=0), 2)


def _gamma_modulation(xyb_x, xyb_y, base):
    """(enc_adaptive_quantization.cc:179-211)."""
    iny = xyb_y + 0.16
    r = _ratio_cbrt_to_gamma(iny - xyb_x, invert=True)
    g = _ratio_cbrt_to_gamma(iny + xyb_x, invert=True)
    overall = _blocks_sum(r + g, 8) * (0.5 / 64)
    return base + 0.1005613337192697 * torch.log2(overall)


def _hf_modulation(xyb_y, base):
    """(enc_adaptive_quantization.cc:260-313): sum of clamped 4-connected
    |diffs| of Y within each block."""
    valmin = 0.0206
    h, w = xyb_y.shape
    dev = xyb_y.device
    dx = (xyb_y[:, 1:] - xyb_y[:, :-1]).abs().clamp_max(valmin)
    dx = F.pad(dx, (0, 1))
    colmask = torch.ones(w, dtype=_f32, device=dev)
    colmask[7::8] = 0.0
    dx = dx * colmask[None, :]
    dy = (xyb_y[1:] - xyb_y[:-1]).abs().clamp_max(valmin)
    dy = F.pad(dy, (0, 0, 0, 1))
    rowmask = torch.ones(h, dtype=_f32, device=dev)
    rowmask[7::8] = 0.0
    dy = dy * rowmask[:, None]
    s = _blocks_sum(dx + dy, 8)
    return base + (-0.38) * s + 0.42


def _blue_modulation(xyb_x, xyb_y, xyb_b, base):
    """(enc_adaptive_quantization.cc:221-258)."""
    k_limit = 0.010474084867598155
    k_offset = 0.0031994768654636393
    p_y_eff = xyb_y + k_offset + xyb_x.abs()
    contrib = torch.where(xyb_b > p_y_eff,
                          (xyb_b - p_y_eff).clamp_max(k_limit), 0.0)
    s = _blocks_sum(contrib, 8)
    s = torch.where(s >= 32 * k_limit, 64 * k_limit - s, s)
    s = s.clamp_max(15.463398341612438 * k_limit)
    return base + 0.90590804735610064 * s


def adaptive_quant_field(xyb: torch.Tensor, distance: float,
                         rescale: float = 1.0) -> torch.Tensor:
    """xyb: (3, H, W) padded to 8x8 blocks. Returns the per-block float32
    quant field (InitialQuantField) on xyb's device."""
    scale = K_AC_QUANT / distance * rescale
    y = xyb[1]
    # gamma-scaled Laplacian activity, 4x4 box to quarter res
    match_gamma_offset = 0.019
    p = _edge_pad(y, 1, 1, 1, 1)
    base4 = 0.25 * (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] +
                    p[1:-1, 2:])
    gammac = _ratio_cbrt_to_gamma(y + match_gamma_offset, invert=False)
    diff = gammac * (y - base4)
    diff = _masking_sqrt((diff * diff).clamp_max(0.2))
    pre_erosion = _blocks_sum(diff, 4) * 0.25

    aq_map = _aq_fuzzy_erosion(pre_erosion, distance)

    # per-block modulations (exponent space), then exponentiate
    val = _compute_mask(aq_map)
    val = _gamma_modulation(xyb[0], xyb[1], val)
    out_val = _hf_modulation(xyb[1], val)
    out_val = torch.minimum(
        out_val, _blue_modulation(xyb[0], xyb[1], xyb[2], val))

    base_level = 0.48 * scale
    damp_start, damp_end = 2.0, 14.0
    dampen = 1.0
    if distance >= damp_start:
        dampen = max(0.0, 1.0 - (distance - damp_start) /
                     (damp_end - damp_start))
    mul = scale * dampen
    add = (1.0 - dampen) * base_level
    return torch.exp(out_val) * mul + add


def gaborish_inverse(xyb: torch.Tensor) -> torch.Tensor:
    """Approximate inverse-Gaborish sharpening applied by the encoder when
    the Gaborish loop filter is on (enc_gaborish.cc:21-75): Symmetric5
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
    p = mirror_pad(xyb, 2)

    def sh(dy, dx):
        return p[:, 2 + dy:2 + dy + h, 2 + dx:2 + dx + w]

    return (w_c * sh(0, 0) +
            w_r * (sh(0, -1) + sh(0, 1) + sh(-1, 0) + sh(1, 0)) +
            w_R * (sh(0, -2) + sh(0, 2) + sh(-2, 0) + sh(2, 0)) +
            w_d * (sh(-1, -1) + sh(-1, 1) + sh(1, -1) + sh(1, 1)) +
            w_D * (sh(-2, -2) + sh(-2, 2) + sh(2, -2) + sh(2, 2)) +
            w_L * (sh(-1, -2) + sh(-2, -1) + sh(-2, 1) + sh(-1, 2) +
                   sh(1, -2) + sh(2, -1) + sh(2, 1) + sh(1, 2)))


def front_device(pixels_u8, distance: float, use_gab: bool, h: int, w: int,
                 yb: int, xb: int, device=None):
    """(h, w, 3) uint8 sRGB (numpy) -> (qf (yb, xb), xyb_p (3, yb*8,
    xb*8), pre_gab (3, yb*8, xb*8)) float32 tensors on ``device``: the
    quant field, the Gaborish-inverse encoder input and the pre-Gaborish
    XYB, both padded to whole blocks by repeating the edge."""
    dev = resolve_device(device)
    px = torch.from_numpy(np.ascontiguousarray(pixels_u8)).to(dev)
    xyb = srgb_to_xyb_device(px.permute(2, 0, 1))
    pre_gab = _edge_pad(xyb, 0, yb * 8 - h, 0, xb * 8 - w)
    qf = adaptive_quant_field(pre_gab, distance if use_gab
                              else distance * 0.62)
    if use_gab:
        xyb = gaborish_inverse(xyb)
    xyb_p = _edge_pad(xyb, 0, yb * 8 - h, 0, xb * 8 - w)
    return qf, xyb_p, pre_gab


# ---------------------------------------------------------------------------
# AC-strategy cost grids (vardct/enc_acs.py, xp=jnp)
# ---------------------------------------------------------------------------

def compute_mask1x1(y: torch.Tensor) -> torch.Tensor:
    """Per-pixel ringing-visibility weight: 1/(log1p|gamma-matched 1x1
    Laplacian|+0.01), 5x5-blurred (enc_adaptive_quantization.cc
    ComputeTile scalar_pixel1x1 :501-521 + Blur1x1Masking)."""
    up = torch.cat([y[:1], y[:-1]], dim=0)
    dn = torch.cat([y[1:], y[-1:]], dim=0)
    lf = torch.cat([y[:, :1], y[:, :-1]], dim=1)
    rt = torch.cat([y[:, 1:], y[:, -1:]], dim=1)
    base = 0.25 * (up + dn + lf + rt)
    gammac = _ratio_cbrt_to_gamma(y + 0.019, False)
    diff = torch.log1p((gammac * (y - base)).abs())
    m = rdiv(1.0, diff + 0.01)
    pad = F.pad(m[None, None], (2, 2, 2, 2), mode="reflect")[0, 0]
    out = torch.zeros_like(m)
    for dy in range(5):
        for dx in range(5):
            out = out + float(_MASK1X1_KER[dy, dx]) * pad[
                dy:dy + m.shape[0], dx:dx + m.shape[1]]
    return out


def strategy_rate_loss(xyb, raw_quant, tables3, scale: float,
                       strategy: int, mask1x1, distance: float,
                       cmap_x: float = 0.0, cmap_b: float = 1.0):
    """(cost, loss) grids over all aligned anchor positions of one
    strategy, over all three channels with base-CfL subtraction
    (EstimateEntropy, enc_ac_strategy.cc:364-510); the torch form of
    ``vardct.enc_acs.strategy_rate_loss``, which documents the terms."""
    lam = 5.5 / (distance * distance)
    _, _, info_loss = acs_cost_params(distance)
    nby, nbx = COVERED_Y[strategy], COVERED_X[strategy]
    rows, cols = nby * 8, nbx * 8
    H, W = xyb.shape[1:]
    gy, gx = H // rows, W // cols
    dev = xyb.device
    if gy == 0 or gx == 0:
        return (torch.zeros((0, 0), dtype=_f32, device=dev),) * 2

    def windows(plane):
        return plane[:gy * rows, :gx * cols].reshape(
            gy, rows, gx, cols).permute(0, 2, 1, 3).reshape(
            gy * gx, rows, cols)

    mr = torch.tensor(dct_matrix(rows), dtype=_f32, device=dev)
    mc = torch.tensor(dct_matrix(cols), dtype=_f32, device=dev)
    qfw = raw_quant[:gy * nby, :gx * nbx].reshape(
        gy, nby, gx, nbx).permute(0, 2, 1, 3).reshape(
        gy * gx, -1).to(_f32)
    qf = qfw.max(dim=1).values
    covered = nby * nbx
    size = covered * 64
    if covered <= 2:
        qn = qf * scale
    else:
        qn = ipow(qfw * scale, 16).mean(dim=1).pow(1.0 / 16.0)
    mwin = windows(mask1x1)
    w_x = 1.0 + min(3.0, covered / 8.0) if covered >= 2 else 1.0
    pos = (torch.arange(size, device=dev) >= covered).to(_f32)

    def stored_of(plane):
        coef = (mr @ windows(plane)) @ mc.T
        return (coef.transpose(1, 2) if rows >= cols else
                coef).reshape(gy * gx, -1)

    st_y = stored_of(xyb[1])
    rate = None
    l8sum = None
    cost_extra = None
    for c, (st, cf) in enumerate((
            (stored_of(xyb[0]), cmap_x), (st_y, 0.0),
            (stored_of(xyb[2]), cmap_b))):
        if cf != 0.0:
            st = st - cf * st_y
        table = tables3[c]
        th = torch.tensor(_thresholds(nby, nbx, c == 1), dtype=_f32,
                          device=dev)
        val = st * rdiv(scale, table)[None, :] * qf[:, None]
        q = torch.where(val.abs() >= th[None, :], torch.round(val), 0.0)
        aq = q.abs() * pos[None, :]
        nzbits = torch.where(aq > 0, torch.log2(aq + 1) * 2.0 + 1.2, 0.02)
        rate_c = (nzbits * pos[None, :]).sum(dim=1)
        err = (_adjust_quant_bias(q, 1) * table[None, :] *
               rdiv(1.0, scale * qf)[:, None] - st) * pos[None, :]
        err_rc = (err.reshape(gy * gx, cols, rows).transpose(1, 2)
                  if rows >= cols else err.reshape(gy * gx, rows, cols))
        err_px = (mr.T @ err_rc) @ mc
        l8c = ipow(_CH_MUL[c] * (mwin + _MASKU_OFF[c]) * err_px, 8).sum(
            dim=(1, 2))
        if c == 0:
            # X-channel ringing punisher for big blocks (:497-503)
            l8c = w_x * l8c
        l8sum = l8c if l8sum is None else l8sum + l8c
        if c == 1:
            # only the Y rate + L2 feed the multiplied cost
            rate = rate_c
            cost_extra = lam * (err * err).sum(dim=1)
    cost = rate + 12.0 + cost_extra
    loss = info_loss * tdiv(l8sum, size).pow(0.125) * size / qn
    return cost.reshape(gy, gx), loss.reshape(gy, gx)


def acs_grids(xyb, raw_quant, tables: tuple, strategies: tuple,
              scale: float, distance: float) -> torch.Tensor:
    """Every strategy's (cost, loss) grids, flattened one after another
    into one tensor (one fetch)."""
    mask1x1 = compute_mask1x1(xyb[1])
    out = [strategy_rate_loss(xyb, raw_quant, tables[i], scale, int(s),
                              mask1x1, distance)
           for i, s in enumerate(strategies)]
    return torch.cat([g.reshape(-1) for pair in out for g in pair])


def acs_grids_device(xyb_dev: torch.Tensor, raw_quant: np.ndarray,
                     matrices, quantizer, distance: float,
                     strategies: tuple) -> dict:
    """The per-strategy (rate, loss) grids on ``xyb_dev``'s device;
    returns {strategy: (rate, loss) float64 numpy grids} for
    choose_acs's merge pass."""
    dev = xyb_dev.device
    tables = tuple(
        tuple(torch.tensor(matrices.table_for_strategy(s)[c].reshape(-1),
                           dtype=_f32, device=dev) for c in range(3))
        for s in strategies)
    flat = acs_grids(xyb_dev, torch.from_numpy(
        np.asarray(raw_quant, np.int32)).to(dev), tables,
        tuple(int(s) for s in strategies), float(quantizer.scale),
        float(distance)).cpu().numpy().astype(np.float64)
    yb8, xb8 = raw_quant.shape
    out = {}
    off = 0
    for s in strategies:
        gy = yb8 // COVERED_Y[s]
        gx = xb8 // COVERED_X[s]
        n = gy * gx
        rate = flat[off:off + n].reshape(gy, gx)
        loss = flat[off + n:off + 2 * n].reshape(gy, gx)
        off += 2 * n
        out[int(s)] = (rate, loss)
    return out
