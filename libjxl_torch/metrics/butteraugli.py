"""Butteraugli perceptual distance in PyTorch (port of
``libjxl_tpu/metrics/butteraugli.py``, which the JAX package fuses with
XLA; it has no Pallas kernel).

The reference psychovisual model (``lib/jxl/butteraugli/butteraugli.cc``)
as whole-image tensor ops on ``device``, float32 with TF32 off:

  * OpsinDynamicsImage (1468-1540): linear sRGB -> psycho XYB with local
    gamma sensitivity from a sigma-1.2 blur.
  * SeparateFrequencies (404-545): LF/MF/HF/UHF band split via gaussian
    blurs (sigma 7.16 / 3.22 / 1.56) with range shaping and X-by-Y
    suppression.
  * MaltaDiffMap[LF] (988-1105): 16 oriented line filters on the scaled
    HF/UHF differences, squared and accumulated.
  * Mask / FuzzyErosion (1215-1290): activity masking from HF+UHF.
  * CombineChannelsToDiffmap (1291-1315) + one 2x-subsampled level mixed
    in with AddSupersampled2x (1768-1786, weight 0.5).

The separable blurs are ``F.conv2d`` row and column passes, each divided
by the in-bounds kernel mass. A Python number divided by a tensor is
computed by torch as the tensor's reciprocal times the number, and on the
card a tensor divided by a Python number as a product with the number's
float32 reciprocal: every division here has two tensor operands
(``rdiv``, ``tdiv``), so it is the true float32 quotient that the JAX
package computes.

Distance scores: ``butteraugli_distance`` = max over the diffmap
(ButteraugliScoreFromDiffmap); ``compute_distance_p`` follows
``lib/extras/metrics.cc:42-145``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from libjxl_torch.config import resolve_device
from libjxl_torch.metrics._malta_kernels import MALTA_FULL, MALTA_LF

_f32 = torch.float32

# ---------------------------------------------------------------------------
# constants (butteraugli.cc:40-90)
# ---------------------------------------------------------------------------

W_UHF_MALTA = 1.10039032555
NORM1_UHF = 71.7800275169
W_UHF_MALTA_X = 173.5
NORM1_UHF_X = 5.0
W_HF_MALTA = 18.7237414387
NORM1_HF = 4498534.45232
W_HF_MALTA_X = 6923.99476109
NORM1_HF_X = 8051.15833247
W_MF_MALTA = 37.0819870399
NORM1_MF = 130262059.556
W_MF_MALTA_X = 8246.75321353
NORM1_MF_X = 1009002.70582
WMUL = (400.0, 1.50815703118, 0.0,
        2150.0, 10.6195433239, 16.2176043152,
        29.2353797994, 0.844626970982, 0.703646627719)

_INTENSITY_NORM_HACK = 0.79079917404    # ln(80)/ln(255)
_GLOBAL_SCALE = 1.0 / (17.83 * _INTENSITY_NORM_HACK)

_SIGMA_LF = 7.15593339443
_SIGMA_HF = 3.22489901262
_SIGMA_UHF = 1.56416327805


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a float32 0-d tensor on ``like``'s device."""
    return torch.tensor(v, dtype=_f32, device=like.device)


def rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """``num / t`` as a true float32 division."""
    return _c(num, t) / t


def tdiv(t: torch.Tensor, den: float) -> torch.Tensor:
    """``t / den`` as a true float32 division, on the card too."""
    return t / _c(den, t)


def _gauss_kernel(sigma: float) -> np.ndarray:
    """(butteraugli.cc ComputeKernel:78-88)."""
    m = 2.25
    scaler = -1.0 / (2.0 * sigma * sigma)
    diff = max(1, int(m * abs(sigma)))
    i = np.arange(-diff, diff + 1)
    return np.exp(scaler * i * i).astype(np.float64)


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable FIR gaussian with border renormalization: each axis is
    convolved zero-padded and divided by the in-bounds kernel mass (the
    reference's ConvolveBorderColumn semantics), rows first."""
    kernel = _gauss_kernel(sigma)
    n = len(kernel)
    k = torch.tensor(kernel, dtype=_f32, device=img.device)
    shape = img.shape
    h, w = shape[-2:]
    x = img.reshape(-1, 1, h, w)
    kx, ky = k.view(1, 1, 1, n), k.view(1, 1, n, 1)
    ones = torch.ones((1, 1, h, w), dtype=_f32, device=img.device)
    x = F.conv2d(x, kx, padding=(0, n // 2)) / \
        F.conv2d(ones[:, :, :1], kx, padding=(0, n // 2))
    x = F.conv2d(x, ky, padding=(n // 2, 0)) / \
        F.conv2d(ones[:, :, :, :1], ky, padding=(n // 2, 0))
    return x.reshape(shape)


# ---------------------------------------------------------------------------
# opsin dynamics (butteraugli.cc:1391-1540)
# ---------------------------------------------------------------------------

def _gamma(v: torch.Tensor) -> torch.Tensor:
    v = v.clamp_min(0.0)
    return 19.245013259874995 * torch.log(v + 9.9710635769299145) - \
        23.16046239805755


_MIX = np.array([
    [0.29956550340058319, 0.63373087833825936, 0.077705617820981968],
    [0.22158691104574774, 0.69391388044116142, 0.0987313588422],
    [0.02, 0.02, 0.20480129041026129],
])
_MIX_BIAS = np.array([1.7557483643287353, 1.7557483643287353,
                      12.226454707163354])


def _opsin_absorbance(r, g, b, clamp: bool):
    out = []
    for c in range(3):
        v = (float(_MIX[c, 0]) * r + float(_MIX[c, 1]) * g +
             float(_MIX[c, 2]) * b + float(_MIX_BIAS[c]))
        if clamp:
            v = v.clamp_min(float(_MIX_BIAS[c]))
        out.append(v)
    return out


def opsin_dynamics_image(rgb: torch.Tensor,
                         intensity_target: float) -> torch.Tensor:
    """(3, H, W) linear sRGB -> psycho XYB (butteraugli.cc:1468-1540)."""
    it = intensity_target
    blurred = _blur(rgb, 1.2)
    pre = _opsin_absorbance(blurred[0] * it, blurred[1] * it,
                            blurred[2] * it, clamp=True)
    sens = [(_gamma(p.clamp_min(1e-4)) / p.clamp_min(1e-4)).clamp_min(1e-4)
            for p in pre]
    cur = _opsin_absorbance(rgb[0] * it, rgb[1] * it, rgb[2] * it,
                            clamp=False)
    m0 = (cur[0] * sens[0]).clamp_min(1.7557483643287353)
    m1 = (cur[1] * sens[1]).clamp_min(1.7557483643287353)
    m2 = (cur[2] * sens[2]).clamp_min(12.226454707163354)
    return torch.stack([m0 - m1, m0 + m1, m2])


# ---------------------------------------------------------------------------
# frequency separation (butteraugli.cc:296-545)
# ---------------------------------------------------------------------------

def _remove_range_around_zero(w, x):
    return torch.where(x > w, x - w, torch.where(x < -w, x + w, 0.0))


def _amplify_range_around_zero(w, x):
    return torch.where(x > w, x + w, torch.where(x < -w, x - w, 2.0 * x))


def _maximum_clamp(v, maxval):
    mul = 0.724216145665
    if_pos = (v - maxval) * mul + maxval
    if_neg = (v + maxval) * mul - maxval
    return torch.where(v >= maxval, if_pos,
                       torch.where(v < -maxval, if_neg, v))


def _xyb_lf_to_vals(lf: torch.Tensor) -> torch.Tensor:
    xmul, ymul, bmul = 33.832837186260, 14.458268100570, 49.87984651440
    y_to_b = -0.362267051518
    b = y_to_b * lf[1] + lf[2]
    return torch.stack([lf[0] * xmul, lf[1] * ymul, b * bmul])


def _suppress_x_by_y(y_hf, x_hf):
    suppress, s = 46.0, 0.653020556257
    scaler = rdiv(suppress, y_hf * y_hf + suppress) * (1.0 - s) + s
    return scaler * x_hf


def separate_frequencies(xyb: torch.Tensor):
    """-> dict with lf (3,), mf (3,), hf (2,), uhf (2,) band images."""
    lf = _blur(xyb, _SIGMA_LF)
    mf = xyb - lf
    vals_lf = _xyb_lf_to_vals(lf)

    # MF vs HF (butteraugli.cc:418-475)
    hf = [None, None]
    mf_out = [None, None, None]
    for i in range(3):
        blurred = _blur(mf[i], _SIGMA_HF)
        if i == 2:
            mf_out[2] = blurred
            break
        hfv = mf[i] - blurred
        if i == 0:
            mf_out[0] = _remove_range_around_zero(0.29, blurred)
        else:
            mf_out[1] = _amplify_range_around_zero(0.1, blurred)
        hf[i] = hfv
    hf[0] = _suppress_x_by_y(hf[1], hf[0])

    # HF vs UHF (butteraugli.cc:476-545)
    uhf = [None, None]
    for i in range(2):
        blurred = _blur(hf[i], _SIGMA_UHF)
        uhfv = hf[i] - blurred
        if i == 0:
            hf[0] = _remove_range_around_zero(1.5, blurred)
            uhf[0] = _remove_range_around_zero(0.04, uhfv)
        else:
            hfv = _maximum_clamp(blurred, 28.4691806922)
            uhfv = hf[1] - hfv
            uhfv = _maximum_clamp(uhfv, 5.19175294647)
            uhf[1] = uhfv * 2.69313763794
            hf[1] = _amplify_range_around_zero(0.132, hfv * 2.155)
    return {"lf": vals_lf, "mf": torch.stack(mf_out), "hf": hf, "uhf": uhf}


# ---------------------------------------------------------------------------
# Malta filters (butteraugli.cc:600-1105)
# ---------------------------------------------------------------------------

def _malta_accumulate(diffs: torch.Tensor, kernels) -> torch.Tensor:
    """Sum over 16 oriented line kernels of (line sum)^2; zero padding at
    borders (PaddedMaltaUnit semantics), taps added in the reference's
    order."""
    h, w = diffs.shape
    p = F.pad(diffs, (4, 4, 4, 4))
    out = torch.zeros_like(diffs)
    for ker in kernels:
        acc = torch.zeros_like(diffs)
        for dy, dx in ker:
            acc = acc + p[4 + dy:4 + dy + h, 4 + dx:4 + dx + w]
        out = out + acc * acc
    return out


def _malta_diff(lum0, lum1, w_0gt1, w_0lt1, norm1, full: bool):
    """(MaltaDiffMapT:988-1087) -> additive contribution to diff_ac."""
    len_ = 3.75
    mulli = 0.39905817637 if full else 0.611612573796
    w_pre0gt1 = mulli * np.sqrt(0.5 * w_0gt1) / (len_ * 2 + 1)
    w_pre0lt1 = mulli * np.sqrt(0.33 * w_0lt1) / (len_ * 2 + 1)
    norm2_0gt1 = w_pre0gt1 * norm1
    norm2_0lt1 = w_pre0lt1 * norm1

    absval = 0.5 * (lum0.abs() + lum1.abs())
    diff = lum0 - lum1
    scaler = rdiv(norm2_0gt1, norm1 + absval)
    diffs = scaler * diff
    scaler2 = rdiv(norm2_0lt1, norm1 + absval)
    fabs0 = lum0.abs()
    too_small = 0.55 * fabs0
    too_big = 1.05 * fabs0
    impact_neg = torch.where(
        lum1 > -too_small, -scaler2 * (lum1 + too_small),
        torch.where(lum1 < -too_big, scaler2 * (-lum1 - too_big), 0.0))
    impact_pos = torch.where(
        lum1 < too_small, scaler2 * (too_small - lum1),
        torch.where(lum1 > too_big, -scaler2 * (lum1 - too_big), 0.0))
    diffs = diffs + torch.where(lum0 < 0, impact_neg, impact_pos)
    return _malta_accumulate(diffs, MALTA_FULL if full else MALTA_LF)


# ---------------------------------------------------------------------------
# L2 diffs (butteraugli.cc:1315-1390)
# ---------------------------------------------------------------------------

def _l2_diff(i0, i1, w):
    if w == 0:
        return 0.0
    d = i0 - i1
    return w * d * d


def _l2_diff_asymmetric(i0, i1, w_0gt1, w_0lt1):
    vw_0gt1 = w_0gt1 * 0.8
    vw_0lt1 = w_0lt1 * 0.8
    diff = i0 - i1
    total = vw_0gt1 * diff * diff
    fabs0 = i0.abs()
    too_small = 0.4 * fabs0
    too_big = fabs0
    if_neg = torch.where(i1 > -too_small, i1 + too_small,
                         torch.where(i1 < -too_big, -i1 - too_big, 0.0))
    if_pos = torch.where(i1 < too_small, too_small - i1,
                         torch.where(i1 > too_big, i1 - too_big, 0.0))
    v = torch.where(i0 < 0, if_neg, if_pos)
    return total + vw_0lt1 * v * v


# ---------------------------------------------------------------------------
# masking (butteraugli.cc:1110-1290)
# ---------------------------------------------------------------------------

def _combine_channels_for_masking(hf, uhf):
    xdiff = (uhf[0] + hf[0]) * 2.5
    ydiff = uhf[1] * 0.4 + hf[1] * 0.4
    return torch.sqrt(xdiff * xdiff + ydiff * ydiff)


def _diff_precompute(x, mul, bias):
    b = mul * bias
    return torch.sqrt(mul * x.abs() + b) - float(np.sqrt(b))


def _fuzzy_erosion(x: torch.Tensor) -> torch.Tensor:
    """Weighted 3 smallest of {center, 2*center, 2*center, 8 neighbors at
    radius 3 (in-bounds only)} (butteraugli.cc:1173-1214)."""
    h, w = x.shape
    step = 3
    p = F.pad(x, (step,) * 4, value=float("inf"))
    cands = [x, 2.0 * x, 2.0 * x]
    for dy in (-step, 0, step):
        for dx in (-step, 0, step):
            if dy == 0 and dx == 0:
                continue
            cands.append(p[step + dy:step + dy + h, step + dx:step + dx + w])
    m = torch.topk(torch.stack(cands), 3, dim=0, largest=False).values
    m = torch.where(torch.isinf(m), 0.0, m)   # cannot happen; keep finite
    return 0.45 * m[0] + 0.3 * m[1] + 0.25 * m[2]


def _mask(mask0_in, mask1_in):
    """-> (mask, diff_ac_contribution) (butteraugli.cc:1215-1251)."""
    k_mul = 6.19424080439
    k_bias = 12.61050594197
    k_radius = 2.7
    diff0 = _diff_precompute(mask0_in, k_mul, k_bias)
    diff1 = _diff_precompute(mask1_in, k_mul, k_bias)
    blurred0 = _blur(diff0, k_radius)
    blurred1 = _blur(diff1, k_radius)
    mask = _fuzzy_erosion(blurred0)
    d = blurred0 - blurred1
    return mask, 10.0 * d * d


def _mask_y(delta):
    c = rdiv(2.5485944793, 0.451936922203 * delta + 0.829591754942)
    retval = _GLOBAL_SCALE * (1.0 + c)
    return retval * retval


def _mask_dc_y(delta):
    c = rdiv(0.505054525019, 3.87449418804 * delta + 0.20025578522)
    retval = _GLOBAL_SCALE * (1.0 + c)
    return retval * retval


# ---------------------------------------------------------------------------
# diffmap assembly
# ---------------------------------------------------------------------------

def _diffmap_psycho(ps0, ps1, hf_asymmetry, xmul):
    """(DiffmapPsychoImage:1893-1951)."""
    ac = [torch.zeros_like(ps0["mf"][0]) for _ in range(3)]
    ac[1] += _malta_diff(ps0["uhf"][1], ps1["uhf"][1],
                         W_UHF_MALTA * hf_asymmetry,
                         W_UHF_MALTA / hf_asymmetry, NORM1_UHF, full=True)
    ac[0] += _malta_diff(ps0["uhf"][0], ps1["uhf"][0],
                         W_UHF_MALTA_X * hf_asymmetry,
                         W_UHF_MALTA_X / hf_asymmetry, NORM1_UHF_X,
                         full=True)
    sq = np.sqrt(hf_asymmetry)
    ac[1] += _malta_diff(ps0["hf"][1], ps1["hf"][1], W_HF_MALTA * sq,
                         W_HF_MALTA / sq, NORM1_HF, full=False)
    ac[0] += _malta_diff(ps0["hf"][0], ps1["hf"][0], W_HF_MALTA_X * sq,
                         W_HF_MALTA_X / sq, NORM1_HF_X, full=False)
    ac[1] += _malta_diff(ps0["mf"][1], ps1["mf"][1], W_MF_MALTA,
                         W_MF_MALTA, NORM1_MF, full=False)
    ac[0] += _malta_diff(ps0["mf"][0], ps1["mf"][0], W_MF_MALTA_X,
                         W_MF_MALTA_X, NORM1_MF_X, full=False)

    dc = []
    for c in range(3):
        if c < 2:
            ac[c] += _l2_diff_asymmetric(ps0["hf"][c], ps1["hf"][c],
                                         WMUL[c] * hf_asymmetry,
                                         WMUL[c] / hf_asymmetry)
        ac[c] += _l2_diff(ps0["mf"][c], ps1["mf"][c], WMUL[3 + c])
        dc.append(_l2_diff(ps0["lf"][c], ps1["lf"][c], WMUL[6 + c]))

    mask0 = _combine_channels_for_masking(ps0["hf"], ps0["uhf"])
    mask1 = _combine_channels_for_masking(ps1["hf"], ps1["uhf"])
    mask, mask_ac = _mask(mask0, mask1)
    ac[1] += mask_ac

    maskval = _mask_y(mask)
    dc_maskval = _mask_dc_y(mask)
    sum_dc = (dc[0] * xmul + dc[1] + dc[2]) * dc_maskval
    sum_ac = (ac[0] * xmul + ac[1] + ac[2]) * maskval
    return torch.sqrt(sum_dc + sum_ac)


def _subsample2x(img: torch.Tensor) -> torch.Tensor:
    """2x box downsample with odd-edge doubling (butteraugli.cc:1733)."""
    c, h, w = img.shape
    ph, pw = (h + 1) // 2 * 2, (w + 1) // 2 * 2
    p = F.pad(img, (0, pw - w, 0, ph - h))
    out = 0.25 * (p[:, 0::2, 0::2] + p[:, 1::2, 0::2] +
                  p[:, 0::2, 1::2] + p[:, 1::2, 1::2])
    if w & 1:
        out[:, :, -1] *= 2.0
    if h & 1:
        out[:, -1, :] *= 2.0
    return out


def _add_supersampled2x(src, w, dest):
    up = src.repeat_interleave(2, 0).repeat_interleave(2, 1)
    up = up[:dest.shape[0], :dest.shape[1]]
    return dest * (1.0 - 0.3 * w) + w * up


def _tensor(a, device) -> torch.Tensor:
    """``a`` as float32 on ``device``; a tensor stays on its own device
    when ``device`` is None."""
    if isinstance(a, torch.Tensor):
        dev = a.device if device is None else resolve_device(device)
        return a.to(dev, _f32)
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        resolve_device(device))


def butteraugli_diffmap(rgb0, rgb1, hf_asymmetry: float = 1.0,
                        xmul: float = 1.0, intensity_target: float = 80.0,
                        device=None) -> torch.Tensor:
    """Diffmap between two (3, H, W) linear sRGB [0,1] images (numpy or
    tensors), as an (H, W) float32 tensor on ``device`` (a tensor input's
    own device when None, else ``config.device``).

    Includes one 2x-subsampled level mixed in at weight 0.5 (the
    comparator's sub-resolution pass, butteraugli.cc:1843-1856)."""
    rgb0 = _tensor(rgb0, device)
    rgb1 = _tensor(rgb1, rgb0.device)

    def level(r0, r1):
        xyb0 = opsin_dynamics_image(r0, intensity_target)
        xyb1 = opsin_dynamics_image(r1, intensity_target)
        ps0 = separate_frequencies(xyb0)
        ps1 = separate_frequencies(xyb1)
        return _diffmap_psycho(ps0, ps1, hf_asymmetry, xmul)

    diffmap = level(rgb0, rgb1)
    h, w = rgb0.shape[1:]
    if h // 2 >= 8 and w // 2 >= 8:
        sub = level(_subsample2x(rgb0), _subsample2x(rgb1))
        diffmap = _add_supersampled2x(sub, 0.5, diffmap)
    return diffmap


def butteraugli_distance(rgb0, rgb1, hf_asymmetry: float = 1.0,
                         xmul: float = 1.0,
                         intensity_target: float = 80.0,
                         device=None) -> float:
    """Max-norm score (ButteraugliScoreFromDiffmap:1954-1965)."""
    dm = butteraugli_diffmap(rgb0, rgb1, hf_asymmetry=hf_asymmetry,
                             xmul=xmul, intensity_target=intensity_target,
                             device=device)
    return float(dm.max())


def compute_distance_p(distmap, p: float = 3.0) -> float:
    """(lib/extras/metrics.cc:42-145): mean over i of
    mean(d^(p*2^i))^(1/(p*2^i)), i in {0,1,2}."""
    if isinstance(distmap, torch.Tensor):
        distmap = distmap.cpu().numpy()
    d = np.asarray(distmap, dtype=np.float64)
    one_per_pixels = 1.0 / d.size
    v = 0.0
    dp = d ** p
    for i in range(3):
        v += (one_per_pixels * dp.sum()) ** (1.0 / (p * (1 << i)))
        if i < 2:
            dp = dp * dp
    return v / 3.0


def butteraugli_distance_srgb(img0_u8: np.ndarray, img1_u8: np.ndarray,
                              device=None, **kwargs) -> float:
    """Convenience: (H, W, 3) uint8 sRGB inputs."""
    from libjxl_torch.color.xyb import srgb_to_linear
    a = srgb_to_linear(np.moveaxis(img0_u8, -1, 0).astype(np.float64) / 255)
    b = srgb_to_linear(np.moveaxis(img1_u8, -1, 0).astype(np.float64) / 255)
    return butteraugli_distance(a, b, device=device, **kwargs)
