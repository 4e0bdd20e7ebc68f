"""Restoration filters on the device: Gaborish + EPF in float32 (port of
``libjxl_tpu/render/filters_jax.py`` and of the ``xp=jax.numpy`` math of
``render/filters.py``).

The stencils run as the CUDA kernels of ``models/filter_kernels.py``, one
launch per pass (their plain versions on a CPU tensor). Scalars are
rounded to float32 on the host exactly as the reference's traced float32
scalars are, so the kernels get the same weights. ``output_int`` is the
inverse XYB + sRGB + quantization step that the reference fuses into the
same XLA program; it is plain torch. ``restore_device``,
``output_srgb_int_device`` and ``restore_banded`` are ``decode()``'s
entry points into them (``libjxl_tpu/render/filters_jax.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from libjxl_torch.color.xyb import INVERSE_OPSIN, NEG_BIAS_CBRT, OPSIN_BIAS
from libjxl_torch.config import resolve_device
from libjxl_torch.models.filter_kernels import epf_filter, gaborish_filter
from libjxl_torch.render.filters import K_INV_SIGMA_NUM

_f32 = np.float32


class LfParams(NamedTuple):
    """Loop-filter constants (frame_header.h LoopFilter), float32."""

    gab_x_weight1: float
    gab_x_weight2: float
    gab_y_weight1: float
    gab_y_weight2: float
    gab_b_weight1: float
    gab_b_weight2: float
    epf_quant_mul: float
    epf_sharp_lut: torch.Tensor     # (8,) float32 on the device
    epf_channel_scale: tuple
    epf_border_sad_mul: float
    epf_pass0_sigma_scale: float
    epf_pass2_sigma_scale: float


def lf_params(lf, device=None) -> LfParams:
    f = lambda v: float(_f32(v))  # noqa: E731
    return LfParams(
        f(lf.gab_x_weight1), f(lf.gab_x_weight2),
        f(lf.gab_y_weight1), f(lf.gab_y_weight2),
        f(lf.gab_b_weight1), f(lf.gab_b_weight2),
        f(lf.epf_quant_mul),
        torch.tensor(np.asarray(lf.epf_sharp_lut, _f32),
                     device=resolve_device(device)),
        tuple(f(v) for v in lf.epf_channel_scale),
        f(lf.epf_border_sad_mul),
        f(lf.epf_pass0_sigma_scale), f(lf.epf_pass2_sigma_scale),
    )


def lf_key(lf) -> tuple:
    """The float32 constants of ``lf`` that the filters read (the fields
    of ``LfParams``), as a hashable tuple: frames with equal keys are
    filtered alike."""
    return tuple(float(v) for name in LfParams._fields
                 for v in np.ravel(np.asarray(getattr(lf, name), _f32)))


def compute_sigma(lfp: LfParams, raw_quant: torch.Tensor,
                  sharpness: torch.Tensor, quant_scale: float
                  ) -> torch.Tensor:
    """Per-8x8-block 1/sigma (epf.cc:39-110), float32, on the fields'
    device: (yb, xb) int raw quant and EPF sharpness."""
    sigma_quant = lfp.epf_quant_mul / (
        float(_f32(quant_scale)) * raw_quant.to(torch.float32) *
        float(_f32(K_INV_SIGMA_NUM)))
    sigma = sigma_quant * lfp.epf_sharp_lut[sharpness.long()]
    sigma = sigma.clamp_max(float(_f32(-1e-4)))
    return (1.0 / sigma).contiguous()


def gab_weights(lfp: LfParams) -> tuple:
    """Gaborish's per-channel (w0, w1, w2), each divided by
    ``1 + 4 (w1 + w2)`` in float32."""
    w1 = np.array([lfp.gab_x_weight1, lfp.gab_y_weight1,
                   lfp.gab_b_weight1], _f32)
    w2 = np.array([lfp.gab_x_weight2, lfp.gab_y_weight2,
                   lfp.gab_b_weight2], _f32)
    div = _f32(1.0) + _f32(4.0) * (w1 + w2)
    return tuple(tuple(map(float, v)) for v in (_f32(1.0) / div, w1 / div,
                                                w2 / div))


def epf_args(lfp: LfParams, pass_id: int) -> tuple:
    """(scales, sm, bsm) of EPF pass ``pass_id``: the SAD multiplier is
    1.65 times the pass's sigma scale (1 for pass 1), and
    ``epf_border_sad_mul`` times that on block borders, in float32."""
    sm = _f32(1.65)
    if pass_id != 1:
        scale = (lfp.epf_pass0_sigma_scale if pass_id == 0
                 else lfp.epf_pass2_sigma_scale)
        sm = _f32(scale) * sm
    bsm = sm * _f32(lfp.epf_border_sad_mul)
    return lfp.epf_channel_scale, float(sm), float(bsm)


def gaborish(xyb: torch.Tensor, lfp: LfParams) -> torch.Tensor:
    """3x3 smoothing (stage_gaborish.cc:31-54). xyb: (3, H, W) float32."""
    return gaborish_filter(xyb, *gab_weights(lfp))


def epf_step0(xyb, inv_sigma, lfp: LfParams):
    """EPF pass 0 (5x5 diamond, plus-shaped SADs; stage_epf.cc EPF0)."""
    return epf_filter(xyb, inv_sigma, 0, *epf_args(lfp, 0))


def epf_step1(xyb, inv_sigma, lfp: LfParams):
    """EPF pass 1 (3x3 plus, plus-shaped SADs; stage_epf.cc EPF1)."""
    return epf_filter(xyb, inv_sigma, 1, *epf_args(lfp, 1))


def epf_step2(xyb, inv_sigma, lfp: LfParams):
    """EPF pass 2 (3x3 plus, centre SADs; stage_epf.cc EPF2)."""
    return epf_filter(xyb, inv_sigma, 2, *epf_args(lfp, 2))


def restore(xyb: torch.Tensor, raw_quant: torch.Tensor,
            sharpness: torch.Tensor, quant_scale: float, lf: LfParams,
            gab: bool, epf_iters: int) -> torch.Tensor:
    """Gaborish, then EPF passes 0 (epf_iters >= 3), 1, 2 (>= 2), on one
    (3, H, W) float32 frame (filters_jax._restore)."""
    if gab:
        xyb = gaborish(xyb, lf)
    if epf_iters > 0:
        inv_sigma = compute_sigma(lf, raw_quant, sharpness, quant_scale)
        if epf_iters >= 3:
            xyb = epf_step0(xyb, inv_sigma, lf)
        xyb = epf_step1(xyb, inv_sigma, lf)
        if epf_iters >= 2:
            xyb = epf_step2(xyb, inv_sigma, lf)
    return xyb


def output_int(xyb: torch.Tensor, intensity: float, maxval: int
               ) -> torch.Tensor:
    """XYB (3, H, W) -> (H, W, 3) integer sRGB (dec_xyb-inl.h:39-86 + sRGB
    encode + quantization). uint8 for ``maxval <= 255``; else the uint16
    values as int16 bit patterns (torch's uint16 is a storage-only type),
    which the host views as ``np.uint16``."""
    f32 = dict(dtype=torch.float32, device=xyb.device)
    gamma = torch.stack([xyb[1] + xyb[0], xyb[1] - xyb[0], xyb[2]])
    gamma = gamma - float(_f32(NEG_BIAS_CBRT))
    mixed = gamma * gamma * gamma - float(_f32(OPSIN_BIAS))
    inv = torch.tensor(INVERSE_OPSIN, **f32) * (
        torch.tensor(255.0, **f32) / torch.tensor(intensity, **f32))
    linear = torch.stack([
        inv[c, 0] * mixed[0] + inv[c, 1] * mixed[1] + inv[c, 2] * mixed[2]
        for c in range(3)])
    a = linear.abs()
    enc = torch.where(a <= float(_f32(0.0031308)), a * float(_f32(12.92)),
                      float(_f32(1.055)) * a ** float(_f32(1 / 2.4))
                      - float(_f32(0.055)))
    srgb = torch.sign(linear) * enc
    out = torch.clamp(torch.round(srgb * float(maxval)), 0, maxval)
    out = out.permute(1, 2, 0)
    if maxval <= 255:
        return out.to(torch.uint8)
    out = out.to(torch.int32)
    return torch.where(out >= 32768, out - 65536, out).to(torch.int16)


def restore_device(xyb, lf, raw_quant, epf_sharpness, quant_scale: float,
                   fetch: bool = True, device=None):
    """Gaborish + EPF of one (3, H, W) frame on ``device`` in float32
    (filters_jax.restore_device), with the frame's own loop filter
    ``lf`` and its per-block raw quant and EPF sharpness. With ``fetch``
    the result comes back as numpy of ``xyb``'s dtype; with
    ``fetch=False`` it stays on the device for ``output_srgb_int_device``
    (only the integer image then crosses to the host)."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.ascontiguousarray(xyb, _f32)).to(dev)
    out = restore(x, torch.from_numpy(np.asarray(raw_quant)).to(dev),
                  torch.from_numpy(np.asarray(epf_sharpness)).to(dev),
                  float(quant_scale), lf_params(lf, dev), bool(lf.gab),
                  int(lf.epf_iters))
    if not fetch:
        return out
    return out.cpu().numpy().astype(np.asarray(xyb).dtype)


def output_srgb_int_device(xyb_dev: torch.Tensor, intensity: float,
                           maxval: int) -> np.ndarray:
    """The (h, w, 3) integer sRGB image (uint8, or uint16 for ``maxval >
    255``) of a device-held XYB frame from ``restore_device(fetch=False)``:
    the colour transform and quantization run on its device, and only
    the integer image is fetched."""
    out = output_int(xyb_dev, float(intensity), int(maxval)).cpu().numpy()
    return out.view(np.uint16) if maxval > 255 else out


def restore_banded(xyb: np.ndarray, lf, raw_quant, epf_sharpness,
                   quant_scale: float, gd: int = 256, margin: int = 8,
                   device=None) -> np.ndarray:
    """Whole-frame filters applied in the group-row windows of the banded
    decoder (``decode_rows``' filter_band: 256-row bands with 8-row
    halos from their neighbours; filters_jax.restore_banded). Each
    window is filtered as ``decode_rows`` filters it, so banded and
    whole-frame decode stay bit-identical."""
    h = xyb.shape[1]
    parts = []
    for y0 in range(0, h, gd):
        rows = min(gd, h - y0)
        top = margin if y0 > 0 else 0
        bot = margin if y0 + rows < h else 0
        ext = xyb[:, y0 - top:y0 + rows + bot]
        br0 = (y0 - top) // 8
        br1 = br0 + -(-ext.shape[1] // 8)
        f = restore_device(ext, lf, np.asarray(raw_quant)[br0:br1],
                           np.asarray(epf_sharpness)[br0:br1],
                           quant_scale, device=device)
        parts.append(f[:, top:top + rows])
    return np.concatenate(parts, axis=1)
