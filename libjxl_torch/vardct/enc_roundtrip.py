"""Encoder-side roundtrip reconstruction for the butteraugli loop.

The reference's FindBestQuantization scores candidate quant fields by
reconstructing the image directly from encoder state — RoundtripImage
(``enc_adaptive_quantization.cc:840``) runs the real decoder fed by
``GetBlockFromEncoder`` (``dec_group.cc:662``), so no bitstream is
emitted or parsed inside the loop. This module is that path for our
encoder: it fills a ``VarDCTFrameDecoder`` with the encoder's quantized
products (no BitReaders involved) and reuses the decoder's own batched
dequant + CfL + LLF + IDCT (``_reconstruct_group_batched``) and filter
math, guaranteeing the roundtrip matches what the emitted stream will
decode to.

The port's copy of ``libjxl_tpu/vardct/enc_roundtrip.py``: the device
scorer (``score``) and the EPF candidate errors (``epf_errs``) are plain
functions on torch tensors of one device, filtering through the hand
Gaborish/EPF kernels of ``render/filters_torch``; their entry points
take ``device=``.
"""

from __future__ import annotations

import numpy as np
import torch

from libjxl_torch.core.frame_header import (
    ColorTransform, FrameEncoding, FrameHeader,
)


def _recon_meta():
    """Minimal ImageMetadata for a recon-only decoder instance."""
    from libjxl_torch.core.headers import ColorEncoding, ImageMetadata
    return ImageMetadata(xyb_encoded=True,
                         color_encoding=ColorEncoding.srgb(gray=False))


def reconstruct_prefilter(state: dict):
    """Reconstruct the pre-filter XYB image from encoder state.

    ``state`` is the dict captured by ``encode_lossy(_recon_only=True)``.
    Returns ``(xyb, dec, lf)`` with the same meaning as the decoder's
    ``_return_prefilter`` hook: cropped (3, H, W) float XYB plus the
    filled decoder (for compute_sigma inputs) and loop-filter params.
    """
    from libjxl_torch.vardct.frame_dec import VarDCTFrameDecoder

    fd = state["fd"]
    fh = FrameHeader(encoding=FrameEncoding.VARDCT,
                     color_transform=ColorTransform.XYB)
    fh.x_qm_scale = state["x_qm_scale"]
    fh.loop_filter.gab = state["gab"]
    fh.loop_filter.epf_iters = state["epf_iters"]
    dec = VarDCTFrameDecoder(fh, _recon_meta(), fd)
    dec.quantizer = state["quantizer"]
    dec.matrices = state["matrices"]
    dec.raw_quant[:] = state["raw_quant"]
    dec.acs_raw[:] = state["acs"]
    dec.acs_anchor[:] = state["anchors"]
    sharp = state.get("sharpness")
    if sharp is None:
        dec.epf_sharpness[:] = 4 if fh.loop_filter.epf_iters > 0 else 0
    else:
        dec.epf_sharpness[:] = sharp
    dec.ytox_map[:] = state["ytox"]
    dec.ytob_map[:] = state["ytob"]

    # DC exactly as decode_dc_group dequantizes it (CfL DC base factors
    # x=0, b=1), then adaptive smoothing
    q_dc = state["q_dc"]
    mul_dc = dec.quantizer.mul_dc(dec.matrices.dc_quant)
    dcy = q_dc[:, :, 1].astype(np.float32) * np.float32(mul_dc[1])
    dcx = q_dc[:, :, 0].astype(np.float32) * np.float32(mul_dc[0])
    dcb = q_dc[:, :, 2].astype(np.float32) * np.float32(mul_dc[2]) + dcy
    dec.dc = np.stack([dcx, dcy, dcb])
    dec.finalize_dc()

    yb, xb = state["raw_quant"].shape
    gdb = fd.group_dim // 8
    blocks = state["blocks"]
    q_ac = state.get("q_ac")
    for gy in range(fd.ysize_groups):
        for gx in range(fd.xsize_groups):
            by0, bx0 = gy * gdb, gx * gdb
            h_ = min(gdb, yb - by0)
            w_ = min(gdb, xb - bx0)
            acs_g = dec.acs_raw[by0:by0 + h_, bx0:bx0 + w_]
            anc_g = dec.acs_anchor[by0:by0 + h_, bx0:bx0 + w_]
            if blocks is not None:
                ys, xs = np.nonzero(anc_g)
                parts = [blocks[(by0 + by, bx0 + bx)]["q"].reshape(3, -1)
                         for by, bx in zip(ys, xs)]
                coeffs = (np.concatenate(parts, axis=1).astype(np.float32)
                          if parts else np.zeros((3, 0), np.float32))
            else:
                # DCT8-only path: every block is an anchor of size 64
                coeffs = q_ac[by0:by0 + h_, bx0:bx0 + w_].transpose(
                    2, 0, 1, 3).reshape(3, -1).astype(np.float32)
            dec._reconstruct_group_batched(bx0, by0, w_, h_,
                                           acs_g, anc_g, coeffs)
    xyb = dec.pixels[:, :fd.ysize, :fd.xsize]
    return xyb, dec, fh.loop_filter


def _tensor(a, dev, dtype=torch.float32) -> torch.Tensor:
    """``a`` (numpy or a tensor) as a contiguous ``dtype`` tensor on
    ``dev``."""
    if not isinstance(a, torch.Tensor):
        a = np.ascontiguousarray(a)
        a = torch.from_numpy(a if a.flags.writeable else a.copy())
    return a.to(dev, dtype).contiguous()


def linear_clipped(xyb: torch.Tensor) -> torch.Tensor:
    """XYB (3, H, W) -> linear RGB (dec_xyb-inl.h), clipped to [0, 1] like
    a u8 decode, float32."""
    from libjxl_torch.color.xyb import INVERSE_OPSIN, NEG_BIAS_CBRT, \
        OPSIN_BIAS
    g = torch.stack([xyb[1] + xyb[0], xyb[1] - xyb[0], xyb[2]]) \
        - float(np.float32(NEG_BIAS_CBRT))
    mixed = g * g * g - float(np.float32(OPSIN_BIAS))
    m = np.asarray(INVERSE_OPSIN, np.float32)
    lin = torch.stack([float(m[c, 0]) * mixed[0] + float(m[c, 1]) * mixed[1]
                       + float(m[c, 2]) * mixed[2] for c in range(3)])
    return lin.clamp(0.0, 1.0)


def _block_sums(v: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(yb8, xb8) sums over the 8x8 blocks of an (h, w) map."""
    yb8, xb8 = (h + 7) // 8, (w + 7) // 8
    pad = torch.nn.functional.pad(v, (0, xb8 * 8 - w, 0, yb8 * 8 - h))
    return pad.reshape(yb8, 8, xb8, 8).sum(dim=(1, 3))


def score(xyb, orig_lin, raw_quant, sharp, scale: float, lfp,
          gab: bool, epf_iters: int, h: int, w: int) -> torch.Tensor:
    """The device scorer: Gaborish + EPF (the hand kernels on the card,
    ``render/filters_torch.restore``) + XYB->linear + butteraugli diffmap
    + per-8x8 16th-power block sums; only the (yb, xb) block-sum grid
    leaves the device (the reference decodes on the CPU inside its loop,
    enc_adaptive_quantization.cc:840). All tensors on one device."""
    from libjxl_torch.metrics.butteraugli import butteraugli_diffmap
    from libjxl_torch.models.vardct_heuristics import ipow
    from libjxl_torch.render.filters_torch import restore

    lin = linear_clipped(restore(xyb, raw_quant, sharp, scale, lfp, gab,
                                 epf_iters))
    dm = butteraugli_diffmap(orig_lin, lin, hf_asymmetry=0.8)
    # f32 pow-16: dm < ~0.004 underflows to 0, a vanishing contribution
    # to the 16-norm
    return _block_sums(ipow(dm, 16), h, w)


def roundtrip_block_sums(state: dict, orig_lin_f32, h: int, w: int,
                         device=None) -> np.ndarray:
    """Reconstruct on the host, then filter + butteraugli-score on
    ``device``: returns the (yb, xb) per-block sums of diffmap**16 for
    _tile_dist_map."""
    from libjxl_torch.config import resolve_device
    from libjxl_torch.render.filters_torch import lf_params

    dev = resolve_device(device)
    xyb, dec, lf = reconstruct_prefilter(state)
    sums = score(_tensor(xyb, dev), _tensor(orig_lin_f32, dev),
                 _tensor(dec.raw_quant, dev, torch.int32),
                 _tensor(dec.epf_sharpness, dev, torch.int32),
                 float(dec.quantizer.scale), lf_params(lf, dev),
                 bool(lf.gab), int(lf.epf_iters), h, w)
    return sums.cpu().numpy().astype(np.float64)


def epf_errs(xyb, orig, raw_quant, scale: float, lfp, steps: tuple,
             gab: bool, epf_iters: int, h: int, w: int) -> torch.Tensor:
    """Candidate-sharpness error grids for the EPF search
    (ComputeARHeuristics, enc_heuristics.cc:892-1018): for each uniform
    sharpness candidate, run the EPF chain (the hand kernels on the card)
    and reduce the weighted L2 error to per-8x8-block sums."""
    from libjxl_torch.render.filters_torch import (
        compute_sigma, epf_step0, epf_step1, epf_step2, gaborish,
    )

    if gab:
        xyb = gaborish(xyb, lfp)
    kw = torch.tensor([12.339445295782363, 1.0, 0.2], dtype=torch.float32,
                      device=xyb.device)
    yb8, xb8 = (h + 7) // 8, (w + 7) // 8
    out = []
    for s in steps:
        sh = torch.full((yb8, xb8), s, dtype=torch.int32, device=xyb.device)
        inv_sigma = compute_sigma(lfp, raw_quant, sh, scale)
        o = xyb
        if epf_iters >= 3:
            o = epf_step0(o, inv_sigma, lfp)
        o = epf_step1(o, inv_sigma, lfp)
        if epf_iters >= 2:
            o = epf_step2(o, inv_sigma, lfp)
        d = o - orig
        out.append(_block_sums((d * d * kw[:, None, None]).sum(dim=0), h, w))
    return torch.stack(out)


def epf_candidate_errs(xyb_pre, dec, lf, orig_xyb, steps: tuple,
                       device=None) -> np.ndarray:
    """(len(steps), yb, xb) per-block weighted-L2 error sums for uniform
    sharpness candidates, computed on ``device``. ``xyb_pre`` and
    ``orig_xyb`` are numpy or tensors."""
    from libjxl_torch.config import resolve_device
    from libjxl_torch.render.filters_torch import lf_params

    dev = resolve_device(device)
    _, h, w = xyb_pre.shape
    out = epf_errs(_tensor(xyb_pre, dev), _tensor(orig_xyb[:, :h, :w], dev),
                   _tensor(dec.raw_quant, dev, torch.int32),
                   float(dec.quantizer.scale), lf_params(lf, dev),
                   tuple(int(s) for s in steps), bool(lf.gab),
                   int(lf.epf_iters), h, w)
    return out.cpu().numpy().astype(np.float64)


def filtered_linear(xyb: np.ndarray, dec, lf) -> np.ndarray:
    """Apply gaborish + EPF to a pre-filter recon and convert to linear
    RGB clipped to [0, 1] (the range a u8 decode would produce) for
    butteraugli scoring."""
    from libjxl_torch.color.xyb import xyb_to_linear
    from libjxl_torch.render.filters import (
        compute_sigma, epf_step0, epf_step1, epf_step2, gaborish,
    )
    out = gaborish(xyb, lf) if lf.gab else xyb
    if lf.epf_iters > 0:
        inv_sigma = compute_sigma(lf, dec.acs_raw, dec.acs_anchor,
                                  dec.raw_quant, dec.epf_sharpness,
                                  dec.quantizer.scale)
        if lf.epf_iters >= 3:
            out = epf_step0(out, inv_sigma, lf)
        out = epf_step1(out, inv_sigma, lf)
        if lf.epf_iters >= 2:
            out = epf_step2(out, inv_sigma, lf)
    return np.clip(xyb_to_linear(np.asarray(out, np.float64)), 0.0, 1.0)
