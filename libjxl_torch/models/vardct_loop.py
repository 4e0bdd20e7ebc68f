"""The device-resident butteraugli loop of the effort >= 7 VarDCT encode
(port of ``libjxl_tpu/models/vardct_loop.py``, which the JAX package
fuses with XLA; it has no Pallas kernel).

The reference's FindBestQuantization reconstructs candidate quant
fields straight from encoder state (RoundtripImage,
``enc_adaptive_quantization.cc:840``), on the CPU, once per iteration.
Here one iteration runs on the device, plain torch in float32: requantize
the cached forward coefficients with the new field, dequantize,
chroma-from-luma, LLF + IDCT (``models/vardct_decode._class_pixels``),
then the scorer of ``vardct/enc_roundtrip.score``: the Gaborish/EPF hand
kernels, XYB->linear, the butteraugli diffmap and the per-8x8 pow-16
sums. Only the (yb, xb) raw-quant field goes up and the (yb8, xb8) sum
grid comes down; pixels stay on the device.

Each strategy class is carried at its exact block count and its pixels
are scattered at their exact positions (no capacity buckets and no
scratch frame). The forward quantization mirrors
``vardct/enc_acs.transform_all``/``finish_chroma`` (enc_group.cc:329-360)
with the CfL factor maps frozen at their first-pass values: the final
emit recomputes them exactly, the loop only steers the field.
"""

from __future__ import annotations

import numpy as np
import torch

from libjxl_torch.config import resolve_device
from libjxl_torch.metrics.butteraugli import rdiv
from libjxl_torch.models.vardct_decode import (
    _adjust_quant_bias, _class_pixels, _matrix,
)
from libjxl_torch.models.vardct_pipeline import _srgb_table, _upload
from libjxl_torch.models.vardct_pipeline import \
    _adjust_quant_bias as adjust_quant_bias_c
from libjxl_torch.vardct.ac_strategy import COVERED_X, COVERED_Y

_f32 = torch.float32


def _srgb_linear_dev(px_u8: torch.Tensor) -> torch.Tensor:
    """(h, w, 3) uint8 sRGB -> (3, h, w) float32 linear, on its device
    (the 256-entry table of the device encode)."""
    table = _srgb_table(px_u8.device)
    return table.index_select(0, px_u8.reshape(-1).to(torch.int32)).reshape(
        px_u8.shape).permute(2, 0, 1).contiguous()


def _dc_smoothed(dc_float, mul_dc, yb: int, xb: int) -> torch.Tensor:
    """DC: quantize + dequantize + adaptive smoothing (the q_dc math of
    frame_enc.encode_lossy and compressed_dc.cc:47-127)."""
    dcy = torch.round(dc_float[1] / mul_dc[1]) * mul_dc[1]
    dcx = torch.round(dc_float[0] / mul_dc[0]) * mul_dc[0]
    dcb = torch.round((dc_float[2] - dcy) / mul_dc[2]) * mul_dc[2] + dcy
    dc = torch.stack([dcx, dcy, dcb])
    if yb > 2 and xb > 2:
        w1 = np.float32(0.20345139757231578)
        w2 = np.float32(0.0334829185968739)
        w0 = np.float32(1.0) - np.float32(4.0) * (w1 + w2)
        w0, w1, w2 = float(w0), float(w1), float(w2)
        cc = dc[:, 1:-1, 1:-1]
        sm = (w0 * cc
              + w1 * (dc[:, 1:-1, :-2] + dc[:, 1:-1, 2:]
                      + dc[:, :-2, 1:-1] + dc[:, 2:, 1:-1])
              + w2 * (dc[:, :-2, :-2] + dc[:, :-2, 2:]
                      + dc[:, 2:, :-2] + dc[:, 2:, 2:]))
        gap = ((cc - sm) / mul_dc[:, None, None]).abs().amax(
            dim=0).clamp_min(0.5)
        factor = (3.0 - 4.0 * gap).clamp_min(0.0)
        dc[:, 1:-1, 1:-1] = (sm - cc) * factor[None] + cc
    return dc


def _loop_step(class_data: dict, dc_float, fx_map, fb_map, x_cc, b_cc,
               raw_quant, scale: float, inv_gs: float, mul_dc, dms,
               x_qm_mul: float,
               orig_lin, lfp, gab: bool, epf_iters: int, h: int, w: int,
               sharp_val: int, score: bool):
    """One loop iteration on the device. ``class_data``: {s: (coefs (n, 3,
    size) float32, by0 (n,), bx0 (n,) int64)}; the other tensors on the
    same device; ``scale`` and ``inv_gs`` are the quantizer's float32
    steps. Returns the (yb8, xb8) diffmap**16 block sums when ``score``,
    else the pre-filter (3, h, w) reconstruction."""
    from libjxl_torch.vardct.enc_acs import _thresholds
    from libjxl_torch.vardct.quant_weights import DequantMatrices

    dev = dc_float.device
    mats = DequantMatrices()
    yb, xb = raw_quant.shape
    dc = _dc_smoothed(dc_float, mul_dc, yb, xb)[None]
    rq_f = raw_quant.to(_f32)
    scale_t = torch.tensor(scale, dtype=_f32, device=dev)
    inv_gs_t = torch.tensor(inv_gs, dtype=_f32, device=dev)
    # the frame as rows of 8x8 blocks: block (by, bx) is row by * xb + bx
    canvas = torch.zeros((yb * xb, 3, 8, 8), dtype=_f32, device=dev)
    for s, (coefs, fy, fx) in class_data.items():
        nby, nbx = COVERED_Y[s], COVERED_X[s]
        tab = _matrix(mats.table_for_strategy(s).reshape(3, -1), dev)
        ith = rdiv(1.0, tab)
        th_y = _matrix(_thresholds(nby, nbx, True), dev)
        th_xb = _matrix(_thresholds(nby, nbx, False), dev)
        qf_c = rq_f[fy, fx]
        qac = scale_t * qf_c

        # forward quantize (enc_group.cc:329-360): Y, round trip for CfL,
        # then X/B residuals against the frozen factor maps
        vy = coefs[:, 1] * (ith[1][None] * qac[:, None])
        q_y = torch.where(vy.abs() >= th_y[None], torch.round(vy), 0.0)
        y_rt = adjust_quant_bias_c(q_y, 1) * tab[1][None] * \
            (inv_gs_t / qf_c)[:, None]
        fxc = fx_map[fy, fx]
        fbc = fb_map[fy, fx]
        vx = (coefs[:, 0] - fxc[:, None] * y_rt) * \
            (ith[0][None] * (qac * x_qm_mul)[:, None])
        vb = (coefs[:, 2] - fbc[:, None] * y_rt) * \
            (ith[2][None] * qac[:, None])
        q_x = torch.where(vx.abs() >= th_xb[None], torch.round(vx), 0.0)
        q_b = torch.where(vb.abs() >= th_xb[None], torch.round(vb), 0.0)
        q = torch.stack([q_x, q_y, q_b], dim=1)

        # decoder-side dequant + CfL (models/vardct_decode semantics)
        dq = _adjust_quant_bias(q) * (tab[None] * dms[None, :, None]) * \
            (inv_gs_t / qf_c)[:, None, None]
        xc = x_cc[fy // 8, fx // 8][:, None]
        bc = b_cc[fy // 8, fx // 8][:, None]
        y_ch = dq[:, 1]
        dq = torch.stack([dq[:, 0] + xc * y_ch, y_ch, dq[:, 2] + bc * y_ch],
                         dim=1)
        fi = torch.zeros_like(fy)
        pix = _class_pixels(s, dq, dc, fi, fy, fx)
        rows = ((fy[:, None, None] + torch.arange(nby, device=dev)[:, None])
                * xb + fx[:, None, None] + torch.arange(nbx, device=dev))
        canvas.index_copy_(0, rows.reshape(-1), pix.reshape(
            -1, 3, nby, 8, nbx, 8).permute(0, 2, 4, 1, 3, 5).reshape(
                -1, 3, 8, 8))
    img = canvas.reshape(yb, xb, 3, 8, 8).permute(2, 0, 3, 1, 4).reshape(
        3, yb * 8, xb * 8)
    xyb = img[:, :h, :w].contiguous()
    if not score:
        return xyb

    from libjxl_torch.vardct.enc_roundtrip import score as score_fn
    sharp = torch.full((yb, xb), sharp_val, dtype=torch.int32, device=dev)
    return score_fn(xyb, orig_lin, raw_quant, sharp, scale, lfp, gab,
                    epf_iters, h, w)


class LoopState:
    """Per-frame device-resident loop state, built once after the first
    heuristics pass (coefficients, DC grid, CfL maps, original image)."""

    def __init__(self, state: dict, aux: dict, orig_lin_f32, d: float,
                 x_qm_mul: float, h: int, w: int,
                 orig_u8: np.ndarray | None = None, device=None):
        from libjxl_torch.render.filters_torch import lf_params
        from libjxl_torch.vardct.cfl import ColorCorrelation

        dev = resolve_device(device)
        self.device = dev
        cc = aux["coef_cache"]
        acs = aux["acs"]
        anchors = aux["anchors"]
        yb, xb = acs.shape
        self.d = d
        self.acs, self.anchors = acs, anchors
        self.yb, self.xb, self.h, self.w = yb, xb, h, w
        self.gab = bool(state["gab"])
        self.epf_iters = int(state["epf_iters"])
        self.x_qm_mul = float(x_qm_mul)
        x_qm_scale = state["x_qm_scale"]
        self.dms = _matrix([(1 / 1.25) ** (x_qm_scale - 2.0), 1.0, 1.0], dev)
        self.lfp = lf_params(state_lf(state), dev)
        cmap = ColorCorrelation()
        self.x_cc = _matrix(cmap.ytox_ratio_arr(state["ytox"]), dev)
        self.b_cc = _matrix(cmap.ytob_ratio_arr(state["ytob"]), dev)
        cs = cmap.color_scale
        fx_full = np.repeat(np.repeat(state["ytox"], 8, 0), 8, 1)[
            :yb, :xb] * cs
        fb_full = 1.0 + np.repeat(np.repeat(state["ytob"], 8, 0), 8, 1)[
            :yb, :xb] * cs
        self.fx_map = _matrix(fx_full, dev)
        self.fb_map = _matrix(fb_full, dev)
        if orig_u8 is not None:
            # the original as uint8, widened on the device
            self.orig_lin = _srgb_linear_dev(
                _upload(orig_u8, dev, torch.uint8))
        else:
            self.orig_lin = _matrix(orig_lin_f32, dev)

        dev_cache = cc.get("dev")
        if dev_cache is not None:
            # device transform path (models/vardct_transform): the raw
            # per-class coefficients and the DC grid are on the device
            self.dc_float = dev_cache["dc_float"]
            self.class_data = {s: v for s, v in sorted(
                (k, v) for k, v in dev_cache.items() if isinstance(k, int))}
            return
        self.dc_float = _matrix(cc["dc_float"], dev)
        self.class_data = {}
        for s in sorted(k for k in cc if isinstance(k, int)):
            by0, bx0 = np.nonzero(anchors & (acs == s))
            coefs = np.stack([cc[s][c] for c in range(3)], axis=1)
            self.class_data[s] = (_matrix(coefs, dev),
                                  _upload(by0, dev, torch.int64),
                                  _upload(bx0, dev, torch.int64))

    def _quant_host(self, qf: np.ndarray):
        from libjxl_torch.vardct.adaptive_quant import (
            compute_global_scale_and_quant, initial_quant_dc,
        )
        from libjxl_torch.vardct.enc_acs import adjust_field_for_acs
        from libjxl_torch.vardct.frame_dec import Quantizer

        quant_dc_f = initial_quant_dc(self.d)
        global_scale, quant_dc_int, raw_quant = \
            compute_global_scale_and_quant(quant_dc_f, qf)
        raw_quant = adjust_field_for_acs(
            self.acs, self.anchors, raw_quant, self.d)
        return raw_quant, Quantizer(global_scale, quant_dc_int)

    def step_args(self, qf: np.ndarray) -> dict:
        """``_loop_step``'s arguments for the field ``qf`` but ``score``:
        the raw quant field and the quantizer's steps derived on the host,
        the frame's device data."""
        from libjxl_torch.vardct.quant_weights import DequantMatrices

        dev = self.device
        raw_quant, quantizer = self._quant_host(qf)
        mul_dc = quantizer.mul_dc(DequantMatrices().dc_quant)
        return dict(
            class_data=self.class_data, dc_float=self.dc_float,
            fx_map=self.fx_map, fb_map=self.fb_map, x_cc=self.x_cc,
            b_cc=self.b_cc, raw_quant=_upload(raw_quant, dev, torch.int32),
            scale=float(quantizer.scale),
            inv_gs=float(quantizer.inv_global_scale),
            mul_dc=_matrix(np.asarray(mul_dc), dev), dms=self.dms,
            x_qm_mul=self.x_qm_mul, orig_lin=self.orig_lin, lfp=self.lfp,
            gab=self.gab, epf_iters=self.epf_iters, h=self.h, w=self.w,
            sharp_val=4 if self.epf_iters > 0 else 0)

    def _run(self, qf, score: bool):
        return _loop_step(**self.step_args(qf), score=score)

    def block_sums(self, qf: np.ndarray) -> np.ndarray:
        """(yb8, xb8) diffmap**16 sums for _tile_dist_map."""
        return self._run(qf, True).cpu().numpy().astype(np.float64)

    def recon_prefilter(self, qf: np.ndarray):
        """Pre-filter (3, h, w) recon as a device tensor (for the EPF
        sharpness search) plus a shim with the decoder fields
        epf_candidate_errs reads."""
        xyb = self._run(qf, False)
        raw_quant, quantizer = self._quant_host(qf)

        class _Shim:
            pass

        shim = _Shim()
        shim.raw_quant = raw_quant
        shim.quantizer = quantizer
        shim.epf_sharpness = np.full((self.yb, self.xb),
                                     4 if self.epf_iters > 0 else 0,
                                     np.int32)
        return xyb, shim


def state_lf(state: dict):
    """LoopFilter params matching enc_roundtrip.reconstruct_prefilter."""
    from libjxl_torch.core.frame_header import (
        ColorTransform, FrameEncoding, FrameHeader,
    )
    fh = FrameHeader(encoding=FrameEncoding.VARDCT,
                     color_transform=ColorTransform.XYB)
    fh.loop_filter.gab = state["gab"]
    fh.loop_filter.epf_iters = state["epf_iters"]
    return fh.loop_filter
