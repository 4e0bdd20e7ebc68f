"""The variable-block forward transform and quantization of the effort
>= 5 encode on the device (port of ``libjxl_tpu/models/vardct_transform.py``,
which the JAX package fuses with XLA; it has no Pallas kernel).

From the device's padded XYB plane, plain torch, float32 with TF32 off:
  * the whole-frame DCT8 Y quantization + round trip and the per-64x64
    chroma-from-luma least squares (the math of
    ``models/vardct_pipeline._frame_body``; enc_chroma_from_luma.cc),
  * for each AC strategy class of the frame, at its exact block count,
    the forward transform of its blocks (gathered at their anchors),
    dead-zone quantization of all three channels with the CfL factors
    unapplied (enc_group.cc:329-360, the math of
    ``vardct/enc_acs.transform_all`` + ``finish_chroma``),
  * the DC grid from each block's lowest frequencies
    (DCFromLowestFrequencies), scattered on the device.

The host fetches the quantized coefficients, the DC grid and the CfL
maps; the raw per-class coefficients and the DC grid stay on the device
for the butteraugli loop (``models/vardct_loop.LoopState``).
"""

from __future__ import annotations

import numpy as np
import torch

from libjxl_torch.metrics.butteraugli import rdiv
from libjxl_torch.models.vardct_decode import _matrix
from libjxl_torch.models.vardct_pipeline import (
    _COLOR_SCALE, _adjust_quant_bias, dct_stored,
)
from libjxl_torch.vardct.ac_strategy import COVERED_X, COVERED_Y
from libjxl_torch.vardct.dct import dct_matrix, idct_matrix, resample_scales
from libjxl_torch.vardct.enc_acs import _thresholds
from libjxl_torch.vardct.enc_transforms_small import forward_matrix

SPECIALS = (1, 2, 3, 12, 13, 14, 15, 16, 17)
_f32 = torch.float32


def class_coefficients(xyb: torch.Tensor, s: int, by0: torch.Tensor,
                       bx0: torch.Tensor) -> torch.Tensor:
    """(n, 3, size) forward-transform coefficients, in the stored layout,
    of the n blocks of strategy ``s`` anchored at block (by0, bx0) of the
    padded (3, yb*8, xb*8) plane."""
    dev = xyb.device
    nby, nbx = COVERED_Y[s], COVERED_X[s]
    rows, cols = nby * 8, nbx * 8
    ys = by0[:, None] * 8 + torch.arange(rows, device=dev)
    xs = bx0[:, None] * 8 + torch.arange(cols, device=dev)
    win = xyb[:, ys[:, :, None], xs[:, None, :]].transpose(0, 1)
    n = win.shape[0]
    if s in SPECIALS:
        return win.reshape(n, 3, 64) @ _matrix(forward_matrix(s), dev).T
    mr, mc = (_matrix(dct_matrix(n), dev) for n in (rows, cols))
    rc = (mr @ win) @ mc.T
    st = rc.transpose(2, 3) if rows >= cols else rc
    return st.reshape(n, 3, rows * cols)


def _class_dc(raw: torch.Tensor, s: int) -> torch.Tensor:
    """(n, 3, nby, nbx) DC blocks from the pre-CfL lowest frequencies of
    the class coefficients ``raw`` (n, 3, size)."""
    dev = raw.device
    if s in SPECIALS:
        return raw[:, :, 0:1].reshape(-1, 3, 1, 1)
    nby, nbx = COVERED_Y[s], COVERED_X[s]
    mn, mx = min(nby, nbx), max(nby, nbx)
    llf_st = raw.reshape(-1, 3, mn * 8, mx * 8)[:, :, :mn, :mx]
    llf = llf_st.transpose(2, 3) if nby >= nbx else llf_st
    sy = _matrix(1.0 / resample_scales(nby), dev)
    sx = _matrix(1.0 / resample_scales(nbx), dev)
    ll = llf / sy[None, None, :, None] / sx[None, None, None, :]
    imy, imx = (_matrix(idct_matrix(n), dev) for n in (nby, nbx))
    return (imy @ ll) @ imx.T


def transform_quantize(xyb, rq, classes: dict, scale, inv_gs, tables: dict,
                       x_qm_mul: float):
    """The transform and quantization on ``xyb``'s device.

    xyb: (3, yb*8, xb*8) float32; rq: (yb, xb) int32 raw quant;
    classes: {s: (by0, bx0)} int64 anchor tensors; scale, inv_gs: 0-d
    float32 tensors; tables: {0 and each s: (3, size) float32}. Returns
    (ytox, ytob (ty, tx) int32, dc_float (3, yb, xb) float32, {s: (raw
    (n, 3, size) float32, q (n, 3, size) int16)})."""
    dev = xyb.device
    yb, xb = rq.shape
    rq_f = rq.to(_f32)

    # ---- whole-frame DCT8 -> Y quantize/round trip -> CfL least squares
    stored8 = dct_stored(xyb[None], yb * 8, xb * 8, yb, xb)[0]
    tab8 = tables[0]
    th8_y = _matrix(_thresholds(1, 1, True), dev)
    qac8 = scale * rq_f
    val_y = stored8[:, :, 1] * (rdiv(1.0, tab8[1])[None, None] *
                                qac8[:, :, None])
    q_y8 = torch.where(val_y.abs() >= th8_y[None, None],
                       torch.round(val_y), 0.0)
    y_rt8 = _adjust_quant_bias(q_y8, 1) * (tab8[1][None, None] *
                                           (inv_gs / rq_f)[:, :, None])
    ty_n, tx_n = -(-yb // 8), -(-xb // 8)

    def tiled(a):
        a = torch.nn.functional.pad(a, (0, 0, 0, tx_n * 8 - xb,
                                        0, ty_n * 8 - yb))
        return a.reshape(ty_n, 8, tx_n, 8, 63)

    yt = tiled(y_rt8[:, :, 1:])
    xt = tiled(stored8[:, :, 0, 1:])
    bt = tiled(stored8[:, :, 2, 1:])
    dims = (1, 3, 4)
    denom = (yt * yt).sum(dims)
    dx = (xt * yt).sum(dims)
    db = (bt * yt).sum(dims)
    ok = denom >= 1e-9
    dsafe = torch.where(ok, denom, 1.0)
    cs = torch.tensor(_COLOR_SCALE, dtype=_f32, device=dev)
    ytox = torch.where(ok, torch.clamp(torch.round(dx / dsafe / cs),
                                       -128, 127), 0.0).to(torch.int32)
    ytob = torch.where(ok, torch.clamp(torch.round((db / dsafe - 1.0) / cs),
                                       -128, 127), 0.0).to(torch.int32)
    fx_t = ytox.to(_f32) * _COLOR_SCALE
    fb_t = 1.0 + ytob.to(_f32) * _COLOR_SCALE

    dc_float = torch.zeros((3, yb, xb), dtype=_f32, device=dev)
    out = {}
    for s, (by0, bx0) in classes.items():
        nby, nbx = COVERED_Y[s], COVERED_X[s]
        tab = tables[s]
        th_y = _matrix(_thresholds(nby, nbx, True), dev)
        th_xb = _matrix(_thresholds(nby, nbx, False), dev)
        raw = class_coefficients(xyb, s, by0, bx0)
        qf_c = rq_f[by0, bx0].clamp_min(1.0)
        qac = scale * qf_c
        ith = rdiv(1.0, tab)
        vy = raw[:, 1] * (ith[1][None] * qac[:, None])
        q_yc = torch.where(vy.abs() >= th_y[None], torch.round(vy), 0.0)
        y_rt = _adjust_quant_bias(q_yc, 1) * tab[1][None] * \
            (inv_gs / qf_c)[:, None]
        fxc = fx_t[by0 // 8, bx0 // 8]
        fbc = fb_t[by0 // 8, bx0 // 8]
        vx = (raw[:, 0] - fxc[:, None] * y_rt) * \
            (ith[0][None] * (qac * x_qm_mul)[:, None])
        vb = (raw[:, 2] - fbc[:, None] * y_rt) * \
            (ith[2][None] * qac[:, None])
        q_x = torch.where(vx.abs() >= th_xb[None], torch.round(vx), 0.0)
        q_b = torch.where(vb.abs() >= th_xb[None], torch.round(vb), 0.0)
        q = torch.stack([q_x, q_yc, q_b], dim=1).clamp(-32767, 32767)
        out[s] = (raw, q.to(torch.int16))
        # the DC of every covered block, scattered at its position
        ys = (by0[:, None] + torch.arange(nby, device=dev))[:, :, None]
        xs = (bx0[:, None] + torch.arange(nbx, device=dev))[:, None, :]
        dcb = _class_dc(raw, s)                      # (n, 3, nby, nbx)
        dc_float[:, ys, xs] = dcb.permute(1, 0, 2, 3)
    return ytox, ytob, dc_float, out


def device_inputs(xyb_dev: torch.Tensor, acs: np.ndarray,
                  anchors: np.ndarray, raw_quant: np.ndarray, matrices,
                  quantizer, x_qm_mul: float) -> tuple:
    """({s: (by0, bx0)} numpy anchors of each class present, the
    arguments of ``transform_quantize`` on ``xyb_dev``'s device)."""
    dev = xyb_dev.device
    hosts = {}
    for s in sorted(int(v) for v in np.unique(acs[anchors])):
        hosts[s] = np.nonzero(anchors & (acs == s))
    classes = {s: (torch.from_numpy(by0).to(dev),
                   torch.from_numpy(bx0).to(dev))
               for s, (by0, bx0) in hosts.items()}
    tables = {0: _matrix(matrices.tables[0].reshape(3, 64), dev)}
    tables.update({s: _matrix(matrices.table_for_strategy(s).reshape(3, -1),
                              dev) for s in hosts})
    f32 = dict(dtype=_f32, device=dev)
    return hosts, (xyb_dev,
                   torch.from_numpy(raw_quant.astype(np.int32)).to(dev),
                   classes, torch.tensor(quantizer.scale, **f32),
                   torch.tensor(quantizer.inv_global_scale, **f32), tables,
                   float(x_qm_mul))


def transform_quantize_device(xyb_dev: torch.Tensor, acs: np.ndarray,
                              anchors: np.ndarray, raw_quant: np.ndarray,
                              matrices, quantizer, x_qm_mul: float):
    """The transform and quantization of the frame's ACS layout on
    ``xyb_dev``'s device. Returns a dict:
      blocks_q: {(by, bx): {"q": (3, size) int32, ...}} for the host
        tokenizer (the "q" contract of transform_all + finish_chroma)
      dc_float: (3, yb, xb) float64 numpy DC grid
      ytox, ytob: (ty, tx) int32 numpy CfL maps
      dev_cache: the loop's device data: {s: (coefs (n, 3, size) f32,
        by0 (n,) int64, bx0 (n,) int64)} plus "dc_float", the (3, yb,
        xb) float32 DC grid, all on the device.
    """
    hosts, args = device_inputs(xyb_dev, acs, anchors, raw_quant, matrices,
                                quantizer, x_qm_mul)
    ytox_d, ytob_d, dc_d, out = transform_quantize(*args)
    classes = args[2]

    # one fetch of all quantized coefficients
    sizes = {s: 3 * COVERED_Y[s] * COVERED_X[s] * 64 for s in out}
    q_all = torch.cat([out[s][1].reshape(-1) for s in out]).cpu().numpy() \
        if out else np.zeros(0, np.int16)
    blocks_q = {}
    dev_cache: dict = {"dc_float": dc_d}
    off = 0
    for s, (by0, bx0) in hosts.items():
        n = len(by0)
        nby, nbx = COVERED_Y[s], COVERED_X[s]
        q_np = q_all[off:off + n * sizes[s]].reshape(n, 3, -1).astype(
            np.int32)
        off += n * sizes[s]
        dev_cache[s] = (out[s][0],) + classes[s]
        for i in range(n):
            blocks_q[(int(by0[i]), int(bx0[i]))] = {
                "q": q_np[i], "strategy": s, "covered": nby * nbx,
                "nby": nby, "nbx": nbx}
    return dict(blocks_q=blocks_q,
                dc_float=dc_d.cpu().numpy().astype(np.float64),
                ytox=ytox_d.cpu().numpy(), ytob=ytob_d.cpu().numpy(),
                dev_cache=dev_cache)
