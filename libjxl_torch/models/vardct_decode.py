"""VarDCT frame reconstruction on the device (port of
``libjxl_tpu/models/vardct_decode.py``: the DCT8 4:4:4 serving shape and
the variable-block one).

The host parses each stream and decodes its AC tokens natively
(``api/decoder._device_decode_inputs``); everything pixel-shaped then
runs on the device for a batch of same-shape frames. An all-DCT8 frame
travels as sparse (flat index, value) pairs:

    sparse scatter -> AdjustQuantBias -> dequant -> chroma from luma
    -> IDCT8 -> Gaborish + EPF (CUDA kernels) -> inverse XYB -> sRGB
    -> integer

A variable-block frame (every effort >= 5 encode: DCT16-DCT256,
rectangles and the 8x8 specials) travels as sparse pairs per strategy
class, and each class of the batch is one set of dense products:

    sparse scatter -> AdjustQuantBias -> dequant -> chroma from luma
    -> LLF from the DC -> IDCT (or a 64x64 special matrix) -> scatter
    by block position -> the same filters and output

The reference shipped the batch as one int32 blob padded to power-of-two
buckets (for the var path: dense classes at power-of-two counts and a
scratch frame for the padding blocks), for a slow development link and
its compile cache. Here each leaf is uploaded as it is, the flat indices
are int64 on the device, and each class runs at its exact count.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from libjxl_torch.config import resolve_device
from libjxl_torch.render.filters_torch import lf_params, output_int, restore
from libjxl_torch.vardct.ac_strategy import COVERED_X, COVERED_Y
from libjxl_torch.vardct.dct import dct_matrix, idct_matrix, resample_scales
from libjxl_torch.vardct.enc_transforms_small import inverse_matrix
from libjxl_torch.vardct.frame_dec import K_BIASES
from libjxl_torch.vardct.quant_weights import DequantMatrices


class FrameRecon(NamedTuple):
    """Inputs of one frame's device reconstruction (numpy leaves).

    Quantized AC coefficients travel sparse (values + flat indices):
    about 90% are zero at normal distances."""

    coeff_vals: object    # (N,) int16 nonzero quantized coefficients
    coeff_idx: object     # (N,) int flat indices into (3, yb, xb, 64)
    dc: object            # (3, yb, xb) f32 dequantized DC
    raw_quant: object     # (yb, xb) i32
    sharpness: object     # (yb, xb) i32
    x_cc: object          # (ty, tx) f32 CfL X ratios
    b_cc: object          # (ty, tx) f32 CfL B ratios
    inv_gs: object        # f32 quantizer inverse global scale
    dms: object           # (3,) f32 x/b qm-scale dequant multipliers
    table: object         # (3, 64) f32 DCT8 dequant table
    quant_scale: object   # f32 quantizer scale for EPF sigma
    intensity: object     # f32 intensity target


class FrameReconVar(NamedTuple):
    """Inputs of one variable-block frame's device reconstruction (numpy
    leaves; the fields of the reference's per-frame dict).

    Quantized AC coefficients travel sparse, per AC strategy class: the
    n blocks of class ``s`` as the nonzero ``vals`` (int16, int32 where a
    value exceeds int16) at flat indices ``idx`` (int64) of their dense
    (n, 3, 64 * covered blocks) array in the stored layout, with each
    block's raw quant ``qf`` and its anchor's block row ``fy`` and column
    ``fx`` (n,) int32."""

    classes: dict         # {strategy: (vals, idx, qf, fy, fx)}
    dc: object            # (3, yb, xb) f32 dequantized DC
    raw_quant: object     # (yb, xb) i32, spread over each varblock
    sharpness: object     # (yb, xb) i32
    x_cc: object          # (ty, tx) f32 CfL X ratios
    b_cc: object          # (ty, tx) f32 CfL B ratios
    inv_gs: object        # f32 quantizer inverse global scale
    dms: object           # (3,) f32 x/b qm-scale dequant multipliers
    quant_scale: object   # f32 quantizer scale for EPF sigma
    intensity: object     # f32 intensity target


# the 8x8 transforms that are not a DCT: IDENTITY, DCT2X2, DCT4X4,
# DCT4X8, DCT8X4, AFV0-3 (one 64x64 matrix each)
_SPECIALS = (1, 2, 3, 12, 13, 14, 15, 16, 17)


def _stack(inputs: list, name: str, dev, dtype=None) -> torch.Tensor:
    arr = np.stack([np.asarray(getattr(f, name)) for f in inputs])
    t = torch.from_numpy(arr)
    return (t if dtype is None else t.to(dtype)).to(dev)


def _matrix(m: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(m, np.float32)).to(dev)


def _upload(parts: list, dev) -> torch.Tensor:
    return torch.from_numpy(np.concatenate(parts)).to(dev)


def _adjust_quant_bias(q: torch.Tensor) -> torch.Tensor:
    """AdjustQuantBias (quantizer-inl.h:35-60) on float32 quantized
    coefficients whose axis 1 is the channel."""
    absq = q.abs()
    biased = q - K_BIASES[3] / torch.where(q == 0, 1.0, q)
    biased = torch.where(absq < 0.5, 0.0, biased)
    shape = (1, 3) + (1,) * (q.dim() - 2)
    small = torch.sign(q) * torch.tensor(K_BIASES[:3], dtype=torch.float32,
                                         device=q.device).reshape(shape)
    return torch.where((absq > 0.5) & (absq < 1.5), small, biased)


def _sandwich(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    """``a @ x @ b.T`` over the last two axes of ``x``, as two GEMMs with
    the leading axes folded into the rows."""
    u = x @ b.T
    return (u.transpose(-1, -2) @ a.T).transpose(-1, -2)


def _dequant_idct(inputs: list, h: int, w: int, dev) -> torch.Tensor:
    """(K, 3, h, w) float32 XYB before the restoration filters."""
    f32 = torch.float32
    k_n = len(inputs)
    yb, xb = inputs[0].dc.shape[1:]
    per_frame = 3 * yb * xb * 64
    vals = torch.from_numpy(np.concatenate(
        [np.asarray(f.coeff_vals) for f in inputs])).to(dev)
    idx = torch.from_numpy(np.concatenate(
        [np.asarray(f.coeff_idx, np.int64) + k * per_frame
         for k, f in enumerate(inputs)])).to(dev)
    q = torch.zeros(k_n * per_frame, dtype=f32, device=dev)
    q.index_add_(0, idx, vals.to(f32))
    biased = _adjust_quant_bias(q.reshape(k_n, 3, yb, xb, 64))
    # dequant: table x qm-scale x per-block scalar
    table = torch.from_numpy(np.asarray(inputs[0].table, np.float32)).to(dev)
    dms = _stack(inputs, "dms", dev, f32)
    tab = table.reshape(1, 3, 1, 1, 64) * dms.reshape(k_n, 3, 1, 1, 1)
    inv_gs = _stack(inputs, "inv_gs", dev, f32)
    raw_quant = _stack(inputs, "raw_quant", dev, f32)
    sd = (inv_gs.reshape(k_n, 1, 1) / raw_quant).reshape(k_n, 1, yb, xb, 1)
    dq = biased * tab * sd
    # chroma from luma per 64x64 tile (chroma_from_luma.h:28)
    ty = torch.arange(yb, device=dev) // 8
    tx = torch.arange(xb, device=dev) // 8
    x_cc = _stack(inputs, "x_cc", dev, f32)
    b_cc = _stack(inputs, "b_cc", dev, f32)
    xc = x_cc[:, ty[:, None], tx[None, :]].reshape(k_n, 1, yb, xb, 1)
    bc = b_cc[:, ty[:, None], tx[None, :]].reshape(k_n, 1, yb, xb, 1)
    y_ch = dq[:, 1:2]
    dq = torch.cat([dq[:, 0:1] + xc * y_ch, y_ch, dq[:, 2:3] + bc * y_ch],
                   dim=1)
    # LLF slot <- DC. A block's 64 coefficients are stored transposed
    # for 8x8 (R >= C): coefficient (k, l) of the 2-D IDCT is slot l*8+k.
    dq[..., 0] = _stack(inputs, "dc", dev, f32)
    # pix[r, c] = sum_{k,l} M[r, k] C[k, l] M[c, l], and the stored
    # 8x8 block is C transposed, so its sandwich is pix transposed
    im = _matrix(idct_matrix(8), dev)
    pix = _sandwich(im, dq.reshape(k_n, 3, yb, xb, 8, 8), im).transpose(
        -1, -2)
    img = pix.permute(0, 1, 2, 4, 3, 5).reshape(k_n, 3, yb * 8, xb * 8)
    return img[:, :, :h, :w]


def _class_pixels(s: int, dq: torch.Tensor, dc: torch.Tensor, fi, fy, fx
                  ) -> torch.Tensor:
    """(n, 3, R, C) pixels of the n blocks of strategy ``s`` from their
    dequantized, chroma-corrected coefficients ``dq`` (n, 3, size) in the
    stored layout and the frames' DC ``dc`` (K, 3, yb, xb)
    (dec_transforms-inl.h:456 TransformToPixels)."""
    dev = dq.device
    if s in _SPECIALS:
        dq[:, :, 0] = dc[fi, :, fy, fx]
        return (dq @ _matrix(inverse_matrix(s), dev).T).reshape(-1, 3, 8, 8)
    nby, nbx = COVERED_Y[s], COVERED_X[s]
    # LLF <- DCT of the block's DC over its covered 8x8 blocks, scaled
    # (dec_transforms-inl.h:691-760 LowestFrequenciesFromDC)
    ay = torch.arange(nby, device=dev)
    ax = torch.arange(nbx, device=dev)
    dcb = dc[fi[:, None, None], :, (fy[:, None] + ay)[:, :, None],
             (fx[:, None] + ax)[:, None, :]].permute(0, 3, 1, 2)
    llf = _sandwich(_matrix(dct_matrix(nby), dev), dcb,
                    _matrix(dct_matrix(nbx), dev))
    llf = llf / _matrix(resample_scales(nby), dev)[:, None] \
        / _matrix(resample_scales(nbx), dev)[None, :]
    # stored (min, max) layout; transposed for R >= C, as is the LLF
    stored = dq.reshape(-1, 3, min(nby, nbx) * 8, max(nby, nbx) * 8)
    if nby >= nbx:
        llf = llf.transpose(2, 3)
    stored[:, :, :llf.shape[2], :llf.shape[3]] = llf
    rc = stored.transpose(2, 3) if nby >= nbx else stored
    return _sandwich(_matrix(idct_matrix(nby * 8), dev), rc,
                     _matrix(idct_matrix(nbx * 8), dev))


def _dequant_idct_var(inputs: list, h: int, w: int, dev) -> torch.Tensor:
    """(K, 3, h, w) float32 XYB of variable-block frames before the
    restoration filters: each strategy class of the batch at its exact
    block count, scattered into the frames by block position."""
    f32 = torch.float32
    k_n = len(inputs)
    yb, xb = inputs[0].dc.shape[1:]
    dc = _stack(inputs, "dc", dev, f32)
    dms = _stack(inputs, "dms", dev, f32)
    inv_gs = _stack(inputs, "inv_gs", dev, f32)
    x_cc = _stack(inputs, "x_cc", dev, f32)
    b_cc = _stack(inputs, "b_cc", dev, f32)
    mats = DequantMatrices()
    # the frames as rows of 8x8 blocks: block (k, by, bx) is row
    # (k * yb + by) * xb + bx
    canvas = torch.zeros((k_n * yb * xb, 3, 8, 8), dtype=f32, device=dev)
    for s in sorted({s for f in inputs for s in f.classes}):
        frames = [k for k, f in enumerate(inputs) if s in f.classes]
        parts = [inputs[k].classes[s] for k in frames]
        nby, nbx = COVERED_Y[s], COVERED_X[s]
        size = nby * nbx * 64
        counts = [len(p[2]) for p in parts]
        firsts = np.cumsum([0] + counts[:-1])
        # the frames' blocks of class s one after another, densified
        q = torch.zeros(sum(counts) * 3 * size, dtype=f32, device=dev)
        q.index_copy_(0, _upload([p[1] + b * 3 * size for p, b in
                                  zip(parts, firsts)], dev),
                      _upload([p[0] for p in parts], dev).to(f32))
        q = q.reshape(-1, 3, size)
        qf = _upload([p[2] for p in parts], dev).to(f32)
        fy = _upload([p[3] for p in parts], dev).to(torch.int64)
        fx = _upload([p[4] for p in parts], dev).to(torch.int64)
        fi = torch.from_numpy(np.repeat(frames, counts)).to(dev)
        # dequant: class table x qm-scale x per-block scalar
        tab = _matrix(mats.table_for_strategy(s).reshape(3, -1), dev)
        dq = _adjust_quant_bias(q) * (tab[None] * dms[fi][:, :, None]) * \
            (inv_gs[fi] / qf)[:, None, None]
        # chroma from luma at the block's 64x64 tile
        xc = x_cc[fi, fy // 8, fx // 8][:, None]
        bc = b_cc[fi, fy // 8, fx // 8][:, None]
        y_ch = dq[:, 1]
        dq = torch.stack([dq[:, 0] + xc * y_ch, y_ch, dq[:, 2] + bc * y_ch],
                         dim=1)
        pix = _class_pixels(s, dq, dc, fi, fy, fx)
        rows = (((fi * yb + fy)[:, None, None]
                 + torch.arange(nby, device=dev)[None, :, None]) * xb
                + fx[:, None, None]
                + torch.arange(nbx, device=dev)[None, None, :])
        canvas.index_copy_(0, rows.reshape(-1), pix.reshape(
            -1, 3, nby, 8, nbx, 8).permute(0, 2, 4, 1, 3, 5).reshape(
                -1, 3, 8, 8))
    img = canvas.reshape(k_n, yb, xb, 3, 8, 8).permute(
        0, 3, 1, 4, 2, 5).reshape(k_n, 3, yb * 8, xb * 8)
    return img[:, :, :h, :w]


def _restore_output(img: torch.Tensor, inputs: list, lf, gab: bool,
                    epf_iters: int, maxval: int, dev, fetch: bool):
    """Gaborish + EPF and the integer output of each frame of ``img``
    (K, 3, h, w); see ``decode_frames_device`` for what comes back."""
    lfp = lf_params(lf, dev)
    raw_quant = _stack(inputs, "raw_quant", dev)
    sharpness = _stack(inputs, "sharpness", dev)
    out = torch.stack([
        output_int(restore(img[k].contiguous(), raw_quant[k], sharpness[k],
                           float(f.quant_scale), lfp, bool(gab),
                           int(epf_iters)), float(f.intensity), int(maxval))
        for k, f in enumerate(inputs)])
    if not fetch:
        return out
    arr = out.cpu().numpy()
    if maxval > 255:
        arr = arr.view(np.uint16)
    return [arr[k] for k in range(len(inputs))]


def decode_frames_device(inputs: list, lf, gab: bool, epf_iters: int,
                         h: int, w: int, maxval: int = 255, device=None,
                         fetch: bool = True):
    """Reconstruct a batch of same-shape frames on ``device``.

    ``inputs`` is a list of per-frame ``FrameRecon`` with numpy leaves.
    Returns one (h, w, 3) numpy image per frame (uint8, or uint16 for
    ``maxval > 255``), or with ``fetch=False`` the (K, h, w, 3) device
    tensor (int16 bit patterns for 16-bit output, see ``output_int``)."""
    dev = resolve_device(device)
    return _restore_output(_dequant_idct(inputs, h, w, dev), inputs, lf,
                           gab, epf_iters, maxval, dev, fetch)


def decode_frames_device_var(inputs: list, lf, gab: bool, epf_iters: int,
                             h: int, w: int, maxval: int = 255, device=None,
                             fetch: bool = True):
    """Reconstruct a batch of same-shape variable-block frames on
    ``device``: ``inputs`` is a list of per-frame ``FrameReconVar`` with
    numpy leaves. Dequantizes with the default tables (the host stage
    sends a stream with other tables to the host decode). Returns what
    ``decode_frames_device`` returns."""
    dev = resolve_device(device)
    return _restore_output(_dequant_idct_var(inputs, h, w, dev), inputs, lf,
                           gab, epf_iters, maxval, dev, fetch)
