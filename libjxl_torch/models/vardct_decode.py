"""VarDCT frame reconstruction on the device (port of
``libjxl_tpu/models/vardct_decode.py``, the DCT8 4:4:4 serving shape).

The host parses each stream and decodes its AC tokens natively into
sparse (flat index, value) pairs (``api/decoder._device_decode_inputs``);
everything pixel-shaped then runs on the device for a batch of
same-shape frames:

    sparse scatter -> AdjustQuantBias -> dequant -> chroma from luma
    -> IDCT8 -> Gaborish + EPF (CUDA kernels) -> inverse XYB -> sRGB
    -> integer

The reference shipped the batch as one int32 blob padded to power-of-two
buckets, with int16 values and int32 indices, for a slow development
link and its compile cache. Here each leaf is uploaded as it is and the
flat indices are int64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from libjxl_torch.config import resolve_device
from libjxl_torch.render.filters_torch import lf_params, output_int, restore
from libjxl_torch.vardct.dct import idct_matrix
from libjxl_torch.vardct.frame_dec import K_BIASES


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


def _stack(inputs: list, name: str, dev, dtype=None) -> torch.Tensor:
    arr = np.stack([np.asarray(getattr(f, name)) for f in inputs])
    t = torch.from_numpy(arr)
    return (t if dtype is None else t.to(dtype)).to(dev)


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
    q = q.reshape(k_n, 3, yb, xb, 64)
    # AdjustQuantBias (quantizer-inl.h:35-60)
    absq = q.abs()
    biased = q - K_BIASES[3] / torch.where(q == 0, 1.0, q)
    biased = torch.where(absq < 0.5, 0.0, biased)
    small = torch.sign(q) * torch.tensor(K_BIASES[:3], dtype=f32,
                                         device=dev).reshape(1, 3, 1, 1, 1)
    biased = torch.where((absq > 0.5) & (absq < 1.5), small, biased)
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
    # pix[r, c] = sum_{k,l} M[r, k] C[k, l] M[c, l] as two plain GEMMs
    im = torch.from_numpy(idct_matrix(8).astype(np.float32)).to(dev)
    u = dq.reshape(-1, 8) @ im.T                         # rows (n, l)
    u = u.reshape(-1, 8, 8).transpose(1, 2).reshape(-1, 8)  # rows (n, r)
    pix = (u @ im.T).reshape(k_n, 3, yb, xb, 8, 8)       # [.., r, c]
    img = pix.permute(0, 1, 2, 4, 3, 5).reshape(k_n, 3, yb * 8, xb * 8)
    return img[:, :, :h, :w]


def decode_frames_device(inputs: list, lf, gab: bool, epf_iters: int,
                         h: int, w: int, maxval: int = 255, device=None,
                         fetch: bool = True):
    """Reconstruct a batch of same-shape frames on ``device``.

    ``inputs`` is a list of per-frame ``FrameRecon`` with numpy leaves.
    Returns one (h, w, 3) numpy image per frame (uint8, or uint16 for
    ``maxval > 255``), or with ``fetch=False`` the (K, h, w, 3) device
    tensor (int16 bit patterns for 16-bit output, see ``output_int``)."""
    dev = resolve_device(device)
    img = _dequant_idct(inputs, h, w, dev)
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
