"""The e<=4 VarDCT encode on the device (port of
``libjxl_tpu/models/vardct_pipeline.py``).

The pixel-parallel half of the lossy encode runs as plain torch on a
batch of same-shape images (the reference fuses it with XLA; it has no
Pallas kernel):

    sRGB -> linear -> XYB -> 8x8 DCT (two GEMMs) -> dead-zone
    quantization of Y -> Y round trip -> chroma-from-luma least squares
    per 64x64 tile -> quantization of X and B -> DC

The host receives the nonzero quantized AC values with their flat
indices, at their exact count, plus the quantized DC and the CfL maps,
and runs context modeling and entropy coding (``vardct/frame_enc.py``).
Float math is float32 with TF32 off, and every division is a true
division on the card too (PyTorch's CUDA division by a Python number
multiplies by its reciprocal instead). Two steps are computed so that
they do not depend on a library's float32 pow: the sRGB transfer curve
is a 256-entry table (the base in float32, the power in float64, rounded
once), and the cube root is a Newton step in float64 from ``pow(x,
1/3)``, rounded once: torch has no cbrt, and float32 ``pow(x, 1/3)`` is
off by an ulp on a share of inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from libjxl_torch.config import resolve_device
from libjxl_torch.vardct.dct import dct_matrix

_OPSIN = np.array([
    [0.30, 1.0 - 0.078 - 0.30, 0.078],
    [0.23, 1.0 - 0.078 - 0.23, 0.078],
    [0.24342268924547819, 0.20476744424496821,
     1.0 - 0.24342268924547819 - 0.20476744424496821]], dtype=np.float32)
_BIAS = 0.0037930732552754493
_NEG_BIAS_CBRT = -(_BIAS ** (1.0 / 3.0))
_K_BIASES = (1.0 - 0.05465007330715401, 1.0 - 0.07005449891748593,
             1.0 - 0.049935103337343655, 0.145)
_COLOR_SCALE = 1.0 / 84.0
_f32 = torch.float32


class LossyPayload(NamedTuple):
    """What the device sends the host for one image: the nonzero
    quantized AC coefficients as flat indices into (yb, xb, 3, 64) with
    their int16 values, the quantized DC (yb, xb, 3), and the CfL maps
    (ty, tx). Tensors on the device until ``unpack_lossy_outputs``
    fetches them, or numpy once fetched."""

    idx: object
    vals: object
    q_dc: object
    ytox: object
    ytob: object


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """The float32 cube root of a positive float32 tensor, correctly
    rounded: one Newton step from ``pow(x, 1/3)``, in float64."""
    y = x.pow(1.0 / 3.0).double()
    xd = x.double()
    return (y - (y * y * y - xd) / (3.0 * y * y)).to(_f32)


def _srgb_table(dev) -> torch.Tensor:
    """sRGB -> linear for the 256 uint8 values: the float32 curve
    ``((v + 0.055) / 1.055) ** 2.4`` with its power correctly rounded
    (exponent float32(2.4), evaluated in float64). Built on the CPU and
    moved to ``dev``: a CUDA tensor divided by a Python number is
    multiplied by the number's float32 reciprocal, which is not the
    correctly rounded quotient."""
    srgb = torch.arange(256, dtype=_f32) / 255.0
    curve = ((srgb + 0.055) / 1.055).double().pow(
        float(np.float32(2.4))).to(_f32)
    return torch.where(srgb <= 0.04045, srgb / 12.92, curve).to(dev)


def srgb_to_xyb_device(rgb_u8: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) uint8 sRGB -> XYB float32 (enc_xyb.cc), the opsin
    mix as explicit multiply-adds."""
    linear = _srgb_table(rgb_u8.device).index_select(
        0, rgb_u8.reshape(-1).to(torch.int32)).reshape(rgb_u8.shape)
    r, g, b = linear.unbind(-3)
    mixed = [float(m[0]) * r + float(m[1]) * g + float(m[2]) * b + _BIAS
             for m in _OPSIN]
    g0, g1, g2 = (cbrt(m.clamp_min(1e-12)) + _NEG_BIAS_CBRT for m in mixed)
    return torch.stack([0.5 * (g0 - g1), 0.5 * (g0 + g1), g2], dim=-3)


def _adjust_quant_bias(q: torch.Tensor, c: int) -> torch.Tensor:
    """quantizer-inl.h:35-60 for channel ``c``: 0 -> 0, +-1 ->
    +-bias_c, else q - bias3 / q."""
    absq = q.abs()
    out = q - _K_BIASES[3] / torch.where(q == 0, 1.0, q)
    out = torch.where(absq < 0.5, 0.0, out)
    return torch.where((absq > 0.5) & (absq < 1.5),
                       torch.sign(q) * _K_BIASES[c], out)


def dct_stored(xyb: torch.Tensor, h: int, w: int, yb: int, xb: int
               ) -> torch.Tensor:
    """(B, 3, h, w) XYB -> (B, yb, xb, 3, 64) 8x8 DCT coefficients in the
    stored (transposed) layout: the image padded to whole blocks by
    repeating its last row and column, two float32 GEMMs a block."""
    n = xyb.shape[0]
    xyb = F.pad(xyb, (0, xb * 8 - w, 0, yb * 8 - h), mode="replicate")
    blocks = xyb.reshape(n, 3, yb, 8, xb, 8).permute(0, 2, 4, 1, 3, 5)
    m8 = torch.tensor(dct_matrix(8), dtype=_f32, device=xyb.device)
    coef = torch.matmul(torch.matmul(m8, blocks), m8.T)
    return coef.transpose(-1, -2).reshape(n, yb, xb, 3, 64)


def _frame_body(px: torch.Tensor, qac, inv_qac, table, thres_y, thres_xb,
                mul_dc, h: int, w: int, yb: int, xb: int, x_qm_mul: float):
    """The e<=4 encode math of a batch: sRGB -> XYB, the 8x8 DCT,
    dead-zone quantization with the Y round trip, per-64x64-tile
    chroma-from-luma least squares and the DC (enc_xyb.cc,
    enc_group.cc:329-520, enc_chroma_from_luma.cc).

    px: (B, h, w, 3) uint8; qac, inv_qac: (yb, xb) float32 AC quant and
    dequant steps; table: (3, 64) dequant weights (stored layout);
    thres_*: (64,) dead-zone thresholds; mul_dc: (3,) DC steps. Returns
    (q_ac (B, yb, xb, 3, 64) int32 with the DC slot zero, q_dc (B, yb,
    xb, 3) int32, ytox, ytob (B, ty, tx) int32)."""
    n = px.shape[0]
    stored = dct_stored(srgb_to_xyb_device(px.permute(0, 3, 1, 2)),
                        h, w, yb, xb)

    inv_table = 1.0 / table
    qac3 = qac[:, :, None]

    def quantize(c, coefs, qm_mul, thres):
        val = coefs * (inv_table[c] * (qac3 * qm_mul))
        return torch.where(val.abs() >= thres, torch.round(val), 0.0)

    q_y = quantize(1, stored[:, :, :, 1], 1.0, thres_y)
    y_rt = _adjust_quant_bias(q_y, 1) * (table[1] * inv_qac[:, :, None])

    # CfL per 64x64 tile, least squares (zero-padded tiles: zeros do not
    # move the dot products)
    ty_n, tx_n = -(-yb // 8), -(-xb // 8)

    def tiled(a):                               # (B, yb, xb, 63)
        a = F.pad(a, (0, 0, 0, tx_n * 8 - xb, 0, ty_n * 8 - yb))
        return a.reshape(n, ty_n, 8, tx_n, 8, 63)

    yt = tiled(y_rt[..., 1:])
    xt = tiled(stored[:, :, :, 0, 1:])
    bt = tiled(stored[:, :, :, 2, 1:])
    dims = (2, 4, 5)
    denom = (yt * yt).sum(dims)
    dx = (xt * yt).sum(dims)
    db = (bt * yt).sum(dims)
    safe = denom.clamp_min(1e-9)
    # a tensor divisor: a Python one would make CUDA multiply by its
    # reciprocal (see _srgb_table)
    scale = torch.tensor(_COLOR_SCALE, dtype=_f32, device=px.device)
    ytox = torch.where(denom < 1e-9, 0.0, torch.clamp(
        torch.round(dx / safe / scale), -128, 127))
    ytob = torch.where(denom < 1e-9, 0.0, torch.clamp(
        torch.round((db / safe - 1.0) / scale), -128, 127))

    def per_block(t):                           # (B, ty, tx) -> (B, yb, xb)
        return t.repeat_interleave(8, 1).repeat_interleave(8, 2)[
            :, :yb, :xb]

    fx_full = per_block(ytox) * _COLOR_SCALE
    fb_full = 1.0 + per_block(ytob) * _COLOR_SCALE
    x_res = stored[:, :, :, 0] - fx_full[..., None] * y_rt
    b_res = stored[:, :, :, 2] - fb_full[..., None] * y_rt
    q_x = quantize(0, x_res, x_qm_mul, thres_xb)
    q_b = quantize(2, b_res, 1.0, thres_xb)
    q_ac = torch.stack([q_x, q_y, q_b], dim=3)
    # the DC slot never feeds the AC tokenizer (order[1:])
    q_ac[..., 0] = 0.0
    q_ac = q_ac.clamp(-32768, 32767).to(torch.int32)
    # DC (the decoder adds cfl_dc_factor 1.0 x dequantized Y to B)
    q_dc_y = torch.round(stored[:, :, :, 1, 0] / mul_dc[1])
    dcy_deq = q_dc_y * mul_dc[1]
    q_dc_x = torch.round(stored[:, :, :, 0, 0] / mul_dc[0])
    q_dc_b = torch.round((stored[:, :, :, 2, 0] - dcy_deq) / mul_dc[2])
    q_dc = torch.stack([q_dc_x, q_dc_y, q_dc_b], -1).to(torch.int32)
    return q_ac, q_dc, ytox.to(torch.int32), ytob.to(torch.int32)


def _upload(a, dev, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t if dtype is None else t.to(dtype)


def _frames(pixels_u8_b, qac, inv_qac, table, thres_y, thres_xb, mul_dc,
            h, w, yb, xb, x_qm_mul, device) -> tuple:
    """_frame_body on ``device``. Returns (idx, vals, counts, q_dc, ytox,
    ytob): the nonzero quantized AC values of the batch, image after
    image, with their flat indices within their image, and how many
    each image has."""
    dev = resolve_device(device)
    q_ac, q_dc, ytox, ytob = _frame_body(
        _upload(pixels_u8_b, dev), _upload(qac, dev, _f32),
        _upload(inv_qac, dev, _f32), _upload(table, dev, _f32),
        _upload(thres_y, dev, _f32), _upload(thres_xb, dev, _f32),
        _upload(mul_dc, dev, _f32), h, w, yb, xb, x_qm_mul)
    n = q_ac.shape[0]
    flat = q_ac.reshape(n, -1)
    img, idx = torch.nonzero(flat, as_tuple=True)
    vals = flat[img, idx].to(torch.int16)
    idx = idx.to(torch.int32 if flat.shape[1] < 2 ** 31 else torch.int64)
    counts = torch.bincount(img, minlength=n).tolist()
    return idx, vals, counts, q_dc, ytox, ytob


def encode_lossy_frame_device(pixels_u8, qac, inv_qac, table, thres_y,
                              thres_xb, mul_dc, h: int, w: int, yb: int,
                              xb: int, x_qm_mul: float, device=None
                              ) -> LossyPayload:
    """The e<=4 VarDCT encode math of one image on ``device`` (see
    ``_frame_body``). pixels_u8: (h, w, 3) uint8 sRGB; the other inputs
    are numpy. Returns the image's payload, still on the device."""
    idx, vals, _, q_dc, ytox, ytob = _frames(
        np.asarray(pixels_u8)[None], qac, inv_qac, table, thres_y,
        thres_xb, mul_dc, h, w, yb, xb, x_qm_mul, device)
    return LossyPayload(idx, vals, q_dc[0], ytox[0], ytob[0])


def encode_lossy_frame_device_batch(pixels_u8_b, qac, inv_qac, table,
                                    thres_y, thres_xb, mul_dc, h: int,
                                    w: int, yb: int, xb: int,
                                    x_qm_mul: float, device=None) -> list:
    """The same for a batch of same-shape images, (B, h, w, 3) uint8,
    that share one quant field (the e<=4 field is constant): one
    program over the batch, and one fetch of each payload array for the
    whole batch. Returns one numpy payload per image."""
    idx, vals, counts, *maps = _frames(
        pixels_u8_b, qac, inv_qac, table, thres_y, thres_xb, mul_dc, h, w,
        yb, xb, x_qm_mul, device)
    cuts = np.cumsum(counts)[:-1]
    idx, vals = (np.split(t.cpu().numpy(), cuts) for t in (idx, vals))
    q_dc, ytox, ytob = (t.cpu().numpy() for t in maps)
    return [LossyPayload(*f) for f in zip(idx, vals, q_dc, ytox, ytob)]


def encode_lossy_frame_device_sharded(pixels: np.ndarray, qac: np.ndarray,
                                      inv_qac: np.ndarray, table, thres_y,
                                      thres_xb, mul_dc, h: int, w: int,
                                      yb: int, xb: int, x_qm_mul: float,
                                      mesh=None):
    """Multi-device VarDCT encode: the SAME ``_frame_body`` math run on
    row bands, one per slot of ``mesh`` (default: one slot per visible
    device of ``config.device``), each on its slot's device (the
    production analog of the reference's per-group RunOnPool loop,
    enc_frame.cc:1232).

    Every step is block/tile-local, so bands need no exchange at all;
    bands are 64-pixel (one CfL tile row) aligned, and the outputs are
    bit-identical to the single-device program. Returns numpy (q_ac
    (yb, xb, 3, 64) i32, q_dc (yb, xb, 3) i32, ytox, ytob), what
    ``unpack_lossy_outputs`` returns. The reference can also hand back
    its compiled HLO (``hlo_out``) to show that no collective runs;
    here the bands share nothing but their inputs, so there is no
    program to audit and no such argument.
    ``encode_lossy_frame_device_sharded.calls`` counts the runs."""
    from libjxl_torch.parallel.mesh import make_mesh

    mesh = mesh or make_mesh()
    n = mesh.size
    # pad: real image -> block grid (edge, same as the one-device
    # program), then BLACK to a whole number of 64px bands per slot:
    # XYB(black) is exactly 0 (opsin bias construction), so padded blocks
    # add zeros to the CfL tile dot products, matching the one-device
    # program's zero-padded partial tiles bit for bit
    band = 64 * n
    hp_ = ((yb * 8 + band - 1) // band) * band
    yb_p = hp_ // 8
    px = np.pad(np.asarray(pixels)[:, :, :3],
                ((0, yb * 8 - h), (0, xb * 8 - w), (0, 0)), mode="edge")
    px = np.pad(px, ((0, hp_ - yb * 8), (0, 0), (0, 0)))
    qac_p = np.ones((yb_p, xb), np.float32)
    qac_p[:yb, :] = qac
    iq_p = np.ones((yb_p, xb), np.float32)
    iq_p[:yb, :] = inv_qac
    ys = hp_ // n
    ybs = yb_p // n
    encode_lossy_frame_device_sharded.calls += 1
    outs = []
    for i, dev in enumerate(mesh.slots):
        outs.append(_frame_body(
            _upload(px[None, i * ys:(i + 1) * ys], dev),
            _upload(qac_p[i * ybs:(i + 1) * ybs], dev),
            _upload(iq_p[i * ybs:(i + 1) * ybs], dev),
            _upload(table, dev, _f32), _upload(thres_y, dev, _f32),
            _upload(thres_xb, dev, _f32), _upload(mul_dc, dev, _f32),
            ys, xb * 8, ybs, xb, x_qm_mul))
    q_ac, q_dc, ytox, ytob = (
        np.concatenate([o[k][0].cpu().numpy() for o in outs])
        for k in range(4))
    ty_n, tx_n = -(-yb // 8), -(-xb // 8)
    return q_ac[:yb], q_dc[:yb], ytox[:ty_n, :tx_n], ytob[:ty_n, :tx_n]


encode_lossy_frame_device_sharded.calls = 0


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def unpack_lossy_outputs(payload: LossyPayload, yb: int, xb: int):
    """(q_ac (yb, xb, 3, 64) int32, q_dc (yb, xb, 3) int32, ytox, ytob
    (ty, tx) int32) of one image's payload, fetched to the host."""
    q = np.zeros(yb * xb * 3 * 64, np.int32)
    q[_host(payload.idx).astype(np.int64)] = _host(payload.vals)
    return (q.reshape(yb, xb, 3, 64), _host(payload.q_dc),
            _host(payload.ytox), _host(payload.ytob))


def vardct_encode_device(groups_u8: torch.Tensor, dequant_step: torch.Tensor,
                         inv_dc_step: torch.Tensor):
    """The VarDCT encode step of the graft entry, on the groups' device.

    groups_u8: (G, 3, gd, gd) uint8 sRGB groups (gd a multiple of 8);
    dequant_step: (3, 64) float32 per-coefficient dequant step (stored
    layout); inv_dc_step: (3,) float32 1/mul_dc; both on the groups'
    device. Returns (q_ac (G, 3, nb, 64) int16, q_dc (G, 3, nby, nbx)
    int16): XYB with B stored as B - Y (the CfL base ratio 1), the 8x8
    DCT, the AC divided by its step and the DC multiplied by its inverse
    step, each rounded half to even."""
    g, _, gd, _ = groups_u8.shape
    nb = gd // 8
    x, y, b = srgb_to_xyb_device(groups_u8).unbind(1)
    xyb = torch.stack([x, y, b - y], dim=1)
    stored = dct_stored(xyb, gd, gd, nb, nb)
    q_ac = torch.round(stored / dequant_step)      # a true division
    q_ac = q_ac.permute(0, 3, 1, 2, 4).reshape(g, 3, nb * nb, 64)
    q_dc = torch.round(stored[..., 0] * inv_dc_step).permute(0, 3, 1, 2)
    return q_ac.to(torch.int16), q_dc.to(torch.int16)
