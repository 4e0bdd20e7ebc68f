"""Modular integer ops on tensors (port of ``libjxl_tpu/ops/modular_ops.py``).

Arrays keep the reference layout, ``(groups, channels, gd, gd)``, and the
reference's integer semantics exactly. Values the reference holds as
uint32 are held here as int64 (or int32 where they fit): PyTorch's uint32
is a storage-only dtype whose shifts and compares raise on the CPU.

Reference semantics: ``lib/jxl/modular/transform/rct.cc`` (forward RCT),
``lib/jxl/modular/encoding/context_predict.h:385-398`` (ClampedGradient),
``lib/jxl/pack_signed.h``, ``lib/jxl/dec_ans.h:69-103`` (hybrid uint).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_U32 = 0xFFFFFFFF


def fwd_ycocg(rgb: torch.Tensor) -> torch.Tensor:
    """Forward YCoCg RCT; channels-first (..., 3, h, w) integers."""
    r, g, b = rgb[..., 0, :, :], rgb[..., 1, :, :], rgb[..., 2, :, :]
    co = r - b
    tmp = b + (co >> 1)
    cg = g - tmp
    y = tmp + (cg >> 1)
    return torch.stack([y, co, cg], dim=-3)


def inv_ycocg(ycc: torch.Tensor) -> torch.Tensor:
    y, co, cg = ycc[..., 0, :, :], ycc[..., 1, :, :], ycc[..., 2, :, :]
    tmp = y - (cg >> 1)
    g = cg + tmp
    b = tmp - (co >> 1)
    r = b + co
    return torch.stack([r, g, b], dim=-3)


def clamped_gradient(n: torch.Tensor, w: torch.Tensor, l: torch.Tensor
                     ) -> torch.Tensor:
    m = torch.minimum(n, w)
    M = torch.maximum(n, w)
    return torch.where(l < m, M, torch.where(l > M, m, n + w - l))


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``x`` moved down ``dy`` rows and right ``dx`` columns, zero-filled."""
    h, w = x.shape[-2:]
    return F.pad(x[..., :h - dy, :w - dx], (dx, 0, dy, 0))


def gradient_residuals(plane: torch.Tensor) -> torch.Tensor:
    """Residuals v - ClampedGradient(N, W, NW) with the modular edge rules
    (W at x=0 is N; N at y=0 is W; NW falls back to W). plane: (..., h, w).
    The rules apply in the reference's order: left, then top, then NW."""
    left = _shift(plane, 0, 1)
    top = _shift(plane, 1, 0)
    left[..., :, 0] = top[..., :, 0]
    top[..., 0, :] = left[..., 0, :]
    nw = _shift(plane, 1, 1)
    nw[..., :, 0] = left[..., :, 0]
    nw[..., 0, :] = left[..., 0, :]
    return plane - clamped_gradient(top, left, nw)


def pack_signed(v: torch.Tensor) -> torch.Tensor:
    """X>=0 -> 2X ; -X -> 2X-1. Same dtype as ``v`` (the reference's
    uint32; real residuals pack below 2^20)."""
    return torch.where(v >= 0, v * 2, -v * 2 - 1)


def floor_log2(v: torch.Tensor) -> torch.Tensor:
    """Floor log2 of ``v`` read as uint32 (0 -> 0); int32 result.
    Taken from the float64 exponent, which is exact below 2^53."""
    x = ((v.to(torch.int64) & _U32).clamp(min=1)).to(torch.float64)
    return (torch.frexp(x).exponent - 1).to(torch.int32)


def hybrid_uint_tokenize(values: torch.Tensor, split_exponent: int = 4,
                         msb_in_token: int = 2, lsb_in_token: int = 0):
    """Vectorized hybrid-uint encoding -> (token int32, nbits int32,
    bits int64)."""
    v = values.to(torch.int64) & _U32
    split_token = 1 << split_exponent
    small = v < split_token
    n = floor_log2(v.clamp(min=1)).to(torch.int64)
    mant = v - (torch.ones_like(n) << n)
    tok_big = (split_token
               + ((n - split_exponent) << (msb_in_token + lsb_in_token))
               + ((mant >> (n - msb_in_token).clamp(min=0)) << lsb_in_token)
               + (mant & ((1 << lsb_in_token) - 1)))
    nbits_big = n - msb_in_token - lsb_in_token
    bits_big = (v >> lsb_in_token) & (
        (torch.ones_like(n) << nbits_big.clamp(0, 31)) - 1)
    token = torch.where(small, v, tok_big).to(torch.int32)
    nbits = torch.where(small, 0, nbits_big).to(torch.int32)
    bits = torch.where(small, 0, bits_big)
    return token, nbits, bits


def token_histogram(tokens: torch.Tensor, mask: torch.Tensor,
                    alphabet_size: int = 256) -> torch.Tensor:
    """Masked histogram of token values (clamped into the alphabet).
    Masked-out positions go to one extra bin that is dropped."""
    m = torch.broadcast_to(mask, tokens.shape)
    t = torch.where(m, tokens.clamp(0, alphabet_size - 1), alphabet_size)
    return torch.bincount(t.reshape(-1),
                          minlength=alphabet_size + 1)[:alphabet_size]


def image_to_groups(img: torch.Tensor, group_dim: int):
    """(C, H, W) -> (G, C, gd, gd) edge-padded groups + validity mask."""
    c, h, w = img.shape
    gy = -(-h // group_dim)
    gx = -(-w // group_dim)
    ph, pw = gy * group_dim, gx * group_dim
    ry = torch.arange(ph, device=img.device).clamp(max=h - 1)
    rx = torch.arange(pw, device=img.device).clamp(max=w - 1)
    img_p = img[:, ry][:, :, rx]
    groups = img_p.reshape(c, gy, group_dim, gx, group_dim)
    groups = groups.permute(1, 3, 0, 2, 4).reshape(
        gy * gx, c, group_dim, group_dim)
    yy = torch.arange(ph, device=img.device).reshape(gy, group_dim)
    xx = torch.arange(pw, device=img.device).reshape(gx, group_dim)
    mask = (yy[:, None, :, None] < h) & (xx[None, :, None, :] < w)
    mask = mask.reshape(gy * gx, 1, group_dim, group_dim)
    return groups, mask


def groups_to_image(groups: torch.Tensor, h: int, w: int, group_dim: int
                    ) -> torch.Tensor:
    """Inverse of image_to_groups (crops padding)."""
    _, c, gd, _ = groups.shape
    gy = -(-h // group_dim)
    gx = -(-w // group_dim)
    img = groups.reshape(gy, gx, c, gd, gd).permute(2, 0, 3, 1, 4)
    img = img.reshape(c, gy * gd, gx * gd)
    return img[:, :h, :w]
