"""The last stage of a recompressed JPEG's device decode: 2x chroma
upsampling, YCbCr to RGB and the 8-bit output, in one CUDA kernel
(``libjxl_torch/csrc/ycbcr.cu``), and its plain PyTorch version, which is
its contract.

``ycbcr420_to_rgb8(y, cb, cr, h, w)`` takes K frames' planes as float32
(K, rows, cols) tensors: ``y`` covers at least h x w, ``cb`` and ``cr``
at least ceil(h / 2) x ceil(w / 2) (the 8x8-block padded planes of the
IDCT). Each chroma plane is cut to that visible size, upsampled 2x
horizontally and then vertically with the 3/4-1/4 taps, the image edge
repeating its last sample (``stage_chroma_upsampling.cc``; the host's
``color/xyb.py`` chroma_upsample), and cut to h x w; YCbCr (full-range
BT.601, buffer order Cb, Y, Cr) becomes RGB (``stage_ycbcr.cc``), and
each sample x 255 is rounded half to even and clamped to 0..255. Returns
(K, h, w, 3) uint8.

The plain version computes in float32 op by op in the host's order; the
kernel makes each of those operations rounded as they are (no fused
multiply-adds), so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

Y_OFFSET = 128.0 / 255
CR_R = 1.402
CB_G = -0.114 * 1.772 / 0.587
CR_G = -0.299 * 1.402 / 0.587
CB_B = 1.772


def _check(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor, h: int,
           w: int) -> None:
    ch, cw = -(-h // 2), -(-w // 2)
    for name, t, need in (("y", y, (h, w)), ("cb", cb, (ch, cw)),
                          ("cr", cr, (ch, cw))):
        if t.dtype != torch.float32 or t.dim() != 3:
            raise ValueError(f"{name} must be (K, rows, cols) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.shape[1] < need[0] or t.shape[2] < need[1] or \
                t.shape[0] != y.shape[0]:
            raise ValueError(f"{name} {tuple(t.shape)} does not cover "
                             f"{need} for {y.shape[0]} frames")
        if t.device != y.device:
            raise ValueError("the planes must be on one device")
    if cb.shape != cr.shape or h < 1 or w < 1:
        raise ValueError("cb and cr must have one shape, h and w >= 1")


def _lib():
    from libjxl_torch.utils.cuda_build import load
    lib = load("ycbcr")
    lib.jxlt_ycbcr420.restype = ctypes.c_int
    lib.jxlt_ycbcr420.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                                  + [ctypes.c_void_p])
    return lib


def ycbcr420_to_rgb8(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                     h: int, w: int) -> torch.Tensor:
    """See the module's docstring. CUDA tensors launch the kernel on the
    current stream (or raise); CPU tensors run ``ycbcr420_to_rgb8_ref``.
    ``ycbcr420_to_rgb8.launches`` counts kernel launches."""
    _check(y, cb, cr, h, w)
    if y.device.type == "cpu":
        return ycbcr420_to_rgb8_ref(y, cb, cr, h, w)
    if y.device.type != "cuda":
        raise ValueError(f"no YCbCr kernel for device {y.device}")
    y, cb, cr = (t.contiguous() for t in (y, cb, cr))
    out = torch.empty((y.shape[0], h, w, 3), dtype=torch.uint8,
                      device=y.device)
    lib = _lib()
    with torch.cuda.device(y.device):
        err = lib.jxlt_ycbcr420(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), out.data_ptr(),
            y.shape[0], h, w, y.shape[1], y.shape[2], cb.shape[1],
            cb.shape[2], torch.cuda.current_stream(y.device).cuda_stream)
    if err:
        raise RuntimeError(f"YCbCr kernel launch failed: CUDA error {err}")
    ycbcr420_to_rgb8.launches += 1
    return out


ycbcr420_to_rgb8.launches = 0


def _upsample2(p: torch.Tensor, dim: int) -> torch.Tensor:
    """2x along ``dim`` with the 3/4-1/4 taps, the edge repeated."""
    n = p.shape[dim]
    prev = p.index_select(dim, (torch.arange(n, device=p.device) - 1)
                          .clamp_min(0))
    nxt = p.index_select(dim, (torch.arange(n, device=p.device) + 1)
                         .clamp_max(n - 1))
    even = 0.75 * p + 0.25 * prev
    odd = 0.75 * p + 0.25 * nxt
    shape = list(p.shape)
    shape[dim] *= 2
    return torch.stack([even, odd], dim + 1).reshape(shape)


def ycbcr420_to_rgb8_ref(y: torch.Tensor, cb: torch.Tensor,
                         cr: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Plain float32 version of the kernel, on any device."""
    _check(y, cb, cr, h, w)
    ch, cw = -(-h // 2), -(-w // 2)
    up = [_upsample2(_upsample2(p[:, :ch, :cw], 2), 1)[:, :h, :w]
          for p in (cb, cr)]
    cbu, cru = up
    yv = y[:, :h, :w] + Y_OFFSET
    r = CR_R * cru + yv
    g = yv + CB_G * cbu + CR_G * cru
    b = CB_B * cbu + yv
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.round(rgb * 255).clamp(0, 255).to(torch.uint8)
