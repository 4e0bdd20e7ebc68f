"""Restoration filter kernels: the CUDA kernels' wrappers and their plain
PyTorch versions (port of ``libjxl_tpu/models/pallas_filters.py``).

Two kernels, one launch per pass (``libjxl_torch/csrc/filters.cu``):

* ``gaborish_filter(x, w0, w1, w2)``: Gaborish, a per-channel 3x3 smooth
  with centre weight ``w0[c]``, edge weight ``w1[c]`` and diagonal weight
  ``w2[c]`` (already divided by ``1 + 4 (w1 + w2)``); reach 1.
* ``epf_filter(x, inv_sigma_block, pass_id, scales, sm, bsm)``: one pass
  of the edge-preserving filter. Pass 0 weighs 12 neighbours of a 5x5
  diamond by plus-shaped SADs (reach 3), pass 1 the 4 direct neighbours
  by plus-shaped SADs (reach 2), pass 2 the 4 direct neighbours by
  centre SADs (reach 1). A neighbour's weight is ``max(1 + SAD *
  inv_sigma * mul, 0)`` with ``mul = bsm`` on 8x8 block-border pixels
  and ``sm`` elsewhere; ``inv_sigma`` is read per 8x8 block. Pixels
  whose ``inv_sigma < K_MIN_SIGMA`` pass through.

``x`` is a contiguous (3, H, W) float32 XYB image. The image edge is
mirrored with edge duplication (numpy's "symmetric" pad), which keeps
reflecting when the reach exceeds the size; torch has no such pad, so
``mirror_pad`` builds it by index arithmetic, as the kernels do.

The plain versions follow the float32 op order of
``libjxl_tpu/render/filters.py`` run with ``xp=jax.numpy``.
"""

from __future__ import annotations

import ctypes

import torch

K_MIN_SIGMA = -3.90524291751269967465540850526868

_PLUS = ((0, -1), (-1, 0), (0, 0), (1, 0), (0, 1))  # (dx, dy)
_NEIGHBORS1 = ((0, -1), (-1, 0), (1, 0), (0, 1))
_NEIGHBORS0 = ((0, -2), (-1, -1), (0, -1), (1, -1), (-2, 0), (-1, 0),
               (1, 0), (2, 0), (-1, 1), (0, 1), (1, 1), (0, 2))
REACH = {"gab": 1, 0: 3, 1: 2, 2: 1}


def mirror_index(n: int, pad: int, device=None) -> torch.Tensor:
    """Source index of each of the ``n + 2 pad`` positions of a
    symmetric-padded axis of size ``n``: the reflection repeats with
    period ``2 n``, so any pad works (numpy's "symmetric" mode)."""
    i = torch.arange(-pad, n + pad, device=device) % (2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def mirror_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad the last two axes of ``x`` by ``pad`` with edge duplication."""
    h, w = x.shape[-2:]
    x = x.index_select(-2, mirror_index(h, pad, x.device))
    return x.index_select(-1, mirror_index(w, pad, x.device))


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[0] != 3:
        raise ValueError(f"x must be (3, H, W) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.shape[1] < 1 or x.shape[2] < 1:
        raise ValueError(f"empty image {tuple(x.shape)}")


def _check_sigma(x: torch.Tensor, inv_sigma_block: torch.Tensor) -> None:
    h, w = x.shape[1:]
    s = inv_sigma_block
    if s.dtype != torch.float32 or s.dim() != 2:
        raise ValueError(f"inv_sigma_block must be 2-D float32, got "
                         f"{tuple(s.shape)} {s.dtype}")
    if s.shape[0] * 8 < h or s.shape[1] * 8 < w:
        raise ValueError(f"inv_sigma_block {tuple(s.shape)} does not cover "
                         f"a {h}x{w} image in 8x8 blocks")
    if s.device != x.device or not s.is_contiguous():
        raise ValueError("inv_sigma_block must be contiguous, on x's device")


def _lib():
    from libjxl_torch.utils.cuda_build import load
    lib = load("filters")
    lib.jxlt_gaborish.restype = ctypes.c_int
    lib.jxlt_gaborish.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                                  + [ctypes.c_float] * 9 + [ctypes.c_void_p])
    lib.jxlt_epf.restype = ctypes.c_int
    lib.jxlt_epf.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                             + [ctypes.c_float] * 5 + [ctypes.c_void_p])
    return lib


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def gaborish_filter(x: torch.Tensor, w0, w1, w2) -> torch.Tensor:
    """Gaborish of a (3, H, W) float32 image; ``w0``, ``w1``, ``w2`` are
    per-channel normalised weights. A CUDA tensor launches the kernel on
    the current stream (or raises); a CPU tensor runs ``gaborish_ref``.
    ``gaborish_filter.launches`` counts kernel launches."""
    _check(x)
    if x.device.type == "cpu":
        return gaborish_ref(x, w0, w1, w2)
    if x.device.type != "cuda":
        raise ValueError(f"no Gaborish kernel for device {x.device}")
    lib = _lib()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.jxlt_gaborish(x.data_ptr(), out.data_ptr(), x.shape[1],
                                x.shape[2], *w0, *w1, *w2, _stream(x))
    if err:
        raise RuntimeError(f"Gaborish kernel launch failed: CUDA error {err}")
    gaborish_filter.launches += 1
    return out


gaborish_filter.launches = 0


def epf_filter(x: torch.Tensor, inv_sigma_block: torch.Tensor, pass_id: int,
               scales, sm: float, bsm: float) -> torch.Tensor:
    """One EPF pass (0, 1 or 2) of a (3, H, W) float32 image with the
    per-8x8-block ``inv_sigma_block``; ``scales`` are the three channel
    scales, ``sm``/``bsm`` the SAD multipliers inside/on block borders.
    A CUDA tensor launches the kernel on the current stream (or raises);
    a CPU tensor runs ``epf_ref``. ``epf_filter.launches`` counts kernel
    launches, ``epf_filter.pass_launches[p]`` those of pass ``p``."""
    if pass_id not in (0, 1, 2):
        raise ValueError(f"EPF pass must be 0, 1 or 2, got {pass_id}")
    _check(x)
    _check_sigma(x, inv_sigma_block)
    if x.device.type == "cpu":
        return epf_ref(x, inv_sigma_block, pass_id, scales, sm, bsm)
    if x.device.type != "cuda":
        raise ValueError(f"no EPF kernel for device {x.device}")
    lib = _lib()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.jxlt_epf(x.data_ptr(), inv_sigma_block.data_ptr(),
                           out.data_ptr(), x.shape[1], x.shape[2],
                           inv_sigma_block.shape[1], pass_id, *scales, sm,
                           bsm, _stream(x))
    if err:
        raise RuntimeError(f"EPF kernel launch failed: CUDA error {err}")
    epf_filter.launches += 1
    epf_filter.pass_launches[pass_id] += 1
    return out


epf_filter.launches = 0
epf_filter.pass_launches = [0, 0, 0]


def _shift(p: torch.Tensor, dx: int, dy: int, pad: int, h: int, w: int):
    return p[:, pad + dy:pad + dy + h, pad + dx:pad + dx + w]


def gaborish_ref(x: torch.Tensor, w0, w1, w2) -> torch.Tensor:
    """Plain float32 version of the Gaborish kernel, on any device."""
    _, h, w = x.shape
    col = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                                 device=x.device)[:, None, None]
    p = mirror_pad(x, 1)
    sh = lambda dy, dx: _shift(p, dx, dy, 1, h, w)  # noqa: E731
    return (col(w0) * sh(0, 0) +
            col(w1) * (sh(-1, 0) + sh(1, 0) + sh(0, -1) + sh(0, 1)) +
            col(w2) * (sh(-1, -1) + sh(-1, 1) + sh(1, -1) + sh(1, 1)))


def _sad_mul(h: int, w: int, sm: float, bsm: float, device):
    """Per-pixel SAD multiplier: block-border rows/cols get ``bsm``."""
    f32 = dict(dtype=torch.float32, device=device)
    ix = torch.arange(w, device=device) % 8
    iy = torch.arange(h, device=device) % 8
    xb = (ix == 0) | (ix == 7)
    yb = (iy == 0) | (iy == 7)
    xmul = torch.where(xb, torch.tensor(bsm, **f32), torch.tensor(sm, **f32))
    return torch.where(yb[:, None], torch.tensor(bsm, **f32), xmul[None, :])


def epf_ref(x: torch.Tensor, inv_sigma_block: torch.Tensor, pass_id: int,
            scales, sm: float, bsm: float) -> torch.Tensor:
    """Plain float32 version of the EPF kernel, on any device."""
    _, h, w = x.shape
    plus = pass_id != 2
    neighbors = _NEIGHBORS0 if pass_id == 0 else _NEIGHBORS1
    pad = 4 if plus else 2
    p = mirror_pad(x, pad)
    sc = torch.tensor(scales, dtype=torch.float32,
                      device=x.device)[:, None, None]
    isig_block = inv_sigma_block.repeat_interleave(8, 0).repeat_interleave(
        8, 1)[:h, :w]
    skip = isig_block < K_MIN_SIGMA
    isig = isig_block * _sad_mul(h, w, sm, bsm, x.device)
    wsum = torch.ones((h, w), dtype=torch.float32, device=x.device)
    acc = x
    for dx, dy in neighbors:
        if plus:
            # |x(p+n+o) - x(p+o)| is the abs-diff plane of neighbour n at
            # p+o, so the plus-SAD is a 5-tap box over one plane
            y0 = x0 = pad - 2
            a = p[:, y0 + dy:y0 + dy + h + 4, x0 + dx:x0 + dx + w + 4]
            b = p[:, y0:y0 + h + 4, x0:x0 + w + 4]
            ad = (sc * (a - b).abs()).sum(dim=0)
            sad = torch.zeros((h, w), dtype=torch.float32, device=x.device)
            for ox, oy in _PLUS:
                sad = sad + ad[2 + oy:2 + oy + h, 2 + ox:2 + ox + w]
        else:
            sad = (sc * (_shift(p, dx, dy, pad, h, w) - x).abs()).sum(dim=0)
        weight = (1.0 + sad * isig).clamp_min(0.0)
        wsum = wsum + weight
        acc = acc + weight[None] * _shift(p, dx, dy, pad, h, w)
    return torch.where(skip[None], x, acc / wsum)
