"""Non-separable edge-preserving upsampling (reference
``lib/jxl/render_pipeline/stage_upsampling.cc``).

Each output pixel of the NxN phase grid is a 5x5 weighted sum of the
low-res neighborhood, clamped to that neighborhood's [min, max] (the
"no ringing" constraint). Kernels come from a triangular weight
parameterization expanded with 4-fold symmetry
(stage_upsampling.cc:63-86). Fully vectorized: one (N*N, 25) kernel
matrix applied to an im2col of the padded plane — on TPU this is a
single matmul per shift."""

from __future__ import annotations

import numpy as np

from libjxl_torch.render.upsample_weights import (
    K_UP2_WEIGHTS, K_UP4_WEIGHTS, K_UP8_WEIGHTS,
)

_DEFAULTS = {1: K_UP2_WEIGHTS, 2: K_UP4_WEIGHTS, 3: K_UP8_WEIGHTS}


def upsampling_kernels(shift: int, weights=None) -> np.ndarray:
    """-> (N, N, 5, 5) kernel per output phase (stage_upsampling.cc)."""
    weights = weights or _DEFAULTS[shift]
    n = 1 << shift
    h = n // 2
    kernel = np.zeros((n, n, 5, 5), dtype=np.float64)
    for ky in range(h):
        for kx in range(h):
            for py in range(5):
                for px in range(5):
                    j = 5 * ky + py
                    i = 5 * kx + px
                    my, mx = min(i, j), max(i, j)
                    w = weights[5 * h * my - my * (my - 1) // 2 + mx - my]
                    kernel[ky, kx, py, px] = w
                    kernel[ky, n - 1 - kx, py, 4 - px] = w
                    kernel[n - 1 - ky, kx, 4 - py, px] = w
                    kernel[n - 1 - ky, n - 1 - kx, 4 - py, 4 - px] = w
    return kernel


def upsample_plane(plane: np.ndarray, shift: int, weights=None,
                   out_h: int | None = None, out_w: int | None = None
                   ) -> np.ndarray:
    """Upsample (H, W) by 2**shift with the 5x5 phase kernels + clamp."""
    n = 1 << shift
    kern = upsampling_kernels(shift, weights)
    h, w = plane.shape
    p = np.pad(plane, 2, mode="symmetric")
    # 5x5 neighborhood stack: (25, H, W)
    neigh = np.stack([p[dy:dy + h, dx:dx + w]
                      for dy in range(5) for dx in range(5)])
    nmin = neigh.min(axis=0)
    nmax = neigh.max(axis=0)
    # (N*N, 25) @ (25, H*W) -> (N, N, H, W)
    kmat = kern.reshape(n * n, 25)
    out = (kmat @ neigh.reshape(25, -1)).reshape(n, n, h, w)
    out = np.clip(out, nmin[None, None], nmax[None, None])
    # interleave phases: (H*N, W*N)
    out = out.transpose(2, 0, 3, 1).reshape(h * n, w * n)
    if out_h is not None:
        out = out[:out_h, :out_w]
    return out


def upsample_image(img: np.ndarray, shift: int, transform_data=None,
                   out_h: int | None = None, out_w: int | None = None
                   ) -> np.ndarray:
    """Upsample (C, H, W) by 2**shift using header weight overrides."""
    weights = None
    if transform_data is not None:
        weights = {1: transform_data.upsampling2_weights,
                   2: transform_data.upsampling4_weights,
                   3: transform_data.upsampling8_weights}.get(shift)
    return np.stack([upsample_plane(img[c], shift, weights, out_h, out_w)
                     for c in range(img.shape[0])])
