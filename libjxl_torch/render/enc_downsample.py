"""Encoder-side image downsampling for resampling mode (cjxl -r 2/4/8).

The reference downsamples the opsin image inside its heuristics
(``enc_heuristics.cc:279-421`` DownsampleImage2_Sharper for 2x — a
12x12 kernel optimized against the decoder's 2x upsampler, with
ringing clamped toward the local 2x2 box bounds by an edge-activity
mask — and the plain partial-box mean ``image_ops.cc:44-68``
DownsampleImage for 4x/8x). The decoder upsamples back with the
signaled default weights (render/upsample.py).
"""

from __future__ import annotations

import numpy as np

# enc_heuristics.cc:283-332 (constant table; optimized offline against
# the decoder's upsampling kernel)
_K2 = np.array([
    -0.000314256996835, -0.000314256996835, -0.000897597057705,
    -0.000562751488849, -0.000176807273646, 0.001864627368902,
    0.001864627368902, -0.000176807273646, -0.000562751488849,
    -0.000897597057705, -0.000314256996835, -0.000314256996835,
    -0.000314256996835, -0.001527942804748, -0.000121760530512,
    0.000191123989093, 0.010193185932466, 0.058637519197110,
    0.058637519197110, 0.010193185932466, 0.000191123989093,
    -0.000121760530512, -0.001527942804748, -0.000314256996835,
    -0.000897597057705, -0.000121760530512, 0.000946363683751,
    0.007113577630288, 0.000437956841058, -0.000372823835211,
    -0.000372823835211, 0.000437956841058, 0.007113577630288,
    0.000946363683751, -0.000121760530512, -0.000897597057705,
    -0.000562751488849, 0.000191123989093, 0.007113577630288,
    0.044592622228814, 0.000222278879007, -0.162864473015945,
    -0.162864473015945, 0.000222278879007, 0.044592622228814,
    0.007113577630288, 0.000191123989093, -0.000562751488849,
    -0.000176807273646, 0.010193185932466, 0.000437956841058,
    0.000222278879007, -0.000913092543974, -0.017071696107902,
    -0.017071696107902, -0.000913092543974, 0.000222278879007,
    0.000437956841058, 0.010193185932466, -0.000176807273646,
    0.001864627368902, 0.058637519197110, -0.000372823835211,
    -0.162864473015945, -0.017071696107902, 0.414660099370354,
    0.414660099370354, -0.017071696107902, -0.162864473015945,
    -0.000372823835211, 0.058637519197110, 0.001864627368902,
    0.001864627368902, 0.058637519197110, -0.000372823835211,
    -0.162864473015945, -0.017071696107902, 0.414660099370354,
    0.414660099370354, -0.017071696107902, -0.162864473015945,
    -0.000372823835211, 0.058637519197110, 0.001864627368902,
    -0.000176807273646, 0.010193185932466, 0.000437956841058,
    0.000222278879007, -0.000913092543974, -0.017071696107902,
    -0.017071696107902, -0.000913092543974, 0.000222278879007,
    0.000437956841058, 0.010193185932466, -0.000176807273646,
    -0.000562751488849, 0.000191123989093, 0.007113577630288,
    0.044592622228814, 0.000222278879007, -0.162864473015945,
    -0.162864473015945, 0.000222278879007, 0.044592622228814,
    0.007113577630288, 0.000191123989093, -0.000562751488849,
    -0.000897597057705, -0.000121760530512, 0.000946363683751,
    0.007113577630288, 0.000437956841058, -0.000372823835211,
    -0.000372823835211, 0.000437956841058, 0.007113577630288,
    0.000946363683751, -0.000121760530512, -0.000897597057705,
    -0.000314256996835, -0.001527942804748, -0.000121760530512,
    0.000191123989093, 0.010193185932466, 0.058637519197110,
    0.058637519197110, 0.010193185932466, 0.000191123989093,
    -0.000121760530512, -0.001527942804748, -0.000314256996835,
    -0.000314256996835, -0.000314256996835, -0.000897597057705,
    -0.000562751488849, -0.000176807273646, 0.001864627368902,
    0.001864627368902, -0.000176807273646, -0.000562751488849,
    -0.000897597057705, -0.000314256996835, -0.000314256996835,
]).reshape(12, 12)


def downsample_box(plane: np.ndarray, factor: int) -> np.ndarray:
    """Partial-box mean (image_ops.cc DoDownsampleImage): edge cells
    average only the pixels that exist."""
    h, w = plane.shape
    oh, ow = -(-h // factor), -(-w // factor)
    pad = np.pad(plane, ((0, oh * factor - h), (0, ow * factor - w)))
    cnt = np.pad(np.ones((h, w)), ((0, oh * factor - h),
                                   (0, ow * factor - w)))
    s = pad.reshape(oh, factor, ow, factor).sum(axis=(1, 3))
    c = cnt.reshape(oh, factor, ow, factor).sum(axis=(1, 3))
    return (s / c).astype(plane.dtype)


def _create_mask(img: np.ndarray) -> np.ndarray:
    """Second-smallest of the 4-neighbor absolute differences
    (enc_heuristics.cc:245-271 CreateMask): small in smooth areas
    (clamp hard), larger in noisy areas (keep sharpness)."""
    p = np.pad(img, 1, mode="edge")
    c = img
    diffs = np.stack([np.abs(c - p[1:-1, :-2]), np.abs(c - p[1:-1, 2:]),
                      np.abs(c - p[:-2, 1:-1]), np.abs(c - p[2:, 1:-1])])
    return np.sort(diffs, axis=0)[1]


def downsample2_sharper(plane: np.ndarray) -> np.ndarray:
    """12x12 sharper 2x downsample with local clamping
    (enc_heuristics.cc:279-407 DownsampleImage2_Sharper)."""
    from numpy.lib.stride_tricks import sliding_window_view
    h, w = plane.shape
    oh, ow = -(-h // 2), -(-w // 2)
    # clamped support: iy = 2y + ky - 5, ky in [0, 12)
    p = np.pad(plane.astype(np.float64), ((5, 6 + (oh * 2 - h)),
                                          (5, 6 + (ow * 2 - w))),
               mode="edge")
    win = sliding_window_view(p, (12, 12))[::2, ::2][:oh, :ow]
    out = np.einsum("yxuv,uv->yx", win, _K2, optimize=True)
    # R=5: the bound region is the 2x2 source box of each output pixel
    box = win[:, :, 5:7, 5:7]
    mn = box.min(axis=(2, 3))
    mx = box.max(axis=(2, 3))
    mask = _create_mask(downsample_box(plane.astype(np.float64), 2))
    return np.clip(out, mn - mask, mx + mask).astype(plane.dtype)


def downsample_xyb(xyb: np.ndarray, factor: int) -> np.ndarray:
    """(3, H, W) opsin -> (3, ceil(H/f), ceil(W/f)); 2x uses the sharper
    kernel, 4x/8x the box mean (enc_heuristics.cc:409-421 routing)."""
    if factor == 2:
        return np.stack([downsample2_sharper(xyb[c]) for c in range(3)])
    return np.stack([downsample_box(xyb[c], factor) for c in range(3)])
