"""Blending primitives for patches and frame composition (reference
``lib/jxl/alpha.cc``, ``lib/jxl/blending.cc``,
``lib/jxl/render_pipeline/stage_blending.cc``). Vectorized numpy over
whole rects instead of per-row calls."""

from __future__ import annotations

import numpy as np

# patch blend modes (dec_patch_dictionary.h:34-70)
PATCH_NONE = 0
PATCH_REPLACE = 1
PATCH_ADD = 2
PATCH_MUL = 3
PATCH_BLEND_ABOVE = 4
PATCH_BLEND_BELOW = 5
PATCH_AWA_ABOVE = 6      # alpha-weighted add
PATCH_AWA_BELOW = 7
NUM_PATCH_BLEND_MODES = 8

# frame blend modes (frame_header.h BlendMode)
BLEND_REPLACE = 0
BLEND_ADD = 1
BLEND_BLEND = 2
BLEND_ALPHA_WEIGHTED_ADD = 3
BLEND_MUL = 4


def patch_uses_alpha(mode: int) -> bool:
    return mode in (PATCH_BLEND_ABOVE, PATCH_BLEND_BELOW, PATCH_AWA_ABOVE,
                    PATCH_AWA_BELOW)


def patch_uses_clamp(mode: int) -> bool:
    return patch_uses_alpha(mode) or mode == PATCH_MUL


def _clamp01(a, clamp):
    return np.clip(a, 0.0, 1.0) if clamp else a


def alpha_blend(bg, bga, fg, fga, premultiplied: bool, clamp: bool):
    """(alpha.cc:18-66) -> (color..., alpha). bg/fg: (C,...) arrays."""
    fga = _clamp01(fga, clamp)
    if premultiplied:
        out = fg + bg * (1.0 - fga)
        out_a = 1.0 - (1.0 - fga) * (1.0 - bga)
    else:
        new_a = 1.0 - (1.0 - fga) * (1.0 - bga)
        rnew_a = np.where(new_a > 0, 1.0 / np.where(new_a > 0, new_a, 1.0),
                          0.0)
        out = (fg * fga + bg * bga * (1.0 - fga)) * rnew_a
        out_a = new_a
    return out, out_a


def blend_rect(bg: np.ndarray, fg: np.ndarray, color_blending,
               ec_blending, extra_channel_info) -> np.ndarray:
    """PerformBlending (blending.cc:42-170) over whole (3+nec, h, w)
    arrays. ``color_blending``/``ec_blending[i]``: (mode, alpha_channel,
    clamp) tuples. Returns the blended (3+nec, h, w) array."""
    num_ec = bg.shape[0] - 3
    out = np.empty_like(bg)

    def ec_alpha(src, idx):
        return src[3 + idx]

    # extra channels first (pre-blending alpha is used for color)
    for i in range(num_ec):
        mode, alpha, clamp = ec_blending[i]
        if mode == PATCH_ADD:
            out[3 + i] = bg[3 + i] + fg[3 + i]
        elif mode == PATCH_BLEND_ABOVE or mode == PATCH_BLEND_BELOW:
            lo, hi = (bg, fg) if mode == PATCH_BLEND_ABOVE else (fg, bg)
            prem = bool(extra_channel_info[alpha].alpha_associated)
            if i == alpha:
                fa = _clamp01(ec_alpha(hi, alpha), clamp)
                out[3 + i] = 1.0 - (1.0 - fa) * (1.0 - ec_alpha(lo, alpha))
            else:
                v, _ = alpha_blend(lo[3 + i], ec_alpha(lo, alpha),
                                   hi[3 + i], ec_alpha(hi, alpha),
                                   prem, clamp)
                out[3 + i] = v
        elif mode == PATCH_AWA_ABOVE or mode == PATCH_AWA_BELOW:
            lo, hi = (bg, fg) if mode == PATCH_AWA_ABOVE else (fg, bg)
            if i == alpha:
                out[3 + i] = lo[3 + i]
            else:
                out[3 + i] = lo[3 + i] + hi[3 + i] * _clamp01(
                    ec_alpha(hi, alpha), clamp)
        elif mode == PATCH_MUL:
            out[3 + i] = bg[3 + i] * _clamp01(fg[3 + i], clamp)
        elif mode == PATCH_REPLACE:
            out[3 + i] = fg[3 + i]
        else:                     # kNone
            out[3 + i] = bg[3 + i]

    mode, alpha, clamp = color_blending
    if mode == PATCH_ADD:
        out[:3] = bg[:3] + fg[:3]
    elif mode in (PATCH_BLEND_ABOVE, PATCH_BLEND_BELOW):
        lo, hi = (bg, fg) if mode == PATCH_BLEND_ABOVE else (fg, bg)
        if num_ec == 0:
            out[:3] = hi[:3]
        else:
            prem = bool(extra_channel_info[alpha].alpha_associated)
            v, va = alpha_blend(lo[:3], ec_alpha(lo, alpha)[None],
                                hi[:3], ec_alpha(hi, alpha)[None],
                                prem, clamp)
            out[:3] = v
            out[3 + alpha] = va[0]
    elif mode in (PATCH_AWA_ABOVE, PATCH_AWA_BELOW):
        lo, hi = (bg, fg) if mode == PATCH_AWA_ABOVE else (fg, bg)
        if num_ec == 0:
            out[:3] = lo[:3]
        else:
            fa = _clamp01(ec_alpha(hi, alpha), clamp)
            out[:3] = lo[:3] + hi[:3] * fa[None]
    elif mode == PATCH_MUL:
        out[:3] = bg[:3] * _clamp01(fg[:3], clamp)
    elif mode == PATCH_REPLACE:
        out[:3] = fg[:3]
    else:
        out[:3] = bg[:3]
    return out


def frame_blend_to_patch_mode(frame_mode: int, above: bool = True) -> tuple:
    """Frame BlendMode -> patch blending semantics
    (stage_blending.cc:60-90 mapping)."""
    table = {
        BLEND_REPLACE: PATCH_REPLACE,
        BLEND_ADD: PATCH_ADD,
        BLEND_BLEND: PATCH_BLEND_ABOVE,
        BLEND_ALPHA_WEIGHTED_ADD: PATCH_AWA_ABOVE,
        BLEND_MUL: PATCH_MUL,
    }
    return table[frame_mode]
