"""Patch dictionary: decode + application (reference
``lib/jxl/dec_patch_dictionary.{h,cc}``, ``patch_dictionary_internal.h``,
``render_pipeline/stage_patches.cc``).

Patches copy rectangles out of previously-stored reference frames (saved
before the color transform) onto the current frame with per-patch,
per-channel blending."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from libjxl_torch.core.fields import FormatError
from libjxl_torch.core.headers import unpack_signed
from libjxl_torch.entropy.ans import ANSSymbolReader, decode_histograms
from libjxl_torch.render.blending import (
    NUM_PATCH_BLEND_MODES, blend_rect, patch_uses_alpha, patch_uses_clamp,
)

# contexts (patch_dictionary_internal.h:11-24, spec C.4.5)
CTX_NUM_REF_PATCH = 0
CTX_REFERENCE_FRAME = 1
CTX_PATCH_SIZE = 2
CTX_PATCH_REFERENCE_POSITION = 3
CTX_PATCH_POSITION = 4
CTX_PATCH_BLEND_MODE = 5
CTX_PATCH_OFFSET = 6
CTX_PATCH_COUNT = 7
CTX_PATCH_ALPHA_CHANNEL = 8
CTX_PATCH_CLAMP = 9
NUM_PATCH_CONTEXTS = 10


@dataclass
class PatchRef:
    ref: int = 0
    x0: int = 0
    y0: int = 0
    xsize: int = 0
    ysize: int = 0


@dataclass
class Patch:
    ref_idx: int = 0
    x: int = 0
    y: int = 0
    blendings: list = field(default_factory=list)  # (mode, alpha, clamp)


@dataclass
class PatchDictionary:
    refs: list = field(default_factory=list)
    patches: list = field(default_factory=list)


def decode_patches(r, xsize: int, ysize: int, num_extra: int,
                   reference_frames) -> PatchDictionary:
    """(dec_patch_dictionary.cc:30-180)."""
    code = decode_histograms(r, NUM_PATCH_CONTEXTS)
    dec = ANSSymbolReader(code, r)
    num_ref = dec.read_hybrid_uint(CTX_NUM_REF_PATCH, r)
    max_ref = 1024 + xsize * ysize // 4
    if num_ref > max_ref:
        raise FormatError("too many patches")
    out = PatchDictionary()
    total = 0
    choose_alpha = num_extra > 1
    for _ in range(num_ref):
        rp = PatchRef()
        rp.ref = dec.read_hybrid_uint(CTX_REFERENCE_FRAME, r)
        if rp.ref >= 4 or reference_frames[rp.ref] is None:
            raise FormatError("invalid patch reference frame")
        ref_img = reference_frames[rp.ref]
        rp.x0 = dec.read_hybrid_uint(CTX_PATCH_REFERENCE_POSITION, r)
        rp.y0 = dec.read_hybrid_uint(CTX_PATCH_REFERENCE_POSITION, r)
        rp.xsize = dec.read_hybrid_uint(CTX_PATCH_SIZE, r) + 1
        rp.ysize = dec.read_hybrid_uint(CTX_PATCH_SIZE, r) + 1
        if rp.x0 + rp.xsize > ref_img.shape[2] or \
                rp.y0 + rp.ysize > ref_img.shape[1]:
            raise FormatError("patch out of reference frame bounds")
        count = dec.read_hybrid_uint(CTX_PATCH_COUNT, r) + 1
        total += count
        if total > 4 * max_ref:
            raise FormatError("too many patches")
        for i in range(count):
            p = Patch(ref_idx=len(out.refs))
            if i == 0:
                p.x = dec.read_hybrid_uint(CTX_PATCH_POSITION, r)
                p.y = dec.read_hybrid_uint(CTX_PATCH_POSITION, r)
            else:
                prev = out.patches[-1]
                p.x = prev.x + unpack_signed(
                    dec.read_hybrid_uint(CTX_PATCH_OFFSET, r))
                p.y = prev.y + unpack_signed(
                    dec.read_hybrid_uint(CTX_PATCH_OFFSET, r))
            if p.x < 0 or p.y < 0 or p.x + rp.xsize > xsize or \
                    p.y + rp.ysize > ysize:
                raise FormatError("patch out of frame bounds")
            for _j in range(num_extra + 1):
                mode = dec.read_hybrid_uint(CTX_PATCH_BLEND_MODE, r)
                if mode >= NUM_PATCH_BLEND_MODES:
                    raise FormatError("invalid patch blend mode")
                alpha = 0
                if patch_uses_alpha(mode) and choose_alpha:
                    alpha = dec.read_hybrid_uint(CTX_PATCH_ALPHA_CHANNEL, r)
                    if alpha >= num_extra:
                        raise FormatError("invalid patch alpha channel")
                clamp = False
                if patch_uses_clamp(mode):
                    clamp = bool(dec.read_hybrid_uint(CTX_PATCH_CLAMP, r))
                p.blendings.append((mode, alpha, clamp))
            out.patches.append(p)
        out.refs.append(rp)
    if not dec.check_final_state():
        raise FormatError("patch ANS checksum failed")
    return out


def apply_patches(img: np.ndarray, pd: PatchDictionary, reference_frames,
                  extra_channel_info) -> np.ndarray:
    """Blend all patches onto (3+nec, H, W) ``img`` (AddOneRow semantics,
    whole-rect vectorized)."""
    out = img.copy()
    for p in pd.patches:
        rp = pd.refs[p.ref_idx]
        ref_img = reference_frames[rp.ref]
        fg = ref_img[:, rp.y0:rp.y0 + rp.ysize, rp.x0:rp.x0 + rp.xsize]
        if fg.shape[0] < out.shape[0]:   # reference lacks extra channels
            pad = np.zeros((out.shape[0] - fg.shape[0],) + fg.shape[1:],
                           dtype=fg.dtype)
            fg = np.concatenate([fg, pad])
        bg = out[:, p.y:p.y + rp.ysize, p.x:p.x + rp.xsize]
        blended = blend_rect(bg, fg, p.blendings[0], p.blendings[1:],
                             extra_channel_info)
        out[:, p.y:p.y + rp.ysize, p.x:p.x + rp.xsize] = blended
    return out


def apply_patches_band(img_band: np.ndarray, row0: int,
                       pd: PatchDictionary, reference_frames,
                       extra_channel_info) -> np.ndarray:
    """apply_patches for a window of image rows [row0, row0 + band):
    every patch rect is clipped to the band (blending is per-pixel, so
    row clipping is exact)."""
    out = img_band.copy()
    rows = img_band.shape[1]
    for p in pd.patches:
        rp = pd.refs[p.ref_idx]
        a = max(p.y, row0)
        b = min(p.y + rp.ysize, row0 + rows)
        if b <= a:
            continue
        ref_img = reference_frames[rp.ref]
        fg = ref_img[:, rp.y0 + (a - p.y):rp.y0 + (b - p.y),
                     rp.x0:rp.x0 + rp.xsize]
        if fg.shape[0] < out.shape[0]:
            pad = np.zeros((out.shape[0] - fg.shape[0],) + fg.shape[1:],
                           dtype=fg.dtype)
            fg = np.concatenate([fg, pad])
        bg = out[:, a - row0:b - row0, p.x:p.x + rp.xsize]
        blended = blend_rect(bg, fg, p.blendings[0], p.blendings[1:],
                             extra_channel_info)
        out[:, a - row0:b - row0, p.x:p.x + rp.xsize] = blended
    return out
