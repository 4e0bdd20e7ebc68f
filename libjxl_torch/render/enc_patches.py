"""Encoder-side patch detection: screenshot/text-like repeated shapes.

Re-design of the reference's ``enc_patch_dictionary.cc`` pipeline
(FindTextLikePatches :231, bin packing / FindBestPatchDictionary :620,
RoundtripPatchFrame :812) in vectorized numpy:

 * seed detection and the background flood fill run as whole-image array
   ops (iterated masked dilation) instead of per-pixel queues;
 * connected components of foreground pixels use a small BFS over the
   (sparse) foreground only;
 * atlas bin packing tests candidate positions with an integral image
   instead of the reference's quadratic pixel scan.

The atlas rides in the codestream as a modular-XYB REFERENCE_ONLY frame
saved before the color transform (slot kPatchFrameReferenceId=3), and
every occurrence becomes a kAdd patch, exactly like the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# PatchColorspaceInfo(is_xyb=true) (enc_patch_dictionary.cc:185-225)
K_DEQUANT = np.array([0.01615, 0.08875, 0.1922], np.float32)
K_WEIGHTS = np.array([30.0, 3.0, 1.0], np.float32)
# PatchColorspaceInfo(is_xyb=false): the reference works on [0..1]
# floats with dequant {20,22,20}/255 and weights {0.017,0.02,0.017}*255;
# expressed per 8-bit integer step those are {20,22,20} and
# {0.017,0.02,0.017} (lossless detection runs on the raw int planes)
K_DEQUANT_RGB8 = np.array([20.0, 22.0, 20.0], np.float32)
K_WEIGHTS_RGB8 = np.array([0.017, 0.02, 0.017], np.float32)
PATCH_SIDE = 4
MAX_PATCH_SIZE = 32
K_SIMILAR_THRESHOLD = 0.8
K_VERY_SIMILAR = 0.03
K_HAS_SIMILAR = 0.03
K_DISTANCE_LIMIT = 50
K_MIN_PEAK = 2
K_MIN_OCCURRENCES = 2
K_MIN_MAX_PATCH_SIZE = 20
PATCH_FRAME_REF_ID = 3


@dataclass
class FoundPatch:
    pixels: np.ndarray                  # (3, ph, pw) float XYB diff
    positions: list = field(default_factory=list)   # [(x, y), ...]
    qpixels: bytes = b""                # dedup key (int8-quantized)


def _weighted_dist(a, b, weights=K_WEIGHTS):
    """Channel-weighted L1 color distance; a/b are (3, ...) arrays."""
    return (np.abs(a - b) * weights[:, None]).sum(axis=0) \
        if a.ndim == 2 else \
        (np.abs(a - b) * weights.reshape(3, 1, 1)).sum(axis=0)


def _find_seeds(xyb: np.ndarray) -> np.ndarray:
    """Aligned 4x4 blocks that are perfectly flat AND agree with >=8 of
    the 9 surrounding block corners (enc_patch_dictionary.cc:278-330).
    Returns a (ph, pw) bool map (border rows/cols always False)."""
    _, H, W = xyb.shape
    ph, pw = H // PATCH_SIDE, W // PATCH_SIDE
    if ph < 3 or pw < 3:
        return np.zeros((max(ph, 0), max(pw, 0)), bool)
    crop = xyb[:, :ph * PATCH_SIDE, :pw * PATCH_SIDE]
    blocks = crop.reshape(3, ph, PATCH_SIDE, pw, PATCH_SIDE)
    base = blocks[:, :, 0, :, 0]                       # block corner color
    flat = (np.abs(blocks - base[:, :, None, :, None]) <= 1e-4).all(
        axis=(0, 2, 4))                                # (ph, pw)
    # corners of the 9 surrounding aligned blocks must be the same color
    same = np.zeros((ph, pw), np.int32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            shifted = np.full((3, ph, pw), np.inf, np.float32)
            ys = slice(max(dy, 0), ph + min(dy, 0))
            yd = slice(max(-dy, 0), ph + min(-dy, 0))
            xs = slice(max(dx, 0), pw + min(dx, 0))
            xd = slice(max(-dx, 0), pw + min(-dx, 0))
            shifted[:, yd, xd] = base[:, ys, xs]
            same += (np.abs(shifted - base) <= 1e-4).all(axis=0)
    seeds = flat & (same >= 8)
    seeds[0, :] = seeds[-1, :] = False
    seeds[:, 0] = seeds[:, -1] = False
    # reference scans px in [1, pw-2] and py in [1, ph-2]
    if pw >= 2:
        seeds[:, pw - 2 + 1:] = False
    return seeds


def _flood_background(xyb: np.ndarray, seeds: np.ndarray,
                      weights=K_WEIGHTS):
    """Grow the background from seed blocks by masked dilation.

    Every background pixel carries the color of the seed-region source
    pixel it grew from; growth stops at the similarity threshold and at
    Manhattan distance K_DISTANCE_LIMIT from the source (reference
    queue-BFS at enc_patch_dictionary.cc:389-421)."""
    _, H, W = xyb.shape
    is_bg = np.zeros((H, W), bool)
    src_color = np.zeros((3, H, W), np.float32)
    src_y = np.zeros((H, W), np.int32)
    src_x = np.zeros((H, W), np.int32)
    ph, pw = seeds.shape
    seed_px = np.zeros((H, W), bool)
    grid = np.repeat(np.repeat(seeds, PATCH_SIDE, 0), PATCH_SIDE, 1)
    seed_px[:ph * PATCH_SIDE, :pw * PATCH_SIDE] = grid
    yy, xx = np.mgrid[0:H, 0:W].astype(np.int32)
    is_bg |= seed_px
    src_color[:, seed_px] = xyb[:, seed_px]
    src_y[seed_px] = yy[seed_px]
    src_x[seed_px] = xx[seed_px]

    shifts = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
              if (dy, dx) != (0, 0)]
    for _ in range(2 * K_DISTANCE_LIMIT + 2):
        grew = False
        for dy, dx in shifts:
            ys = slice(max(dy, 0), H + min(dy, 0))
            yd = slice(max(-dy, 0), H + min(-dy, 0))
            xs = slice(max(dx, 0), W + min(dx, 0))
            xd = slice(max(-dx, 0), W + min(-dx, 0))
            cand = (~is_bg[yd, xd]) & is_bg[ys, xs]
            if not cand.any():
                continue
            sc = src_color[:, ys, xs]
            dist = _weighted_dist(sc, xyb[:, yd, xd], weights)
            man = (np.abs(yy[yd, xd] - src_y[ys, xs]) +
                   np.abs(xx[yd, xd] - src_x[ys, xs]))
            ok = cand & (dist <= K_SIMILAR_THRESHOLD) & \
                (man <= K_DISTANCE_LIMIT)
            if not ok.any():
                continue
            grew = True
            tgt_bg = is_bg[yd, xd]
            tgt_bg[ok] = True
            is_bg[yd, xd] = tgt_bg
            for c in range(3):
                t = src_color[c, yd, xd]
                t[ok] = sc[c][ok]
                src_color[c, yd, xd] = t
            t = src_y[yd, xd]
            t[ok] = src_y[ys, xs][ok]
            src_y[yd, xd] = t
            t = src_x[yd, xd]
            t[ok] = src_x[ys, xs][ok]
            src_x[yd, xd] = t
        if not grew:
            break
    return is_bg, src_color


def find_text_like_patches(xyb: np.ndarray, weights=K_WEIGHTS,
                           dequant=K_DEQUANT) -> list[FoundPatch]:
    """Vectorized mirror of FindTextLikePatches
    (enc_patch_dictionary.cc:231-617). ``xyb`` is the (3, H, W) opsin
    image. Returns deduplicated patches with >=2 occurrences."""
    _, H, W = xyb.shape
    seeds = _find_seeds(xyb)
    if not seeds.any():
        return []
    is_bg, background = _flood_background(xyb, seeds, weights)
    fg = ~is_bg
    if not fg.any():
        return []

    # connected components (8-connected) over the sparse foreground
    visited = np.zeros((H, W), bool)
    raw: list[FoundPatch] = []
    fys, fxs = np.nonzero(fg)
    neigh = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
             if (dy, dx) != (0, 0)]
    for y0, x0 in zip(fys, fxs):
        if visited[y0, x0]:
            continue
        stack = [(int(y0), int(x0))]
        comp = []
        border_ref = None
        all_similar = True
        min_x = max_x = int(x0)
        min_y = max_y = int(y0)
        while stack:
            cy, cx = stack.pop()
            if visited[cy, cx]:
                continue
            visited[cy, cx] = True
            comp.append((cy, cx))
            min_x, max_x = min(min_x, cx), max(max_x, cx)
            min_y, max_y = min(min_y, cy), max(max_y, cy)
            for dy, dx in neigh:
                ny, nx = cy + dy, cx + dx
                if not (0 <= ny < H and 0 <= nx < W):
                    continue
                if fg[ny, nx]:
                    if not visited[ny, nx]:
                        stack.append((ny, nx))
                elif border_ref is None:
                    border_ref = (ny, nx)
                elif all_similar:
                    a = background[:, ny, nx]
                    b = background[:, border_ref[0], border_ref[1]]
                    if float((np.abs(a - b) * weights).sum()) > \
                            K_VERY_SIMILAR:
                        all_similar = False
        if border_ref is None or not all_similar:
            continue
        if max_x - min_x >= MAX_PATCH_SIZE or \
                max_y - min_y >= MAX_PATCH_SIZE:
            continue
        ref = background[:, border_ref[0], border_ref[1]]
        # require a similar color nearby in the original image
        ylo = max(min_y - 2, 0)
        yhi = min(max_y + 3, H)
        xlo = max(min_x - 2, 0)
        xhi = min(max_x + 3, W)
        region = xyb[:, ylo:yhi, xlo:xhi]
        if not (_weighted_dist(region, ref.reshape(3, 1, 1), weights) <=
                K_HAS_SIMILAR).any():
            continue
        diff = (xyb[:, min_y:max_y + 1, min_x:max_x + 1] -
                ref.reshape(3, 1, 1)).astype(np.float32)
        q = np.trunc(diff / dequant.reshape(3, 1, 1))
        if (np.abs(q) > 127).any():         # doesn't fit int8
            continue
        if (np.abs(q) < K_MIN_PEAK).all():  # all-flat patch: skip
            continue
        raw.append(FoundPatch(pixels=diff,
                              positions=[(min_x, min_y)],
                              qpixels=q.astype(np.int8).tobytes() +
                              diff.shape[1].to_bytes(2, "little") +
                              diff.shape[2].to_bytes(2, "little")))

    if not raw:
        return []
    # dedup identical quantized patches; keep those occurring >= 2 times
    by_key: dict[bytes, FoundPatch] = {}
    for p in raw:
        if p.qpixels in by_key:
            by_key[p.qpixels].positions.extend(p.positions)
        else:
            by_key[p.qpixels] = p
    info = [p for p in by_key.values()
            if len(p.positions) >= K_MIN_OCCURRENCES]
    if not info:
        return []
    if max(p.pixels.shape[1] * p.pixels.shape[2] for p in info) < \
            K_MIN_MAX_PATCH_SIZE:
        return []
    return info


def pack_patches(info: list[FoundPatch]):
    """Greedy first-fit bin packing into the atlas
    (FindBestPatchDictionary :663-740), candidate testing via an
    occupancy integral image. Returns (atlas (3, H, W) float32,
    [(x0, y0) per patch])."""
    info = sorted(info, key=lambda p: -(p.pixels.shape[1] *
                                        p.pixels.shape[2]))
    total = sum(p.pixels.shape[1] * p.pixels.shape[2] for p in info)
    max_w = max(p.pixels.shape[2] for p in info)
    max_h = max(p.pixels.shape[1] for p in info)
    ref_w = max(max_w, int(np.sqrt(total)))
    ref_h = max(max_h, int(np.sqrt(total)))
    while True:
        ref_w = int(ref_w * 1.05) + 1
        ref_h = int(ref_h * 1.05) + 1
        occupied = np.zeros((ref_h, ref_w), np.int32)
        positions = []
        ok = True
        max_y = 0
        for p in info:
            ph, pw = p.pixels.shape[1:]
            ii = np.zeros((ref_h + 1, ref_w + 1), np.int64)
            np.cumsum(np.cumsum(occupied, 0), 1, out=ii[1:, 1:])
            rect = (ii[ph:, pw:] - ii[:-ph, pw:] -
                    ii[ph:, :-pw] + ii[:-ph, :-pw])
            free = np.argwhere(rect == 0)
            if len(free) == 0:
                ok = False
                break
            y0, x0 = int(free[0][0]), int(free[0][1])
            occupied[y0:y0 + ph, x0:x0 + pw] = 1
            positions.append((x0, y0))
            max_y = max(max_y, y0 + ph)
        if ok:
            break
    atlas = np.zeros((3, max_y, ref_w), np.float32)
    for p, (x0, y0) in zip(info, positions):
        ph, pw = p.pixels.shape[1:]
        atlas[:, y0:y0 + ph, x0:x0 + pw] = p.pixels
    return info, atlas, positions


def build_patch_dictionary(info, atlas_positions, num_extra: int):
    """PatchDictionary (decode-side dataclasses) with kAdd color
    blending and kNone for extra channels."""
    from libjxl_torch.render.patches import Patch, PatchDictionary, PatchRef

    pdict = PatchDictionary()
    for i, (p, (ax, ay)) in enumerate(zip(info, atlas_positions)):
        ph, pw = p.pixels.shape[1:]
        pdict.refs.append(PatchRef(ref=PATCH_FRAME_REF_ID, x0=ax, y0=ay,
                                   xsize=pw, ysize=ph))
        for (x, y) in sorted(p.positions, key=lambda t: (t[1], t[0])):
            pt = Patch(ref_idx=i, x=x, y=y)
            pt.blendings.append((2, 0, False))          # kAdd
            for _ in range(num_extra):
                pt.blendings.append((0, 0, False))      # kNone
            pdict.patches.append(pt)
    return pdict


def serialize_patches(sw, pdict, num_extra: int) -> None:
    """Token-stream mirror of decode_patches (render/patches.py;
    PatchDictionaryEncoder::Encode, enc_patch_dictionary.cc:60-140)."""
    from libjxl_torch.core.headers import pack_signed
    from libjxl_torch.entropy.ans import (
        build_entropy_codes, tokens_to_array, write_entropy_codes,
        write_tokens,
    )
    from libjxl_torch.render.patches import (
        CTX_NUM_REF_PATCH, CTX_PATCH_ALPHA_CHANNEL, CTX_PATCH_BLEND_MODE,
        CTX_PATCH_CLAMP, CTX_PATCH_COUNT, CTX_PATCH_OFFSET,
        CTX_PATCH_POSITION, CTX_PATCH_REFERENCE_POSITION, CTX_PATCH_SIZE,
        CTX_REFERENCE_FRAME, NUM_PATCH_CONTEXTS,
    )
    from libjxl_torch.render.blending import patch_uses_alpha, \
        patch_uses_clamp

    toks: list[tuple[int, int]] = []
    toks.append((CTX_NUM_REF_PATCH, len(pdict.refs)))
    by_ref: dict[int, list] = {i: [] for i in range(len(pdict.refs))}
    for p in pdict.patches:
        by_ref[p.ref_idx].append(p)
    choose_alpha = num_extra > 1
    for i, rp in enumerate(pdict.refs):
        toks.append((CTX_REFERENCE_FRAME, rp.ref))
        toks.append((CTX_PATCH_REFERENCE_POSITION, rp.x0))
        toks.append((CTX_PATCH_REFERENCE_POSITION, rp.y0))
        toks.append((CTX_PATCH_SIZE, rp.xsize - 1))
        toks.append((CTX_PATCH_SIZE, rp.ysize - 1))
        plist = by_ref[i]
        toks.append((CTX_PATCH_COUNT, len(plist) - 1))
        for j, p in enumerate(plist):
            if j == 0:
                toks.append((CTX_PATCH_POSITION, p.x))
                toks.append((CTX_PATCH_POSITION, p.y))
            else:
                prev = plist[j - 1]
                toks.append((CTX_PATCH_OFFSET, pack_signed(p.x - prev.x)))
                toks.append((CTX_PATCH_OFFSET, pack_signed(p.y - prev.y)))
            for (mode, alpha, clamp) in p.blendings:
                toks.append((CTX_PATCH_BLEND_MODE, mode))
                if patch_uses_alpha(mode) and choose_alpha:
                    toks.append((CTX_PATCH_ALPHA_CHANNEL, alpha))
                if patch_uses_clamp(mode):
                    toks.append((CTX_PATCH_CLAMP, int(clamp)))
    arr = tokens_to_array(toks)
    codes = build_entropy_codes([arr], NUM_PATCH_CONTEXTS)
    write_entropy_codes(sw, codes)
    write_tokens(sw, arr, codes)


def quantize_atlas_modular(atlas: np.ndarray):
    """Quantize the float XYB atlas to the modular-XYB integer planes
    with the all-default DC quants (see api/decoder.py:404-412: Y, X,
    B-Y channel order, B stored minus Y). Returns (channels, decoded)
    where decoded is the float image the decoder will reconstruct —
    the encoder must subtract THESE values, not the originals."""
    dcq = np.array([1.0 / 4096, 1.0 / 512, 1.0 / 256], np.float32)
    chx = np.round(atlas[0] / dcq[0]).astype(np.int32)
    chy = np.round(atlas[1] / dcq[1]).astype(np.int32)
    chb = np.round(atlas[2] / dcq[2]).astype(np.int32) - chy
    decoded = np.stack([chx * dcq[0], chy * dcq[1],
                        (chb + chy) * dcq[2]]).astype(np.float32)
    return [chy, chx, chb], decoded


def subtract_patches(xyb: np.ndarray, pdict, atlas_decoded: np.ndarray
                     ) -> None:
    """In-place: remove the (decoded) patch values from the image so the
    main frame encodes the background (PatchDictionaryEncoder::
    SubtractFrom)."""
    for p in pdict.patches:
        rp = pdict.refs[p.ref_idx]
        patch = atlas_decoded[:, rp.y0:rp.y0 + rp.ysize,
                              rp.x0:rp.x0 + rp.xsize]
        xyb[:, p.y:p.y + rp.ysize, p.x:p.x + rp.xsize] -= patch


def find_lossless_patches(pixels: np.ndarray, num_extra: int = 0):
    """Integer-domain patch detection for the modular lossless path
    (enc_modular.cc:710-717 calls FindBestPatchDictionary with
    is_xyb=false on the pre-RCT color image, then SubtractFrom).

    ``pixels`` is the (h, w, c>=3) uint8/uint16 image. Returns
    ``(pdict, atlas_int)`` — the patch dictionary plus the (3, ah, aw)
    int32 atlas of exact pixel diffs — or None when nothing repeats.
    Unlike the XYB path, no quantization is involved: the atlas stores
    the integer difference patch-vs-background, the main frame encodes
    ``orig - drawn_diff`` and the decoder's kAdd blend restores the
    original exactly (all values stay on the 1/maxval float grid)."""
    h, w, nch = pixels.shape
    maxval = 65535 if pixels.dtype == np.uint16 else 255
    scale = maxval / 255.0
    planes = np.moveaxis(pixels[:, :, :3], -1, 0).astype(np.float32)
    info = find_text_like_patches(
        planes, weights=K_WEIGHTS_RGB8 / scale,
        dequant=(K_DEQUANT_RGB8 * scale).astype(np.float32))
    if not info:
        return None
    info, atlas, positions = pack_patches(info)
    pdict = build_patch_dictionary(info, positions, num_extra)
    atlas_int = np.rint(atlas).astype(np.int32)
    return pdict, atlas_int


def subtract_patches_int(planes: np.ndarray, pdict,
                         atlas_int: np.ndarray) -> None:
    """In-place integer mirror of PatchDictionaryEncoder::SubtractFrom
    for the lossless path; ``planes`` is (3, h, w) int32."""
    for p in pdict.patches:
        rp = pdict.refs[p.ref_idx]
        patch = atlas_int[:, rp.y0:rp.y0 + rp.ysize,
                          rp.x0:rp.x0 + rp.xsize]
        planes[:, p.y:p.y + rp.ysize, p.x:p.x + rp.xsize] -= patch
