"""Modular transforms: RCT, Palette, Squeeze — serialization, meta-apply,
forward and inverse (reference ``lib/jxl/modular/transform/``)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from jxlbench.ref.jxl.core.fields import Bits, BitsOffset, FormatError, Val
from jxlbench.ref.jxl.modular.image import Channel, ModularImage


class TransformId:
    RCT = 0
    PALETTE = 1
    SQUEEZE = 2
    INVALID = 3


@dataclass
class SqueezeParams:
    """(squeeze_params.cc:15-24)."""

    horizontal: bool = False
    in_place: bool = False
    begin_c: int = 0
    num_c: int = 2

    def visit(self, v) -> None:
        self.horizontal = v.bool(self.horizontal)
        self.in_place = v.bool(self.in_place)
        self.begin_c = v.u32(Bits(3), BitsOffset(6, 8), BitsOffset(10, 72),
                             BitsOffset(13, 1096), self.begin_c)
        self.num_c = v.u32(Val(1), Val(2), Val(3), BitsOffset(4, 4),
                           self.num_c)


@dataclass
class Transform:
    """(transform.cc:36-89)."""

    id: int = TransformId.RCT
    begin_c: int = 0
    rct_type: int = 6          # YCoCg default
    num_c: int = 3
    nb_colors: int = 256
    nb_deltas: int = 0
    predictor: int = 0
    squeezes: list = field(default_factory=list)

    def visit(self, v) -> None:
        self.id = v.u32(Val(0), Val(1), Val(2), Val(3), self.id)
        if self.id == TransformId.INVALID:
            raise FormatError("invalid transform id")
        if self.id in (TransformId.RCT, TransformId.PALETTE):
            self.begin_c = v.u32(Bits(3), BitsOffset(6, 8),
                                 BitsOffset(10, 72), BitsOffset(13, 1096),
                                 self.begin_c)
        if self.id == TransformId.RCT:
            self.rct_type = v.u32(Val(6), Bits(2), BitsOffset(4, 2),
                                  BitsOffset(6, 10), self.rct_type)
            if self.rct_type >= 42:
                raise FormatError("invalid RCT type")
        if self.id == TransformId.PALETTE:
            self.num_c = v.u32(Val(1), Val(3), Val(4), BitsOffset(13, 1),
                               self.num_c)
            self.nb_colors = v.u32(BitsOffset(8, 0), BitsOffset(10, 256),
                                   BitsOffset(12, 1280), BitsOffset(16, 5376),
                                   self.nb_colors)
            self.nb_deltas = v.u32(Val(0), BitsOffset(8, 1),
                                   BitsOffset(10, 257), BitsOffset(16, 1281),
                                   self.nb_deltas)
            self.predictor = v.bits(4, self.predictor)
            if self.predictor >= 14:
                raise FormatError("invalid palette predictor")
        if self.id == TransformId.SQUEEZE:
            n = v.u32(Val(0), BitsOffset(4, 1), BitsOffset(6, 9),
                      BitsOffset(8, 41), len(self.squeezes))
            if v.is_reading:
                self.squeezes = [SqueezeParams() for _ in range(n)]
            for sq in self.squeezes:
                sq.visit(v)

    # -- meta application (channel-list shape changes before decoding) ------

    def meta_apply(self, image: ModularImage) -> None:
        if self.id == TransformId.RCT:
            _check_equal_channels(image, self.begin_c, self.begin_c + 2)
        elif self.id == TransformId.SQUEEZE:
            meta_squeeze(image, self)
        elif self.id == TransformId.PALETTE:
            meta_palette(image, self.begin_c, self.begin_c + self.num_c - 1,
                         self.nb_colors, self.nb_deltas)
        else:
            raise FormatError("bad transform")

    def inverse(self, image: ModularImage, wp_header=None) -> None:
        if self.id == TransformId.RCT:
            inv_rct(image, self.begin_c, self.rct_type)
        elif self.id == TransformId.SQUEEZE:
            inv_squeeze(image, self.squeezes)
        elif self.id == TransformId.PALETTE:
            inv_palette(image, self.begin_c, self.nb_colors, self.nb_deltas,
                        self.predictor, wp_header)
        else:
            raise FormatError("bad transform")


def _check_equal_channels(image: ModularImage, c1: int, c2: int) -> None:
    if c1 > c2 or c2 >= len(image.channel):
        raise FormatError("invalid channel range")
    if c1 < image.nb_meta_channels and c2 >= image.nb_meta_channels:
        raise FormatError("invalid meta channel range")
    ch0 = image.channel[c1]
    for c in range(c1 + 1, c2 + 1):
        ch = image.channel[c]
        if ch.w != ch0.w or ch.h != ch0.h:
            raise FormatError("transform on differently-sized channels")


# ---------------------------------------------------------------------------
# RCT (rct.cc:30-148, enc_rct.cc)
# ---------------------------------------------------------------------------

def _perm_indices(permutation: int):
    return (permutation % 3, (permutation + 1 + permutation // 3) % 3,
            (permutation + 2 - permutation // 3) % 3)


def inv_rct(image: ModularImage, begin_c: int, rct_type: int) -> None:
    _check_equal_channels(image, begin_c, begin_c + 2)
    if rct_type == 0:
        return
    m = begin_c
    permutation = rct_type // 7
    custom = rct_type % 7
    i0 = image.channel[m].plane.astype(np.int64)
    i1 = image.channel[m + 1].plane.astype(np.int64)
    i2 = image.channel[m + 2].plane.astype(np.int64)
    if custom == 6:  # YCoCg
        tmp = i0 - (i2 >> 1)
        g = i2 + tmp
        b = tmp - (i1 >> 1)
        r = b + i1
        o0, o1, o2 = r, g, b
    else:
        second = custom >> 1
        third = custom & 1
        o0, o1, o2 = i0, i1, i2
        if third:
            o2 = i2 + i0
        if second == 1:
            o1 = i1 + i0
        elif second == 2:
            o1 = i1 + ((i0 + o2) >> 1)
    p0, p1, p2 = _perm_indices(permutation)
    outs = [None, None, None]
    outs[p0], outs[p1], outs[p2] = o0, o1, o2
    for i, o in enumerate(outs):
        image.channel[m + i].plane = _wrap32(o)


def fwd_rct(image: ModularImage, begin_c: int, rct_type: int) -> None:
    """Forward RCT (enc_rct.cc semantics, exact inverse of inv_rct)."""
    _check_equal_channels(image, begin_c, begin_c + 2)
    if rct_type == 0:
        return
    m = begin_c
    permutation = rct_type // 7
    custom = rct_type % 7
    p0, p1, p2 = _perm_indices(permutation)
    i0 = image.channel[m + p0].plane.astype(np.int64)
    i1 = image.channel[m + p1].plane.astype(np.int64)
    i2 = image.channel[m + p2].plane.astype(np.int64)
    if custom == 6:  # YCoCg forward: R,G,B -> Y,Co,Cg
        r, g, b = i0, i1, i2
        co = r - b
        tmp = b + (co >> 1)
        cg = g - tmp
        y = tmp + (cg >> 1)
        o0, o1, o2 = y, co, cg
    else:
        second = custom >> 1
        third = custom & 1
        o0, o1, o2 = i0, i1, i2
        if second == 1:
            o1 = i1 - i0
        elif second == 2:
            o1 = i1 - ((i0 + i2) >> 1)
        if third:
            o2 = i2 - i0
    image.channel[m].plane = _wrap32(o0)
    image.channel[m + 1].plane = _wrap32(o1)
    image.channel[m + 2].plane = _wrap32(o2)


def _wrap32(a: np.ndarray) -> np.ndarray:
    return a.astype(np.int64).astype(np.uint32).astype(np.int32).copy()


# ---------------------------------------------------------------------------
# Squeeze (squeeze.cc)
# ---------------------------------------------------------------------------

K_MAX_FIRST_PREVIEW_SIZE = 8


def default_squeeze_parameters(image: ModularImage) -> list[SqueezeParams]:
    """(squeeze.cc DefaultSqueezeParameters)."""
    params: list[SqueezeParams] = []
    nb = len(image.channel) - image.nb_meta_channels
    w = image.channel[image.nb_meta_channels].w
    h = image.channel[image.nb_meta_channels].h
    wide = w > h
    if nb > 2 and image.channel[image.nb_meta_channels + 1].w == w and \
            image.channel[image.nb_meta_channels + 1].h == h:
        params.append(SqueezeParams(True, False,
                                    image.nb_meta_channels + 1, 2))
        params.append(SqueezeParams(False, False,
                                    image.nb_meta_channels + 1, 2))
    base = SqueezeParams(False, True, image.nb_meta_channels, nb)
    if not wide and h > K_MAX_FIRST_PREVIEW_SIZE:
        params.append(SqueezeParams(False, True, base.begin_c, nb))
        h = (h + 1) // 2
    while w > K_MAX_FIRST_PREVIEW_SIZE or h > K_MAX_FIRST_PREVIEW_SIZE:
        if w > K_MAX_FIRST_PREVIEW_SIZE:
            params.append(SqueezeParams(True, True, base.begin_c, nb))
            w = (w + 1) // 2
        if h > K_MAX_FIRST_PREVIEW_SIZE:
            params.append(SqueezeParams(False, True, base.begin_c, nb))
            h = (h + 1) // 2
    return params


def meta_squeeze(image: ModularImage, transform: Transform) -> None:
    """(squeeze.cc MetaSqueeze)."""
    if not transform.squeezes:
        transform.squeezes = default_squeeze_parameters(image)
    for p in transform.squeezes:
        _check_squeeze_params(p, len(image.channel))
        beginc, endc = p.begin_c, p.begin_c + p.num_c - 1
        if beginc < image.nb_meta_channels:
            if endc >= image.nb_meta_channels or not p.in_place:
                raise FormatError("invalid meta squeeze")
            image.nb_meta_channels += p.num_c
        offset = endc + 1 if p.in_place else len(image.channel)
        for c in range(beginc, endc + 1):
            ch = image.channel[c]
            if ch.w == 0 or ch.h == 0:
                raise FormatError("squeezing empty channel")
            if p.horizontal:
                w = ch.w
                ch.plane = np.zeros((ch.h, (w + 1) // 2), dtype=np.int32)
                if ch.hshift >= 0:
                    ch.hshift += 1
                resw, resh = w - (w + 1) // 2, ch.h
            else:
                h = ch.h
                ch.plane = np.zeros(((h + 1) // 2, ch.w), dtype=np.int32)
                if ch.vshift >= 0:
                    ch.vshift += 1
                resw, resh = ch.w, h - (h + 1) // 2
            # Residual placeholder gets the post-squeeze shifts.
            placeholder = Channel.create(resw, resh, ch.hshift, ch.vshift)
            placeholder.component = ch.component
            image.channel.insert(offset + (c - beginc), placeholder)


def _check_squeeze_params(p: SqueezeParams, num_channels: int) -> None:
    c1, c2 = p.begin_c, p.begin_c + p.num_c - 1
    if c1 >= num_channels or c2 >= num_channels or c2 < c1:
        raise FormatError("invalid squeeze channel range")


def smooth_tendency(b, a, n):
    """Vectorized SmoothTendency (squeeze.h:30-50)."""
    b = b.astype(np.int64)
    a = a.astype(np.int64)
    n = n.astype(np.int64)
    # Case 1: B >= a >= n
    d1 = (4 * b - 3 * n - a + 6) // 12
    d1 = np.where(d1 - (d1 & 1) > 2 * (b - a), 2 * (b - a) + 1, d1)
    d1 = np.where(d1 + (d1 & 1) > 2 * (a - n), 2 * (a - n), d1)
    # Case 2: B <= a <= n (C's truncating division on negatives)
    num2 = 4 * b - 3 * n - a - 6
    d2 = -((-num2) // 12)     # trunc toward zero for negative numerator
    d2 = np.where(num2 >= 0, num2 // 12, d2)
    d2 = np.where(d2 + (d2 & 1) < 2 * (b - a), 2 * (b - a) - 1, d2)
    d2 = np.where(d2 - (d2 & 1) < 2 * (a - n), 2 * (a - n), d2)
    out = np.zeros_like(b)
    out = np.where((b >= a) & (a >= n), d1, out)
    out = np.where((b <= a) & (a <= n), d2, out)
    return out


def _tdiv2(x):
    """C-style truncating division by 2 (rounds toward zero)."""
    return np.where(x >= 0, x // 2, -((-x) // 2))


def inv_hsqueeze(image: ModularImage, c: int, rc: int) -> None:
    chin = image.channel[c]
    chres = image.channel[rc]
    if chres.w == 0:
        image.channel[c].hshift -= 1
        return
    w_out = chin.w + chres.w
    out = np.zeros((chin.h, w_out), dtype=np.int64)
    if chres.h != 0:
        avg = chin.plane.astype(np.int64)
        res = chres.plane.astype(np.int64)
        # per-row scan: 'left' depends on previous output pixel
        for y in range(chin.h):
            p_avg = avg[y]
            p_res = res[y]
            p_out = out[y]
            left = p_avg[0]
            for x in range(chres.w):
                a = p_avg[x]
                next_avg = p_avg[x + 1] if x + 1 < chin.w else a
                lv = p_out[2 * x - 1] if x else a
                tendency = _smooth_tendency_scalar(lv, a, next_avg)
                diff = p_res[x] + tendency
                A = a + _trunc_div2_scalar(diff)
                p_out[2 * x] = A
                p_out[2 * x + 1] = A - diff
            if w_out & 1:
                p_out[w_out - 1] = p_avg[chin.w - 1]
    image.channel[c] = Channel(out.astype(np.int32), chin.hshift - 1,
                               chin.vshift)


def inv_vsqueeze(image: ModularImage, c: int, rc: int) -> None:
    chin = image.channel[c]
    chres = image.channel[rc]
    if chres.h == 0:
        image.channel[c].vshift -= 1
        return
    h_out = chin.h + chres.h
    out = np.zeros((h_out, chin.w), dtype=np.int64)
    if chres.w != 0:
        avg = chin.plane.astype(np.int64)
        res = chres.plane.astype(np.int64)
        for y in range(chres.h):
            p_avg = avg[y]
            p_navg = avg[y + 1] if y + 1 < chin.h else avg[y]
            p_pout = out[2 * y - 1] if y > 0 else p_avg
            tendency = smooth_tendency(p_pout, p_avg, p_navg)
            diff = res[y] + tendency
            o = p_avg + _tdiv2(diff)
            out[2 * y] = o
            out[2 * y + 1] = o - diff
        if h_out & 1:
            out[h_out - 1] = avg[chin.h - 1]
    image.channel[c] = Channel(out.astype(np.int32), chin.hshift,
                               chin.vshift - 1)


def _smooth_tendency_scalar(b, a, n):
    b, a, n = int(b), int(a), int(n)
    diff = 0
    if b >= a >= n:
        diff = (4 * b - 3 * n - a + 6) // 12
        if diff - (diff & 1) > 2 * (b - a):
            diff = 2 * (b - a) + 1
        if diff + (diff & 1) > 2 * (a - n):
            diff = 2 * (a - n)
    elif b <= a <= n:
        num = 4 * b - 3 * n - a - 6
        diff = num // 12 if num >= 0 else -((-num) // 12)
        if diff + (diff & 1) < 2 * (b - a):
            diff = 2 * (b - a) - 1
        if diff - (diff & 1) < 2 * (a - n):
            diff = 2 * (a - n)
    return diff


def _trunc_div2_scalar(x: int) -> int:
    return x // 2 if x >= 0 else -((-x) // 2)


def inv_squeeze(image: ModularImage, parameters: list[SqueezeParams]) -> None:
    """(squeeze.cc InvSqueeze)."""
    for p in reversed(parameters):
        _check_squeeze_params(p, len(image.channel))
        beginc, endc = p.begin_c, p.begin_c + p.num_c - 1
        offset = endc + 1 if p.in_place else \
            len(image.channel) + beginc - endc - 1
        if beginc < image.nb_meta_channels:
            image.nb_meta_channels -= p.num_c
        for c in range(beginc, endc + 1):
            rc = offset + c - beginc
            if rc >= len(image.channel):
                raise FormatError("invalid squeeze residual channel")
            if (image.channel[c].w < image.channel[rc].w or
                    image.channel[c].h < image.channel[rc].h):
                raise FormatError("corrupted squeeze")
            if p.horizontal:
                inv_hsqueeze(image, c, rc)
            else:
                inv_vsqueeze(image, c, rc)
        del image.channel[offset:offset + (endc - beginc + 1)]


# ---------------------------------------------------------------------------
# Palette (palette.cc)
# ---------------------------------------------------------------------------

_K_DELTA_PALETTE = np.array([
    [0, 0, 0], [4, 4, 4], [11, 0, 0], [0, 0, -13], [0, -12, 0],
    [-10, -10, -10], [-18, -18, -18], [-27, -27, -27], [-18, -18, 0],
    [0, 0, -32], [-32, 0, 0], [-37, -37, -37], [0, -32, -32], [24, 24, 45],
    [50, 50, 50], [-45, -24, -24], [-24, -45, -45], [0, -24, -24],
    [-34, -34, 0], [-24, 0, -24], [-45, -45, -24], [64, 64, 64],
    [-32, 0, -32], [0, -32, 0], [-32, 0, 32], [-24, -45, -24], [45, 24, 45],
    [24, -24, -45], [-45, -24, 24], [80, 80, 80], [64, 0, 0], [0, 0, -64],
    [0, -64, -64], [-24, -24, 45], [96, 96, 96], [64, 64, 0], [45, -24, -24],
    [34, -34, 0], [112, 112, 112], [24, -45, -45], [45, 45, -24],
    [0, -32, 32], [24, -24, 45], [0, 96, 96], [45, -24, 24], [24, -45, -24],
    [-24, -45, 24], [0, -64, 0], [96, 0, 0], [128, 128, 128], [64, 0, 64],
    [144, 144, 144], [96, 96, 0], [-36, -36, 36], [45, -24, -45],
    [45, -45, -24], [0, 0, -96], [0, 128, 128], [0, 96, 0], [45, 24, -45],
    [-128, 0, 0], [24, -45, 24], [-45, 24, -45], [64, 0, -64], [64, -64, -64],
    [96, 0, 96], [45, -45, 24], [24, 45, -45], [64, 64, -64], [128, 128, 0],
    [0, 0, -128], [-24, 45, -45]], dtype=np.int64)

_K_SMALL_CUBE = 4
_K_SMALL_CUBE_BITS = 2
_K_LARGE_CUBE = 5
_K_LARGE_CUBE_OFFSET = _K_SMALL_CUBE ** 3


def get_palette_value(palette: np.ndarray, index, c: int,
                      palette_size: int, bit_depth: int):
    """Vectorized GetPaletteValue (palette.h:53-120); index: int array."""
    index = np.asarray(index, dtype=np.int64)
    out = np.zeros_like(index)
    # negative: delta palette
    neg = index < 0
    if neg.any() and c < 3:
        ni = -(index[neg] + 1)
        ni = ni % (1 + 2 * (len(_K_DELTA_PALETTE) - 1))
        val = _K_DELTA_PALETTE[(ni + 1) >> 1, c]
        val = val * np.where((ni & 1) == 1, 1, -1)
        if bit_depth > 8:
            val = val << (bit_depth - 8)
        out[neg] = val
    # in-palette
    inp = (index >= 0) & (index < palette_size)
    if inp.any():
        out[inp] = palette[c, index[inp]]
    # small implicit cube
    small = (index >= palette_size) & (index < palette_size +
                                       _K_LARGE_CUBE_OFFSET)
    if small.any() and c < 3:
        si = (index[small] - palette_size) >> (c * _K_SMALL_CUBE_BITS)
        v = ((si % _K_SMALL_CUBE) * ((1 << bit_depth) - 1)) >> 2
        out[small] = v + (1 << max(0, bit_depth - 3))
    # large implicit cube
    large = index >= palette_size + _K_LARGE_CUBE_OFFSET
    if large.any() and c < 3:
        li = index[large] - palette_size - _K_LARGE_CUBE_OFFSET
        if c == 1:
            li = li // _K_LARGE_CUBE
        elif c == 2:
            li = li // (_K_LARGE_CUBE * _K_LARGE_CUBE)
        out[large] = ((li % _K_LARGE_CUBE) * ((1 << bit_depth) - 1)) >> 2
    return out


def meta_palette(image: ModularImage, begin_c: int, end_c: int,
                 nb_colors: int, nb_deltas: int) -> None:
    _check_equal_channels(image, begin_c, end_c)
    nb = end_c - begin_c + 1
    if begin_c >= image.nb_meta_channels:
        image.nb_meta_channels += 1
    else:
        if end_c >= image.nb_meta_channels:
            raise FormatError("invalid palette channels")
        image.nb_meta_channels += 2 - nb
    del image.channel[begin_c + 1:end_c + 1]
    pch = Channel.create(nb_colors + nb_deltas, nb, -1, -1)
    image.channel.insert(0, pch)


def inv_palette(image: ModularImage, begin_c: int, nb_colors: int,
                nb_deltas: int, predictor: int, wp_header) -> None:
    """(palette.cc InvPalette)."""
    from jxlbench.ref.jxl.modular.predict import (
        PREDICTOR_ZERO, predict_no_tree_scalar, WPState,
    )
    if image.nb_meta_channels < 1:
        raise FormatError("palette without palette channel")
    nb = image.channel[0].h
    c0 = begin_c + 1
    if c0 >= len(image.channel):
        raise FormatError("palette channel out of range")
    w, h = image.channel[c0].w, image.channel[c0].h
    if nb < 1:
        raise FormatError("corrupt palette")
    for i in range(1, nb):
        image.channel.insert(
            c0 + 1 + (i - 1),
            Channel.create(w, h, image.channel[c0].hshift,
                           image.channel[c0].vshift))
    palette = image.channel[0].plane.astype(np.int64)   # (nb, colors)
    bit_depth = min(image.bitdepth, 24)
    palette_size = image.channel[0].w

    if w == 0:
        pass
    elif nb_deltas == 0 and predictor == PREDICTOR_ZERO:
        indices = np.clip(image.channel[c0].plane.astype(np.int64), 0,
                          palette_size - 1) if nb == 1 else \
            image.channel[c0].plane.astype(np.int64)
        for c in range(nb):
            vals = get_palette_value(palette, indices, c, palette_size,
                                     bit_depth)
            image.channel[c0 + c].plane = vals.astype(np.int32)
    else:
        indices = image.channel[c0].plane.astype(np.int64).copy()
        for c in range(nb):
            ch = image.channel[c0 + c]
            plane = np.zeros((h, w), dtype=np.int64)
            entries = get_palette_value(palette, indices, c, palette_size,
                                        bit_depth)
            wp = WPState(wp_header, w, h) if predictor == 6 else None
            for y in range(h):
                for x in range(w):
                    idx = int(indices[y, x])
                    entry = int(entries[y, x])
                    if idx < nb_deltas:
                        guess = predict_no_tree_scalar(plane, x, y, w,
                                                       predictor, wp)
                        val = guess + entry
                    else:
                        val = entry
                    plane[y, x] = val
                    if wp is not None:
                        wp.update_errors(val, x, y, w)
            ch.plane = plane.astype(np.int32)
    if c0 >= image.nb_meta_channels:
        image.nb_meta_channels -= 1
    else:
        image.nb_meta_channels -= 2 - nb
    del image.channel[0]


# ---------------------------------------------------------------------------
# Forward transforms (encoder side; enc_transforms-inl.h)
# ---------------------------------------------------------------------------

def fwd_palette(image: ModularImage, begin_c: int, end_c: int,
                max_colors: int):
    """Forward palette (enc_palette.cc FwdPalette, explicit-colors case).

    Replaces channels [begin_c..end_c] by a single index channel plus a
    palette meta channel when the number of distinct colors is at most
    ``max_colors``. Returns the Transform to signal in the stream, or
    None if the image has too many colors (image unchanged)."""
    _check_equal_channels(image, begin_c, end_c)
    nb = end_c - begin_c + 1
    planes = [image.channel[begin_c + i].plane for i in range(nb)]
    h, w = planes[0].shape
    flat = [p.reshape(-1).astype(np.int64) for p in planes]
    lo = min(int(p.min()) for p in flat) if flat[0].size else 0
    if lo >= 0:
        # pack the color into one int64 key: unique on a 1-D key is
        # ~10x cheaper than np.unique(axis=0)'s lexsort, with the same
        # (lexicographic) palette order. A sparse sample bails early on
        # colorful images before the full pass.
        K = max(int(p.max()) for p in flat) + 1
        key = flat[0]
        for p in flat[1:]:
            key = key * K + p
        n = key.size
        if n > (1 << 16):
            samp = key[::max(1, n >> 14)]
            if len(np.unique(samp)) > max_colors:
                return None
        colors_key, inverse = np.unique(key, return_inverse=True)
        if len(colors_key) > max_colors:
            return None
        cols = np.empty((nb, len(colors_key)), np.int64)
        rem = colors_key
        for i in range(nb - 1, -1, -1):
            cols[i] = rem % K
            rem = rem // K
        colors = cols.T
    else:
        stacked = np.stack([p.reshape(-1) for p in planes], axis=1)
        colors, inverse = np.unique(stacked, axis=0, return_inverse=True)
        if len(colors) > max_colors:
            return None
        colors = np.asarray(colors)
    idx = inverse.reshape(h, w).astype(np.int32)
    pch = Channel(np.ascontiguousarray(
        np.asarray(colors).T).astype(np.int32), -1, -1)
    image.channel[begin_c].plane = idx
    del image.channel[begin_c + 1:end_c + 1]
    image.channel.insert(0, pch)
    if begin_c >= image.nb_meta_channels:
        image.nb_meta_channels += 1
    else:
        image.nb_meta_channels += 2 - nb
    return Transform(id=TransformId.PALETTE, begin_c=begin_c, num_c=nb,
                     nb_colors=len(colors), nb_deltas=0, predictor=0)


def _fwd_hsqueeze(image: ModularImage, c: int) -> Channel:
    """Squeeze channel c horizontally in place; returns the residual
    channel (enc_transforms-inl.h FwdHSqueeze)."""
    ch = image.channel[c]
    plane = ch.plane.astype(np.int64)
    h, w = plane.shape
    cw = (w + 1) // 2
    rw = w - cw
    avg = np.zeros((h, cw), np.int64)
    res = np.zeros((h, rw), np.int64)
    A = plane[:, 0:2 * rw:2]
    B = plane[:, 1:2 * rw:2]
    diff = A - B
    avg[:, :rw] = A - _tdiv2(diff)
    if w & 1:
        avg[:, cw - 1] = plane[:, w - 1]
    for x in range(rw):
        left = plane[:, 2 * x - 1] if x > 0 else avg[:, x]
        next_avg = avg[:, x + 1] if x + 1 < cw else avg[:, x]
        res[:, x] = diff[:, x] - smooth_tendency(left, avg[:, x], next_avg)
    hs = ch.hshift + 1 if ch.hshift >= 0 else ch.hshift
    image.channel[c] = Channel(avg.astype(np.int32), hs, ch.vshift)
    return Channel(res.astype(np.int32), hs, ch.vshift)


def _fwd_vsqueeze(image: ModularImage, c: int) -> Channel:
    ch = image.channel[c]
    plane = ch.plane.astype(np.int64)
    h, w = plane.shape
    chh = (h + 1) // 2
    rh = h - chh
    avg = np.zeros((chh, w), np.int64)
    res = np.zeros((rh, w), np.int64)
    A = plane[0:2 * rh:2]
    B = plane[1:2 * rh:2]
    diff = A - B
    avg[:rh] = A - _tdiv2(diff)
    if h & 1:
        avg[chh - 1] = plane[h - 1]
    for y in range(rh):
        top = plane[2 * y - 1] if y > 0 else avg[y]
        next_avg = avg[y + 1] if y + 1 < chh else avg[y]
        res[y] = diff[y] - smooth_tendency(top, avg[y], next_avg)
    vs = ch.vshift + 1 if ch.vshift >= 0 else ch.vshift
    image.channel[c] = Channel(avg.astype(np.int32), ch.hshift, vs)
    return Channel(res.astype(np.int32), ch.hshift, vs)


def fwd_squeeze(image: ModularImage, parameters: list[SqueezeParams]):
    """Forward squeeze; mirrors MetaSqueeze's channel layout so that
    ``inv_squeeze`` (and the reference decoder) restores the image."""
    if not parameters:
        parameters = default_squeeze_parameters(image)
    for p in parameters:
        _check_squeeze_params(p, len(image.channel))
        beginc, endc = p.begin_c, p.begin_c + p.num_c - 1
        if beginc < image.nb_meta_channels:
            if endc >= image.nb_meta_channels or not p.in_place:
                raise FormatError("invalid meta squeeze")
            image.nb_meta_channels += p.num_c
        offset = endc + 1 if p.in_place else len(image.channel)
        for c in range(beginc, endc + 1):
            if p.horizontal:
                residual = _fwd_hsqueeze(image, c)
            else:
                residual = _fwd_vsqueeze(image, c)
            image.channel.insert(offset + (c - beginc), residual)
    return parameters


# ---------------------------------------------------------------------------
# Modular lossy: squeeze-residual quantization (enc_modular.cc:81-107,
# 140-152, 979-1035). Encoder-side only — values are rounded to
# multiples of a per-channel q, the stream stays a plain modular one.
# ---------------------------------------------------------------------------

_SQUEEZE_QUALITY_FACTOR = 0.35
_SQUEEZE_LUMA_FACTOR = 1.1
_SQUEEZE_LUMA_QTABLE = (163.84, 81.92, 40.96, 20.48, 10.24, 5.12, 2.56,
                        1.28, 0.64, 0.32, 0.16, 0.08, 0.04, 0.02, 0.01,
                        0.005)
_SQUEEZE_CHROMA_QTABLE = (1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1,
                          0.5, 0.5, 0.5, 0.5, 0.5)


def quantize_squeeze(image: ModularImage, distance: float, maxval: int,
                     chroma_rct: bool, responsive: bool = True) -> None:
    """Round each non-meta channel to multiples of its squeeze-level q
    (QuantizeChannel): the amount of loss scales with the channel's
    resolution level, mimicking a wavelet quantizer. Channels from
    extra components (component >= 3 or unknown in a >3-channel image)
    stay lossless (ec_distance default 0)."""
    quantizer = 0.25 * (0.1 if not responsive else 1.0)
    qbase = quantizer * distance ** 1.2 * (maxval / 255.0)
    for i in range(image.nb_meta_channels, len(image.channel)):
        ch = image.channel[i]
        comp = ch.component
        if comp >= 3:
            continue                      # extra channel: lossless
        shift = min(ch.hshift + ch.vshift, 16)
        if shift > 0:
            shift -= 1
        if chroma_rct and 0 < comp < 3:
            q = int(qbase * _SQUEEZE_QUALITY_FACTOR *
                    _SQUEEZE_CHROMA_QTABLE[shift])
        else:
            q = int(qbase * _SQUEEZE_QUALITY_FACTOR *
                    _SQUEEZE_LUMA_FACTOR * _SQUEEZE_LUMA_QTABLE[shift])
        if q <= 1:
            continue
        p = ch.plane.astype(np.int64)
        ch.plane = np.where(
            p < 0, -((-p + q // 2) // q) * q,
            ((p + q // 2) // q) * q).astype(np.int32)
