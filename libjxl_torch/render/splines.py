"""Spline image features: decode + gaussian rendering (reference
``lib/jxl/splines.{h,cc}``).

Splines are centripetal Catmull-Rom curves with 32-coefficient DCT
profiles for color (XYB) and sigma along the arc; rendering walks the
curve in unit arc-length steps and splats an erf-based gaussian cross
section at each sample."""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from libjxl_torch.core.fields import FormatError
from libjxl_torch.core.headers import unpack_signed
from libjxl_torch.entropy.ans import ANSSymbolReader, decode_histograms

# context ids (splines.h:36-42)
CTX_QUANT_ADJ = 0
CTX_STARTING_POS = 1
CTX_NUM_SPLINES = 2
CTX_NUM_CONTROL_POINTS = 3
CTX_CONTROL_POINTS = 4
CTX_DCT = 5
NUM_SPLINE_CONTEXTS = 6

K_CHANNEL_WEIGHT = (0.0042, 0.075, 0.07, 0.3333)
K_RENDER_DISTANCE = 1.0


@dataclass
class QuantizedSpline:
    control_points: list = field(default_factory=list)  # delta-deltas
    color_dct: np.ndarray = None        # (3, 32) int
    sigma_dct: np.ndarray = None        # (32,) int


@dataclass
class Splines:
    quantization_adjustment: int = 0
    splines: list = field(default_factory=list)
    starting_points: list = field(default_factory=list)


def decode_splines(r, num_pixels: int) -> Splines:
    """(splines.cc:601-637 Splines::Decode)."""
    code = decode_histograms(r, NUM_SPLINE_CONTEXTS)
    dec = ANSSymbolReader(code, r)
    num_splines = dec.read_hybrid_uint(CTX_NUM_SPLINES, r) + 1
    max_cp = min(1 << 20, num_pixels // 2)
    if num_splines > max_cp:
        raise FormatError("too many splines")

    points = []
    last_x = last_y = 0
    for i in range(num_splines):
        dx = dec.read_hybrid_uint(CTX_STARTING_POS, r)
        dy = dec.read_hybrid_uint(CTX_STARTING_POS, r)
        if i == 0:
            x, y = dx, dy
        else:
            x = unpack_signed(dx) + last_x
            y = unpack_signed(dy) + last_y
        points.append((float(x), float(y)))
        last_x, last_y = x, y

    quant_adj = unpack_signed(dec.read_hybrid_uint(CTX_QUANT_ADJ, r))
    result = Splines(quant_adj, [], points)
    total_cp = num_splines
    for _ in range(num_splines):
        n = dec.read_hybrid_uint(CTX_NUM_CONTROL_POINTS, r)
        total_cp += n
        if total_cp > max_cp:
            raise FormatError("too many control points")
        cps = []
        for _ in range(n):
            a = unpack_signed(dec.read_hybrid_uint(CTX_CONTROL_POINTS, r))
            b = unpack_signed(dec.read_hybrid_uint(CTX_CONTROL_POINTS, r))
            cps.append((a, b))
        color = np.zeros((3, 32), np.int64)
        for c in range(3):
            for i in range(32):
                color[c, i] = unpack_signed(
                    dec.read_hybrid_uint(CTX_DCT, r))
        sigma = np.zeros(32, np.int64)
        for i in range(32):
            sigma[i] = unpack_signed(dec.read_hybrid_uint(CTX_DCT, r))
        result.splines.append(QuantizedSpline(cps, color, sigma))
    if not dec.check_final_state():
        raise FormatError("spline ANS checksum failed")
    return result


def _inv_adjusted_quant(adj: int) -> float:
    return 1.0 / (1.0 + 0.125 * adj) if adj >= 0 else (1.0 - 0.125 * adj)


def dequantize_spline(qs: QuantizedSpline, start, quant_adj: int,
                      y_to_x: float, y_to_b: float):
    """(splines.cc:443-531 Dequantize): control points + float DCTs."""
    cps = [(round(start[0]), round(start[1]))]
    cx, cy = cps[0]
    dx = dy = 0
    for (a, b) in qs.control_points:
        dx += a
        dy += b
        cx += dx
        cy += dy
        cps.append((cx, cy))
    inv_quant = _inv_adjusted_quant(quant_adj)
    color = np.zeros((3, 32), np.float32)
    for c in range(3):
        color[c] = qs.color_dct[c] * K_CHANNEL_WEIGHT[c] * inv_quant
        color[c, 0] *= math.sqrt(0.5)
    color[0] += y_to_x * color[1]
    color[2] += y_to_b * color[1]
    sigma = qs.sigma_dct * K_CHANNEL_WEIGHT[3] * inv_quant
    sigma = sigma.astype(np.float32)
    sigma[0] *= math.sqrt(0.5)
    return [(float(x), float(y)) for x, y in cps], color, sigma


def _catmull_rom(points):
    """DrawCentripetalCatmullRomSpline (splines.cc:300-343)."""
    if len(points) == 1:
        return list(points)
    pts = list(points)
    p0 = (2 * pts[0][0] - pts[1][0], 2 * pts[0][1] - pts[1][1])
    pn = (2 * pts[-1][0] - pts[-2][0], 2 * pts[-1][1] - pts[-2][1])
    pts = [p0] + pts + [pn]
    result = []
    kn = 16
    for s in range(len(pts) - 3):
        p = pts[s:s + 4]
        result.append(p[1])
        d = [0.0] * 3
        t = [0.0] * 4
        for k in range(3):
            d[k] = math.sqrt(math.hypot(p[k + 1][0] - p[k][0],
                                        p[k + 1][1] - p[k][1]))
            t[k + 1] = t[k] + d[k]
        for i in range(1, kn):
            tt = d[0] + (i / kn) * d[1]
            a = []
            for k in range(3):
                f = (tt - t[k]) / d[k]
                a.append((p[k][0] + f * (p[k + 1][0] - p[k][0]),
                          p[k][1] + f * (p[k + 1][1] - p[k][1])))
            b = []
            for k in range(2):
                f = (tt - t[k]) / (d[k] + d[k + 1])
                b.append((a[k][0] + f * (a[k + 1][0] - a[k][0]),
                          a[k][1] + f * (a[k + 1][1] - a[k][1])))
            f = (tt - t[1]) / d[1]
            result.append((b[0][0] + f * (b[1][0] - b[0][0]),
                           b[0][1] + f * (b[1][1] - b[0][1])))
    result.append(pts[-2])
    return result


def _equally_spaced(points):
    """ForEachEquallySpacedPoint (splines.cc:350-381): unit-arc samples,
    each with the distance to its predecessor."""
    out = [(points[0], K_RENDER_DISTANCE)]
    current = points[0]
    idx = 0
    while True:
        prev = current
        arc = 0.0
        while True:
            if idx >= len(points):
                out.append((prev, arc))
                return out
            nxt = points[idx]
            seg = math.hypot(nxt[0] - prev[0], nxt[1] - prev[1])
            if arc + seg >= K_RENDER_DISTANCE:
                f = (K_RENDER_DISTANCE - arc) / seg
                current = (prev[0] + f * (nxt[0] - prev[0]),
                           prev[1] + f * (nxt[1] - prev[1]))
                out.append((current, K_RENDER_DISTANCE))
                break
            arc += seg
            prev = nxt
            idx += 1


def _continuous_idct(dct: np.ndarray, t: float) -> float:
    i = np.arange(32)
    return float(np.sum(math.sqrt(2) * dct *
                        np.cos(i * (math.pi / 32) * (t + 0.5))))


def _erf(x: np.ndarray) -> np.ndarray:
    """Vectorized erf (Abramowitz & Stegun 7.1.26, |err| < 1.5e-7)."""
    sign = np.sign(x)
    x = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t -
                0.284496736) * t + 0.254829592) * t * np.exp(-x * x)
    return sign * y


def render_splines(xyb: np.ndarray, splines: Splines, y_to_x: float,
                   y_to_b: float, row0: int = 0,
                   h_total: int | None = None) -> np.ndarray:
    """Add all splines to (3, H, W) XYB (InitializeDrawCache + DrawSegment
    semantics, splines.cc:40-230, 660-760).

    ``row0``/``h_total``: render only the window of image rows
    [row0, row0 + H) of an h_total-tall frame (banded decode); segment
    pixels are absolute, so the windowed result equals the whole-frame
    rows exactly."""
    _, h, w = xyb.shape
    if h_total is None:
        h_total = h
    out = xyb.astype(np.float32).copy()
    for qs, start in zip(splines.splines, splines.starting_points):
        cps, color_dct, sigma_dct = dequantize_spline(
            qs, start, splines.quantization_adjustment, y_to_x, y_to_b)
        for a, b in zip(cps, cps[1:]):
            if a == b:
                raise FormatError("identical successive spline points")
        dense = _catmull_rom(cps)
        samples = _equally_spaced(dense)
        arc_length = (len(samples) - 2) * K_RENDER_DISTANCE + samples[-1][1]
        if arc_length <= 0:
            continue
        for k, (point, multiplier) in enumerate(samples):
            progress = min(1.0, k * K_RENDER_DISTANCE / arc_length)
            t = 31 * progress
            color = [_continuous_idct(color_dct[c], t) for c in range(3)]
            sigma = _continuous_idct(sigma_dct, t)
            if not (np.isfinite(sigma) and sigma != 0 and
                    np.isfinite(1.0 / sigma)):
                continue
            max_color = max(0.01, *(abs(c * multiplier) for c in color))
            dist_exp = 5.0
            maxd = math.sqrt(-2 * sigma * sigma *
                             (math.log(0.1) * dist_exp - math.log(max_color)))
            cx, cy = point
            y0 = max(row0, round(cy - maxd))
            y1 = min(row0 + h, round(cy + maxd) + 1)
            x0 = max(0, round(cx - maxd))
            x1 = min(w, round(cx + maxd) + 1)
            if y1 <= y0 or x1 <= x0:
                continue
            xs = np.arange(x0, x1, dtype=np.float32) - cx
            ys = np.arange(y0, y1, dtype=np.float32) - cy
            dist = np.sqrt(xs[None, :] ** 2 + ys[:, None] ** 2)
            inv_sigma = 1.0 / sigma
            c1 = 0.353553391
            odf = (_erf((0.5 * dist + c1) * inv_sigma) -
                   _erf((0.5 * dist - c1) * inv_sigma))
            local = (0.25 * sigma * multiplier) * odf * odf
            for c in range(3):
                out[c, y0 - row0:y1 - row0, x0:x1] += color[c] * local
    return out


def serialize_splines(w, splines: Splines) -> None:
    """Encoder side (reference ``lib/jxl/enc_splines.cc``): tokens over the
    six spline contexts, shared-histogram ANS."""
    from libjxl_torch.core.headers import pack_signed
    from libjxl_torch.entropy.ans import (
        build_entropy_codes, tokens_to_array, write_entropy_codes,
        write_tokens,
    )

    toks = [(CTX_NUM_SPLINES, len(splines.splines) - 1)]
    last = None
    for (x, y) in splines.starting_points:
        if last is None:
            toks += [(CTX_STARTING_POS, int(x)), (CTX_STARTING_POS, int(y))]
        else:
            toks += [(CTX_STARTING_POS, pack_signed(int(x) - last[0])),
                     (CTX_STARTING_POS, pack_signed(int(y) - last[1]))]
        last = (int(x), int(y))
    toks.append((CTX_QUANT_ADJ, pack_signed(splines.quantization_adjustment)))
    for qs in splines.splines:
        toks.append((CTX_NUM_CONTROL_POINTS, len(qs.control_points)))
        for (a, b) in qs.control_points:
            toks += [(CTX_CONTROL_POINTS, pack_signed(a)),
                     (CTX_CONTROL_POINTS, pack_signed(b))]
        for c in range(3):
            for i in range(32):
                toks.append((CTX_DCT, pack_signed(int(qs.color_dct[c][i]))))
        for i in range(32):
            toks.append((CTX_DCT, pack_signed(int(qs.sigma_dct[i]))))
    arr = tokens_to_array(toks)
    codes = build_entropy_codes([arr], num_contexts=NUM_SPLINE_CONTEXTS)
    write_entropy_codes(w, codes)
    write_tokens(w, arr, codes)


def find_splines(xyb: np.ndarray) -> Splines | None:
    """Encoder-side spline detection (enc_splines.cc:103-106
    FindSplines). The reference ships this as an explicit stub — "TODO:
    implement spline detection" returning an empty set — so detection
    parity is: no splines are auto-detected. User-supplied splines are
    encoded through ``LossyOptions.splines`` (the reference's
    cparams.custom_splines path, enc_heuristics.cc:1046-1048)."""
    return None
