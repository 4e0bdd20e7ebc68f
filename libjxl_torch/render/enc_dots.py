"""Encoder-side dot detection (reference ``lib/jxl/enc_detect_dots.cc``
DetectGaussianEllipses, ``enc_dot_dictionary.cc`` FindDotDictionary).

Isolated high-energy speckles (dots) are expensive for VarDCT at low
quality; the reference detects them, fits a Gaussian ellipse to gate
acceptance, and ships each accepted dot as a tiny single-occurrence
patch (pixels = opsin - smooth background) through the patch
dictionary. This is an encoder heuristic that runs once on the host;
the arrays are small and the math is vectorized numpy.

Pipeline (enc_detect_dots.cc:553-621):
 * energy image: Y-channel squared difference between a lightly
   smoothed (sigma 0.65) and a heavily smoothed (iterated sigma 3)
   opsin (:152-176; color coefs (0, 10, 0) :66-68)
 * connected components above (t_low, t_high) hysteresis thresholds,
   window- and score-gated (:299-341)
 * moment-based Gaussian ellipse fit with least-squares intensity
   (:411-520 FitGaussianFast) and loss gates (:345-408)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# dot-specific detection parameters (enc_dot_dictionary.cc:46-56)
T_HIGH = 0.04
T_LOW = 0.02
MAX_WIN_SIZE = 5
MAX_L2_LOSS = 0.005
MAX_CUSTOM_LOSS = 300.0
MIN_INTENSITY = 0.12
MAX_DIST_MEAN_MODE = 1.0
MAX_NEG_PIXELS = 0
MIN_SCORE = 12.0
MAX_CC = 100
MAX_CC_SIZE = 1000                     # enc_detect_dots.cc:188
K_MIN_BUTTERAUGLI_FOR_DOTS = 3.0       # enc_params.h:194

# separable 5-tap kernels (enc_detect_dots.cc:130-149)
_G065 = (0.558311, 0.210395, 0.010449)   # smooths noise, preserves dots
_G3 = (0.222338, 0.210431, 0.1784)       # (iterated) removes dots


def _sep5(plane: np.ndarray, w) -> np.ndarray:
    """Separable 5-tap convolution with mirrored boundary."""
    p = np.pad(plane, 2, mode="symmetric")
    h = (w[0] * p[:, 2:-2] + w[1] * (p[:, 1:-3] + p[:, 3:-1]) +
         w[2] * (p[:, :-4] + p[:, 4:]))
    return (w[0] * h[2:-2] + w[1] * (h[1:-3] + h[3:-1]) +
            w[2] * (h[:-4] + h[4:]))


def _energy_and_smooth(xyb: np.ndarray):
    """(energy (h, w), smooth (3, h, w)) — ComputeEnergyImage."""
    smooth = np.stack([_sep5(_sep5(xyb[c], _G3), _G3) for c in range(3)])
    fy = _sep5(xyb[1], _G065)
    d = fy - smooth[1]
    return 10.0 * d * d, smooth


def _find_components(energy: np.ndarray):
    """Hysteresis connected components: seeds > T_HIGH grown over
    > T_LOW (8-neighborhood), bounding window < MAX_WIN_SIZE."""
    img = energy.copy()
    h, w = img.shape
    out = []
    seeds = np.argwhere(img > T_HIGH)
    for sy, sx in seeds:
        if img[sy, sx] <= T_LOW:       # already consumed
            continue
        img[sy, sx] = 0.0
        pixels = []
        q = [(int(sy), int(sx))]
        too_big = False
        while q:
            y, x = q.pop()
            pixels.append((y, x))
            if len(pixels) > MAX_CC_SIZE:
                too_big = True
                break
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    ny, nx = y + dy, x + dx
                    if 0 <= ny < h and 0 <= nx < w and \
                            img[ny, nx] > T_LOW:
                        img[ny, nx] = 0.0
                        q.append((ny, nx))
        if too_big:
            continue
        ys = [p[0] for p in pixels]
        xs = [p[1] for p in pixels]
        y0, y1 = min(ys), max(ys)
        x0, x1 = min(xs), max(xs)
        if y1 - y0 + 1 >= MAX_WIN_SIZE or x1 - x0 + 1 >= MAX_WIN_SIZE:
            continue
        out.append((y0, x0, y1 - y0 + 1, x1 - x0 + 1))
    return out


@dataclass
class _CCStats:
    score: float
    mode: tuple           # (y, x) of max energy


def _cc_stats(energy: np.ndarray, box, extra: int = 4) -> _CCStats:
    """Inside-vs-background energy score (ConnectedComponent::CompStats)."""
    y0, x0, bh, bw = box
    h, w = energy.shape
    ya, yb = max(0, y0 - extra), min(h, y0 + bh + extra)
    xa, xb = max(0, x0 - extra), min(w, x0 + bw + extra)
    win = energy[ya:yb, xa:xb]
    iy, ix = np.unravel_index(np.argmax(win), win.shape)
    mode = (ya + int(iy), xa + int(ix))
    inner = np.zeros(win.shape, bool)
    inner[y0 - ya:y0 - ya + bh, x0 - xa:x0 - xa + bw] = True
    e_in = win[inner]
    e_out = win[~inner]
    if e_out.size == 0 or e_in.size == 0:
        return _CCStats(0.0, mode)
    var_bg = e_out.var()
    score = (e_in.mean() - e_out.mean()) / np.sqrt(max(var_bg, 1e-18))
    return _CCStats(float(score), mode)


def _fit_gaussian(xyb, smooth, box, mode):
    """Moment fit + least-squares intensity (FitGaussianFast) and the
    loss gates (ComputeDotLosses). Returns a dict or None."""
    _, h, w = xyb.shape
    my, mx = mode
    r = 2                               # kEllipseWindowSize >> 1
    ya, yb = max(0, my - r), min(h, my + r + 1)
    xa, xb = max(0, mx - r), min(w, mx + r + 1)
    dy_ = xyb[1, ya:yb, xa:xb] - smooth[1, ya:yb, xa:xb]
    color = xyb[:, my, mx] - smooth[:, my, mx]
    sign = 1.0 if color[1] > 0 else -1.0
    wgt = np.maximum(1e-6, sign * dy_)
    ys, xs = np.mgrid[ya:yb, xa:xb]
    s = wgt.sum()
    m1y = (wgt * ys).sum() / s
    m1x = (wgt * xs).sum() / s
    cyy = (wgt * ys * ys).sum() / s - m1y * m1y
    cxx = (wgt * xs * xs).sum() / s - m1x * m1x
    cxy = (wgt * xs * ys).sum() / s - m1x * m1y
    cov = np.array([[cxx, cxy], [cxy, cyy]])
    evals, evecs = np.linalg.eigh(cov)
    i_big = int(np.argmax(evals))
    sigma_x = float(max(evals[i_big], 1e-6))
    sigma_y = float(max(evals[1 - i_big], 1e-6))
    angle = float(np.arctan2(evecs[1, i_big], evecs[0, i_big]))
    ct, st = np.cos(angle), np.sin(angle)

    def gauss(px, py, sx, sy, amp):
        rx = ct * (px - m1x) + st * (py - m1y)
        ry = -st * (px - m1x) + ct * (py - m1y)
        return amp * np.exp(-0.5 * (rx * rx / sx + ry * ry / sy))

    g = gauss(xs, ys, sigma_x, sigma_y, 1.0)
    gg = (g * g).sum()
    intensity = np.empty(3)
    for c in range(3):
        target = xyb[c, ya:yb, xa:xb] - smooth[c, ya:yb, xa:xb]
        intensity[c] = (g * target).sum() / (gg + 1e-6)

    # losses over bounds + 2 (ComputeDotLosses, rectBounds=2)
    y0, x0, bh, bw = box
    la, lb = max(0, y0 - 2), min(h, y0 + bh + 2)
    lc, ld = max(0, x0 - 2), min(w, x0 + bw + 2)
    lys, lxs = np.mgrid[la:lb, lc:ld]
    bg = smooth[:, la:lb, lc:ld]
    n = 3 * lys.size
    l2 = 0.0
    custom = 0.0
    neg_pixels = 0
    for c in range(3):
        dot = gauss(lxs, lys, sigma_x, sigma_y, intensity[c])
        target = xyb[c, la:lb, lc:ld]
        neg_pixels += int((dot > target + 0.1).sum())
        diff = target - (bg[c] + dot)
        l2 += float((diff * diff).sum())
        wq = gauss(lxs, lys, 1.0 + sigma_x, 1.0 + sigma_y, 1.0)
        custom += float((wq * diff * diff).sum())
    dist_mm = (m1x - mx) ** 2 + (m1y - my) ** 2
    l2 /= n
    custom = custom / n + 20.0 * dist_mm
    return dict(x=m1x, y=m1y, intensity=intensity, l2=l2, custom=custom,
                neg_pixels=neg_pixels, dist_mm=dist_mm)


def find_dots(xyb: np.ndarray):
    """DetectGaussianEllipses: returns a list of
    ``enc_patches.FoundPatch`` (single-occurrence residual patches) for
    accepted dots."""
    from libjxl_torch.render.enc_patches import FoundPatch

    xyb = np.asarray(xyb, np.float64)
    energy, smooth = _energy_and_smooth(xyb)
    boxes = _find_components(energy)
    scored = []
    for box in boxes:
        st = _cc_stats(energy, box)
        if st.score >= MIN_SCORE:
            scored.append((st.score, box, st.mode))
    scored.sort(key=lambda t: -t[0])
    out = []
    _, h, w = xyb.shape
    for _, box, mode in scored[:MAX_CC]:
        fit = _fit_gaussian(xyb, smooth, box, mode)
        if fit is None:
            continue
        if not (0.0 <= fit["x"] < w and 0.0 <= fit["y"] < h):
            continue
        if fit["neg_pixels"] > MAX_NEG_PIXELS:
            continue
        inten = (0.21 * fit["intensity"][0] + 0.72 * fit["intensity"][1] +
                 0.07 * fit["intensity"][2])
        if (fit["l2"] < MAX_L2_LOSS and fit["custom"] < MAX_CUSTOM_LOSS and
                inten * inten > MIN_INTENSITY * MIN_INTENSITY and
                fit["dist_mm"] < MAX_DIST_MEAN_MODE ** 2):
            y0, x0, bh, bw = box
            pix = (xyb[:, y0:y0 + bh, x0:x0 + bw] -
                   smooth[:, y0:y0 + bh, x0:x0 + bw]).astype(np.float32)
            out.append(FoundPatch(pixels=pix, positions=[(x0, y0)]))
    return out
