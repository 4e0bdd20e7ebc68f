"""Modular predictors, per-pixel properties and the weighted predictor
(reference ``lib/jxl/modular/encoding/context_predict.h``,
``lib/jxl/modular/options.h:21-40``)."""

from __future__ import annotations

import numpy as np

# Predictor ids (options.h:21)
PREDICTOR_ZERO = 0
PREDICTOR_LEFT = 1
PREDICTOR_TOP = 2
PREDICTOR_AVG0 = 3
PREDICTOR_SELECT = 4
PREDICTOR_GRADIENT = 5
PREDICTOR_WEIGHTED = 6
PREDICTOR_TOPRIGHT = 7
PREDICTOR_TOPLEFT = 8
PREDICTOR_LEFTLEFT = 9
PREDICTOR_AVG1 = 10
PREDICTOR_AVG2 = 11
PREDICTOR_AVG3 = 12
PREDICTOR_AVG4 = 13
NUM_PREDICTORS = 14

NUM_STATIC_PROPERTIES = 2
NUM_NONREF_PROPERTIES = NUM_STATIC_PROPERTIES + 13 + 1  # = 16
WP_PROP = NUM_NONREF_PROPERTIES - 1  # 15
EXTRA_PROPS_PER_CHANNEL = 4


def clamped_gradient(n: int, w: int, l: int) -> int:
    m = min(n, w)
    M = max(n, w)
    grad = n + w - l
    if l < m:
        return M
    if l > M:
        return m
    return grad


def select_pred(a: int, b: int, c: int) -> int:
    p = a + b - c
    return a if abs(p - a) < abs(p - b) else b


def _tdiv(a: int, b: int) -> int:
    """C-style truncating integer division."""
    q = abs(a) // b
    return q if a >= 0 else -q


def wrap32(v: int) -> int:
    """int32 two's-complement wrap (PropertyVal = int32_t and the WP
    error stores, reference options.h:18 / context_predict.h:72-73;
    only observable on 32-bit-sample content)."""
    return ((int(v) + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def predict_one(p: int, left: int, top: int, toptop: int, topleft: int,
                topright: int, leftleft: int, toprightright: int,
                wp_pred: int) -> int:
    """(context_predict.h PredictOne)."""
    if p == PREDICTOR_ZERO:
        return 0
    if p == PREDICTOR_LEFT:
        return left
    if p == PREDICTOR_TOP:
        return top
    if p == PREDICTOR_SELECT:
        return select_pred(left, top, topleft)
    if p == PREDICTOR_WEIGHTED:
        return wp_pred
    if p == PREDICTOR_GRADIENT:
        return clamped_gradient(left, top, topleft)
    if p == PREDICTOR_TOPLEFT:
        return topleft
    if p == PREDICTOR_TOPRIGHT:
        return topright
    if p == PREDICTOR_LEFTLEFT:
        return leftleft
    if p == PREDICTOR_AVG0:
        return _tdiv(left + top, 2)
    if p == PREDICTOR_AVG1:
        return _tdiv(left + topleft, 2)
    if p == PREDICTOR_AVG2:
        return _tdiv(topleft + top, 2)
    if p == PREDICTOR_AVG3:
        return _tdiv(top + topright, 2)
    if p == PREDICTOR_AVG4:
        return _tdiv(6 * top - 2 * toptop + 7 * left + leftleft +
                     toprightright + 3 * topright + 8, 16)
    return 0


def _neighbors(plane: np.ndarray, x: int, y: int, w: int):
    """Edge-case neighbor values (context_predict.h Predict)."""
    left = int(plane[y, x - 1]) if x else (int(plane[y - 1, x]) if y else 0)
    top = int(plane[y - 1, x]) if y else left
    topleft = int(plane[y - 1, x - 1]) if (x and y) else left
    topright = int(plane[y - 1, x + 1]) if (x + 1 < w and y) else top
    leftleft = int(plane[y, x - 2]) if x > 1 else left
    toptop = int(plane[y - 2, x]) if y > 1 else top
    toprightright = int(plane[y - 1, x + 2]) if (x + 2 < w and y) else topright
    return left, top, topleft, topright, leftleft, toptop, toprightright


def predict_no_tree_scalar(plane: np.ndarray, x: int, y: int, w: int,
                           predictor: int, wp_state=None) -> int:
    left, top, topleft, topright, leftleft, toptop, trr = \
        _neighbors(plane, x, y, w)
    wp_pred = 0
    if wp_state is not None:
        wp_pred = wp_state.predict(x, y, w, top, left, topright, topleft,
                                   toptop)
    return predict_one(predictor, left, top, toptop, topleft, topright,
                       leftleft, trr, wp_pred)


class WPHeader:
    """Weighted predictor parameters (context_predict.h:28-61)."""

    __slots__ = ("p1C", "p2C", "p3Ca", "p3Cb", "p3Cc", "p3Cd", "p3Ce", "w")

    def __init__(self):
        self.p1C = 16
        self.p2C = 10
        self.p3Ca = 7
        self.p3Cb = 7
        self.p3Cc = 7
        self.p3Cd = 0
        self.p3Ce = 0
        self.w = [0xD, 0xC, 0xC, 0xC]

    def is_all_default(self) -> bool:
        return (self.p1C, self.p2C, self.p3Ca, self.p3Cb, self.p3Cc,
                self.p3Cd, self.p3Ce) == (16, 10, 7, 7, 7, 0, 0) and \
            self.w == [0xD, 0xC, 0xC, 0xC]

    def visit(self, v) -> None:
        if v.all_default(self.is_all_default()):
            if v.is_reading:
                self.__init__()
            return
        self.p1C = v.bits(5, self.p1C)
        self.p2C = v.bits(5, self.p2C)
        self.p3Ca = v.bits(5, self.p3Ca)
        self.p3Cb = v.bits(5, self.p3Cb)
        self.p3Cc = v.bits(5, self.p3Cc)
        self.p3Cd = v.bits(5, self.p3Cd)
        self.p3Ce = v.bits(5, self.p3Ce)
        self.w = [v.bits(4, x) for x in self.w]


_DIVLOOKUP = [(1 << 24) // (i + 1) for i in range(64)]
K_PRED_EXTRA_BITS = 3
K_PREDICTION_ROUND = ((1 << K_PRED_EXTRA_BITS) >> 1) - 1


def _floor_log2(x: int) -> int:
    return x.bit_length() - 1


class WPState:
    """Weighted predictor running state (context_predict.h State)."""

    def __init__(self, header: WPHeader, xsize: int, ysize: int):
        self.header = header or WPHeader()
        self.xsize = xsize
        self.pred = 0
        self.prediction = [0, 0, 0, 0]
        n = (xsize + 2) * 2
        self.pred_errors = [np.zeros(n, dtype=np.int64) for _ in range(4)]
        self.error = np.zeros(n, dtype=np.int64)

    def _error_weight(self, x: int, maxweight: int) -> int:
        shift = _floor_log2(x + 1) - 5
        if shift < 0:
            shift = 0
        return 4 + ((maxweight * _DIVLOOKUP[x >> shift]) >> shift)

    def _weighted_average(self, p, w) -> int:
        weight_sum = sum(w)
        log_weight = _floor_log2(weight_sum)
        w = [wi >> (log_weight - 4) for wi in w]
        weight_sum = sum(w)
        s = (weight_sum >> 1) - 1
        for i in range(4):
            s += p[i] * w[i]
        return (s * _DIVLOOKUP[weight_sum - 1]) >> 24

    def predict(self, x: int, y: int, xsize: int, top: int, left: int,
                topright: int, topleft: int, toptop: int,
                properties=None, prop_offset: int = 0) -> int:
        cur_row = 0 if (y & 1) else (xsize + 2)
        prev_row = (xsize + 2) if (y & 1) else 0
        pos_n = prev_row + x
        pos_ne = pos_n + 1 if x < xsize - 1 else pos_n
        pos_nw = pos_n - 1 if x > 0 else pos_n
        hdr = self.header
        weights = []
        for i in range(4):
            werr = (int(self.pred_errors[i][pos_n]) +
                    int(self.pred_errors[i][pos_ne]) +
                    int(self.pred_errors[i][pos_nw])) & 0xFFFFFFFF
            weights.append(self._error_weight(werr, hdr.w[i]))
        N = top << K_PRED_EXTRA_BITS
        W = left << K_PRED_EXTRA_BITS
        NE = topright << K_PRED_EXTRA_BITS
        NW = topleft << K_PRED_EXTRA_BITS
        NN = toptop << K_PRED_EXTRA_BITS
        teW = 0 if x == 0 else int(self.error[cur_row + x - 1])
        teN = int(self.error[pos_n])
        teNW = int(self.error[pos_nw])
        teNE = int(self.error[pos_ne])
        sumWN = teN + teW
        if properties is not None:
            p = teW
            if abs(teN) > abs(p):
                p = teN
            if abs(teNW) > abs(p):
                p = teNW
            if abs(teNE) > abs(p):
                p = teNE
            properties[prop_offset] = wrap32(p)
        self.prediction[0] = W + NE - N
        self.prediction[1] = N - (((sumWN + teNE) * hdr.p1C) >> 5)
        self.prediction[2] = W - (((sumWN + teNW) * hdr.p2C) >> 5)
        self.prediction[3] = N - ((teNW * hdr.p3Ca + teN * hdr.p3Cb +
                                   teNE * hdr.p3Cc + (NN - N) * hdr.p3Cd +
                                   (NW - W) * hdr.p3Ce) >> 5)
        self.pred = self._weighted_average(self.prediction, weights)
        if ((teN ^ teW) | (teN ^ teNW)) > 0:
            return (self.pred + K_PREDICTION_ROUND) >> K_PRED_EXTRA_BITS
        mx = max(W, NE, N)
        mn = min(W, NE, N)
        self.pred = max(mn, min(mx, self.pred))
        return (self.pred + K_PREDICTION_ROUND) >> K_PRED_EXTRA_BITS

    def update_errors(self, val: int, x: int, y: int, xsize: int) -> None:
        cur_row = 0 if (y & 1) else (xsize + 2)
        prev_row = (xsize + 2) if (y & 1) else 0
        val <<= K_PRED_EXTRA_BITS
        self.error[cur_row + x] = wrap32(self.pred - val)
        for i in range(4):
            err = (abs(self.prediction[i] - val) +
                   K_PREDICTION_ROUND) >> K_PRED_EXTRA_BITS
            # uint32 stores (context_predict.h:72)
            self.pred_errors[i][cur_row + x] = err & 0xFFFFFFFF
            self.pred_errors[i][prev_row + x + 1] = \
                (int(self.pred_errors[i][prev_row + x + 1]) + err) \
                & 0xFFFFFFFF


def predictor_has_wp(predictor: int) -> bool:
    return predictor == PREDICTOR_WEIGHTED


def compute_properties_scalar(props, plane: np.ndarray, x: int, y: int,
                              w: int, prev_grad: int):
    """Fill props[3..14]; returns new p[9] carry (context_predict.h:508-530).

    props[9] = W + N - NW of the *previous* pixel is consumed as
    props[8] = W - prev; the caller threads `prev_grad` between pixels and
    resets it to 0 at row starts (InitPropsRow)."""
    left, top, topleft, topright, leftleft, toptop, trr = \
        _neighbors(plane, x, y, w)
    props[3] = x
    props[4] = wrap32(abs(top))
    props[5] = wrap32(abs(left))
    props[6] = wrap32(top)
    props[7] = wrap32(left)
    props[8] = wrap32(left - prev_grad)
    props[9] = wrap32(left + top - topleft)
    props[10] = wrap32(left - topleft)
    props[11] = wrap32(topleft - top)
    props[12] = wrap32(top - topright)
    props[13] = wrap32(top - toptop)
    props[14] = wrap32(left - leftleft)
    return left, top, topleft, topright, leftleft, toptop, trr


def wp_mode_header(mode: int) -> WPHeader:
    """WP parameter presets (context_predict.h:214-276 PredictorMode):
    0 ~lossless16, 1 ~default lossless8, 2 ~west, 3 ~north, 4 other."""
    presets = {
        0: (16, 10, 7, 7, 7, 0, 0, [0xD, 0xC, 0xC, 0xC]),
        1: (8, 8, 4, 0, 3, 23, 2, [0xD, 0xC, 0xC, 0xB]),
        2: (10, 9, 7, 0, 0, 16, 9, [0xD, 0xC, 0xD, 0xC]),
        3: (16, 8, 0, 16, 0, 23, 0, [0xD, 0xD, 0xC, 0xC]),
        4: (10, 10, 5, 5, 5, 12, 4, [0xD, 0xC, 0xC, 0xC]),
    }
    h = WPHeader()
    (h.p1C, h.p2C, h.p3Ca, h.p3Cb, h.p3Cc, h.p3Cd, h.p3Ce,
     h.w) = presets[mode if mode in presets else 4]
    return h


def search_wp_mode(planes, n_modes: int) -> int:
    """EstimateWPCost (enc_modular.cc:1525-1541): rank the first
    ``n_modes`` WP presets by residual token entropy over the channel
    planes, return the winning mode (0 when native is unavailable)."""
    from jxlbench.ref.jxl.utils import native
    if not native.available() or n_modes <= 1:
        return 0
    best_mode, best_cost = 0, None
    for mode in range(n_modes):
        hdr = wp_mode_header(mode)
        cost = 0.0
        for plane in planes:
            res = native.wp_plane(np.ascontiguousarray(plane, np.int32),
                                  hdr)
            if res is None:
                return 0
            resid = plane.astype(np.int64) - res[0].astype(np.int64)
            packed = np.where(resid >= 0, 2 * resid, -2 * resid - 1)
            big = packed >= 16
            bl = np.frexp(packed.astype(np.float64))[1] - 1
            tok = np.where(big, 16 + (bl - 4) * 4 +
                           ((packed >> np.maximum(bl - 2, 0)) & 3),
                           packed)
            nbits = np.where(big, np.maximum(bl - 2, 0), 0)
            hist = np.bincount(tok.reshape(-1))
            nz = hist[hist > 0]
            tot = nz.sum()
            cost += float(-(nz * np.log2(nz / tot)).sum() + nbits.sum())
        if best_cost is None or cost < best_cost:
            best_cost, best_mode = cost, mode
    return best_mode
