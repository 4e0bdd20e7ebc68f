"""AC strategy selection + variable-size transform encoding (reference
``lib/jxl/enc_ac_strategy.cc`` FindBestAcStrategy, ``enc_group.cc``).

Hierarchical rate-distortion choice between DCT8, DCT16X16 and DCT32X32
per 32x32 superblock; candidate evaluation is batched per strategy
(one einsum per transform size). Chosen regions are quantized with
their strategy's dequant table, LLF positions feed the DC grid through
DCFromLowestFrequencies."""

from __future__ import annotations

import numpy as np

from libjxl_torch.vardct.ac_strategy import (
    COVERED_X, COVERED_Y, STRATEGY_ORDER, natural_order,
)
from libjxl_torch.vardct.dct import (
    coeffs_rc_to_stored, dct_matrix, dc_from_llf,
)
from libjxl_torch.vardct.frame_dec import adjust_quant_bias
from libjxl_torch.vardct.ac_context import (
    K_COEFF_FREQ_CONTEXT, K_COEFF_NUM_NONZERO_CONTEXT,
)

_KNZ_ARR = np.asarray(K_COEFF_NUM_NONZERO_CONTEXT, dtype=np.int64)
_KFR_ARR = np.asarray(K_COEFF_FREQ_CONTEXT, dtype=np.int64)

ACS_DCT8 = 0
ACS_DCT16 = 4
ACS_DCT32 = 5
ACS_DCT16X8 = 6     # 2 blocks tall, 1 wide
ACS_DCT8X16 = 7     # 1 block tall, 2 wide
ACS_DCT32X16 = 10   # 4 tall, 2 wide
ACS_DCT16X32 = 11   # 2 tall, 4 wide
ACS_DCT64 = 18      # 8 tall, 8 wide
ACS_DCT64X32 = 19   # 8 tall, 4 wide
ACS_DCT32X64 = 20   # 4 tall, 8 wide


def _regions(arr: np.ndarray, by0, bx0, nblk_y, nblk_x):
    """Gather (n, nblk_y*8, nblk_x*8) pixel regions at block coords."""
    out = np.empty((len(by0), nblk_y * 8, nblk_x * 8), arr.dtype)
    for i, (by, bx) in enumerate(zip(by0, bx0)):
        out[i] = arr[by * 8:(by + nblk_y) * 8, bx * 8:(bx + nblk_x) * 8]
    return out


def _batched_dct(regions: np.ndarray) -> np.ndarray:
    """(n, R, C) pixels -> (n, R, C) coefficients (two BLAS matmuls; a
    3-operand einsum without optimize= is a naive O(R^2 C^2) loop)."""
    r, c = regions.shape[1:]
    mr = dct_matrix(r)
    mc = dct_matrix(c)
    return (mr @ regions) @ mc.T


def _rate_estimate(q: np.ndarray, covered: int) -> np.ndarray:
    """Cheap bits estimate per region: ~token+mantissa bits for nonzeros
    (enc_ac_strategy.cc EstimateEntropy spirit). q: (n, size)."""
    aq = np.abs(q[:, covered:])
    nz = aq > 0
    bits = np.where(nz, np.log2(aq + 1) * 2.0 + 1.2, 0.02)
    return bits.sum(axis=1) + 12.0


# 5x5 symmetric blur of the 1x1 masking field (Blur1x1Masking,
# enc_adaptive_quantization.cc:634-662; quadrant c r R / r d L / R L D)
def _mask1x1_kernel() -> np.ndarray:
    k0, k1, k2, k3, k4 = (0.364911248, 0.05, 0.1688888021,
                          0.221069183, 0.306563504)
    norm = 1.0 / (1.0 + 4 * (k0 + k1 + k2 + k4 + 2 * k3))
    c, r, R, d, D, L = (np.array(v) * norm
                        for v in (1.0, k0, k2, k1, k4, k3))
    ker = np.array([[D, L, R, L, D],
                    [L, d, r, d, L],
                    [R, r, c, r, R],
                    [L, d, r, d, L],
                    [D, L, R, L, D]])
    return ker


_MASK1X1_KER = _mask1x1_kernel()


def compute_mask1x1(y_plane, xp=np):
    """Per-pixel ringing-visibility weight: 1/(log1p|gamma-matched 1x1
    Laplacian|+0.01), 5x5-blurred (enc_adaptive_quantization.cc
    ComputeTile scalar_pixel1x1 :501-521 + Blur1x1Masking). Smooth
    pixels weigh quantization error up to ~100x — the term that stops
    big DCT blocks from ringing into flat areas."""
    from libjxl_torch.vardct.adaptive_quant import _ratio_cbrt_to_gamma
    y = y_plane
    up = xp.concatenate([y[:1], y[:-1]], axis=0)
    dn = xp.concatenate([y[1:], y[-1:]], axis=0)
    lf = xp.concatenate([y[:, :1], y[:, :-1]], axis=1)
    rt = xp.concatenate([y[:, 1:], y[:, -1:]], axis=1)
    base = 0.25 * (up + dn + lf + rt)
    gammac = _ratio_cbrt_to_gamma(y + 0.019, False, xp=xp)
    diff = xp.log1p(xp.abs(gammac * (y - base)))
    m = 1.0 / (diff + 0.01)
    pad = xp.pad(m, 2, mode="reflect")
    ker = _MASK1X1_KER
    out = xp.zeros_like(m)
    for dy in range(5):
        for dx in range(5):
            out = out + ker[dy, dx] * pad[dy:dy + m.shape[0],
                                          dx:dx + m.shape[1]]
    return out


def acs_cost_params(distance: float):
    """Distance-scaled rate/loss weights (enc_ac_strategy.cc:1111-1123)."""
    bias = 0.13731742964354549
    ratio = (distance + bias) / (1.0 + bias)
    info_loss = 1.2 * ratio ** 0.33677806662454718
    zeros_mul = 9.3089059022677905 * ratio ** 0.50990926717963703
    cost_delta = 10.833273317067883 * ratio ** 0.36702940662370243
    return cost_delta, zeros_mul, info_loss


_MASKU_OFF = (12.0, 0.0, 4.0)        # masku_lut, enc_ac_strategy.cc:450
_CH_MUL = (8.2, 1.0, 1.03)           # kChannelMul^(1/8), :478-482


def strategy_rate_loss(xyb, raw_quant, tables3, scale: float,
                       strategy: int, mask1x1, distance: float,
                       cmap_x: float = 0.0, cmap_b: float = 1.0, xp=np):
    """(cost, loss) grids over all aligned anchor positions of one
    strategy, evaluated over ALL THREE channels with base-CfL
    subtraction (EstimateEntropy, enc_ac_strategy.cc:364-510).

    ``cost`` is the rate + Y-L2-distortion estimate the merge
    multipliers scale; ``loss`` is the masked PIXEL-DOMAIN
    information-loss term: the L8 norm of mask1x1-weighted
    reconstruction error with the reference's per-channel weights (X
    errors 8.2x) and the X-channel big-block ringing punisher
    (:497-503). The L8 norm is what makes one ringing pixel condemn a
    whole big block, and the X weighting is what stops merges across
    red-green (colored) edges a Y-only cost cannot see — both were
    missing in rounds 1-3 (+80% BD-rate on collages/screenshots).
    xp-generic: numpy on host, jnp in the device grids program."""
    lam = 5.5 / (distance * distance)
    _, _, info_loss = acs_cost_params(distance)
    nby, nbx = COVERED_Y[strategy], COVERED_X[strategy]
    rows, cols = nby * 8, nbx * 8
    H, W = xyb.shape[1:]
    gy, gx = H // rows, W // cols
    if gy == 0 or gx == 0:
        return xp.zeros((0, 0)), xp.zeros((0, 0))
    dt = xyb.dtype

    def windows(plane):
        return plane[:gy * rows, :gx * cols].reshape(
            gy, rows, gx, cols).transpose(0, 2, 1, 3).reshape(
            gy * gx, rows, cols)

    mr = xp.asarray(dct_matrix(rows), dt)
    mc = xp.asarray(dct_matrix(cols), dt)
    qfw = raw_quant[:gy * nby, :gx * nbx].reshape(
        gy, nby, gx, nbx).transpose(0, 2, 1, 3).reshape(
        gy * gx, -1).astype(dt)
    qf = qfw.max(axis=1)
    covered = nby * nbx
    size = covered * 64
    if covered <= 2:
        qn = qf * scale
    else:
        qn = ((qfw * scale) ** 16).mean(axis=1) ** (1.0 / 16.0)
    mwin = windows(mask1x1)
    w_x = 1.0 + min(3.0, covered / 8.0) if covered >= 2 else 1.0
    pos = xp.arange(size) >= covered

    def stored_of(plane):
        coef = (mr @ windows(plane)) @ mc.T
        return (xp.swapaxes(coef, 1, 2) if rows >= cols else
                coef).reshape(gy * gx, -1)

    st_y = stored_of(xyb[1])
    rate = None
    l8sum = None
    cost_extra = None
    for c, (st, cf) in enumerate((
            (stored_of(xyb[0]), cmap_x), (st_y, 0.0),
            (stored_of(xyb[2]), cmap_b))):
        if cf != 0.0:
            st = st - cf * st_y
        table = xp.asarray(tables3[c], dt)
        th = xp.asarray(_thresholds(nby, nbx, c == 1), dt)
        val = st * (scale / table)[None, :] * qf[:, None]
        q = xp.where(xp.abs(val) >= th[None, :], xp.round(val), 0.0)
        aq = xp.abs(q) * pos[None, :]
        nzbits = xp.where(aq > 0, xp.log2(aq + 1) * 2.0 + 1.2, 0.02)
        rate_c = (nzbits * pos[None, :]).sum(axis=1)
        err = (adjust_quant_bias_xp(q, xp) * table[None, :] *
               (1.0 / (scale * qf))[:, None] - st) * pos[None, :]
        err_rc = (xp.swapaxes(err.reshape(gy * gx, cols, rows), 1, 2)
                  if rows >= cols else err.reshape(gy * gx, rows, cols))
        err_px = (mr.T @ err_rc) @ mc
        l8c = ((_CH_MUL[c] * (mwin + _MASKU_OFF[c]) * err_px) ** 8
               ).sum(axis=(1, 2))
        if c == 0:
            # X-channel ringing punisher for big blocks (:497-503; w
            # scales the already-8th-power loss sum, as the reference)
            l8c = w_x * l8c
        l8sum = l8c if l8sum is None else l8sum + l8c
        if c == 1:
            # only the Y rate + L2 feed the multiplied cost (the merge
            # multipliers were calibrated against the Y-only estimate;
            # full-weight chroma rate over-fragments smooth colored
            # content, sky +43% BD). Chroma enters through the masked
            # loss, where X errors carry the reference's 8.2x weight.
            rate = rate_c
            cost_extra = lam * (err * err).sum(axis=1)
    cost = rate + 12.0 + cost_extra
    loss = info_loss * (l8sum / size) ** 0.125 * size / qn
    return cost.reshape(gy, gx), loss.reshape(gy, gx)


def adjust_quant_bias_xp(q, xp):
    """xp-generic adjust_quant_bias for channel Y (quantizer.cc:131)."""
    if xp is np:
        return adjust_quant_bias(q, 1)
    from libjxl_torch.models.vardct_pipeline import _adjust_quant_bias
    return _adjust_quant_bias(q, 1)


def _quantize_y(coef_stored, table_flat, qac, thres):
    val = coef_stored * (table_flat[None, :] * qac[:, None])
    return np.where(np.abs(val) >= thres[None, :], np.rint(val), 0.0)


def _thresholds(nblk_y, nblk_x, c_is_y: bool) -> np.ndarray:
    """Dead-zone thresholds over the stored layout (enc_group.cc:60-70,
    329-360); quadrant structure, wider dead zone on bigger blocks."""
    rows, cols = min(nblk_y, nblk_x) * 8, max(nblk_y, nblk_x) * 8
    t0, tr = (0.56, 0.62) if c_is_y else (0.58, 0.62)
    th = np.full((rows, cols), tr)
    th[:rows // 2, :cols // 2] = t0
    if not c_is_y and nblk_x * nblk_y >= 4:
        th = np.maximum(th - 0.00744 * nblk_x * nblk_y, 0.5)
    th[0, 0] = 0.0
    return th.reshape(-1)


def choose_acs(xyb_planes: np.ndarray, raw_quant: np.ndarray, matrices,
               quantizer, distance: float, try_small: bool = False,
               try_64: bool = False, try_32: bool = True,
               grids: dict | None = None,
               heterogeneous: bool | None = None):
    """RD selection on the Y channel. Returns (acs_raw, anchors,
    raw_quant') with merged regions given their anchor's max qf.

    ``try_small``: also evaluate the 8x8 special transforms (IDENTITY,
    DCT2X2, DCT4X4, DCT4X8/8X4, AFV0-3; enc_ac_strategy.cc
    kTransforms8x8) for blocks left unmerged.

    ``try_64``: second-level merge pass promoting 64x64 regions to
    DCT64X64 / DCT64X32 / DCT32X64 when the merged transform beats the
    chosen 32-level tiling (enc_ac_strategy.cc:897-921 entropy_mul64X32/
    64X64 = 2.25 vs 1.48 at the 32 level; the 128/256 strategies exist
    for decode but the reference merge heuristic does not emit them
    either, enc_ac_strategy.cc:925-930 commented out)."""
    yb8, xb8 = raw_quant.shape
    inv_gs = quantizer.inv_global_scale
    lam = 5.5 / (distance * distance)     # distortion weight (small path)

    # Per-merge-level RATE multipliers (enc_ac_strategy.cc:886-897
    # entropy_mul16X8/16X16/16X32/32X32/64X32 and :862-866 mul8x8):
    # hand-tuned in the reference against ringing next to sky; without
    # them the entropy estimate systematically over-merges into large
    # DCTs (seen as +80% BD-rate on multi-group photos, round 4).
    # Engaged for multi-group frames (r4 calibration: large textures
    # over-merge without them, large_wood +6 -> +19 measured) and for
    # SYNTHETIC-EDGE content at any size (graphics, screenshots):
    # median |dY/dx| is near 0 there (flat fills dominate, even after
    # gaborish sharpening) with a heavy hard-step tail, and the
    # unguarded estimator merges across those edges (+23% BD on
    # graphics). Small photographic tiles keep the r3-calibrated
    # unmultiplied estimator (which the multipliers over-fragment:
    # photo_face -6.7 -> +2.1 measured r4).
    if heterogeneous is None:
        if min(xyb_planes.shape[1:]) > 256:
            heterogeneous = True
        else:
            gx = np.abs(np.diff(np.asarray(xyb_planes[1], np.float32),
                                axis=1))
            heterogeneous = (float(np.median(gx)) < 5e-3 and
                             float((gx > 0.25).mean()) > 0.02)
    if heterogeneous:
        mul8x8 = 1.0 - 0.4 / (distance + 1.4)
        MUL16X8 = 1.21
        MUL16X16 = 1.34
        MUL16X32 = 1.49
        MUL32X32 = 1.48
        MUL64 = 2.25
        loss_w = 1.0
    else:
        mul8x8 = MUL16X8 = MUL16X16 = MUL16X32 = MUL32X32 = 1.0
        MUL64 = 2.25 / 1.48
        loss_w = 0.0
    xyb64 = np.asarray(xyb_planes, np.float64)
    y_plane = xyb64[1]
    # mask1x1 is only needed for host grid-cache misses; when the
    # device program supplied every strategy's grids (e5+ serving
    # path), computing it here costs ~0.5 s/MP for nothing
    _mask_cell: list = []

    def _mask():
        if not _mask_cell:
            _mask_cell.append(compute_mask1x1(y_plane))
        return _mask_cell[0]

    grid_cache = dict(grids) if grids else {}

    def region_cost(strategy, by, bx, mul=1.0):
        """mul * cost + loss at one aligned position (EstimateEntropy:
        the level multiplier scales the bits estimate only; the masked
        information-loss term is absolute, :508-509)."""
        g = grid_cache.get(strategy)
        if g is None:
            t = matrices.table_for_strategy(strategy)
            g = grid_cache[strategy] = strategy_rate_loss(
                xyb64, raw_quant,
                tuple(t[c].reshape(-1) for c in range(3)),
                quantizer.scale, strategy, _mask(), distance)
        rate, loss = g
        nby, nbx = COVERED_Y[strategy], COVERED_X[strategy]
        if rate.size == 0:
            return float("inf")
        return mul * float(rate[by // nby, bx // nbx]) + \
            loss_w * float(loss[by // nby, bx // nbx])

    acs = np.zeros((yb8, xb8), np.int32)
    anchors = np.zeros((yb8, xb8), bool)
    anchors[:] = True
    rq = raw_quant.copy()

    # At low distances merged blocks take the MAX of the field; at high
    # distances the MEAN works better (AdjustQuantField,
    # enc_adaptive_quantization.cc:1198-1246 mean_max_mixer)
    mixer = max(0.0, 1.0 - max(0.0, distance - 1.54138) * 0.56391)

    def place(strategy, by, bx):
        nby, nbx = COVERED_Y[strategy], COVERED_X[strategy]
        acs[by:by + nby, bx:bx + nbx] = strategy
        anchors[by:by + nby, bx:bx + nbx] = False
        anchors[by, bx] = True
        region = rq[by:by + nby, bx:bx + nbx]
        val = region.max()
        if nby * nbx >= 4:
            val = mixer * val + (1.0 - mixer) * region.mean()
        rq[by:by + nby, bx:bx + nbx] = max(1, int(round(val)))

    def quad_layouts(y0, x0):
        """Candidate tilings of a 16x16 region (enc_ac_strategy.cc
        hierarchical merge: 8s, vertical/horizontal halves, full 16)."""
        singles = [(mul8x8 * region_cost(ACS_DCT8, y0 + dy, x0 + dx),
                    [(ACS_DCT8, y0 + dy, x0 + dx)])
                   for dy in range(2) for dx in range(2)]
        j8 = (sum(c for c, _ in singles),
              [p for _, ps in singles for p in ps])
        jv = (region_cost(ACS_DCT16X8, y0, x0, MUL16X8) +
              region_cost(ACS_DCT16X8, y0, x0 + 1, MUL16X8),
              [(ACS_DCT16X8, y0, x0), (ACS_DCT16X8, y0, x0 + 1)])
        jh = (region_cost(ACS_DCT8X16, y0, x0, MUL16X8) +
              region_cost(ACS_DCT8X16, y0 + 1, x0, MUL16X8),
              [(ACS_DCT8X16, y0, x0), (ACS_DCT8X16, y0 + 1, x0)])
        j16 = (region_cost(ACS_DCT16, y0, x0, MUL16X16),
               [(ACS_DCT16, y0, x0)])
        return min((j8, jv, jh, j16), key=lambda t: t[0])

    cost32 = {}
    for sy in range(0, yb8 - 3, 4):
        for sx in range(0, xb8 - 3, 4):
            # group-boundary: a 32x32 region must not cross group edges
            if (sx % 32) + 4 > 32 or (sy % 32) + 4 > 32:
                continue
            quads = [quad_layouts(sy + dy, sx + dx)
                     for dy in (0, 2) for dx in (0, 2)]
            jq = (sum(c for c, _ in quads),
                  [p for _, ps in quads for p in ps])
            cands = [jq]
            if try_32:      # decoding_speed tier 4 disables 32x32-class
                cands += [
                    (region_cost(ACS_DCT32X16, sy, sx, MUL16X32) +
                     region_cost(ACS_DCT32X16, sy, sx + 2, MUL16X32),
                     [(ACS_DCT32X16, sy, sx), (ACS_DCT32X16, sy, sx + 2)]),
                    (region_cost(ACS_DCT16X32, sy, sx, MUL16X32) +
                     region_cost(ACS_DCT16X32, sy + 2, sx, MUL16X32),
                     [(ACS_DCT16X32, sy, sx), (ACS_DCT16X32, sy + 2, sx)]),
                    (region_cost(ACS_DCT32, sy, sx, MUL32X32),
                     [(ACS_DCT32, sy, sx)]),
                ]
            best, layout = min(cands, key=lambda t: t[0])
            cost32[(sy, sx)] = best
            for strategy, by, bx in layout:
                if strategy != ACS_DCT8:
                    place(strategy, by, bx)
    if try_64:
        # 64x64-level merges; candidate entropies carry the reference's
        # big-block penalty (entropy_mul64X32/64X64 = 2.25) to guard
        # against ringing next to smooth gradients. cost32 values
        # already include the level-specific multipliers, mirroring the
        # reference's accumulation of multiplied estimates
        # (enc_ac_strategy.cc:900-906 note).
        mul64 = MUL64
        for ty in range(0, (yb8 // 8) * 8, 8):
            for tx in range(0, (xb8 // 8) * 8, 8):
                quads = [(ty, tx), (ty, tx + 4), (ty + 4, tx),
                         (ty + 4, tx + 4)]
                if any(q not in cost32 for q in quads):
                    continue
                q00, q01, q10, q11 = (cost32[q] for q in quads)
                c64 = region_cost(ACS_DCT64, ty, tx, mul64)
                cl = region_cost(ACS_DCT64X32, ty, tx, mul64)
                cr = region_cost(ACS_DCT64X32, ty, tx + 4, mul64)
                ct = region_cost(ACS_DCT32X64, ty, tx, mul64)
                cb = region_cost(ACS_DCT32X64, ty + 4, tx, mul64)
                cost_vert = min(cl, q00 + q10) + min(cr, q01 + q11)
                cost_horz = min(ct, q00 + q01) + min(cb, q10 + q11)
                if c64 < cost_vert and c64 < cost_horz:
                    place(ACS_DCT64, ty, tx)
                elif cost_vert < cost_horz:
                    if cl < q00 + q10:
                        place(ACS_DCT64X32, ty, tx)
                    if cr < q01 + q11:
                        place(ACS_DCT64X32, ty, tx + 4)
                else:
                    if ct < q00 + q01:
                        place(ACS_DCT32X64, ty, tx)
                    if cb < q10 + q11:
                        place(ACS_DCT32X64, ty + 4, tx)
    if try_small:
        _choose_small(y_plane, acs, anchors, rq, matrices, quantizer,
                      lam, distance)
    return acs, anchors, rq


def _choose_small(y_plane, acs, anchors, rq, matrices, quantizer,
                  lam, distance: float = 1.0):
    """Per-8x8 candidate choice among DCT8 + the special transforms,
    vectorized over all unmerged blocks (pixel-domain distortion through
    the probed linear maps)."""
    from libjxl_torch.vardct.enc_transforms_small import (
        SMALL_STRATEGIES, forward_matrix, inverse_matrix,
    )
    sel = anchors & (acs == ACS_DCT8)
    by0, bx0 = np.nonzero(sel)
    if len(by0) == 0:
        return
    pix = _regions(y_plane, by0, bx0, 1, 1).reshape(len(by0), 64)
    qf = rq[by0, bx0].astype(np.float64)
    qac = quantizer.scale * qf
    inv_gs = quantizer.inv_global_scale
    th = _thresholds(1, 1, True)
    best_cost = np.full(len(by0), np.inf)
    best_s = np.zeros(len(by0), np.int32)
    for raw, mul in [(0, 1.0)] + list(SMALL_STRATEGIES.items()):
        # distance-dependent multiplier shaping (FindBest8x8Transform,
        # enc_ac_strategy.cc:585-603): IDENTITY/DCT2X2 get a strong
        # favor below d=5 (kFavor2X2AtHighQuality — sharp synthetic
        # edges code far better through them at high quality), the
        # frequency-split transforms a penalty above d=4
        if raw in (1, 2) and distance < 5.0:
            mul = mul - 0.4 * ((5.0 - distance) / 5.0) ** 2
        if raw not in (0, 1, 2) and distance > 4.0:
            avoid = 1.0
            if distance < 12.0:
                avoid *= (12.0 - 4.0) / (distance - 4.0)
            mul = mul + 0.5 * avoid
        F = forward_matrix(raw)
        M = inverse_matrix(raw)
        table = matrices.table_for_strategy(raw)[1].reshape(64)
        inv_table = 1.0 / table
        coef = pix @ F.T
        val = coef * (inv_table[None, :] * qac[:, None])
        q = np.where(np.abs(val) >= th[None, :], np.rint(val), 0.0)
        rate = _rate_estimate(q, 1)
        dq = adjust_quant_bias(q, 1) * table[None, :] *             (inv_gs / qf)[:, None]
        dq[:, 0] = coef[:, 0]              # DC carried by the DC image
        err = (dq - coef) @ M.T            # pixel-domain error
        dist = (err * err).sum(axis=1)
        # the level multiplier scales the BITS estimate only; the
        # distortion term is absolute (EstimateEntropy: entropy *=
        # entropy_mul, THEN += info_loss — scaling both handed the
        # low-mul AFV transforms a double advantage)
        cost = mul * rate + lam * dist
        better = cost < best_cost
        best_cost = np.where(better, cost, best_cost)
        best_s = np.where(better, raw, best_s)
    acs[by0, bx0] = best_s


def transform_all(xyb_p: np.ndarray, acs: np.ndarray, anchors: np.ndarray,
                  raw_quant: np.ndarray, matrices, quantizer,
                  x_qm_mul: float, coef_cache: dict | None = None):
    """Quantize every anchor region with its strategy.

    Returns dict keyed by (by, bx) anchor -> dict with q (3, size) int32,
    y_rt (size,) roundtripped Y, stored residual arrays for X/B pending
    CfL, plus the (3, yb, xb) DC float grid.

    ``coef_cache``: optional dict reused across butteraugli iterations —
    the forward transforms depend only on the pixels and the (pinned)
    ACS layout, so per-strategy coefficient batches and the DC grid are
    computed once and requantized per iteration."""
    yb8, xb8 = acs.shape
    inv_gs = quantizer.inv_global_scale
    if coef_cache is not None and "dc_float" in coef_cache:
        dc_float = coef_cache["dc_float"]
        dc_done = True
    else:
        dc_float = np.zeros((3, yb8, xb8), np.float64)
        dc_done = False
    blocks = {}
    for strategy in np.unique(acs[anchors]):
        sel = anchors & (acs == strategy)
        by0, bx0 = np.nonzero(sel)
        nby, nbx = COVERED_Y[strategy], COVERED_X[strategy]
        covered = nby * nbx
        table = matrices.table_for_strategy(strategy).reshape(3, -1)
        inv_table = 1.0 / table
        qf = raw_quant[by0, bx0].astype(np.float64)
        qac = quantizer.scale * qf
        th_y = _thresholds(nby, nbx, True)
        th_xb = _thresholds(nby, nbx, False)
        special = int(strategy) in (1, 2, 3, 12, 13, 14, 15, 16, 17)
        if special:
            from libjxl_torch.vardct.enc_transforms_small import \
                forward_matrix
            F = forward_matrix(int(strategy))
        cached = None if coef_cache is None else \
            coef_cache.get(int(strategy))
        if cached is not None:
            coefs = cached
        else:
            coefs = {}
            for c in range(3):
                reg = _regions(xyb_p[c], by0, bx0, nby, nbx)
                if special:
                    coefs[c] = reg.reshape(len(by0), 64) @ F.T
                    continue
                rc = _batched_dct(reg)
                stored = np.stack([coeffs_rc_to_stored(r) for r in rc])
                coefs[c] = stored.reshape(len(by0), -1)
            if coef_cache is not None:
                coef_cache[int(strategy)] = coefs
        # quantize Y + roundtrip
        qy = _quantize_y(coefs[1], inv_table[1], qac, th_y)
        y_rt = adjust_quant_bias(qy.reshape(-1, qy.shape[-1]), 1).reshape(
            qy.shape) * (table[1][None, :] * (inv_gs / qf)[:, None])
        for i, (by, bx) in enumerate(zip(by0, bx0)):
            blocks[(by, bx)] = dict(
                strategy=int(strategy), covered=covered,
                stored_x=coefs[0][i], stored_b=coefs[2][i],
                q_y=qy[i].astype(np.int32), y_rt=y_rt[i],
                inv_table=inv_table, table=table, qf=float(qf[i]),
                th_xb=th_xb, nby=nby, nbx=nbx)
        # DC from the LLF of the PRE-CfL coefficients: the decoder's DC
        # chroma-from-luma uses the global DC factors (0 for X, 1.0 for
        # B with the dequantized Y DC), which the DC quantization step
        # accounts for — not the per-tile AC factors.
        if dc_done:
            continue
        mn, mx = min(nby, nbx), max(nby, nbx)
        for c in range(3):
            if special:
                dc_float[c, by0, bx0] = coefs[c][:, 0]
                continue
            for i, (by, bx) in enumerate(zip(by0, bx0)):
                rcl = coefs[c][i].reshape(mn * 8, mx * 8)
                llf_st = rcl[:mn, :mx]
                llf = llf_st.T if nby >= nbx else llf_st
                dc_float[c, by:by + nby, bx:bx + nbx] = dc_from_llf(llf)
    if coef_cache is not None and not dc_done:
        coef_cache["dc_float"] = dc_float
    return blocks, dc_float


def finish_chroma(blocks, dc_float, fx_full, fb_full, x_qm_mul, quantizer):
    """Unapply CfL with the per-tile factors and quantize X/B; fills the
    X/B DC planes. fx/fb_full: per-block (yb, xb) factors."""
    for (by, bx), blk in blocks.items():
        nby, nbx = blk["nby"], blk["nbx"]
        fx = fx_full[by, bx]
        fb = fb_full[by, bx]
        x_res = blk["stored_x"] - fx * blk["y_rt"]
        b_res = blk["stored_b"] - fb * blk["y_rt"]
        qac = quantizer.scale * blk["qf"]
        vx = x_res * (blk["inv_table"][0] * (qac * x_qm_mul))
        vb = b_res * (blk["inv_table"][2] * qac)
        th = blk["th_xb"]
        qx = np.where(np.abs(vx) >= th, np.rint(vx), 0.0)
        qb = np.where(np.abs(vb) >= th, np.rint(vb), 0.0)
        blk["q"] = np.stack([qx, blk["q_y"], qb]).astype(np.int32)


def tokenize_varblock(toks, blk, orders, nz, bx, by, bctx, qf, y, x):
    """Generalized per-block tokenizer (mirror of DecodeACVarBlock)."""
    raw = blk["strategy"]
    covered = blk["covered"]
    size = covered * 64
    log2_cov = (covered).bit_length() - 1
    ord_ = STRATEGY_ORDER[raw]
    cxv, cyv = COVERED_X[raw], COVERED_Y[raw]
    for c in (1, 0, 2):
        qcoef = blk["q"][c]
        order = orders[ord_]
        vals = qcoef[order[covered:]]
        nzeros = int(np.count_nonzero(vals))
        nzc = nz[c]
        if bx == 0:
            predicted = nzc[by - 1, bx] if by > 0 else 32
        elif by == 0:
            predicted = nzc[by, bx - 1]
        else:
            predicted = (nzc[by - 1, bx] + nzc[by, bx - 1] + 1) // 2
        nzc[by:by + cyv, bx:bx + cxv] = (nzeros + covered - 1) >> log2_cov
        block_ctx = bctx.context(0, qf, ord_, c)
        toks.append((bctx.nonzero_context(int(predicted), block_ctx),
                     nzeros))
        if nzeros == 0:
            continue
        histo_offset = bctx.zero_density_offset(block_ctx)
        # vectorized zero-density coefficient loop: running (left, prev)
        # are pure prefix functions of the nonzero mask
        nzm = vals != 0
        cum = np.cumsum(nzm)
        last = int(np.argmax(cum == nzeros))     # final nonzero index
        vv = vals[:last + 1].astype(np.int64)
        nzm = nzm[:last + 1]
        left = nzeros - (cum[:last + 1] - nzm)
        prev = np.empty(last + 1, np.int64)
        prev[0] = 0 if nzeros > size // 16 else 1
        prev[1:] = nzm[:-1]
        k = covered + np.arange(last + 1)
        nzl = (left + covered - 1) >> log2_cov
        ctx = histo_offset + (_KNZ_ARR[nzl] +
                              _KFR_ARR[k >> log2_cov]) * 2 + prev
        val = np.where(vv >= 0, vv << 1, ((-vv) << 1) - 1)
        toks.append(np.stack([ctx, val], axis=1))


def adjust_field_for_acs(acs: np.ndarray, anchors: np.ndarray,
                         raw_quant: np.ndarray, distance: float
                         ) -> np.ndarray:
    """Re-apply the merged-region quant adjustment (the ``place`` math:
    AdjustQuantField mean/max mixer) to a fresh field while keeping a
    previously chosen ACS map — the butteraugli iteration loop holds
    ACS fixed and only moves the quant field, like the reference's
    FindBestQuantization."""
    rq = raw_quant.copy()
    mixer = max(0.0, 1.0 - max(0.0, distance - 1.54138) * 0.56391)
    by0, bx0 = np.nonzero(anchors)
    for by, bx in zip(by0.tolist(), bx0.tolist()):
        s = int(acs[by, bx])
        nby, nbx = COVERED_Y[s], COVERED_X[s]
        if nby * nbx == 1:
            continue
        region = rq[by:by + nby, bx:bx + nbx]
        val = region.max()
        if nby * nbx >= 4:
            val = mixer * val + (1.0 - mixer) * region.mean()
        rq[by:by + nby, bx:bx + nbx] = max(1, int(round(val)))
    return rq


def tokenize_varblocks_group(blocks, acs, anchors, orders, bctx, raw_quant,
                             by0: int, bx0: int, gh: int, gw: int
                             ) -> np.ndarray:
    """Vectorized whole-group tokenizer for variable-size blocks: the
    batched mirror of ``tokenize_varblock`` (enc_entropy_coder.cc:153
    DecodeACVarBlock order). Produces the identical (N, 2) token stream:
    per raster anchor, per channel (Y, X, B), one nonzero-count token
    followed by the zero-density coefficient tokens.

    Causality note: the nonzero-count prediction reads the top/left
    CELLS of each anchor, which raster anchor order guarantees belong
    to earlier blocks — so the nz grids can be painted up front and
    gathered without a sequential walk."""
    a_sel = anchors[by0:by0 + gh, bx0:bx0 + gw]
    acs_g = acs[by0:by0 + gh, bx0:bx0 + gw]
    ys, xs = np.nonzero(a_sel)
    n = len(ys)
    if n == 0:
        return np.zeros((0, 2), np.int64)
    strat = acs_g[ys, xs]
    qf = raw_quant[by0 + ys, bx0 + xs].astype(np.int64)
    order_of = np.asarray(STRATEGY_ORDER, np.int64)
    covered_of = (np.asarray(COVERED_X, np.int64) *
                  np.asarray(COVERED_Y, np.int64))
    covered = covered_of[strat]
    log2cov = np.zeros(n, np.int64)
    c_tmp = covered.copy()
    while (c_tmp > 1).any():
        log2cov += c_tmp > 1
        c_tmp >>= 1

    # block contexts per (anchor, channel): idx layout of
    # BlockCtxMap.context (ac_context.py:87-96)
    nqf = len(bctx.qf_thresholds)
    qf_idx = np.searchsorted(np.asarray(bctx.qf_thresholds, np.int64),
                             qf, side="left") if nqf else \
        np.zeros(n, np.int64)
    cidx = np.array([1, 0, 2], np.int64)     # channel order (Y, X, B)
    from libjxl_torch.vardct.ac_context import (
        K_COEFF_FREQ_CONTEXT, K_COEFF_NUM_NONZERO_CONTEXT, NUM_ORDERS,
    )
    idx = (cidx[None, :] * NUM_ORDERS + order_of[strat][:, None])
    idx = (idx * (nqf + 1) + qf_idx[:, None]) * bctx.num_dc_ctxs
    block_ctx = np.asarray(bctx.ctx_map, np.int64)[idx]    # (n, 3)

    knz = np.asarray(K_COEFF_NUM_NONZERO_CONTEXT, np.int64)
    kfr = np.asarray(K_COEFF_FREQ_CONTEXT, np.int64)

    # per-class batched coefficient tokens
    per_anchor_parts: list = [None] * n          # (3, list of tok arrays)
    nzeros_all = np.zeros((n, 3), np.int64)
    per_class: dict = {}
    for s in np.unique(strat):
        sel = np.nonzero(strat == s)[0]
        per_class[int(s)] = sel
    class_tok = {}
    for s, sel in per_class.items():
        cov = int(covered_of[s])
        size = cov * 64
        order = orders[STRATEGY_ORDER[s]]
        q = np.stack([blocks[(by0 + ys[i], bx0 + xs[i])]["q"]
                      for i in sel])              # (m, 3, size)
        vals = q[:, :, order[cov:]].astype(np.int64)   # (m, 3, size-cov)
        m = vals != 0
        nz = m.sum(-1, dtype=np.int64)                  # (m, 3)
        nzeros_all[sel] = nz
        cums = np.cumsum(m, axis=-1, dtype=np.int64)
        left = nz[..., None] - (cums - m)
        emit = left > 0
        prev = np.empty(vals.shape, np.int64)
        prev[..., 0] = (nz <= size // 16).astype(np.int64)
        prev[..., 1:] = m[..., :-1]
        l2 = max(cov.bit_length() - 1, 0)
        k = cov + np.arange(vals.shape[-1])
        nzl = (np.where(emit, left, 1) + cov - 1) >> l2
        from libjxl_torch.vardct.ac_context import (
            K_NONZERO_BUCKETS, K_ZERO_DENSITY_CONTEXT_COUNT,
        )
        hoff = (bctx.num_ctxs * K_NONZERO_BUCKETS +
                K_ZERO_DENSITY_CONTEXT_COUNT *
                block_ctx[sel])                          # (m, 3)
        ctx = hoff[:, :, None] + \
            (knz[nzl] + kfr[(k >> l2)][None, None, :]) * 2 + prev
        tok = np.where(vals >= 0, vals << 1, ((-vals) << 1) - 1)
        class_tok[s] = (sel, ctx, tok, emit)

    # nonzero-count contexts: paint per-channel nz grids, then gather
    # top/left predictions per anchor
    nzgrid = np.zeros((3, gh, gw), np.int64)
    paint = (nzeros_all + (covered - 1)[:, None]) >> log2cov[:, None]
    for s, sel in per_class.items():
        nby, nbx = COVERED_Y[s], COVERED_X[s]
        ay = np.arange(nby)
        ax = np.arange(nbx)
        yy = (ys[sel][:, None, None] + ay[None, :, None])
        xx = (xs[sel][:, None, None] + ax[None, None, :])
        for c in range(3):
            nzgrid[c, yy, xx] = paint[sel, c][:, None, None]
    # prediction must read only already-painted (earlier-anchor) cells;
    # top/left cells of an anchor are never covered by itself
    up = np.where(ys > 0, nzgrid[:, np.maximum(ys - 1, 0), xs], 32)
    lf = np.where(xs > 0, nzgrid[:, ys, np.maximum(xs - 1, 0)], 0)
    predicted = np.where(
        xs[None, :] == 0, up,
        np.where(ys[None, :] == 0, lf, (up + lf + 1) >> 1))  # (3, n)
    pb = np.minimum(predicted, 64)
    pb = np.where(pb < 8, pb, 4 + pb // 2)
    nz_ctx = pb.T * bctx.num_ctxs + block_ctx                # (n, 3)

    # assemble in raster-anchor/channel order via offsets
    corder = np.array([1, 0, 2])
    emit_counts = np.zeros((n, 3), np.int64)
    for s, (sel, ctx, tok, emit) in class_tok.items():
        emit_counts[sel] = emit.sum(-1)
    per_chan = 1 + emit_counts[:, corder]                    # (n, 3)
    flat_counts = per_chan.reshape(-1)
    offsets = np.concatenate([[0], np.cumsum(flat_counts)[:-1]]
                             ).reshape(n, 3)
    total = int(flat_counts.sum())
    out = np.empty((total, 2), np.int64)
    # nz tokens
    for ci, c in enumerate(corder):
        pos = offsets[:, ci]
        out[pos, 0] = nz_ctx[:, c]
        out[pos, 1] = nzeros_all[:, c]
    # coefficient tokens per class
    for s, (sel, ctx, tok, emit) in class_tok.items():
        for ci, c in enumerate(corder):
            em = emit[:, c]                                  # (m, size-cov)
            cnt = em.sum(-1)
            m_idx, k_idx = np.nonzero(em)
            # position = anchor offset + 1 + rank within the channel
            ranks = np.concatenate(
                [np.arange(v) for v in cnt]) if len(cnt) else \
                np.zeros(0, np.int64)
            pos = offsets[sel, ci][m_idx] + 1 + ranks
            out[pos, 0] = ctx[:, c][em]
            out[pos, 1] = tok[:, c][em]
    return out
