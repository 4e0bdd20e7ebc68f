"""Dequantization matrices: default library computation + bitstream decode
(reference ``lib/jxl/quant_weights.cc``)."""

from __future__ import annotations

import functools

import numpy as np

from libjxl_torch.core.fields import FormatError, read_f16
from libjxl_torch.utils.bits import BitReader
from libjxl_torch.vardct.quant_tables_data import (
    LIBRARY, REQUIRED_SIZE_X, REQUIRED_SIZE_Y,
)
from libjxl_torch.vardct.ac_strategy import QUANT_KIND

NUM_QUANT_TABLES = 17
K_ALMOST_ZERO = 1e-8

# DC quant defaults (quant_weights.cc kDCQuant)
DEFAULT_DC_QUANT = (1.0 / 4096, 1.0 / 512, 1.0 / 256)


def _mult(v: float) -> float:
    return 1.0 + v if v > 0 else 1.0 / (1.0 - v)


def _interpolate(pos, max_val, array):
    """Geometric interpolation along band array (quant_weights.cc:89-98)."""
    scaled_pos = pos * (len(array) - 1) / max_val
    idx = np.minimum(scaled_pos.astype(np.int32), len(array) - 2)
    frac = scaled_pos - idx
    a = np.asarray(array)[idx]
    b = np.asarray(array)[idx + 1]
    return a * (b / a) ** frac


def _get_quant_weights(rows: int, cols: int, distance_bands) -> np.ndarray:
    """(quant_weights.cc:129-160) -> (3, rows, cols) of *inverse* weights."""
    out = np.zeros((3, rows, cols), dtype=np.float64)
    for c in range(3):
        db = distance_bands[c]
        bands = [db[0]]
        if bands[0] < K_ALMOST_ZERO:
            raise FormatError("invalid distance bands")
        for i in range(1, len(db)):
            bands.append(bands[-1] * _mult(db[i]))
            if bands[-1] < K_ALMOST_ZERO:
                raise FormatError("invalid distance bands")
        num_bands = len(db)
        scale = (num_bands - 1) / (np.sqrt(2.0) + 1e-6)
        rcpcol = scale / (cols - 1)
        rcprow = scale / (rows - 1)
        yy = np.arange(rows)[:, None] * rcprow
        xx = np.arange(cols)[None, :] * rcpcol
        dist = np.sqrt(xx * xx + yy * yy)
        if num_bands == 1:
            out[c] = bands[0]
        else:
            out[c] = _interpolate(dist, 1e30, bands) if False else \
                _interp_bands(dist, bands)
    return out


def _interp_bands(scaled_distance, bands):
    """InterpolateVec semantics: idx = int(scaled_distance); geometric
    blend between bands[idx] and bands[idx+1]."""
    idx = scaled_distance.astype(np.int32)
    idx = np.minimum(idx, len(bands) - 2)
    frac = scaled_distance - idx
    a = np.asarray(bands)[idx]
    b = np.asarray(bands)[idx + 1]
    return a * (b / a) ** frac


def _weights_dct2(vals) -> np.ndarray:
    """(quant_weights.cc:48-77) -> (3, 8, 8) inverse weights."""
    out = np.zeros((3, 8, 8))
    for c in range(3):
        w = out[c]
        w[0, 0] = 1.0  # unused (DC)
        w[0, 1] = w[1, 0] = vals[c][0]
        w[1, 1] = vals[c][1]
        w[0:2, 2:4] = vals[c][2]
        w[2:4, 0:2] = vals[c][2]
        w[2:4, 2:4] = vals[c][3]
        w[0:4, 4:8] = vals[c][4]
        w[4:8, 0:4] = vals[c][4]
        w[4:8, 4:8] = vals[c][5]
    return out


def _weights_identity(vals) -> np.ndarray:
    out = np.zeros((3, 8, 8))
    for c in range(3):
        out[c, :, :] = vals[c][0]
        out[c, 0, 1] = vals[c][1]
        out[c, 1, 0] = vals[c][1]
        out[c, 1, 1] = vals[c][2]
    return out


_AFV_FREQS = [0, 0, 0.8517778890324296, 5.37778436506804, 0, 0,
              4.734747904497923, 5.449245381693219, 1.6598270267479331,
              4, 7.275749096817861, 10.423227632456525, 2.662932286148962,
              7.630657783650829, 8.962388608184032, 12.97166202570235]


def _weights_afv(afv_weights, dct4x8_bands, dct4x4_bands) -> np.ndarray:
    """(quant_weights.cc:246-323) -> (3, 8, 8) inverse weights."""
    w48 = _get_quant_weights(4, 8, dct4x8_bands)
    w44 = _get_quant_weights(4, 4, dct4x4_bands)
    lo = 0.8517778890324296
    hi = 12.97166202570235 - lo + 1e-6
    out = np.zeros((3, 8, 8))
    for c in range(3):
        a = afv_weights[c]
        bands = [a[5]]
        for i in range(1, 4):
            bands.append(bands[-1] * _mult(a[i + 5]))
        w = out[c]
        w[0, 0] = 1.0
        w[1, 0] = a[0]
        w[0, 1] = a[1]
        w[2, 0] = a[2]
        w[0, 2] = a[3]
        w[2, 2] = a[4]
        for y in range(4):
            for x in range(4):
                if x < 2 and y < 2:
                    continue
                val = _interp_bands(
                    np.array((_AFV_FREQS[y * 4 + x] - lo) * 3 / hi),
                    bands)
                w[2 * y, 2 * x] = val
        for y in range(4):
            for x in range(8):
                if x == 0 and y == 0:
                    continue
                w[2 * y + 1, x] = w48[c, y, x]
        for y in range(4):
            for x in range(4):
                if x == 0 and y == 0:
                    continue
                w[2 * y, 2 * x + 1] = w44[c, y, x]
    return out


@functools.lru_cache(maxsize=1)
def default_matrices():
    """Returns list of 17 (3, rows, cols) DEQUANT tables (1/weight) in the
    stored coefficient layout (rows=8*size_x, cols=8*size_y... see
    ComputeQuantTable: wrows=8*required_size_x, wcols=8*required_size_y)."""
    tables = []
    for idx, (mode, params) in enumerate(LIBRARY):
        tables.append(_compute_table(idx, mode, params))
    return tables


def _compute_table(idx: int, mode: str, params) -> np.ndarray:
    wrows = 8 * REQUIRED_SIZE_X[idx]
    wcols = 8 * REQUIRED_SIZE_Y[idx]
    if mode == "DCT":
        inv = _get_quant_weights(wrows, wcols, params[0])
    elif mode == "ID":
        inv = _weights_identity(params[0])
    elif mode == "DCT2":
        inv = _weights_dct2(params[0])
    elif mode == "DCT4":
        bands, kmul = params
        w44 = _get_quant_weights(4, 4, bands)
        inv = np.repeat(np.repeat(w44, 2, axis=1), 2, axis=2)
        for c in range(3):
            inv[c, 0, 1] /= kmul[c][0]
            inv[c, 1, 0] /= kmul[c][0]
            inv[c, 1, 1] /= kmul[c][1]
    elif mode == "DCT4X8":
        bands, mul = params
        w48 = _get_quant_weights(4, 8, bands)
        inv = np.repeat(w48, 2, axis=1)
        for c in range(3):
            inv[c, 1, 0] /= mul[c]
    elif mode == "AFV":
        dct4x8_bands = LIBRARY[9][1][0]
        dct4x4_bands = LIBRARY[3][1][0]
        inv = _weights_afv(params[0], dct4x8_bands, dct4x4_bands)
    else:
        raise FormatError(f"unknown quant mode {mode}")
    if np.any(inv < K_ALMOST_ZERO) and mode not in ("ID", "DCT2", "DCT4",
                                                    "DCT4X8", "AFV"):
        raise FormatError("invalid quant table")
    with np.errstate(divide="ignore"):
        table = 1.0 / inv
    # LLF entries are not used via this table (DC handled separately);
    # the reference zeroes inv there — keep table finite for safety.
    xs = REQUIRED_SIZE_X[idx]
    ys = REQUIRED_SIZE_Y[idx]
    if ys > xs:
        xs, ys = ys, xs
    # stored layout rows=wrows, cols=wcols; LLF grid is (ys, xs) at top-left
    return table.astype(np.float32)


class DequantMatrices:
    """Per-strategy dequant tables + DC quants (quant_weights.h)."""

    def __init__(self):
        self.dc_quant = list(DEFAULT_DC_QUANT)
        self.tables = default_matrices()
        self.encodings_default = True

    def decode_dc(self, r: BitReader) -> None:
        """(quant_weights.cc:513-528)."""
        all_default = r.read(1) == 1
        if not all_default:
            self.dc_quant = [read_f16(r) / 128.0 for _ in range(3)]
            for q in self.dc_quant:
                if q < K_ALMOST_ZERO:
                    raise FormatError("invalid dc_quant")

    def decode(self, r: BitReader, modular_frame_decoder=None) -> None:
        """AC-global matrices (quant_weights.cc:493-511)."""
        all_default = r.read(1) == 1
        self.encodings_default = all_default
        if all_default:
            return
        for i in range(NUM_QUANT_TABLES):
            self._decode_table(r, i, modular_frame_decoder)

    def _decode_table(self, r: BitReader, idx: int, mfd) -> None:
        mode = r.read(3)
        if mode == 0:  # library default
            r.read(0)  # predefined index: ceil_log2(1) = 0 bits
            return
        if mode == 7:  # RAW: F16 den + modular 8sx x 8sy x 3 image
            den = read_f16(r)
            if den < K_ALMOST_ZERO:
                raise FormatError("invalid qtable_den")
            sx = REQUIRED_SIZE_X[idx] * 8
            sy = REQUIRED_SIZE_Y[idx] * 8
            from libjxl_torch.modular.codec import ModularOptions, \
                modular_decode
            from libjxl_torch.modular.image import Channel, ModularImage
            from libjxl_torch.modular.frame import stream_id_quant_table
            img = ModularImage(sx, sy, 8)
            for _ in range(3):
                img.channel.append(Channel.create(sx, sy))
            modular_decode(r, img, group_id=(
                stream_id_quant_table(mfd.dims, idx) if mfd is not None
                else 0), options=ModularOptions(),
                global_tree=getattr(mfd, "tree", None),
                global_code=getattr(mfd, "code", None),
                undo_transforms=True)
            qtable = np.stack([c.plane for c in img.channel])  # (3, sy, sx)
            if np.any(qtable <= 0):
                raise FormatError("invalid RAW qtable")
            with np.errstate(divide="ignore"):
                table = (den * qtable.reshape(3, sy, sx)).astype(np.float32)
            # weights = 1/(den*qtable) => dequant table = den*qtable
            self.tables = list(self.tables)
            self.tables[idx] = table
            self.raw_qtables = getattr(self, "raw_qtables", {})
            self.raw_qtables[idx] = (den, qtable)
            return
        raise FormatError(
            f"non-default quant table encoding (mode {mode}) not yet "
            "supported")

    def table_for_strategy(self, raw_strategy: int) -> np.ndarray:
        return self.tables[QUANT_KIND[raw_strategy]]
