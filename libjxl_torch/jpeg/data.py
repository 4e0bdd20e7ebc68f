"""Parsed-JPEG data model (reference ``lib/jxl/jpeg/jpeg_data.h``).

Holds everything needed to reproduce a .jpg byte-exactly: marker order and
payloads, quant/huffman tables, scan scripts, per-component DCT
coefficients, and entropy-coder deviations (padding bits, restarts)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# zig-zag index tables (jpeg_data.h:40-63)
JPEG_NATURAL_ORDER = (
    0, 1, 8, 16, 9, 2, 3, 10,
    17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63)

JPEG_ZIGZAG_ORDER = (
    0, 1, 5, 6, 14, 15, 27, 28,
    2, 4, 7, 13, 16, 26, 29, 42,
    3, 8, 12, 17, 25, 30, 41, 43,
    9, 11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54,
    20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61,
    35, 36, 48, 49, 57, 58, 62, 63)


@dataclass
class QuantTable:
    values: np.ndarray = None          # 64 int32, natural (raster) order
    precision: int = 0
    index: int = 0
    is_last: bool = True


@dataclass
class HuffmanCode:
    counts: list = field(default_factory=lambda: [0] * 17)
    values: list = field(default_factory=list)
    slot_id: int = 0                   # 0-3 DC, 0x10-0x13 AC
    is_last: bool = True


@dataclass
class ScanComponent:
    comp_idx: int = 0
    dc_tbl_idx: int = 0
    ac_tbl_idx: int = 0


@dataclass
class ScanInfo:
    Ss: int = 0
    Se: int = 63
    Ah: int = 0
    Al: int = 0
    components: list = field(default_factory=list)
    reset_points: list = field(default_factory=list)
    extra_zero_runs: list = field(default_factory=list)  # (block_idx, n)


@dataclass
class Component:
    id: int = 0
    h_samp_factor: int = 1
    v_samp_factor: int = 1
    quant_idx: int = 0
    width_in_blocks: int = 0
    height_in_blocks: int = 0
    coeffs: np.ndarray = None          # (nblocks, 64) int16, zigzag order


@dataclass
class JPEGData:
    width: int = 0
    height: int = 0
    restart_interval: int = 0
    app_data: list = field(default_factory=list)       # bytes incl. marker
    com_data: list = field(default_factory=list)
    quant: list = field(default_factory=list)          # [QuantTable]
    huffman_code: list = field(default_factory=list)   # [HuffmanCode]
    components: list = field(default_factory=list)
    scan_info: list = field(default_factory=list)
    marker_order: list = field(default_factory=list)   # marker bytes
    inter_marker_data: list = field(default_factory=list)
    tail_data: bytes = b""
    padding_bits: list = field(default_factory=list)   # (nbits, value) pads
    padding_flat: list = field(default_factory=list)   # flat bit list
    has_zero_padding_bit: bool = False
    progressive: bool = False
