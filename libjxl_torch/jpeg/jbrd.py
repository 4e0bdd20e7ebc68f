"""jbrd box codec: JPEGData bundle + Brotli-compressed raw marker bytes
(reference ``lib/jxl/jpeg/jpeg_data.cc`` VisitFields,
``lib/jxl/jpeg/enc_jpeg_data.cc:286-360``)."""

from __future__ import annotations

import numpy as np

from libjxl_torch.core.fields import (
    Bits, BitsOffset, FieldReader, FieldWriter, FormatError, Val,
)
from libjxl_torch.jpeg.data import (
    Component, HuffmanCode, JPEGData, QuantTable, ScanComponent, ScanInfo,
)
from libjxl_torch.utils import brotli
from libjxl_torch.utils.bits import BitReader, BitWriter

APP_UNKNOWN, APP_ICC, APP_EXIF, APP_XMP = 0, 1, 2, 3


def _visit_jpeg_data(v, jd: JPEGData):
    """Single-source bundle layout (jpeg_data.cc:64-380)."""
    reading = v.is_reading
    is_gray = v.bool(len(jd.components) == 1)
    if reading:
        jd.components = [Component() for _ in range(1 if is_gray else 3)]
    # markers
    num_app = num_com = num_scans = num_inter = 0
    has_dri = False
    if reading:
        jd.marker_order = []
        while True:
            m = v.bits(6, 0) + 0xC0
            jd.marker_order.append(m)
            if m == 0xD9:
                break
            if len(jd.marker_order) > 16384:
                raise FormatError("too many markers")
    else:
        for m in jd.marker_order:
            v.bits(6, m - 0xC0)
    for m in jd.marker_order:
        if (m & 0xF0) == 0xE0:
            num_app += 1
        if m == 0xFE:
            num_com += 1
        if m == 0xDA:
            num_scans += 1
        if m == 0xFF:
            num_inter += 1
        if m == 0xDD:
            has_dri = True
    if reading:
        jd.app_data = [b""] * num_app
        jd.app_marker_type = [0] * num_app
        jd.com_data = [b""] * num_com
        jd.scan_info = [ScanInfo() for _ in range(num_scans)]
    elif not hasattr(jd, "app_marker_type") or \
            len(jd.app_marker_type) != num_app:
        jd.app_marker_type = [APP_UNKNOWN] * num_app
    app_lens = []
    for i in range(num_app):
        t = v.u32(Val(0), Val(1), BitsOffset(1, 2), BitsOffset(2, 4),
                  jd.app_marker_type[i] if not reading else 0)
        if reading:
            jd.app_marker_type[i] = t
        # our app_data includes the leading 0xFF; the stored length is
        # (marker byte + 2-byte length + payload) - 1 (jpeg_data.cc:128)
        ln = v.bits(16, (len(jd.app_data[i]) - 2) if not reading else 0)
        app_lens.append(ln + 1)
    com_lens = []
    for i in range(num_com):
        ln = v.bits(16, (len(jd.com_data[i]) - 2) if not reading else 0)
        com_lens.append(ln + 1)
    # quant tables
    nq = v.u32(Val(1), Val(2), Val(3), Val(4), len(jd.quant))
    if nq == 4:
        raise FormatError("invalid number of quant tables")
    if reading:
        jd.quant = [QuantTable(values=np.zeros(64, np.int32))
                    for _ in range(nq)]
    for i, qt in enumerate(jd.quant):
        qt.precision = v.bits(1, qt.precision)
        qt.index = v.bits(2, qt.index if not reading else i)
        qt.is_last = v.bool(qt.is_last)
    # component ids
    comp_ids = [c.id for c in jd.components]
    if len(comp_ids) == 1 and comp_ids[0] == 1:
        ctype = 0
    elif comp_ids == [1, 2, 3]:
        ctype = 1
    elif comp_ids == [ord("R"), ord("G"), ord("B")]:
        ctype = 2
    else:
        ctype = 3
    ctype = v.bits(2, ctype)
    if ctype == 0:
        ncomp = 1
    elif ctype != 3:
        ncomp = 3
    else:
        ncomp = v.u32(Val(1), Val(2), Val(3), Val(4), len(jd.components))
    if reading:
        jd.components = [Component() for _ in range(ncomp)]
    if ctype == 3:
        for c in jd.components:
            c.id = v.bits(8, c.id)
    elif ctype == 0:
        jd.components[0].id = 1
    elif ctype == 2:
        for c, i in zip(jd.components, b"RGB"):
            c.id = i
    else:
        for c, i in zip(jd.components, (1, 2, 3)):
            c.id = i
    for c in jd.components:
        c.quant_idx = v.bits(2, c.quant_idx)
    # huffman codes (with the virtual 256 sentinel)
    nh = v.u32(Val(4), BitsOffset(3, 2), BitsOffset(4, 10), BitsOffset(6, 26),
               len(jd.huffman_code))
    if reading:
        jd.huffman_code = [HuffmanCode() for _ in range(nh)]
    for hc in jd.huffman_code:
        if not reading:
            counts, values = _add_sentinel(hc)
        else:
            counts, values = [0] * 17, []
        is_ac = v.bool(bool(hc.slot_id & 0x10))
        hid = v.bits(2, hc.slot_id & 0xF)
        hc.slot_id = (0x10 if is_ac else 0) | hid
        hc.is_last = v.bool(hc.is_last)
        total = 0
        for i in range(17):
            counts[i] = v.u32(Val(0), Val(1), BitsOffset(3, 2), Bits(8),
                              counts[i])
            total += counts[i]
        if reading:
            values = [0] * total
        for i in range(total):
            values[i] = v.u32(Bits(2), BitsOffset(2, 4), BitsOffset(4, 8),
                              BitsOffset(8, 1), values[i] if i < len(values)
                              else 0)
        if total and values[total - 1] != 256:
            raise FormatError("missing huffman sentinel")
        if reading:
            _strip_sentinel(hc, counts, values)
    # scans
    for si in jd.scan_info:
        n = v.u32(Val(1), Val(2), Val(3), Val(4), len(si.components))
        if n >= 4:
            raise FormatError("invalid scan components")
        if reading:
            si.components = [ScanComponent() for _ in range(n)]
        si.Ss = v.bits(6, si.Ss)
        si.Se = v.bits(6, si.Se)
        si.Al = v.bits(4, si.Al)
        si.Ah = v.bits(4, si.Ah)
        for sc in si.components:
            sc.comp_idx = v.bits(2, sc.comp_idx)
            sc.ac_tbl_idx = v.bits(2, sc.ac_tbl_idx)
            sc.dc_tbl_idx = v.bits(2, sc.dc_tbl_idx)
        # last_needed_pass (unused single-pass): kMaxNumPasses-1 default
        v.u32(Val(0), Val(1), Val(2), BitsOffset(3, 3),
              getattr(si, "last_needed_pass", 0))
    if has_dri:
        jd.restart_interval = v.bits(16, jd.restart_interval)
    for si in jd.scan_info:
        nrp = v.u32(Val(0), BitsOffset(2, 1), BitsOffset(4, 4),
                    BitsOffset(16, 20), len(si.reset_points))
        if reading:
            si.reset_points = [0] * nrp
        last = -1
        for i in range(nrp):
            d = v.u32(Val(0), BitsOffset(3, 1), BitsOffset(5, 9),
                      BitsOffset(28, 41),
                      (si.reset_points[i] - last - 1) if not reading else 0)
            si.reset_points[i] = d + last + 1
            last = si.reset_points[i]
        nzr = v.u32(Val(0), BitsOffset(2, 1), BitsOffset(4, 4),
                    BitsOffset(16, 20), len(si.extra_zero_runs))
        if reading:
            si.extra_zero_runs = [(0, 0)] * nzr
        last = -1
        for i in range(nzr):
            bi, nr = si.extra_zero_runs[i] if not reading else (0, 1)
            nr = v.u32(Val(1), BitsOffset(2, 2), BitsOffset(4, 5),
                       BitsOffset(8, 20), nr)
            d = v.u32(Val(0), BitsOffset(3, 1), BitsOffset(5, 9),
                      BitsOffset(28, 41),
                      (bi - last - 1) if not reading else 0)
            bi = d + last + 1
            si.extra_zero_runs[i] = (bi, nr)
            last = bi
    inter_lens = []
    for i in range(num_inter):
        ln = v.bits(16, len(jd.inter_marker_data[i]) if not reading else 0)
        inter_lens.append(ln)
    tail_len = v.u32(Val(0), BitsOffset(8, 1), BitsOffset(16, 257),
                     BitsOffset(22, 65793), len(jd.tail_data))
    has_padding = v.bool(bool(jd.padding_flat))
    if has_padding:
        nbit = v.bits(24, len(jd.padding_flat))
        if reading:
            jd.padding_flat = [v.bool() for _ in range(nbit)]
        else:
            for b in jd.padding_flat:
                v.bool(bool(b))
    return app_lens, com_lens, inter_lens, tail_len


def _add_sentinel(hc: HuffmanCode):
    counts = list(hc.counts)
    values = list(hc.values)
    total = sum(counts[1:])
    if total == 0:
        return counts, values
    max_depth = max(i for i in range(1, 17) if counts[i])
    counts[max_depth] += 1
    values.append(256)
    return counts, values


def _strip_sentinel(hc: HuffmanCode, counts, values):
    total = sum(counts[1:])
    if total == 0:
        hc.counts = counts
        hc.values = []
        return
    max_depth = max(i for i in range(1, 17) if counts[i])
    counts[max_depth] -= 1
    hc.counts = counts
    hc.values = values[:-1]


def _padding_bits_flat(jd: JPEGData) -> list[int]:
    """Flatten reader-recorded (nbits, value) pads to individual bits,
    keeping only non-default (non-all-ones) padding significance."""
    flat = []
    nonstandard = False
    for nbits, val in jd.padding_bits:
        for i in range(nbits - 1, -1, -1):
            bit = (val >> i) & 1
            flat.append(bit)
            if bit == 0:
                nonstandard = True
    return flat if nonstandard else []


def serialize_jbrd(jd: JPEGData) -> bytes:
    """JPEGData -> jbrd box payload."""
    jd.app_marker_type = [APP_UNKNOWN] * len(jd.app_data)
    jd.padding_flat = _padding_bits_flat(jd)
    w = BitWriter()
    _visit_jpeg_data(FieldWriter(w), jd)
    w.zero_pad_to_byte()
    raw = bytearray()
    for i, app in enumerate(jd.app_data):
        if jd.app_marker_type[i] == APP_UNKNOWN:
            raw += app[1:]      # without the leading 0xFF
    for com in jd.com_data:
        raw += com[1:]
    for inter in jd.inter_marker_data:
        raw += inter
    raw += jd.tail_data
    return w.to_bytes() + brotli.compress(bytes(raw))


def parse_jbrd(payload: bytes) -> JPEGData:
    """jbrd box payload -> JPEGData (coefficients not included)."""
    jd = JPEGData()
    jd.padding_flat = []
    r = BitReader(payload)
    app_lens, com_lens, inter_lens, tail_len = _visit_jpeg_data(
        FieldReader(r), jd)
    r.jump_to_byte_boundary()
    comp = payload[r.bits_consumed // 8:]
    raw = brotli.decompress(comp)
    pos = 0
    for i, ln in enumerate(app_lens):
        marker = [m for m in jd.marker_order if (m & 0xF0) == 0xE0][i]
        if jd.app_marker_type[i] == APP_UNKNOWN:
            jd.app_data[i] = bytes([0xFF]) + raw[pos:pos + ln]
            pos += ln
        else:
            raise FormatError("non-raw app marker restore not supported yet")
    for i, ln in enumerate(com_lens):
        jd.com_data[i] = bytes([0xFF]) + raw[pos:pos + ln]
        pos += ln
    jd.inter_marker_data = []
    for ln in inter_lens:
        jd.inter_marker_data.append(raw[pos:pos + ln])
        pos += ln
    jd.tail_data = raw[pos:pos + tail_len]
    jd.progressive = 0xC2 in jd.marker_order
    return jd
