"""Byte-exact .jpg serialization from JPEGData
(reference ``lib/jxl/jpeg/dec_jpeg_data_writer.cc``)."""

from __future__ import annotations

import struct

import numpy as np

from libjxl_torch.jpeg.data import JPEGData, JPEG_ZIGZAG_ORDER
from libjxl_torch.jpeg.reader import JpegError


class _BitWriterMSB:
    def __init__(self, out: bytearray):
        self.out = out
        self.acc = 0
        self.cnt = 0

    def write(self, n: int, v: int) -> None:
        if n == 0:
            return
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.cnt += n
        while self.cnt >= 8:
            b = (self.acc >> (self.cnt - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)
            self.cnt -= 8
            self.acc &= (1 << self.cnt) - 1

    def flush(self, pad_cursor) -> None:
        """Pad to byte, consuming bits from `pad_cursor` (an iterator over
        recorded padding bits) or all-ones when exhausted."""
        rem = (-self.cnt) % 8
        for _ in range(rem):
            try:
                b = next(pad_cursor)
            except StopIteration:
                b = 1
            self.write(1, b)


def _build_codes(counts, values):
    codes = {}
    code = 0
    k = 0
    for ln in range(1, 17):
        for _ in range(counts[ln]):
            codes[values[k]] = (ln, code)
            code += 1
            k += 1
        code <<= 1
    return codes


def _csize(v: int) -> int:
    return abs(v).bit_length()


def write_jpeg(jd: JPEGData) -> bytes:
    out = bytearray(b"\xff\xd8")
    dc_codes = {}
    ac_codes = {}
    app_i = com_i = dqt_i = dht_i = sof_emitted = 0
    scan_i = 0
    pad_cursor = iter(jd.padding_flat)
    dht_groups = _group_segments(jd.huffman_code)
    dqt_groups = _group_segments(jd.quant)

    for marker in jd.marker_order:
        if 0xE0 <= marker <= 0xEF:
            out += jd.app_data[app_i]
            app_i += 1
        elif marker == 0xFE:
            out += jd.com_data[com_i]
            com_i += 1
        elif marker == 0xDB:
            seg = bytearray()
            for qt in dqt_groups[dqt_i]:
                seg.append((qt.precision << 4) | qt.index)
                for k in range(64):
                    v = int(qt.values[JPEG_ZIGZAG_ORDER[k]]) if False else \
                        int(qt.values[_zig_to_nat(k)])
                    if qt.precision:
                        seg += struct.pack(">H", v)
                    else:
                        seg.append(v)
            out += b"\xff\xdb" + struct.pack(">H", len(seg) + 2) + seg
            dqt_i += 1
        elif marker in (0xC0, 0xC1, 0xC2):
            seg = bytearray()
            seg.append(8)
            seg += struct.pack(">H", jd.height)
            seg += struct.pack(">H", jd.width)
            seg.append(len(jd.components))
            for c in jd.components:
                seg.append(c.id)
                seg.append((c.h_samp_factor << 4) | c.v_samp_factor)
                seg.append(c.quant_idx)
            out += bytes([0xFF, marker]) + struct.pack(">H",
                                                      len(seg) + 2) + seg
        elif marker == 0xC4:
            seg = bytearray()
            for hc in dht_groups[dht_i]:
                seg.append(hc.slot_id)
                total = sum(hc.counts[1:])
                seg += bytes(hc.counts[1:17])
                seg += bytes(hc.values[:total])
                codes = _build_codes(hc.counts, hc.values)
                if hc.slot_id & 0x10:
                    ac_codes[hc.slot_id & 0x0F] = codes
                else:
                    dc_codes[hc.slot_id & 0x0F] = codes
            out += b"\xff\xc4" + struct.pack(">H", len(seg) + 2) + seg
            dht_i += 1
        elif marker == 0xDD:
            out += b"\xff\xdd" + struct.pack(">H", 4) + \
                struct.pack(">H", jd.restart_interval)
        elif marker == 0xDA:
            si = jd.scan_info[scan_i]
            scan_i += 1
            seg = bytearray()
            seg.append(len(si.components))
            for sc in si.components:
                seg.append(jd.components[sc.comp_idx].id)
                seg.append((sc.dc_tbl_idx << 4) | sc.ac_tbl_idx)
            seg.append(si.Ss)
            seg.append(si.Se)
            seg.append((si.Ah << 4) | si.Al)
            out += b"\xff\xda" + struct.pack(">H", len(seg) + 2) + seg
            _encode_scan(jd, si, out, dc_codes, ac_codes, pad_cursor)
        elif marker == 0xD9:
            out += b"\xff\xd9"
            out += jd.tail_data
        else:
            raise JpegError(f"unsupported marker in order: {marker:#x}")
    return bytes(out)


def _zig_to_nat(k: int) -> int:
    from libjxl_torch.jpeg.data import JPEG_NATURAL_ORDER
    return JPEG_NATURAL_ORDER[k]


def _group_segments(items):
    """Split table lists into original segments via is_last flags."""
    groups = []
    cur = []
    for it in items:
        cur.append(it)
        if it.is_last:
            groups.append(cur)
            cur = []
    if cur:
        groups.append(cur)
    return groups


def _encode_scan(jd: JPEGData, si, out: bytearray, dc_codes, ac_codes,
                 pad_cursor) -> None:
    bw = _BitWriterMSB(out)
    max_h = max(c.h_samp_factor for c in jd.components)
    max_v = max(c.v_samp_factor for c in jd.components)
    mcux = (jd.width + 8 * max_h - 1) // (8 * max_h)
    mcuy = (jd.height + 8 * max_v - 1) // (8 * max_v)
    interleaved = len(si.components) > 1
    if interleaved:
        n_mcu = mcux * mcuy
    else:
        sc = si.components[0]
        comp = jd.components[sc.comp_idx]
        cw = (jd.width * comp.h_samp_factor + 8 * max_h - 1) // (8 * max_h)
        ch = (jd.height * comp.v_samp_factor + 8 * max_v - 1) // (8 * max_v)
        n_mcu = cw * ch
    dc_pred = [0] * len(jd.components)
    st = _EncState(bw)
    restarts_to_go = jd.restart_interval
    next_restart = 0
    mcu = 0
    while mcu < n_mcu:
        if jd.restart_interval and restarts_to_go == 0:
            st.flush_eobrun(jd, si, ac_codes)
            bw.flush(pad_cursor)
            out += bytes([0xFF, 0xD0 + next_restart])
            next_restart = (next_restart + 1) & 7
            dc_pred = [0] * len(jd.components)
            restarts_to_go = jd.restart_interval
        _encode_mcu(jd, si, st, mcu, dc_codes, ac_codes, dc_pred,
                    interleaved, mcux, max_h, max_v)
        mcu += 1
        if jd.restart_interval:
            restarts_to_go -= 1
    st.flush_eobrun(jd, si, ac_codes)
    bw.flush(pad_cursor)


class _EncState:
    def __init__(self, bw):
        self.bw = bw
        self.eobrun = 0
        self.refine_bits: list[int] = []

    def flush_eobrun(self, jd, si, ac_codes) -> None:
        if self.eobrun > 0:
            actbl = ac_codes[si.components[0].ac_tbl_idx]
            _emit_eobrun(self.bw, actbl, self.eobrun, self.refine_bits)
            self.eobrun = 0
            self.refine_bits = []


def _emit_eobrun(bw, actbl, eobrun, refine_bits) -> None:
    r = eobrun.bit_length() - 1
    ln, code = actbl[r << 4]
    bw.write(ln, code)
    if r:
        bw.write(r, eobrun - (1 << r))
    for b in refine_bits:
        bw.write(1, b)


def _encode_mcu(jd, si, st, mcu, dc_codes, ac_codes, dc_pred, interleaved,
                mcux, max_h, max_v) -> None:
    if interleaved:
        my, mx = divmod(mcu, mcux)
        for sc in si.components:
            comp = jd.components[sc.comp_idx]
            for v in range(comp.v_samp_factor):
                for hh in range(comp.h_samp_factor):
                    by = my * comp.v_samp_factor + v
                    bx = mx * comp.h_samp_factor + hh
                    bidx = by * comp.width_in_blocks + bx
                    _encode_block(jd, si, st, comp, sc, comp.coeffs[bidx],
                                  dc_pred, dc_codes, ac_codes)
    else:
        sc = si.components[0]
        comp = jd.components[sc.comp_idx]
        cw = (jd.width * comp.h_samp_factor + 8 * max_h - 1) // (8 * max_h)
        by, bx = divmod(mcu, cw)
        bidx = by * comp.width_in_blocks + bx
        _encode_block(jd, si, st, comp, sc, comp.coeffs[bidx], dc_pred,
                      dc_codes, ac_codes)


def _encode_block(jd, si, st, comp, sc, coeffs, dc_pred, dc_codes,
                  ac_codes) -> None:
    bw = st.bw
    if not jd.progressive:
        dctbl = dc_codes[sc.dc_tbl_idx]
        actbl = ac_codes[sc.ac_tbl_idx]
        diff = int(coeffs[0]) - dc_pred[sc.comp_idx]
        dc_pred[sc.comp_idx] = int(coeffs[0])
        n = _csize(diff)
        ln, code = dctbl[n]
        bw.write(ln, code)
        if n:
            bw.write(n, diff if diff >= 0 else diff + (1 << n) - 1)
        r = 0
        for k in range(1, 64):
            v = int(coeffs[k])
            if v == 0:
                r += 1
                continue
            while r > 15:
                ln, code = actbl[0xF0]
                bw.write(ln, code)
                r -= 16
            n = _csize(v)
            ln, code = actbl[(r << 4) | n]
            bw.write(ln, code)
            bw.write(n, v if v >= 0 else v + (1 << n) - 1)
            r = 0
        if r:
            ln, code = actbl[0x00]
            bw.write(ln, code)
        return
    # progressive
    if si.Ss == 0:
        if si.Ah == 0:
            dctbl = dc_codes[sc.dc_tbl_idx]
            v = int(coeffs[0]) >> si.Al
            diff = v - dc_pred[sc.comp_idx]
            dc_pred[sc.comp_idx] = v
            n = _csize(diff)
            ln, code = dctbl[n]
            bw.write(ln, code)
            if n:
                bw.write(n, diff if diff >= 0 else diff + (1 << n) - 1)
        else:
            bw.write(1, (int(coeffs[0]) >> si.Al) & 1)
        return
    actbl = ac_codes[sc.ac_tbl_idx]
    if si.Ah == 0:
        # AC first scan
        vals = [int(coeffs[k]) >> si.Al if int(coeffs[k]) >= 0 else
                -((-int(coeffs[k])) >> si.Al) for k in range(64)]
        last_nz = 0
        for k in range(si.Ss, si.Se + 1):
            if vals[k]:
                last_nz = k
        if all(vals[k] == 0 for k in range(si.Ss, si.Se + 1)):
            st.eobrun += 1
            if st.eobrun == 0x7FFF:
                st.flush_eobrun(jd, si, ac_codes)
            return
        st.flush_eobrun(jd, si, ac_codes)
        r = 0
        for k in range(si.Ss, si.Se + 1):
            v = vals[k]
            if v == 0:
                r += 1
                continue
            while r > 15:
                ln, code = actbl[0xF0]
                bw.write(ln, code)
                r -= 16
            n = _csize(v)
            ln, code = actbl[(r << 4) | n]
            bw.write(ln, code)
            bw.write(n, v if v >= 0 else v + (1 << n) - 1)
            r = 0
            if k == last_nz:
                if k < si.Se:
                    st.eobrun += 1
                    if st.eobrun == 0x7FFF:
                        st.flush_eobrun(jd, si, ac_codes)
                return
        return
    # AC refinement
    p1 = 1 << si.Al
    vals = [int(coeffs[k]) for k in range(64)]
    absvals = [abs(v) >> si.Al for v in vals]
    last_nz = si.Ss - 1
    for k in range(si.Ss, si.Se + 1):
        if absvals[k] == 1:
            last_nz = k
    if last_nz < si.Ss:
        st.eobrun += 1
        st.refine_bits.extend(
            (abs(vals[k]) >> si.Al) & 1
            for k in range(si.Ss, si.Se + 1) if absvals[k] > 1)
        if st.eobrun == 0x7FFF:
            st.flush_eobrun(jd, si, ac_codes)
        return
    # jcphuff encode_mcu_AC_refine structure
    r = 0
    pending = []
    for k in range(si.Ss, si.Se + 1):
        a = absvals[k]
        if a == 0:
            r += 1
            continue
        while r > 15 and k <= last_nz:
            st.flush_eobrun(jd, si, ac_codes)
            ln, code = actbl[0xF0]
            bw.write(ln, code)
            r -= 16
            for b in pending:
                bw.write(1, b)
            pending = []
        if a > 1:
            pending.append(a & 1)
            continue
        st.flush_eobrun(jd, si, ac_codes)
        ln, code = actbl[(r << 4) | 1]
        bw.write(ln, code)
        bw.write(1, 1 if vals[k] >= 0 else 0)
        for b in pending:
            bw.write(1, b)
        pending = []
        r = 0
    if r > 0 or pending:
        st.eobrun += 1
        st.refine_bits.extend(pending)
        if st.eobrun == 0x7FFF:
            st.flush_eobrun(jd, si, ac_codes)
