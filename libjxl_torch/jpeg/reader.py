"""JPEG bitstream parser: .jpg bytes -> JPEGData (markers, tables, DCT
coefficients). Baseline and progressive scans
(reference ``lib/jxl/jpeg/enc_jpeg_data_reader.cc``)."""

from __future__ import annotations

import struct

import numpy as np

from libjxl_torch.jpeg.data import (
    Component, HuffmanCode, JPEGData, JPEG_ZIGZAG_ORDER, QuantTable,
    ScanComponent, ScanInfo,
)


class JpegError(ValueError):
    pass


class _BitReaderMSB:
    """MSB-first entropy-data reader with 0xFF00 unstuffing and marker
    detection. Tracks the exact stream byte each buffered 8-bit chunk came
    from so byte positions are recoverable at aligned points."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos              # next stream byte to feed
        self.start = pos
        self.bitbuf = 0
        self.bitcnt = 0
        self.fed_bits = 0
        self.chunk_pos: list[int] = []   # stream pos AFTER each fed chunk

    def _fill(self) -> None:
        while self.bitcnt <= 24:
            b = 0
            if self.pos < len(self.data):
                b = self.data[self.pos]
                if b == 0xFF:
                    nxt = self.data[self.pos + 1] if self.pos + 1 < \
                        len(self.data) else 0xD9
                    if nxt == 0x00:
                        self.pos += 2
                    else:
                        b = 0  # at a marker: feed zero bits, don't advance
                else:
                    self.pos += 1
            self.bitbuf = (self.bitbuf << 8) | b
            self.bitcnt += 8
            self.fed_bits += 8
            self.chunk_pos.append(self.pos)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self._fill()
        v = (self.bitbuf >> (self.bitcnt - n)) & ((1 << n) - 1)
        self.bitcnt -= n
        self.bitbuf &= (1 << self.bitcnt) - 1
        return v

    def read_bit(self) -> int:
        return self.read(1)

    def align_to_byte(self):
        """Discard bits to the next chunk boundary; returns (nbits, value)
        of the discarded padding."""
        rem = self.bitcnt & 7
        pad = self.read(rem) if rem else 0
        return (rem, pad)

    def byte_pos(self) -> int:
        """Stream position at the current (byte-aligned) point."""
        consumed_chunks = (self.fed_bits - self.bitcnt) // 8
        if consumed_chunks == 0:
            return self.start
        return self.chunk_pos[consumed_chunks - 1]


class _HuffTable:
    def __init__(self, counts, values):
        self.lookup = {}
        code = 0
        k = 0
        self.maxcode = [-1] * 17
        self.mincode = [0] * 17
        self.valptr = [0] * 17
        self.values = values
        for ln in range(1, 17):
            self.valptr[ln] = k
            self.mincode[ln] = code
            code += counts[ln]
            k += counts[ln]
            self.maxcode[ln] = code - 1
            code <<= 1

    def decode(self, br: _BitReaderMSB) -> int:
        code = br.read_bit()
        ln = 1
        while code > self.maxcode[ln]:
            code = (code << 1) | br.read_bit()
            ln += 1
            if ln > 16:
                raise JpegError("bad huffman code")
        return self.values[self.valptr[ln] + code - self.mincode[ln]]


def _extend(v: int, n: int) -> int:
    return v - (1 << n) + 1 if v < (1 << (n - 1)) else v


def parse_jpeg(data: bytes) -> JPEGData:
    if data[:2] != b"\xff\xd8":
        raise JpegError("not a JPEG (missing SOI)")
    jd = JPEGData()
    pos = 2
    dc_tables: dict[int, _HuffTable] = {}
    ac_tables: dict[int, _HuffTable] = {}
    dc_pred = {}
    eobrun = 0
    sof_precision = 8
    max_h = max_v = 1
    mcux = mcuy = 0

    def comp_by_idx(i):
        return jd.components[i]

    while pos < len(data):
        if data[pos] != 0xFF:
            raise JpegError(f"expected marker at {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:  # EOI
            jd.marker_order.append(marker)
            jd.tail_data = data[pos:]
            break
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue  # standalone
        (seglen,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + seglen]
        segend = pos + seglen
        if 0xE0 <= marker <= 0xEF:          # APPn
            jd.marker_order.append(marker)
            jd.app_data.append(bytes([0xFF, marker]) +
                               data[pos:pos + seglen])
        elif marker == 0xFE:                # COM
            jd.marker_order.append(marker)
            jd.com_data.append(bytes([0xFF, marker]) +
                               data[pos:pos + seglen])
        elif marker == 0xDB:                # DQT
            jd.marker_order.append(marker)
            p = 0
            while p < len(seg):
                pq = seg[p] >> 4
                tq = seg[p] & 15
                p += 1
                vals = np.zeros(64, dtype=np.int32)
                for k in range(64):
                    if pq:
                        v = struct.unpack(">H", seg[p:p + 2])[0]
                        p += 2
                    else:
                        v = seg[p]
                        p += 1
                    vals[JPEG_ZIGZAG_ORDER[k] if False else k] = v
                # store in natural order: DQT transmits zigzag
                nat = np.zeros(64, dtype=np.int32)
                for k in range(64):
                    nat[k] = vals[JPEG_ZIGZAG_ORDER[k]]
                qt = QuantTable(values=nat, precision=pq, index=tq,
                                is_last=p >= len(seg))
                jd.quant.append(qt)
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0/1/2
            jd.marker_order.append(marker)
            jd.progressive = marker == 0xC2
            sof_precision = seg[0]
            jd.height = struct.unpack(">H", seg[1:3])[0]
            jd.width = struct.unpack(">H", seg[3:5])[0]
            ncomp = seg[5]
            p = 6
            for _ in range(ncomp):
                c = Component(id=seg[p],
                              h_samp_factor=seg[p + 1] >> 4,
                              v_samp_factor=seg[p + 1] & 15,
                              quant_idx=seg[p + 2])
                jd.components.append(c)
                p += 3
            max_h = max(c.h_samp_factor for c in jd.components)
            max_v = max(c.v_samp_factor for c in jd.components)
            mcux = (jd.width + 8 * max_h - 1) // (8 * max_h)
            mcuy = (jd.height + 8 * max_v - 1) // (8 * max_v)
            for c in jd.components:
                c.width_in_blocks = mcux * c.h_samp_factor
                c.height_in_blocks = mcuy * c.v_samp_factor
                c.coeffs = np.zeros(
                    (c.width_in_blocks * c.height_in_blocks, 64),
                    dtype=np.int16)
        elif marker == 0xC4:                # DHT
            jd.marker_order.append(marker)
            p = 0
            while p < len(seg):
                slot = seg[p]
                p += 1
                counts = [0] * 17
                total = 0
                for ln in range(1, 17):
                    counts[ln] = seg[p]
                    total += seg[p]
                    p += 1
                values = list(seg[p:p + total])
                p += total
                hc = HuffmanCode(counts=counts, values=values, slot_id=slot,
                                 is_last=p >= len(seg))
                jd.huffman_code.append(hc)
                table = _HuffTable(counts, values)
                if slot & 0x10:
                    ac_tables[slot & 0x0F] = table
                else:
                    dc_tables[slot & 0x0F] = table
        elif marker == 0xDD:                # DRI
            jd.marker_order.append(marker)
            jd.restart_interval = struct.unpack(">H", seg[0:2])[0]
        elif marker == 0xDA:                # SOS
            jd.marker_order.append(marker)
            ns = seg[0]
            si = ScanInfo()
            p = 1
            for _ in range(ns):
                cid = seg[p]
                idx = next(i for i, c in enumerate(jd.components)
                           if c.id == cid)
                si.components.append(ScanComponent(
                    comp_idx=idx, dc_tbl_idx=seg[p + 1] >> 4,
                    ac_tbl_idx=seg[p + 1] & 15))
                p += 2
            si.Ss = seg[p]
            si.Se = seg[p + 1]
            si.Ah = seg[p + 2] >> 4
            si.Al = seg[p + 2] & 15
            jd.scan_info.append(si)
            pos = segend
            pos = _decode_scan(jd, si, data, pos, dc_tables, ac_tables,
                               max_h, max_v, mcux, mcuy)
            continue
        else:
            raise JpegError(f"unsupported marker {marker:#x}")
        pos = segend
    else:
        raise JpegError("missing EOI")
    return jd


def _decode_scan(jd: JPEGData, si: ScanInfo, data: bytes, pos: int,
                 dc_tables, ac_tables, max_h, max_v, mcux, mcuy) -> int:
    br = _BitReaderMSB(data, pos)
    dc_pred = [0] * len(jd.components)
    eobrun = 0
    restarts_to_go = jd.restart_interval
    interleaved = len(si.components) > 1
    if interleaved:
        n_mcu = mcux * mcuy
    else:
        sc = si.components[0]
        comp = jd.components[sc.comp_idx]
        cw = (jd.width * comp.h_samp_factor + 8 * max_h - 1) // (8 * max_h)
        ch = (jd.height * comp.v_samp_factor + 8 * max_v - 1) // (8 * max_v)
        n_mcu = cw * ch

    def decode_block(comp, coeffs, sc):
        nonlocal eobrun
        if jd.progressive:
            _decode_block_progressive(br, si, coeffs, dc_tables, ac_tables,
                                      sc, dc_pred, lambda: None)
        else:
            _decode_block_sequential(br, si, coeffs, dc_tables, ac_tables,
                                     sc, dc_pred)

    mcu = 0
    while mcu < n_mcu:
        if jd.restart_interval and restarts_to_go == 0:
            # byte-align + restart marker
            nbits, pad = br.align_to_byte()
            jd.padding_bits.append((nbits, pad))
            for i in range(nbits - 1, -1, -1):
                jd.padding_flat.append((pad >> i) & 1)
            p = br.byte_pos()
            if not (data[p] == 0xFF and 0xD0 <= data[p + 1] <= 0xD7):
                raise JpegError("expected restart marker")
            br = _BitReaderMSB(data, p + 2)
            dc_pred = [0] * len(jd.components)
            eobrun = 0
            restarts_to_go = jd.restart_interval
        eobrun = _decode_mcu(jd, si, br, mcu, dc_tables, ac_tables, dc_pred,
                             eobrun, interleaved, mcux, max_h, max_v)
        mcu += 1
        if jd.restart_interval:
            restarts_to_go -= 1
    nbits, pad = br.align_to_byte()
    jd.padding_bits.append((nbits, pad))
    for i in range(nbits - 1, -1, -1):
        jd.padding_flat.append((pad >> i) & 1)
    return br.byte_pos()


def _decode_mcu(jd, si, br, mcu, dc_tables, ac_tables, dc_pred, eobrun,
                interleaved, mcux, max_h, max_v):
    if interleaved:
        my, mx = divmod(mcu, mcux)
        for sc in si.components:
            comp = jd.components[sc.comp_idx]
            for v in range(comp.v_samp_factor):
                for hh in range(comp.h_samp_factor):
                    by = my * comp.v_samp_factor + v
                    bx = mx * comp.h_samp_factor + hh
                    bidx = by * comp.width_in_blocks + bx
                    eobrun = _decode_one(jd, si, br, comp, sc,
                                         comp.coeffs[bidx], dc_pred, eobrun,
                                         dc_tables, ac_tables)
    else:
        sc = si.components[0]
        comp = jd.components[sc.comp_idx]
        cw = (jd.width * comp.h_samp_factor + 8 * max_h - 1) // (8 * max_h)
        by, bx = divmod(mcu, cw)
        bidx = by * comp.width_in_blocks + bx
        eobrun = _decode_one(jd, si, br, comp, sc, comp.coeffs[bidx],
                             dc_pred, eobrun, dc_tables, ac_tables)
    return eobrun


def _decode_one(jd, si, br, comp, sc, coeffs, dc_pred, eobrun,
                dc_tables, ac_tables):
    if not jd.progressive:
        # sequential: DC + full AC
        t = dc_tables[sc.dc_tbl_idx].decode(br)
        diff = _extend(br.read(t), t) if t else 0
        dc_pred[sc.comp_idx] += diff
        coeffs[0] = dc_pred[sc.comp_idx]
        k = 1
        actbl = ac_tables[sc.ac_tbl_idx]
        while k < 64:
            rs = actbl.decode(br)
            r, s = rs >> 4, rs & 15
            if s == 0:
                if r == 15:
                    k += 16
                    continue
                break
            k += r
            if k > 63:
                raise JpegError("AC overflow")
            coeffs[k] = _extend(br.read(s), s)
            k += 1
        return eobrun
    # progressive
    if si.Ss == 0:
        if si.Ah == 0:
            t = dc_tables[sc.dc_tbl_idx].decode(br)
            diff = _extend(br.read(t), t) if t else 0
            dc_pred[sc.comp_idx] += diff
            coeffs[0] = dc_pred[sc.comp_idx] << si.Al
        else:
            if br.read_bit():
                coeffs[0] |= 1 << si.Al
        return eobrun
    # AC scans
    actbl = ac_tables[sc.ac_tbl_idx]
    if si.Ah == 0:
        if eobrun > 0:
            return eobrun - 1
        k = si.Ss
        while k <= si.Se:
            rs = actbl.decode(br)
            r, s = rs >> 4, rs & 15
            if s == 0:
                if r < 15:
                    eobrun = (1 << r) - 1
                    if r:
                        eobrun += br.read(r)
                    break
                k += 16
                continue
            k += r
            if k > si.Se:
                raise JpegError("AC overflow (progressive)")
            coeffs[k] = _extend(br.read(s), s) << si.Al
            k += 1
        return eobrun
    # AC refinement (jdphuff decode_mcu_AC_refine structure)
    p1 = 1 << si.Al
    m1 = -p1
    k = si.Ss
    if eobrun == 0:
        while k <= si.Se:
            rs = actbl.decode(br)
            r, s = rs >> 4, rs & 15
            sval = 0
            if s == 0:
                if r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += br.read(r)
                    break
            else:
                sval = p1 if br.read_bit() else m1
            while k <= si.Se:
                if coeffs[k] != 0:
                    if br.read_bit():
                        if (coeffs[k] & p1) == 0:
                            coeffs[k] += p1 if coeffs[k] >= 0 else m1
                else:
                    if r == 0:
                        break
                    r -= 1
                k += 1
            if sval and k <= si.Se:
                coeffs[k] = sval
            k += 1
    if eobrun > 0:
        while k <= si.Se:
            if coeffs[k] != 0:
                if br.read_bit():
                    if (coeffs[k] & p1) == 0:
                        coeffs[k] += p1 if coeffs[k] >= 0 else m1
            k += 1
        eobrun -= 1
    return eobrun
