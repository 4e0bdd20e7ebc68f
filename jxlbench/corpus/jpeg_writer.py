"""Baseline JPEGs as libjpeg-turbo's ``cjpeg`` makes them at its
defaults, in numpy, for machines without an image library.

``baseline_jpeg(img, quality)`` takes an (h, w, 3) uint8 RGB image and
returns the JFIF file that libjpeg-turbo writes for it with chroma 4:2:0,
the IJG quality scaling of the standard tables, the integer ("islow")
forward DCT and the standard Huffman tables (no optimisation, no restart
markers): PIL's ``Image.save(f, "JPEG", quality=q, subsampling=2)``, byte
for byte (``jxlbench/tests/test_jxlbench_jpeg420.py`` holds it to PIL).
Each step is libjpeg-turbo's integer arithmetic:

* ``jccolor.c`` ``rgb_ycc_convert``: 16-bit fixed-point YCbCr;
* ``jcprepct.c``, ``jcsample.c``: the last column and row repeated to the
  block grid, ``h2v2_downsample`` (the 2x2 sum with the bias 1, 2, 1, 2
  along a row, shifted right by 2), the chroma's last row repeated to its
  iMCU height;
* ``jfdctint.c`` ``jpeg_fdct_islow`` on samples less 128, and
  ``jcdctmgr.c`` ``quantize`` by the reciprocal of each table entry times
  8 (``compute_reciprocal``);
* ``jccoefct.c``: the dummy blocks of the last MCU column and row (AC 0,
  DC of the block before);
* ``jchuff.c`` ``encode_one_block``, ones as the last byte's padding,
  0xFF stuffed with 0x00; ``jcmarker.c``'s markers in its order.
"""

from __future__ import annotations

import numpy as np

# jcparam.c: the standard quantization tables (ITU T.81 K.1, K.2), in
# natural (raster) order
STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
STD_CHROMA = np.full(64, 99, np.int64)
STD_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# the raster index of each zigzag position (jutils.c jpeg_natural_order)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# jstdhuff.c: the standard Huffman tables (K.3-K.6): 16 counts, symbols
HUFF = {
    "dc0": ("00010501010101010100000000000000", "000102030405060708090a0b"),
    "ac0": ("0002010303020403050504040000017d",
            "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
            "2433627282090a161718191a25262728292a3435363738393a434445464748"
            "494a535455565758595a636465666768696a737475767778797a8384858687"
            "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2"
            "c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4"
            "f5f6f7f8f9fa"),
    "dc1": ("00030101010101010101010000000000", "000102030405060708090a0b"),
    "ac1": ("00020102040403040705040400010277",
            "000102031104052131061241510761711322328108144291a1b1c109233352"
            "f0156272d10a162434e125f11718191a262728292a35363738393a43444546"
            "4748494a535455565758595a636465666768696a737475767778797a828384"
            "85868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8"
            "b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3"
            "f4f5f6f7f8f9fa"),
}


def quant_table(std: np.ndarray, quality: int) -> np.ndarray:
    """jcparam.c ``jpeg_set_quality`` with baseline tables."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((std * scale + 50) // 100, 1, 255)


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def rgb_to_ycc(img: np.ndarray) -> np.ndarray:
    """jccolor.c: (3, h, w) int64 Y, Cb, Cr of an (h, w, 3) uint8 image."""
    r, g, b = (img[..., c].astype(np.int64) for c in range(3))
    half, off = 1 << 15, 128 << 16
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + off +
          half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + off +
          half - 1) >> 16
    return np.stack([y, cb, cr])


def _edge(p: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """``p`` with its last row and column repeated to rows x cols."""
    return np.pad(p, ((0, rows - p.shape[0]), (0, cols - p.shape[1])),
                  mode="edge")


def _downsample_h2v2(p: np.ndarray, cols: int) -> np.ndarray:
    """jcsample.c ``h2v2_downsample`` of a full-size plane to ``cols``
    output columns (and ceil(rows / 2) rows)."""
    p = _edge(p, p.shape[0] + p.shape[0] % 2, 2 * cols)
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = np.tile([1, 2], cols)[:cols]
    return (s + bias) >> 2


def _blocks(p: np.ndarray, by: int, bx: int) -> np.ndarray:
    """(by, bx, 8, 8) blocks of the top-left by*8 x bx*8 of ``p``."""
    p = p[:by * 8, :bx * 8]
    return p.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)


_CONST_BITS, _PASS1_BITS = 13, 2
_F = {k: int(v * (1 << _CONST_BITS) + 0.5) for k, v in dict(
    f0298=0.298631336, f0390=0.390180644, f0541=0.541196100,
    f0765=0.765366865, f0899=0.899976223, f1175=1.175875602,
    f1501=1.501321110, f1847=1.847759065, f1961=1.961570560,
    f2053=2.053119869, f2562=2.562915447, f3072=3.072711026).items()}


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d: list, first: bool) -> list:
    """One pass of jfdctint.c over the 8 lists of ``d`` (rows in the
    first pass, columns in the second)."""
    f = _F
    t0, t7 = d[0] + d[7], d[0] - d[7]
    t1, t6 = d[1] + d[6], d[1] - d[6]
    t2, t5 = d[2] + d[5], d[2] - d[5]
    t3, t4 = d[3] + d[4], d[3] - d[4]
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2
    out = [None] * 8
    n = _CONST_BITS - _PASS1_BITS if first else _CONST_BITS + _PASS1_BITS
    if first:
        out[0] = (t10 + t11) << _PASS1_BITS
        out[4] = (t10 - t11) << _PASS1_BITS
    else:
        out[0] = _descale(t10 + t11, _PASS1_BITS)
        out[4] = _descale(t10 - t11, _PASS1_BITS)
    z1 = (t12 + t13) * f["f0541"]
    out[2] = _descale(z1 + t13 * f["f0765"], n)
    out[6] = _descale(z1 - t12 * f["f1847"], n)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * f["f1175"]
    t4, t5 = t4 * f["f0298"], t5 * f["f2053"]
    t6, t7 = t6 * f["f3072"], t7 * f["f1501"]
    z1, z2 = z1 * -f["f0899"], z2 * -f["f2562"]
    z3, z4 = z3 * -f["f1961"] + z5, z4 * -f["f0390"] + z5
    out[7] = _descale(t4 + z1 + z3, n)
    out[5] = _descale(t5 + z2 + z4, n)
    out[3] = _descale(t6 + z2 + z3, n)
    out[1] = _descale(t7 + z1 + z4, n)
    return out


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """jfdctint.c ``jpeg_fdct_islow`` of (..., 8, 8) int64 centred
    samples: the DCT scaled by 8, in natural order."""
    rows = _fdct_1d([blocks[..., :, i] for i in range(8)], True)
    rows = np.stack(rows, -1)
    cols = _fdct_1d([rows[..., i, :] for i in range(8)], False)
    return np.stack(cols, -2)


def _reciprocal(divisor: int) -> tuple:
    """jcdctmgr.c ``compute_reciprocal`` (16-bit DCTELEM): (reciprocal,
    correction, total shift)."""
    if divisor == 1:
        return 1, 0, 0
    b = divisor.bit_length() - 1
    r = 16 + b
    fq, fr = divmod(1 << r, divisor)
    c = divisor // 2
    if fr == 0:
        fq >>= 1
        r -= 1
    elif fr <= divisor // 2:
        c += 1
    else:
        fq += 1
    return fq, c, r


def quantize(coef: np.ndarray, table: np.ndarray) -> np.ndarray:
    """jcdctmgr.c ``quantize`` of (..., 8, 8) islow output by ``table``
    (natural order)."""
    rcs = [_reciprocal(int(q) << 3) for q in table]
    recip = np.array([x[0] for x in rcs], np.int64).reshape(8, 8)
    corr = np.array([x[1] for x in rcs], np.int64).reshape(8, 8)
    shift = np.array([x[2] for x in rcs], np.int64).reshape(8, 8)
    mag = ((np.abs(coef) + corr) * recip) >> shift
    return np.where(coef < 0, -mag, mag)


def _codes(counts: bytes, symbols: bytes) -> tuple:
    """jchuff.c ``jpeg_make_c_derived_tbl``: (code, length) by symbol."""
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    c, k = 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            code[symbols[k]] = c
            size[symbols[k]] = length
            c += 1
            k += 1
        c <<= 1
    return code, size


def _nbits(v: np.ndarray) -> np.ndarray:
    """The bit length of |v| (jchuff.c's category)."""
    a = np.abs(v)
    n = np.zeros(a.shape, np.int64)
    while (a > 0).any():
        n += a > 0
        a = a >> 1
    return n


def _extra(v: np.ndarray, n: np.ndarray) -> np.ndarray:
    """The n low bits that follow a category: v, or v - 1 below 0."""
    return np.where(v < 0, v - 1, v) & ((1 << n) - 1)


def _events(zz: np.ndarray, comp: np.ndarray) -> tuple:
    """(value, bits) of every Huffman code with its extra bits, in
    stream order, for blocks ``zz`` (n, 64) in zigzag order in MCU order,
    ``comp`` the component of each (0 luma, 1 and 2 chroma)."""
    nb = zz.shape[0]
    tables = {k: _codes(bytes.fromhex(c), bytes.fromhex(s))
              for k, (c, s) in HUFF.items()}
    chroma = comp > 0
    # DC: the difference from the component's last block
    dc = zz[:, 0]
    diff = np.empty(nb, np.int64)
    for c in range(3):
        idx = np.flatnonzero(comp == c)
        diff[idx] = np.diff(dc[idx], prepend=0)
    n = _nbits(diff)
    dcode = np.where(chroma, tables["dc1"][0][n], tables["dc0"][0][n])
    dsize = np.where(chroma, tables["dc1"][1][n], tables["dc0"][1][n])
    dc_val, dc_len = (dcode << n) | _extra(diff, n), dsize + n
    # AC: each nonzero after its run of zeros (ZRL 0xF0 for each 16)
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[b, k]
    first = np.ones(b.shape, bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.roll(k, 1))
    run = k - prev - 1
    zrl = run >> 4
    n = _nbits(v)
    sym = ((run & 15) << 4) | n
    ch = chroma[b]
    acode = np.where(ch, tables["ac1"][0][sym], tables["ac0"][0][sym])
    asize = np.where(ch, tables["ac1"][1][sym], tables["ac0"][1][sym])
    ac_val, ac_len = (acode << n) | _extra(v, n), asize + n
    last = np.zeros(nb, np.int64)
    np.maximum.at(last, b, k)
    eob = last < 63
    # the events of block i: DC, (ZRLs, code) for each nonzero, EOB
    per_nz = zrl + 1
    count = 1 + np.bincount(b, per_nz, nb).astype(np.int64) + eob
    start = np.cumsum(count) - count
    total = int(count.sum())
    val = np.empty(total, np.int64)
    ln = np.empty(total, np.int64)
    val[start], ln[start] = dc_val, dc_len
    cum = np.cumsum(per_nz)
    block_cum = np.zeros(nb + 1, np.int64)
    np.add.at(block_cum, b + 1, per_nz)
    block_cum = np.cumsum(block_cum)
    pos = start[b] + 1 + (cum - block_cum[b]) - 1
    val[pos], ln[pos] = ac_val, ac_len
    zpos = np.repeat(pos, zrl) - (np.arange(int(zrl.sum())) -
                                   np.repeat(np.cumsum(zrl) - zrl, zrl)) - 1
    zch = np.repeat(ch, zrl)
    val[zpos] = np.where(zch, tables["ac1"][0][0xF0], tables["ac0"][0][0xF0])
    ln[zpos] = np.where(zch, tables["ac1"][1][0xF0], tables["ac0"][1][0xF0])
    epos = (start + count - 1)[eob]
    ech = chroma[eob]
    val[epos] = np.where(ech, tables["ac1"][0][0], tables["ac0"][0][0])
    ln[epos] = np.where(ech, tables["ac1"][1][0], tables["ac0"][1][0])
    return val, ln


def _pack(val: np.ndarray, ln: np.ndarray, chunk: int = 1 << 22) -> bytes:
    """The bits of the codes MSB first, padded with ones to a byte, 0xFF
    followed by a stuffed 0x00."""
    parts = []
    for s in range(0, len(val), chunk):
        v, n = val[s:s + chunk], ln[s:s + chunk]
        k = np.repeat(np.arange(len(v)), n)
        j = np.arange(k.shape[0]) - np.repeat(np.cumsum(n) - n, n)
        parts.append(((v[k] >> (n[k] - 1 - j)) & 1).astype(np.uint8))
    bits = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.uint8)])
    data = np.packbits(bits)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def _marker(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + (len(body) + 2).to_bytes(2, "big") + body


def baseline_jpeg(img: np.ndarray, quality: int) -> bytes:
    """The 4:2:0 baseline JFIF of ``img`` (h, w, 3) uint8 at ``quality``
    (see the module's docstring)."""
    h, w = img.shape[:2]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3 or \
            not (1 <= h <= 65535 and 1 <= w <= 65535):
        raise ValueError(f"want an (h, w, 3) uint8 image, got "
                         f"{img.shape} {img.dtype}")
    tables = [quant_table(STD_LUMA, quality), quant_table(STD_CHROMA,
                                                          quality)]
    ycc = rgb_to_ycc(img)
    my, mx = -(-h // 16), -(-w // 16)          # MCUs (16 x 16 luma)
    lby, lbx = -(-h // 8), -(-w // 8)          # luma blocks in the image
    # luma: the last row and column repeated; blocks beyond the image's
    # block grid are the dummies of the last MCU row and column
    y = _edge(ycc[0], lby * 8, lbx * 8)
    qy = quantize(fdct_islow(_blocks(y - 128, lby, lbx)), tables[0])
    full = np.zeros((2 * my, 2 * mx, 8, 8), np.int64)
    full[:lby, :lbx] = qy
    if lbx % 2:            # dummy right column: the DC of its left block
        full[:lby, lbx, 0, 0] = qy[:, lbx - 1, 0, 0]
    if lby % 2:            # dummy bottom row: the DC of the MCU's block
        full[lby, :, 0, 0] = full[lby - 1, 1::2, 0, 0].repeat(2)  # above
    planes = [full]
    for c in (1, 2):
        p = _downsample_h2v2(ycc[c], mx * 8)
        p = _edge(p, my * 8, mx * 8)
        planes.append(quantize(fdct_islow(_blocks(p - 128, my, mx)),
                               tables[1]))
    # MCU order: the 4 luma blocks (2 x 2, rows first), Cb, Cr
    luma = full.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4) \
        .reshape(my, mx, 4, 64)
    mcu = np.concatenate([luma, planes[1].reshape(my, mx, 1, 64),
                          planes[2].reshape(my, mx, 1, 64)], axis=2)
    zz = mcu.reshape(-1, 64)[:, ZIGZAG]
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), my * mx)
    scan = _pack(*_events(zz, comp))

    out = [b"\xff\xd8",
           _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i, t in enumerate(tables):
        out.append(_marker(0xDB, bytes([i]) + bytes(t[ZIGZAG].tolist())))
    out.append(_marker(0xC0, bytes([8]) + h.to_bytes(2, "big") +
                       w.to_bytes(2, "big") +
                       bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for name, slot in (("dc0", 0x00), ("ac0", 0x10), ("dc1", 0x01),
                       ("ac1", 0x11)):
        counts, symbols = HUFF[name]
        out.append(_marker(0xC4, bytes([slot]) + bytes.fromhex(counts) +
                           bytes.fromhex(symbols)))
    out.append(_marker(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63,
                                    0])))
    out += [scan, b"\xff\xd9"]
    return b"".join(out)
