"""ICC profile color management (reference surface:
``lib/jxl/cms/jxl_cms.cc`` through skcms/lcms; this image has neither,
so both the matrix/TRC class — v2/v4 RGB or gray profiles built from
rXYZ/gXYZ/bXYZ columns + curv/para tone curves — and the LUT class
(lut8 ``mft1``, lut16 ``mft2``, v4 ``mAB ``/``mBA `` pipelines with
multilinear CLUT interpolation, XYZ or Lab PCS) are implemented
directly, validated against littleCMS.)

Matrix/TRC pipeline: signal --TRC--> linear profile RGB --matrix-->
XYZ(D50) --Bradford--> XYZ(D65) --matrix--> linear sRGB, and inverse.
LUT pipeline: signal --A2B stages--> PCS(D50) --Bradford--> linear
sRGB; output direction via the profile's B2A pipeline.
"""

from __future__ import annotations

import struct

import numpy as np

_D50 = (0.34567, 0.35850)
_D65 = (0.3127, 0.3290)


def _s15f16(b: bytes, off: int) -> float:
    v, = struct.unpack_from(">i", b, off)
    return v / 65536.0


def parse_icc(icc: bytes) -> dict:
    """Parse a matrix/TRC ICC profile: returns {'gray': bool,
    'matrix': (3,3) profile-RGB -> XYZ(D50), 'trc': [3 curve specs]}.
    Raises ValueError for LUT-based or malformed profiles."""
    if len(icc) < 132 or icc[36:40] != b"acsp":
        raise ValueError("not an ICC profile")
    space = icc[16:20]
    if space not in (b"RGB ", b"GRAY"):
        raise ValueError(f"unsupported ICC color space {space!r}")
    ntags, = struct.unpack_from(">I", icc, 128)
    if len(icc) < 132 + 12 * ntags:
        raise ValueError("truncated ICC tag table")
    tags = {}
    for i in range(ntags):
        sig, off, size = struct.unpack_from(">4sII", icc, 132 + 12 * i)
        if off + size > len(icc):
            raise ValueError("ICC tag out of bounds")
        tags[sig] = icc[off:off + size]

    def read_xyz(raw: bytes):
        if raw[:4] != b"XYZ ":
            raise ValueError("bad XYZ tag")
        return [_s15f16(raw, 8), _s15f16(raw, 12), _s15f16(raw, 16)]

    def read_curve(raw: bytes):
        typ = raw[:4]
        if typ == b"curv":
            n, = struct.unpack_from(">I", raw, 8)
            if n == 0:
                return ("gamma", 1.0)
            if n == 1:
                g, = struct.unpack_from(">H", raw, 12)
                return ("gamma", g / 256.0)
            lut = np.frombuffer(raw[12:12 + 2 * n],
                                ">u2").astype(np.float64) / 65535.0
            return ("lut", lut)
        if typ == b"para":
            ft, = struct.unpack_from(">H", raw, 8)
            npar = {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}.get(ft)
            if npar is None:
                raise ValueError("unknown parametric curve type")
            pars = [_s15f16(raw, 12 + 4 * i) for i in range(npar)]
            return ("para", ft, pars)
        raise ValueError(f"unsupported curve type {typ!r}")

    if space == b"GRAY":
        if b"kTRC" not in tags:
            raise ValueError("gray ICC without kTRC")
        trc = [read_curve(tags[b"kTRC"])] * 3
        # gray maps straight to the white point's XYZ
        wx, wy = _D50
        wxyz = np.array([wx / wy, 1.0, (1 - wx - wy) / wy])
        matrix = np.column_stack([wxyz / 3, wxyz / 3, wxyz / 3])
        return {"gray": True, "matrix": matrix, "trc": trc}
    need = (b"rXYZ", b"gXYZ", b"bXYZ", b"rTRC", b"gTRC", b"bTRC")
    if all(t in tags for t in need):
        matrix = np.column_stack([read_xyz(tags[b"rXYZ"]),
                                  read_xyz(tags[b"gXYZ"]),
                                  read_xyz(tags[b"bXYZ"])])
        trc = [read_curve(tags[t]) for t in (b"rTRC", b"gTRC", b"bTRC")]
        return {"gray": False, "matrix": matrix, "trc": trc}
    # LUT profile class: A2B/B2A pipelines (lcms default intent order)
    pcs = icc[20:24]
    a2b = next((tags[t] for t in (b"A2B0", b"A2B1", b"A2B2")
                if t in tags), None)
    b2a = next((tags[t] for t in (b"B2A0", b"B2A1", b"B2A2")
                if t in tags), None)
    if a2b is None and b2a is None:
        raise ValueError("ICC profile without matrix/TRC or LUT tags")
    return {"gray": False, "matrix": None, "trc": None, "pcs": pcs,
            "a2b": _parse_lut_tag(a2b, to_pcs=True)
            if a2b is not None else None,
            "b2a": _parse_lut_tag(b2a, to_pcs=False)
            if b2a is not None else None}


def _read_curve_seq(raw: bytes, off: int, n: int):
    """n consecutive curv/para elements, each 4-byte aligned
    (ICC v4 10.5 lutAToBType)."""
    specs = []
    for _ in range(n):
        typ = raw[off:off + 4]
        if typ == b"curv":
            cnt, = struct.unpack_from(">I", raw, off + 8)
            end = off + 12 + 2 * cnt
            if cnt == 0:
                specs.append(("gamma", 1.0))
            elif cnt == 1:
                g, = struct.unpack_from(">H", raw, off + 12)
                specs.append(("gamma", g / 256.0))
            else:
                lut = np.frombuffer(raw[off + 12:end],
                                    ">u2").astype(np.float64) / 65535.0
                specs.append(("lut", lut))
        elif typ == b"para":
            ft, = struct.unpack_from(">H", raw, off + 8)
            npar = {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}.get(ft)
            if npar is None:
                raise ValueError("unknown parametric curve type")
            specs.append(("para", ft,
                          [_s15f16(raw, off + 12 + 4 * i)
                           for i in range(npar)]))
            end = off + 12 + 4 * npar
        else:
            raise ValueError(f"unsupported curve type in LUT {typ!r}")
        off = (end + 3) & ~3
    return specs


def _parse_lut_tag(raw: bytes, to_pcs: bool):
    """Parse one LUT tag into a stage list. Stages:
    ("curves", [spec]*n) | ("matrix", (3,3) M, (3,) offset) |
    ("clut", grid tuple, table (g1,..,gn,n_out))."""
    typ = raw[:4]
    if typ in (b"mft1", b"mft2"):
        n_in, n_out, g = raw[8], raw[9], raw[10]
        mat = np.array([_s15f16(raw, 12 + 4 * i)
                        for i in range(9)]).reshape(3, 3)
        stages = []
        if n_in == 3 and not np.allclose(mat, np.eye(3)):
            stages.append(("matrix", mat, np.zeros(3)))
        if typ == b"mft1":
            off = 48
            tables = np.frombuffer(raw[off:off + 256 * n_in],
                                   np.uint8).reshape(n_in, 256) / 255.0
            off += 256 * n_in
            nclut = g ** n_in * n_out
            clut = np.frombuffer(raw[off:off + nclut], np.uint8) / 255.0
            off += nclut
            out = np.frombuffer(raw[off:off + 256 * n_out],
                                np.uint8).reshape(n_out, 256) / 255.0
        else:
            n_ie, n_oe = struct.unpack_from(">HH", raw, 48)
            off = 52
            tables = np.frombuffer(
                raw[off:off + 2 * n_ie * n_in],
                ">u2").reshape(n_in, n_ie) / 65535.0
            off += 2 * n_ie * n_in
            nclut = g ** n_in * n_out
            clut = np.frombuffer(raw[off:off + 2 * nclut],
                                 ">u2") / 65535.0
            off += 2 * nclut
            out = np.frombuffer(raw[off:off + 2 * n_oe * n_out],
                                ">u2").reshape(n_out, n_oe) / 65535.0
        stages.append(("curves", [("lut", t) for t in tables]))
        stages.append(("clut", (g,) * n_in,
                       clut.reshape((g,) * n_in + (n_out,))))
        stages.append(("curves", [("lut", t) for t in out]))
        return {"type": typ.decode(), "n_in": n_in, "n_out": n_out,
                "stages": stages, "legacy_pcs": typ == b"mft2"}
    if typ in (b"mAB ", b"mBA "):
        n_in, n_out = raw[8], raw[9]
        off_b, off_mat, off_m, off_clut, off_a = struct.unpack_from(
            ">IIIII", raw, 12)
        b_curves = _read_curve_seq(raw, off_b, 3) if off_b else None
        m_curves = _read_curve_seq(raw, off_m, 3) if off_m else None
        a_curves = _read_curve_seq(
            raw, off_a, n_in if typ == b"mAB " else n_out) \
            if off_a else None
        matrix = None
        if off_mat:
            vals = [_s15f16(raw, off_mat + 4 * i) for i in range(12)]
            matrix = (np.array(vals[:9]).reshape(3, 3),
                      np.array(vals[9:]))
        clut = None
        if off_clut:
            grid = tuple(raw[off_clut + i]
                         for i in range(n_in if typ == b"mAB "
                                        else 3))
            prec = raw[off_clut + 16]
            n = int(np.prod(grid)) * n_out if typ == b"mAB " else \
                int(np.prod(grid)) * n_out
            base = off_clut + 20
            if prec == 1:
                table = np.frombuffer(raw[base:base + n],
                                      np.uint8) / 255.0
            else:
                table = np.frombuffer(raw[base:base + 2 * n],
                                      ">u2") / 65535.0
            clut = (grid, table.reshape(grid + (n_out,)))
        stages = []
        if typ == b"mAB ":                 # A -> CLUT -> M -> mat -> B
            if a_curves:
                stages.append(("curves", a_curves))
            if clut:
                stages.append(("clut", clut[0], clut[1]))
            if m_curves:
                stages.append(("curves", m_curves))
            if matrix is not None:
                stages.append(("matrix", matrix[0], matrix[1]))
            if b_curves:
                stages.append(("curves", b_curves))
        else:                              # B -> mat -> M -> CLUT -> A
            if b_curves:
                stages.append(("curves", b_curves))
            if matrix is not None:
                stages.append(("matrix", matrix[0], matrix[1]))
            if m_curves:
                stages.append(("curves", m_curves))
            if clut:
                stages.append(("clut", clut[0], clut[1]))
            if a_curves:
                stages.append(("curves", a_curves))
        return {"type": typ.decode().strip(), "n_in": n_in,
                "n_out": n_out, "stages": stages, "legacy_pcs": False}
    raise ValueError(f"unsupported LUT tag type {typ!r}")


def _apply_clut(vals: np.ndarray, grid, table: np.ndarray) -> np.ndarray:
    """CLUT interpolation: tetrahedral for 3 inputs (the lcms/skcms
    convention the reference inherits), multilinear otherwise.
    vals: (n_in, N) in [0,1]; table: (g1,..,gn, n_out) -> (n_out, N)."""
    n_in = len(grid)
    if n_in == 3:
        return _clut_tetrahedral(vals, grid, table)
    pos = [np.clip(vals[i], 0.0, 1.0) * (grid[i] - 1)
           for i in range(n_in)]
    lo = [np.minimum(p.astype(np.int64), grid[i] - 2 if grid[i] > 1
                     else 0) for i, p in enumerate(pos)]
    frac = [p - l for p, l in zip(pos, lo)]
    n_out = table.shape[-1]
    out = np.zeros((vals.shape[1], n_out))
    for corner in range(1 << n_in):
        idx = []
        wgt = np.ones(vals.shape[1])
        for i in range(n_in):
            if corner >> i & 1:
                idx.append(np.minimum(lo[i] + 1, grid[i] - 1))
                wgt = wgt * frac[i]
            else:
                idx.append(lo[i])
                wgt = wgt * (1.0 - frac[i])
        out += wgt[:, None] * table[tuple(idx)]
    return out.T


def _clut_tetrahedral(vals: np.ndarray, grid,
                      table: np.ndarray) -> np.ndarray:
    """6-simplex tetrahedral interpolation over a 3D CLUT (lcms2
    cmsintrp.c TetrahedralInterp16 case ordering)."""
    pos = [np.clip(vals[i], 0.0, 1.0) * (grid[i] - 1) for i in range(3)]
    lo = [np.minimum(p.astype(np.int64),
                     grid[i] - 2 if grid[i] > 1 else 0)
          for i, p in enumerate(pos)]
    fx, fy, fz = (p - l for p, l in zip(pos, lo))
    hi = [np.minimum(l + 1, grid[i] - 1) for i, l in enumerate(lo)]

    def c(ix, iy, iz):
        return table[(hi[0] if ix else lo[0],
                      hi[1] if iy else lo[1],
                      hi[2] if iz else lo[2])]

    c000, c111 = c(0, 0, 0), c(1, 1, 1)
    f = (fx[:, None], fy[:, None], fz[:, None])
    m_xy, m_yz, m_xz = fx >= fy, fy >= fz, fx >= fz
    cases = (
        (m_xy & m_yz, (c(1, 0, 0) - c000, c(1, 1, 0) - c(1, 0, 0),
                       c111 - c(1, 1, 0))),
        (m_xy & ~m_yz & m_xz, (c(1, 0, 0) - c000,
                               c111 - c(1, 0, 1),
                               c(1, 0, 1) - c(1, 0, 0))),
        (m_xy & ~m_yz & ~m_xz, (c(1, 0, 1) - c(0, 0, 1),
                                c111 - c(1, 0, 1),
                                c(0, 0, 1) - c000)),
        (~m_xy & ~m_yz, (c111 - c(0, 1, 1), c(0, 1, 1) - c(0, 0, 1),
                         c(0, 0, 1) - c000)),
        (~m_xy & m_yz & ~m_xz, (c111 - c(0, 1, 1),
                                c(0, 1, 0) - c000,
                                c(0, 1, 1) - c(0, 1, 0))),
        (~m_xy & m_yz & m_xz, (c(1, 1, 0) - c(0, 1, 0),
                               c(0, 1, 0) - c000,
                               c111 - c(1, 1, 0))),
    )
    acc = np.zeros_like(c000)
    sel_any = np.zeros(vals.shape[1], bool)
    for mask, (dx, dy, dz) in cases:
        mask = mask & ~sel_any
        sel_any |= mask
        acc = np.where(mask[:, None],
                       c000 + f[0] * dx + f[1] * dy + f[2] * dz, acc)
    return acc.T


def _apply_pipeline(vals: np.ndarray, lut: dict) -> np.ndarray:
    """vals: (n_in, N) in [0,1] -> (n_out, N) in [0,1]."""
    for stage in lut["stages"]:
        if stage[0] == "curves":
            vals = np.stack([_curve_forward(vals[i], s)
                             for i, s in enumerate(stage[1])])
        elif stage[0] == "matrix":
            vals = stage[1] @ vals + stage[2][:, None]
        else:
            vals = _apply_clut(vals, stage[1], stage[2])
    return vals


def _pcs_decode(vals: np.ndarray, pcs: bytes, legacy: bool) -> np.ndarray:
    """Encoded PCS channel values in [0,1] -> XYZ(D50)."""
    if pcs == b"XYZ ":
        return vals * (65535.0 / 32768.0)
    if legacy:                              # ICC v2 Lab16 encoding
        lab_l = vals[0] * 100.0 * 65535.0 / 65280.0
        lab_a = vals[1] * 255.0 * 65535.0 / 65280.0 - 128.0
        lab_b = vals[2] * 255.0 * 65535.0 / 65280.0 - 128.0
    else:
        lab_l = vals[0] * 100.0
        lab_a = vals[1] * 255.0 - 128.0
        lab_b = vals[2] * 255.0 - 128.0
    return _lab_to_xyz(np.stack([lab_l, lab_a, lab_b]))


def _pcs_encode(xyz: np.ndarray, pcs: bytes, legacy: bool) -> np.ndarray:
    """XYZ(D50) -> encoded PCS channel values in [0,1]."""
    if pcs == b"XYZ ":
        return xyz * (32768.0 / 65535.0)
    lab = _xyz_to_lab(xyz)
    if legacy:
        return np.stack([lab[0] / 100.0 * 65280.0 / 65535.0,
                         (lab[1] + 128.0) / 255.0 * 65280.0 / 65535.0,
                         (lab[2] + 128.0) / 255.0 * 65280.0 / 65535.0])
    return np.stack([lab[0] / 100.0, (lab[1] + 128.0) / 255.0,
                     (lab[2] + 128.0) / 255.0])


def _d50_xyz() -> np.ndarray:
    wx, wy = _D50
    return np.array([wx / wy, 1.0, (1 - wx - wy) / wy])


def _lab_to_xyz(lab: np.ndarray) -> np.ndarray:
    fy = (lab[0] + 16.0) / 116.0
    fx = fy + lab[1] / 500.0
    fz = fy - lab[2] / 200.0

    def f_inv(t):
        return np.where(t > 6.0 / 29.0, t ** 3,
                        3 * (6.0 / 29.0) ** 2 * (t - 4.0 / 29.0))
    return _d50_xyz()[:, None] * np.stack([f_inv(fx), f_inv(fy),
                                           f_inv(fz)])


def _xyz_to_lab(xyz: np.ndarray) -> np.ndarray:
    r = np.maximum(xyz / _d50_xyz()[:, None], 0.0)

    def f(t):
        return np.where(t > (6.0 / 29.0) ** 3, np.cbrt(t),
                        t / (3 * (6.0 / 29.0) ** 2) + 4.0 / 29.0)
    fx, fy, fz = f(r[0]), f(r[1]), f(r[2])
    return np.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                     200.0 * (fy - fz)])


def _curve_forward(x: np.ndarray, spec) -> np.ndarray:
    """device signal -> linear (the TRC direction stored in profiles)."""
    x = np.clip(x, 0.0, 1.0)
    if spec[0] == "gamma":
        return x ** spec[1]
    if spec[0] == "lut":
        lut = spec[1]
        return np.interp(x, np.linspace(0, 1, len(lut)), lut)
    _, ft, p = spec
    if ft == 0:
        return x ** p[0]
    # types 1-4 generalize Y = (a X + b)^g above a threshold
    if ft == 1:
        g, a, b = p
        d = -b / a
        return np.where(x >= d, (a * x + b) ** g, 0.0)
    if ft == 2:
        g, a, b, c = p
        d = -b / a
        return np.where(x >= d, (a * x + b) ** g + c, c)
    if ft == 3:
        g, a, b, c, d = p
        return np.where(x >= d, (a * x + b) ** g, c * x)
    g, a, b, c, d, e, f = p
    return np.where(x >= d, (a * x + b) ** g + e, c * x + f)


def _curve_inverse(y: np.ndarray, spec) -> np.ndarray:
    """linear -> device signal."""
    y = np.clip(y, 0.0, 1.0)
    if spec[0] == "gamma":
        return y ** (1.0 / max(spec[1], 1e-6))
    if spec[0] == "lut":
        lut = np.maximum.accumulate(spec[1])     # enforce monotonic
        xs = np.linspace(0, 1, len(lut))
        return np.interp(y, lut, xs)
    _, ft, p = spec
    if ft == 0:
        return y ** (1.0 / max(p[0], 1e-6))
    if ft == 3:
        g, a, b, c, d = p
        lin_max = c * d
        return np.where(y >= lin_max,
                        (np.maximum(y, 1e-12) ** (1.0 / g) - b) / a,
                        y / max(c, 1e-12))
    # fall back to numeric inversion via a dense LUT for types 1/2/4
    xs = np.linspace(0, 1, 4096)
    ys = np.maximum.accumulate(_curve_forward(xs, spec))
    return np.interp(y, ys, xs)


def _xyz_matrix_to_srgb() -> np.ndarray:
    from libjxl_torch.color.cms import adapt_matrix, rgb_to_xyz_matrix
    from libjxl_torch.core.headers import ColorEncoding
    srgb = ColorEncoding.srgb()
    m_srgb = rgb_to_xyz_matrix(srgb)            # sRGB -> XYZ(D65)
    adapt = adapt_matrix(_D50, _D65)            # XYZ D50 -> D65
    return np.linalg.inv(m_srgb) @ adapt


def icc_to_linear_srgb(planes: np.ndarray, icc: bytes) -> np.ndarray:
    """(3, h, w) device signal under the ICC profile -> linear sRGB."""
    prof = parse_icc(icc)
    if prof["matrix"] is None:
        lut = prof["a2b"]
        if lut is None:
            raise ValueError("ICC LUT profile without an A2B tag")
        if lut["n_in"] != 3:
            raise ValueError(f"{lut['n_in']}-channel ICC input "
                             "unsupported")
        sh = planes.shape[1:]
        enc = _apply_pipeline(planes.reshape(3, -1), lut)
        xyz = _pcs_decode(enc, prof["pcs"], lut["legacy_pcs"])
        return (_xyz_matrix_to_srgb() @ xyz).reshape((3,) + sh)
    lin = np.stack([_curve_forward(planes[c], prof["trc"][c])
                    for c in range(3)])
    m = _xyz_matrix_to_srgb() @ prof["matrix"]
    return np.einsum("ij,jhw->ihw", m, lin)


def linear_srgb_to_icc(planes: np.ndarray, icc: bytes) -> np.ndarray:
    """linear sRGB -> (3, h, w) device signal under the ICC profile."""
    prof = parse_icc(icc)
    if prof["gray"]:
        raise ValueError("cannot target a gray ICC profile with RGB")
    if prof["matrix"] is None:
        lut = prof["b2a"]
        if lut is None:
            raise ValueError("ICC LUT profile without a B2A tag")
        if lut["n_out"] != 3:
            raise ValueError(f"{lut['n_out']}-channel ICC output "
                             "unsupported")
        sh = planes.shape[1:]
        xyz = np.linalg.inv(_xyz_matrix_to_srgb()) @ planes.reshape(3, -1)
        enc = _pcs_encode(xyz, prof["pcs"], lut["legacy_pcs"])
        dev = _apply_pipeline(np.clip(enc, 0.0, 1.0), lut)
        return dev.reshape((3,) + sh)
    m = np.linalg.inv(_xyz_matrix_to_srgb() @ prof["matrix"])
    lin = np.einsum("ij,jhw->ihw", m, planes)
    return np.stack([_curve_inverse(lin[c], prof["trc"][c])
                     for c in range(3)])
