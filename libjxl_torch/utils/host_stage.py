"""Native class staging of the variable-block serving decode, and the
AC decode of subsampled DCT8 frames (``libjxl_torch/csrc/host_stage.cc``).

``count_classes`` reads the native AC decoder's run-packed groups once
and sizes each strategy class's arrays; ``fill_classes`` writes them into
arrays the caller provides, so that a pool worker can lay them out in
the shared-memory segment the parent maps. Together they give exactly
what ``api/decoder._var_classes`` (the plain twin the tests hold them
to) gives. ``ac_decode_subsampled`` decodes the AC tokens of a
recompressed JPEG's frame (chroma subsampled, every block DCT8) into
dense int16 coefficient planes the caller provides. Built with g++ on
first use into ``libjxl_torch/build/``, keyed by the source's hash, as
``utils/native.py`` builds ``native/jxl_host.cc``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import NamedTuple

import numpy as np

from libjxl_torch.utils import native

_SRC = os.path.join(native._REPO_ROOT, "libjxl_torch", "csrc",
                    "host_stage.cc")
_lib = None
_lock = threading.Lock()

_N = 27          # AC strategies


def get_lib():
    """The staging library, built and bound on first call (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(native._build(_SRC, "host_stage"))
            P, I64 = ctypes.c_void_p, ctypes.c_int64
            lib.jxlt_stage_count.restype = I64
            lib.jxlt_stage_count.argtypes = [I64] + [P] * 8
            lib.jxlt_stage_fill.restype = I64
            lib.jxlt_stage_fill.argtypes = [I64] + [P] * 9 + [I64] * 3 + [P]
            I32 = ctypes.c_int32
            lib.jxlt_ac_decode_subsampled.restype = I64
            lib.jxlt_ac_decode_subsampled.argtypes = (
                [P] * 4 + [I64] + [P] * 6 + [I64] + [I32] * 4 + [P] +
                [I64] * 2 + [P] * 5 + [I32])
            _lib = lib
        return _lib


def _cover() -> np.ndarray:
    from libjxl_torch.vardct.ac_strategy import COVERED_X, COVERED_Y
    return np.asarray(COVERED_X, np.int64) * np.asarray(COVERED_Y) * 64


class ClassCounts(NamedTuple):
    """What ``count_classes`` read: the groups as the native pass takes
    them (their buffers kept alive here), per strategy its blocks,
    nonzeros and largest |value|, and the nonzero mask of each run of 64
    coefficients (which the filling pass reads instead of the zeros)."""

    args: tuple           # (n, rects, acs, anc, coef, coef_len) pointers
    keep: list            # the arrays those pointers point into
    cover: np.ndarray     # (27,) int64 coefficients a block of each class
    counts: np.ndarray    # (27, 3) int64 blocks, nonzeros, max |value|
    masks: np.ndarray     # uint64, one a run of 64 coefficients

    @property
    def present(self) -> list:
        """The classes with blocks, in order."""
        return np.flatnonzero(self.counts[:, 0]).tolist()

    def specs(self) -> list:
        """(shape, dtype) of (vals, idx, qf, fy, fx) of each present
        class in turn: the arrays ``fill_classes`` writes."""
        out = []
        for s in self.present:
            blocks, nnz, top = self.counts[s].tolist()
            out += [((nnz,), np.int16 if top <= 32767 else np.int32),
                    ((nnz,), np.int64)] + [((blocks,), np.int32)] * 3
        return out


def _check(rc: int, what: str) -> None:
    if rc != 0:
        from libjxl_torch.core.fields import FormatError
        raise FormatError(f"{what}: AC groups the class staging cannot "
                          f"read (error {rc})")


def count_classes(runs: list) -> ClassCounts:
    """The counting pass over ``runs``, the native decoder's run-packed
    groups ``(bx0, by0, w, h, acs, anchors, coeffs)``."""
    lib = get_lib()
    keep, rects, lens = [], [], []
    for (bx0, by0, w, h, acs_g, anc_g, coeffs) in runs:
        acs = np.ascontiguousarray(acs_g, np.int8)
        anc = np.ascontiguousarray(np.asarray(anc_g) != 0).view(np.uint8)
        coef = np.ascontiguousarray(coeffs, np.int32)
        if acs.shape != (h, w) or anc.shape != (h, w) or \
                coef.ndim != 2 or coef.shape[0] != 3:
            raise ValueError("a run-packed group of another shape")
        keep += [acs, anc, coef]
        rects.append((bx0, by0, w, h))
        lens.append(coef.shape[1])
    ptrs = [np.asarray([a.ctypes.data for a in keep[i::3]], np.uintp)
            for i in range(3)]
    rects = np.asarray(rects, np.int64).reshape(-1, 4)
    lens = np.asarray(lens, np.int64)
    keep += ptrs + [rects, lens]
    args = (len(runs), rects.ctypes.data, *(p.ctypes.data for p in ptrs),
            lens.ctypes.data)
    cover = _cover()
    counts = np.zeros((_N, 3), np.int64)
    masks = np.empty(3 * int(lens.sum()) // 64 + 1, np.uint64)
    _check(lib.jxlt_stage_count(*args, cover.ctypes.data,
                                counts.ctypes.data, masks.ctypes.data),
           "count")
    return ClassCounts(args, keep, cover, counts, masks)


def fill_classes(cc: ClassCounts, raw_quant: np.ndarray, out: list) -> dict:
    """The filling pass: writes each present class's (vals, idx, qf, fy,
    fx) into ``out`` (empty arrays as ``cc.specs()`` gives them) and
    returns ``{s: (vals, idx, qf, fy, fx)}`` of those arrays."""
    specs = cc.specs()
    if len(out) != len(specs) or any(
            a.shape != shape or a.dtype != dtype or
            not a.flags.c_contiguous or not a.flags.writeable
            for a, (shape, dtype) in zip(out, specs)):
        raise ValueError("fill_classes needs the arrays of cc.specs()")
    rq = np.asarray(raw_quant)
    if rq.dtype != np.int32 or rq.ndim != 2 or rq.strides[1] != 4:
        raise ValueError("raw_quant must be a 2-D int32 array with "
                         "contiguous rows")
    outs = np.zeros((_N, 5), np.uintp)
    classes = {}
    for k, s in enumerate(cc.present):
        arrs = out[5 * k:5 * k + 5]
        outs[s] = [a.ctypes.data for a in arrs]
        classes[s] = tuple(arrs)
    _check(get_lib().jxlt_stage_fill(
        *cc.args, cc.cover.ctypes.data, cc.counts.ctypes.data,
        cc.masks.ctypes.data, rq.ctypes.data, rq.shape[0], rq.shape[1], rq.strides[0] // 4,
        outs.ctypes.data), "fill")
    return classes


def var_classes(runs: list, raw_quant: np.ndarray) -> dict:
    """``_var_classes`` by the native passes, into arrays of its own."""
    cc = count_classes(runs)
    return fill_classes(cc, raw_quant,
                        [np.empty(s, d) for s, d in cc.specs()])


def subsampled_planes_shapes(dec) -> list:
    """(shape, dtype) of the three coefficient planes of
    ``ac_decode_subsampled`` for the frame of ``dec``."""
    fd = dec.fd
    return [((fd.ysize_blocks >> dec.vs[c], fd.xsize_blocks >> dec.hs[c], 64),
             np.dtype(np.int16)) for c in range(3)]


def ac_decode_subsampled(dec, sections: dict, planes: list,
                         n_threads: int = 0):
    """Decode the AC sections ``{group: (bytes, start bit)}`` of the
    one-pass, all-DCT8, chroma-subsampled frame of ``dec`` (a
    ``VarDCTFrameDecoder`` past its AC global section) into ``planes``:
    per channel a C-contiguous int16 array of
    ``subsampled_planes_shapes(dec)``, each block's 64 quantized values
    in the stored layout (every value written). Returns ``planes``, or
    None where the frame needs the Python path (prefix codes, LZ77, a
    block other than DCT8, a value outside int16); raises FormatError
    for a corrupt section. ``n_threads`` 0: one a group up to the cores
    on the main thread, one elsewhere (a pool's worker)."""
    from libjxl_torch.core.fields import FormatError

    code = dec.codes[0]
    if code.use_prefix_code or code.lz77.enabled or \
            dec.fh.passes.num_passes != 1 or not dec.acs_anchor.all() or \
            (dec.acs_raw != 0).any():
        return None
    specs = subsampled_planes_shapes(dec)
    if len(planes) != 3 or any(
            p.shape != shape or p.dtype != dt or not p.flags.c_contiguous or
            not p.flags.writeable for p, (shape, dt) in zip(planes, specs)):
        raise ValueError("planes must be the arrays of "
                         "subsampled_planes_shapes")
    fd = dec.fd
    gids = sorted(sections)
    gdb = fd.group_dim // 8
    rects = np.asarray([
        (bx0, by0, min(gdb, fd.xsize_blocks - bx0),
         min(gdb, fd.ysize_blocks - by0))
        for bx0, by0 in ((g % fd.xsize_groups * gdb,
                          g // fd.xsize_groups * gdb) for g in gids)],
        np.int64).reshape(-1, 4)
    bufs = [np.frombuffer(sections[g][0], np.uint8) for g in gids]
    lens = np.asarray([len(b) for b in bufs], np.int64)
    offs = np.zeros(len(gids) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    data = np.concatenate(bufs) if bufs else np.zeros(1, np.uint8)
    start = np.asarray([sections[g][1] for g in gids], np.int64)
    block_ctx3 = dec._block_ctx3(0, 0, fd.xsize_blocks, fd.ysize_blocks)
    alias_sym, alias_off, freqs, cfgs, ctx_map = dec._flat_code_tables(0)
    orders, order_off = dec._flat_orders(0)
    hs = np.asarray(dec.hs, np.int32)
    vs = np.asarray(dec.vs, np.int32)
    ptrs = np.asarray([p.ctypes.data for p in planes], np.uintp)
    if n_threads <= 0:
        from libjxl_torch.api.decoder import _native_ac_threads
        n_threads = _native_ac_threads(len(gids))
    selector_bits = ((dec.num_histograms - 1).bit_length()
                     if dec.num_histograms > 1 else 0)
    rc = get_lib().jxlt_ac_decode_subsampled(
        data.ctypes.data, offs.ctypes.data, lens.ctypes.data,
        start.ctypes.data, len(gids), rects.ctypes.data,
        alias_sym.ctypes.data, alias_off.ctypes.data, freqs.ctypes.data,
        cfgs.ctypes.data, ctx_map.ctypes.data, len(ctx_map), selector_bits,
        dec.num_histograms, dec.bctx.num_ac_contexts(), dec.bctx.num_ctxs,
        block_ctx3.ctypes.data, fd.xsize_blocks, fd.ysize_blocks,
        orders.ctypes.data, order_off.ctypes.data, hs.ctypes.data,
        vs.ctypes.data, ptrs.ctypes.data, n_threads)
    if rc == -6:
        return None
    if rc != 0:
        raise FormatError(f"AC frame native decode error {rc}")
    return planes
