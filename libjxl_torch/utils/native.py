"""Loader/builder for the native host kernels (``native/jxl_host.cc``).

Compiles on first use with g++ -O3 into a cached shared object under
``libjxl_torch/build/``. Processes that build at once serialise on a
lock file there and each compiles to a temporary file of its own; a
failed build raises with the compiler's output and is tried again on
the next call.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "jxl_host.cc")
_BUILD_DIR = os.path.join(_REPO_ROOT, "libjxl_torch", "build")

_lib = None
_lock = threading.Lock()


def _build(src_path: str | None = None, stem: str = "jxl_host") -> str:
    """Build ``src_path`` (default ``native/jxl_host.cc``) into
    ``<stem>_<key>.so`` unless it is built; returns the path."""
    # Cache key includes the machine + compiler identity: -march=native
    # binaries are CPU-specific, and a stale/foreign .so must never be
    # dlopened just because the source hash matches.
    src_path = src_path or _SRC
    with open(src_path, "rb") as f:
        src = f.read()
    import platform
    cxx_id = subprocess.run(["g++", "--version"], capture_output=True,
                            timeout=10).stdout[:200]
    key = hashlib.sha256(src + cxx_id + platform.platform().encode() +
                         platform.processor().encode()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so_path = os.path.join(_BUILD_DIR, f"{stem}_{key}.so")
    with open(os.path.join(_BUILD_DIR, f"{stem}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so_path):
            return so_path
        tmp = f"{so_path}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", "-pthread", src_path, "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"native build of {src_path} failed:\n"
                               f"{proc.stderr}")
        os.replace(tmp, so_path)
    return so_path


def get_lib():
    """The native library, built and bound on first call (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(_build())
        return _lib


def _bind(so_path: str):
    lib = ctypes.CDLL(so_path)
    lib.jxlt_ans_encode_stream.restype = ctypes.c_int64
    lib.jxlt_ans_encode_stream.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64]
    lib.jxlt_ans_encode_multi.restype = ctypes.c_int64
    lib.jxlt_ans_encode_multi.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.jxlt_ans_decode_tokens.restype = ctypes.c_int64
    lib.jxlt_ans_decode_tokens.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_void_p]
    lib.jxlt_gradient_reconstruct.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.jxlt_gradient_residuals.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    return lib


def available() -> bool:
    return get_lib() is not None


def ans_encode_stream(tokens: np.ndarray, nbits: np.ndarray,
                      bits: np.ndarray, counts: np.ndarray,
                      start: np.ndarray, slots: np.ndarray
                      ) -> tuple[bytes, int] | None:
    """Returns (packed_bytes, total_bits) or None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    tokens = np.ascontiguousarray(tokens, dtype=np.int32)
    nbits = np.ascontiguousarray(nbits, dtype=np.int32)
    bits = np.ascontiguousarray(bits, dtype=np.uint32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    start = np.ascontiguousarray(start, dtype=np.int64)
    slots = np.ascontiguousarray(slots, dtype=np.int32)
    n = len(tokens)
    cap = 8 * n + 64 + (n // 2) + 1024
    out = np.zeros(cap, dtype=np.uint8)
    total_bits = lib.jxlt_ans_encode_stream(
        tokens.ctypes.data, nbits.ctypes.data, bits.ctypes.data, n,
        counts.ctypes.data, start.ctypes.data, slots.ctypes.data,
        out.ctypes.data, cap)
    if total_bits < 0:
        return None
    return out[: (total_bits + 7) // 8].tobytes(), int(total_bits)


def ans_encode_multi(tokens: np.ndarray, histos: np.ndarray,
                     nbits: np.ndarray, bits: np.ndarray,
                     counts_list, start_list, slots_list
                     ) -> tuple[bytes, int] | None:
    """Multi-context rANS emission: per-token histogram ids against
    flattened per-histogram tables. Returns (bytes, total_bits) or None
    when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    tokens = np.ascontiguousarray(tokens, dtype=np.int32)
    histos = np.ascontiguousarray(histos, dtype=np.int32)
    nbits = np.ascontiguousarray(nbits, dtype=np.int32)
    bits = np.ascontiguousarray(bits, dtype=np.uint32)
    counts_off = np.zeros(len(counts_list) + 1, dtype=np.int64)
    counts_off[1:] = np.cumsum([len(c) for c in counts_list])
    counts_flat = np.concatenate(
        [np.asarray(c, np.int32) for c in counts_list]) \
        if counts_list else np.zeros(0, np.int32)
    counts_flat = np.ascontiguousarray(counts_flat, dtype=np.int32)
    start_off = np.zeros(len(start_list) + 1, dtype=np.int64)
    start_off[1:] = np.cumsum([len(s) for s in start_list])
    start_flat = np.concatenate(
        [np.asarray(s, np.int64) for s in start_list]) \
        if start_list else np.zeros(0, np.int64)
    start_flat = np.ascontiguousarray(start_flat, dtype=np.int64)
    slots_flat = np.ascontiguousarray(
        np.concatenate([np.asarray(s, np.int32) for s in slots_list]),
        dtype=np.int32)
    n = len(tokens)
    cap = 8 * n + 64 + (n // 2) + 1024
    out = np.zeros(cap, dtype=np.uint8)
    total_bits = lib.jxlt_ans_encode_multi(
        tokens.ctypes.data, histos.ctypes.data, nbits.ctypes.data,
        bits.ctypes.data, n, counts_flat.ctypes.data,
        counts_off.ctypes.data, start_flat.ctypes.data,
        start_off.ctypes.data, slots_flat.ctypes.data,
        out.ctypes.data, cap)
    if total_bits < 0:
        return None
    return out[: (total_bits + 7) // 8].tobytes(), int(total_bits)


def ans_decode_tokens(data: bytes, start_bit: int, n: int,
                      alias_sym: np.ndarray, alias_off: np.ndarray,
                      freqs: np.ndarray, cfg=(4, 2, 0),
                      check_final: bool = True, state: int | None = None):
    """Returns (values, end_bit, state) or None if native
    unavailable/failed. Pass `state` to continue a live ANS stream (the
    32-bit initial state is then NOT read from the bitstream)."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    alias_sym = np.ascontiguousarray(alias_sym, dtype=np.int32)
    alias_off = np.ascontiguousarray(alias_off, dtype=np.int32)
    freqs = np.ascontiguousarray(freqs, dtype=np.int32)
    out = np.empty(n, dtype=np.uint32)
    st = np.array([0 if state is None else state], dtype=np.uint32)
    end = lib.jxlt_ans_decode_tokens(
        buf.ctypes.data, len(buf), start_bit, n,
        alias_sym.ctypes.data, alias_off.ctypes.data, freqs.ctypes.data,
        cfg[0], cfg[1], cfg[2], out.ctypes.data, 1 if check_final else 0,
        st.ctypes.data if state is not None else None)
    if end < 0:
        return None
    return out, int(end), int(st[0]) if state is not None else None


def build_alias_table(counts: np.ndarray, log_alpha_size: int):
    """Native alias-table build; returns (sym, off, freq) or None."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "jxlt_build_alias_table_bound"):
        lib.jxlt_build_alias_table.restype = ctypes.c_int64
        lib.jxlt_build_alias_table.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.jxlt_build_alias_table_bound = True
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    sym = np.empty(4096, np.int32)
    off = np.empty(4096, np.int32)
    freq = np.empty(1 << log_alpha_size, np.int32)
    rc = lib.jxlt_build_alias_table(
        counts.ctypes.data, len(counts), log_alpha_size,
        sym.ctypes.data, off.ctypes.data, freq.ctypes.data)
    if rc != 0:
        from libjxl_torch.core.fields import FormatError
        raise FormatError("invalid histogram for alias table")
    return sym, off, freq


def sparsify_i32(buf: np.ndarray, n_threads: int = 0):
    """(idx, val) of the nonzeros of a dense int32 array, threaded.
    Falls back to np.flatnonzero without the native lib."""
    flat = np.ascontiguousarray(buf).reshape(-1)
    lib = get_lib()
    if lib is None:
        idx = np.flatnonzero(flat).astype(np.int32)
        return idx, flat[idx]
    if not hasattr(lib, "jxlt_sparsify_i32_bound"):
        lib.jxlt_sparsify_i32.restype = ctypes.c_int64
        lib.jxlt_sparsify_i32.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.jxlt_sparsify_i32_bound = True
    if n_threads <= 0:
        import threading
        n_threads = 1 if threading.current_thread() is not \
            threading.main_thread() else (os.cpu_count() or 1)
    out_idx = np.empty(flat.size, np.int32)
    out_val = np.empty(flat.size, np.int32)
    nnz = lib.jxlt_sparsify_i32(flat.ctypes.data, flat.size, n_threads,
                                out_idx.ctypes.data, out_val.ctypes.data)
    return out_idx[:nnz].copy(), out_val[:nnz].copy()


def gradient_reconstruct(residuals: np.ndarray, h: int, w: int) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        return None
    residuals = np.ascontiguousarray(residuals, dtype=np.uint32)
    out = np.empty((h, w), dtype=np.int32)
    lib.jxlt_gradient_reconstruct(residuals.ctypes.data, h, w,
                                  out.ctypes.data)
    return out


def gradient_residuals_native(plane: np.ndarray) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    plane = np.ascontiguousarray(plane, dtype=np.int32)
    h, w = plane.shape
    out = np.empty((h, w), dtype=np.uint32)
    lib.jxlt_gradient_residuals(plane.ctypes.data, h, w, out.ctypes.data)
    return out


def lossless_group_encode(packed: np.ndarray, gw: int, gh: int,
                          counts: np.ndarray, start: np.ndarray,
                          slots: np.ndarray) -> tuple[bytes, int] | None:
    """One-shot (C, gd, gd) packed-residual plane -> ANS stream bytes.

    Tokenize (default hybrid-uint) + rANS + pack in native code; returns
    (packed_bytes, total_bits) or None when native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "jxlt_lossless_group_encode_bound"):
        lib.jxlt_lossless_group_encode.restype = ctypes.c_int64
        lib.jxlt_lossless_group_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.jxlt_lossless_group_encode_bound = True
    if packed.dtype == np.uint8:
        elem = 1
    elif packed.dtype == np.uint16:
        elem = 2
    elif packed.dtype == np.uint32:
        elem = 4
    else:
        return None
    packed = np.ascontiguousarray(packed)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    start = np.ascontiguousarray(start, dtype=np.int64)
    slots = np.ascontiguousarray(slots, dtype=np.int32)
    nch, gd, _ = packed.shape
    n = nch * gw * gh
    cap = 8 * n + 64 + (n // 2) + 1024
    out = np.zeros(cap, dtype=np.uint8)
    total_bits = lib.jxlt_lossless_group_encode(
        packed.ctypes.data, elem, nch, gd, gw, gh,
        counts.ctypes.data, start.ctypes.data, slots.ctypes.data,
        out.ctypes.data, cap)
    if total_bits < 0:
        return None
    return out[: (total_bits + 7) // 8].tobytes(), int(total_bits)


def pack_bits(nbits: np.ndarray, values: np.ndarray) -> bytes | None:
    """Native LSB-first packing; returns bytes or None."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "jxlt_pack_bits_bound"):
        lib.jxlt_pack_bits.restype = ctypes.c_int64
        lib.jxlt_pack_bits.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64]
        lib.jxlt_pack_bits_bound = True
    nbits = np.ascontiguousarray(nbits, dtype=np.int64)
    values = np.ascontiguousarray(values, dtype=np.uint64)
    cap = int(nbits.sum()) // 8 + 16
    out = np.zeros(cap, dtype=np.uint8)
    total = lib.jxlt_pack_bits(nbits.ctypes.data, values.ctypes.data,
                               len(nbits), out.ctypes.data, cap)
    if total < 0:
        return None
    return out[: (total + 7) // 8].tobytes()


def splice_chunks(words: np.ndarray, word_start: np.ndarray,
                  chunk_bits: np.ndarray, c0: int, c1: int
                  ) -> tuple[bytes, int] | None:
    """Concatenate device-packed word-aligned chunks [c0, c1) into one
    continuous LSB-first bitstream; returns (bytes, total_bits)."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "jxlt_splice_chunks_bound"):
        lib.jxlt_splice_chunks.restype = ctypes.c_int64
        lib.jxlt_splice_chunks.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        lib.jxlt_splice_chunks_bound = True
    words = np.ascontiguousarray(words, dtype=np.uint32)
    word_start = np.ascontiguousarray(word_start, dtype=np.int64)
    chunk_bits = np.ascontiguousarray(chunk_bits, dtype=np.uint16)
    total = int(chunk_bits[c0:c1].astype(np.int64).sum())
    cap = total // 8 + 16
    out = np.zeros(cap, dtype=np.uint8)
    bits = lib.jxlt_splice_chunks(
        words.ctypes.data, word_start.ctypes.data, chunk_bits.ctypes.data,
        c0, c1, out.ctypes.data, cap)
    if bits < 0:
        return None
    return out[: (bits + 7) // 8].tobytes(), int(bits)


def splice_section(prefix_bytes: bytes, prefix_nbits: int,
                   words: np.ndarray, word_start: np.ndarray,
                   chunk_bits: np.ndarray, c0: int, c1: int) -> bytes | None:
    """Header bits + spliced chunks + byte pad: one native call per
    section. ``words``/``word_start``/``chunk_bits`` must already be
    contiguous arrays of dtype uint32/int64/uint16."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "jxlt_splice_section_bound"):
        lib.jxlt_splice_section.restype = ctypes.c_int64
        lib.jxlt_splice_section.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        lib.jxlt_splice_section_bound = True
    total = int(chunk_bits[c0:c1].astype(np.int64).sum()) + prefix_nbits
    cap = total // 8 + 16
    out = np.zeros(cap, dtype=np.uint8)
    nbytes = lib.jxlt_splice_section(
        prefix_bytes, prefix_nbits, words.ctypes.data,
        word_start.ctypes.data, chunk_bits.ctypes.data,
        c0, c1, out.ctypes.data, cap)
    if nbytes < 0:
        return None
    return out[:nbytes].tobytes()


def prefix_encode_group(packed: np.ndarray, gw: int, gh: int,
                        lut_bits: np.ndarray, lut_len: np.ndarray,
                        prefix_bytes: bytes, prefix_nbits: int
                        ) -> bytes | None:
    """Tokenize + prefix-code one group's (C, gd, gd) packed residuals
    into a complete byte-aligned section (host-pack mode)."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "jxlt_prefix_encode_group_bound"):
        lib.jxlt_prefix_encode_group.restype = ctypes.c_int64
        lib.jxlt_prefix_encode_group.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        lib.jxlt_prefix_encode_group_bound = True
    packed = np.ascontiguousarray(packed)
    elem = packed.dtype.itemsize
    nch, gd, _ = packed.shape
    n = nch * gw * gh
    cap = 4 * n + prefix_nbits // 8 + 64
    out = np.zeros(cap, dtype=np.uint8)
    nbytes = lib.jxlt_prefix_encode_group(
        packed.ctypes.data, elem, nch, gd, gw, gh,
        lut_bits.ctypes.data, lut_len.ctypes.data,
        prefix_bytes, prefix_nbits, out.ctypes.data, cap)
    if nbytes < 0:
        return None
    return out[:nbytes].tobytes()


def wp_plane(plane: np.ndarray, wp_header=None
             ) -> tuple[np.ndarray, np.ndarray] | None:
    """Whole-plane weighted-predictor sweep: (pred, p15_property).
    ``wp_header``: optional modular WPHeader (non-default params,
    context_predict.h PredictorMode presets)."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "jxlt_wp_plane_bound"):
        lib.jxlt_wp_plane.restype = None
        lib.jxlt_wp_plane.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.jxlt_wp_plane_bound = True
    plane = np.ascontiguousarray(plane, dtype=np.int32)
    h, w = plane.shape
    pred = np.empty((h, w), np.int32)
    prop = np.empty((h, w), np.int32)
    hdr_ptr = None
    if wp_header is not None:
        hdr = np.array([wp_header.p1C, wp_header.p2C, wp_header.p3Ca,
                        wp_header.p3Cb, wp_header.p3Cc, wp_header.p3Cd,
                        wp_header.p3Ce] + list(wp_header.w), np.int32)
        hdr_ptr = hdr.ctypes.data
    lib.jxlt_wp_plane(plane.ctypes.data, w, h, hdr_ptr,
                      pred.ctypes.data, prop.ctypes.data)
    return pred, prop


def lz77_parse(values: np.ndarray, sym_cost: np.ndarray,
               add_cost: np.ndarray, min_length: int,
               special_dists: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray] | None:
    """Greedy+lazy hash-chain LZ77 parse of one token stream
    (enc_lz77.cc:439 ApplyLZ77_LZ77). ``sym_cost`` is the prefix-sum of
    per-symbol literal bit costs (length n+1); ``add_cost`` the
    per-position penalty for introducing a length symbol into that
    position's context; ``special_dists`` maps special-distance index ->
    actual distance (empty when the stream has no distance multiplier).
    Returns (match_len, dist_symbol) arrays (zero where no match starts)
    or None when native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "jxlt_lz77_parse_bound"):
        lib.jxlt_lz77_parse.restype = ctypes.c_int64
        lib.jxlt_lz77_parse.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.jxlt_lz77_parse_bound = True
    values = np.ascontiguousarray(values, dtype=np.uint32)
    sym_cost = np.ascontiguousarray(sym_cost, dtype=np.float32)
    add_cost = np.ascontiguousarray(add_cost, dtype=np.float32)
    special_dists = np.ascontiguousarray(special_dists, dtype=np.int32)
    n = len(values)
    window = 1
    while window < n and window < (1 << 20):
        window <<= 1
    out_len = np.zeros(n, dtype=np.uint32)
    out_sym = np.zeros(n, dtype=np.uint32)
    rc = lib.jxlt_lz77_parse(
        values.ctypes.data, n, sym_cost.ctypes.data,
        add_cost.ctypes.data, min_length, window,
        special_dists.ctypes.data if len(special_dists) else None,
        len(special_dists), out_len.ctypes.data, out_sym.ctypes.data)
    if rc < 0:
        return None
    return out_len, out_sym


def tokenize_dct8(qp: np.ndarray, order: np.ndarray,
                  block_ctx: np.ndarray, histo_off: np.ndarray,
                  num_ctxs: int, knz: np.ndarray, kfr: np.ndarray
                  ) -> np.ndarray | None:
    """AC-group tokenizer for all-DCT8 groups (DecodeACVarBlock mirror,
    enc_entropy_coder.cc:153): returns an (N, 2) int64 (context, value)
    token array or None when native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "jxlt_tokenize_dct8_bound"):
        lib.jxlt_tokenize_dct8.restype = ctypes.c_int64
        lib.jxlt_tokenize_dct8.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.jxlt_tokenize_dct8_bound = True
    qp = np.ascontiguousarray(qp, dtype=np.int32)
    gh, gw = qp.shape[:2]
    order = np.ascontiguousarray(order, dtype=np.int32)
    block_ctx = np.ascontiguousarray(block_ctx, dtype=np.int32)
    histo_off = np.ascontiguousarray(histo_off, dtype=np.int32)
    knz = np.ascontiguousarray(knz, dtype=np.int32)
    kfr = np.ascontiguousarray(kfr, dtype=np.int32)
    cap = gh * gw * 3 * 64
    out_ctx = np.empty(cap, np.int32)
    out_val = np.empty(cap, np.int32)
    n = lib.jxlt_tokenize_dct8(
        qp.ctypes.data, gh, gw, order.ctypes.data, block_ctx.ctypes.data,
        histo_off.ctypes.data, num_ctxs, knz.ctypes.data, kfr.ctypes.data,
        out_ctx.ctypes.data, out_val.ctypes.data)
    if n < 0:
        return None
    out = np.empty((n, 2), np.int64)
    out[:, 0] = out_ctx[:n]
    out[:, 1] = out_val[:n]
    return out


def modular_generic_decode(data, start_bit: int, state: int, code,
                           tree, plane: np.ndarray, refs,
                           chan_idx: int, group_id: int, use_wp: bool,
                           wp_header, reader=None
                           ) -> tuple[int, int] | None:
    """General modular channel decode (DecodeModularChannelMAANS) in
    native code: per-pixel MA-tree context + rANS + hybrid-uint +
    all predictors incl. WP. ``code`` is the decoded ANSCode (no
    prefix/LZ77 — caller gates), ``tree`` the node list, ``plane`` an
    (h, w) int32 output buffer, ``refs`` an optional
    (n_ref_props, h, w) int32 array of reference properties.
    Returns (end_bit, state) or None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "jxlt_modular_generic_decode_bound"):
        lib.jxlt_modular_generic_decode.restype = ctypes.c_int64
        lib.jxlt_modular_generic_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.jxlt_modular_generic_decode_bound = True
    flat = getattr(code, "_native_flat", None)
    if flat is None:
        nhist = len(code.alias_freqs)
        a_sym = np.ascontiguousarray(
            np.stack([np.asarray(s, np.int32)
                      for s in code.alias_symbols]))
        a_off = np.ascontiguousarray(
            np.stack([np.asarray(s, np.int32)
                      for s in code.alias_offsets]))
        freqs_off = np.zeros(nhist + 1, np.int64)
        freqs_off[1:] = np.cumsum([len(f) for f in code.alias_freqs])
        freqs_flat = np.ascontiguousarray(np.concatenate(
            [np.asarray(f, np.int32) for f in code.alias_freqs]))
        cmap = np.ascontiguousarray(np.asarray(code.context_map, np.int32))
        cfg_se = np.array([c.split_exponent for c in code.uint_configs],
                          np.int32)
        cfg_msb = np.array([c.msb_in_token for c in code.uint_configs],
                           np.int32)
        cfg_lsb = np.array([c.lsb_in_token for c in code.uint_configs],
                           np.int32)
        flat = (a_sym, a_off, freqs_off, freqs_flat, cmap,
                cfg_se, cfg_msb, cfg_lsb)
        code._native_flat = flat
    a_sym, a_off, freqs_off, freqs_flat, cmap, cfg_se, cfg_msb, \
        cfg_lsb = flat
    tcache = getattr(code, "_native_tree", None)
    if tcache is not None and tcache[0] is tree:
        tarr = tcache[1]
    else:
        tarr = np.zeros((len(tree), 8), np.int32)
        for i, n in enumerate(tree):
            tarr[i] = (n.property, n.splitval, n.lchild, n.rchild,
                       n.context, n.predictor, n.predictor_offset,
                       n.multiplier)
        tarr = np.ascontiguousarray(tarr)
        code._native_tree = (tree, tarr)
    buf = np.frombuffer(data, dtype=np.uint8)
    h, w = plane.shape
    st = np.array([state], np.uint32)
    if refs is None:
        refs_arr = None
        n_ref = 0
    else:
        refs_arr = np.ascontiguousarray(refs, np.int32)
        n_ref = refs_arr.shape[0]
    hdr = np.array([wp_header.p1C, wp_header.p2C, wp_header.p3Ca,
                    wp_header.p3Cb, wp_header.p3Cc, wp_header.p3Cd,
                    wp_header.p3Ce] + list(wp_header.w), np.int32)
    lz_enabled = bool(reader is not None and reader.lz77_enabled)
    if lz_enabled:
        lz = code.lz77
        if not reader.window.flags["C_CONTIGUOUS"] or \
                reader.window.dtype != np.uint32:
            return None
        lz_window = reader.window
        lz_state = np.array([reader.num_decoded, reader.copy_pos,
                             reader.num_to_copy], np.int64)
        special = np.ascontiguousarray(
            np.asarray(reader.special, np.int32)) \
            if reader.num_special else np.zeros(0, np.int32)
        lcfg = lz.length_uint_config
        lz_args = (1, int(lz.min_symbol), int(lz.min_length),
                   int(lcfg.split_exponent), int(lcfg.msb_in_token),
                   int(lcfg.lsb_in_token), int(lz.distance_context),
                   special.ctypes.data if len(special) else None,
                   len(special), lz_window.ctypes.data,
                   lz_state.ctypes.data)
    else:
        lz_state = None
        lz_args = (0, 0, 0, 0, 0, 0, 0, None, 0, None, None)
    end = lib.jxlt_modular_generic_decode(
        buf.ctypes.data, len(buf), start_bit, st.ctypes.data,
        a_sym.ctypes.data, a_off.ctypes.data, freqs_flat.ctypes.data,
        freqs_off.ctypes.data, cmap.ctypes.data, len(cmap),
        cfg_se.ctypes.data, cfg_msb.ctypes.data, cfg_lsb.ctypes.data,
        tarr.ctypes.data, len(tree),
        plane.ctypes.data, w, h,
        refs_arr.ctypes.data if refs_arr is not None else None, n_ref,
        chan_idx, group_id, 1 if use_wp else 0, hdr.ctypes.data,
        *lz_args)
    if end < 0:
        return None
    if lz_enabled:
        reader.num_decoded = int(lz_state[0])
        reader.copy_pos = int(lz_state[1])
        reader.num_to_copy = int(lz_state[2])
    return int(end), int(st[0])


_DEC_HIST_BOUND = False


def decode_histograms_native(data, start_bit: int, num_contexts: int,
                             disallow_lz77: bool):
    """One-call DecodeHistograms (native/jxl_host.cc
    jxlt_decode_histograms): returns (end_bit, lz77_arr, ctx_map,
    num_histograms, log_alpha, uint_cfgs, counts, alpha_sizes) or None
    when the stream needs the Python path (prefix codes, nested LZ77)
    or the native module is unavailable."""
    global _DEC_HIST_BOUND
    if not available():
        return None
    import ctypes

    lib = get_lib()
    if not _DEC_HIST_BOUND:
        lib.jxlt_decode_histograms.restype = ctypes.c_int64
        lib.jxlt_decode_histograms.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32] + [ctypes.c_void_p] * 6
        _DEC_HIST_BOUND = True
    buf = np.frombuffer(data, np.uint8)
    lz77 = np.zeros(7, np.int32)
    ctx_map = np.zeros(num_contexts + 1, np.int32)
    info = np.zeros(2, np.int32)
    cfgs = np.zeros(3 * 256, np.int32)
    counts = np.empty(320 * 256, np.int32)
    alphas = np.zeros(256, np.int32)
    end = lib.jxlt_decode_histograms(
        buf.ctypes.data, buf.size, start_bit, num_contexts,
        1 if disallow_lz77 else 0, lz77.ctypes.data, ctx_map.ctypes.data,
        info.ctypes.data, cfgs.ctypes.data, counts.ctypes.data,
        alphas.ctypes.data)
    if end < 0:
        return None
    return (end, lz77, ctx_map, int(info[0]), int(info[1]), cfgs,
            counts, alphas)


_DEC_TREE_BOUND = False


def decode_tree_native(data, start_bit: int, max_nodes: int):
    """Full MA-tree decode (jxlt_decode_tree): histogram set + node
    stream in one call. Returns (nodes (n,7) int32, end_bit) or None
    for the Python path."""
    global _DEC_TREE_BOUND
    if not available():
        return None
    import ctypes

    lib = get_lib()
    if not _DEC_TREE_BOUND:
        lib.jxlt_decode_tree.restype = ctypes.c_int64
        lib.jxlt_decode_tree.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p]
        _DEC_TREE_BOUND = True
    buf = np.frombuffer(data, np.uint8)
    cap = 1 << 12
    while True:
        nodes = np.empty((cap, 7), np.int32)
        end_bit = np.zeros(1, np.int64)
        n = lib.jxlt_decode_tree(buf.ctypes.data, buf.size, start_bit,
                                 max_nodes, nodes.ctypes.data, cap,
                                 end_bit.ctypes.data)
        if n == -3 and cap < (1 << 26):   # legal tree bigger than cap
            cap *= 16
            continue
        if n < 0:
            return None
        return nodes[:n], int(end_bit[0])


def tree_learn(tok_mat: np.ndarray, nb_mat: np.ndarray,
               props_mat: np.ndarray, max_leaves: int):
    """Native greedy MA-tree learner (enc_ma.cc ComputeBestTree class).

    tok_mat/nb_mat: (n_pred, N) int32 token ids / raw-bit counts per
    candidate predictor; props_mat: (n_props, N) int32 property values
    in split-prop order. Returns (prop_idx, splitval, child, pred_idx)
    int32 arrays in the decode BFS layout, or None.
    """
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "jxlt_tree_learn_bound"):
        lib.jxlt_tree_learn.restype = ctypes.c_int64
        lib.jxlt_tree_learn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.jxlt_tree_learn_bound = True
    tok_mat = np.ascontiguousarray(tok_mat, dtype=np.int32)
    nb_mat = np.ascontiguousarray(nb_mat, dtype=np.int32)
    props_mat = np.ascontiguousarray(props_mat, dtype=np.int32)
    n_pred, n = tok_mat.shape
    n_props = props_mat.shape[0]
    alphabet = int(tok_mat.max()) + 1 if n else 1
    cap = 4 * max_leaves + 2
    out_prop = np.empty(cap, np.int32)
    out_sval = np.empty(cap, np.int32)
    out_child = np.empty(cap, np.int32)
    out_pred = np.empty(cap, np.int32)
    cnt = lib.jxlt_tree_learn(
        tok_mat.ctypes.data, nb_mat.ctypes.data, props_mat.ctypes.data,
        n, n_pred, n_props, alphabet, max_leaves,
        out_prop.ctypes.data, out_sval.ctypes.data,
        out_child.ctypes.data, out_pred.ctypes.data)
    if cnt < 0:
        return None
    return (out_prop[:cnt], out_sval[:cnt], out_child[:cnt],
            out_pred[:cnt])


def entropy_tail(token_arrays, num_contexts: int, max_clusters: int,
                 histo_shift: int, uint_search: bool):
    """One-call no-LZ77 entropy-encode tail (jxlt_entropy_tail):
    clustering + histogram serialization + context map + optional
    uint-config search + per-group rANS emission.

    token_arrays: list of (N, 2) int64 (ctx, value) arrays, one per
    group. Returns (hdr_bytes, hdr_bitlen, [(bytes, bitlen)] per group)
    or None (unavailable/overflow — caller falls back to Python).
    """
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "jxlt_entropy_tail_bound"):
        lib.jxlt_entropy_tail.restype = ctypes.c_int64
        lib.jxlt_entropy_tail.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.jxlt_entropy_tail_bound = True
    n_groups = len(token_arrays)
    if n_groups == 0:
        return None
    offs = np.zeros(n_groups + 1, np.int64)
    for i, a in enumerate(token_arrays):
        offs[i + 1] = offs[i] + len(a)
    total = int(offs[-1])
    flat = np.empty((total, 2), np.int64)
    for i, a in enumerate(token_arrays):
        if len(a):
            flat[offs[i]:offs[i + 1]] = a
    max_n = int((offs[1:] - offs[:-1]).max()) if n_groups else 0
    stride = 64 + 8 * max_n
    hdr_cap = 1 << 17
    hdr = np.zeros(hdr_cap, np.uint8)
    hdr_bits = np.zeros(1, np.int64)
    grp = np.zeros(n_groups * stride, np.uint8)
    grp_bits = np.zeros(n_groups, np.int64)
    rc = lib.jxlt_entropy_tail(
        flat.ctypes.data, total, offs.ctypes.data, n_groups,
        num_contexts, max_clusters, histo_shift,
        1 if uint_search else 0,
        hdr.ctypes.data, hdr_cap, hdr_bits.ctypes.data,
        grp.ctypes.data, stride, grp_bits.ctypes.data)
    if rc < 0:
        return None
    nb = int(hdr_bits[0])
    out_groups = []
    for g in range(n_groups):
        b = int(grp_bits[g])
        out_groups.append((grp[g * stride:g * stride + (b + 7) // 8]
                           .tobytes(), b))
    return hdr[:(nb + 7) // 8].tobytes(), nb, out_groups
