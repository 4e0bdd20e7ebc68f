"""Brotli via the system shared libraries (ctypes).

Used for the jbrd (JPEG reconstruction) payload and brob boxes — matching
the reference's use of the brotli library (third_party/brotli)."""

from __future__ import annotations

import ctypes
import ctypes.util

_enc = None
_dec = None


def _load():
    global _enc, _dec
    if _enc is not None:
        return
    for name in ("libbrotlienc.so.1", "libbrotlienc.so"):
        try:
            _enc = ctypes.CDLL(name)
            break
        except OSError:
            continue
    for name in ("libbrotlidec.so.1", "libbrotlidec.so"):
        try:
            _dec = ctypes.CDLL(name)
            break
        except OSError:
            continue
    if _enc is not None:
        _enc.BrotliEncoderCompress.restype = ctypes.c_int
        _enc.BrotliEncoderMaxCompressedSize.restype = ctypes.c_size_t
    if _dec is not None:
        _dec.BrotliDecoderDecompress.restype = ctypes.c_int


def available() -> bool:
    _load()
    return _enc is not None and _dec is not None


_default_quality = 9


def set_default_quality(q: int) -> None:
    """cjxl --brotli_effort (0-11): quality for brotli-coded payloads
    (jbrd JPEG metadata, compressed ICC)."""
    global _default_quality
    _default_quality = max(0, min(11, int(q)))


def compress(data: bytes, quality: int | None = None) -> bytes:
    if quality is None:
        quality = _default_quality
    _load()
    if _enc is None:
        raise RuntimeError("brotli encoder unavailable")
    cap = _enc.BrotliEncoderMaxCompressedSize(len(data)) or len(data) + 1024
    out = ctypes.create_string_buffer(cap)
    out_len = ctypes.c_size_t(cap)
    ok = _enc.BrotliEncoderCompress(
        quality, 22, 0, len(data), data, ctypes.byref(out_len), out)
    if not ok:
        raise RuntimeError("brotli compression failed")
    return out.raw[:out_len.value]


def decompress(data: bytes, max_size: int = 1 << 30) -> bytes:
    _load()
    if _dec is None:
        raise RuntimeError("brotli decoder unavailable")
    size = max(len(data) * 8, 1 << 16)
    while size <= max_size:
        out = ctypes.create_string_buffer(size)
        out_len = ctypes.c_size_t(size)
        res = _dec.BrotliDecoderDecompress(len(data), data,
                                           ctypes.byref(out_len), out)
        if res == 1:  # BROTLI_DECODER_RESULT_SUCCESS
            return out.raw[:out_len.value]
        size *= 4
    raise RuntimeError("brotli decompression failed")
