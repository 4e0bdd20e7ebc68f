"""Standalone compressed-ICC API (reference
``include/jxl/compressed_icc.h``, ``lib/extras/compressed_icc.cc``):
compress / decompress an ICC profile with the JPEG XL ICC codec
(ISO 18181 "Compressed representation of ICC profiles" — the same
order/predict/ANS pipeline used for in-stream profiles,
``color/icc.py``)."""

from __future__ import annotations

from libjxl_torch.utils.bits import BitReader, BitWriter


def icc_profile_encode(icc: bytes) -> bytes:
    """JxlICCProfileEncode: raw ICC -> compressed bytes."""
    from libjxl_torch.color.icc import write_encoded_icc

    w = BitWriter()
    write_encoded_icc(w, icc)
    w.zero_pad_to_byte()
    return w.to_bytes()


def icc_profile_decode(compressed: bytes) -> bytes:
    """JxlICCProfileDecode: compressed bytes -> raw ICC profile."""
    from libjxl_torch.color.icc import read_encoded_icc

    return read_encoded_icc(BitReader(compressed))
