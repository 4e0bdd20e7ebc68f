"""Prefix-pack chunks of hybrid-uint tokens: the CUDA kernel's wrapper and
its plain PyTorch version (port of ``libjxl_tpu/models/pack_kernel.py``).

Contract, shared with the TPU kernel: ``v`` holds (Cn, 128) residuals as
uint32 bit patterns in an int32 tensor; -1 (0xFFFFFFFF) marks an invalid
position, which emits a 0-bit token. ``lut_comb`` is the (96,) int32
table ``(code_len << 16) | code_bits``. The result is (buf, chunk_bits):
buf (Cn, 128) int32 holding each chunk's LSB-first uint32 words, and
chunk_bits (Cn,) int32, each chunk's exact bit count. Real residuals are
below 2^20 (16-bit images pack below 2^19), so no token reaches 96.

The kernel itself is ``libjxl_torch/csrc/pack_kernel.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from libjxl_torch.ops.modular_ops import hybrid_uint_tokenize

T = 128          # tokens per chunk (PACK_T)
NWP = 128        # words per chunk buffer; a chunk uses at most 124
ALPHABET = 96
SENTINEL = -1    # 0xFFFFFFFF as int32


def _check(v: torch.Tensor, lut_comb: torch.Tensor) -> None:
    if v.dtype != torch.int32 or v.dim() != 2 or v.shape[1] != T:
        raise ValueError(f"v must be (Cn, {T}) int32, got "
                         f"{tuple(v.shape)} {v.dtype}")
    if lut_comb.dtype != torch.int32 or tuple(lut_comb.shape) != (ALPHABET,):
        raise ValueError(f"lut_comb must be ({ALPHABET},) int32, got "
                         f"{tuple(lut_comb.shape)} {lut_comb.dtype}")
    if v.device != lut_comb.device:
        raise ValueError("v and lut_comb lie on different devices")
    if not (v.is_contiguous() and lut_comb.is_contiguous()):
        raise ValueError("v and lut_comb must be contiguous")


def pack_chunks(v: torch.Tensor, lut_comb: torch.Tensor):
    """Pack (Cn, 128) residual chunks; see the module docstring.

    A CUDA tensor launches the kernel on the current stream (or raises);
    a CPU tensor runs ``pack_chunks_ref``. ``pack_chunks.launches`` counts
    kernel launches."""
    _check(v, lut_comb)
    if v.device.type == "cpu":
        return pack_chunks_ref(v, lut_comb)
    if v.device.type != "cuda":
        raise ValueError(f"no pack kernel for device {v.device}")
    if v.data_ptr() % 16:
        raise ValueError("v must be 16-byte aligned (one uint4 per lane)")
    from libjxl_torch.utils.cuda_build import load
    lib = load("pack_kernel")
    fn = lib.jxlt_pack_chunks
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                           ctypes.c_void_p]
    cn = v.shape[0]
    buf = torch.empty((cn, NWP), dtype=torch.int32, device=v.device)
    chunk_bits = torch.empty(cn, dtype=torch.int32, device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = fn(v.data_ptr(), lut_comb.data_ptr(), buf.data_ptr(),
                 chunk_bits.data_ptr(), cn, stream)
    if err:
        raise RuntimeError(f"pack kernel launch failed: CUDA error {err}")
    pack_chunks.launches += 1
    return buf, chunk_bits


pack_chunks.launches = 0


def pack_chunks_ref(v: torch.Tensor, lut_comb: torch.Tensor):
    """Plain PyTorch version of the kernel, in int64 on any device.
    Pieces are inserted with ``scatter_add_``: on bit-disjoint pieces a
    sum equals an OR."""
    x = v.to(torch.int64) & 0xFFFFFFFF
    invalid = x == 0xFFFFFFFF
    token, nbits, raw = hybrid_uint_tokenize(torch.where(invalid, 0, x))
    token = token.to(torch.int64)
    lut = lut_comb.to(torch.int64)
    e = torch.where(token < ALPHABET, lut[token.clamp(max=ALPHABET - 1)], 0)
    clen = e >> 16
    cbits = e & 0xFFFF
    shifted = torch.where(clen < 32, raw << clen.clamp(0, 31), 0)
    comb = torch.where(invalid, 0, (cbits | shifted) & 0xFFFFFFFF)
    lens = torch.where(invalid, 0, clen + nbits)

    off = torch.cumsum(lens, dim=1) - lens
    wt = off >> 5
    b = off & 31
    lo = (comb << b) & 0xFFFFFFFF
    hi = torch.where(b == 0, 0, comb >> (32 - b))
    # pieces past the buffer go to a spare column that is dropped
    buf = torch.zeros((v.shape[0], NWP + 1), dtype=torch.int64,
                      device=v.device)
    buf.scatter_add_(1, wt.clamp(max=NWP), lo)
    buf.scatter_add_(1, (wt + 1).clamp(max=NWP), hi)
    buf = buf[:, :NWP]
    buf = torch.where(buf >= 1 << 31, buf - (1 << 32), buf).to(torch.int32)
    chunk_bits = (off[:, -1] + lens[:, -1]).to(torch.int32)
    return buf, chunk_bits
