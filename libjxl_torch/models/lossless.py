"""Lossless Modular encode on the device (port of
``libjxl_tpu/models/lossless.py``).

The device computes everything pixel-shaped over the ``(groups,
channels, gd, gd)`` layout: YCoCg RCT, clamped-gradient residuals,
``pack_signed``, token ids and the 256-bin token histogram; for the
prefix path it also packs the entropy-coded words with the CUDA pack
kernel (``models/pack_kernel.py``) and compacts them into one dense
stream. The host builds the codes and splices the words into sections.

Residuals are int32 tensors here (uint32 in the reference); every output
that reaches the host is byte-identical to the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from libjxl_torch.config import resolve_device
from libjxl_torch.models.pack_kernel import SENTINEL, pack_chunks
from libjxl_torch.ops.modular_ops import (
    fwd_ycocg, gradient_residuals, hybrid_uint_tokenize, pack_signed,
    token_histogram,
)

PACK_T = 128          # tokens per packed chunk
PACK_NW = 128         # word capacity per chunk (a chunk uses at most 124)
PACK_ROW = 8          # compaction row: chunks start 8-word aligned in
                      # the dense stream (the host splice drops the slack)


def frame_groups_host(img: np.ndarray, group_dim: int):
    """(H, W, C) -> (G, C, gd, gd) uint8/uint16 groups + bool mask (numpy)."""
    h, w, c = img.shape
    gy = -(-h // group_dim)
    gx = -(-w // group_dim)
    ph, pw = gy * group_dim, gx * group_dim
    imgp = np.pad(img, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    groups = imgp.reshape(gy, group_dim, gx, group_dim, c)
    groups = groups.transpose(0, 2, 4, 1, 3).reshape(
        gy * gx, c, group_dim, group_dim)
    yy = np.arange(ph).reshape(gy, group_dim)
    xx = np.arange(pw).reshape(gx, group_dim)
    mask = (yy[:, None, :, None] < h) & (xx[None, :, None, :] < w)
    mask = mask.reshape(gy * gx, 1, group_dim, group_dim)
    return np.ascontiguousarray(groups), mask


def upload_groups(groups: np.ndarray, device) -> torch.Tensor:
    """Host uint8/uint16 groups onto ``device``, still narrow (the int32
    widening happens on the device)."""
    return torch.from_numpy(groups).to(resolve_device(device))


def _group_mask(ng: int, gd: int, h: int, w: int, gx: int,
                per_image: int, device, g0: int = 0) -> torch.Tensor:
    """(G, 1, gd, gd) validity of each group pixel of groups ``g0`` to
    ``g0 + G``; groups of a stacked batch repeat every ``per_image``
    groups (0 = one image)."""
    gi = torch.arange(g0, g0 + ng, device=device)
    if per_image:
        gi = gi % per_image
    row0 = (gi // gx) * gd
    col0 = (gi % gx) * gd
    ar = torch.arange(gd, device=device)
    ymask = row0[:, None] + ar[None, :] < h
    xmask = col0[:, None] + ar[None, :] < w
    return ymask[:, None, :, None] & xmask[:, None, None, :]


def _packed_residuals(groups: torch.Tensor, use_rct: bool = True
                      ) -> torch.Tensor:
    """RCT (3+ channels) + clamped-gradient residuals + pack_signed."""
    groups = groups.to(torch.int32)
    if use_rct and groups.shape[1] >= 3:
        groups = torch.cat([fwd_ycocg(groups[:, :3]), groups[:, 3:]], dim=1)
    return pack_signed(gradient_residuals(groups))


def _token_id(packed: torch.Tensor) -> torch.Tensor:
    """Hybrid-uint (4, 2, 0) token of packed residuals (int32)."""
    return hybrid_uint_tokenize(packed)[0]


def _u32_bytes(x: torch.Tensor) -> torch.Tensor:
    """Little-endian uint32 bytes of non-negative int values below 2^31."""
    return x.to(torch.int32).contiguous().view(torch.uint8)


def _probe_payload(packed: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """uint32 per-group maxes + 256-bin token histogram, as bytes: the
    layout ``libjxl_tpu.api.encoder._prefix_code_state`` reads."""
    hist = token_histogram(_token_id(packed), mask)
    gmax = torch.where(mask, packed, 0).amax(dim=(1, 2, 3))
    return torch.cat([_u32_bytes(gmax), _u32_bytes(hist)])


def encode_groups_device(groups: torch.Tensor, h: int, w: int, gx: int = 1,
                         use_rct: bool = True):
    """Device side of the ANS lossless encode.

    groups: (G, C, gd, gd) integer pixels of one image. Returns
    (payload, wide): payload is uint8 bytes of the residual planes clamped
    to 255, then uint32 per-group maxes and the 256-bin histogram; wide is
    the int32 packed residuals, read for the groups whose max reaches
    255."""
    ng, _, gd, _ = groups.shape
    mask = _group_mask(ng, gd, h, w, gx, 0, groups.device)
    packed = _packed_residuals(groups, use_rct)
    planes = packed.clamp(max=255).to(torch.uint8).reshape(-1)
    return torch.cat([planes, _probe_payload(packed, mask)]), packed


def encode_image_device(img: np.ndarray, group_dim: int = 256,
                        use_rct: bool = True, device=None):
    """(H, W, C) -> (per-group packed residual arrays, mask, histogram).
    A group is uint8 when its residuals fit, else uint32."""
    return encode_image_device_collect(
        encode_image_device_dispatch(img, group_dim, use_rct, device))


def encode_image_device_dispatch(img: np.ndarray, group_dim: int = 256,
                                 use_rct: bool = True, device=None):
    """Enqueue the device work of one image; returns a handle for
    ``encode_image_device_collect``."""
    groups, mask = frame_groups_host(img, group_dim)
    h, w = img.shape[:2]
    payload, wide = encode_groups_device(
        upload_groups(groups, device), h, w, gx=-(-w // group_dim),
        use_rct=use_rct)
    return payload, wide, mask, groups.shape


def encode_image_device_collect(dev):
    """Fetch a dispatched image's payload and split it."""
    payload, wide, mask, gshape = dev
    ng, nch, gd, _ = gshape
    buf = payload.cpu().numpy()
    psize = ng * nch * gd * gd
    packed8 = buf[:psize].reshape(ng, nch, gd, gd)
    gmax = buf[psize:psize + 4 * ng].view(np.uint32)
    hist = buf[psize + 4 * ng:].view(np.uint32).astype(np.int64)
    out = [wide[g].cpu().numpy().view(np.uint32) if gmax[g] >= 255
           else packed8[g] for g in range(ng)]
    return out, mask, hist


def lossless_tokens_device(groups: torch.Tensor, h: int, w: int,
                           gx: int = 1, per_image: int = 0, g0: int = 0):
    """Pass 1 of the two-pass encode: residuals + token histogram.

    groups: (G_total, C, gd, gd), possibly a batch of images stacked along
    the group axis (``per_image`` groups each; 0 = one image), or the
    shard of that stack that starts at group ``g0``. Returns (wide int32
    residuals, zero outside the image; valid mask broadcast to their
    shape; the probe payload of ``lossless_hist_device``)."""
    ng, _, gd, _ = groups.shape
    mask = _group_mask(ng, gd, h, w, gx, per_image, groups.device, g0)
    packed = _packed_residuals(groups)
    valid = torch.broadcast_to(mask, packed.shape)
    wide = torch.where(valid, packed, 0)
    return wide, valid, _probe_payload(packed, mask)


def lossless_hist_device(groups: torch.Tensor, h: int, w: int, gx: int = 1,
                         per_image: int = 0) -> torch.Tensor:
    """Histogram probe: the uint8 payload of per-group maxes + 256-bin
    token histogram, from which the host builds the prefix code."""
    ng, _, gd, _ = groups.shape
    mask = _group_mask(ng, gd, h, w, gx, per_image, groups.device)
    return _probe_payload(_packed_residuals(groups), mask)


def lossless_pack_fused(groups: torch.Tensor, h: int, w: int,
                        lut_comb: torch.Tensor, gx: int = 1,
                        per_image: int = 0):
    """RCT + residuals + tokens + prefix pack in one pass, when the prefix
    code is already known (the serving path reuses sub-batch 0's code).
    Returns (dense words, chunk_bits) as ``chunk_pack_device`` does."""
    ng, _, gd, _ = groups.shape
    mask = _group_mask(ng, gd, h, w, gx, per_image, groups.device)
    packed = _packed_residuals(groups)
    return chunk_pack_device(packed, mask, lut_comb)


def prefix_state_to_device(cst: dict, device=None) -> torch.Tensor:
    """The prefix code that ``libjxl_tpu.api.encoder`` builds on the host
    (``lut_bits`` uint32[256], ``lut_len`` int32[256]) as the pack
    kernel's (96,) int32 table ``(len << 16) | bits`` on ``device``."""
    lut_bits = np.asarray(cst["lut_bits"]).astype(np.int64)
    lut_len = np.asarray(cst["lut_len"]).astype(np.int64)
    comb = ((lut_len << 16) | lut_bits)[:96]
    comb = np.where(comb >= 1 << 31, comb - (1 << 32), comb)
    return torch.from_numpy(comb.astype(np.int32)).to(resolve_device(device))


def random_prefix_state(rng: np.random.Generator) -> dict:
    """A prefix-code state of the layout ``prefix_state_to_device`` reads,
    for checking the packers: the 96 kernel entries get lengths 1..15 and
    bits below 2^len (canonicity does not matter to packing)."""
    lens = rng.integers(1, 16, 96)
    bits = rng.integers(0, 1 << 30, 96) & ((1 << lens) - 1)
    cst = dict(lut_bits=np.zeros(256, np.uint32),
               lut_len=np.zeros(256, np.int32))
    cst["lut_bits"][:96] = bits
    cst["lut_len"][:96] = lens
    return cst


def chunk_pack_device(wide: torch.Tensor, valid: torch.Tensor,
                      lut_comb: torch.Tensor):
    """Entropy-code residuals into one dense LSB-first word stream.

    Each PACK_T-token chunk is packed into its own word buffer by the pack
    kernel, then the buffers are compacted row by row; chunks start
    PACK_ROW-word aligned and the host splices them bit-exactly from
    chunk_bits. Replaces WriteTokens (enc_ans.cc:1237) + emission.

    Returns (dense int32 words holding uint32 bit patterns, exactly as
    many as the chunks' rows; chunk_bits (Cn,) int32)."""
    v = torch.where(torch.broadcast_to(valid, wide.shape),
                    wide.to(torch.int32), SENTINEL).reshape(-1, PACK_T)
    buf, chunk_bits = pack_chunks(v, lut_comb)
    return _compact_rows8(buf, chunk_bits), chunk_bits


def _compact_rows8(buf: torch.Tensor, chunk_bits: torch.Tensor
                   ) -> torch.Tensor:
    """Compact per-chunk word buffers into one dense stream whose chunks
    start PACK_ROW-word aligned. Reads the dense length (one device sync)
    and returns exactly that many words."""
    rw = PACK_ROW
    rows = buf.reshape(-1, rw)
    rows_per_chunk = PACK_NW // rw
    nw8 = (chunk_bits.to(torch.int64) + rw * 32 - 1) >> 8
    total_rows = int(nw8.sum())
    wstart8 = torch.cumsum(nw8, 0) - nw8
    # A chunk of 0 rows starts where the next chunk does: the marks ADD,
    # so cumsum steps past it (an assignment would lose the count and
    # shift every later chunk). Starts at total_rows fall in a spare slot.
    marks = torch.zeros(total_rows + 1, dtype=torch.int64, device=buf.device)
    marks.index_add_(0, wstart8, torch.ones_like(wstart8))
    cid = torch.cumsum(marks[:total_rows], 0) - 1
    j = torch.arange(total_rows, device=buf.device)
    rsrc = cid * rows_per_chunk + (j - wstart8[cid])
    return rows[rsrc].reshape(-1)
