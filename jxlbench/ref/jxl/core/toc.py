"""Table of contents: per-section byte sizes (reference ``lib/jxl/toc.{h,cc}``).

Section order for multi-group frames: DCGlobal, DCGroup[0..], ACGlobal,
then per-pass AC groups (``toc.h:31-41``). Single-group single-pass frames
use one combined entry.
"""

from __future__ import annotations

import numpy as np

from jxlbench.ref.jxl.core.fields import Bits, BitsOffset, U32Enc, read_u32, \
    write_u32, FormatError
from jxlbench.ref.jxl.utils.bits import BitReader, BitWriter

TOC_DIST = U32Enc(Bits(10), BitsOffset(14, 1024), BitsOffset(22, 17408),
                  BitsOffset(30, 4211712))


def num_toc_entries(num_groups: int, num_dc_groups: int,
                    num_passes: int) -> int:
    if num_groups == 1 and num_passes == 1:
        return 1
    return 2 + num_dc_groups + num_groups * num_passes


def ac_group_index(pass_idx: int, group: int, num_groups: int,
                   num_dc_groups: int) -> int:
    return 2 + num_dc_groups + pass_idx * num_groups + group


def read_toc(r: BitReader, toc_entries: int):
    """Returns (sizes, offsets, permutation_or_None); reader ends
    byte-aligned at the first section."""
    if toc_entries > 65536:
        raise FormatError("too many TOC entries")
    permutation = None
    if r.read(1) == 1:
        from jxlbench.ref.jxl.entropy.permutation import decode_permutation
        permutation = decode_permutation(r, toc_entries, skip=0)
    if not r.jump_to_byte_boundary():
        raise FormatError("TOC padding bits not zero")
    sizes = np.array([read_u32(r, TOC_DIST) for _ in range(toc_entries)],
                     dtype=np.int64)
    if not r.jump_to_byte_boundary():
        raise FormatError("TOC padding bits not zero")
    if r.overflow:
        raise FormatError("truncated TOC")
    offsets = np.concatenate(([0], np.cumsum(sizes)[:-1]))
    if permutation is not None:
        perm = np.asarray(permutation)
        offsets = offsets[perm]
        sizes = sizes[perm]
    return sizes, offsets, permutation


def write_toc(w: BitWriter, sizes) -> None:
    """Write a TOC without permutation; leaves writer byte-aligned."""
    w.write(1, 0)  # no permutation
    w.zero_pad_to_byte()
    for s in sizes:
        write_u32(w, TOC_DIST, int(s))
    w.zero_pad_to_byte()


def write_toc_permuted(w: BitWriter, sizes_file_order, perm) -> None:
    """Permuted TOC (streaming encode, enc_frame.cc:1867): sizes are in
    FILE order; ``perm[logical_section] = file_position`` so the decoder
    recovers the spec section order (read_toc applies sizes[perm])."""
    from jxlbench.ref.jxl.entropy.permutation import encode_permutation
    w.write(1, 1)
    encode_permutation(w, perm)
    w.zero_pad_to_byte()
    for s in sizes_file_order:
        write_u32(w, TOC_DIST, int(s))
    w.zero_pad_to_byte()
