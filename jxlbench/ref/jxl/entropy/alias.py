"""ANS alias table — the spec-defined mapping [0,4096) -> (symbol, offset).

Construction must match the reference exactly (``lib/jxl/ans_common.cc:16-117``)
because the encoder's slot assignment and the decoder's lookup both derive
from it.
"""

from __future__ import annotations

import numpy as np

from jxlbench.ref.jxl.core.fields import FormatError
from jxlbench.ref.jxl.entropy.histogram import ANS_LOG_TAB_SIZE, ANS_TAB_SIZE


def build_alias_table(counts, log_alpha_size: int):
    """Returns per-slot arrays over the full [0, ANS_TAB_SIZE) range:

    ``symbol[v]``  — decoded symbol for slot value v
    ``offset[v]``  — occurrence index of that symbol at v
    ``freq[s]``    — count of symbol s (padded to table size)

    plus the inverse ``slot[symbol_start + offset] -> v`` mapping used by the
    encoder, as (cum_freq, slots) arrays.

    Hot in the decode host stage (one table per clustered histogram per
    stream); dispatches to the native builder when available.
    """
    from jxlbench.ref.jxl.utils import native
    if native.available():
        res = native.build_alias_table(np.asarray(counts, np.int32),
                                       log_alpha_size)
        if res is not None:
            return res
    table_size = 1 << log_alpha_size
    entry_size = ANS_TAB_SIZE >> log_alpha_size
    log_entry_size = ANS_LOG_TAB_SIZE - log_alpha_size
    dist = list(counts)
    while dist and dist[-1] == 0:
        dist.pop()
    if not dist:
        dist = [ANS_TAB_SIZE]
    if len(dist) > table_size:
        raise FormatError("alphabet too large for alias table")
    if sum(dist) != ANS_TAB_SIZE:
        raise FormatError("counts must sum to ANS_TAB_SIZE")

    cutoff = np.zeros(table_size, dtype=np.int64)
    right_value = np.zeros(table_size, dtype=np.int64)
    offsets1 = np.zeros(table_size, dtype=np.int64)

    single = None
    for sym, v in enumerate(dist):
        if v == ANS_TAB_SIZE:
            single = sym
    if single is not None:
        sym_arr = np.full(ANS_TAB_SIZE, single, dtype=np.int32)
        off_arr = np.arange(ANS_TAB_SIZE, dtype=np.int32)
        freqs = np.zeros(table_size, dtype=np.int32)
        freqs[:len(dist)] = dist
        return sym_arr, off_arr, freqs

    cutoffs = np.zeros(table_size, dtype=np.int64)
    underfull: list[int] = []
    overfull: list[int] = []
    for i, v in enumerate(dist):
        cutoffs[i] = v
        if v > entry_size:
            overfull.append(i)
        elif v < entry_size:
            underfull.append(i)
    for i in range(len(dist), table_size):
        cutoffs[i] = 0
        underfull.append(i)
    while overfull:
        oi = overfull.pop()
        if not underfull:
            raise FormatError("alias table construction failed")
        ui = underfull.pop()
        by = entry_size - cutoffs[ui]
        cutoffs[oi] -= by
        right_value[ui] = oi
        offsets1[ui] = cutoffs[oi]
        if cutoffs[oi] < entry_size:
            underfull.append(oi)
        elif cutoffs[oi] > entry_size:
            overfull.append(oi)
    for i in range(table_size):
        if cutoffs[i] == entry_size:
            right_value[i] = i
            offsets1[i] = 0
            cutoff[i] = 0
        else:
            offsets1[i] -= cutoffs[i]
            cutoff[i] = cutoffs[i]

    # Expand to full per-slot arrays (vectorized decode + encoder inverse).
    v = np.arange(ANS_TAB_SIZE, dtype=np.int64)
    i = v >> log_entry_size
    pos = v & (entry_size - 1)
    greater = pos >= cutoff[i]
    sym_arr = np.where(greater, right_value[i], i).astype(np.int32)
    off_arr = np.where(greater, offsets1[i] + pos, pos).astype(np.int32)
    freqs = np.zeros(table_size, dtype=np.int32)
    freqs[:len(dist)] = dist
    return sym_arr, off_arr, freqs


def build_encoder_slots(counts, log_alpha_size: int):
    """Inverse mapping: for each symbol s and offset o in [0, freq[s]),
    the slot value v with symbol[v]==s, offset[v]==o.

    Returns (start, slots): slots is a flat array indexed by
    ``start[s] + o``.
    """
    sym_arr, off_arr, freqs = build_alias_table(counts, log_alpha_size)
    start = np.zeros(len(freqs) + 1, dtype=np.int64)
    np.cumsum(freqs, out=start[1:])
    slots = np.zeros(ANS_TAB_SIZE, dtype=np.int32)
    slots[start[sym_arr] + off_arr] = np.arange(ANS_TAB_SIZE, dtype=np.int32)
    return start, slots
