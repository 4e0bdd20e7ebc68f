"""Coefficient order decoding (reference ``lib/jxl/coeff_order.cc``)."""

from __future__ import annotations

import numpy as np

from jxlbench.ref.jxl.core.fields import Bits, BitsOffset, U32Enc, Val, read_u32
from jxlbench.ref.jxl.entropy.ans import ANSSymbolReader, decode_histograms
from jxlbench.ref.jxl.entropy.permutation import (
    K_PERMUTATION_CONTEXTS, read_permutation_tokens,
)
from jxlbench.ref.jxl.utils.bits import BitReader
from jxlbench.ref.jxl.vardct.ac_strategy import (
    COVERED_X, COVERED_Y, NUM_STRATEGIES, STRATEGY_ORDER, natural_order,
)

NUM_ORDERS = 13
K_ORDER_ENC = U32Enc(Val(0x5F), Val(0x13), Val(0), Bits(13))


def read_used_orders(r: BitReader) -> int:
    return read_u32(r, K_ORDER_ENC)


def decode_coeff_orders(r: BitReader, used_orders: int, used_acs: int):
    """Returns dict: (order_bucket, channel) -> order array
    (coeff_order.cc:110-170)."""
    orders = {}
    reader = None
    code = None
    if used_orders != 0:
        code = decode_histograms(r, K_PERMUTATION_CONTEXTS)
        reader = ANSSymbolReader(code, r)
    acs_mask = 0
    for o in range(NUM_STRATEGIES):
        if used_acs & (1 << o):
            acs_mask |= 1 << STRATEGY_ORDER[o]
    computed = 0
    for o in range(NUM_STRATEGIES):
        ord_ = STRATEGY_ORDER[o]
        if computed & (1 << ord_):
            continue
        computed |= 1 << ord_
        used = (acs_mask & (1 << ord_)) != 0
        llf = COVERED_X[o] * COVERED_Y[o]
        size = 64 * llf
        nat = natural_order(o)
        if (used_orders & (1 << ord_)) == 0:
            if used:
                for c in range(3):
                    orders[(ord_, c)] = nat.copy()
        else:
            for c in range(3):
                perm = read_permutation_tokens(r, reader, size, skip=llf)
                if used:
                    orders[(ord_, c)] = nat[perm]
    if reader is not None and not reader.check_final_state():
        from jxlbench.ref.jxl.core.fields import FormatError
        raise FormatError("invalid coeff order ANS state")
    return orders


# ---- encoder side ---------------------------------------------------------

def compute_custom_orders(zero_counts: dict) -> tuple:
    """Custom scan orders from per-position zero counts
    (enc_coeff_order.cc ComputeCoeffOrder:66-200, channel-shared).

    ``zero_counts``: {order_bucket: int64 (size,) array of zero counts
    per STORED-layout position, summed over channels; LLF positions may
    be any value (forced first here)}. Returns (used_orders_mask,
    {bucket: order}, {bucket: perm}) with identity permutations dropped
    from the mask (the reference signals them anyway; dropping saves
    the tokens and decodes identically). Buckets > 6 (blocks above
    32x32) are never customized, matching ComputeUsedOrders:54-58."""
    orders: dict = {}
    perms: dict = {}
    used = 0
    for o in range(NUM_STRATEGIES):
        ordb = STRATEGY_ORDER[o]
        if ordb in orders or ordb > 6 or ordb not in zero_counts:
            continue
        nat = natural_order(o)
        sz = len(nat)
        llf = COVERED_X[o] * COVERED_Y[o]
        cnt = zero_counts[ordb][nat].astype(np.float64)
        cnt[:llf] = -1.0
        q = np.maximum(np.floor(cnt / np.sqrt(sz) + 0.1), 0).astype(
            np.int64)
        perm = np.argsort(q, kind="stable")
        if np.array_equal(perm, np.arange(sz)):
            continue
        orders[ordb] = nat[perm]
        perms[ordb] = perm
        used |= 1 << ordb
    return used, orders, perms


def encode_coeff_orders(w, used_orders: int, perms: dict) -> None:
    """used_orders U32 + Lehmer-coded permutations, one shared histogram
    set, in the exact bucket/channel order the decoder reads
    (decode_coeff_orders; enc_coeff_order.cc EncodeCoeffOrders).
    The same (channel-shared) permutation is written for all three
    channels of a bucket."""
    from jxlbench.ref.jxl.core.fields import write_u32
    from jxlbench.ref.jxl.entropy.ans import (
        build_entropy_codes, write_entropy_codes, write_tokens,
    )
    from jxlbench.ref.jxl.entropy.permutation import (
        coeff_order_context, encode_lehmer,
    )

    write_u32(w, K_ORDER_ENC, used_orders)
    if not used_orders:
        return
    toks: list = []
    computed = 0
    for o in range(NUM_STRATEGIES):
        ordb = STRATEGY_ORDER[o]
        if computed & (1 << ordb):
            continue
        computed |= 1 << ordb
        if not (used_orders & (1 << ordb)):
            continue
        perm = np.asarray(perms[ordb])
        size = len(perm)
        llf = COVERED_X[o] * COVERED_Y[o]
        lehmer = encode_lehmer(perm)
        end = size
        while end > llf and lehmer[end - 1] == 0:
            end -= 1
        for _c in range(3):
            toks.append((coeff_order_context(size), end - llf))
            last = 0
            for i in range(llf, end):
                toks.append((coeff_order_context(last), int(lehmer[i])))
                last = int(lehmer[i])
    arr = np.array(toks, dtype=np.int64).reshape(-1, 2)
    codes = build_entropy_codes([arr], K_PERMUTATION_CONTEXTS)
    write_entropy_codes(w, codes)
    write_tokens(w, arr, codes)
