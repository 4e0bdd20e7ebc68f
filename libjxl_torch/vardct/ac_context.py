"""AC token context modeling (reference ``lib/jxl/ac_context.h``,
``lib/jxl/entropy_coder.cc``)."""

from __future__ import annotations

import numpy as np

from libjxl_torch.core.fields import (
    Bits, BitsOffset, FormatError, U32Enc, read_u32,
)
from libjxl_torch.core.headers import unpack_signed
from libjxl_torch.entropy.ans import decode_context_map
from libjxl_torch.utils.bits import BitReader

K_NONZERO_BUCKETS = 37
K_ZERO_DENSITY_CONTEXT_COUNT = 458
K_ZERO_DENSITY_CONTEXT_LIMIT = 474
NUM_ORDERS = 13

K_COEFF_FREQ_CONTEXT = (
    0xBAD, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
    15, 15, 16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 23, 23, 24, 24, 24, 24, 25, 25, 25, 25, 26, 26, 26, 26,
    27, 27, 27, 27, 28, 28, 28, 28, 29, 29, 29, 29, 30, 30, 30, 30)

K_COEFF_NUM_NONZERO_CONTEXT = (
    0xBAD, 0, 31, 62, 62, 93, 93, 93, 93, 123, 123, 123, 123,
    152, 152, 152, 152, 152, 152, 152, 152, 180, 180, 180, 180, 180,
    180, 180, 180, 180, 180, 180, 180, 206, 206, 206, 206, 206, 206,
    206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206,
    206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206)

_DEFAULT_CTX_MAP = (
    0, 1, 2, 2, 3, 3, 4, 5, 6, 6, 6, 6, 6,
    7, 8, 9, 9, 10, 11, 12, 13, 14, 14, 14, 14, 14,
    7, 8, 9, 9, 10, 11, 12, 13, 14, 14, 14, 14, 14)

_DC_THRESHOLD_DIST = U32Enc(Bits(4), BitsOffset(8, 16), BitsOffset(16, 272),
                            BitsOffset(32, 65808))
_QF_THRESHOLD_DIST = U32Enc(Bits(2), BitsOffset(3, 4), BitsOffset(5, 12),
                            BitsOffset(8, 44))


def zero_density_context(nonzeros_left: int, k: int, covered_blocks: int,
                         log2_covered: int, prev: int) -> int:
    nonzeros_left = (nonzeros_left + covered_blocks - 1) >> log2_covered
    k >>= log2_covered
    return (K_COEFF_NUM_NONZERO_CONTEXT[nonzeros_left] +
            K_COEFF_FREQ_CONTEXT[k]) * 2 + prev


class BlockCtxMap:
    """(ac_context.h:66-120)."""

    def __init__(self):
        self.dc_thresholds = [[], [], []]
        self.qf_thresholds = []
        self.ctx_map = list(_DEFAULT_CTX_MAP)
        self.num_ctxs = max(self.ctx_map) + 1
        self.num_dc_ctxs = 1

    def read(self, r: BitReader) -> None:
        """(entropy_coder.cc:25-60)."""
        if r.read(1):
            self.__init__()
            return
        self.num_dc_ctxs = 1
        self.dc_thresholds = []
        for _ in range(3):
            n = r.read(4)
            th = [unpack_signed(read_u32(r, _DC_THRESHOLD_DIST))
                  for _ in range(n)]
            self.dc_thresholds.append(th)
            self.num_dc_ctxs *= n + 1
        nqf = r.read(4)
        self.qf_thresholds = [read_u32(r, _QF_THRESHOLD_DIST) + 1
                              for _ in range(nqf)]
        if self.num_dc_ctxs * (nqf + 1) > 64:
            raise FormatError("block ctx map too big")
        n_ctx = 3 * NUM_ORDERS * self.num_dc_ctxs * (nqf + 1)
        cmap, num = decode_context_map(r, n_ctx)
        self.ctx_map = [int(v) for v in cmap]
        self.num_ctxs = num
        if num > 16:
            raise FormatError("too many block contexts")

    def context(self, dc_idx: int, qf: int, ord_: int, c: int) -> int:
        qf_idx = 0
        for t in self.qf_thresholds:
            if qf > t:
                qf_idx += 1
        idx = c ^ 1 if c < 2 else 2
        idx = idx * NUM_ORDERS + ord_
        idx = idx * (len(self.qf_thresholds) + 1) + qf_idx
        idx = idx * self.num_dc_ctxs + dc_idx
        return self.ctx_map[idx]

    def dc_context(self, qdc_x: int, qdc_y: int, qdc_b: int) -> int:
        """Bucket index from quantized DC (compressed_dc.cc:275-292):
        nesting x -> b -> y."""
        bx = sum(1 for t in self.dc_thresholds[0] if qdc_x > t)
        by = sum(1 for t in self.dc_thresholds[1] if qdc_y > t)
        bb = sum(1 for t in self.dc_thresholds[2] if qdc_b > t)
        bucket = bx
        bucket = bucket * (len(self.dc_thresholds[2]) + 1) + bb
        bucket = bucket * (len(self.dc_thresholds[1]) + 1) + by
        return bucket

    def zero_density_offset(self, block_ctx: int) -> int:
        return (self.num_ctxs * K_NONZERO_BUCKETS +
                K_ZERO_DENSITY_CONTEXT_COUNT * block_ctx)

    def num_ac_contexts(self) -> int:
        return self.num_ctxs * (K_NONZERO_BUCKETS +
                                K_ZERO_DENSITY_CONTEXT_COUNT)

    def nonzero_context(self, non_zeros: int, block_ctx: int) -> int:
        if non_zeros >= 64:
            non_zeros = 64
        ctx = non_zeros if non_zeros < 8 else 4 + non_zeros // 2
        return ctx * self.num_ctxs + block_ctx


def write_block_ctx_map(w, b: BlockCtxMap) -> None:
    """Serialize (entropy_coder.cc EncodeBlockCtxMap mirror of read)."""
    from libjxl_torch.core.fields import write_u32
    from libjxl_torch.core.headers import pack_signed
    from libjxl_torch.entropy.ans import encode_context_map
    if (not b.qf_thresholds and not any(b.dc_thresholds) and
            list(b.ctx_map) == list(_DEFAULT_CTX_MAP)):
        w.write(1, 1)
        return
    w.write(1, 0)
    for th in b.dc_thresholds:
        w.write(4, len(th))
        for t in th:
            write_u32(w, _DC_THRESHOLD_DIST, pack_signed(int(t)))
    w.write(4, len(b.qf_thresholds))
    for t in b.qf_thresholds:
        write_u32(w, _QF_THRESHOLD_DIST, int(t) - 1)
    encode_context_map(w, np.asarray(b.ctx_map, np.int64), b.num_ctxs)


def build_block_ctx_map(distance: float, raw_quant: np.ndarray,
                        acs_map: np.ndarray) -> BlockCtxMap | None:
    """Content-adaptive block context model (enc_heuristics.cc:69-203
    FindBestBlockEntropyModel): bucket blocks by (coeff order, quant
    segment), greedy-merge the lowest-count buckets into 2-9 luma
    contexts (1-5 for chroma). Collapsing the default 15 contexts
    shrinks both the AC context map and the histogram set — the big
    header win on small/flat images. Returns None when the image is
    too small for a custom model to pay."""
    from libjxl_torch.vardct.ac_strategy import STRATEGY_ORDER
    tot = raw_quant.size
    size_for_ctx_model = (1 << 10) * distance
    if tot < size_for_ctx_model:
        return None
    ords = np.asarray(STRATEGY_ORDER)[acs_map]
    qf = raw_quant.astype(np.int64).ravel() - 1
    qf_counts = np.bincount(qf, minlength=256)
    qf_ord = np.zeros((NUM_ORDERS, 256), np.int64)
    np.add.at(qf_ord, (ords.ravel(), qf), 1)

    num_qf_segments = 1 if tot < (1 << 13) * distance else 2
    qft: list[int] = []
    cumsum, nxt, last_cut = 0, 1, 256
    cut = tot * nxt // num_qf_segments
    for j in range(256):
        cumsum += int(qf_counts[j])
        if cumsum > cut:
            if j != 0:
                qft.append(j)
            last_cut = j
            while cumsum > cut:
                nxt += 1
                cut = tot * nxt // num_qf_segments
        elif nxt > len(qft) + 1:
            if j - 1 == last_cut and j != 0:
                qft.append(j)
    nseg = len(qft) + 1
    counts = [0] * (NUM_ORDERS * nseg)
    qft_pos = 0
    for j in range(256):
        if qft_pos < len(qft) and j == qft[qft_pos]:
            qft_pos += 1
        for i in range(NUM_ORDERS):
            counts[qft_pos + i * nseg] += int(qf_ord[i, j])

    remap = list(range(nseg * NUM_ORDERS))
    clusters = list(remap)
    nb = min(max(int(tot / size_for_ctx_model / 2), 2), 9)
    nb_chroma = min(max(int(tot / size_for_ctx_model / 3), 1), 5)
    while len(clusters) > nb:
        clusters.sort(key=lambda a: -counts[a])
        counts[clusters[-2]] += counts[clusters[-1]]
        counts[clusters[-1]] = 0
        remap[clusters[-1]] = clusters[-2]
        clusters.pop()
    for i in range(len(remap)):
        while remap[remap[i]] != remap[i]:
            remap[i] = remap[remap[i]]
    remap_remap = [len(remap)] * len(remap)
    num = 0
    for i in range(len(remap)):
        if remap_remap[remap[i]] == len(remap):
            remap_remap[remap[i]] = num
            num += 1
        remap[i] = remap_remap[remap[i]]
    ctx_map = list(remap)
    for i in range(len(remap), 3 * len(remap)):
        ctx_map.append(num + min(max(remap[i % len(remap)], 0),
                                 nb_chroma - 1))
    b = BlockCtxMap()
    b.dc_thresholds = [[], [], []]
    b.num_dc_ctxs = 1
    b.qf_thresholds = qft
    b.ctx_map = ctx_map
    b.num_ctxs = max(ctx_map) + 1
    return b

