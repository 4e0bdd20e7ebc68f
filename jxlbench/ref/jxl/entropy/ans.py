"""rANS entropy codec: histogram bundles, symbol reader, token writer.

Decode mirrors ``DecodeHistograms``/``ANSSymbolReader``
(``lib/jxl/dec_ans.cc:295-340``, ``lib/jxl/dec_ans.h:162-366``); encode
mirrors ``BuildAndStoreEntropyCodes``/``WriteTokens``
(``lib/jxl/enc_ans.cc:915,1237-1321``, ``lib/jxl/enc_ans.h:49-77``).

The 32-bit rANS state renormalizes in 16-bit words; streams are written in
reverse and read forward; the final decoder state must equal the signature
(0x13 << 16) — a built-in checksum.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from jxlbench.ref.jxl.core.fields import (
    Bits, BitsOffset, FormatError, U32Enc, Val, read_u32, write_u32,
)
from jxlbench.ref.jxl.entropy.alias import build_alias_table, build_encoder_slots
from jxlbench.ref.jxl.entropy.histogram import (
    ANS_LOG_TAB_SIZE, ANS_MAX_ALPHABET_SIZE, ANS_SIGNATURE, ANS_TAB_SIZE,
    PREFIX_MAX_BITS, decode_varlen_uint16, encode_varlen_uint16,
    read_histogram, write_histogram,
)
from jxlbench.ref.jxl.entropy.hybrid import HybridUintConfig
from jxlbench.ref.jxl.entropy.prefix import (
    PrefixCode, build_prefix_lengths, canonical_codes, read_prefix_code,
    write_prefix_code, _reverse_bits,
)
from jxlbench.ref.jxl.utils.bits import BitReader, BitWriter

K_WINDOW_SIZE = 1 << 20
K_NUM_SPECIAL_DISTANCES = 120
_SPECIAL_DISTANCES = (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2),
    (2, 1), (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3),
    (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0),
    (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4),
    (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2),
    (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0),
    (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2),
    (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3),
    (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1),
    (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5),
    (8, 0), (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6),
    (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7),
    (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7))


def special_distance(index: int, multiplier: int) -> int:
    a, b = _SPECIAL_DISTANCES[index]
    d = a + multiplier * b
    return d if d > 1 else 1


@dataclass
class LZ77Params:
    """(dec_ans.cc LZ77Params::VisitFields)."""

    enabled: bool = False
    min_symbol: int = 224
    min_length: int = 3
    length_uint_config: HybridUintConfig = HybridUintConfig(0, 0, 0)
    distance_context: int = 0   # nonserialized

    def read(self, r: BitReader) -> None:
        self.enabled = r.read(1) == 1
        if self.enabled:
            self.min_symbol = read_u32(r, U32Enc(Val(224), Val(512),
                                                 Val(4096), BitsOffset(15, 8)))
            self.min_length = read_u32(r, U32Enc(Val(3), Val(4),
                                                 BitsOffset(2, 5),
                                                 BitsOffset(8, 9)))

    def write(self, w: BitWriter) -> None:
        w.write(1, 1 if self.enabled else 0)
        if self.enabled:
            write_u32(w, U32Enc(Val(224), Val(512), Val(4096),
                                BitsOffset(15, 8)), self.min_symbol)
            write_u32(w, U32Enc(Val(3), Val(4), BitsOffset(2, 5),
                                BitsOffset(8, 9)), self.min_length)


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


def read_uint_config(r: BitReader, log_alpha_size: int) -> HybridUintConfig:
    """(dec_ans.cc:271-293)."""
    split_exponent = r.read(_ceil_log2(log_alpha_size + 1))
    msb = lsb = 0
    if split_exponent != log_alpha_size:
        nbits = _ceil_log2(split_exponent + 1)
        msb = r.read(nbits)
        if msb > split_exponent:
            raise FormatError("invalid hybrid uint config")
        nbits = _ceil_log2(split_exponent - msb + 1)
        lsb = r.read(nbits)
    if lsb + msb > split_exponent:
        raise FormatError("invalid hybrid uint config")
    return HybridUintConfig(split_exponent, msb, lsb)


def write_uint_config(w: BitWriter, cfg: HybridUintConfig,
                      log_alpha_size: int) -> None:
    w.write(_ceil_log2(log_alpha_size + 1), cfg.split_exponent)
    if cfg.split_exponent != log_alpha_size:
        w.write(_ceil_log2(cfg.split_exponent + 1), cfg.msb_in_token)
        w.write(_ceil_log2(cfg.split_exponent - cfg.msb_in_token + 1),
                cfg.lsb_in_token)


@dataclass
class ANSCode:
    """Decoded entropy-code bundle for one histogram set."""

    use_prefix_code: bool = False
    log_alpha_size: int = 8
    lz77: LZ77Params = field(default_factory=LZ77Params)
    uint_configs: list = field(default_factory=list)
    # per-histogram decode tables
    alias_symbols: list = field(default_factory=list)   # [np(4096)]
    alias_offsets: list = field(default_factory=list)   # [np(4096)]
    alias_freqs: list = field(default_factory=list)     # [np(tab)]
    prefix_codes: list = field(default_factory=list)    # [PrefixCode|None]
    context_map: np.ndarray | None = None


def decode_context_map(r: BitReader, num_contexts: int):
    """(dec_context_map.cc:48-95). Returns (context_map, num_histograms)."""
    context_map = np.zeros(num_contexts, dtype=np.int32)
    if r.read(1):  # simple
        bits_per_entry = r.read(2)
        if bits_per_entry != 0:
            for i in range(num_contexts):
                context_map[i] = r.read(bits_per_entry)
    else:
        use_mtf = r.read(1) == 1
        code = decode_histograms(r, 1, disallow_lz77=num_contexts <= 2)
        reader = ANSSymbolReader(code, r)
        vals = None
        if not code.use_prefix_code and not code.lz77.enabled:
            # bulk path: the map is one single-context token run — the
            # native decoder does it in one call (dec_context_map.cc:75)
            from jxlbench.ref.jxl.utils import native
            if native.available():
                ctx = int(code.context_map[0])
                cfg = code.uint_configs[ctx]
                res = native.ans_decode_tokens(
                    r._data, r.bits_consumed, num_contexts,
                    code.alias_symbols[ctx], code.alias_offsets[ctx],
                    code.alias_freqs[ctx],
                    cfg=(cfg.split_exponent, cfg.msb_in_token,
                         cfg.lsb_in_token),
                    check_final=False, state=reader.state)
                if res is not None:
                    vals, end_bit, state = res
                    r.skip(end_bit - r.bits_consumed)
                    reader.state = state
                    if vals.max(initial=0) >= 256:
                        raise FormatError("invalid cluster ID")
                    context_map[:] = vals
        if vals is None:
            for i in range(num_contexts):
                context_map[i] = reader.read_hybrid_uint(0, r)
        if context_map.max(initial=0) >= 256:
            raise FormatError("invalid cluster ID")
        if not reader.check_final_state():
            raise FormatError("invalid context map checksum")
        if use_mtf:
            _inverse_mtf(context_map)
    num_histograms = int(context_map.max()) + 1
    used = np.unique(context_map)
    if used.size != num_histograms or context_map.min() < 0:
        raise FormatError("incomplete context map")
    return context_map, num_histograms


def _inverse_mtf(values: np.ndarray) -> None:
    mtf = list(range(256))
    for i in range(len(values)):
        idx = int(values[i])
        values[i] = mtf[idx]
        if idx:
            v = mtf.pop(idx)
            mtf.insert(0, v)


def _mtf_transform(values: np.ndarray) -> np.ndarray:
    """Move-to-front (enc_context_map.cc MoveToFrontTransform)."""
    mtf = list(range(int(values.max()) + 1))
    out = np.empty(len(values), dtype=np.int64)
    for i, v in enumerate(values.tolist()):
        idx = mtf.index(v)
        out[i] = idx
        if idx:
            mtf.insert(0, mtf.pop(idx))
    return out


def encode_context_map(w: BitWriter, context_map, num_histograms: int
                       ) -> None:
    """Context map encoding (enc_context_map.cc EncodeContextMap):
    candidates are raw bits, plain-ANS, MTF-ANS, and (for long maps)
    RLE-LZ77 variants of both; the smallest serialization wins. AC
    coefficient context maps have thousands of entries in long runs, so
    the MTF/RLE paths are ~2-4x smaller than raw ANS there."""
    context_map = np.asarray(context_map)
    if len(context_map) <= 1:
        return
    if num_histograms == 1:
        w.write(1, 1)   # simple
        w.write(2, 0)   # 0 bits per entry
        return
    candidates = []
    bits_per_entry = _ceil_log2(num_histograms)
    if bits_per_entry <= 3:
        ww = BitWriter()
        ww.write(1, 1)
        ww.write(2, bits_per_entry)
        for v in context_map:
            ww.write(bits_per_entry, int(v))
        candidates.append(ww)
    if bits_per_entry <= 3 and len(context_map) <= 16:
        # short maps: raw bits are within a byte or two of the entropy-
        # coded candidates, and building 3-4 candidate ANS streams per
        # map dominated the e3 host profile (~23 code builds/image)
        w.append_writer(candidates[0])
        return
    arr_raw = np.zeros((len(context_map), 2), dtype=np.int64)
    arr_raw[:, 1] = context_map
    arr_mtf = arr_raw.copy()
    arr_mtf[:, 1] = _mtf_transform(context_map)
    # the ctx-map entropy stream may itself use LZ77 only when the outer
    # map is longer than 2 entries (dec_context_map.cc:61 mirror)
    allow_lz = len(context_map) > 2 and len(context_map) >= 16
    for use_mtf, arr in ((False, arr_raw), (True, arr_mtf)):
        for use_lz in (False, True):
            if use_lz and not allow_lz:
                continue
            ww = BitWriter()
            ww.write(1, 0)
            ww.write(1, 1 if use_mtf else 0)
            if use_lz:
                lz = LZ77Params(enabled=True)
                t = lz77_rle_transform(arr, 1, lz)
                if len(t) >= len(arr):          # no runs worth emitting
                    continue
                codes = build_entropy_codes([t], 1, lz77=lz,
                                            allow_clustering=False)
                write_entropy_codes(ww, codes)
                write_tokens(ww, t, codes)
            else:
                codes = build_entropy_codes([arr], 1,
                                            allow_clustering=False)
                write_entropy_codes(ww, codes)
                write_tokens(ww, arr, codes)
            candidates.append(ww)
    w.append_writer(min(candidates, key=lambda b: b.bits_written))


def decode_histograms(r: BitReader, num_contexts: int,
                      disallow_lz77: bool = False) -> ANSCode:
    """(dec_ans.cc:295-340)."""
    res = _decode_histograms_fast(r, num_contexts, disallow_lz77)
    if res is not None:
        return res
    code = ANSCode()
    code.lz77.read(r)
    if code.lz77.enabled:
        if disallow_lz77:
            raise FormatError("LZ77 disallowed here")
        num_contexts += 1
        code.lz77.length_uint_config = read_uint_config(r, 8)
    if num_contexts > 1:
        code.context_map, num_histograms = decode_context_map(r, num_contexts)
    else:
        code.context_map = np.zeros(1, dtype=np.int32)
        num_histograms = 1
    code.lz77.distance_context = int(code.context_map[-1])
    code.use_prefix_code = r.read(1) == 1
    if code.use_prefix_code:
        code.log_alpha_size = PREFIX_MAX_BITS
    else:
        code.log_alpha_size = r.read(2) + 5
    code.uint_configs = [read_uint_config(r, code.log_alpha_size)
                         for _ in range(num_histograms)]
    if code.use_prefix_code:
        alphabet_sizes = [decode_varlen_uint16(r) + 1
                          for _ in range(num_histograms)]
        for sz in alphabet_sizes:
            if sz > (1 << PREFIX_MAX_BITS):
                raise FormatError("alphabet too large")
        for sz in alphabet_sizes:
            if sz > 1:
                code.prefix_codes.append(read_prefix_code(sz, r))
            else:
                code.prefix_codes.append(None)  # 0-bit: symbol 0
    else:
        max_alphabet = 1 << code.log_alpha_size
        for _ in range(num_histograms):
            counts = read_histogram(r)
            if len(counts) > max_alphabet:
                raise FormatError("alphabet too large")
            sym, off, freq = build_alias_table(counts, code.log_alpha_size)
            code.alias_symbols.append(sym)
            code.alias_offsets.append(off)
            code.alias_freqs.append(freq)
    if r.overflow:
        raise FormatError("truncated entropy header")
    return code


def _decode_histograms_fast(r: BitReader, num_contexts: int,
                            disallow_lz77: bool):
    """Native one-call histogram-set decode (jxlt_decode_histograms):
    the LZ77 params / context map / uint configs / per-cluster ANS
    histograms are sequential bit-level parsing that dominated the
    host decode prelude in Python. Returns None to fall back (native
    unavailable, prefix codes, nested-LZ77 context map, or corrupt
    stream — the Python path re-parses to raise the exact error)."""
    from jxlbench.ref.jxl.utils import native
    res = native.decode_histograms_native(
        r._data, r.bits_consumed, num_contexts, disallow_lz77)
    if res is None:
        return None
    (end, lz77, ctx_map, num_histograms, log_alpha, cfgs, counts,
     alphas) = res
    code = ANSCode()
    code.lz77.enabled = bool(lz77[0])
    n_ctx = num_contexts
    if code.lz77.enabled:
        code.lz77.min_symbol = int(lz77[1])
        code.lz77.min_length = int(lz77[2])
        code.lz77.length_uint_config = HybridUintConfig(
            int(lz77[3]), int(lz77[4]), int(lz77[5]))
        n_ctx += 1
    code.lz77.distance_context = int(lz77[6])
    code.context_map = ctx_map[:n_ctx].copy()
    code.use_prefix_code = False
    code.log_alpha_size = log_alpha
    code.uint_configs = [
        HybridUintConfig(int(cfgs[3 * h]), int(cfgs[3 * h + 1]),
                         int(cfgs[3 * h + 2]))
        for h in range(num_histograms)]
    from jxlbench.ref.jxl.entropy.alias import build_alias_table
    for h in range(num_histograms):
        cts = counts[320 * h:320 * h + int(alphas[h])]
        sym, off, freq = build_alias_table(cts.tolist(), log_alpha)
        code.alias_symbols.append(sym)
        code.alias_offsets.append(off)
        code.alias_freqs.append(freq)
    r.skip(end - r.bits_consumed)
    return code


class ANSSymbolReader:
    """Scalar symbol/uint reader (dec_ans.h:162-366)."""

    def __init__(self, code: ANSCode, r: BitReader,
                 distance_multiplier: int = 0):
        self.code = code
        self.log_entry_size = max(ANS_LOG_TAB_SIZE - code.log_alpha_size, 0)
        self.entry_mask = (1 << self.log_entry_size) - 1
        if not code.use_prefix_code:
            self.state = r.read(32)
        else:
            self.state = ANS_SIGNATURE << 16
        self.lz77_enabled = code.lz77.enabled
        self.num_to_copy = 0
        self.copy_pos = 0
        self.num_decoded = 0
        self.window = (np.zeros(K_WINDOW_SIZE, dtype=np.uint32)
                       if code.lz77.enabled else None)
        self.num_special = (K_NUM_SPECIAL_DISTANCES
                           if distance_multiplier else 0)
        self.special = [special_distance(i, distance_multiplier)
                        for i in range(self.num_special)]

    def read_symbol(self, histo_idx: int, r: BitReader) -> int:
        code = self.code
        if code.use_prefix_code:
            pc = code.prefix_codes[histo_idx]
            return 0 if pc is None else pc.read_symbol(r)
        res = self.state & (ANS_TAB_SIZE - 1)
        sym = int(code.alias_symbols[histo_idx][res])
        off = int(code.alias_offsets[histo_idx][res])
        freq = int(code.alias_freqs[histo_idx][sym])
        self.state = freq * (self.state >> ANS_LOG_TAB_SIZE) + off
        if self.state < (1 << 16):
            self.state = (self.state << 16) | r.read(16)
        return sym

    def read_hybrid_uint(self, ctx: int, r: BitReader) -> int:
        """ctx is an UNclustered context; maps through context_map."""
        return self.read_hybrid_uint_clustered(
            int(self.code.context_map[ctx]), r)

    def read_hybrid_uint_clustered(self, ctx: int, r: BitReader) -> int:
        if self.lz77_enabled and self.num_to_copy > 0:
            ret = int(self.window[self.copy_pos & (K_WINDOW_SIZE - 1)])
            self.copy_pos += 1
            self.num_to_copy -= 1
            self.window[self.num_decoded & (K_WINDOW_SIZE - 1)] = ret
            self.num_decoded += 1
            return ret
        token = self.read_symbol(ctx, r)
        if self.lz77_enabled and token >= self.code.lz77.min_symbol:
            lz = self.code.lz77
            self.num_to_copy = lz.length_uint_config.decode(
                token - lz.min_symbol, lambda n: r.read(n)) + lz.min_length
            d_token = self.read_symbol(lz.distance_context, r)
            distance = self.code.uint_configs[lz.distance_context].decode(
                d_token, lambda n: r.read(n))
            if distance < self.num_special:
                distance = self.special[distance]
            else:
                distance = distance + 1 - self.num_special
            if distance > self.num_decoded:
                distance = self.num_decoded
            if distance > K_WINDOW_SIZE:
                distance = K_WINDOW_SIZE
            self.copy_pos = self.num_decoded - distance
            if distance == 0:
                self.window[:min(self.num_to_copy, K_WINDOW_SIZE)] = 0
            return self.read_hybrid_uint_clustered(ctx, r)
        ret = self.code.uint_configs[ctx].decode(token, lambda n: r.read(n))
        if self.lz77_enabled:
            self.window[self.num_decoded & (K_WINDOW_SIZE - 1)] = ret
            self.num_decoded += 1
        return ret

    def check_final_state(self) -> bool:
        return self.state == (ANS_SIGNATURE << 16) or \
            self.code.use_prefix_code


# ---------------------------------------------------------------------------
# Encode side
# ---------------------------------------------------------------------------

def tokens_to_array(tokens) -> np.ndarray:
    """tokens: iterable of (context, value) pairs — or a mixed list of
    pairs and (n, 2) array chunks (vectorized tokenizers append whole
    blocks at once) -> (N, 2) int64 array."""
    if isinstance(tokens, np.ndarray):
        return tokens
    if isinstance(tokens, list) and \
            any(isinstance(t, np.ndarray) for t in tokens):
        parts, buf = [], []
        for t in tokens:
            if isinstance(t, np.ndarray):
                if buf:
                    parts.append(np.asarray(buf, np.int64).reshape(-1, 2))
                    buf = []
                parts.append(t.reshape(-1, 2).astype(np.int64,
                                                     copy=False))
            else:
                buf.append(t)
        if buf:
            parts.append(np.asarray(buf, np.int64).reshape(-1, 2))
        return np.concatenate(parts) if parts else \
            np.zeros((0, 2), np.int64)
    return np.array(tokens, dtype=np.int64).reshape(-1, 2)


@dataclass
class EntropyEncodingData:
    """Encoder-side mirror of ANSCode."""

    use_prefix_code: bool = False
    log_alpha_size: int = 8
    lz77: LZ77Params = field(default_factory=LZ77Params)
    uint_configs: list = field(default_factory=list)
    context_map: np.ndarray | None = None
    num_histograms: int = 1
    histo_shift: int = 13                              # count precision
    counts: list = field(default_factory=list)         # normalized per histo
    # derived encode tables
    slot_starts: list = field(default_factory=list)
    slots: list = field(default_factory=list)
    prefix_lengths: list = field(default_factory=list)
    prefix_depths: list = field(default_factory=list)  # emission depths
    prefix_bits: list = field(default_factory=list)    # LSB-first codes


def normalize_counts(hist: np.ndarray, target: int = ANS_TAB_SIZE
                     ) -> np.ndarray:
    """Normalize to sum=target, keeping every nonzero symbol nonzero."""
    hist = np.asarray(hist, dtype=np.int64)
    total = int(hist.sum())
    assert total > 0
    nz = hist > 0
    n_nz = int(nz.sum())
    if n_nz == 1:
        out = np.zeros_like(hist)
        out[np.argmax(hist)] = target
        return out
    scaled = hist.astype(np.float64) * (target - n_nz) / total
    out = np.floor(scaled).astype(np.int64) + nz.astype(np.int64)
    deficit = target - int(out.sum())
    if deficit > 0:
        frac = scaled - np.floor(scaled)
        frac[~nz] = -1
        order = np.argsort(-frac, kind="stable")
        for i in order[:deficit]:
            out[i] += 1
    elif deficit < 0:
        room = out - 1
        room[~nz] = 0
        order = np.argsort(-out, kind="stable")
        k = -deficit
        for i in order:
            if k == 0:
                break
            take = min(int(room[i]), k)
            out[i] -= take
            k -= take
        assert k == 0
    assert out.sum() == target
    return out


def _entropy_cost(h: np.ndarray) -> float:
    """Shannon cost in bits of a histogram coded with its own code."""
    total = h.sum()
    if total == 0:
        return 0.0
    nz = h[h > 0].astype(np.float64)
    return float(total * np.log2(total) - (nz * np.log2(nz)).sum())


def _entropy_cost_rows(H: np.ndarray) -> np.ndarray:
    """Shannon cost in bits for each row histogram, vectorized."""
    Hf = H.astype(np.float64)
    totals = Hf.sum(axis=1)
    logs = np.zeros_like(Hf)
    np.log2(Hf, out=logs, where=Hf > 0)
    tlog = np.where(totals > 0,
                    totals * np.log2(np.maximum(totals, 1.0)), 0.0)
    return tlog - (Hf * logs).sum(axis=1)


def cluster_histograms(hists: np.ndarray, max_clusters: int = 64):
    """Greedy entropy-distance clustering (FastClusterHistograms,
    enc_cluster.cc:136). Returns (context_map, clustered_hists).

    Each incoming histogram is scored against ALL current clusters in
    one vectorized entropy evaluation over the occupied alphabet width
    (the scalar form cost >1s/frame in the VarDCT encoder)."""
    n = len(hists)
    full_width = hists.shape[1]
    occ = np.flatnonzero(hists.any(axis=0))
    width = int(occ[-1]) + 1 if occ.size else 1
    hists = hists[:, :width]
    totals = hists.sum(axis=1)
    order = np.argsort(-totals, kind="stable")
    C = np.zeros((max_clusters, width), dtype=np.int64)
    costs = np.zeros(max_clusters)
    k = 0
    cmap = np.zeros(n, dtype=np.int64)
    # all-empty contexts share cluster 0 later via mapping of zero hists
    for idx in order:
        if totals[idx] == 0 and k:
            # empty context: merges anywhere at zero delta-cost; the
            # descending-total order guarantees all of these come last
            cmap[idx] = 0
            continue
        h = hists[idx].astype(np.int64)
        own_cost = _entropy_cost(h)
        if k:
            merged = C[:k] + h
            merged_costs = _entropy_cost_rows(merged)
            dcost = merged_costs - costs[:k] - own_cost
            best = int(np.argmin(dcost))
            best_cost = float(dcost[best])
        else:
            best, best_cost, merged_costs = -1, None, None
        # break-even: a new cluster pays only when the token bits saved
        # by separate coding exceed the cost of SERIALIZING one more
        # histogram (measured on geometric-decay shapes: ~10 bits for
        # 1 symbol, ~33 for 2, then ~40 + 5.5/symbol of ANS counts)
        nnz_h = int((h > 0).sum())
        ser_est = 12.0 if nnz_h <= 1 else 33.0 if nnz_h == 2 \
            else 40.0 + 5.5 * nnz_h
        if k and (best_cost <= max(ser_est, 0.01 * own_cost)
                  or k >= max_clusters):
            C[best] += h
            costs[best] = float(merged_costs[best])
            cmap[idx] = best
        else:
            cmap[idx] = k
            C[k] = h
            costs[k] = own_cost
            k += 1
    if k == 0:
        k = 1
    out = np.zeros((k, full_width), dtype=np.int64)
    out[:, :width] = C[:k]
    return cmap, out


def lz77_rle_transform(arr: np.ndarray, num_contexts: int,
                       lz77: LZ77Params, min_emit: int = 4,
                       distance_multiplier: int = 0) -> np.ndarray:
    """RLE-flavoured LZ77 (enc_ans.cc ApplyLZ77_RLE): replace runs of a
    repeated VALUE (distance 1) with a length token + distance token.

    arr: (N, 2) (context, value). Returns (M, 3) rows of
    (context, value, kind) with kind 0=literal, 1=copy length (value is
    the length), 2=distance (context column is the appended distance
    context ``num_contexts``)."""
    arr = tokens_to_array(arr)
    n = len(arr)
    if n < min_emit + 1:
        out = np.zeros((n, 3), dtype=np.int64)
        out[:, :2] = arr
        return out
    val = arr[:, 1]
    eq = np.concatenate([[False], val[1:] == val[:-1]])
    # maximal True-runs of eq: eq[a..b] => positions a..b copy val[a-1]
    d = np.diff(eq.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1          # exclusive
    if eq[0]:
        starts = np.concatenate([[0], starts])
    if eq[-1]:
        ends = np.concatenate([ends, [n]])
    min_run = max(min_emit, lz77.min_length)
    keep = ((ends - starts) >= min_run) & (starts > 0)
    starts, ends = starts[keep], ends[keep]
    rows = []
    pos = 0
    for a, b in zip(starts, ends):
        run = b - a
        if a > pos:
            lit = np.zeros((a - pos, 3), dtype=np.int64)
            lit[:, :2] = arr[pos:a]
            rows.append(lit)
        # distance 1: token 0 plain, or special-distance index 1 ((1,0)
        # in kSpecialDistances) when the stream has a distance multiplier
        dv = 1 if distance_multiplier else 0
        rows.append(np.array([[arr[a, 0], run, 1],
                              [num_contexts, dv, 2]], dtype=np.int64))
        pos = b
    if pos == 0:
        out = np.zeros((n, 3), dtype=np.int64)
        out[:, :2] = arr
        return out
    if pos < n:
        lit = np.zeros((n - pos, 3), dtype=np.int64)
        lit[:, :2] = arr[pos:]
        rows.append(lit)
    return np.concatenate(rows)


def lz77_match_transform(arrs, num_contexts: int, lz77: LZ77Params,
                         distance_multipliers=None):
    """General LZ77 over token streams (enc_lz77.cc:439 ApplyLZ77_LZ77):
    hash-chain match search with greedy + one-symbol-lazy parsing, gated
    per match on estimated literal-vs-copy bit cost. Match search runs in
    the native module (the parse is inherently sequential); returns a
    list of (M, 3) arrays in lz77_rle_transform's row format, or None
    when native is unavailable or the estimated saving is below the
    keep threshold (bit_decrease <= 0.2 * total_symbols + 16)."""
    from jxlbench.ref.jxl.utils import native
    if not native.available():
        return None
    arrs = [tokens_to_array(a) for a in arrs]
    if distance_multipliers is None:
        distance_multipliers = [0] * len(arrs)
    cfg = HybridUintConfig(4, 2, 0)
    # literal-cost estimator over ALL streams (SymbolCostEstimator):
    # -log2(p) per token under the plain-stream histograms
    hists = np.zeros((num_contexts, 256), dtype=np.int64)
    toks_all, nbits_all = [], []
    for arr in arrs:
        if not len(arr):
            toks_all.append(None)
            nbits_all.append(None)
            continue
        tok, nb, _ = cfg.encode_array(arr[:, 1].astype(np.uint32))
        toks_all.append(tok)
        nbits_all.append(nb)
        np.add.at(hists, (arr[:, 0], np.minimum(tok, 255)), 1)
    totals = hists.sum(axis=1)
    with np.errstate(divide="ignore"):
        bits_tab = -np.log2(hists / np.maximum(totals, 1)[:, None])
    bits_tab[hists == 0] = 12.0              # ANS_LOG_TAB_SIZE ceiling
    bits_tab[hists == totals[:, None]] = 0.0
    # per-context penalty for introducing the length symbol
    avg_bits = (hists * np.where(np.isfinite(bits_tab), bits_tab, 0)
                ).sum(axis=1) / np.maximum(totals, 1)
    add_cost_ctx = np.maximum(0.0, 6.0 - avg_bits).astype(np.float32)

    out_arrs = []
    bit_decrease = 0.0
    total_symbols = 0
    for arr, tok, nb, mult in zip(arrs, toks_all, nbits_all,
                                  distance_multipliers):
        if not len(arr):
            out_arrs.append(np.zeros((0, 3), dtype=np.int64))
            continue
        total_symbols += len(arr)
        lit_bits = (bits_tab[arr[:, 0], np.minimum(tok, 255)] +
                    nb).astype(np.float32)
        sym_cost = np.zeros(len(arr) + 1, dtype=np.float32)
        np.cumsum(lit_bits, out=sym_cost[1:])
        nspecial = K_NUM_SPECIAL_DISTANCES if mult else 0
        sd = np.array([special_distance(i, mult)
                       for i in range(nspecial)], dtype=np.int32)
        res = native.lz77_parse(
            arr[:, 1].astype(np.uint32), sym_cost,
            add_cost_ctx[arr[:, 0]], lz77.min_length, sd)
        if res is None:
            return None
        mlen, msym = res
        starts = np.flatnonzero(mlen)
        if not len(starts):
            out_arrs.append(np.column_stack(
                [arr, np.zeros(len(arr), dtype=np.int64)]))
            continue
        rows = []
        pos = 0
        for s in starts:
            ln = int(mlen[s])
            if s > pos:
                lit = np.zeros((s - pos, 3), dtype=np.int64)
                lit[:, :2] = arr[pos:s]
                rows.append(lit)
            rows.append(np.array(
                [[arr[s, 0], ln, 1],
                 [num_contexts, int(msym[s]), 2]], dtype=np.int64))
            bit_decrease += float(sym_cost[s + ln] - sym_cost[s]) - 10.0
            pos = s + ln
        if pos < len(arr):
            lit = np.zeros((len(arr) - pos, 3), dtype=np.int64)
            lit[:, :2] = arr[pos:]
            rows.append(lit)
        out_arrs.append(np.concatenate(rows))
    if bit_decrease <= 0.2 * total_symbols + 16:
        return None
    return out_arrs


def _tokenize_rows(arr: np.ndarray, cfg: HybridUintConfig,
                   lz77: LZ77Params):
    """Per-row (token, nbits, bits) for a plain (N,2) stream or an
    LZ77-transformed (N,3) stream."""
    vals = arr[:, 1].astype(np.uint32)
    toks, nbits, bits = cfg.encode_array(vals)
    if arr.shape[1] == 3:
        is_len = arr[:, 2] == 1
        if is_len.any():
            lt, ln, lb = lz77.length_uint_config.encode_array(
                (arr[is_len, 1] - lz77.min_length).astype(np.uint32))
            toks = toks.astype(np.int64)
            toks[is_len] = lt.astype(np.int64) + lz77.min_symbol
            nbits[is_len] = ln
            bits[is_len] = lb
    return toks, nbits, bits


def _trim_back(a: np.ndarray) -> np.ndarray:
    """np.trim_zeros(trim="b") without its per-element Python loop."""
    nz = np.nonzero(a)[0]
    return a[:nz[-1] + 1] if nz.size else a[:0]


_UINT_SEARCH_CANDIDATES = (
    # ChooseUintConfigs (enc_ans.cc:745-770) kBest subset that covers
    # the shapes seen in AC/modular streams; every candidate keeps the
    # 8-bit ANS alphabet
    (4, 2, 0), (4, 1, 0), (4, 2, 1), (4, 1, 2), (5, 2, 0), (5, 1, 0),
    (3, 2, 0), (2, 0, 1), (0, 0, 0), (7, 0, 0),
)


def build_entropy_codes(token_arrays, num_contexts: int,
                        use_prefix_code: bool = False,
                        allow_clustering: bool = True,
                        lz77: LZ77Params | None = None,
                        histo_shift: int = 13,
                        max_clusters: int = 64,
                        uint_search: bool = False) -> EntropyEncodingData:
    """Histograms + (trivial) clustering from token streams.

    token_arrays: list of (N,2) arrays of (context, value) pairs.
    """
    codes = EntropyEncodingData()
    if lz77 is not None:
        codes.lz77 = lz77
    lz_on = codes.lz77.enabled
    codes.use_prefix_code = use_prefix_code
    cfg = HybridUintConfig(4, 2, 0)
    alpha_bits = PREFIX_MAX_BITS if use_prefix_code else 8
    # histogram per context of token values (+1 distance context for LZ77)
    eff_contexts = num_contexts + 1 if lz_on else num_contexts
    max_token = 0
    flats = []
    tok_cache: dict = {}
    codes._tok_cache = tok_cache
    codes._tok_cache_cfg = cfg
    for arr in token_arrays:
        if arr.size == 0:
            continue
        ctx = arr[:, 0]
        tok, nb_, bits_ = _tokenize_rows(arr, cfg, codes.lz77)
        # keep the default-config tokenization for write_tokens: the
        # same arrays come back for emission and re-tokenizing them was
        # ~10% of the e3 host tail (cache is valid only while every
        # cluster keeps cfg; uint_search invalidates it below)
        tok_cache[id(arr)] = (arr, tok, nb_, bits_)
        if tok.size:
            max_token = max(max_token, int(tok.max()))
        flats.append(ctx * (1 << alpha_bits) + tok)
    if max_token >= (1 << alpha_bits):
        raise FormatError("token too large for alphabet")
    # ONE bincount over the flattened (ctx, tok) indices of all streams:
    # ~8x faster than np.add.at's unbuffered scatter, and one allocation
    # instead of one per stream
    hists = np.bincount(
        np.concatenate(flats) if flats else np.zeros(0, np.int64),
        minlength=eff_contexts << alpha_bits
    ).reshape(eff_contexts, 1 << alpha_bits)
    # cluster histograms (entropy-distance greedy, enc_cluster.cc:136-300)
    if allow_clustering and eff_contexts > 1:
        context_map, clustered = cluster_histograms(hists, max_clusters)
    else:
        context_map = np.arange(eff_contexts)
        clustered = hists
    if lz_on:
        codes.lz77.distance_context = int(context_map[-1])
    codes.context_map = context_map.astype(np.int32)
    codes.num_histograms = len(clustered)
    codes.uint_configs = [cfg] * codes.num_histograms
    if uint_search and not use_prefix_code and not lz_on:
        # per-cluster hybrid-uint config search (ChooseUintConfigs,
        # enc_ans.cc:712-870): re-tokenize each cluster's values under
        # a small candidate set, score entropy + raw bits + a histogram
        # header estimate, keep the winner. The decode side reads one
        # config per histogram, so this is free format-wise.
        nz_arrays = [a for a in token_arrays if a.size]
        if nz_arrays:
            ctx_all = np.concatenate([a[:, 0] for a in nz_arrays])
            val_all = np.concatenate([a[:, 1] for a in nz_arrays]
                                     ).astype(np.uint32)
            clus = context_map[ctx_all]
            order = np.argsort(clus, kind="stable")
            sv = val_all[order]
            sc = clus[order]
            bounds = np.searchsorted(sc, np.arange(len(clustered) + 1))
            clustered = [np.asarray(h, np.int64) for h in clustered]
            for h in range(len(clustered)):
                vals = sv[bounds[h]:bounds[h + 1]]
                if vals.size < 64:
                    continue
                # big clusters: score candidates on an even subsample
                # (the decision is a distribution property; 1/k sampling
                # changes the per-candidate cost estimate by ~k noise on
                # a 2^16 population but never flips a >0.5% winner), then
                # re-tokenize only the WINNER at full size for the
                # histogram the stream is actually coded with
                search_vals = vals if vals.size <= (1 << 15) else \
                    vals[::(vals.size >> 15) + 1]
                sfac = vals.size / search_vals.size
                best = None
                for t3 in _UINT_SEARCH_CANDIDATES:
                    c = HybridUintConfig(*t3)
                    tok, nb, _ = c.encode_array(search_vals)
                    if tok.size and int(tok.max()) >= 256:
                        continue
                    hist = np.bincount(tok, minlength=1)
                    # exact coded cost: ANS bits under the NORMALIZED
                    # histogram + raw bits + the real histogram header
                    norm = np.asarray(normalize_counts(
                        _trim_back(hist.astype(np.int64))), np.float64)
                    nzm = hist[:len(norm)] > 0
                    ans_bits = float(-(hist[:len(norm)][nzm] *
                                       np.log2(norm[nzm] /
                                               ANS_TAB_SIZE)).sum())
                    hw = BitWriter()
                    write_histogram(hw, [int(x) for x in norm],
                                    shift=histo_shift)
                    cost = sfac * (ans_bits + float(nb.sum())) + \
                        hw.bits_written
                    if best is None or cost < best[0]:
                        best = (cost, c, hist)
                if best is not None:
                    codes.uint_configs[h] = best[1]
                    if sfac > 1.0:
                        tok, _, _ = best[1].encode_array(vals)
                        if tok.size and int(tok.max()) >= 256:
                            codes.uint_configs[h] = cfg
                            continue
                        best = (best[0], best[1], np.bincount(
                            tok, minlength=1))
                    clustered[h] = best[2]
    codes.log_alpha_size = alpha_bits if not use_prefix_code else \
        PREFIX_MAX_BITS
    if not use_prefix_code:
        codes.log_alpha_size = 8
    for h in clustered:
        h = _trim_back(h)
        if h.size == 0:
            h = np.array([1], dtype=np.int64)
        if use_prefix_code:
            lengths = build_prefix_lengths(h)
            codes.prefix_lengths.append(lengths)
            mcodes = canonical_codes(lengths)
            codes.prefix_bits.append(
                [(_reverse_bits(c, int(l)) if l else 0)
                 for c, l in zip(mcodes, lengths)])
            # A single-symbol code is transmitted as a simple code that the
            # decoder reads with 0 bits per symbol (dec_huffman.cc:127-129).
            depths = np.asarray(lengths).copy()
            if np.count_nonzero(h) == 1:
                depths[:] = 0
            codes.prefix_depths.append(depths)
            codes.counts.append(h)
        else:
            from jxlbench.ref.jxl.entropy.histogram import quantize_histogram
            norm = np.asarray(quantize_histogram(
                list(normalize_counts(h)), histo_shift), dtype=np.int64)
            codes.histo_shift = histo_shift
            codes.counts.append(norm)
            start, slots = build_encoder_slots(norm, codes.log_alpha_size)
            codes.slot_starts.append(start)
            codes.slots.append(slots)
    return codes


def write_entropy_codes(w: BitWriter, codes: EntropyEncodingData) -> None:
    """Serialize the entropy-code header (inverse of decode_histograms)."""
    codes.lz77.write(w)
    if codes.lz77.enabled:
        write_uint_config(w, codes.lz77.length_uint_config, 8)
    num_contexts = len(codes.context_map)
    if num_contexts > 1:
        encode_context_map(w, codes.context_map, codes.num_histograms)
    w.write(1, 1 if codes.use_prefix_code else 0)
    if not codes.use_prefix_code:
        w.write(2, codes.log_alpha_size - 5)
    for cfg in codes.uint_configs:
        write_uint_config(w, cfg, codes.log_alpha_size
                          if not codes.use_prefix_code else PREFIX_MAX_BITS)
    if codes.use_prefix_code:
        for lengths in codes.prefix_lengths:
            n = len(_trim_back(np.asarray(lengths)))
            encode_varlen_uint16(w, max(n, 1) - 1)
        for lengths in codes.prefix_lengths:
            n = len(_trim_back(np.asarray(lengths)))
            if n > 1:
                write_prefix_code(w, np.asarray(lengths)[:n])
    else:
        for counts in codes.counts:
            write_histogram(w, list(counts), shift=codes.histo_shift)


def write_tokens_pretokenized(w: BitWriter, toks: np.ndarray,
                              nbits: np.ndarray, bits: np.ndarray,
                              codes: EntropyEncodingData,
                              histo: int = 0) -> None:
    """ANS emission for already-tokenized (token, nbits, bits) arrays in a
    single clustered context — the device-side tokenizer's output format."""
    n = len(toks)
    if n == 0:
        w.write(32, ANS_SIGNATURE << 16)
        return
    counts = codes.counts[histo]
    start = codes.slot_starts[histo]
    slots = codes.slots[histo]
    from jxlbench.ref.jxl.utils import native
    packed = native.ans_encode_stream(toks, nbits, bits, counts, start,
                                      slots)
    if packed is not None:
        data, total_bits = packed
        w.append_packed(data, total_bits)
        return
    state = ANS_SIGNATURE << 16
    rev_nbits: list[int] = []
    rev_bits: list[int] = []
    toks_l = toks.tolist()
    nbits_l = nbits.tolist()
    bits_l = bits.tolist()
    counts_l = counts.tolist() if hasattr(counts, "tolist") else list(counts)
    start_l = start.tolist()
    slots_l = slots.tolist()
    for i in range(n - 1, -1, -1):
        nb = nbits_l[i]
        if nb:
            rev_nbits.append(nb)
            rev_bits.append(bits_l[i])
        t = toks_l[i]
        freq = counts_l[t]
        if (state >> (32 - ANS_LOG_TAB_SIZE)) >= freq:
            rev_nbits.append(16)
            rev_bits.append(state & 0xFFFF)
            state >>= 16
        state = ((state // freq) << ANS_LOG_TAB_SIZE) + \
            slots_l[start_l[t] + state % freq]
    w.write(32, state)
    w.write_array(np.array(rev_nbits[::-1], dtype=np.int64),
                  np.array(rev_bits[::-1], dtype=np.uint64))


def build_entropy_codes_from_histogram(hist: np.ndarray
                                       ) -> EntropyEncodingData:
    """Single-context codes from a precomputed token histogram."""
    codes = EntropyEncodingData()
    codes.context_map = np.zeros(1, dtype=np.int32)
    codes.num_histograms = 1
    codes.uint_configs = [HybridUintConfig(4, 2, 0)]
    codes.log_alpha_size = 8
    h = _trim_back(np.asarray(hist, dtype=np.int64))
    if h.size == 0:
        h = np.array([1], dtype=np.int64)
    norm = normalize_counts(h)
    codes.counts.append(norm)
    start, slots = build_encoder_slots(norm, codes.log_alpha_size)
    codes.slot_starts.append(start)
    codes.slots.append(slots)
    return codes


def write_tokens(w: BitWriter, tokens: np.ndarray,
                 codes: EntropyEncodingData) -> None:
    """ANS/prefix token emission (enc_ans.cc:1237-1321)."""
    tokens = tokens_to_array(tokens)
    n = len(tokens)
    if n == 0 and not codes.use_prefix_code:
        w.write(32, ANS_SIGNATURE << 16)
        return
    ctxs = tokens[:, 0].astype(np.int64)
    histos = codes.context_map[ctxs]
    cfg = codes.uint_configs[0]
    if any(c != cfg for c in codes.uint_configs):
        # per-cluster hybrid-uint configs (ChooseUintConfigs result)
        toks = np.empty(n, np.int32)
        nbits = np.empty(n, np.int32)
        bits = np.empty(n, np.uint32)
        for h in np.unique(histos):
            m = histos == h
            t_, n_, b_ = _tokenize_rows(tokens[m],
                                        codes.uint_configs[int(h)],
                                        codes.lz77)
            toks[m], nbits[m], bits[m] = t_, n_, b_
    else:
        cached = getattr(codes, "_tok_cache", {}).get(id(tokens))
        # the cache holds the DEFAULT-config tokenization; a uniform
        # uint_search winner changes uint_configs[0] without tripping
        # the per-cluster branch above, so re-check the config
        if cached is not None and cached[0] is tokens and \
                cfg == getattr(codes, "_tok_cache_cfg", None):
            toks, nbits, bits = cached[1], cached[2], cached[3]
        else:
            toks, nbits, bits = _tokenize_rows(tokens, cfg, codes.lz77)
    if codes.use_prefix_code:
        # table-lookup form: pad per-histogram depth/bits tables to a
        # rectangle, then one fancy-indexed gather per stream
        amax = max(len(d) for d in codes.prefix_depths)
        dmat = np.zeros((len(codes.prefix_depths), amax), np.int64)
        bmat = np.zeros_like(dmat)
        for h, (dd, bb) in enumerate(zip(codes.prefix_depths,
                                         codes.prefix_bits)):
            dmat[h, :len(dd)] = np.asarray(dd, np.int64)
            bmat[h, :len(bb)] = np.asarray(bb, np.int64)
        depth = dmat[histos, toks]
        out_nbits = depth + nbits.astype(np.int64)
        out_bits = bmat[histos, toks].astype(np.uint64) | \
            (bits.astype(np.uint64) << depth.astype(np.uint64))
        w.write_array(out_nbits, out_bits)
        return
    from jxlbench.ref.jxl.utils import native
    res = native.ans_encode_multi(toks, histos, nbits, bits,
                                  codes.counts, codes.slot_starts,
                                  codes.slots)
    if res is not None:
        w.append_packed(*res)
        return
    # ANS: process tokens in reverse, emit state words; then write forward.
    state = ANS_SIGNATURE << 16
    rev_nbits: list[int] = []
    rev_bits: list[int] = []
    for i in range(n - 1, -1, -1):
        h = int(histos[i])
        t = int(toks[i])
        nb = int(nbits[i])
        if nb:
            rev_nbits.append(nb)
            rev_bits.append(int(bits[i]))
        freq = int(codes.counts[h][t])
        if (state >> (32 - ANS_LOG_TAB_SIZE)) >= freq:
            rev_nbits.append(16)
            rev_bits.append(state & 0xFFFF)
            state >>= 16
        start = codes.slot_starts[h]
        slots = codes.slots[h]
        state = ((state // freq) << ANS_LOG_TAB_SIZE) + \
            int(slots[int(start[t]) + state % freq])
    w.write(32, state)
    w.write_array(np.array(rev_nbits[::-1], dtype=np.int64),
                  np.array(rev_bits[::-1], dtype=np.uint64))


def build_prefix_codes_from_histogram(hist: np.ndarray
                                      ) -> EntropyEncodingData:
    """Single-context PREFIX (Brotli-style Huffman) codes from a token
    histogram — the device entropy-packing path (fjxl-like tradeoff:
    ~2-4% larger than ANS, but the packing parallelizes)."""
    codes = EntropyEncodingData()
    codes.use_prefix_code = True
    codes.context_map = np.zeros(1, dtype=np.int32)
    codes.num_histograms = 1
    codes.uint_configs = [HybridUintConfig(4, 2, 0)]
    codes.log_alpha_size = PREFIX_MAX_BITS
    h = _trim_back(np.asarray(hist, dtype=np.int64))
    if h.size == 0:
        h = np.array([1], dtype=np.int64)
    lengths = build_prefix_lengths(h)
    codes.prefix_lengths.append(lengths)
    mcodes = canonical_codes(lengths)
    codes.prefix_bits.append([(_reverse_bits(c, int(l)) if l else 0)
                              for c, l in zip(mcodes, lengths)])
    depths = np.asarray(lengths).copy()
    if np.count_nonzero(h) == 1:
        depths[:] = 0
    codes.prefix_depths.append(depths)
    codes.counts.append(h)
    return codes
