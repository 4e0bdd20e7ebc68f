// Host staging of the variable-block serving decode: the nonzero
// quantized AC coefficients of one frame, per AC strategy class, from
// the native AC decoder's run-packed groups. The same arrays, in the
// same order, as ``_var_classes`` in ``libjxl_torch/api/decoder.py``
// (its plain twin, which the tests hold this to bit for bit).
//
// Two passes, one thread each. ``jxlt_stage_count`` reads every
// coefficient once and gives each class's blocks, nonzeros and largest
// |value|, which size the output, and the nonzero mask of every run of
// 64 coefficients; the caller lays the arrays out (in a shared-memory
// segment in the decode pool's workers) and ``jxlt_stage_fill`` writes
// them in place, reading only the runs whose mask is not empty.
//
// A group is (bx0, by0, w, h) in blocks, its strategies ``acs`` and
// anchor flags ``anc`` as contiguous (h, w) int8 / uint8 planes, and its
// coefficients as a contiguous (3, len) int32 array: per channel, the
// group's anchor blocks in raster order, ``cover[s]`` values each (a
// multiple of 64). ``masks`` holds len / 64 words a channel, group after
// group. Built by g++ (``libjxl_torch/utils/host_stage.py``); plain C
// interface.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr int kClasses = 27;

struct Group {
  int64_t bx0, by0, w, h;
  const int8_t* acs;
  const uint8_t* anc;
  const int32_t* coef;
  int64_t len;
};

Group group_at(int64_t g, const int64_t* rects, const uintptr_t* acs,
               const uintptr_t* anc, const uintptr_t* coef,
               const int64_t* coef_len) {
  return Group{rects[4 * g], rects[4 * g + 1], rects[4 * g + 2],
               rects[4 * g + 3], reinterpret_cast<const int8_t*>(acs[g]),
               reinterpret_cast<const uint8_t*>(anc[g]),
               reinterpret_cast<const int32_t*>(coef[g]), coef_len[g]};
}

// Bit j set where p[j] != 0, for j < 64.
inline uint64_t nonzero_mask(const int32_t* p) {
#if defined(__AVX2__)
  const __m256i zero = _mm256_setzero_si256();
  uint64_t eq = 0;
  for (int j = 0; j < 8; ++j) {
    const __m256i v =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(p + 8 * j));
    const int m = _mm256_movemask_ps(
        _mm256_castsi256_ps(_mm256_cmpeq_epi32(v, zero)));
    eq |= static_cast<uint64_t>(m) << (8 * j);
  }
  return ~eq;
#else
  uint64_t mask = 0;
  for (int j = 0; j < 64; ++j) {
    mask |= static_cast<uint64_t>(p[j] != 0) << j;
  }
  return mask;
#endif
}

// max |p[j]| for j < 64 (|INT32_MIN| is 2^31).
inline int64_t max_abs(const int32_t* p) {
#if defined(__AVX2__)
  __m256i m = _mm256_setzero_si256();
  for (int j = 0; j < 8; ++j) {
    const __m256i v =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(p + 8 * j));
    m = _mm256_max_epu32(m, _mm256_abs_epi32(v));
  }
  alignas(32) uint32_t lanes[8];
  _mm256_store_si256(reinterpret_cast<__m256i*>(lanes), m);
  uint32_t mx = 0;
  for (uint32_t x : lanes) mx = x > mx ? x : mx;
  return mx;
#else
  int64_t mx = 0;
  for (int j = 0; j < 64; ++j) {
    const int64_t v = p[j];
    const int64_t a = v < 0 ? -v : v;
    mx = a > mx ? a : mx;
  }
  return mx;
#endif
}

// Whether every class covers a whole number of 64-value runs.
bool covers_ok(const int64_t* cover) {
  for (int s = 0; s < kClasses; ++s) {
    if (cover[s] <= 0 || cover[s] % 64) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// counts: (27, 3) int64 out: blocks, nonzeros, max |value| per class;
// masks out (see above). Returns 0, -1 for a strategy outside 0..26, -2
// where a group's anchor blocks do not cover its coefficient run
// exactly, -3 for a ``cover`` that is not a positive multiple of 64.
int64_t jxlt_stage_count(int64_t n, const int64_t* rects,
                         const uintptr_t* acs, const uintptr_t* anc,
                         const uintptr_t* coef, const int64_t* coef_len,
                         const int64_t* cover, int64_t* counts,
                         uint64_t* masks) {
  for (int s = 0; s < 3 * kClasses; ++s) counts[s] = 0;
  if (!covers_ok(cover)) return -3;
  for (int64_t g = 0; g < n; ++g) {
    const Group gr = group_at(g, rects, acs, anc, coef, coef_len);
    if (gr.len % 64) return -2;
    int64_t off = 0;
    for (int64_t y = 0; y < gr.h; ++y) {
      for (int64_t x = 0; x < gr.w; ++x) {
        if (!gr.anc[y * gr.w + x]) continue;
        const int s = gr.acs[y * gr.w + x];
        if (s < 0 || s >= kClasses) return -1;
        const int64_t cov = cover[s];
        if (off + cov > gr.len) return -2;
        int64_t nz = 0, mx = counts[3 * s + 2];
        for (int c = 0; c < 3; ++c) {
          const int32_t* p = gr.coef + c * gr.len + off;
          uint64_t* m = masks + (c * gr.len + off) / 64;
          for (int64_t k0 = 0; k0 < cov; k0 += 64) {
            const uint64_t mask = nonzero_mask(p + k0);
            m[k0 / 64] = mask;
            if (!mask) continue;
            nz += __builtin_popcountll(mask);
            const int64_t a = max_abs(p + k0);
            mx = a > mx ? a : mx;
          }
        }
        counts[3 * s] += 1;
        counts[3 * s + 1] += nz;
        counts[3 * s + 2] = mx;
        off += cov;
      }
    }
    if (off != gr.len) return -2;
    masks += 3 * gr.len / 64;
  }
  return 0;
}

// outs: (27, 5) pointers per class (vals, idx, qf, fy, fx), null for a
// class without blocks; vals are int16 where the class's max |value|
// from ``counts`` is at most 32767, else int32. idx int64, the rest
// int32. raw_quant: (rows, cols) int32, row stride ``rq_stride``.
// ``masks`` as jxlt_stage_count left them. Returns 0, -1 to -3 as
// jxlt_stage_count, -4 for a block outside raw_quant, -5 where the
// groups disagree with ``counts``.
int64_t jxlt_stage_fill(int64_t n, const int64_t* rects,
                        const uintptr_t* acs, const uintptr_t* anc,
                        const uintptr_t* coef, const int64_t* coef_len,
                        const int64_t* cover, const int64_t* counts,
                        const uint64_t* masks, const int32_t* raw_quant,
                        int64_t rq_rows, int64_t rq_cols, int64_t rq_stride,
                        const uintptr_t* outs) {
  int16_t* v16[kClasses];
  int32_t* v32[kClasses];
  int64_t* idx[kClasses];
  int32_t *qf[kClasses], *fy[kClasses], *fx[kClasses];
  int64_t rank[kClasses] = {0}, cur[kClasses] = {0};
  if (!covers_ok(cover)) return -3;
  for (int s = 0; s < kClasses; ++s) {
    const bool wide = counts[3 * s + 2] > 32767;
    v16[s] = wide ? nullptr : reinterpret_cast<int16_t*>(outs[5 * s]);
    v32[s] = wide ? reinterpret_cast<int32_t*>(outs[5 * s]) : nullptr;
    idx[s] = reinterpret_cast<int64_t*>(outs[5 * s + 1]);
    qf[s] = reinterpret_cast<int32_t*>(outs[5 * s + 2]);
    fy[s] = reinterpret_cast<int32_t*>(outs[5 * s + 3]);
    fx[s] = reinterpret_cast<int32_t*>(outs[5 * s + 4]);
  }
  struct Block {
    int s;
    int64_t off, cov, rank;
  };
  std::vector<Block> blocks;
  for (int64_t g = 0; g < n; ++g) {
    const Group gr = group_at(g, rects, acs, anc, coef, coef_len);
    if (gr.len % 64) return -2;
    // the group's anchor blocks in raster order, each numbered within
    // its class in the frame's block order
    blocks.clear();
    int64_t off = 0;
    for (int64_t y = 0; y < gr.h; ++y) {
      for (int64_t x = 0; x < gr.w; ++x) {
        if (!gr.anc[y * gr.w + x]) continue;
        const int s = gr.acs[y * gr.w + x];
        if (s < 0 || s >= kClasses) return -1;
        const int64_t cov = cover[s];
        if (off + cov > gr.len) return -2;
        const int64_t by = gr.by0 + y, bx = gr.bx0 + x;
        if (by < 0 || by >= rq_rows || bx < 0 || bx >= rq_cols) return -4;
        const int64_t r = rank[s]++;
        if (r >= counts[3 * s]) return -5;
        qf[s][r] = raw_quant[by * rq_stride + bx];
        fy[s][r] = static_cast<int32_t>(by);
        fx[s][r] = static_cast<int32_t>(bx);
        blocks.push_back(Block{s, off, cov, r});
        off += cov;
      }
    }
    if (off != gr.len) return -2;
    // nonzeros channel by channel, each in the run's order, by the bits
    // of the runs' masks
    for (int c = 0; c < 3; ++c) {
      const int32_t* row = gr.coef + c * gr.len;
      const uint64_t* mrow = masks + c * gr.len / 64;
      for (const Block& b : blocks) {
        const int s = b.s;
        int64_t i = cur[s];
        for (int64_t k0 = 0; k0 < b.cov; k0 += 64) {
          uint64_t mask = mrow[(b.off + k0) / 64];
          if (!mask) continue;
          if (i + __builtin_popcountll(mask) > counts[3 * s + 1]) return -5;
          const int32_t* p = row + b.off + k0;
          const int64_t base = (b.rank * 3 + c) * b.cov + k0;
          while (mask) {
            const int j = __builtin_ctzll(mask);
            mask &= mask - 1;
            if (v16[s]) {
              v16[s][i] = static_cast<int16_t>(p[j]);
            } else {
              v32[s][i] = p[j];
            }
            idx[s][i++] = base + j;
          }
        }
        cur[s] = i;
      }
    }
    masks += 3 * gr.len / 64;
  }
  for (int s = 0; s < kClasses; ++s) {
    if (rank[s] != counts[3 * s] || cur[s] != counts[3 * s + 1]) return -5;
  }
  return 0;
}

// AC token decode of a one-pass frame with subsampled chroma, every
// block DCT8 (a recompressed JPEG's frame), straight into dense int16
// coefficient planes: channel c is a (fhb >> vs[c], fwb >> hs[c], 64)
// array, each block's 64 values in the stored (transposed) layout that
// the coefficient order names. The token loop of DecodeACVarBlock
// (dec_group.cc:470-545) as ``native/jxl_host.cc``'s
// jxlt_ac_frame_decode runs it, with a block grid per channel: the luma
// blocks of a group go in raster order, and at each the channels Y, X,
// B, a subsampled channel's block only where the luma position is a
// multiple of its sampling (dec_group.cc:370-376); each channel predicts
// its nonzero count from its own grid, and reads the block context of
// the luma position (``plain twin``: the Python path of
// ``vardct/frame_dec.py`` decode_ac_group, in JPEG mode).
//
// sec_off/sec_len/start_bit: each group's AC section in ``data``;
// rects (n, 4): bx0, by0, w, h in luma blocks; the entropy tables, the
// context map and the (3, fhb, fwb) block contexts as the frame decode
// takes them; ``orders`` and ``order_off`` the coefficient orders
// (DCT8's are at order_off[c]); planes: 3 int16 pointers. Groups run on
// ``n_threads`` threads. Returns 0, or the first error: -1 checksum,
// -2 corrupt token, -3 invalid nonzero count, -4 overrun, -6 a value
// outside int16.
namespace {

constexpr uint32_t kAnsTabSize = 1u << 12;
constexpr uint32_t kAnsSignature = 0x13;

// kCoeffFreqContext / kCoeffNumNonzeroContext (ac_context.h:28-48)
const uint8_t kCoeffFreqCtx[64] = {
    0xBA, 0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14,
    15, 15, 16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 23, 23, 24, 24, 24, 24, 25, 25, 25, 25, 26, 26, 26, 26,
    27, 27, 27, 27, 28, 28, 28, 28, 29, 29, 29, 29, 30, 30, 30, 30};
const uint8_t kCoeffNumNonzeroCtx[64] = {
    0xBA, 0,   31,  62,  62,  93,  93,  93,  93,  123, 123, 123, 123,
    152,  152, 152, 152, 152, 152, 152, 152, 180, 180, 180, 180, 180,
    180,  180, 180, 180, 180, 180, 180, 206, 206, 206, 206, 206, 206,
    206,  206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206,
    206,  206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206};

struct Ans {
  const uint8_t* data;
  int64_t nbytes;
  int64_t bitpos;
  uint32_t state = 0;
  bool overflow = false;

  uint64_t Read(int nbits) {
    if (nbits == 0) return 0;
    const int64_t byte = bitpos >> 3;
    if ((bitpos + nbits + 7) / 8 > nbytes) {
      overflow = true;
      return 0;
    }
    uint64_t v = 0;
    const int64_t avail = nbytes - byte;
    memcpy(&v, data + byte, avail >= 8 ? 8 : avail);
    v >>= (bitpos & 7);
    bitpos += nbits;
    return v & ((1ull << nbits) - 1);
  }
};

struct Tables {
  const int32_t *alias_sym, *alias_off, *freqs, *uint_cfg, *ctx_map;
  int64_t n_ctx;
  int32_t num_ctxs;
};

// One hybrid uint of context ``ctx``, or -2 for a corrupt token.
inline int64_t read_uint(Ans& a, const Tables& t, int64_t ctx) {
  const int h = t.ctx_map[ctx];
  const uint32_t res = a.state & (kAnsTabSize - 1);
  const uint32_t tok = static_cast<uint32_t>(t.alias_sym[h * 4096 + res]);
  a.state = static_cast<uint32_t>(t.freqs[h * 256 + tok]) * (a.state >> 12) +
            static_cast<uint32_t>(t.alias_off[h * 4096 + res]);
  if (a.state < (1u << 16)) {
    a.state = (a.state << 16) | static_cast<uint32_t>(a.Read(16));
  }
  const int se = t.uint_cfg[h * 3], msb = t.uint_cfg[h * 3 + 1],
            lsb = t.uint_cfg[h * 3 + 2];
  const uint32_t split = 1u << se;
  if (tok < split) return tok;
  const uint32_t nb = se - (msb + lsb) + ((tok - split) >> (msb + lsb));
  if (nb > 31) return -2;
  const uint32_t low = tok & ((1u << lsb) - 1);
  const uint32_t t2 = tok >> lsb;
  const uint64_t extra = a.Read(static_cast<int>(nb));
  return static_cast<int64_t>(
      ((((((1ull << msb) | (t2 & ((1u << msb) - 1))) << nb) | extra)
        << lsb) |
       low));
}

int64_t decode_group_subsampled(
    Ans& a, const Tables& t, int32_t ctx_offset, const int64_t* rect,
    const int32_t* block_ctx3, int64_t fwb, int64_t fhb,
    const int32_t* orders, const int64_t* order_off, const int32_t* hs,
    const int32_t* vs, int16_t* const* planes) {
  const int64_t bx0 = rect[0], by0 = rect[1], gw = rect[2], gh = rect[3];
  std::vector<int32_t> nz[3];
  int64_t nzw[3];
  for (int c = 0; c < 3; ++c) {
    nzw[c] = gw >> hs[c];
    nz[c].assign(static_cast<size_t>((gh >> vs[c]) * nzw[c]), 0);
  }
  static const int kChanOrder[3] = {1, 0, 2};
  for (int64_t by = 0; by < gh; ++by) {
    for (int64_t bx = 0; bx < gw; ++bx) {
      for (int ci = 0; ci < 3; ++ci) {
        const int c = kChanOrder[ci];
        if (((bx >> hs[c]) << hs[c]) != bx || ((by >> vs[c]) << vs[c]) != by)
          continue;
        const int64_t x = bx >> hs[c], y = by >> vs[c];
        int32_t* nzp = nz[c].data();
        int predicted;
        if (x == 0) {
          predicted = y > 0 ? nzp[(y - 1) * nzw[c]] : 32;
        } else if (y == 0) {
          predicted = nzp[x - 1];
        } else {
          predicted = (nzp[(y - 1) * nzw[c] + x] + nzp[y * nzw[c] + x - 1] +
                       1) / 2;
        }
        if (predicted > 64) predicted = 64;
        const int64_t fy = by0 + by, fx = bx0 + bx;
        const int block_ctx = block_ctx3[(c * fhb + fy) * fwb + fx];
        const int nz_small = predicted < 8 ? predicted : 4 + predicted / 2;
        const int64_t nzero_ctx =
            ctx_offset + static_cast<int64_t>(nz_small) * t.num_ctxs +
            block_ctx;
        if (nzero_ctx >= t.n_ctx) return -2;
        int64_t nzeros = read_uint(a, t, nzero_ctx);
        if (nzeros < 0 || nzeros > 63) return -3;
        nzp[y * nzw[c] + x] = static_cast<int32_t>(nzeros);
        const int64_t pw = fwb >> hs[c];
        int16_t* out = planes[c] + (((fy >> vs[c]) * pw) + (fx >> hs[c])) * 64;
        memset(out, 0, 64 * sizeof(int16_t));
        const int64_t histo_off = ctx_offset + t.num_ctxs * 37 +
                                  458 * static_cast<int64_t>(block_ctx);
        const int32_t* order = orders + order_off[c];
        int prev = nzeros > 4 ? 0 : 1;
        for (int k = 1; k < 64 && nzeros != 0; ++k) {
          const int64_t ctx =
              histo_off +
              (kCoeffNumNonzeroCtx[nzeros] + kCoeffFreqCtx[k]) * 2 + prev;
          if (ctx >= t.n_ctx) return -2;
          const int64_t u = read_uint(a, t, ctx);
          if (u < 0) return -2;
          const int64_t coeff = (u & 1) ? -(u >> 1) - 1 : (u >> 1);
          const int32_t pos = order[k];
          if (pos < 0 || pos >= 64) return -2;
          if (coeff < -32768 || coeff > 32767) return -6;
          out[pos] = static_cast<int16_t>(coeff);
          prev = u != 0;
          nzeros -= prev;
        }
        if (nzeros != 0) return -3;
      }
    }
  }
  return 0;
}

}  // namespace

int64_t jxlt_ac_decode_subsampled(
    const uint8_t* data, const int64_t* sec_off, const int64_t* sec_len,
    const int64_t* start_bit, int64_t n_groups, const int64_t* rects,
    const int32_t* alias_sym, const int32_t* alias_off, const int32_t* freqs,
    const int32_t* uint_cfg, const int32_t* ctx_map, int64_t n_ctx,
    int32_t selector_bits, int32_t num_histograms, int32_t num_ac_ctxs,
    int32_t num_ctxs, const int32_t* block_ctx3, int64_t fwb, int64_t fhb,
    const int32_t* orders, const int64_t* order_off, const int32_t* hs,
    const int32_t* vs, const uintptr_t* planes, int32_t n_threads) {
  const Tables t{alias_sym, alias_off, freqs, uint_cfg, ctx_map, n_ctx,
                 num_ctxs};
  int16_t* const out[3] = {reinterpret_cast<int16_t*>(planes[0]),
                           reinterpret_cast<int16_t*>(planes[1]),
                           reinterpret_cast<int16_t*>(planes[2])};
  std::atomic<int64_t> next(0), err(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t g = next.fetch_add(1);
      if (g >= n_groups) return;
      Ans a{data + sec_off[g], sec_len[g], start_bit[g]};
      // the histogram selector precedes the ANS state (dec_frame.cc:481)
      const int64_t sel = selector_bits ? a.Read(selector_bits) : 0;
      int64_t res = -4;
      if (!a.overflow && sel < num_histograms) {
        a.state = static_cast<uint32_t>(a.Read(32));
        res = decode_group_subsampled(
            a, t, static_cast<int32_t>(sel * num_ac_ctxs), rects + 4 * g,
            block_ctx3, fwb, fhb, orders, order_off, hs, vs, out);
        if (res == 0 && a.overflow) res = -4;
        if (res == 0 && a.state != (kAnsSignature << 16)) res = -1;
      }
      if (res < 0) {
        int64_t expected = 0;
        err.compare_exchange_strong(expected, res);
      }
    }
  };
  const int64_t nt = n_threads < n_groups ? n_threads : n_groups;
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int64_t i = 0; i < nt; ++i) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return err.load();
}

}  // extern "C"
