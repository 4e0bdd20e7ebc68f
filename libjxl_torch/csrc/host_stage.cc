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

#include <cstdint>
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

}  // extern "C"
