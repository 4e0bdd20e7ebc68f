// Restoration filters of the VarDCT decode on Hopper (sm_90a): Gaborish
// and the edge-preserving filter (EPF) passes 0, 1 and 2.
//
// Replaces the Pallas TPU kernels libjxl_tpu/models/pallas_filters.py:72
// (_gab_kernel) and :85 (_epf_kernel), reached through restore_pallas.
// Same contract as their plain versions (libjxl_torch/models/
// filter_kernels.py): x is a (3, H, W) float32 XYB image, the image edge
// is mirrored with edge duplication (numpy "symmetric", reflecting again
// when the reach exceeds the size), and EPF reads 1/sigma per 8x8 block.
//
// The least a pass can take is set by memory: it reads 3 float32 planes
// and writes 3 (plus the small per-block sigma field), so a 3840x2160
// frame moves 199 MB a pass, 59 us at the card's 3.35 TB/s. Each byte of
// device memory is read once; the stencil's re-reads stay on chip. The
// block-border SAD multiplier comes from the global coordinates (y % 8,
// x % 8 in {0, 7}), and 1/sigma from the block (y >> 3, x >> 3): nothing
// per pixel is read besides the image.
//
// Gaborish and EPF2 (gab_kernel, epf2_kernel), memory-bound: a block of
// 256 threads owns one 32x32 output tile, loads it plus its halo (1
// pixel) for all three channels into shared memory, resolving the mirror
// by index arithmetic on each load, and computes 4 output pixels a
// thread.
//
// EPF0 and EPF1 (epf_plus_kernel): the plus-shaped SADs need 5
// abs-diffs per neighbour and pixel, so the arithmetic and the on-chip
// traffic, not device memory, set the pace (12 neighbours for EPF0). The
// design cuts both:
//   - neighbours come in pairs (n, -n), and D_n(q) = sum_c s_c
//     |x_c(q + n) - x_c(q)| gives D_{-n}(q) = D_n(q - n) bit for bit, so
//     one scaled abs-diff per pair and pixel (6 for EPF0, 2 for EPF1)
//     carries all the SADs: the SAD of -n at p is the plus box of D_n at
//     p - n;
//   - a block of 4 warps stages its tile (rows and columns plus the reach
//     on each side, 3 channels, and the 1/sigma of its 8x8 blocks) in
//     shared memory with cp.async, a warp per row, in 16-byte pieces
//     where the rows are aligned, and meets its one barrier. Only a tile
//     that reaches past the frame's edge resolves the mirror, once a row
//     and once a column;
//   - a warp then owns a strip of 32 columns, one per lane, and walks
//     down its rows (32 for EPF0, 16 for EPF1). Each lane keeps its
//     column's x, the D of each pair and the plus boxes P of the last
//     rows in register rings: the vertical taps are registers, the
//     horizontal ones come from the neighbouring lanes by shuffle (x of
//     the columns +-1 and +-2 once a row, D(c +- 1) for the box, P(c - dx)
//     for a -n neighbour). No barrier follows the first;
//   - the lanes at the warp's edge lack their outer neighbours' values,
//     so a strip outputs 32 - 2 reach columns (26 for EPF0, 28 for
//     EPF1): 23% and 14% more lane work than output pixels. A block's
//     tile is 28% (EPF0) and 34% (EPF1) larger than its output, the
//     reach on each side and the aligned pieces' slack, re-read from L2;
//   - the plus box keeps the reference's tap order (0,-1), (-1,0),
//     (0,0), (1,0), (0,1) and the weighted sum its neighbour order; the
//     mean multiplies by the reciprocal of the weight sum.
// The TPU kernels padded their halos to (8, 128) tiles for Mosaic and
// took a per-pixel sigma plane; neither is needed here. One launch per
// pass, as in the reference; fusing the passes is left for later.

#include <cuda_runtime.h>

namespace {

constexpr int kTW = 32;                  // tile width (one warp per row)
constexpr int kTH = 32;                  // tile height
constexpr int kRowsPerThread = kTH / 8;  // blockDim = (32, 8)
constexpr float kMinSigma = -3.90524291751269967465540850526868f;

struct GabWeights {
  float w0[3], w1[3], w2[3];
};

struct EpfParams {
  float scale[3];
  float sm, bsm;
};

// numpy "symmetric" padding: the reflection has period 2n.
__device__ __forceinline__ int mirror(int i, int n) {
  const int p = 2 * n;
  int m = i % p;
  if (m < 0) m += p;
  return m < n ? m : p - 1 - m;
}

// Tile + halo of R pixels, all 3 channels: s[(c * SH + r) * SW + col].
template <int R>
__device__ __forceinline__ void load_tile(const float* __restrict__ x,
                                          float* s, int h, int w, int y0,
                                          int x0) {
  constexpr int SH = kTH + 2 * R, SW = kTW + 2 * R;
  const long long plane = (long long)h * w;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < SH * SW; i += blockDim.x * blockDim.y) {
    const int r = i / SW, c = i - r * SW;
    const long long off =
        (long long)mirror(y0 - R + r, h) * w + mirror(x0 - R + c, w);
    s[i] = x[off];
    s[SH * SW + i] = x[plane + off];
    s[2 * SH * SW + i] = x[2 * plane + off];
  }
}

__global__ void __launch_bounds__(256)
gab_kernel(const float* __restrict__ x, float* __restrict__ out, int h,
           int w, GabWeights g) {
  constexpr int R = 1, SH = kTH + 2 * R, SW = kTW + 2 * R;
  __shared__ float s[3 * SH * SW];
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  load_tile<R>(x, s, h, w, y0, x0);
  __syncthreads();
  const long long plane = (long long)h * w;
  const int lx = threadIdx.x, gx = x0 + lx;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int ly = threadIdx.y + 8 * k, gy = y0 + ly;
    if (gy >= h || gx >= w) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* t = s + c * SH * SW + (ly + R) * SW + lx + R;
      const float edge = ((t[-SW] + t[SW]) + t[-1]) + t[1];
      const float diag = ((t[-SW - 1] + t[-SW + 1]) + t[SW - 1]) + t[SW + 1];
      out[c * plane + (long long)gy * w + gx] =
          (g.w0[c] * t[0] + g.w1[c] * edge) + g.w2[c] * diag;
    }
  }
}

// Neighbour offsets (dx, dy) of EPF pass 2, in the reference's order.
__constant__ int kN2[4][2] = {{0, -1}, {-1, 0}, {1, 0}, {0, 1}};

__global__ void __launch_bounds__(256)
epf2_kernel(const float* __restrict__ x, const float* __restrict__ inv_sigma,
            float* __restrict__ out, int h, int w, int sigma_w, EpfParams e) {
  constexpr int R = 1, SH = kTH + 2 * R, SW = kTW + 2 * R;
  __shared__ float s[3 * SH * SW];
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  load_tile<R>(x, s, h, w, y0, x0);
  __syncthreads();

  const int lx = threadIdx.x, gx = x0 + lx;
  float acc[kRowsPerThread][3], wsum[kRowsPerThread], isig[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int ly = threadIdx.y + 8 * k, gy = y0 + ly;
    const int o = (ly + R) * SW + lx + R;
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[k][c] = s[c * SH * SW + o];
    wsum[k] = 1.f;
    isig[k] = 0.f;
    if (gy < h && gx < w) {
      const bool border = ((gy & 7) == 0) | ((gy & 7) == 7) |
                          ((gx & 7) == 0) | ((gx & 7) == 7);
      isig[k] = inv_sigma[(gy >> 3) * sigma_w + (gx >> 3)] *
                (border ? e.bsm : e.sm);
    }
  }

  for (int n = 0; n < 4; ++n) {
    const int dx = kN2[n][0], dy = kN2[n][1];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int ly = threadIdx.y + 8 * k;
      const int o = (ly + R) * SW + lx + R;
      const int on = o + dy * SW + dx;
      const float sad =
          (e.scale[0] * fabsf(s[on] - s[o]) +
           e.scale[1] * fabsf(s[SH * SW + on] - s[SH * SW + o])) +
          e.scale[2] * fabsf(s[2 * SH * SW + on] - s[2 * SH * SW + o]);
      const float weight = fmaxf(1.f + sad * isig[k], 0.f);
      wsum[k] += weight;
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[k][c] += weight * s[c * SH * SW + on];
    }
  }

  const long long plane = (long long)h * w;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int ly = threadIdx.y + 8 * k, gy = y0 + ly;
    if (gy >= h || gx >= w) continue;
    const bool skip = inv_sigma[(gy >> 3) * sigma_w + (gx >> 3)] < kMinSigma;
    const int o = (ly + R) * SW + lx + R;
    const long long g = (long long)gy * w + gx;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[c * plane + g] = skip ? s[c * SH * SW + o] : acc[k][c] / wsum[k];
  }
}

// Neighbours (dx, dy) of EPF passes 0 and 1 in the reference's order
// (render/filters.py:73-76). Of a pass's 2m neighbours, i and 2m-1-i are
// each other's negatives: pair k is n+ = neighbour 2m-1-k and -n+ =
// neighbour k.
__host__ __device__ constexpr int plus_nb(int pass, int i, int axis) {
  constexpr int n0[12][2] = {{0, -2}, {-1, -1}, {0, -1}, {1, -1},
                             {-2, 0}, {-1, 0},  {1, 0},  {2, 0},
                             {-1, 1}, {0, 1},   {1, 1},  {0, 2}};
  constexpr int n1[4][2] = {{0, -1}, {-1, 0}, {1, 0}, {0, 1}};
  return pass == 0 ? n0[i][axis] : n1[i][axis];
}

constexpr int kWarps = 4;   // warps of a block, their strips side by side
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ constexpr int plus_reach(int pass) {
  return pass == 0 ? 3 : 2;
}

// Output rows a warp walks down its strip.
__host__ __device__ constexpr int plus_run(int pass) {
  return pass == 0 ? 32 : 16;
}

// Output columns of a warp's 32-lane strip.
__host__ __device__ constexpr int plus_cols(int pass) {
  return 32 - 2 * plus_reach(pass);
}

// The block's staged tile: its strips' rows and columns plus the reach
// on each side, 3 channels. Its first column is x0 - 4, a multiple of 4
// (4 - reach columns before the first one read), so that rows of a frame
// whose width is a multiple of 4 copy in 16-byte pieces; a row holds
// plus_tile_stride columns, a multiple of 4. After it, the 1/sigma of
// the 8x8 blocks of the block's output: plus_run / 8 rows of
// plus_sig_cols.
__host__ __device__ constexpr int plus_tile_rows(int pass) {
  return plus_run(pass) + 2 * plus_reach(pass);
}
__host__ __device__ constexpr int plus_tile_stride(int pass) {
  return (kWarps * plus_cols(pass) + 8 + 3) / 4 * 4;
}
__host__ __device__ constexpr int plus_sig_cols(int pass) {
  return kWarps * plus_cols(pass) / 8;
}
constexpr int plus_tile_bytes(int pass) {
  return (3 * plus_tile_rows(pass) * plus_tile_stride(pass) +
          plus_run(pass) / 8 * plus_sig_cols(pass)) * 4;
}

// Asynchronous copies from device to shared memory (cp.async).
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// The ring offset (rows above the newest) at which a pass first reads x
// of the lane dx columns away: D of pair n+ = (dx, dy) reads it at
// DY - dy, the weighted sum of neighbour (dx, dy) at DY + 1 - dy. 2 DY + 2
// where it is never read.
__host__ __device__ constexpr int first_read(int pass, int dx) {
  const int m = pass == 0 ? 6 : 2, dy_max = pass == 0 ? 2 : 1;
  int f = 2 * dy_max + 2;
  for (int i = 0; i < 2 * m; ++i) {
    if (plus_nb(pass, i, 0) != dx) continue;
    const int o = dy_max + (i < m ? 1 : 0) - plus_nb(pass, i, 1);
    f = o < f ? o : f;
  }
  return f;
}

// v of the lane d columns to the right (d < 0: to the left). A lane with
// no such lane gets its own v back; those lanes output nothing.
__device__ __forceinline__ float lane_at(float v, int d) {
  return d > 0 ? __shfl_down_sync(kAll, v, d)
         : d < 0 ? __shfl_up_sync(kAll, v, -d) : v;
}

template <int PASS>
__global__ void __launch_bounds__(32 * kWarps)
epf_plus_kernel(const float* __restrict__ x,
                const float* __restrict__ inv_sigma, float* __restrict__ out,
                int h, int w, int sigma_w, EpfParams e) {
  constexpr int NN = PASS == 0 ? 12 : 4, NP = NN / 2;  // neighbours, pairs
  constexpr int DY = PASS == 0 ? 2 : 1;                 // largest |dy|
  constexpr int R = plus_reach(PASS), OW = plus_cols(PASS);
  constexpr int RUN = plus_run(PASS), TR = plus_tile_rows(PASS);
  constexpr int TS = plus_tile_stride(PASS), SC = plus_sig_cols(PASS);
  constexpr int XR = 2 * DY + 2;                        // rows of x held
  constexpr int kFirst[4] = {first_read(PASS, -2), first_read(PASS, -1),
                             first_read(PASS, 1), first_read(PASS, 2)};
  static_assert(RUN % 8 == 0 && kWarps * OW % 8 == 0,
                "a block's output starts on an 8x8 block");
  extern __shared__ float tile[];              // [3][TR][TS], [RUN / 8][SC]
  float* const sig = tile + 3 * TR * TS;
  const int y0 = blockIdx.y * RUN, x0 = blockIdx.x * kWarps * OW;
  const int xa = x0 - 4;                                // tile column 0
  const long long plane = (long long)h * w;

  // Stage rows y0 - R .. y0 + RUN + R - 1, columns xa .. xa + TS - 1:
  // a warp copies a row, its lanes consecutive pieces. A tile inside the
  // frame copies 16-byte pieces when the rows are 16-byte aligned; only a
  // tile that reaches past an edge resolves the mirror, once a row and
  // once a column.
  const int lane = threadIdx.x, tid = threadIdx.y * 32 + lane;
  if (y0 >= R && y0 + RUN + R <= h && xa >= 0 && xa + TS <= w &&
      (w & 3) == 0) {
    for (int rr = threadIdx.y; rr < 3 * TR; rr += kWarps) {
      const int ch = rr / TR, gy = y0 - R + rr - ch * TR;
      const float* src = x + ch * plane + (long long)gy * w + xa;
      for (int q = 4 * lane; q < TS; q += 128)
        copy16(tile + rr * TS + q, src + q);
    }
  } else {
    int gx[(TS + 31) / 32];
#pragma unroll
    for (int k = 0; k < (TS + 31) / 32; ++k)
      gx[k] = mirror(xa + lane + 32 * k, w);
    for (int rr = threadIdx.y; rr < 3 * TR; rr += kWarps) {
      const int ch = rr / TR, gy = mirror(y0 - R + rr - ch * TR, h);
      const float* src = x + ch * plane + (long long)gy * w;
#pragma unroll
      for (int k = 0; k < (TS + 31) / 32; ++k) {
        if (lane + 32 * k < TS)
          copy4(tile + rr * TS + lane + 32 * k, src + gx[k]);
      }
    }
  }
  // 1/sigma of the blocks (y0 / 8 + i, x0 / 8 + j) the frame has
  for (int i = tid; i < RUN / 8 * SC; i += 32 * kWarps) {
    const int by = y0 / 8 + i / SC, bx = x0 / 8 + i % SC;
    if (8 * by < h && 8 * bx < w)
      copy4(sig + i, inv_sigma + by * sigma_w + bx);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int strip = blockIdx.x * kWarps + threadIdx.y;
  if (strip * OW >= w) return;                  // the whole warp
  const int c = strip * OW - R + lane, steps = min(RUN, h - y0) + XR;
  const float* tc = tile + 4 - R + threadIdx.y * OW + lane;   // column c
  const bool owner = lane >= R && lane < 32 - R && c < w;
  const bool xborder = ((c & 7) == 0) | ((c & 7) == 7);

  // Rings, by rows above the newest input row rho = y0 - R + s (tile row
  // s): X[o] = x(rho - o, c) and XN[j][o] = x(rho - o, c + dx_j), dx_j =
  // -2, -1, 1, 2; D[k][o] = D of pair k at (rho - DY - o, c); P[k][o] =
  // its plus box at (rho - DY - 1 - o, c). Step s outputs y = rho - R.
  float X[XR][3] = {}, XN[4][XR][3] = {};
  float D[NP][3] = {}, P[NP][DY + 1] = {};
  auto xat = [&](int o, int dx, int ch) {       // x(rho - o, c + dx)
    return dx == 0 ? X[o][ch] : XN[dx < 0 ? dx + 2 : dx + 1][o][ch];
  };

#pragma unroll 4
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int o = XR - 1; o > 0; --o) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        X[o][ch] = X[o - 1][ch];
#pragma unroll
        for (int j = 0; j < 4; ++j) XN[j][o][ch] = XN[j][o - 1][ch];
      }
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) X[0][ch] = tc[(ch * TR + s) * TS];
    // the neighbouring columns' x: one shuffle a row, where first read
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (kFirst[j] < XR) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          XN[j][kFirst[j]][ch] =
              lane_at(X[kFirst[j]][ch], j < 2 ? j - 2 : j - 1);
      }
    }
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      // D of pair k at d = rho - DY: sum_c s_c |x(d + n+) - x(d)|
      const int dx = plus_nb(PASS, NN - 1 - k, 0);
      const int dy = plus_nb(PASS, NN - 1 - k, 1);
      D[k][2] = D[k][1];
      D[k][1] = D[k][0];
      D[k][0] = (e.scale[0] * fabsf(xat(DY - dy, dx, 0) - X[DY][0]) +
                 e.scale[1] * fabsf(xat(DY - dy, dx, 1) - X[DY][1])) +
                e.scale[2] * fabsf(xat(DY - dy, dx, 2) - X[DY][2]);
      // its plus box at d - 1, taps (0,-1), (-1,0), (0,0), (1,0), (0,1)
#pragma unroll
      for (int o = DY; o > 0; --o) P[k][o] = P[k][o - 1];
      P[k][0] = (((D[k][2] + lane_at(D[k][1], -1)) + D[k][1]) +
                 lane_at(D[k][1], 1)) + D[k][0];
    }
    if (s < XR) continue;                       // above the run

    const int y = y0 - 2 * R + s;
    float inv = 0.f, isig = 0.f;
    if (owner) {
      inv = sig[((y - y0) >> 3) * SC + (c >> 3) - x0 / 8];
      const bool border = xborder | ((y & 7) == 0) | ((y & 7) == 7);
      isig = inv * (border ? e.bsm : e.sm);
    }
    float acc[3] = {X[R][0], X[R][1], X[R][2]}, wsum = 1.f;
#pragma unroll
    for (int i = 0; i < NN; ++i) {
      const int dx = plus_nb(PASS, i, 0), dy = plus_nb(PASS, i, 1);
      // n+ (i >= NP): the box of its pair at y; -n+ (i < NP, pair i):
      // the box of pair i at (y, c) - n+ = (y + dy, c + dx)
      const float sad = i < NP ? lane_at(P[i][-dy], dx) : P[NN - 1 - i][0];
      const float weight = fmaxf(1.f + sad * isig, 0.f);
      wsum += weight;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) acc[ch] += weight * xat(R - dy, dx, ch);
    }
    if (owner) {
      // wsum >= 1: the fast reciprocal has no special case to miss
      const float rw = __fdividef(1.f, wsum);
      const bool skip = inv < kMinSigma;
      float* o = out + (long long)y * w + c;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        o[ch * plane] = skip ? X[R][ch] : acc[ch] * rw;
    }
  }
}

dim3 grid_of(int h, int w) {
  return dim3((w + kTW - 1) / kTW, (h + kTH - 1) / kTH);
}

// Launches EPF pass 0 or 1, its tile in dynamic shared memory (above the
// 48 KB a launch gets without asking).
template <int PASS>
int launch_plus(const float* x, const float* inv_sigma, float* out, int h,
                int w, int sigma_w, EpfParams e, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      epf_plus_kernel<PASS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      plus_tile_bytes(PASS));
  if (err != cudaSuccess) return (int)err;
  const int strips = (w + plus_cols(PASS) - 1) / plus_cols(PASS);
  const dim3 grid((strips + kWarps - 1) / kWarps,
                  (h + plus_run(PASS) - 1) / plus_run(PASS));
  epf_plus_kernel<PASS><<<grid, dim3(32, kWarps), plus_tile_bytes(PASS),
                          st>>>(x, inv_sigma, out, h, w, sigma_w, e);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (3, h, w) float32 on the device. w0/w1/w2: per-channel
// normalised weights. Launches on ``stream``; returns cudaGetLastError().
extern "C" int jxlt_gaborish(const void* x, void* out, int h, int w,
                             float w0x, float w0y, float w0b, float w1x,
                             float w1y, float w1b, float w2x, float w2y,
                             float w2b, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const GabWeights g = {{w0x, w0y, w0b}, {w1x, w1y, w1b}, {w2x, w2y, w2b}};
  gab_kernel<<<grid_of(h, w), dim3(32, 8), 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, h, w, g);
  return (int)cudaGetLastError();
}

// x, out: (3, h, w) float32; inv_sigma: (>= ceil(h/8), sigma_w) float32
// per 8x8 block, sigma_w >= ceil(w/8). pass_id: 0, 1 or 2. Launches on
// ``stream``; returns cudaGetLastError() (or cudaErrorInvalidValue for a
// bad pass).
extern "C" int jxlt_epf(const void* x, const void* inv_sigma, void* out,
                        int h, int w, int sigma_w, int pass_id, float s0,
                        float s1, float s2, float sm, float bsm,
                        void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const EpfParams e = {{s0, s1, s2}, sm, bsm};
  cudaStream_t st = (cudaStream_t)stream;
  const float* xi = (const float*)x;
  const float* si = (const float*)inv_sigma;
  float* o = (float*)out;
  switch (pass_id) {
    case 0: return launch_plus<0>(xi, si, o, h, w, sigma_w, e, st);
    case 1: return launch_plus<1>(xi, si, o, h, w, sigma_w, e, st);
    case 2:
      epf2_kernel<<<grid_of(h, w), dim3(32, 8), 0, st>>>(xi, si, o, h, w,
                                                         sigma_w, e);
      return (int)cudaGetLastError();
    default: return (int)cudaErrorInvalidValue;
  }
}
