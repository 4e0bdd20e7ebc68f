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
// What bounds it: memory. A pass reads 3 float32 planes and writes 3
// (plus the small per-block sigma field), so a 3840x2160 frame moves
// 199 MB a pass, 59 us at the card's 3.35 TB/s. The arithmetic is a few
// hundred float operations per pixel at most (EPF0: 12 neighbours), well
// under what the SMs execute in that time. The design moves each byte of
// device memory once and keeps the stencil's re-reads on chip:
//   - a block of 256 threads owns one 32x32 output tile; it loads the
//     tile plus its halo (1, 3, 2, 1 pixels for Gaborish, EPF0, EPF1,
//     EPF2) for all three channels into shared memory, resolving the
//     mirror by index arithmetic on each load, so the image is read from
//     device memory once (the halo adds 6-40% of re-reads, in L2);
//   - each thread computes 4 output pixels from shared memory;
//   - for the plus-shaped SADs of EPF0/EPF1, each neighbour's scaled
//     abs-diff plane is built once over the tile plus a 1-pixel margin in
//     shared memory and then boxed with 5 taps, so a pixel costs 3
//     abs-diffs per neighbour instead of 15 (render/filters.py:113-122);
//   - the block-border SAD multiplier comes from the global coordinates
//     (y % 8, x % 8 in {0, 7}), and 1/sigma from the block (y >> 3,
//     x >> 3): nothing per pixel is read besides the image.
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

// Neighbour offsets (dx, dy) of the passes, in the reference's order.
__constant__ int kN0[12][2] = {{0, -2}, {-1, -1}, {0, -1}, {1, -1},
                               {-2, 0}, {-1, 0},  {1, 0},  {2, 0},
                               {-1, 1}, {0, 1},   {1, 1},  {0, 2}};
__constant__ int kN1[4][2] = {{0, -1}, {-1, 0}, {1, 0}, {0, 1}};

template <int PASS>
__global__ void __launch_bounds__(256)
epf_kernel(const float* __restrict__ x, const float* __restrict__ inv_sigma,
           float* __restrict__ out, int h, int w, int sigma_w, EpfParams e) {
  constexpr bool kPlus = PASS != 2;
  constexpr int R = PASS == 0 ? 3 : PASS == 1 ? 2 : 1;
  constexpr int SH = kTH + 2 * R, SW = kTW + 2 * R;
  constexpr int AH = kTH + 2, AW = kTW + 2;   // abs-diff plane: tile + 1
  constexpr int kNum = PASS == 0 ? 12 : 4;
  __shared__ float s[3 * SH * SW];
  __shared__ float ad[kPlus ? AH * AW : 1];
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  load_tile<R>(x, s, h, w, y0, x0);
  __syncthreads();

  const int lx = threadIdx.x, gx = x0 + lx;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
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

  for (int n = 0; n < kNum; ++n) {
    const int dx = PASS == 0 ? kN0[n][0] : kN1[n][0];
    const int dy = PASS == 0 ? kN0[n][1] : kN1[n][1];
    if (kPlus) {
      __syncthreads();                   // the previous plane is consumed
      for (int i = tid; i < AH * AW; i += blockDim.x * blockDim.y) {
        const int qy = i / AW, qx = i - qy * AW;   // tile coords + 1
        const int a = (qy - 1 + R) * SW + qx - 1 + R;
        const int b = a + dy * SW + dx;
        ad[i] = (e.scale[0] * fabsf(s[b] - s[a]) +
                 e.scale[1] * fabsf(s[SH * SW + b] - s[SH * SW + a])) +
                e.scale[2] * fabsf(s[2 * SH * SW + b] - s[2 * SH * SW + a]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int ly = threadIdx.y + 8 * k;
      const int o = (ly + R) * SW + lx + R;
      const int on = o + dy * SW + dx;
      float sad;
      if (kPlus) {
        const float* t = ad + (ly + 1) * AW + lx + 1;
        // the plus taps (0,-1), (-1,0), (0,0), (1,0), (0,1), in order
        sad = (((t[-AW] + t[-1]) + t[0]) + t[1]) + t[AW];
      } else {
        sad = (e.scale[0] * fabsf(s[on] - s[o]) +
               e.scale[1] * fabsf(s[SH * SW + on] - s[SH * SW + o])) +
              e.scale[2] * fabsf(s[2 * SH * SW + on] - s[2 * SH * SW + o]);
      }
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

dim3 grid_of(int h, int w) {
  return dim3((w + kTW - 1) / kTW, (h + kTH - 1) / kTH);
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
  const dim3 grid = grid_of(h, w), block(32, 8);
  cudaStream_t st = (cudaStream_t)stream;
  const float* xi = (const float*)x;
  const float* si = (const float*)inv_sigma;
  float* o = (float*)out;
  switch (pass_id) {
    case 0: epf_kernel<0><<<grid, block, 0, st>>>(xi, si, o, h, w, sigma_w, e);
      break;
    case 1: epf_kernel<1><<<grid, block, 0, st>>>(xi, si, o, h, w, sigma_w, e);
      break;
    case 2: epf_kernel<2><<<grid, block, 0, st>>>(xi, si, o, h, w, sigma_w, e);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
