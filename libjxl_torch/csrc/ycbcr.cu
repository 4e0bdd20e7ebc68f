// The last stage of a recompressed JPEG's decode on Hopper (sm_90a): 2x
// chroma upsampling of the 4:2:0 planes, YCbCr to RGB and the 8-bit,
// interleaved output, for a batch of frames in one launch.
//
// Contract: ycbcr420_to_rgb8_ref in libjxl_torch/models/ycbcr_kernel.py
// (the host's chroma_upsample and ycbcr_to_rgb, color/xyb.py, after
// stage_chroma_upsampling.cc and stage_ycbcr.cc). Each chroma plane is cut
// to its visible size (ceil(h / 2), ceil(w / 2)), upsampled horizontally
// and then vertically with the taps 3/4 (the sample) and 1/4 (its
// neighbour on the output pixel's side), the edge repeating its last
// sample, and cut to h x w. Every operation is rounded as the plain
// version rounds it (__fmul_rn / __fadd_rn: no contraction into FMAs), so
// the two agree bit for bit; the output rounds half to even (rintf).
//
// One thread owns the 2x2 output pixels of one chroma sample: it reads
// the 3x3 chroma samples around it in both planes (neighbouring threads
// share them through L1), upsamples horizontally the three rows it needs
// once, and writes 2 rows of 2 RGB pixels. Device memory is read and
// written once: the Y plane (4 B a pixel), two quarter-size chroma
// planes (2 B a pixel) and the output (3 B a pixel): 9 B a pixel, 110 MB
// for a 4032x3024 frame, 33 us at the card's 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kYOffset = static_cast<float>(128.0 / 255);
constexpr float kCrR = static_cast<float>(1.402);
constexpr float kCbG = static_cast<float>(-0.114 * 1.772 / 0.587);
constexpr float kCrG = static_cast<float>(-0.299 * 1.402 / 0.587);
constexpr float kCbB = static_cast<float>(1.772);

__device__ __forceinline__ float tap(float centre, float side) {
  return __fadd_rn(__fmul_rn(0.75f, centre), __fmul_rn(0.25f, side));
}

__device__ __forceinline__ uint8_t to_u8(float v) {
  return static_cast<uint8_t>(
      fminf(fmaxf(rintf(__fmul_rn(v, 255.0f)), 0.0f), 255.0f));
}

__global__ void ycbcr420_kernel(const float* __restrict__ y,
                                const float* __restrict__ cb,
                                const float* __restrict__ cr,
                                uint8_t* __restrict__ out, int h, int w,
                                int y_rows, int y_cols, int c_rows,
                                int c_cols) {
  const int ch = (h + 1) >> 1, cw = (w + 1) >> 1;
  const int xc = blockIdx.x * blockDim.x + threadIdx.x;
  const int yc = blockIdx.y * blockDim.y + threadIdx.y;
  if (xc >= cw || yc >= ch) return;
  const int64_t k = blockIdx.z;
  const float* yk = y + k * y_rows * static_cast<int64_t>(y_cols);
  const int64_t c_off = k * c_rows * static_cast<int64_t>(c_cols);
  const float* planes[2] = {cb + c_off, cr + c_off};
  uint8_t* ok = out + k * h * static_cast<int64_t>(w) * 3;
  const int xl = xc > 0 ? xc - 1 : 0, xr = xc + 1 < cw ? xc + 1 : cw - 1;
  const int rows[3] = {yc > 0 ? yc - 1 : 0, yc, yc + 1 < ch ? yc + 1 : ch - 1};
  // hor[p][r][dx]: plane p, row rows[r], horizontally upsampled at output
  // column 2 xc + dx
  float hor[2][3][2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float* row = planes[p] + rows[r] * static_cast<int64_t>(c_cols);
      const float c = __ldg(row + xc);
      hor[p][r][0] = tap(c, __ldg(row + xl));
      hor[p][r][1] = tap(c, __ldg(row + xr));
    }
  }
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int oy = 2 * yc + dy;
    if (oy >= h) break;
    const int side = dy ? 2 : 0;
    const float* yrow = yk + oy * static_cast<int64_t>(y_cols);
    uint8_t* orow = ok + oy * static_cast<int64_t>(w) * 3;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int ox = 2 * xc + dx;
      if (ox >= w) break;
      const float cbv = tap(hor[0][1][dx], hor[0][side][dx]);
      const float crv = tap(hor[1][1][dx], hor[1][side][dx]);
      const float yv = __fadd_rn(__ldg(yrow + ox), kYOffset);
      const float r = __fadd_rn(__fmul_rn(kCrR, crv), yv);
      const float g = __fadd_rn(__fadd_rn(yv, __fmul_rn(kCbG, cbv)),
                                __fmul_rn(kCrG, crv));
      const float b = __fadd_rn(__fmul_rn(kCbB, cbv), yv);
      uint8_t* o = orow + 3 * ox;
      o[0] = to_u8(r);
      o[1] = to_u8(g);
      o[2] = to_u8(b);
    }
  }
}

}  // namespace

// y: (k, y_rows, y_cols), cb and cr: (k, c_rows, c_cols) contiguous
// float32; out: (k, h, w, 3) uint8. Returns 0 or the CUDA error of the
// launch.
extern "C" int jxlt_ycbcr420(const float* y, const float* cb,
                             const float* cr, uint8_t* out, int k, int h,
                             int w, int y_rows, int y_cols, int c_rows,
                             int c_cols, void* stream) {
  const int ch = (h + 1) >> 1, cw = (w + 1) >> 1;
  if (k < 1 || h < 1 || w < 1 || y_rows < h || y_cols < w ||
      c_rows < ch || c_cols < cw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(32, 8);
  const dim3 grid((cw + 31) / 32, (ch + 7) / 8, k);
  ycbcr420_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      y, cb, cr, out, h, w, y_rows, y_cols, c_rows, c_cols);
  return static_cast<int>(cudaGetLastError());
}
