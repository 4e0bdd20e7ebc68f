// Prefix-pack chunks of hybrid-uint tokens on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel libjxl_tpu/models/pack_kernel.py
// (_pack_kernel, called through pack_chunks_tpu). Same contract: for each
// chunk of 128 uint32 residuals (0xFFFFFFFF marks an invalid position,
// which emits a 0-bit token):
//   1. hybrid-uint (4, 2, 0) token and raw mantissa bits;
//   2. prefix code from a 96-entry (len << 16) | bits table (tokens >= 96
//      get the empty code, as the TPU kernel's compare loop gave them);
//   3. exclusive scan of the bit lengths;
//   4. OR of each token's low/high word pieces into a 128-word buffer.
// Outputs: buf (Cn, 128) uint32 words, LSB-first within the chunk, and
// chunk_bits (Cn,) int32, the exact bit count of each chunk.
//
// What bounds it: memory. A chunk reads 512 bytes and writes 516, and the
// arithmetic per token is a dozen integer operations, far below what the
// card can execute per byte of HBM traffic. The design therefore moves each
// byte once and keeps every intermediate on chip:
//   - one warp per chunk; each lane loads its 4 adjacent tokens with one
//     16-byte load, so a warp's load is one coalesced 512-byte transaction;
//   - floor_log2 is one __clz; the 96-entry table sits in shared memory and
//     is read by a direct gather (the TPU's compare loop was a workaround
//     for slow small-table gathers there);
//   - bit offsets come from a __shfl_up_sync scan across the warp;
//   - pieces are ORed into a per-warp 128-word shared buffer with
//     atomicOr; they are bit-disjoint, so the result does not depend on
//     the order and is deterministic;
//   - the warp stores the buffer with one coalesced 16-byte store per lane.
// Any chunk count works: the TPU version padded to 256-chunk blocks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTokens = 128;     // tokens per chunk (PACK_T)
constexpr int kWords = 128;      // words per chunk buffer (PACK_NW)
constexpr int kAlphabet = 96;
constexpr int kWarps = 8;        // warps (chunks in flight) per block
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kWarps * 32)
pack_chunks_kernel(const uint4* __restrict__ v, const int* __restrict__ lut,
                   uint4* __restrict__ buf, int* __restrict__ chunk_bits,
                   long long cn) {
  __shared__ int s_lut[kAlphabet];
  __shared__ __align__(16) uint32_t s_buf[kWarps][kWords];
  for (int i = threadIdx.x; i < kAlphabet; i += blockDim.x) s_lut[i] = lut[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint32_t* wbuf = s_buf[warp];
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long c = (long long)blockIdx.x * kWarps + warp; c < cn;
       c += stride) {
    reinterpret_cast<uint4*>(wbuf)[lane] = make_uint4(0, 0, 0, 0);
    const uint4 q = v[c * (kTokens / 4) + lane];
    const uint32_t vals[4] = {q.x, q.y, q.z, q.w};
    uint32_t comb[4], len[4];
    uint32_t sum = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t x = vals[k];
      if (x == kSentinel) {
        comb[k] = 0;
        len[k] = 0;
        continue;
      }
      uint32_t token, nbits, raw;
      if (x < 16) {
        token = x;
        nbits = 0;
        raw = 0;
      } else {
        const uint32_t ln = 31 - __clz(x);           // x >= 16: ln >= 4
        const uint32_t mant = x - (1u << ln);
        token = 16 + ((ln - 4) << 2) + (mant >> (ln - 2));
        nbits = ln - 2;
        raw = x & ((1u << nbits) - 1);
      }
      const int e = token < kAlphabet ? s_lut[token] : 0;
      const uint32_t clen = (uint32_t)(e >> 16);
      const uint32_t cbits = (uint32_t)(e & 0xFFFF);
      comb[k] = cbits | (clen < 32 ? raw << clen : 0u);
      len[k] = clen + nbits;
      sum += len[k];
    }
    // inclusive scan of the lanes' bit counts
    uint32_t inc = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t t = __shfl_up_sync(0xFFFFFFFFu, inc, d);
      if (lane >= d) inc += t;
    }
    __syncwarp();                      // buffer zeroed before any OR
    uint32_t off = inc - sum;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t wt = off >> 5;
      const uint32_t b = off & 31;
      const uint32_t lo = comb[k] << b;
      const uint32_t hi = b ? comb[k] >> (32 - b) : 0u;
      if (lo && wt < kWords) atomicOr(&wbuf[wt], lo);
      if (hi && wt + 1 < kWords) atomicOr(&wbuf[wt + 1], hi);
      off += len[k];
    }
    __syncwarp();                      // every OR lands before the store
    buf[c * (kWords / 4) + lane] = reinterpret_cast<const uint4*>(wbuf)[lane];
    if (lane == 31) chunk_bits[c] = (int)inc;
  }
}

}  // namespace

// v: (cn, 128) uint32, 16-byte aligned; lut: (96,) int32 on the device;
// buf: (cn, 128) uint32; chunk_bits: (cn,) int32. Launches on ``stream``
// and returns cudaGetLastError() as an int (0 = launched).
extern "C" int jxlt_pack_chunks(const void* v, const void* lut, void* buf,
                                void* chunk_bits, long long cn,
                                void* stream) {
  if (cn <= 0) return 0;
  // one wave of resident blocks (8 per SM on 132 SMs); warps stride on
  const long long want = (cn + kWarps - 1) / kWarps;
  const int blocks = (int)(want < 132LL * 8 ? want : 132LL * 8);
  pack_chunks_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint4*)v, (const int*)lut, (uint4*)buf, (int*)chunk_bits, cn);
  return (int)cudaGetLastError();
}
