// Blockwise int8 quantize / dequantize for sm_90a.
//
// Replaces the Pallas TPU kernels repro/kernels/quantize.py (quantize_int8,
// body _quant_kernel; dequantize_int8, body _dequant_kernel): symmetric
// int8 per block of 256 values with an f32 scale per block,
//   scale = max|x| / 127,  q = clip(rint(x / safe), -127, 127),
//   safe = scale where scale > 0, else 1,
// and back, x = q * scale.  Bit-exact with the plain version
// (repro_torch/optim/compression.py): both divisions are IEEE quotients
// (this file is built without -use_fast_math, and never multiplies by a
// reciprocal or calls __fdividef), rintf rounds half to even as torch.round
// does, and max and the dequantize multiply are exact in any order.
//
// Design: one warp per 256-value block.  Each lane holds 8 values, read as
// two 16-byte vectors 128 values apart, so a warp reads its block's 1 KiB
// in two fully coalesced transactions; the block's max meets in a shuffle
// reduction, and each lane writes its 8 codes as two 4-byte words.  Eight
// blocks per 256-thread CTA.  Blocks past the input's end read zeros, so
// the padding blocks the wrapper asks for come out as q = 0, scale = 0.
// Bound on the H100: bytes (a few operations per 4-byte value), so the aim
// is one pass at the memory rate: 4 bytes in and 1 + 1/64 out per value.
#include "common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int BLOCKS_PER_CTA = 8;

__device__ __forceinline__ float4 load4(const float* __restrict__ x,
                                        int64_t i, int64_t n) {
  if (i + 3 < n) return *reinterpret_cast<const float4*>(x + i);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < n) v.x = x[i];
  if (i + 1 < n) v.y = x[i + 1];
  if (i + 2 < n) v.z = x[i + 2];
  return v;
}

__device__ __forceinline__ int8_t code(float x, float safe) {
  const float r = rintf(x / safe);
  return (int8_t)fminf(fmaxf(r, -127.f), 127.f);
}

__device__ __forceinline__ uint32_t pack4(float4 v, float safe) {
  const uint32_t a = (uint8_t)code(v.x, safe), b = (uint8_t)code(v.y, safe),
                 c = (uint8_t)code(v.z, safe), d = (uint8_t)code(v.w, safe);
  return a | (b << 8) | (c << 16) | (d << 24);
}

__device__ __forceinline__ float amax4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

__global__ void __launch_bounds__(32 * BLOCKS_PER_CTA)
    quantize_kernel(const float* __restrict__ x, int64_t n,
                    uint32_t* __restrict__ q, float* __restrict__ scales,
                    int64_t nb) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t blk = (int64_t)blockIdx.x * BLOCKS_PER_CTA + warp;
  if (blk >= nb) return;
  const int64_t base = blk * BLOCK;
  const float4 lo = load4(x, base + 4 * lane, n);
  const float4 hi = load4(x, base + 128 + 4 * lane, n);
  float m = fmaxf(amax4(lo), amax4(hi));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float scale = m / 127.0f;  // IEEE division (no fast math)
  const float safe = scale > 0.f ? scale : 1.f;
  uint32_t* row = q + blk * (BLOCK / 4);
  row[lane] = pack4(lo, safe);
  row[32 + lane] = pack4(hi, safe);
  if (lane == 0) scales[blk] = scale;
}

__device__ __forceinline__ void store4(float* __restrict__ out, int64_t i,
                                       int64_t n, float4 v) {
  if (i + 3 < n) {
    *reinterpret_cast<float4*>(out + i) = v;
    return;
  }
  if (i < n) out[i] = v.x;
  if (i + 1 < n) out[i + 1] = v.y;
  if (i + 2 < n) out[i + 2] = v.z;
}

__device__ __forceinline__ float4 unpack4(uint32_t w, float s) {
  return make_float4((float)(int8_t)(w & 0xff) * s,
                     (float)(int8_t)((w >> 8) & 0xff) * s,
                     (float)(int8_t)((w >> 16) & 0xff) * s,
                     (float)(int8_t)(w >> 24) * s);
}

__global__ void __launch_bounds__(32 * BLOCKS_PER_CTA)
    dequantize_kernel(const uint32_t* __restrict__ q,
                      const float* __restrict__ scales,
                      float* __restrict__ out, int64_t n) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t blk = (int64_t)blockIdx.x * BLOCKS_PER_CTA + warp;
  const int64_t base = blk * BLOCK;
  if (base >= n) return;
  const float s = scales[blk];
  const uint32_t* row = q + blk * (BLOCK / 4);
  store4(out, base + 4 * lane, n, unpack4(row[lane], s));
  store4(out, base + 128 + 4 * lane, n, unpack4(row[32 + lane], s));
}

}  // namespace

// x: n f32 values, 16-byte aligned; q: (nb, 256) int8 and scales: (nb,) f32,
// nb >= ceil(n / 256) (blocks past the data come out zero).
extern "C" int quantize_int8_f32(const void* x, long long n, void* q,
                                 void* scales, long long nb, void* stream) {
  if (n < 0 || nb <= 0 || nb * BLOCK < n) return (int)cudaErrorInvalidValue;
  const long long ctas = (nb + BLOCKS_PER_CTA - 1) / BLOCKS_PER_CTA;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  quantize_kernel<<<(unsigned)ctas, 32 * BLOCKS_PER_CTA, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), (int64_t)n, static_cast<uint32_t*>(q),
      static_cast<float*>(scales), (int64_t)nb);
  return (int)cudaGetLastError();
}

// q: (nb, 256) int8, 16-byte aligned; scales: (nb,) f32; out: n f32 values,
// 16-byte aligned, n <= nb * 256.
extern "C" int dequantize_int8_f32(const void* q, const void* scales,
                                   void* out, long long n, long long nb,
                                   void* stream) {
  if (n <= 0 || nb <= 0 || nb * BLOCK < n) return (int)cudaErrorInvalidValue;
  const long long used = (n + BLOCK - 1) / BLOCK;
  const long long ctas = (used + BLOCKS_PER_CTA - 1) / BLOCKS_PER_CTA;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dequantize_kernel<<<(unsigned)ctas, 32 * BLOCKS_PER_CTA, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), (int64_t)n);
  return (int)cudaGetLastError();
}
