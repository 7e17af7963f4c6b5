// Blockwise lattice digest for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/digest.py (block_digest, body
// _digest_kernel): one 32-bit digest per 256-word row,
//   d = sum_j x_j * (2j + 1) * 0x9E3779B1  (mod 2^32),
// bit-exact with the plain version, because uint32 multiply and add wrap
// mod 2^32 natively and that sum is associative in any order.
//
// Design: one warp per row.  Each lane reads two 16-byte vectors (8 words)
// of its row, so a warp reads the row's 1 KiB in two fully coalesced
// transactions; the weights are computed in registers and the lane sums meet
// in a shuffle reduction.  8 rows per 256-thread CTA.  Bound on the H100:
// bytes (2 integer ops per 4-byte word), so the aim is one pass over the
// panels at the memory rate.  Any row count is taken; the TPU kernel's
// multiple-of-8 tile is a grid constraint, not semantics.
#include "common.cuh"

namespace {

constexpr uint32_t GOLDEN = 0x9E3779B1u;
constexpr int ROW_WORDS = 256;
constexpr int ROWS_PER_CTA = 8;

__device__ __forceinline__ uint32_t weight(uint32_t j) {
  return (2u * j + 1u) * GOLDEN;
}

__global__ void __launch_bounds__(32 * ROWS_PER_CTA)
    block_digest_kernel(const uint4* __restrict__ x, uint32_t* __restrict__ out,
                        int64_t nb) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * ROWS_PER_CTA + warp;
  if (row >= nb) return;
  const uint4* r = x + row * (ROW_WORDS / 4);
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = lane + 32 * i;  // vector index: words 4c .. 4c + 3
    const uint4 w = r[c];
    const uint32_t j = 4u * (uint32_t)c;
    acc += w.x * weight(j);
    acc += w.y * weight(j + 1u);
    acc += w.z * weight(j + 2u);
    acc += w.w * weight(j + 3u);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[row] = acc;
}

}  // namespace

// panels: (nb, 256) uint32, contiguous and 16-byte aligned; out: (nb,) uint32
extern "C" int block_digest_u32(const void* panels, void* out, long long nb,
                                void* stream) {
  if (nb <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (nb + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  block_digest_kernel<<<(unsigned)blocks, 32 * ROWS_PER_CTA, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(panels), static_cast<uint32_t*>(out),
      (int64_t)nb);
  return (int)cudaGetLastError();
}
