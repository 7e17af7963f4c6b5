// Hopper (sm_90a) building blocks written as inline PTX: mbarriers, TMA
// tile and 1-D bulk loads, wgmma shared-memory descriptors and the
// m64n64k16 bf16 wgmma with A from shared memory or from registers, and
// ldmatrix for register operands.  No CuTe: these few instructions are all
// the attention, SSD and dequantize kernels need, and CuTe's headers would
// multiply the build time.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ---------------------------------------------------------------------------
// host: the TMA descriptor encoder, looked up at run time
// ---------------------------------------------------------------------------

typedef CUresult (*TensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query, so the
// library needs no -lcuda; null where it is not offered
inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (TensorMapEncodeTiled)p;
  }
  return fn;
}

// A 4-D bf16 tensor map over (cols, rows, heads, batch) with element
// strides (1, srow, shead, sbatch), cut into boxes of 64 x 64 elements with
// the 128-byte swizzle (one 64-element bf16 row is exactly one swizzle atom
// row); a row of 128 values is two boxes, at column 0 and 64.  `cols` is a
// multiple of 8 (16 bytes, as TMA asks of every stride): where it is not a
// multiple of 64 the last box is part filled, and its columns past `cols`
// read as zero, as rows past `rows` do (a row of 96 values is two boxes,
// the second holding columns 64-95 and 32 zeros).  A dimension of size 1
// never moves its coordinate, so its stride is replaced by a valid one.
inline bool encode_rows(CUtensorMap* map, const void* base, int cols,
                        int rows, int heads, int batch, int64_t srow,
                        int64_t shead, int64_t sbatch) {
  TensorMapEncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const int64_t es = 2;  // bytes per bf16
  cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows,
                        (cuuint64_t)heads, (cuuint64_t)batch};
  const int64_t s1 = rows > 1 ? srow * es : cols * es;
  const int64_t s2 = heads > 1 ? shead * es : s1 * rows;
  const int64_t s3 = batch > 1 ? sbatch * es : s2 * heads;
  cuuint64_t strides[3] = {(cuuint64_t)s1, (cuuint64_t)s2, (cuuint64_t)s3};
  cuuint32_t box[4] = {64, 64, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(base), dims, strides, box, estr,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// device: mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// one plain arrival (no transaction bytes)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed; a copy that never
// lands (a bad descriptor) traps after about 2^28 tries, seconds, so it
// surfaces as a launch error instead of a hung card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 28)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one 4-D box of `map` at coordinates (c0, c1, c2, c3) into shared memory;
// completion counts the box's bytes on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// a 1-D bulk copy (TMA without a tensor map) of `bytes` from global to
// shared memory; both addresses and `bytes` are multiples of 16, and
// completion counts the bytes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a tile stored as rows of 128 bytes
// with the 128-byte swizzle (what TMA's SWIZZLE_128B writes), the tile
// 1024-byte aligned.  An 8-row group is 1024 bytes; both offsets are set
// to it (K-major ignores the leading offset, MN-major with a 64-wide N
// never steps it).
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// make this thread's ordinary shared-memory writes visible to the async
// proxy (wgmma operands, TMA) before a barrier hands them over
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WGMMA_D32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

#define WGMMA_D32_LIST                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64 f32) (+)= A (64 x 16, K-major in shared memory) .
// B (16 x 64, K-major in shared memory: rows of B^T).  `accumulate` 0
// overwrites d.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                   uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32) += A (64 x 16 bf16 in registers, the accumulator layout
// of a previous wgmma packed in pairs) . B (16 x 64, MN-major in shared
// memory: 16 rows of 64 contiguous values).
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// (a, b) as two bf16 pairs whose sum is (a, b) to about 2^-17 relative:
// `hi` rounds them to bf16, `lo` rounds what that left out
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// ---------------------------------------------------------------------------
// device: register operands from shared memory
// ---------------------------------------------------------------------------

// four 8 x 8 bf16 matrices from shared memory, each transposed: lane l gives
// the address of row l % 8 of matrix l / 8 (16 bytes), and receives rows
// 2t, 2t+1 of column g of each stored matrix (g = l / 4, t = l % 4; the
// lower row in the low half).  From a tile stored [k][m] this is the A
// fragment of mma.m16n8k16, which is also each warp's 16-row slice of the
// register A operand of wgmma m64nNk16: a0 (m g, k 2t..), a1 (m g+8, k 2t..),
// a2 (m g, k 2t+8..), a3 (m g+8, k 2t+8..), from matrices (k 0-7, m 0-7),
// (k 0-7, m 8-15), (k 8-15, m 0-7) and (k 8-15, m 8-15).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
