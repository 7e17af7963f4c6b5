// Shared helpers for the hand-written Hopper kernels: f32 <-> storage-type
// conversion for the two element types the attention kernels take.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// element-type codes passed across the C interface
#define DTYPE_F32 0
#define DTYPE_BF16 1

// the masked-score sentinel of the reference (attention.py NEG_INF)
#define NEG_INF_F (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
