// Decode attention (flash-decode) for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention_bhd, body _decode_kernel): one new query token per
// sequence against a KV cache.  A slot is kept iff
// k_pos >= 0 && k_pos <= q_pos (and k_pos > q_pos - window when window > 0),
// so full caches, partly filled caches and ring caches (slots in any order)
// share one kernel: only k_pos is trusted, never the slot index.
//
// Layout: q (B, Hq, hd), k/v (B, Hkv, S, hd), all by element strides with the
// head dim contiguous, so the model's (B, S, Hkv, hd) caches go in as
// transposed views; k_pos (B, S) int32 with contiguous slots, q_pos (B,)
// int32.
//
// Design: one CTA per (b, KV head); all G query heads of that KV head share
// it, so the cache is read from device memory once per step.  The CTA walks
// the cache in blocks of 64 slots: it loads the block's positions first and
// skips a block with no kept slot without touching its K/V; otherwise K/V go
// through shared memory as f32, scores for the G rows are formed, and the
// online-softmax state (m, l, acc) is corrected once per block.  Bound on the
// H100: bytes (the whole cache is read for a few FLOPs per byte), so the
// design's aim is to read each kept slot exactly once.
#include "common.cuh"

namespace {

constexpr int DBK = 64;        // cache slots per block
constexpr int DTHREADS = 128;  // threads per CTA

__host__ __device__ inline size_t decode_smem_floats(int G, int HD) {
  return (size_t)G * HD            // q rows (scaled)
         + (size_t)DBK * (HD + 1)  // K block, padded against bank conflicts
         + (size_t)DBK * HD        // V block
         + (size_t)G * DBK         // scores, then probabilities
         + (size_t)G * HD          // accumulator
         + 3 * (size_t)G           // m, l, alpha
         + DBK;                    // keep flags (as int)
}

template <typename T, int HD>
__global__ void __launch_bounds__(DTHREADS) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ k_pos, const int* __restrict__ q_pos,
    T* __restrict__ o, int S, int G, int64_t qsb, int64_t qsh, int64_t ksb,
    int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh, int64_t vss,
    int64_t kpsb, int64_t osb, int64_t osh, float scale, int window) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + G * HD;
  float* vs = ks + DBK * (HD + 1);
  float* sc = vs + DBK * HD;
  float* acc = sc + G * DBK;
  float* mm = acc + G * HD;
  float* ll = mm + G;
  float* al = ll + G;
  int* kk = reinterpret_cast<int*>(al + G);

  const int b = blockIdx.y;
  const int hk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = DTHREADS / 32;
  const int qp = q_pos[b];

  for (int e = tid; e < G * HD; e += DTHREADS) {
    const int g = e / HD;
    const int d = e - g * HD;
    qs[e] = to_f32(q[b * qsb + (int64_t)(hk * G + g) * qsh + d]) * scale;
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += DTHREADS) {
    mm[g] = NEG_INF_F;
    ll[g] = 0.f;
  }

  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  const int* kpb = k_pos + b * kpsb;

  for (int s0 = 0; s0 < S; s0 += DBK) {
    __syncthreads();  // the previous block is no longer read
    int any = 0;
    if (tid < DBK) {
      const int sj = s0 + tid;
      int keep = 0;
      if (sj < S) {
        const int kp = kpb[sj];
        keep = kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
      }
      kk[tid] = keep;
      any = keep;
    }
    if (!__syncthreads_or(any)) continue;  // nothing kept: skip the K/V read

    for (int e = tid; e < DBK * HD; e += DTHREADS) {
      const int r = e / HD;
      const int c = e - r * HD;
      const int sj = s0 + r;
      const bool ok = kk[r] != 0;
      ks[r * (HD + 1) + c] = ok ? to_f32(kb[(int64_t)sj * kss + c]) : 0.f;
      vs[r * HD + c] = ok ? to_f32(vb[(int64_t)sj * vss + c]) : 0.f;
    }
    __syncthreads();

    for (int e = tid; e < G * DBK; e += DTHREADS) {
      const int g = e / DBK;
      const int j = e - g * DBK;
      float dot = 0.f;
      const float* qg = qs + g * HD;
      const float* kj = ks + j * (HD + 1);
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(qg[d], kj[d], dot);
      sc[e] = kk[j] ? dot : NEG_INF_F;
    }
    __syncthreads();

    // one warp per query row: block max, probabilities, block sum
    for (int g = warp; g < G; g += nwarps) {
      float* sg = sc + g * DBK;
      float mt = NEG_INF_F;
      for (int j = lane; j < DBK; j += 32) mt = fmaxf(mt, sg[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(mm[g], mt);
      float sum = 0.f;
      for (int j = lane; j < DBK; j += 32) {
        const float p = kk[j] ? __expf(sg[j] - m_new) : 0.f;
        sg[j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = __expf(mm[g] - m_new);
        al[g] = alpha;
        ll[g] = ll[g] * alpha + sum;
        mm[g] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * HD; e += DTHREADS) {
      const int g = e / HD;
      const int d = e - g * HD;
      const float* pg = sc + g * DBK;
      float a = acc[e] * al[g];
#pragma unroll 8
      for (int j = 0; j < DBK; ++j) a = fmaf(pg[j], vs[j * HD + d], a);
      acc[e] = a;
    }
  }
  __syncthreads();

  for (int e = tid; e < G * HD; e += DTHREADS) {
    const int g = e / HD;
    const int d = e - g * HD;
    const float l = ll[g];
    const float inv = l > 0.f ? 1.f / l : 1.f;
    o[b * osb + (int64_t)(hk * G + g) * osh + d] = from_f32<T>(acc[e] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* k_pos, const int* q_pos, void* o, int B, int Hkv,
                   int S, int G, const int64_t* st, float scale, int window,
                   cudaStream_t stream) {
  const size_t smem = decode_smem_floats(G, HD) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(Hkv, B);
  decode_kernel<T, HD><<<grid, DTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), k_pos, q_pos, static_cast<T*>(o), S, G, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      scale, window);
  return cudaGetLastError();
}

// only the head dim of the ported configs (64) is instantiated: another
// one is added with the config that needs it
template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int* k_pos, const int* q_pos, void* o, int B,
                        int Hkv, int S, int G, const int64_t* st, float scale,
                        int window, cudaStream_t stream) {
  if (hd != 64) return cudaErrorInvalidValue;
  return launch<T, 64>(q, k, v, k_pos, q_pos, o, B, Hkv, S, G, st, scale,
                       window, stream);
}

}  // namespace

// strides: 11 int64 element strides: q (b, h), k (b, h, s), v (b, h, s),
// k_pos (b), o (b, h).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* k_pos,
                                    const void* q_pos, void* o, int dtype,
                                    int B, int Hq, int Hkv, int S, int hd,
                                    const int64_t* strides, float scale,
                                    int window, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kp = static_cast<const int*>(k_pos);
  const int* qp = static_cast<const int*>(q_pos);
  if (dtype == DTYPE_F32)
    return (int)dispatch_hd<float>(hd, q, k, v, kp, qp, o, B, Hkv, S, G,
                                   strides, scale, window, s);
  if (dtype == DTYPE_BF16)
    return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, kp, qp, o, B, Hkv, S,
                                           G, strides, scale, window, s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory one CTA needs, so the wrapper can refuse a G or hd
// the card cannot hold before launching
extern "C" long long decode_attention_smem_bytes(int G, int hd) {
  return (long long)(decode_smem_floats(G, hd) * sizeof(float));
}
