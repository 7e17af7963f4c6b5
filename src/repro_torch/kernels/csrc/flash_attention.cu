// Flash attention forward for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_bhsd, body _flash_kernel): blocked online-softmax GQA
// attention with causal and sliding-window masks, f32 running max, sum and
// accumulator, output in the input's type.
//
// Layout: q (B, Hq, Sq, hd), k/v (B, Hkv, Sk, hd) given by element strides
// (the head dim contiguous), so the model's (B, S, H, hd) tensors go in as
// transposed views without a copy.  Query head h reads KV head h / G: no
// repeated K/V is materialised.
//
// Design: one CTA per (b, h, 64-row query tile), one thread per query row.
// The thread keeps its scaled query row and its f32 accumulator in
// registers; K/V tiles of 32 keys are staged through shared memory as f32
// and every thread reads the same key row at a time (a broadcast, no bank
// conflicts).  Each tile's scores are formed first, then the running max is
// corrected once per tile, as the TPU kernel does per k-block.  Tiles wholly
// above the causal diagonal or below the window are never loaded.  Any Sq
// and Sk are taken: the ragged tail of either is masked, not padded.
//
// Bound on the H100: at the serving shapes (S = 128..1000, hd = 64) the
// work is a few GFLOP against a few MB, so FLOPs bound it; this first
// version runs on the f32 CUDA cores (no wgmma/TMA yet), so it is far from
// the bf16 tensor-core roofline.  PERF.md records its times beside the bound.
#include "common.cuh"

namespace {

constexpr int BQ = 64;  // query rows per CTA (= threads per CTA)
constexpr int BK = 32;  // keys per shared-memory tile

template <typename T, int HD>
__global__ void __launch_bounds__(BQ) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Sk, int G, int64_t qsb, int64_t qsh,
    int64_t qss, int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
    int64_t vsh, int64_t vss, int64_t osb, int64_t osh, int64_t oss,
    float scale, int causal, int window) {
  __shared__ float ks[BK][HD];
  __shared__ float vs[BK][HD];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int hk = h / G;
  const int tid = threadIdx.x;
  const int qi = q0 + tid;
  const bool row_ok = qi < Sq;

  float qr[HD];
  float acc[HD];
  const T* qp = q + b * qsb + h * qsh + (int64_t)qi * qss;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = row_ok ? to_f32(qp[d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_INF_F;
  float l = 0.f;

  // the keys this query tile can see
  const int q_last = min(q0 + BQ, Sq) - 1;
  int k_end = causal ? min(Sk, q_last + 1) : Sk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < BK * HD; e += BQ) {
      const int r = e / HD;
      const int c = e - r * HD;
      const int kj = k0 + r;
      const bool ok = kj < Sk;
      ks[r][c] = ok ? to_f32(kb[(int64_t)kj * kss + c]) : 0.f;
      vs[r][c] = ok ? to_f32(vb[(int64_t)kj * vss + c]) : 0.f;
    }
    __syncthreads();

    float s[BK];
    unsigned keep = 0u;
    float mt = NEG_INF_F;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int kj = k0 + j;
      const bool kp = row_ok && kj < Sk && (!causal || kj <= qi) &&
                      (window <= 0 || kj > qi - window);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      s[j] = kp ? dot : NEG_INF_F;
      keep |= (kp ? 1u : 0u) << j;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = __expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = ((keep >> j) & 1u) ? __expf(s[j] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    m = m_new;
  }

  if (row_ok) {
    const float inv = l > 0.f ? 1.f / l : 1.f;
    T* op = o + b * osb + h * osh + (int64_t)qi * oss;
#pragma unroll
    for (int d = 0; d < HD; ++d) op[d] = from_f32<T>(acc[d] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Sq, int Sk, int G, const int64_t* st,
                   float scale, int causal, int window, cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, HD><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, G, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale, causal, window);
  return cudaGetLastError();
}

// only the head dim of the ported configs (64) is instantiated: another
// one is added with the config that needs it
template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int B, int Hq, int Sq, int Sk, int G,
                        const int64_t* st, float scale, int causal, int window,
                        cudaStream_t stream) {
  if (hd != 64) return cudaErrorInvalidValue;
  return launch<T, 64>(q, k, v, o, B, Hq, Sq, Sk, G, st, scale, causal, window,
                       stream);
}

}  // namespace

// strides: 12 int64 element strides (b, h, s) for q, k, v, o in that order.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int Hq, int Hkv, int Sq, int Sk, int hd,
                                   const int64_t* strides, float scale,
                                   int causal, int window, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return (int)dispatch_hd<float>(hd, q, k, v, o, B, Hq, Sq, Sk, G, strides,
                                   scale, causal, window, s);
  if (dtype == DTYPE_BF16)
    return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Hq, Sq, Sk, G,
                                           strides, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
