// Decode attention (flash-decoding, split-K) for sm_90a.
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
// transposed views; k_pos (B, S) int32 with contiguous slots (its batch
// stride may be 0), q_pos (B,) int32.
//
// Bound on the H100: bytes.  A step reads the kept part of the cache once
// for about 2 FLOP per byte, far below the card's ridge of about 295, so
// the tensor cores cannot help; what matters is enough CTAs reading at once.
//
// Design: the TPU kernel walks the cache in order on one core; here the
// cache is cut into `chunk` slots (a multiple of 32, chosen by the wrapper
// so that the grid reaches about two waves of the 132 SMs).  The partial
// kernel runs one CTA of 4 warps per (split, KV head, block of up to 4 query
// heads of that KV head, b).  A warp takes 8 slots at a time: it reads their
// positions first, skips the 8 without touching K/V when none is kept, and
// otherwise reads K and V straight from device memory as 16-byte vector
// loads (an hd-64 bf16 row is 8 lanes x 16 B), only for kept slots.  At hd
// 256 in bf16 a row is all 32 lanes, and a warp takes 4 slots at a time:
// eight slots' K and V in f32 registers would be 128 of them a lane.  At hd
// 128 a row is 16 lanes, two slots a warp-wide load, and a warp takes 4
// slots at a time as well (two loads each of K and V in flight).  At hd 96
// (phi3-mini) a row is 12 lanes of 16 bytes; it is given 16 lanes, the
// next power of two, as at hd 128, so the shuffle butterfly that sums a
// slot's score stays inside its 16 lanes: lanes 12-15 of each 16 load
// nothing, hold zeros and add 0 (a butterfly over 12 lanes would run
// offsets 6, 3, 1 and mix neighbouring slots' lanes).  The
// query rows (scaled by hd^-1/2 log2 e) stay in registers; a slot's score is
// reduced over its lanes by shuffles, and each lane keeps an online softmax
// (m, l, acc) in f32 for its slots.  The lanes, then the warps (through
// shared memory), are merged once at the end.  Each CTA writes an f32
// partial (m, l, acc[hd]) per query head to a workspace the wrapper
// allocates; the combine kernel, launched right after on the same stream as
// a programmatic dependent (so its launch overlaps the partial kernel),
// merges the splits: out = sum e^(m - M) acc / sum e^(m - M) l.  A split with
// nothing kept has l = 0 and adds nothing; a row with nothing kept at all is
// 0.  With one split the partial kernel writes the output itself.
#include "common.cuh"

namespace {

constexpr int DWARPS = 4;           // warps per CTA
constexpr int DTHREADS = 32 * DWARPS;
constexpr int GB = 4;               // query heads per CTA at most
constexpr int WARP_SLOTS = 8;       // slots a warp takes at a time (hd 64)
constexpr int CHUNK_ALIGN = DWARPS * WARP_SLOTS;  // chunk is a multiple of it

// the least power of two >= n (n >= 1)
__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// 16 bytes of T: loaded raw, widened to f32
__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void widen(uint4 r, float (&x)[4]) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void widen(uint4 r, float (&x)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

// merge online-softmax state (mo, lo, ao) into (m, l, a); m = -inf is empty
template <int N>
__device__ __forceinline__ void merge(float& m, float& l, float (&a)[N],
                                      float mo, float lo, const float (&ao)[N]) {
  const float mn = fmaxf(m, mo);
  const float ref = mn == -INFINITY ? 0.f : mn;
  const float s = exp2f(m - ref);
  const float so = exp2f(mo - ref);
  l = l * s + lo * so;
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] = a[e] * s + ao[e] * so;
  m = mn;
}

template <typename T, int HD>
__global__ void __launch_bounds__(DTHREADS) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ k_pos, const int* __restrict__ q_pos,
    T* __restrict__ o, float* __restrict__ ws_acc, float* __restrict__ ws_ml,
    int B, int Hq, int S, int G, int chunk, int64_t qsb, int64_t qsh,
    int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
    int64_t vss, int64_t kpsb, int64_t osb, int64_t osh, float scale_log2,
    int window) {
  constexpr int EPL = Vec16<T>::N;       // elements per lane per load
  constexpr int ROW = HD / EPL;          // lanes that hold a slot row
  constexpr int LPS = pow2_at_least(ROW);  // lanes per slot row, padded
  constexpr int SPL = 32 / LPS;          // slots per warp-wide load
  constexpr int WS = HD > 64 ? WARP_SLOTS / 2 : WARP_SLOTS;  // per step
  constexpr int U = WS / SPL;            // loads per group of WS slots
  static_assert(HD % EPL == 0 && LPS <= 32 && U >= 1 &&
                    CHUNK_ALIGN % (DWARPS * WS) == 0,
                "a slot row is whole 16-byte lanes of one warp-wide load");
  __shared__ float sh_m[DWARPS][GB], sh_l[DWARPS][GB];
  __shared__ float sh_acc[DWARPS][GB][HD];

  const int gblocks = (G + GB - 1) / GB;
  const int split = blockIdx.x;
  const int hk = blockIdx.y / gblocks;
  const int g0 = (blockIdx.y % gblocks) * GB;
  const int ng = min(GB, G - g0);
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int sub = lane / LPS;          // which slot of a warp-wide load
  const int d0 = (lane % LPS) * EPL;   // which 16 bytes of the row
  const bool on_row = d0 < HD;         // false on a padding lane
  const int qp = q_pos[b];
  // the combine kernel may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  float qr[GB][EPL];
  float m[GB], l[GB], acc[GB][EPL];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] = acc[g][e] = 0.f;
    if (g < ng && on_row) {
      Vec16<T>::widen(
          load16(q + b * qsb + (int64_t)(hk * G + g0 + g) * qsh + d0), qr[g]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] *= scale_log2;
    }
  }

  const T* kb = k + b * ksb + hk * ksh + d0;
  const T* vb = v + b * vsb + hk * vsh + d0;
  const int* kpb = k_pos + b * kpsb;
  const int s_begin = split * chunk;
  const int s_end = min(S, s_begin + chunk);

  // a warp takes groups of WS slots, DWARPS WS apart: their positions
  // first, then the K/V of every kept slot (U loads of 16 B per lane for
  // each of K and V in flight), then the arithmetic
  for (int s0 = s_begin + warp * WS; s0 < s_end; s0 += DWARPS * WS) {
    bool keep[U];
    bool any = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int sj = s0 + u * SPL + sub;
      keep[u] = false;
      if (sj < s_end) {
        const int kp = kpb[sj];
        keep[u] = kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
      }
      any |= keep[u];
    }
    if (!__any_sync(0xffffffffu, any)) continue;  // nothing kept: no K/V read

    float kf[U][EPL], vf[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t sj = s0 + u * SPL + sub;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = kr;
      if (keep[u] && on_row) {
        kr = load16(kb + sj * kss);
        vr = load16(vb + sj * vss);
      }
      Vec16<T>::widen(kr, kf[u]);
      Vec16<T>::widen(vr, vf[u]);
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g >= ng) break;
      float sc[U];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[g][e], kf[u][e], dot);
#pragma unroll
        for (int off = LPS / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        sc[u] = keep[u] ? dot : -INFINITY;
        mx = fmaxf(mx, sc[u]);
      }
      if (mx == -INFINITY) continue;  // none of this lane's slots is kept
      const float m_new = fmaxf(m[g], mx);
      const float alpha = exp2f(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = exp2f(sc[u] - m_new);  // -inf (not kept) gives 0
        l[g] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vf[u][e], acc[g][e]);
      }
      m[g] = m_new;
    }
  }

  // merge the warp's slot lanes (same d0, other sub), then the warps
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int off = LPS; off < 32; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      float ao[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        ao[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
      merge<EPL>(m[g], l[g], acc[g], mo, lo, ao);
    }
    if (lane < LPS) {
      if (on_row) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) sh_acc[warp][g][d0 + e] = acc[g][e];
      }
      if (lane == 0) {
        sh_m[warp][g] = m[g];
        sh_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  for (int idx = tid; idx < ng * HD; idx += DTHREADS) {
    const int g = idx / HD;
    const int d = idx - g * HD;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < DWARPS; ++w) mm = fmaxf(mm, sh_m[w][g]);
    const float ref = mm == -INFINITY ? 0.f : mm;
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < DWARPS; ++w) {
      const float s = exp2f(sh_m[w][g] - ref);
      ll = fmaf(sh_l[w][g], s, ll);
      aa = fmaf(sh_acc[w][g][d], s, aa);
    }
    const int hq = hk * G + g0 + g;
    if (gridDim.x == 1) {
      o[b * osb + (int64_t)hq * osh + d] =
          from_f32<T>(ll > 0.f ? aa / ll : 0.f);
    } else {
      const int64_t row = ((int64_t)split * B + b) * Hq + hq;
      ws_acc[row * HD + d] = aa;
      if (d == 0) {
        ws_ml[2 * row] = mm;
        ws_ml[2 * row + 1] = ll;
      }
    }
  }
}

// one thread per output value (b, query head, dim): an online merge of the
// n_split partials, whose loads do not depend on one another, so the
// unrolled loop issues them together.  Launched as a programmatic dependent
// of the partial kernel: its CTAs are scheduled while the partial kernel
// runs and wait here for its writes.
template <typename T, int HD>
__global__ void __launch_bounds__(DTHREADS) decode_combine_kernel(
    const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
    T* __restrict__ o, int B, int Hq, int n_split, int64_t osb, int64_t osh) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int idx = blockIdx.x * DTHREADS + threadIdx.x;
  if (idx >= B * Hq * HD) return;
  const int r = idx / HD;  // b * Hq + query head
  const int d = idx - r * HD;
  const int64_t stride = (int64_t)B * Hq;  // rows between splits
  float mm = -INFINITY, ll = 0.f, aa = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) {
    const int64_t row = s * stride + r;
    const float ms = ws_ml[2 * row];
    const float mn = fmaxf(mm, ms);
    const float ref = mn == -INFINITY ? 0.f : mn;
    const float a = exp2f(mm - ref);
    const float w = exp2f(ms - ref);  // an empty split weighs 0
    ll = ll * a + ws_ml[2 * row + 1] * w;
    aa = aa * a + ws_acc[row * HD + d] * w;
    mm = mn;
  }
  const int b = r / Hq;
  const int hq = r - b * Hq;
  o[b * osb + (int64_t)hq * osh + d] =
      from_f32<T>(ll > 0.f ? aa / ll : 0.f);  // nothing kept: 0
}

constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* k_pos, const int* q_pos, void* o, float* ws,
                   int B, int Hq, int Hkv, int S, int G, int chunk,
                   const int64_t* st, float scale, int window,
                   cudaStream_t stream) {
  const int n_split = (S + chunk - 1) / chunk;
  if (n_split > 1 && ws == nullptr) return cudaErrorInvalidValue;
  float* ws_acc = ws;
  float* ws_ml = n_split > 1 ? ws + (int64_t)n_split * B * Hq * HD : nullptr;
  dim3 grid(n_split, Hkv * ((G + GB - 1) / GB), B);
  decode_split_kernel<T, HD><<<grid, DTHREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), k_pos, q_pos, static_cast<T*>(o), ws_acc,
      ws_ml, B, Hq, S, G, chunk, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], scale * LOG2E, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B * Hq * HD + DTHREADS - 1) / DTHREADS);
  cfg.blockDim = dim3(DTHREADS);
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_combine_kernel<T, HD>,
                            (const float*)ws_acc, (const float*)ws_ml,
                            static_cast<T*>(o), B, Hq, n_split, st[9],
                            st[10]);
}

}  // namespace

// strides: 11 int64 element strides: q (b, h), k (b, h, s), v (b, h, s),
// k_pos (b), o (b, h).  `chunk` slots per split, a positive multiple of 32;
// `ws` holds ceil(S / chunk) * B * Hq * (hd + 2) floats when that is > 1
// split, else may be null.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* k_pos,
                                    const void* q_pos, void* o, void* ws,
                                    int dtype, int B, int Hq, int Hkv, int S,
                                    int hd, const int64_t* strides,
                                    float scale, int window, int chunk,
                                    void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || B <= 0 || chunk <= 0 ||
      chunk % CHUNK_ALIGN != 0)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kp = static_cast<const int*>(k_pos);
  const int* qp = static_cast<const int*>(q_pos);
  float* w = static_cast<float*>(ws);
  // the ported configs' head dims: 64 in f32 and bf16, 96, 128 and 256 in
  // bf16 (an f32 row of 256 is 64 lanes of 16 bytes, more than a warp);
  // another one is added with the config that needs it
  if (dtype == DTYPE_F32 && hd == 64)
    return (int)launch<float, 64>(q, k, v, kp, qp, o, w, B, Hq, Hkv, S, G,
                                  chunk, strides, scale, window, s);
  if (dtype == DTYPE_BF16 && hd == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, kp, qp, o, w, B, Hq, Hkv,
                                          S, G, chunk, strides, scale, window,
                                          s);
  if (dtype == DTYPE_BF16 && hd == 96)
    return (int)launch<__nv_bfloat16, 96>(q, k, v, kp, qp, o, w, B, Hq, Hkv,
                                          S, G, chunk, strides, scale, window,
                                          s);
  if (dtype == DTYPE_BF16 && hd == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, kp, qp, o, w, B, Hq, Hkv,
                                           S, G, chunk, strides, scale,
                                           window, s);
  if (dtype == DTYPE_BF16 && hd == 256)
    return (int)launch<__nv_bfloat16, 256>(q, k, v, kp, qp, o, w, B, Hq, Hkv,
                                           S, G, chunk, strides, scale,
                                           window, s);
  return (int)cudaErrorInvalidValue;
}
