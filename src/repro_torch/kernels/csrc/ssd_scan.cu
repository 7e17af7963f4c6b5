// Chunked Mamba2 SSD scan for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (ssd_scan_bhsd,
// body _ssd_kernel).  Per (b, h), over chunks of Q steps with the (P, N)
// state carried from chunk to chunk:
//
//   cum_i   = sum_{t<=i} dt_t A                       (inclusive, per chunk)
//   y_i     = sum_{j<=i} exp(cum_i - cum_j) dt_j (C_i . B_j) x_j
//             + exp(cum_i) C_i . state_in
//   state   = exp(cum_Q) state_in + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T
//
// Head h reads B/C group h / (H / G).  Besides y, the kernel writes the final
// state (B, H, P, N) f32, which the TPU kernel keeps in VMEM and drops; the
// port's prefill needs it for the decode cache.
//
// Layout: x and y (B, H, S, P), dt (B, H, S), B and C (B, G, S, N), given by
// element strides with the last dim contiguous, so the model's (B, S, H, P)
// and (B, S, G, N) views of its conv output go in without a copy.  x, B, C
// and y are bf16 (the model's type), dt and A f32.  Only P = 64 and N = 128
// (mamba2-1.3b) are built; the wrapper refuses other shapes before launch.
//
// Design: the TPU grid's sequential chunk axis becomes a loop inside one CTA
// per (b, h) of 256 threads; the state lives in shared memory (32 KiB f32)
// for the whole sequence.  Per chunk, x (Q x P) and B^T (N x Q) are staged
// in shared memory as bf16, and the query rows are taken 32 at a time: a
// thread per key column j forms the 32 scores C_i . B_j and the masked
// weights W_ij = exp(cum_i - cum_j) dt_j (C_i . B_j) in a shared 32 x Q f32
// tile (a Q x Q f32 tile at Q = 256 would be 256 KiB, over the 227 KiB a
// CTA may have); then a thread per (p, 8 rows) sums W x and C . state.
// The exponential is computed only where j <= i: above the diagonal
// cum_i - cum_j > 0 can overflow to inf, and inf * 0 is NaN.  Row tiles
// skip key columns past their last row (the causal half of the work).
// cum is a block-wide prefix sum in f32 (a shuffle scan, in another order
// than torch.cumsum); PERF.md and the tests state the tolerance.
//
// Bound on the H100: about 33.5 MFLOP per (b, h, chunk) against about
// 85 KB, so operations bound it; this first version runs on the f32 CUDA
// cores (no wgmma/TMA yet), far from the bf16 tensor-core bound.
#include "common.cuh"

namespace {

constexpr int P = 64;          // head dim
constexpr int N = 128;         // state dim
constexpr int QMAX = 256;      // largest chunk
constexpr int R = 32;          // query rows per tile
constexpr int THREADS = 256;
constexpr int BT_LD = QMAX + 4;  // B^T row pitch (bf16): 8-byte aligned rows

struct Strides {
  int64_t xb, xh, xs;   // x (b, h, s); p contiguous
  int64_t db, dh, ds;   // dt (b, h, s)
  int64_t bb, bg, bs;   // B (b, g, s); n contiguous
  int64_t cb, cg, cs;   // C (b, g, s); n contiguous
  int64_t yb, yh, ys;   // y (b, h, s); p contiguous
};

// shared memory, in bytes
constexpr size_t SMEM_STATE = sizeof(float) * N * P;            // [n][p]
constexpr size_t SMEM_X = sizeof(__nv_bfloat16) * QMAX * P;     // [j][p]
constexpr size_t SMEM_BT = sizeof(__nv_bfloat16) * N * BT_LD;   // [n][j]
constexpr size_t SMEM_C = sizeof(float) * R * N;                // [i][n]
constexpr size_t SMEM_W = sizeof(float) * R * QMAX;             // [i][j]
constexpr size_t SMEM_VEC = sizeof(float) * (3 * QMAX + 32);    // cum, dt, wdt
constexpr size_t SMEM_BYTES =
    SMEM_STATE + SMEM_X + SMEM_BT + SMEM_C + SMEM_W + SMEM_VEC;

__device__ __forceinline__ float bf(const __nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void put(__nv_bfloat16* d, __nv_bfloat16 v) {
  *d = v;
}
__device__ __forceinline__ void put(float* d, __nv_bfloat16 v) { *d = bf(v); }

// Copy `rows` rows of COLS contiguous bf16 values (rows `row_stride` apart)
// into shared memory at dst[r * ld + c], or dst[c * ld + r] when
// TRANSPOSE.  Each thread keeps U loads in flight before it stores, so the
// copy waits on device memory about once per U elements, not once each.
template <int COLS, bool TRANSPOSE, typename D>
__device__ __forceinline__ void stage_rows(
    const __nv_bfloat16* __restrict__ src, int64_t row_stride, int rows,
    D* __restrict__ dst, int ld) {
  constexpr int U = 16;
  const int total = rows * COLS;
  for (int e0 = threadIdx.x; e0 < total; e0 += THREADS * U) {
    __nv_bfloat16 v[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int e = e0 + k * THREADS;
      if (e < total) v[k] = src[(int64_t)(e / COLS) * row_stride + e % COLS];
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int e = e0 + k * THREADS;
      if (e < total) {
        const int r = e / COLS, c = e % COLS;
        put(dst + (TRANSPOSE ? c * ld + r : r * ld + c), v[k]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) ssd_scan_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
    const __nv_bfloat16* __restrict__ Cm, __nv_bfloat16* __restrict__ y,
    float* __restrict__ state_out, int H, int G, int S, int Q, Strides st) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* state = reinterpret_cast<float*>(smem);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_STATE);
  __nv_bfloat16* bt =
      reinterpret_cast<__nv_bfloat16*>(smem + SMEM_STATE + SMEM_X);
  float* cs = reinterpret_cast<float*>(smem + SMEM_STATE + SMEM_X + SMEM_BT);
  float* ws = cs + R * N;
  float* cum = ws + R * QMAX;
  float* dts = cum + QMAX;
  float* wdt = dts + QMAX;
  float* warp_tot = wdt + QMAX;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int g = h / (H / G);
  const float a = A[h];

  const __nv_bfloat16* xp = x + b * st.xb + h * st.xh;
  const float* dtp = dt + b * st.db + h * st.dh;
  const __nv_bfloat16* bp = Bm + b * st.bb + g * st.bg;
  const __nv_bfloat16* cp = Cm + b * st.cb + g * st.cg;
  __nv_bfloat16* yp = y + b * st.yb + h * st.yh;

  for (int e = tid; e < N * P; e += THREADS) state[e] = 0.f;

  // thread roles in the y and state phases: column p, a group of rows/n
  const int p = tid % P;
  const int grp = tid / P;  // 0..3

  for (int c0 = 0; c0 < S; c0 += Q) {
    // ---- stage the chunk: dt, cum (block prefix sum), x, B^T ----------
    float d = 0.f, v = 0.f;
    if (tid < Q) {
      d = dtp[(int64_t)(c0 + tid) * st.ds];
      v = d * a;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) warp_tot[warp] = v;
    stage_rows<P, false>(xp + (int64_t)c0 * st.xs, st.xs, Q, xs, P);
    stage_rows<N, true>(bp + (int64_t)c0 * st.bs, st.bs, Q, bt, BT_LD);
    __syncthreads();
    if (tid < Q) {
      float prefix = 0.f;
      for (int w = 0; w < warp; ++w) prefix += warp_tot[w];
      cum[tid] = prefix + v;
      dts[tid] = d;
    }
    __syncthreads();
    const float total = cum[Q - 1];
    if (tid < Q) wdt[tid] = expf(total - cum[tid]) * dts[tid];

    // ---- y, 32 query rows at a time -------------------------------------
    for (int r0 = 0; r0 < Q; r0 += R) {
      const int jmax = r0 + R;  // key columns this row tile needs
      stage_rows<N, false>(cp + (int64_t)(c0 + r0) * st.cs, st.cs, R, cs, N);
      __syncthreads();
      if (tid < jmax) {
        const int j = tid;
        float acc[R];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] = 0.f;
        for (int n = 0; n < N; n += 4) {
          const float b0 = bf(bt[(n + 0) * BT_LD + j]);
          const float b1 = bf(bt[(n + 1) * BT_LD + j]);
          const float b2 = bf(bt[(n + 2) * BT_LD + j]);
          const float b3 = bf(bt[(n + 3) * BT_LD + j]);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float4 cv = *reinterpret_cast<const float4*>(cs + i * N + n);
            acc[i] += cv.x * b0 + cv.y * b1 + cv.z * b2 + cv.w * b3;
          }
        }
        const float cj = cum[j], dj = dts[j];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int gi = r0 + i;
          // exp only on or below the diagonal: never inf * 0
          ws[i * QMAX + j] = j <= gi ? expf(cum[gi] - cj) * dj * acc[i] : 0.f;
        }
      }
      __syncthreads();
      // rows grp*8 .. grp*8+7 of the tile, column p
      float yi[8], yc[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) yi[k] = yc[k] = 0.f;
      for (int j = 0; j < jmax; j += 4) {
        const float x0 = bf(xs[(j + 0) * P + p]);
        const float x1 = bf(xs[(j + 1) * P + p]);
        const float x2 = bf(xs[(j + 2) * P + p]);
        const float x3 = bf(xs[(j + 3) * P + p]);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float4 w =
              *reinterpret_cast<const float4*>(ws + (grp * 8 + k) * QMAX + j);
          yi[k] += w.x * x0 + w.y * x1 + w.z * x2 + w.w * x3;
        }
      }
      for (int n = 0; n < N; n += 4) {
        const float s0 = state[(n + 0) * P + p];
        const float s1 = state[(n + 1) * P + p];
        const float s2 = state[(n + 2) * P + p];
        const float s3 = state[(n + 3) * P + p];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float4 cv =
              *reinterpret_cast<const float4*>(cs + (grp * 8 + k) * N + n);
          yc[k] += cv.x * s0 + cv.y * s1 + cv.z * s2 + cv.w * s3;
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int gi = r0 + grp * 8 + k;
        yp[(int64_t)(c0 + gi) * st.ys + p] =
            __float2bfloat16(yi[k] + expf(cum[gi]) * yc[k]);
      }
      __syncthreads();  // cs and ws are rewritten by the next row tile
    }

    // ---- state update: n = grp*32 .. grp*32+31, column p -----------------
    {
      const float decay = expf(total);
      float acc[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = 0.f;
      for (int j = 0; j < Q; j += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(wdt + j);
        const float x0 = bf(xs[(j + 0) * P + p]) * wv.x;
        const float x1 = bf(xs[(j + 1) * P + p]) * wv.y;
        const float x2 = bf(xs[(j + 2) * P + p]) * wv.z;
        const float x3 = bf(xs[(j + 3) * P + p]) * wv.w;
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const uint2 raw = *reinterpret_cast<const uint2*>(
              bt + (grp * 32 + k) * BT_LD + j);
          const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
          const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
          acc[k] += x0 * __low2float(lo) + x1 * __high2float(lo) +
                    x2 * __low2float(hi) + x3 * __high2float(hi);
        }
      }
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        float* s = state + (grp * 32 + k) * P + p;
        *s = decay * *s + acc[k];
      }
    }
    __syncthreads();  // xs, bt and the state are read by the next chunk
  }

  // final state, (P, N) for this (b, h), f32
  float* so = state_out + (int64_t)bh * P * N;
  for (int e = tid; e < P * N; e += THREADS) {
    const int pp = e / N, n = e % N;
    so[e] = state[n * P + pp];
  }
}

}  // namespace

extern "C" long long ssd_scan_smem_bytes() { return (long long)SMEM_BYTES; }

// x, y: (B, H, S, 64) bf16; dt: (B, H, S) f32; A: (H,) f32; Bm, Cm:
// (B, G, S, 128) bf16; state_out: (B, H, 64, 128) f32 contiguous.
// strides: 15 int64 element strides, (b, h|g, s) for x, dt, Bm, Cm, y.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y,
                            void* state_out, int B, int H, int G, int S,
                            int Q, int P_, int N_, const int64_t* strides,
                            void* stream) {
  if (P_ != P || N_ != N) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || Q <= 0 || Q > QMAX ||
      Q % R != 0 || S <= 0 || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // above 48 KiB of dynamic shared memory only after opting in (per
  // device, so on every launch; it is a host-side attribute, not a stream
  // operation, and is allowed while a CUDA graph captures)
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  Strides st;
  const int64_t* s = strides;
  st.xb = s[0]; st.xh = s[1]; st.xs = s[2];
  st.db = s[3]; st.dh = s[4]; st.ds = s[5];
  st.bb = s[6]; st.bg = s[7]; st.bs = s[8];
  st.cb = s[9]; st.cg = s[10]; st.cs = s[11];
  st.yb = s[12]; st.yh = s[13]; st.ys = s[14];
  ssd_scan_kernel<<<B * H, THREADS, SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(state_out), H, G, S, Q, st);
  return (int)cudaGetLastError();
}
