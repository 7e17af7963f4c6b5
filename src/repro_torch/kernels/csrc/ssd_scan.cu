// Chunked Mamba2 SSD scan for sm_90a, on the tensor cores.
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
// and (B, S, G, N) views of its conv output go in without a copy (rows of
// x, B and C start on 16 bytes, as TMA needs: the wrapper checks).  x, B, C
// and y are bf16 (the model's type), dt and A f32.  P = 64 is built with
// N = 128 (mamba2-1.3b) and N = 64 (zamba2-1.2b), N a template parameter,
// for chunks that are multiples of 32 up to 256; the wrapper refuses other
// shapes before launch.
//
// Bound on the H100 at the serving shape (B 4, H 64, G 1, S 512, Q 256): by
// bytes 0.01299 ms (about 43 MB: x, B, C and dt read once, y and the state
// written once); by operations about 10.7 GFLOP of causal work, 0.011 ms at
// 989 TFLOP/s, or about 17.4 GFLOP with the second bf16 part of the f32
// factors below, 0.018 ms.  So the kernel's own tensor work bounds it, and
// that is the bound the design aims at.
//
// Design.  Every product runs on the tensor cores as wgmma m64n64k16, bf16
// in and f32 accumulate.  C.B^T has bf16 factors, so one chain is exact.
// The other three products have one f32 factor: W = exp(cum_i - cum_j) dt_j
// C.B^T in W.x, the state in C.state, and wdt_j x_j (wdt = exp(total - cum)
// dt) in the state update.  Each goes in as two bf16 parts, hi = bf16(v) and
// lo = bf16(v - hi), run as two chains into one accumulator: about 2^-17
// relative, where one rounding (2^-9) misses the stated tolerance of the
// final state (tests/test_torch_ssd_design.py).
//
// One CTA of one warpgroup (128 threads) per (b, h) walks the chunks in
// order (the TPU grid's sequential chunk axis).  The state's f32
// accumulator stays in registers across chunks (64 x N: N / 64 m64n64
// accumulators), and a bf16 hi/lo copy of it sits in shared memory as the
// B operand of C.state.  TMA brings C, B and x in 64-row tiles (128-byte
// swizzle; a row of B or C is N / 64 boxes) into a C tile and two key
// buffers (B and x), 102,528 bytes of shared memory in all at N = 128 and
// 61,568 at N = 64, so two CTAs share an SM: the 256 CTAs of mamba2's
// serving shape (128 of zamba2's) are resident at once, and one CTA's
// loads and barriers overlap the other's products.  Per chunk:
//   1. dt, cum (a block-wide f32 prefix sum, in another order than
//      torch.cumsum), wdt, and per step cum log2(e) and
//      u = cum log2(e) - log2(dt) into shared memory;
//   2. per 64-row block of C: exp(cum_i) C.state (C and the state from
//      shared memory), then per key tile at or before the block the 64 x 64
//      scores S = C.B^T (both from shared memory), W = S exp(cum_i - cum_j)
//      dt_j = S exp2(cum_i log2(e) - u_j), one exp2 a score, kept only
//      where j <= i (above it the exponent is positive and can overflow,
//      and inf * 0 is NaN), packed in registers as the hi and lo A operands
//      of W.x (x from shared memory, MN-major).  Row block rb takes key tiles 0..rb, ascending when rb is
//      odd and descending when even, so consecutive blocks begin with the
//      tiles the last one ended on; each step prefetches the next step's
//      tile when it is not resident;
//   3. the last row block meets every key tile once and also runs the
//      state update: the accumulator scaled by exp(total), then A = (wdt x)^T
//      (ldmatrix.trans from the x tile, scaled and split in registers)
//      against the B tile, MN-major.
// C.B^T is not shared across the heads of a group: a CTA that took two
// heads would halve the grid to 128 CTAs, fewer than the 132 SMs, and need
// a second state copy that two CTAs per SM leave no room for.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int P = 64;           // head dim
constexpr int QMAX = 256;       // largest chunk
constexpr int QALIGN = 32;      // chunks are whole multiples of this
constexpr int TILE = 64;        // rows of C, keys of B and x per tile
constexpr int THREADS = 128;    // one warpgroup
constexpr int BOX = 64 * 64 * 2;                 // one 64 x 64 bf16 box
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory for state dim N: a row of B or C is NB = N / 64 boxes.
template <int N>
struct Smem {
  static constexpr int NB = N / 64;
  static constexpr int OFF_C = 0;                      // C tile: NB boxes
  static constexpr int OFF_B = OFF_C + NB * BOX;       // B tiles: 2 x NB
  static constexpr int OFF_X = OFF_B + 2 * NB * BOX;   // x tiles: 2 x 1 box
  static constexpr int OFF_SH = OFF_X + 2 * BOX;       // state hi: NB boxes
  static constexpr int OFF_SL = OFF_SH + NB * BOX;     // state lo: NB boxes
  static constexpr int OFF_VEC = OFF_SL + NB * BOX;    // f32 vectors below
  static constexpr int BYTES = OFF_VEC + 4 * (3 * QMAX + 32) + 1024;  // align
  // two CTAs per SM: 228 KiB of shared memory, 1 KiB of it reserved per CTA
  static_assert(N % 64 == 0, "a row of B or C is whole 64-value boxes");
  static_assert(2 * (BYTES + 64 + 1024) <= 228 * 1024, "two CTAs per SM");
};

struct Strides {
  int64_t xb, xh, xs;   // x (b, h, s); p contiguous
  int64_t db, dh, ds;   // dt (b, h, s)
  int64_t yb, yh, ys;   // y (b, h, s); p contiguous
};

// byte offset of (row, 16-byte chunk) in a 128-byte-swizzled 64-row box
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

template <int N>
__global__ void __launch_bounds__(THREADS, 2) ssd_scan_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap bmap,
    const __grid_constant__ CUtensorMap cmap, const float* __restrict__ dt,
    const float* __restrict__ A, __nv_bfloat16* __restrict__ y,
    float* __restrict__ state_out, int H, int G, int S, int Q, Strides st) {
  using L = Smem<N>;
  constexpr int NB = L::NB;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_c;
  __shared__ uint64_t bar_k[2];
  // the 128-byte swizzle repeats every 1024 bytes: boxes start on it
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* cs = smem + L::OFF_C;
  uint8_t* sth = smem + L::OFF_SH;
  uint8_t* stl = smem + L::OFF_SL;
  // per step of the chunk: cum log2(e); cum log2(e) - log2(dt), so that
  // exp(cum_i - cum_j) dt_j = exp2(cum2_i - u_j); wdt; and the scan's sums
  float* cum2 = reinterpret_cast<float*>(smem + L::OFF_VEC);
  float* u = cum2 + QMAX;
  float* wdt = u + QMAX;
  float* warp_tot = wdt + QMAX;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int grp = h / (H / G);
  const float a = A[h];
  const float* dtp = dt + b * st.db + h * st.dh;
  __nv_bfloat16* yp = y + b * st.yb + h * st.yh;

  // accumulator layout of wgmma m64n64: d[4n + 2i + j] is row r0 + 8i,
  // column 8n + cq + j of the 64 x 64 tile
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  // ldmatrix.trans of the A operand (wdt x)^T from the x tile [key][p]:
  // this lane's row (key) and 16-byte chunk (p / 8) of its 8 x 8 matrix
  const int mi = lane >> 3;
  const int ld_key = (lane & 7) + (mi >> 1) * 8;
  const int ld_chunk = 2 * warp + (mi & 1);

  if (tid == 0) {
    mbar_init(&bar_c, 1);
    mbar_init(&bar_k[0], 1);
    mbar_init(&bar_k[1], 1);
    mbar_fence_init();
  }
  __syncthreads();

  // state[p][n]: sacc[hh] holds n 64hh..64hh+63, rows p = r0 (+8)
  float sacc[NB][32];
#pragma unroll
  for (int hh = 0; hh < NB; ++hh)
#pragma unroll
    for (int e = 0; e < 32; ++e) sacc[hh][e] = 0.f;

  const int nblk = (Q + TILE - 1) / TILE;   // row blocks = key tiles
  uint32_t c_loads = 0, k_loads[2] = {0, 0};

  for (int c0 = 0; c0 < S; c0 += Q) {
    // ---- 1. dt, cum (block prefix sum, two steps a thread), wdt ---------
    float d0 = 0.f, d1 = 0.f;
    if (2 * tid < Q) {
      d0 = dtp[(int64_t)(c0 + 2 * tid) * st.ds];
      d1 = dtp[(int64_t)(c0 + 2 * tid + 1) * st.ds];
    }
    const float s0 = d0 * a;
    const float s1 = s0 + d1 * a;
    float v = s1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    float prefix = v - s1;
    for (int w = 0; w < warp; ++w) prefix += warp_tot[w];
    const float cum0 = prefix + s0, cum1 = prefix + s1;
    if (2 * tid < Q) {
      cum2[2 * tid] = cum0 * LOG2E;
      cum2[2 * tid + 1] = cum1 * LOG2E;
      // dt = 0 gives u = inf, so exp2 gives exactly 0
      u[2 * tid] = cum0 * LOG2E - log2f(d0);
      u[2 * tid + 1] = cum1 * LOG2E - log2f(d1);
    }
    if (2 * tid + 1 == Q - 1) warp_tot[8] = cum1;   // the chunk's total
    __syncthreads();
    const float total = warp_tot[8];
    if (2 * tid < Q) {
      wdt[2 * tid] = expf(total - cum0) * d0;
      wdt[2 * tid + 1] = expf(total - cum1) * d1;
    }

    // ---- 2. y, 64 rows at a time; 3. the state update -------------------
    int tile_in[2] = {-1, -1};   // key tile in each buffer
    int buf = 0;                 // buffer of the current step
    // key tile kt (B: NB boxes, x: one) into buffer kb, by one thread
    auto load_keys = [&](int kt, int kb) {
      if (tid == 0) {
        const int row = c0 + kt * TILE;
        uint8_t* bt = smem + L::OFF_B + kb * NB * BOX;
        mbar_expect_tx(&bar_k[kb], (NB + 1) * BOX);
#pragma unroll
        for (int hh = 0; hh < NB; ++hh)
          tma_load_4d(bt + hh * BOX, &bmap, &bar_k[kb], 64 * hh, row, grp,
                      b);
        tma_load_4d(smem + L::OFF_X + kb * BOX, &xmap, &bar_k[kb], 0, row, h,
                    b);
      }
      ++k_loads[kb];
      tile_in[kb] = kt;
    };
    for (int rb = 0; rb < nblk; ++rb) {
      const bool last = rb == nblk - 1;
      if (tid == 0) {
        mbar_expect_tx(&bar_c, NB * BOX);
#pragma unroll
        for (int hh = 0; hh < NB; ++hh)
          tma_load_4d(cs + hh * BOX, &cmap, &bar_c, 64 * hh, c0 + rb * TILE,
                      grp, b);
      }
      ++c_loads;
      if (last) {
        const float decay = expf(total);
#pragma unroll
        for (int hh = 0; hh < NB; ++hh)
#pragma unroll
          for (int e = 0; e < 32; ++e) sacc[hh][e] *= decay;
      }
      float yacc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) yacc[e] = 0.f;
      // rows r0 and r0 + 8 of the block, as chunk rows
      const int row0 = rb * TILE + r0, row1 = row0 + 8;

      for (int step = 0; step <= rb; ++step) {
        const int kt = (rb & 1) ? step : rb - step;
        if (tile_in[buf] != kt) {
          buf = tile_in[0] == kt ? 0 : tile_in[1] == kt ? 1 : buf ^ 1;
          if (tile_in[buf] != kt) load_keys(kt, buf);  // chunk's first step
        }
        // the next step's tile, into the other buffer (free: the step
        // that last read it ended on a barrier)
        int nk = -1;
        if (step < rb) nk = (rb & 1) ? step + 1 : rb - step - 1;
        else if (!last) nk = (rb & 1) ? rb + 1 : 0;   // (rb + 1)'s first
        if (nk >= 0 && tile_in[0] != nk && tile_in[1] != nk)
          load_keys(nk, buf ^ 1);
        if (step == 0) mbar_wait(&bar_c, (c_loads - 1) & 1);
        mbar_wait(&bar_k[buf], (k_loads[buf] - 1) & 1);
        uint8_t* kb = smem + L::OFF_B + buf * NB * BOX;
        uint8_t* kx = smem + L::OFF_X + buf * BOX;

        if (step == 0 && c0 > 0) {
          // exp(cum_i) C_i . state_in, state as hi + lo
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4 * NB; ++kk) {
            const uint64_t ad = wgmma_desc_sw128(cs + (kk >> 2) * BOX) +
                                2 * (kk & 3);
            const int so = (kk >> 2) * BOX;
            wgmma_ss_m64n64k16(yacc, ad, wgmma_desc_sw128(sth + so) +
                                             2 * (kk & 3), 1);
            wgmma_ss_m64n64k16(yacc, ad, wgmma_desc_sw128(stl + so) +
                                             2 * (kk & 3), 1);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(yacc);
          const float e0 = exp2f(cum2[min(row0, Q - 1)]);
          const float e1 = exp2f(cum2[min(row1, Q - 1)]);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            yacc[4 * n + 0] *= e0;
            yacc[4 * n + 1] *= e0;
            yacc[4 * n + 2] *= e1;
            yacc[4 * n + 3] *= e1;
          }
        }

        // S = C . B^T over N: NB boxes of 64 along N
        float sc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * NB; ++kk)
          wgmma_ss_m64n64k16(
              sc, wgmma_desc_sw128(cs + (kk >> 2) * BOX) + 2 * (kk & 3),
              wgmma_desc_sw128(kb + (kk >> 2) * BOX) + 2 * (kk & 3), kk);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // W, kept where key <= row < Q, as hi + lo bf16 pairs: ph[2n + i]
        // holds row r0 + 8i, keys 8n + cq, +1
        uint32_t ph[16], pl[16];
        const float ci[2] = {cum2[min(row0, Q - 1)], cum2[min(row1, Q - 1)]};
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int key = kt * TILE + 8 * n + cq;
          const float2 uj =
              *reinterpret_cast<const float2*>(u + min(key, Q - 2));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = i ? row1 : row0;
            const bool ok = row < Q;
            const float w0 = ok && key <= row
                                 ? exp2f(ci[i] - uj.x) * sc[4 * n + 2 * i]
                                 : 0.f;
            const float w1 = ok && key + 1 <= row
                                 ? exp2f(ci[i] - uj.y) * sc[4 * n + 2 * i + 1]
                                 : 0.f;
            split_bf16x2(w0, w1, ph[2 * n + i], pl[2 * n + i]);
          }
        }

        // y += W_hi x + W_lo x: k-step kk takes keys 16kk.., x rows 16kk..
        const uint64_t xd = wgmma_desc_sw128(kx);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t ah[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                                  ph[4 * kk + 3]};
          const uint32_t al[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                                  pl[4 * kk + 3]};
          wgmma_rs_m64n64k16_tb(yacc, ah, xd + kk * (2048 >> 4));
          wgmma_rs_m64n64k16_tb(yacc, al, xd + kk * (2048 >> 4));
        }
        wgmma_commit();

        if (last) {
          // state += (wdt x)^T B over this key tile's 64 keys: A from the
          // x tile by ldmatrix.trans (register r: rows p 16 warp + g (+8),
          // keys 2 t + 8 (r / 2), +1), scaled and split; B MN-major
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            uint32_t xa[4], ah[4], al[4];
            ldsm_x4_t(xa, kx + swz(16 * kk + ld_key, ld_chunk));
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int key = kt * TILE + 16 * kk + cq + 8 * (r >> 1);
              const float2 xv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&xa[r]));
              const float w0 = key < Q ? wdt[key] : 0.f;
              const float w1 = key + 1 < Q ? wdt[key + 1] : 0.f;
              split_bf16x2(xv.x * w0, xv.y * w1, ah[r], al[r]);
            }
            wgmma_fence();
#pragma unroll
            for (int hh = 0; hh < NB; ++hh) {
              const uint64_t bd =
                  wgmma_desc_sw128(kb + hh * BOX) + kk * (2048 >> 4);
              wgmma_rs_m64n64k16_tb(sacc[hh], ah, bd);
              wgmma_rs_m64n64k16_tb(sacc[hh], al, bd);
            }
          }
          wgmma_commit();
          wgmma_wait_all();
#pragma unroll
          for (int hh = 0; hh < NB; ++hh) fence_regs(sacc[hh]);
        }
        wgmma_wait_all();
        fence_regs(yacc);
        __syncthreads();   // this key buffer is free for a prefetch
      }

      // y for the rows of this block inside the chunk
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = i ? row1 : row0;
        if (row >= Q) continue;
        __nv_bfloat16* yr = yp + (int64_t)(c0 + row) * st.ys + cq;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(yr + 8 * n) =
              __floats2bfloat162_rn(yacc[4 * n + 2 * i],
                                    yacc[4 * n + 2 * i + 1]);
      }
      // (the C tile is free: every warp passed the step's barrier)
    }

    // the hi + lo copy of the state that the next chunk's C.state reads,
    // in the swizzled layout of its NB boxes [p][n 64hh..64hh+63]
    if (c0 + Q < S) {
#pragma unroll
      for (int hh = 0; hh < NB; ++hh)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int p = r0 + 8 * i;
            const int off = hh * BOX + swz(p, n) + 2 * cq;
            uint32_t hi, lo;
            split_bf16x2(sacc[hh][4 * n + 2 * i], sacc[hh][4 * n + 2 * i + 1],
                         hi, lo);
            *reinterpret_cast<uint32_t*>(sth + off) = hi;
            *reinterpret_cast<uint32_t*>(stl + off) = lo;
          }
      fence_proxy_async();
    }
    __syncthreads();
  }

  // final state, (P, N) for this (b, h), f32, from the registers
  float* so = state_out + (int64_t)bh * P * N;
#pragma unroll
  for (int hh = 0; hh < NB; ++hh)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(so + (r0 + 8 * i) * N + 64 * hh + 8 * n +
                                   cq) =
            make_float2(sacc[hh][4 * n + 2 * i], sacc[hh][4 * n + 2 * i + 1]);
}

template <int N>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* state_out,
                   int B, int H, int G, int S, int Q, const int64_t* s,
                   cudaStream_t stream) {
  CUtensorMap xm, bm, cm;
  if (!encode_rows(&xm, x, P, S, H, B, s[2], s[1], s[0]) ||
      !encode_rows(&bm, Bm, N, S, G, B, s[8], s[7], s[6]) ||
      !encode_rows(&cm, Cm, N, S, G, B, s[11], s[10], s[9]))
    return cudaErrorInvalidValue;
  // above 48 KiB of dynamic shared memory only after opting in (per
  // device, so on every launch; it is a host-side attribute, not a stream
  // operation, and is allowed while a CUDA graph captures)
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<N>::BYTES);
  if (e != cudaSuccess) return e;
  Strides st;
  st.xb = s[0]; st.xh = s[1]; st.xs = s[2];
  st.db = s[3]; st.dh = s[4]; st.ds = s[5];
  st.yb = s[12]; st.yh = s[13]; st.ys = s[14];
  ssd_scan_kernel<N><<<B * H, THREADS, Smem<N>::BYTES, stream>>>(
      xm, bm, cm, static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(state_out), H, G, S, Q, st);
  return cudaGetLastError();
}

}  // namespace

// shared memory one CTA takes at state dim N (0 for a dim not built)
extern "C" long long ssd_scan_smem_bytes(int N) {
  return N == 128 ? (long long)Smem<128>::BYTES
         : N == 64 ? (long long)Smem<64>::BYTES
                   : 0;
}

// x, y: (B, H, S, 64) bf16; dt: (B, H, S) f32; A: (H,) f32; Bm, Cm:
// (B, G, S, N) bf16 with N 128 or 64; state_out: (B, H, 64, N) f32
// contiguous.  strides: 15 int64 element strides, (b, h|g, s) for x, dt,
// Bm, Cm, y.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y,
                            void* state_out, int B, int H, int G, int S,
                            int Q, int P_, int N_, const int64_t* strides,
                            void* stream) {
  if (P_ != P || (N_ != 128 && N_ != 64)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || Q <= 0 || Q > QMAX ||
      Q % QALIGN != 0 || S <= 0 || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N_ == 128)
    return (int)launch<128>(x, dt, A, Bm, Cm, y, state_out, B, H, G, S, Q,
                            strides, st);
  return (int)launch<64>(x, dt, A, Bm, Cm, y, state_out, B, H, G, S, Q,
                         strides, st);
}
