// Flash attention forward for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_bhsd, body _flash_kernel): blocked online-softmax GQA
// attention with causal and sliding-window masks, f32 running max, sum and
// accumulator, output in the input's type.
//
// Layout: q (B, Hq, Sq, hd), k/v (B, Hkv, Sk, hd) given by element strides
// (the head dim contiguous), so the model's (B, S, H, hd) tensors go in as
// transposed views without a copy.  Query row i sits at position q_off + i
// and key j at position j: a model rank that computes only its own block of
// the query rows (the sequence split over the model axis) passes the block's
// first position as q_off; 0 is the whole sequence.  Query head h reads KV
// head h / G: no repeated K/V is materialised.  Any Sq and Sk are taken: the
// ragged tail of either is masked, not padded.  Tiles wholly above the
// causal diagonal or below the window are never loaded.  At a q_off that is
// a multiple of the 64-row tile each tile reads the keys, in the order, of
// the unsplit launch's tile at the same positions: its rows are those rows,
// bit for bit.
//
// Bound on the H100: at the serving shapes (S = 128..1000, hd = 64) the
// work is a few GFLOP against a few MB, so the bf16 tensor cores bound it
// at S = 1000 and the bytes (a few us of latency) at S = 128; at gemma3's
// (S 1024, hd 256), qwen3-moe's (S 512, hd 128), zamba2's (S 4608, hd 64),
// mixtral's (S 4608, hd 128, window 4096) and mistral-large's (S 1024, hd
// 128, 96 query heads) the tensor cores; at phi3-mini's (S 1024, hd 96,
// 32 KV heads: no grouping) the two bounds lie within 15% of each other.
//
// bf16 (the model's type), FlashAttention-3's shape kept simple: one CTA of
// one warpgroup (128 threads) owns a 64-row query tile of one (b, h).  TMA
// brings the Q tile and 64-key K/V tiles (8 KiB each, 128-byte swizzle)
// into shared memory, K/V through a 2-stage ring signalled on mbarriers, so
// the next tile's load overlaps this tile's products.  S = Q K^T is a chain
// of four wgmma m64n64k16 (bf16 in, f32 accumulate); the online softmax
// runs in the accumulator's register layout (a row over a quad of threads:
// max and sum by quad shuffles, the scale folded into exp2f).  P goes to
// bf16 in registers as two parts, P = P_hi + P_lo, each the register A
// operand of O += P V with V as the MN-major B operand.  (P rounded once to
// bf16, as the reference's model path rounds it, moves an output near zero
// by up to 3e-3 from the plain version's f32 P, more than the stated
// tolerance; the second part costs half as much tensor work again.)  A tile
// that straddles the diagonal, the window edge or the end of the keys is
// masked element by element (-inf scores, so exp2f gives exactly 0); TMA
// fills rows past the end with zeros.  The output is scaled by 1 / l once
// and stored from registers.
//
// Head dim 256 (gemma3) is the same kernel with each tile four 64-column
// boxes: S = Q K^T contracts over 16 k-steps, and O is four m64n64
// accumulators (128 f32 registers a thread), one per box of V, each fed the
// same P fragments, all four chains under one fence / commit / wait.  Q
// (32 KiB) and two stages of K and V (32 KiB each) take 161 KiB of shared
// memory, so one CTA runs per SM.  Four n64 chains rather than one m64n256
// wgmma: the same tensor work with the helpers the hd-64 kernel uses.
// Head dim 128 (qwen3-moe, and the other hd-128 configs) takes two boxes:
// 8 k-steps for S, two O accumulators (64 f32 registers a thread), and
// 81 KiB of shared memory (opted in), so two CTAs can share an SM.
// Head dim 96 (phi3-mini) is the hd-128 layout with its second box half
// filled: the tensor maps' rows are 96 columns wide, so TMA reads columns
// 96-127 of the second box as zeros.  S = Q K^T runs the 6 k-steps that
// hold data (HD / 16), exact; O's second accumulator spans columns
// 64-127 (the n64 wgmma is the narrowest the helpers issue), of which
// only d < 96 are stored, so P V does a third more tensor work than the
// head dim needs (about 22% more for the kernel's whole MMA work, with P V
// run twice, hi and lo).  The softmax scale is the caller's, 96^-1/2.
//
// f32 keeps the first version: one thread per query row on the f32 CUDA
// cores (K/V tiles of 32 keys staged as f32 in shared memory, read as
// broadcasts), no slower than PyTorch's own attention in f32.  It holds a
// query row and its accumulator in registers (2 hd floats a thread), so it
// is built at hd 64 only: no config serves f32.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;  // query rows per CTA (= threads per CTA)
constexpr int BK = 32;  // keys per shared-memory tile

template <typename T, int HD>
__global__ void __launch_bounds__(BQ) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Sk, int G, int64_t qsb, int64_t qsh,
    int64_t qss, int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
    int64_t vsh, int64_t vss, int64_t osb, int64_t osh, int64_t oss,
    float scale, int causal, int window, int q_off) {
  __shared__ float ks[BK][HD];
  __shared__ float vs[BK][HD];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int hk = h / G;
  const int tid = threadIdx.x;
  const int qi = q0 + tid;
  const bool row_ok = qi < Sq;
  const int qpos = q_off + qi;  // the row's position

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

  // the keys this query tile can see (its rows at q_off + q0 ..)
  const int q_last = q_off + min(q0 + BQ, Sq) - 1;
  int k_end = causal ? min(Sk, q_last + 1) : Sk;
  int k_begin = window > 0 ? max(0, q_off + q0 - window + 1) : 0;
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
      const bool kp = row_ok && kj < Sk && (!causal || kj <= qpos) &&
                      (window <= 0 || kj > qpos - window);
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
                   float scale, int causal, int window, int q_off,
                   cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, HD><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, G, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale, causal, window, q_off);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int WQ = 64;                    // query rows per CTA
constexpr int WK = 64;                    // keys per tile
constexpr int WSTAGES = 2;                // K/V ring depth
constexpr int WTILE = 64 * 64 * 2;        // bytes of one 64 x 64 bf16 box
// 64-column boxes that make a row of head dim HD (the last one part
// filled where HD is not a multiple of 64)
template <int HD>
__host__ __device__ constexpr int nboxes() {
  return (HD + 63) / 64;
}
// dynamic shared memory for head dim HD: the Q tile and WSTAGES K and V
// tiles of nboxes<HD>() boxes each, + 1 KiB to align
template <int HD>
constexpr int wsmem() {
  return WTILE * nboxes<HD>() * (1 + 2 * WSTAGES) + 1024;
}
constexpr float LOG2E = 1.4426950408889634f;

// nboxes<HD>() boxes make a row: box j holds columns 64j..64j+63 of every
// row of a tile (zeros past HD).  S = Q K^T contracts over the HD / 16
// k-steps that hold data (k-step kk reads box kk / 4 at 32 bytes times
// kk % 4); O is nboxes<HD>() accumulators of m64n64, one per box of V,
// fed by the same P fragments, and stores its columns d < HD.
template <int HD>
__global__ void __launch_bounds__(128) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
    int Sq, int Sk, int G, int64_t osb, int64_t osh, int64_t oss,
    float scale_log2, int causal, int window, int q_off) {
  constexpr int NB = nboxes<HD>();        // boxes per row
  constexpr int KSTEPS = HD / 16;         // k-steps of S = Q K^T
  constexpr int TILE = NB * WTILE;        // bytes of one Q, K or V tile
  static_assert(HD % 16 == 0 && HD <= 256,
                "a row is whole k-steps of at most four boxes");
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar_q;
  __shared__ uint64_t bar_kv[WSTAGES];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on it
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* ks = smem + TILE;
  uint8_t* vs = smem + TILE * (1 + WSTAGES);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * WQ;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the keys this query tile can see, in whole tiles; its rows sit at
  // positions p0 = q_off + q0 ..
  const int p0 = q_off + q0;
  const int q_last = q_off + min(q0 + WQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = (window > 0 ? max(0, p0 - window + 1) : 0) / WK * WK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + WK - 1) / WK : 0;

  // K and V tile t of stage s: NB boxes each, one barrier for all of them
  auto load_kv = [&](int s, int row) {
    mbar_expect_tx(&bar_kv[s], 2 * TILE);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      tma_load_4d(ks + s * TILE + j * WTILE, &kmap, &bar_kv[s], 64 * j, row,
                  hk, b);
      tma_load_4d(vs + s * TILE + j * WTILE, &vmap, &bar_kv[s], 64 * j, row,
                  hk, b);
    }
  };

  if (tid == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < WSTAGES; ++s) mbar_init(&bar_kv[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar_q, TILE);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_load_4d(qs + j * WTILE, &qmap, &bar_q, 64 * j, q0, h, b);
    for (int t = 0; t < WSTAGES && t < n_tiles; ++t)
      load_kv(t, k_begin + t * WK);
  }

  // accumulator layout of wgmma m64n64: d[4n + 2i + j] is row r0 + 8i,
  // column 8n + cq + j of the 64 x 64 tile
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float oacc[NB][32];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) oacc[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  mbar_wait(&bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % WSTAGES;
    const int k0 = k_begin + t * WK;
    mbar_wait(&bar_kv[s], (t / WSTAGES) & 1);

    // S = Q K^T over hd: HD / 16 k-steps of 16 (32 bytes each)
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss_m64n64k16(
          sc, wgmma_desc_sw128(qs + (kk >> 2) * WTILE) + 2 * (kk & 3),
          wgmma_desc_sw128(ks + s * TILE + (kk >> 2) * WTILE) + 2 * (kk & 3),
          kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const bool whole = k0 + WK <= Sk && (!causal || k0 + WK - 1 <= p0) &&
                       (window <= 0 || k0 > p0 + WQ - 1 - window);
    if (!whole) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int kj = k0 + 8 * (e >> 2) + cq + (e & 1);
        const int qp = p0 + r0 + 8 * ((e >> 1) & 1);
        const bool keep = kj < Sk && (!causal || kj <= qp) &&
                          (window <= 0 || kj > qp - window);
        if (!keep) sc[e] = -INFINITY;
      }
    }

    // online softmax, one pass per row half i
    float ms[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * i], sc[4 * n + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      // a row with nothing kept yet keeps m = -inf: subtract 0, so every
      // exp2f below sees -inf and gives 0, never NaN
      ms[i] = m_new == -INFINITY ? 0.f : m_new * scale_log2;
      alpha[i] = exp2f(m[i] * scale_log2 - ms[i]);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    // P as bf16 pairs, hi + lo: ph[2n + i] / pl[2n + i] hold row half i of
    // score block n
    uint32_t ph[16], pl[16];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = exp2f(fmaf(sc[4 * n + 2 * i], scale_log2, -ms[i]));
        const float p1 =
            exp2f(fmaf(sc[4 * n + 2 * i + 1], scale_log2, -ms[i]));
        l[i] += p0 + p1;
        split_bf16x2(p0, p1, ph[2 * n + i], pl[2 * n + i]);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        oacc[j][4 * n + 0] *= alpha[0];
        oacc[j][4 * n + 1] *= alpha[0];
        oacc[j][4 * n + 2] *= alpha[1];
        oacc[j][4 * n + 3] *= alpha[1];
      }
    }

    // O += P_hi V + P_lo V: k-step kk takes keys 16kk..16kk+15, i.e. score
    // blocks 2kk and 2kk+1, and V rows 16kk.. (2048 bytes further each),
    // into the accumulator of each box j of V
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t ah[4] = {ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                              ph[4 * kk + 3]};
      const uint32_t al[4] = {pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                              pl[4 * kk + 3]};
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const uint64_t vdesc =
            wgmma_desc_sw128(vs + s * TILE + j * WTILE) + kk * (2048 >> 4);
        wgmma_rs_m64n64k16_tb(oacc[j], ah, vdesc);
        wgmma_rs_m64n64k16_tb(oacc[j], al, vdesc);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_regs(oacc[j]);

    __syncthreads();  // every warp is done with stage s: refill it
    if (tid == 0 && t + WSTAGES < n_tiles) load_kv(s, k0 + WSTAGES * WK);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // nothing kept: 0
    const int qi = q0 + r0 + 8 * i;
    if (qi >= Sq) continue;
    __nv_bfloat16* op = o + b * osb + h * osh + (int64_t)qi * oss;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        if (64 * j + 8 * n < HD)  // columns 8n + cq, + 1 of box j
          *reinterpret_cast<__nv_bfloat162*>(op + 64 * j + 8 * n + cq) =
              __floats2bfloat162_rn(oacc[j][4 * n + 2 * i] * inv,
                                    oacc[j][4 * n + 2 * i + 1] * inv);
  }
}

// one TMA descriptor per operand, encoded on the host for this call, its
// rows HD columns wide (hd 96: the second box reads zeros past column 95);
// above 48 KiB of dynamic shared memory (hd 256: 161 KiB) only after
// opting in,
// per device, so on every launch (a host-side attribute, allowed while a
// CUDA graph captures)
template <int HD>
cudaError_t launch_bf16_wgmma(const void* q, const void* k, const void* v,
                              void* o, int B, int Hq, int Hkv, int Sq, int Sk,
                              int G, const int64_t* st, float scale,
                              int causal, int window, int q_off,
                              cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!encode_rows(&qm, q, HD, Sq, Hq, B, st[2], st[1], st[0]) ||
      !encode_rows(&km, k, HD, Sk, Hkv, B, st[5], st[4], st[3]) ||
      !encode_rows(&vm, v, HD, Sk, Hkv, B, st[8], st[7], st[6]))
    return cudaErrorInvalidValue;
  constexpr int smem = wsmem<HD>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + WQ - 1) / WQ, Hq, B);
  flash_fwd_wgmma_kernel<HD><<<grid, 128, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), Sq, Sk, G, st[9], st[10],
      st[11], scale * LOG2E, causal, window, q_off);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 int64 element strides (b, h, s) for q, k, v, o in that order.
// q_off: the position of query row 0 (>= 0; causal: q_off + Sq <= Sk).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int Hq, int Hkv, int Sq, int Sk, int hd,
                                   const int64_t* strides, float scale,
                                   int causal, int window, int q_off,
                                   void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || B <= 0 ||
      q_off < 0 || (causal && q_off + Sq > Sk))
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // f32 (the SIMT kernel) at hd 64; bf16 (wgmma) at the ported configs'
  // head dims, 64, 96, 128 and 256.  Another one is added with the config
  // that needs it.
  if (dtype == DTYPE_F32 && hd == 64)
    return (int)launch<float, 64>(q, k, v, o, B, Hq, Sq, Sk, G, strides,
                                  scale, causal, window, q_off, s);
  if (dtype == DTYPE_BF16 && hd == 64)
    return (int)launch_bf16_wgmma<64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, G,
                                      strides, scale, causal, window, q_off, s);
  if (dtype == DTYPE_BF16 && hd == 96)
    return (int)launch_bf16_wgmma<96>(q, k, v, o, B, Hq, Hkv, Sq, Sk, G,
                                      strides, scale, causal, window, q_off, s);
  if (dtype == DTYPE_BF16 && hd == 128)
    return (int)launch_bf16_wgmma<128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, G,
                                       strides, scale, causal, window, q_off,
                                       s);
  if (dtype == DTYPE_BF16 && hd == 256)
    return (int)launch_bf16_wgmma<256>(q, k, v, o, B, Hq, Hkv, Sq, Sk, G,
                                       strides, scale, causal, window, q_off,
                                       s);
  return (int)cudaErrorInvalidValue;
}
