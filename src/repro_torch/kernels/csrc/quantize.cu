// Blockwise int8 quantize / dequantize for sm_90a, a slab of items a launch.
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
// Formats.  Quantize: item i's n_i f32 values form nb_i blocks (nb_i a
// multiple of TILE, at least ceil(n_i / 256): the wrapper pads to the TPU
// kernel's multiple of 8 blocks), rows first_i .. first_i + nb_i - 1 of one
// (sum nb, 256) int8 output and of one (sum nb,) f32 scale output; values
// past n_i are zeros, so padding blocks come out q 0, scale 0.  Dequantize:
// item i's codes (rows of 256) and scales give its n_i values at offset
// first_i of one f32 output.
//
// Bound on the H100: bytes (a few f32 operations a 4-byte value).  One item
// of 2 MiB is too small for any launch to approach the memory rate, so each
// direction is one persistent kernel over a whole slab of items:
// * The item table is the kernel's __grid_constant__ parameter (up to
//   32,764 bytes on Hopper with CUDA >= 12.1): no copy of it precedes the
//   launch.  A small instantiation serves up to 4 items, so a single-item
//   launch does not upload 10 KB of parameters.
// * The items' blocks form one space of tiles of TILE blocks that never
//   cross an item.  The grid is what the SMs hold at once (the occupancy
//   API's CTAs a SM, capped, times the SM count), fewer where the slab has
//   fewer tiles, so every CTA is resident from the start.  CTA b walks
//   tiles b, b + grid, b + 2 grid, ... (the CTAs read one window of the
//   slab together), and a cursor into the table follows it from item to
//   item.
// * Quantize is a register-pipelined stream: each of a CTA's 8 warps takes
//   one block of each tile and keeps the loads of its next QUANT_DEPTH
//   blocks in flight in registers while it reduces and writes the current
//   one.  Lane l holds values 4l .. 4l+3 and 128 + 4l .., two 16-byte loads;
//   the block's max meets in shuffles; the codes leave as 4-byte words (each
//   warp store instruction covers 128 contiguous bytes, whole lines) and the
//   scale once a block.
// * Dequantize reads through a ring of DEQUANT_STAGES shared-memory stages:
//   the CTA's last warp is the producer, one lane issuing a 1-D bulk copy
//   (TMA without a tensor map) of each tile's codes, and of its scales where
//   they start on 16 bytes, completing on the stage's `full` mbarrier; it
//   refills a stage once the 8 consumer warps have arrived on its `empty`
//   mbarrier.  A consumer warp takes one block of each tile from shared
//   memory and writes its values as 16-byte stores, 512 contiguous bytes a
//   warp instruction.
// * The last 1-3 values of an item whose length is not a multiple of 4 are
//   read one by one, zeros past the item's end and never a byte past it;
//   padding blocks are written without any read.  Items are read where
//   they lie: the wrapper copies only one whose address is not 16-byte
//   aligned.
// Each direction ships the faster of the two persistent designs on the
// card: tools/quantize_designs.py builds this file and the other design of
// each direction (tools/quantize_designs.cu) and times them in one process
// (PERF.md section 6).  The stream was the faster quantize at every shape
// measured; the ring the faster dequantize at 64 MiB and on whole
// stagings' slabs.  One warp a block with a CTA a tile, not persistent,
// measured faster than both.
#include <algorithm>
#include <atomic>

#include "common.cuh"
#include "hopper.cuh"

// a build may override these (tools/quantize_designs.py sweeps them):
// quantize loads in flight a warp beyond the block it works on, and CTAs a
// SM at most; dequantize ring stages and CTAs a SM
#ifndef QUANT_DEPTH
#define QUANT_DEPTH 1
#endif
#ifndef QUANT_CTAS
#define QUANT_CTAS 8
#endif
#ifndef DEQUANT_STAGES
#define DEQUANT_STAGES 8  // 2 KiB of codes and 32 bytes of scales a stage
#endif
#ifndef DEQUANT_CTAS
#define DEQUANT_CTAS 4
#endif

namespace {

constexpr int BLOCK = 256;  // values a block (one scale)
constexpr int TILE = 8;     // blocks a tile: one a warp
constexpr int Q_THREADS = 32 * TILE;
constexpr int D_THREADS = 32 * (TILE + 1);  // + the producer warp
constexpr int D_STAGE_WORDS = TILE * BLOCK / 4 + TILE;  // codes, then scales
// table capacities, mirrored in kernels/quantize.py (MAX_ITEMS)
constexpr int MAX_ITEMS = 256;
constexpr int SMALL_ITEMS = 4;

struct Item {
  long long src;     // f32 values (quantize) or int8 codes (dequantize)
  long long scales;  // dequantize: the item's f32 scales
  long long n;       // values
  long long first;   // quantize: first output row; dequantize: first value
  long long tile0;   // first tile of the item in the launch
};

template <int MI>
struct Table {
  long long out;         // quantize: int8 rows; dequantize: f32 values
  long long out_scales;  // quantize: f32 scales
  long long tiles;
  int n_items;
  Item items[MI];
};

// the item holding tile `tile`: the last i with tile0 <= tile (an item with
// no tiles shares its tile0 with the next, which is the one found)
template <int MI>
__device__ __forceinline__ int find_item(const Table<MI>& t, long long tile) {
  int lo = 0, hi = t.n_items - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.items[mid].tile0 <= tile) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// move cursor `it` forward to the item holding `tile` (tiles only grow)
template <int MI>
__device__ __forceinline__ void advance(const Table<MI>& t, int& it,
                                        long long tile) {
  while (it + 1 < t.n_items && tile >= t.items[it + 1].tile0) ++it;
}

// ---------------------------------------------------------------------------
// quantize: a register-pipelined stream
// ---------------------------------------------------------------------------

// values i .. i+3 of an item of n values: one 16-byte load where all four
// lie in the item, zeros past its end
__device__ __forceinline__ float4 load4(const float* __restrict__ x,
                                        long long i, long long n) {
  if (i + 3 < n) return __ldg(reinterpret_cast<const float4*>(x + i));
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

// start the loads of this warp's block of tile `tile` (zeros for a tile
// past the slab, for a padding block, and past the item's end)
template <int MI>
__device__ __forceinline__ void q_load(const Table<MI>& t, int& it,
                                       long long tile, int warp, int lane,
                                       float4& lo, float4& hi) {
  lo = make_float4(0.f, 0.f, 0.f, 0.f);
  hi = lo;
  if (tile >= t.tiles) return;
  advance(t, it, tile);
  const Item& I = t.items[it];
  const long long v = ((tile - I.tile0) * TILE + warp) * BLOCK;
  if (v >= I.n) return;  // a padding block reads nothing
  const float* x = reinterpret_cast<const float*>(I.src);
  lo = load4(x, v + 4 * lane, I.n);
  hi = load4(x, v + 128 + 4 * lane, I.n);
}

template <int MI>
__global__ void __launch_bounds__(Q_THREADS)
    quantize_items_kernel(const __grid_constant__ Table<MI> t) {
  constexpr int D = QUANT_DEPTH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long t0 = blockIdx.x, dt = gridDim.x;
  int li = find_item(t, t0), pi = li;  // cursors: loads, writes
  int8_t* q = reinterpret_cast<int8_t*>(t.out);
  float* scales = reinterpret_cast<float*>(t.out_scales);
  float4 lo[D], hi[D];
#pragma unroll
  for (int j = 0; j < D; ++j)
    q_load(t, li, t0 + j * dt, warp, lane, lo[j], hi[j]);
  for (long long base = t0; base < t.tiles; base += D * dt) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const long long tile = base + j * dt;
      if (tile >= t.tiles) break;
      const float4 a = lo[j], b = hi[j];
      q_load(t, li, tile + D * dt, warp, lane, lo[j], hi[j]);
      advance(t, pi, tile);
      const Item& I = t.items[pi];
      float m = fmaxf(amax4(a), amax4(b));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float scale = m / 127.0f;  // IEEE division (no fast math)
      const float safe = scale > 0.f ? scale : 1.f;
      const long long row = I.first + (tile - I.tile0) * TILE + warp;
      uint32_t* words = reinterpret_cast<uint32_t*>(q + row * BLOCK);
      words[lane] = pack4(a, safe);
      words[32 + lane] = pack4(b, safe);
      if (lane == 0) scales[row] = scale;
    }
  }
}

// ---------------------------------------------------------------------------
// dequantize: a ring of shared-memory stages filled by 1-D bulk copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 unpack4(uint32_t w, float s) {
  return make_float4((float)(int8_t)(w & 0xff) * s,
                     (float)(int8_t)((w >> 8) & 0xff) * s,
                     (float)(int8_t)((w >> 16) & 0xff) * s,
                     (float)(int8_t)(w >> 24) * s);
}

// values i .. i+3 of a block whose item has `left` values from the block's
// start on: one 16-byte store where all four lie in the item
__device__ __forceinline__ void store4(float* __restrict__ out, int i,
                                       long long left, float4 v) {
  if (i + 3 < left) {
    *reinterpret_cast<float4*>(out + i) = v;
    return;
  }
  if (i < left) out[i] = v.x;
  if (i + 1 < left) out[i + 1] = v.y;
  if (i + 2 < left) out[i + 2] = v.z;
}

// a dequantize tile: its first block in the item and the blocks it holds
// (of the item's ceil(n / 256) blocks that hold values)
__device__ __forceinline__ void d_tile(const Item& I, long long tile,
                                       long long& b0, int& cnt) {
  const long long used = (I.n + BLOCK - 1) / BLOCK;
  b0 = (tile - I.tile0) * TILE;
  cnt = (int)min((long long)TILE, used - b0);
}

// the scales the bulk copy brings with a tile's codes: its cnt scales
// rounded up to whole 16-byte words, where they start on 16 bytes and lie
// in the item's used blocks; 0 where not (the consumers load their own)
__device__ __forceinline__ int d_scales(const Item& I, long long b0, int cnt) {
  const int c4 = (cnt + 3) & ~3;
  const long long used = (I.n + BLOCK - 1) / BLOCK;
  return ((I.scales + 4 * b0) % 16 == 0 && b0 + c4 <= used) ? c4 : 0;
}

template <int MI>
__global__ void __launch_bounds__(D_THREADS, DEQUANT_CTAS)
    dequantize_items_kernel(const __grid_constant__ Table<MI> t) {
  constexpr int S = DEQUANT_STAGES;
  __shared__ __align__(128) uint32_t ring[S][D_STAGE_WORDS];
  __shared__ __align__(8) uint64_t full[S];
  __shared__ __align__(8) uint64_t empty[S];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], TILE);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const long long t0 = blockIdx.x, dt = gridDim.x;
  int it = find_item(t, t0);
  int s = 0;
  uint32_t phase = 0;

  if (warp == TILE) {  // the producer
    if (lane != 0) return;
    for (long long tile = t0; tile < t.tiles; tile += dt) {
      advance(t, it, tile);
      const Item& I = t.items[it];
      long long b0;
      int cnt;
      d_tile(I, tile, b0, cnt);
      const int ns = d_scales(I, b0, cnt);
      if (tile - t0 >= S * dt) mbar_wait(&empty[s], phase ^ 1u);
      mbar_expect_tx(&full[s], (uint32_t)(cnt * BLOCK + 4 * ns));
      bulk_load(ring[s], reinterpret_cast<const int8_t*>(I.src) + b0 * BLOCK,
                (uint32_t)(cnt * BLOCK), &full[s]);
      if (ns)
        bulk_load(ring[s] + TILE * BLOCK / 4,
                  reinterpret_cast<const float*>(I.scales) + b0,
                  (uint32_t)(4 * ns), &full[s]);
      if (++s == S) {
        s = 0;
        phase ^= 1u;
      }
    }
    return;
  }

  float* out = reinterpret_cast<float*>(t.out);
  for (long long tile = t0; tile < t.tiles; tile += dt) {
    advance(t, it, tile);
    const Item& I = t.items[it];
    long long b0;
    int cnt;
    d_tile(I, tile, b0, cnt);
    const long long blk = b0 + warp;
    const bool mine = warp < cnt;
    const bool own_scale = mine && !d_scales(I, b0, cnt);
    // a scale the copy does not bring is in flight while the codes arrive
    float sc = own_scale
                   ? __ldg(reinterpret_cast<const float*>(I.scales) + blk)
                   : 0.f;
    mbar_wait(&full[s], phase);
    uint32_t a = 0u, b = 0u;
    if (mine) {
      a = ring[s][warp * (BLOCK / 4) + lane];
      b = ring[s][warp * (BLOCK / 4) + 32 + lane];
      if (!own_scale) sc = __uint_as_float(ring[s][TILE * BLOCK / 4 + warp]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (mine) {
      float* o = out + I.first + blk * BLOCK;
      const long long left = I.n - blk * BLOCK;
      store4(o, 4 * lane, left, unpack4(a, sc));
      store4(o, 128 + 4 * lane, left, unpack4(b, sc));
    }
    if (++s == S) {
      s = 0;
      phase ^= 1u;
    }
  }
}

// ---------------------------------------------------------------------------
// host: the tables and the launch
// ---------------------------------------------------------------------------

// rows: (k, 4) int64 (values address, values, first row, rows)
template <int MI>
int fill_quantize(Table<MI>& t, const long long* rows, int k, void* q,
                  void* scales) {
  if (k < 1 || k > MI || !q || !scales) return (int)cudaErrorInvalidValue;
  long long first = rows[2], tiles = 0;
  for (int i = 0; i < k; ++i) {
    const long long* r = rows + 4 * i;
    const long long addr = r[0], n = r[1], f = r[2], nb = r[3];
    if (n < 0 || nb < 0 || nb % TILE || nb * BLOCK < n || f != first ||
        (n > 0 && (addr == 0 || addr % 16)))
      return (int)cudaErrorInvalidValue;
    t.items[i] = Item{addr, 0, n, f, tiles};
    tiles += nb / TILE;
    first += nb;
  }
  t.out = reinterpret_cast<long long>(q);
  t.out_scales = reinterpret_cast<long long>(scales);
  t.tiles = tiles;
  t.n_items = k;
  return 0;
}

// rows: (k, 4) int64 (codes address, scales address, values, first value)
template <int MI>
int fill_dequantize(Table<MI>& t, const long long* rows, int k, void* out) {
  if (k < 1 || k > MI || !out || reinterpret_cast<long long>(out) % 16)
    return (int)cudaErrorInvalidValue;
  long long end = 0, tiles = 0;
  for (int i = 0; i < k; ++i) {
    const long long* r = rows + 4 * i;
    const long long codes = r[0], sc = r[1], n = r[2], f = r[3];
    if (n < 0 || f < end || f % 4 ||
        (n > 0 && (codes == 0 || codes % 16 || sc == 0 || sc % 4)))
      return (int)cudaErrorInvalidValue;
    t.items[i] = Item{codes, sc, n, f, tiles};
    tiles += ((n + BLOCK - 1) / BLOCK + TILE - 1) / TILE;
    end = f + n;
  }
  t.out = reinterpret_cast<long long>(out);
  t.out_scales = 0;
  t.tiles = tiles;
  t.n_items = k;
  return 0;
}

// CTAs of the kernel that all SMs of the current device hold at once (at
// most QUANT_CTAS / DEQUANT_CTAS a SM); looked up once a device and kernel
template <int MI, bool QUANTIZE>
int resident_ctas(int& ctas) {
  static std::atomic<int> known[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 0 && dev < 64 && (ctas = known[dev].load()) > 0) return 0;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = QUANTIZE ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, quantize_items_kernel<MI>, Q_THREADS, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, dequantize_items_kernel<MI>, D_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  const int cap = QUANTIZE ? QUANT_CTAS : DEQUANT_CTAS;
  ctas = std::max(1, std::min(per_sm, cap)) * std::max(1, sms);
  if (dev >= 0 && dev < 64) known[dev].store(ctas);
  return 0;
}

template <int MI, bool QUANTIZE>
int launch(const long long* rows, int k, void* out, void* out_scales,
           cudaStream_t stream) {
  Table<MI> t;  // at most 10,272 bytes of stack
  int err = QUANTIZE ? fill_quantize(t, rows, k, out, out_scales)
                     : fill_dequantize(t, rows, k, out);
  if (err) return err;
  if (t.tiles == 0) return (int)cudaErrorInvalidValue;  // nothing to launch
  int ctas = 0;
  if ((err = resident_ctas<MI, QUANTIZE>(ctas))) return err;
  const unsigned grid = (unsigned)std::min(t.tiles, (long long)ctas);
  if (QUANTIZE)
    quantize_items_kernel<MI><<<grid, Q_THREADS, 0, stream>>>(t);
  else
    dequantize_items_kernel<MI><<<grid, D_THREADS, 0, stream>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace

// rows: (n_items, 4) int64 (address of the item's f32 values, 16-byte
// aligned; values; first output row; rows, a multiple of 8 covering the
// values), the rows contiguous from item to item; q: int8 rows of 256 and
// scales: f32, both holding every row the items name.
extern "C" int quantize_items(const long long* rows, int n_items, void* q,
                              void* scales, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_items <= SMALL_ITEMS)
    return launch<SMALL_ITEMS, true>(rows, n_items, q, scales, s);
  return launch<MAX_ITEMS, true>(rows, n_items, q, scales, s);
}

// rows: (n_items, 4) int64 (address of the item's int8 codes, rows of 256,
// 16-byte aligned; address of its f32 scales, 4-byte aligned; values; first
// output value, a multiple of 4, increasing without overlap); out: f32
// holding them all, 16-byte aligned.
extern "C" int dequantize_items(const long long* rows, int n_items,
                                void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_items <= SMALL_ITEMS)
    return launch<SMALL_ITEMS, false>(rows, n_items, out, nullptr, s);
  return launch<MAX_ITEMS, false>(rows, n_items, out, nullptr, s);
}
