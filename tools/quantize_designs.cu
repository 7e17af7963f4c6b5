// The int8 pair's designs that csrc/quantize.cu does not ship, for
// tools/quantize_designs.py to time against it: the same C interface, the
// same results bit for bit (see that file for the arithmetic, the formats
// and the walk over a slab's tiles).  Build with -DQDESIGN=
// 1. The other design of each direction, persistent as the shipped ones:
//    quantize through a ring of QUANT_STAGES shared-memory stages filled by
//    1-D bulk copies (TMA without a tensor map) of each tile's whole 16-byte
//    words, a producer warp and 8 consumer warps a CTA, QUANT_CTAS CTAs a
//    SM; an item's last 1-3 values are read with plain loads.  Dequantize
//    as a register-pipelined stream: each warp keeps the codes and scale of
//    its next DEQUANT_DEPTH blocks in flight in registers.
// 2. One warp a block, one tile a CTA, every tile's CTA in one launch (the
//    shape of the pair's first port, plus the item table).
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

#ifndef QDESIGN
#define QDESIGN 1
#endif
#ifndef QUANT_STAGES
#define QUANT_STAGES 5  // 8 KiB of f32 a stage
#endif
#ifndef QUANT_CTAS
#define QUANT_CTAS 4
#endif
#ifndef DEQUANT_DEPTH
#define DEQUANT_DEPTH 2
#endif
#ifndef DEQUANT_CTAS
#define DEQUANT_CTAS 8
#endif

namespace {

constexpr int BLOCK = 256;
constexpr int TILE = 8;
constexpr int WARPS_THREADS = 32 * TILE;
constexpr int RING_THREADS = 32 * (TILE + 1);  // + the producer warp
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

#if QDESIGN == 1
// values v .. v+3 of a tile: from the stage where the bulk copy brought
// them (v < bulk), else read where they lie, zeros from `left` on
__device__ __forceinline__ float4 tile_values(const float4* stage,
                                              const float* x, long long v,
                                              long long bulk,
                                              long long left) {
  if (v < bulk) return stage[v >> 2];
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (v < left) r.x = x[v];
  if (v + 1 < left) r.y = x[v + 1];
  if (v + 2 < left) r.z = x[v + 2];
  return r;  // v + 3 < left would have been in the bulk copy
}

template <int MI>
__global__ void __launch_bounds__(RING_THREADS, QUANT_CTAS)
    quantize_items_kernel(const __grid_constant__ Table<MI> t) {
  constexpr int S = QUANT_STAGES;
  __shared__ __align__(128) float4 ring[S][TILE * BLOCK / 4];
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
      const long long v0 = (tile - I.tile0) * (TILE * BLOCK);
      const long long left = I.n - v0;
      const long long bulk =
          left <= 0 ? 0 : min(left, (long long)(TILE * BLOCK)) & ~3LL;
      if (tile - t0 >= S * dt) mbar_wait(&empty[s], phase ^ 1u);
      if (bulk) {
        mbar_expect_tx(&full[s], 4u * (uint32_t)bulk);
        bulk_load(ring[s], reinterpret_cast<const float*>(I.src) + v0,
                  4u * (uint32_t)bulk, &full[s]);
      } else {
        mbar_arrive(&full[s]);  // a tile of padding blocks: nothing to read
      }
      if (++s == S) {
        s = 0;
        phase ^= 1u;
      }
    }
    return;
  }
  int8_t* q = reinterpret_cast<int8_t*>(t.out);
  float* scales = reinterpret_cast<float*>(t.out_scales);
  for (long long tile = t0; tile < t.tiles; tile += dt) {
    advance(t, it, tile);
    const Item& I = t.items[it];
    const long long v0 = (tile - I.tile0) * (TILE * BLOCK);
    const long long left = I.n - v0;
    const long long bulk =
        left <= 0 ? 0 : min(left, (long long)(TILE * BLOCK)) & ~3LL;
    const float* x = reinterpret_cast<const float*>(I.src) + v0;
    const long long vb = (long long)warp * BLOCK;  // the block in the tile
    mbar_wait(&full[s], phase);
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (vb < left) {  // a padding block reads nothing
      lo = tile_values(ring[s], x, vb + 4 * lane, bulk, left);
      hi = tile_values(ring[s], x, vb + 128 + 4 * lane, bulk, left);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    float m = fmaxf(amax4(lo), amax4(hi));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float scale = m / 127.0f;
    const float safe = scale > 0.f ? scale : 1.f;
    const long long row = I.first + (tile - I.tile0) * TILE + warp;
    uint32_t* words = reinterpret_cast<uint32_t*>(q + row * BLOCK);
    words[lane] = pack4(lo, safe);
    words[32 + lane] = pack4(hi, safe);
    if (lane == 0) scales[row] = scale;
    if (++s == S) {
      s = 0;
      phase ^= 1u;
    }
  }
}

// start the loads of this warp's block of tile `tile`: its two code words
// a lane and its scale (nothing for a tile past the slab or a block past
// the item's values)
template <int MI>
__device__ __forceinline__ void d_load(const Table<MI>& t, int& it,
                                       long long tile, int warp, int lane,
                                       uint32_t& a, uint32_t& b, float& s) {
  a = b = 0u;
  s = 0.f;
  if (tile >= t.tiles) return;
  advance(t, it, tile);
  const Item& I = t.items[it];
  const long long blk = (tile - I.tile0) * TILE + warp;
  if (blk * BLOCK >= I.n) return;
  s = __ldg(reinterpret_cast<const float*>(I.scales) + blk);
  const uint32_t* codes =
      reinterpret_cast<const uint32_t*>(I.src) + blk * (BLOCK / 4);
  a = __ldg(codes + lane);
  b = __ldg(codes + 32 + lane);
}

template <int MI>
__global__ void __launch_bounds__(WARPS_THREADS)
    dequantize_items_kernel(const __grid_constant__ Table<MI> t) {
  constexpr int D = DEQUANT_DEPTH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long t0 = blockIdx.x, dt = gridDim.x;
  int li = find_item(t, t0), pi = li;  // cursors: loads, writes
  float* out = reinterpret_cast<float*>(t.out);
  uint32_t wa[D], wb[D];
  float ws[D];
#pragma unroll
  for (int j = 0; j < D; ++j)
    d_load(t, li, t0 + j * dt, warp, lane, wa[j], wb[j], ws[j]);
  for (long long base = t0; base < t.tiles; base += D * dt) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const long long tile = base + j * dt;
      if (tile >= t.tiles) break;
      const uint32_t a = wa[j], b = wb[j];
      const float s = ws[j];
      d_load(t, li, tile + D * dt, warp, lane, wa[j], wb[j], ws[j]);
      advance(t, pi, tile);
      const Item& I = t.items[pi];
      const long long blk = (tile - I.tile0) * TILE + warp;
      const long long left = I.n - blk * BLOCK;
      if (left <= 0) continue;
      float* o = out + I.first + blk * BLOCK;
      store4(o, 4 * lane, left, unpack4(a, s));
      store4(o, 128 + 4 * lane, left, unpack4(b, s));
    }
  }
}
constexpr int Q_THREADS = RING_THREADS, D_THREADS = WARPS_THREADS;
#else  // QDESIGN == 2
template <int MI>
__global__ void __launch_bounds__(WARPS_THREADS)
    quantize_items_kernel(const __grid_constant__ Table<MI> t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tile = blockIdx.x;
  const Item& I = t.items[find_item(t, tile)];
  const long long blk = (tile - I.tile0) * TILE + warp;
  const long long v = blk * BLOCK;
  float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
  if (v < I.n) {
    const float* x = reinterpret_cast<const float*>(I.src);
    lo = load4(x, v + 4 * lane, I.n);
    hi = load4(x, v + 128 + 4 * lane, I.n);
  }
  float m = fmaxf(amax4(lo), amax4(hi));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float scale = m / 127.0f;
  const float safe = scale > 0.f ? scale : 1.f;
  const long long row = I.first + blk;
  uint32_t* words = reinterpret_cast<uint32_t*>(t.out) + row * (BLOCK / 4);
  words[lane] = pack4(lo, safe);
  words[32 + lane] = pack4(hi, safe);
  if (lane == 0) reinterpret_cast<float*>(t.out_scales)[row] = scale;
}

template <int MI>
__global__ void __launch_bounds__(WARPS_THREADS)
    dequantize_items_kernel(const __grid_constant__ Table<MI> t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tile = blockIdx.x;
  const Item& I = t.items[find_item(t, tile)];
  const long long blk = (tile - I.tile0) * TILE + warp;
  const long long left = I.n - blk * BLOCK;
  if (left <= 0) return;
  const float s = __ldg(reinterpret_cast<const float*>(I.scales) + blk);
  const uint32_t* codes =
      reinterpret_cast<const uint32_t*>(I.src) + blk * (BLOCK / 4);
  const uint32_t a = __ldg(codes + lane), b = __ldg(codes + 32 + lane);
  float* o = reinterpret_cast<float*>(t.out) + I.first + blk * BLOCK;
  store4(o, 4 * lane, left, unpack4(a, s));
  store4(o, 128 + 4 * lane, left, unpack4(b, s));
}
constexpr int Q_THREADS = WARPS_THREADS, D_THREADS = WARPS_THREADS;
#endif

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

// the grid: design 1 as many CTAs as the SMs hold at once (capped), design
// 2 a CTA a tile
template <int MI, bool QUANTIZE>
int grid_of(long long tiles, long long& grid) {
#if QDESIGN == 2
  grid = tiles;
  return 0;
#else
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = QUANTIZE ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, quantize_items_kernel<MI>, Q_THREADS, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, dequantize_items_kernel<MI>, D_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  const int cap = QUANTIZE ? QUANT_CTAS : DEQUANT_CTAS;
  grid = std::min(tiles, (long long)std::max(1, std::min(per_sm, cap)) *
                             std::max(1, sms));
  return 0;
#endif
}

template <int MI, bool QUANTIZE>
int launch(const long long* rows, int k, void* out, void* out_scales,
           cudaStream_t stream) {
  Table<MI> t;
  int err = QUANTIZE ? fill_quantize(t, rows, k, out, out_scales)
                     : fill_dequantize(t, rows, k, out);
  if (err) return err;
  if (t.tiles == 0) return (int)cudaErrorInvalidValue;
  long long grid = 0;
  if ((err = grid_of<MI, QUANTIZE>(t.tiles, grid))) return err;
  if (QUANTIZE)
    quantize_items_kernel<MI><<<(unsigned)grid, Q_THREADS, 0, stream>>>(t);
  else
    dequantize_items_kernel<MI><<<(unsigned)grid, D_THREADS, 0, stream>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace

// the C interface of csrc/quantize.cu
extern "C" int quantize_items(const long long* rows, int n_items, void* q,
                              void* scales, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_items <= SMALL_ITEMS)
    return launch<SMALL_ITEMS, true>(rows, n_items, q, scales, s);
  return launch<MAX_ITEMS, true>(rows, n_items, q, scales, s);
}

extern "C" int dequantize_items(const long long* rows, int n_items,
                                void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_items <= SMALL_ITEMS)
    return launch<SMALL_ITEMS, false>(rows, n_items, out, nullptr, s);
  return launch<MAX_ITEMS, false>(rows, n_items, out, nullptr, s);
}
