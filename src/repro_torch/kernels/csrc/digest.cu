// Lattice digest for sm_90a: the per-row entry and whole-item fingerprints.
//
// Replaces the Pallas TPU kernel repro/kernels/digest.py (block_digest, body
// _digest_kernel) and the fold that repro/core/integrity.py
// (StreamDigest._fingerprint) runs around it on the host.  The row digest
//   d = sum_j x_j * (2j + 1) * 0x9E3779B1  (mod 2^32)
// over rows of 256 little-endian uint32 words is bit-exact with the plain
// version, because uint32 multiply and add wrap mod 2^32 natively and that
// sum, the XOR and the sum of the fold are exact in any order.
//
// block_digest_u32: (nb, 256) panels -> (nb,) row digests, the TPU kernel's
// exact function.  One warp per 1 KiB row, two 16-byte loads a lane, then a
// shuffle reduction; 8 rows per 256-thread CTA.
//
// digest_items: k items -> k 64-bit fingerprints in ONE launch.  An item is
// a list of segments (device memory where it lies, or a few host bytes that
// travel inline in the launch's parameters); its n bytes form
// blocks = max(1, ceil(n / 1024)) rows, bytes past n counting as zeros, and
//   hi = XOR(d) ^ mix,  lo = (sum d + mix) mod 2^32,  mix = n * GOLDEN,
// fingerprint = hi << 32 | lo.  Bound on the H100: bytes (2 integer ops per
// 4-byte word), and a single item of 412 KB is too small for any launch to
// approach it, so the design serves a whole slab of items at once:
// * The item table (rows, segments, inline bytes) is the kernel's
//   __grid_constant__ parameter (up to 32,764 bytes on Hopper with CUDA >=
//   12.1): no copy of it precedes the launch, and each launch owns its own.
//   A small instantiation serves up to 4 items, so a single-item launch does
//   not upload 28 KB of parameters.  Each CTA first copies the items and
//   segments into shared memory, every load issued before any store: one
//   round trip, where dependent reads (item, segment, address) would take
//   one each.
// * The rows of all items form one index space, cut into a contiguous range
//   of at least 16 rows per CTA, about two CTAs per SM.  A warp takes 4
//   rows per step, interleaved 8 rows apart, so a CTA reads 32 KiB
//   contiguous per step.
//   A run of steps whose rows are whole rows of one item inside one device
//   segment at a 16-byte aligned address is a plain strided stream: two
//   16-byte loads per row and lane, and the next step's loads issued before
//   this step is reduced (128-256 B in flight per lane, 64-128 KiB per SM,
//   above the ~17 KB per SM that 3.35 TB/s x ~0.7 us of latency needs).
// * Any other row (the ragged last row of an item, a row across two
//   segments, a segment at an address that is not 16-byte aligned, inline
//   bytes) is read word by word where it lies: 4-byte loads where the
//   address allows, bytes otherwise, zeros past n, never a byte past a
//   segment's end, all of a lane's loads issued before any is used.
// * A row's item comes from the row-prefix table in shared memory; row
//   digests meet in warp shuffles, a warp's run of rows of one item in
//   registers, a CTA's in shared memory.  Then each CTA folds its share of
//   each item it touched into a workspace with one 64-bit atomicXor (an
//   arrival bit beside the XOR) and one 64-bit atomicAdd (an arrival count
//   beside the sum) per item, in groups of 32 CTAs and then across groups
//   (fold_item): the CTA that sees an item's last arrival applies mix and
//   writes that half of the fingerprint, and clears the word, so the next
//   launch on the stream finds the workspace zero.  No ticket, no fence, no
//   memset and no second kernel: one round trip to L2 per level.
// Tensor cores, wgmma and TMA tiles have no part in an integer weighted sum
// mod 2^32.
#include "common.cuh"

namespace {

constexpr uint32_t GOLDEN = 0x9E3779B1u;
constexpr int ROW_WORDS = 256;
constexpr int ROW_BYTES = 4 * ROW_WORDS;
constexpr int ROWS_PER_CTA = 8;

__device__ __forceinline__ uint32_t weight(uint32_t j) {
  return (2u * j + 1u) * GOLDEN;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(32 * ROWS_PER_CTA)
    block_digest_kernel(const uint4* __restrict__ x, uint32_t* __restrict__ out,
                        int64_t nb) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * ROWS_PER_CTA + warp;
  if (row >= nb) return;
  const uint4* r = x + row * (ROW_WORDS / 4);
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = lane + 32 * i;  // vector index: words 4c .. 4c + 3
    const uint4 w = r[c];
    const uint32_t j = 4u * (uint32_t)c;
    acc += w.x * weight(j);
    acc += w.y * weight(j + 1u);
    acc += w.z * weight(j + 2u);
    acc += w.w * weight(j + 3u);
  }
  acc = warp_sum(acc);
  if (lane == 0) out[row] = acc;
}

// ---------------------------------------------------------------------------
// digest_items
// ---------------------------------------------------------------------------

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;        // rows a warp loads before it reduces them
// table capacities, mirrored in kernels/digest.py (MAX_ITEMS, ...)
constexpr int MAX_ITEMS = 256;
constexpr int MAX_SEGS = 768;
constexpr int MAX_INLINE = 4096;
constexpr int SMALL_ITEMS = 4;
constexpr int SMALL_SEGS = 16;
constexpr int SMALL_INLINE = 256;
// the fold's groups: the CTAs that touch an item meet in groups of 32, and
// the groups (at most MAX_GROUPS, so a launch takes 32 x MAX_GROUPS CTAs)
// meet in a second level
constexpr int MAX_GROUPS = 16;
// a small item's rows spread over CTAs of at least this many rows: two rows
// per warp cost one step as one row does, and the item meets in fewer CTAs
constexpr int MIN_ROWS_PER_CTA = 16;
// workspace, uint64, zero between launches: per item and group a word of
// (arrival mask << 32 | XOR) and one of (arrivals << 40 | sum), then per
// item the same two words for the groups
constexpr int WS_WORDS = 2 * MAX_ITEMS * MAX_GROUPS + 2 * MAX_ITEMS;

struct ItemRec {
  long long row0;   // first row in the launch's row space
  long long n;      // bytes
  int seg0;         // first segment
  int nseg;         // segments (0 for an empty item)
};

struct SegRec {
  unsigned long long addr;  // device address, or offset into the inline pool
  long long off;            // byte offset within the item (a multiple of 4)
  unsigned int len;         // bytes, >= 1
  unsigned int is_inline;
};

template <int MI, int MS, int MP>
struct Table {
  unsigned long long* out;  // (n_items,) fingerprints
  unsigned long long* ws;   // WS_WORDS, zero on entry and on exit
  long long total_rows;
  long long rows_per_cta;
  int n_items;
  int n_segs;
  ItemRec items[MI];
  SegRec segs[MS];
  unsigned char pool[MP];
};

// One lane's share of row r of an item, read word by word where it lies:
// words j = lane + 32 k, a 4-byte load where the address allows, bytes
// elsewhere, zeros past n, never a byte past a segment's end.  The
// addresses come first (a segment search in shared memory), then every
// load is issued, and only then are the words used, so a lane's loads are
// in flight together.
__device__ __forceinline__ uint32_t row_words(const SegRec* segs,
                                              const unsigned char* pool,
                                              const ItemRec& it, long long r,
                                              int lane) {
  constexpr int K = ROW_WORDS / 32;
  const unsigned char* p[K];
  int avail[K];   // bytes of the word that lie in its segment: 0 .. 4
  bool word[K];   // one aligned 4-byte load
  int s = it.seg0;
  const int last = it.seg0 + it.nseg - 1;
  const long long base = r * ROW_BYTES + 4LL * lane;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long b = base + 128LL * k;
    avail[k] = 0;
    word[k] = false;
    p[k] = nullptr;
    if (b >= it.n) continue;
    while (s < last && b >= segs[s + 1].off) ++s;
    const SegRec& sg = segs[s];
    const long long rel = b - sg.off;
    avail[k] = (int)min(4LL, (long long)sg.len - rel);
    p[k] = sg.is_inline ? pool + sg.addr + rel
                        : reinterpret_cast<const unsigned char*>(sg.addr) + rel;
    word[k] = !sg.is_inline && avail[k] == 4 &&
              (reinterpret_cast<uintptr_t>(p[k]) & 3) == 0;
  }
  uint32_t w[K], c[K][4];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    w[k] = 0u;
    c[k][0] = c[k][1] = c[k][2] = c[k][3] = 0u;
    if (word[k]) {
      w[k] = __ldg(reinterpret_cast<const uint32_t*>(p[k]));
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (m < avail[k]) c[k][m] = p[k][m];
    }
  }
  uint32_t acc = 0u;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t x = w[k] | c[k][0] | (c[k][1] << 8) | (c[k][2] << 16) |
                       (c[k][3] << 24);
    acc += x * weight((uint32_t)(lane + 32 * k));
  }
  return acc;
}

// One lane's share of a row read as two 16-byte vectors: words 4 lane ..
// 4 lane + 3 and 128 + 4 lane .., weighted by wt (see main loop).
__device__ __forceinline__ uint32_t row_vectors(uint4 a, uint4 b,
                                                const uint32_t* wt) {
  return a.x * wt[0] + a.y * wt[1] + a.z * wt[2] + a.w * wt[3] +
         b.x * wt[4] + b.y * wt[5] + b.z * wt[6] + b.w * wt[7];
}

__device__ __forceinline__ uint32_t all_arrived(int n) {
  return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

// One CTA's partials (XOR x and sum s of its row digests) of one item into
// the item's fingerprint, with no ticket and no fence: the CTAs touching
// the item (known from the row ranges) meet in groups of 32.  Each adds
// its bit and x to the group's XOR word and one arrival and s to its sum
// word; the CTA whose XOR completes the mask holds the group's XOR, the one
// whose arrival is the last holds its sum (possibly another CTA), each
// clears its word, and the groups meet in the item's two words the same
// way.  The holders of the item's XOR and sum write the fingerprint's two
// halves.  One round trip to L2 per level, and the workspace is zero again
// when the launch ends.
__device__ __forceinline__ void fold_item(unsigned long long* ws,
                                          uint32_t* out, int item,
                                          long long n, long long first,
                                          long long end, long long per,
                                          int cta, uint32_t x, uint32_t s) {
  const uint32_t mix = (uint32_t)n * GOLDEN;
  const int c0 = (int)(first / per);
  const int nc = (int)((end - 1) / per) - c0 + 1;
  if (nc == 1) {              // the whole item in this CTA
    out[2 * item] = s + mix;
    out[2 * item + 1] = x ^ mix;
    return;
  }
  const int r = cta - c0, q = r >> 5;
  unsigned long long* wx = ws + (long long)item * MAX_GROUPS + q;
  unsigned long long* wsum = wx + MAX_ITEMS * MAX_GROUPS;
  const unsigned long long ox =
      atomicXor(wx, (1ull << (32 + (r & 31))) | x);
  const unsigned long long os = atomicAdd(wsum, (1ull << 40) | s);
  const int nq = min(32, nc - 32 * q);
  bool hx = ((uint32_t)(ox >> 32) | (1u << (r & 31))) == all_arrived(nq);
  bool hs = (int)(os >> 40) == nq - 1;
  x ^= (uint32_t)ox;
  s += (uint32_t)os;
  if (hx) *wx = 0ull;
  if (hs) *wsum = 0ull;
  if (nc > 32) {              // the groups meet in the item's words
    const int ng = (nc + 31) >> 5;
    unsigned long long* gx = ws + 2 * MAX_ITEMS * MAX_GROUPS + item;
    unsigned long long* gs = gx + MAX_ITEMS;
    if (hx) {
      const unsigned long long o = atomicXor(gx, (1ull << (32 + q)) | x);
      hx = ((uint32_t)(o >> 32) | (1u << q)) == all_arrived(ng);
      x ^= (uint32_t)o;
      if (hx) *gx = 0ull;
    }
    if (hs) {
      const unsigned long long o = atomicAdd(gs, (1ull << 40) | s);
      hs = (int)(o >> 40) == ng - 1;
      s += (uint32_t)o;
      if (hs) *gs = 0ull;
    }
  }
  if (hs) out[2 * item] = s + mix;
  if (hx) out[2 * item + 1] = x ^ mix;
}

// the item holding row R: the last i with row0[i] <= R
__device__ __forceinline__ int find_item(const long long* row0, int n,
                                         long long R) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (row0[mid] <= R) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <int MI, int MS, int MP>
__global__ void __launch_bounds__(THREADS)
    digest_items_kernel(const __grid_constant__ Table<MI, MS, MP> t) {
  struct Staged {
    ItemRec items[MI];
    SegRec segs[MS];
  };
  __shared__ Staged tab;
  __shared__ long long row0[MI + 1];
  const ItemRec* items = tab.items;
  const SegRec* segs = tab.segs;
  __shared__ uint32_t cx[MI];
  __shared__ uint32_t cs[MI];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // the table's items and segments into shared memory, all threads at
  // once, every load issued before any is stored: one round trip to the
  // parameters, where a chain of dependent reads (item, segment, address)
  // would take one each
  {
    constexpr int IW = sizeof(ItemRec) / 8, SW = sizeof(SegRec) / 8;
    constexpr int PER = (MI * IW + MS * SW + THREADS - 1) / THREADS;
    static_assert(sizeof(Staged) == (MI * IW + MS * SW) * 8, "packed");
    const int wi = t.n_items * IW, wn = wi + t.n_segs * SW;
    const auto* src = reinterpret_cast<const unsigned long long*>(t.items);
    auto* dst = reinterpret_cast<unsigned long long*>(&tab);
    unsigned long long w[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = tid + k * THREADS;
      const int at = i < wi ? i : MI * IW + (i - wi);
      if (i < wn) w[k] = src[at];
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = tid + k * THREADS;
      const int at = i < wi ? i : MI * IW + (i - wi);
      if (i < wn) dst[at] = w[k];
      if (i < wi && i % IW == 0) row0[i / IW] = (long long)w[k];
    }
  }
  if (tid == 0) row0[t.n_items] = t.total_rows;
  for (int i = tid; i < MI; i += THREADS) cx[i] = cs[i] = 0u;
  __syncthreads();

  const long long r0 = (long long)blockIdx.x * t.rows_per_cta;
  const long long r1 = min(r0 + t.rows_per_cta, t.total_rows);
  const int ia = find_item(row0, t.n_items, r0);
  const int ib = find_item(row0, t.n_items, r1 - 1);

  // this lane's weights in the vector path
  uint32_t wt[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    wt[q] = weight(4u * lane + q);
    wt[4 + q] = weight(128u + 4u * lane + q);
  }
  // this warp's rows, increasing: r0 + 32 i + warp + 8 u
  int item = ia, seg = items[ia].seg0;
  for (long long g = r0 + warp; g < r1; g += WARPS * UNROLL) {
    while (g >= row0[item + 1]) {
      ++item;
      seg = items[item].seg0;
    }
    // a run of steps whose UNROLL rows are all whole rows of this item in
    // one device segment at a 16-byte aligned address (rows 8 KiB apart
    // keep it): a plain strided stream, each step's loads issued before
    // the step before it is reduced
    long long steps = 0;
    const uint4* src = nullptr;
    {
      const ItemRec& it = items[item];
      const long long b0 = (g - row0[item]) * ROW_BYTES;
      if (it.nseg > 0 && b0 + ROW_BYTES <= it.n) {
        while (seg < it.seg0 + it.nseg - 1 && b0 >= segs[seg + 1].off) ++seg;
        const SegRec& sg = segs[seg];
        const unsigned long long a =
            sg.addr + (unsigned long long)(b0 - sg.off);
        if (!sg.is_inline && !(a & 15ull)) {
          // rows before this one lie whole inside the segment
          const long long end = min(r1, row0[item] +
              min(sg.off + (long long)sg.len, it.n) / ROW_BYTES);
          const long long span = end - 1 - (long long)WARPS * (UNROLL - 1) - g;
          if (span >= 0) steps = span / (WARPS * UNROLL) + 1;
          src = reinterpret_cast<const uint4*>(a);
        }
      }
    }
    if (steps > 0) {
      constexpr int ROW = WARPS * ROW_BYTES / 16;            // uint4, row to row
      constexpr int STEP = WARPS * UNROLL * ROW_BYTES / 16;  // step to step
      uint4 v[UNROLL][2], nv[UNROLL][2];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        v[u][0] = __ldg(src + u * ROW + lane);
        v[u][1] = __ldg(src + u * ROW + 32 + lane);
      }
      uint32_t x = 0u, sum = 0u;
      for (long long st = 0; st < steps; ++st) {
        if (st + 1 < steps) {
          const uint4* nsrc = src + (st + 1) * STEP;
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            nv[u][0] = __ldg(nsrc + u * ROW + lane);
            nv[u][1] = __ldg(nsrc + u * ROW + 32 + lane);
          }
        }
        uint32_t d[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          d[u] = warp_sum(row_vectors(v[u][0], v[u][1], wt));
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          x ^= d[u];
          sum += d[u];
          v[u][0] = nv[u][0];
          v[u][1] = nv[u][1];
        }
      }
      if (lane == 0) {
        atomicXor(&cx[item - ia], x);
        atomicAdd(&cs[item - ia], sum);
      }
      g += (steps - 1) * (WARPS * UNROLL);   // the loop adds the last
      continue;
    }
    // any other step, row by row
    uint4 v[UNROLL][2];
    bool fast[UNROLL];
    int of[UNROLL];
    long long rr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long R = g + (long long)WARPS * u;
      fast[u] = false;
      of[u] = item;
      rr[u] = 0;
      if (R >= r1) continue;
      while (R >= row0[item + 1]) {
        ++item;
        seg = items[item].seg0;
      }
      const ItemRec& it = items[item];
      const long long r = R - row0[item];
      const long long base = r * ROW_BYTES;
      of[u] = item;
      rr[u] = r;
      if (it.nseg == 0 || base + ROW_BYTES > it.n) continue;
      while (seg < it.seg0 + it.nseg - 1 && base >= segs[seg + 1].off) ++seg;
      const SegRec& sg = segs[seg];
      if (sg.is_inline || base + ROW_BYTES > sg.off + (long long)sg.len)
        continue;
      const unsigned long long a = sg.addr + (unsigned long long)(base - sg.off);
      if (a & 15ull) continue;
      const uint4* row = reinterpret_cast<const uint4*>(a);
      v[u][0] = __ldg(row + lane);
      v[u][1] = __ldg(row + 32 + lane);
      fast[u] = true;
    }
    uint32_t d[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long R = g + (long long)WARPS * u;
      d[u] = 0u;
      if (R >= r1) continue;
      d[u] = fast[u] ? row_vectors(v[u][0], v[u][1], wt)
                     : row_words(segs, t.pool, items[of[u]], rr[u], lane);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) d[u] = warp_sum(d[u]);
    // a run of rows of one item meets in registers; each run goes to the
    // CTA's accumulators in shared memory (rows arrive in item order)
    int cur = of[0];
    uint32_t run_x = 0u, run_s = 0u;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (g + (long long)WARPS * u >= r1) continue;
      if (of[u] != cur) {
        if (lane == 0) {
          atomicXor(&cx[cur - ia], run_x);
          atomicAdd(&cs[cur - ia], run_s);
        }
        cur = of[u];
        run_x = run_s = 0u;
      }
      run_x ^= d[u];
      run_s += d[u];
    }
    if (lane == 0) {
      atomicXor(&cx[cur - ia], run_x);
      atomicAdd(&cs[cur - ia], run_s);
    }
  }
  __syncthreads();
  for (int i = tid; i <= ib - ia; i += THREADS)
    fold_item(t.ws, reinterpret_cast<uint32_t*>(t.out), ia + i,
              items[ia + i].n, row0[ia + i], row0[ia + i + 1], t.rows_per_cta,
              blockIdx.x, cx[i], cs[i]);
}

long long item_blocks(long long n) {
  return n > 0 ? (n + ROW_BYTES - 1) / ROW_BYTES : 1;
}

// Fill a table from the host arrays, checking what the kernel relies on.
template <int MI, int MS, int MP>
int fill(Table<MI, MS, MP>& t, const long long* items, int n_items,
         const long long* segs, int n_segs, const unsigned char* pool,
         int pool_bytes, void* out, void* ws) {
  if (n_items < 1 || n_items > MI || n_segs < 0 || n_segs > MS ||
      pool_bytes < 0 || pool_bytes > MP || !out || !ws)
    return (int)cudaErrorInvalidValue;
  long long rows = 0;
  for (int i = 0; i < n_items; ++i) {
    const long long* r = items + 4 * i;
    ItemRec& it = t.items[i];
    it.row0 = r[0];
    it.n = r[1];
    it.seg0 = (int)r[2];
    it.nseg = (int)r[3];
    if (it.row0 != rows || it.n < 0 || it.seg0 < 0 || it.nseg < 0 ||
        it.seg0 + it.nseg > n_segs || (it.n > 0) != (it.nseg > 0))
      return (int)cudaErrorInvalidValue;
    long long off = 0;
    for (int s = it.seg0; s < it.seg0 + it.nseg; ++s) {
      const long long* q = segs + 4 * s;
      // every segment starts on a word of the item, and only the last one
      // may end inside a word
      if (q[1] != off || (off & 3) || q[2] < 1 || q[2] > 0xffffffffLL ||
          (s + 1 < it.seg0 + it.nseg && (q[2] & 3)))
        return (int)cudaErrorInvalidValue;
      if (q[3] && (q[0] < 0 || q[0] + q[2] > pool_bytes))
        return (int)cudaErrorInvalidValue;
      t.segs[s].addr = (unsigned long long)q[0];
      t.segs[s].off = q[1];
      t.segs[s].len = (unsigned int)q[2];
      t.segs[s].is_inline = q[3] ? 1u : 0u;
      off += q[2];
    }
    if (off != it.n) return (int)cudaErrorInvalidValue;
    rows += item_blocks(it.n);
  }
  for (int i = 0; i < pool_bytes; ++i) t.pool[i] = pool[i];
  t.out = static_cast<unsigned long long*>(out);
  t.ws = static_cast<unsigned long long*>(ws);
  t.total_rows = rows;
  t.n_items = n_items;
  t.n_segs = n_segs;
  return 0;
}

template <int MI, int MS, int MP>
int launch(const long long* items, int n_items, const long long* segs,
           int n_segs, const unsigned char* pool, int pool_bytes, void* out,
           void* ws, cudaStream_t stream) {
  Table<MI, MS, MP> t;  // at most 28,712 bytes of stack
  const int err = fill(t, items, n_items, segs, n_segs, pool, pool_bytes, out,
                       ws);
  if (err) return err;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // about two CTAs per SM, each a whole number of 8-row steps (one row per
  // warp), so a small item still spreads over as many SMs as it has rows / 8
  const long long target = 2LL * sms;
  long long per = (t.total_rows + target - 1) / target;
  per = (per + WARPS - 1) / WARPS * WARPS;
  if (per < MIN_ROWS_PER_CTA) per = MIN_ROWS_PER_CTA;
  t.rows_per_cta = per;
  const long long grid = (t.total_rows + per - 1) / per;
  if (grid > 32LL * MAX_GROUPS) return (int)cudaErrorInvalidValue;
  digest_items_kernel<MI, MS, MP><<<(unsigned)grid, THREADS, 0, stream>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace

// panels: (nb, 256) uint32, contiguous and 16-byte aligned; out: (nb,) uint32
extern "C" int block_digest_u32(const void* panels, void* out, long long nb,
                                void* stream) {
  if (nb <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (nb + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  block_digest_kernel<<<(unsigned)blocks, 32 * ROWS_PER_CTA, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(panels), static_cast<uint32_t*>(out),
      (int64_t)nb);
  return (int)cudaGetLastError();
}

// items: (n_items, 4) int64 rows (row0, n, seg0, nseg); segs: (n_segs, 4)
// int64 rows (address or pool offset, offset in the item, bytes, inline);
// pool: the inline bytes; out: (n_items,) uint64 on the card; ws: the
// stream's workspace of digest_items_ws_words() uint64, zero.
extern "C" int digest_items(const long long* items, int n_items,
                            const long long* segs, int n_segs,
                            const unsigned char* pool, int pool_bytes,
                            void* out, void* ws, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_items <= SMALL_ITEMS && n_segs <= SMALL_SEGS &&
      pool_bytes <= SMALL_INLINE)
    return launch<SMALL_ITEMS, SMALL_SEGS, SMALL_INLINE>(
        items, n_items, segs, n_segs, pool, pool_bytes, out, ws, s);
  return launch<MAX_ITEMS, MAX_SEGS, MAX_INLINE>(
      items, n_items, segs, n_segs, pool, pool_bytes, out, ws, s);
}

extern "C" int digest_items_ws_words() { return WS_WORDS; }
