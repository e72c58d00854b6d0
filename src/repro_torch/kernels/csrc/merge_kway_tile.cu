// merge_kway_tile.cu — one output tile of the stable k-way merge of k
// sorted runs, optionally carrying a payload, as a merge tree in shared
// memory.
//
// Replaces the TPU kernel merge_kway_tile_kernel and its helper
// _lane_count_search (src/repro/kernels/merge.py:208-326), launched by
// merge_kway_pallas (merge.py:332, pl.pallas_call at :430).
//
// What bounds it on an H100: bytes.  A merge of k runs of width w reads
// k*w*(sizeof(key)+sizeof(val)) bytes and writes as many, and needs only
// about log2(k) comparisons per element.
//
// What the design does about that bound: one pass over device memory.
// Phase 1 (the multi-way co-rank of every tile boundary r*S, computed by the
// caller in torch ops, clamped at the real run lengths) gives each block its
// segment [cb[r,q], cb[r+1,q]) of every run q; the segments sum to S (less
// on the ragged last tile).  A block stages exactly those elements and
// stores exactly its tile, so every input byte is read once and every output
// byte written once.  Inside the tile the work is log2(k') merge-path levels,
// not k-1 searches per element:
//   * Compaction: one block-wide scan over the k cuts drops the empty
//     segments and keeps run order, so the segment table holds
//     k' <= min(k, S) entries and a large k costs one pass over the cuts.
//   * Staging: all threads stage the S slots at once, not run by run: slot
//     i finds its segment by a binary search of the table and is copied by a
//     4- or 8-byte cp.async, so a thread's kItems loads are in flight
//     together; each segment is a contiguous, coalesced read.
//   * Merging: ceil(log2(k')) levels merge adjacent segments (2i, 2i+1)
//     between two shared-memory buffers.  At each level a thread owns kItems
//     consecutive output slots: it finds the pair that holds its first slot,
//     co-ranks that slot inside the pair with the Lemma-1 binary search, and
//     emits its slots with the two-finger rule, moving to the next pair (whose
//     co-rank is (0, 0)) where one ends.  An odd segment at a level passes
//     through unchanged.
//   * Stability: the left segment wins ties, and pairs stay in run order, so
//     an earlier run's equal keys come first — the run-index tie-break of
//     repro_torch.core.engine.counts_ties / count_side.
//   * The payload moves with its key at every level.
//   * kItems is odd, so a warp's strided writes (thread t at t*kItems + i)
//     fall on distinct banks; the last level's buffer leaves with 16-byte
//     coalesced stores.
//
// The ragged "lengths" form needs nothing here: phase 1 clamps the cuts at
// the lengths, so padding is never staged and real dtype-max keys never
// meet sentinels.  Output positions past the real total are not written.
//
// Two grouped launches below merge g independent groups of k runs of width
// w, laid out (g, k, w), into (g, k*w), with no phase 1: the top-k's block
// sort and tournament rounds and every pass of merge sort's plan.
// merge_kway_groups_kernel takes groups of at most 4096 elements (a tile of
// its own) and sorts them in registers; merge_kway_groups_wide_kernel takes
// wider groups, co-ranks each output tile inside its group in the block, and
// merges it with the merge tree above.  The wide launch also has the ragged
// form (run lengths, an out_len), so with g = 1 it is the one-launch k-way
// merge of up to 64 runs that the entry points (stable_merge_kway,
// merge_window) take; merge_kway_tile_kernel with phase-1 cuts stays the
// route for more runs.  Each section says what bounds it and what its
// design does about that.
//
// The run count k is a launch argument (any k >= 1; at most 64 for the wide
// grouped launch).  Keys are int32,
// int64, float32, float64, float16 or bfloat16 (the 16-bit floats compared
// after an exact widening to float); the payload is copied as raw 4- or
// 8-byte words, so any dtype of that width rides along.  Global offsets are
// 64-bit.

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

using repro_tile::kItems;                // slots per thread and level (odd)
using repro_tile::kThreads;
using repro_tile::kTile;
using repro_tile::ord;
using repro_tile::store_tile;
constexpr int kWarps = kThreads / 32;

// Dynamic shared memory: two key buffers, two payload buffers (with a
// payload), then the table of the `table` compacted segments: where each
// starts in the runs (int64) and in the tile (table + 1 ints).
template <typename Key, typename Val, bool HAS_VALS>
__host__ __device__ constexpr size_t buffer_bytes() {
  return 2 * kTile * (sizeof(Key) + (HAS_VALS ? sizeof(Val) : 0));
}

template <typename Key, typename Val, bool HAS_VALS>
size_t smem_bytes(int table) {
  return buffer_bytes<Key, Val, HAS_VALS>() +
         static_cast<size_t>(table) * sizeof(int64_t) +
         (static_cast<size_t>(table) + 1) * sizeof(int);
}

// Block-wide exclusive prefix sum of x; *total gets the sum over the block.
// Every thread must call it.
__device__ __forceinline__ int64_t block_exclusive_sum(int64_t x,
                                                       int64_t* s_warp,
                                                       int64_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int64_t inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int64_t base = 0;
  int64_t sum = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const int64_t v = s_warp[i];
    base += i < warp ? v : 0;
    sum += v;
  }
  __syncthreads();  // s_warp may be written again
  *total = sum;
  return base + inc - x;
}

// *dst = *src without passing through registers: a 4- or 8-byte cp.async,
// which lets a thread have all its staging loads in flight at once (16-bit
// keys are copied through a register).
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4 || sizeof(T) == 8) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(sizeof(T))
                 : "memory");
  } else {
    *dst = *src;
  }
}

// The last index c in [0, n) with table[c * stride] <= x (table[0] <= x),
// by steps of top, top/2, ..., 1, where top is the largest power of two
// below n.
__device__ __forceinline__ int last_at_most(const int* table, int n,
                                            int stride, int x) {
  int c = 0;
  for (int s = n > 1 ? 1 << (31 - __clz(n - 1)) : 0; s > 0; s >>= 1) {
    if (c + s < n && table[(c + s) * stride] <= x) c += s;
  }
  return c;
}

// The pairs of one merge level over the compacted segment table of a tile:
// pair p merges table segments [p*span, p*span+step) and [p*span+step,
// p*span+span), clamped at kp.
struct TablePairs {
  const int* seg_start;  // kp + 1 slot offsets
  int kp;
  int step;

  // The pair that holds slot s: its index p and slots [lo, md), [md, he).
  __device__ __forceinline__ void find(int s, int& p, int& lo, int& md,
                                       int& he) const {
    const int span = 2 * step;
    p = last_at_most(seg_start, (kp - 1) / span + 1, span, s);
    lo = seg_start[p * span];
    md = seg_start[min(p * span + step, kp)];
    he = seg_start[min(p * span + span, kp)];
  }
  // The pair after p, which starts at the old he.
  __device__ __forceinline__ void next(int& p, int& md, int& he) const {
    const int span = 2 * step;
    ++p;
    md = seg_start[min(p * span + step, kp)];
    he = seg_start[min(p * span + span, kp)];
  }
};

// One level of the merge tree: every pair of `pairs` merges its two sorted
// slot ranges of ik/iv into the same slots of ok/ov; a pair whose right range
// is empty passes through.  A thread owns kItems consecutive slots: it finds
// the pair that holds its first slot, co-ranks that slot inside the pair with
// the Lemma-1 binary search, and emits its slots with the two-finger rule,
// moving to the next pair (whose co-rank is (0, 0)) where one ends.  The left
// range wins ties: stability.  The caller synchronises after it.
template <typename Key, typename Val, bool HAS_VALS, typename Pairs>
__device__ __forceinline__ void merge_level(const Key* ik, Key* ok,
                                            const Val* iv, Val* ov, int len,
                                            const Pairs& pairs) {
  const int t0 = threadIdx.x * kItems;
  if (t0 >= len) return;
  int p, lo, md, he;
  pairs.find(t0, p, lo, md, he);
  // Co-rank of pair rank d: the largest jj in [max(0, d-lb), min(d, la)]
  // with A[jj-1] <= B[d-jj] (an exhausted B satisfies it).
  const int d = t0 - lo;
  const int la = md - lo;
  const int lb = he - md;
  int jlo = max(0, d - lb);
  int jhi = min(d, la);
  while (jlo < jhi) {
    const int mid = (jlo + jhi + 1) >> 1;
    const int kk = d - mid;
    if (kk >= lb || ord(ik[lo + mid - 1]) <= ord(ik[md + kk])) {
      jlo = mid;
    } else {
      jhi = mid - 1;
    }
  }
  int ia = lo + jlo;        // next of the left range
  int ib = md + (d - jlo);  // next of the right range
  Key xa = ia < md ? ik[ia] : Key();
  Key xb = ib < he ? ik[ib] : Key();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int s = t0 + i;
    if (s < len) {
      if (s == he) {  // the next pair starts here, at co-rank (0, 0)
        ia = he;
        pairs.next(p, md, he);
        ib = md;
        xa = ik[ia];
        xb = ib < he ? ik[ib] : Key();
      }
      // Left wins ties: stability.
      const bool take_a = ia < md && (ib >= he || ord(xa) <= ord(xb));
      ok[s] = take_a ? xa : xb;
      if constexpr (HAS_VALS) ov[s] = iv[take_a ? ia : ib];
      ia += take_a;
      ib += !take_a;
      // The taken side's next head.  Past its range's end this reads a
      // neighbouring slot (or, at the tile's end, the next region of shared
      // memory), which is never compared.
      const Key next = ik[take_a ? ia : ib];
      xa = take_a ? next : xa;
      xb = take_a ? xb : next;
    }
  }
}

// Val is the payload word (uint32_t or uint64_t); HAS_VALS false ignores it.
template <typename Key, typename Val, bool HAS_VALS>
__global__ void __launch_bounds__(kThreads)
    merge_kway_tile_kernel(const Key* __restrict__ runs,
                           const Val* __restrict__ vals, int k, int64_t w,
                           const int32_t* __restrict__ cb,
                           Key* __restrict__ out_k, Val* __restrict__ out_v,
                           int64_t out_len, int table) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t s_warp[kWarps];
  Key* const kbuf0 = reinterpret_cast<Key*>(smem);
  Key* const kbuf1 = kbuf0 + kTile;
  Val* const vbuf0 = reinterpret_cast<Val*>(smem + 2 * kTile * sizeof(Key));
  Val* const vbuf1 = vbuf0 + kTile;
  int64_t* seg_src = reinterpret_cast<int64_t*>(
      smem + buffer_bytes<Key, Val, HAS_VALS>());
  int* seg_start = reinterpret_cast<int*>(seg_src + table);

  // Compaction: the non-empty segments, in run order.  One block-wide scan
  // per kThreads runs counts them (high word) and sums their lengths (low
  // word) at once.
  const int64_t r = blockIdx.x;
  const int32_t* lo_row = cb + r * k;
  const int32_t* hi_row = lo_row + k;
  int kp = 0;   // non-empty segments so far
  int len = 0;  // their total length
  for (int q0 = 0; q0 < k; q0 += kThreads) {
    const int q = q0 + threadIdx.x;
    int lo = 0;
    int n = 0;
    if (q < k) {
      lo = lo_row[q];
      const int hi = hi_row[q];
      // Cuts that are not co-ranks of the tile bounds would read or stage
      // out of bounds: fail the launch loudly instead.
      if (lo < 0 || hi < lo || hi > w || hi - lo > kTile) __trap();
      n = hi - lo;
    }
    int64_t total;
    const int64_t pre = block_exclusive_sum(
        (static_cast<int64_t>(n > 0) << 32) | n, s_warp, &total);
    if (n > 0) {
      const int c = kp + static_cast<int>(pre >> 32);
      if (c >= table) __trap();
      seg_src[c] = q * w + lo;
      seg_start[c] = len + static_cast<int>(pre & 0xffffffff);
    }
    kp += static_cast<int>(total >> 32);
    len += static_cast<int>(total & 0xffffffff);
    if (len > kTile) __trap();
  }
  if (r * kTile + len > out_len) __trap();
  if (threadIdx.x == 0) seg_start[kp] = len;
  __syncthreads();

  // Staging: slot i of the tile is element i - seg_start[c] of compacted
  // segment c.  Every thread starts the copies of all its slots, then waits
  // for them.
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (i < len) {
      const int c = last_at_most(seg_start, kp, 1, i);
      const int64_t from = seg_src[c] + (i - seg_start[c]);
      copy_async(kbuf0 + i, runs + from);
      if constexpr (HAS_VALS) copy_async(vbuf0 + i, vals + from);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Merging: at the level with segments of `step` compacted segments, pair p
  // merges segments 2p and 2p+1, i.e. slots [seg_start[p*span],
  // seg_start[p*span+step]) and [that, seg_start[p*span+span]) (indices
  // clamped at kp), into the same slots of the other buffer.
  bool flipped = false;  // the tile is in kbuf1/vbuf1
  for (int step = 1; step < kp; step <<= 1) {
    merge_level<Key, Val, HAS_VALS>(flipped ? kbuf1 : kbuf0,
                                    flipped ? kbuf0 : kbuf1,
                                    flipped ? vbuf1 : vbuf0,
                                    flipped ? vbuf0 : vbuf1, len,
                                    TablePairs{seg_start, kp, step});
    __syncthreads();
    flipped = !flipped;
  }

  store_tile(out_k + r * kTile, flipped ? kbuf1 : kbuf0, len);
  if constexpr (HAS_VALS) {
    store_tile(out_v + r * kTile, flipped ? vbuf1 : vbuf0, len);
  }
}

// ===========================================================================
// The grouped launch (merge_kway_groups_kernel): g independent groups of k
// sorted runs of width w, laid out (g, k, w), merged into (g, k*w), where a
// group's G = k*w elements fit one tile of 4096 (grouped::kTile).
//
// The stable merge of a group's runs is the stable sort of its G elements by
// key (lower run first on ties, runs laid out in run order), so the kernel
// sorts each group by (key, slot), slot being an element's index in its
// group: the order is total, and any sorting network gives the stable
// result.  A group is padded to P, the next power of two of G, with keys
// above every real one (slots >= G), so a tile holds 4096 / P whole groups
// and every segment is a power of two.  The bound on an H100 is bytes (each
// key and payload read once and written once); what holds the kernel above
// it is the network's compares and shuffles, O(log^2) a key, and the merge
// levels' dependent shared-memory reads (PERF.md has the measured times).
// The design:
//   * Persistent, double-buffered blocks: a block walks tiles t, t + grid,
//     ...; while tile t sorts, tile t + grid arrives by 16-byte cp.async.cg
//     (one contiguous span of whole groups) into the other stage buffer.
//   * Registers first: a thread holds 16 consecutive slots as 64-bit sort
//     words (the key's order-preserving image, then the slot: one integer
//     compare).  For runs narrower than 16 (the sort plan's leaf and the
//     top-k's block sort, w = 1) it sorts them with a bitonic network in
//     registers (sizes 2-16), then the warp's 512 slots with the same
//     network across lanes by shuffles (sizes 32-512): a segment of up to
//     512 never touches shared memory or a block barrier.  (Merge-path
//     levels in shared memory in place of the shuffles measured slower:
//     0.0461 against 0.0379 ms at the top-k's (18992, 128, 1).)
//   * Only levels above that go through shared memory, as merge-path
//     merges of two sorted runs (sizes 1024-4096 of the leaf, or the runs
//     of w >= 16 as given, the top-k's rounds), in a buffer padded by one
//     entry every 16 so that a thread's 16 consecutive entries start on
//     distinct banks; pairs inside one warp need only the warp's barrier.
//   * A power-of-two group is read from the stage once as 16-byte vectors,
//     each thread starting at a rotated chunk so that a quarter warp hits
//     distinct banks, and its keys leave as 16-byte stores, rebuilt from
//     their sort words; the payload is gathered once from the stage by
//     slot.  Other groups are laid out by segment through the padded
//     buffer, striped, both ways, so the device accesses stay coalesced.
//   * Occupancy: the stage holds exactly two tiles of keys (and payload),
//     the merge buffer is allocated only when a level or a layout needs it,
//     and the grid is the occupancy the card reports for that size (queried
//     once per instance, with the shared-memory opt-in).
// ===========================================================================

namespace grouped {

constexpr int kThreads = 256;
constexpr int kItems = 16;                      // slots a thread holds
constexpr int kTile = kThreads * kItems;        // 4096
constexpr int kWarpSpan = 32 * kItems;          // 512
constexpr int kWarps = kThreads / 32;
constexpr int kMergeEntries = kTile + kTile / kItems;  // padded merge buffer

__device__ __forceinline__ uint32_t flip32(uint32_t c) {
  return (c & 0x80000000u) ? ~c : (c | 0x80000000u);
}
__device__ __forceinline__ uint32_t unflip32(uint32_t t) {
  return (t & 0x80000000u) ? (t & 0x7fffffffu) : ~t;
}
__device__ __forceinline__ uint64_t flip64(uint64_t c) {
  return (c >> 63) ? ~c : (c | (1ull << 63));
}
__device__ __forceinline__ uint64_t unflip64(uint64_t t) {
  return (t >> 63) ? (t & ~(1ull << 63)) : ~t;
}

// Sort word of a 4- or 2-byte key: bits 63-32 the key's order-preserving
// image (-0.0 folded into 0.0, 16-bit floats widened exactly), bits 31-16
// the slot, bits 15-0 what the image loses (a 16-bit key's own bits, or
// float -0.0's sign).  Slots are unique, so the low bits never decide.
struct Narrow {
  uint64_t w;
};
// 8-byte keys: the 64-bit image, and the slot above -0.0's sign bit.
struct Wide {
  uint64_t w;
  uint32_t s;
};

__device__ __forceinline__ bool less(Narrow a, Narrow b) { return a.w < b.w; }
__device__ __forceinline__ bool less(Wide a, Wide b) {
  return a.w < b.w || (a.w == b.w && a.s < b.s);
}
__device__ __forceinline__ Narrow shfl_xor(Narrow a, int m) {
  return {__shfl_xor_sync(0xffffffffu, a.w, m)};
}
__device__ __forceinline__ Wide shfl_xor(Wide a, int m) {
  return {__shfl_xor_sync(0xffffffffu, a.w, m),
          __shfl_xor_sync(0xffffffffu, a.s, m)};
}

__device__ __forceinline__ uint64_t narrow_word(uint32_t image, int slot,
                                                uint32_t low) {
  return static_cast<uint64_t>(image) << 32 |
         static_cast<uint64_t>(slot) << 16 | low;
}
__device__ __forceinline__ uint32_t float_image(float f, uint32_t* neg0) {
  const uint32_t b = __float_as_uint(f);
  *neg0 = b == 0x80000000u;
  return flip32(*neg0 ? 0u : b);
}

template <typename Key>
struct Order;

template <>
struct Order<int32_t> {
  using Item = Narrow;
  __device__ static Item make(int32_t k, int slot) {
    return {narrow_word(static_cast<uint32_t>(k) ^ 0x80000000u, slot, 0)};
  }
  __device__ static int32_t key(Item it) {
    return static_cast<int32_t>(static_cast<uint32_t>(it.w >> 32) ^
                                0x80000000u);
  }
};
template <>
struct Order<float> {
  using Item = Narrow;
  __device__ static Item make(float k, int slot) {
    uint32_t neg0;
    const uint32_t im = float_image(k, &neg0);
    return {narrow_word(im, slot, neg0)};
  }
  __device__ static float key(Item it) {
    return (it.w & 1) ? __uint_as_float(0x80000000u)
                      : __uint_as_float(unflip32(static_cast<uint32_t>(it.w >> 32)));
  }
};
template <>
struct Order<__half> {
  using Item = Narrow;
  __device__ static Item make(__half k, int slot) {
    uint32_t neg0;
    const uint32_t im = float_image(__half2float(k), &neg0);
    return {narrow_word(im, slot, __half_as_ushort(k))};
  }
  __device__ static __half key(Item it) {
    return __ushort_as_half(static_cast<unsigned short>(it.w & 0xffff));
  }
};
template <>
struct Order<__nv_bfloat16> {
  using Item = Narrow;
  __device__ static Item make(__nv_bfloat16 k, int slot) {
    uint32_t neg0;
    const uint32_t im = float_image(__bfloat162float(k), &neg0);
    return {narrow_word(im, slot, __bfloat16_as_ushort(k))};
  }
  __device__ static __nv_bfloat16 key(Item it) {
    return __ushort_as_bfloat16(static_cast<unsigned short>(it.w & 0xffff));
  }
};
template <>
struct Order<int64_t> {
  using Item = Wide;
  __device__ static Item make(int64_t k, int slot) {
    return {static_cast<uint64_t>(k) ^ (1ull << 63),
            static_cast<uint32_t>(slot) << 1};
  }
  __device__ static int64_t key(Item it) {
    return static_cast<int64_t>(it.w ^ (1ull << 63));
  }
};
template <>
struct Order<double> {
  using Item = Wide;
  __device__ static Item make(double k, int slot) {
    const uint64_t b = static_cast<uint64_t>(__double_as_longlong(k));
    const uint32_t neg0 = b == (1ull << 63);
    return {flip64(neg0 ? 0ull : b), static_cast<uint32_t>(slot) << 1 | neg0};
  }
  __device__ static double key(Item it) {
    return __longlong_as_double(static_cast<long long>(
        (it.s & 1) ? (1ull << 63) : unflip64(it.w)));
  }
};

// Padding: above every real key of its segment (image all ones, slot >= G).
__device__ __forceinline__ void make_pad(Narrow& it, int slot) {
  it.w = narrow_word(0xffffffffu, slot, 0);
}
__device__ __forceinline__ void make_pad(Wide& it, int slot) {
  it.w = ~0ull;
  it.s = static_cast<uint32_t>(slot) << 1;
}
__device__ __forceinline__ int slot_of(Narrow it) {
  return static_cast<int>((it.w >> 16) & 0xffff);
}
__device__ __forceinline__ int slot_of(Wide it) {
  return static_cast<int>(it.s >> 1);
}

// a <- the smaller, b <- the larger.
template <typename Item>
__device__ __forceinline__ void cas(Item& a, Item& b) {
  const bool swap = less(b, a);
  const Item lo = swap ? b : a;
  b = swap ? a : b;
  a = lo;
}
// The smaller of mine and other for the lower slot of a pair, else the larger.
template <typename Item>
__device__ __forceinline__ Item pick(Item mine, Item other, bool lower) {
  return (less(other, mine) == lower) ? other : mine;
}

// Sorts every aligned block of min(P, 16) of a thread's 16 slots (P a
// power of two) with a bitonic network in registers, every comparator
// ascending: each merge of size sz first compares slot i with i ^ (sz-1),
// then half-cleans with strides sz/4 .. 1.
template <typename Item>
__device__ __forceinline__ void sort_in_thread(Item (&x)[kItems], int P) {
#pragma unroll
  for (int sz = 2; sz <= kItems; sz <<= 1) {
    if (sz > P) break;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if ((i & (sz >> 1)) == 0) cas(x[i], x[i ^ (sz - 1)]);
    }
#pragma unroll
    for (int st = sz >> 2; st >= 1; st >>= 1) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if ((i & st) == 0) cas(x[i], x[i ^ st]);
      }
    }
  }
}

// Continues the same network across the lanes of a warp (sizes 32 .. min(P,
// 512)), the warp's 32 x 16 slots held blocked (lane l holds 16l .. 16l+15):
// strides of 16 and more are shuffles, smaller ones stay in registers.
template <typename Item>
__device__ __forceinline__ void sort_in_warp(Item (&x)[kItems], int P) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int sz = 2 * kItems; sz <= kWarpSpan; sz <<= 1) {
    if (sz > P) break;
    // Slot 16l+i meets slot 16(l^m)+15-i: the partner lane passes its item
    // 15-i in the same shuffle.
    const int m = sz / kItems - 1;
    const bool lower = (lane & (sz / kItems / 2)) == 0;
#pragma unroll
    for (int i = 0; i < kItems / 2; ++i) {
      const Item for_i = shfl_xor(x[kItems - 1 - i], m);
      const Item for_j = shfl_xor(x[i], m);
      x[i] = pick(x[i], for_i, lower);
      x[kItems - 1 - i] = pick(x[kItems - 1 - i], for_j, lower);
    }
#pragma unroll
    for (int st = sz >> 2; st >= kItems; st >>= 1) {
      const int mm = st / kItems;
      const bool low = (lane & mm) == 0;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        x[i] = pick(x[i], shfl_xor(x[i], mm), low);
      }
    }
#pragma unroll
    for (int st = kItems / 2; st >= 1; st >>= 1) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if ((i & st) == 0) cas(x[i], x[i ^ st]);
      }
    }
  }
}

__device__ __forceinline__ int padded(int p) { return p + p / kItems; }

// Sort words in shared memory: the 64-bit word, and for 8-byte keys the
// slot word beside it.
template <typename Item>
struct ItemBuf {
  uint64_t* w;
  uint32_t* s;
  __device__ __forceinline__ void put(int i, Item x) const {
    w[i] = x.w;
    if constexpr (sizeof(Item) > 8) s[i] = x.s;
  }
  __device__ __forceinline__ Item get(int i) const {
    Item x;
    x.w = w[i];
    if constexpr (sizeof(Item) > 8) x.s = s[i];
    return x;
  }
};

// One level of merges in shared memory: inside every segment of P slots,
// the sorted runs [a, a+h) and [a+h, a+2h) (a a multiple of 2h, both cut
// at the segment's end) become one sorted run.  A thread writes its 16
// slots to the buffer, finds by the merge-path search how many of its first
// output's predecessors come from the left run, and takes its 16 outputs
// with two fingers, moving on to the next pair (co-rank (0, 0)) where one
// ends.  Pairs that lie inside one warp's 512 slots need only the warp's
// barrier.
template <typename Item>
__device__ __forceinline__ void merge_level(Item (&x)[kItems], int h, int P,
                                            const ItemBuf<Item>& buf) {
  const int t0 = threadIdx.x * kItems;
  const bool in_warp = 2 * h <= kWarpSpan && (h & (h - 1)) == 0;
  if (in_warp) {
    __syncwarp();
  } else {
    __syncthreads();  // every thread is done reading the buffer
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) buf.put(padded(t0 + i), x[i]);
  if (in_warp) {
    __syncwarp();
  } else {
    __syncthreads();
  }
  const int end = (t0 & ~(P - 1)) + P;  // the segment's end
  int a = t0 - (t0 & (P - 1)) % (2 * h);
  int am = min(a + h, end);
  int ae = min(a + 2 * h, end);
  const int d = t0 - a;
  int lo = max(0, d - (ae - am));
  int hi = min(d, am - a);
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (less(buf.get(padded(a + mid - 1)), buf.get(padded(am + d - mid)))) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  int ia = a + lo;
  int ib = am + d - lo;
  Item xa = buf.get(padded(min(ia, end - 1)));
  Item xb = buf.get(padded(min(ib, end - 1)));
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (t0 + i == ae) {  // the next pair starts here
      a = ae;
      am = min(a + h, end);
      ae = min(a + 2 * h, end);
      ia = a;
      ib = am;
      xa = buf.get(padded(ia));
      xb = buf.get(padded(min(ib, end - 1)));
    }
    const bool take_a = ia < am && (ib >= ae || less(xa, xb));
    x[i] = take_a ? xa : xb;
    if (take_a) {
      if (++ia < am) xa = buf.get(padded(ia));
    } else {
      if (++ib < ae) xb = buf.get(padded(ib));
    }
  }
}

// The width of the sorted runs a segment starts its merge levels with:
// runs of w as given, or, for w < 16, blocks of up to 512 sorted in
// registers and shuffles.
__host__ __device__ constexpr int first_run(int w, int P) {
  return w >= kItems ? w : P < kWarpSpan ? P : kWarpSpan;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Starts copying n elements of src to dst (shared): 16-byte cp.async.cg
// where the span allows it, else element by element.
template <typename T>
__device__ __forceinline__ void stage_span(T* dst, const T* src, int n) {
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && (n * sizeof(T)) % 16 == 0) {
    constexpr int kVec = 16 / sizeof(T);
    for (int c = threadIdx.x; c < n / kVec; c += kThreads) {
      cp_async16(dst + c * kVec, src + c * kVec);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) copy_async(dst + i, src + i);
  }
}

// A thread's 16 consecutive elements of a stage buffer as 16-byte loads,
// lane group g starting at chunk g so that a quarter warp reads 8 distinct
// bank groups, then put back in order.
template <typename T>
__device__ __forceinline__ void load16(T (&out)[kItems], const T* src) {
  constexpr int C = kItems * sizeof(T) / 16;
  const int s = (threadIdx.x * C / 8) % C;
  uint4 u[C];
#pragma unroll
  for (int v = 0; v < C; ++v) u[v] = reinterpret_cast<const uint4*>(src)[(v + s) % C];
#pragma unroll
  for (int b = 1; b < C; b <<= 1) {
    uint4 t[C];
#pragma unroll
    for (int c = 0; c < C; ++c) t[c] = u[(c - b + C) % C];
#pragma unroll
    for (int c = 0; c < C; ++c) u[c] = (s & b) ? t[c] : u[c];
  }
  memcpy(out, u, sizeof(u));
}

template <typename T>
__device__ __forceinline__ void store16(T* dst, const T (&v)[kItems]) {
  constexpr int C = kItems * sizeof(T) / 16;
  uint4 u[C];
  memcpy(u, v, sizeof(u));
#pragma unroll
  for (int c = 0; c < C; ++c) reinterpret_cast<uint4*>(dst)[c] = u[c];
}

template <typename Key, typename Val, bool HAS_VALS>
__host__ __device__ constexpr size_t stage_bytes() {
  return 2 * kTile * (sizeof(Key) + (HAS_VALS ? sizeof(Val) : 0));
}
// The merge buffer (sort words, padded), which also holds the keys and
// payload of a tile laid out by segment when G is not P.
template <typename Key, typename Val, bool HAS_VALS>
__host__ __device__ constexpr size_t region_bytes() {
  const size_t words =
      kMergeEntries * (sizeof(uint64_t) + (sizeof(Key) == 8 ? sizeof(uint32_t) : 0));
  const size_t layout =
      kMergeEntries * (sizeof(Key) + (HAS_VALS ? sizeof(Val) : 0));
  return words > layout ? words : layout;
}

// e / G for 0 <= e < 4096 and 1 < G < 4096, with magic = ceil(2^24 / G).
__device__ __forceinline__ int div_small(int e, uint32_t magic) {
  return static_cast<int>((static_cast<uint64_t>(e) * magic) >> 24);
}

// Groups [first, first + n) of the input, one contiguous span, into stage
// buffer `buf`.
template <typename Key, typename Val, bool HAS_VALS>
__device__ __forceinline__ void stage_tile(Key* sk, Val* sv,
                                           const Key* runs, const Val* vals,
                                           int G, int64_t first, int n) {
  stage_span(sk, runs + first * G, n * G);
  if constexpr (HAS_VALS) stage_span(sv, vals + first * G, n * G);
}

template <typename Key, typename Val, bool HAS_VALS>
__global__ void __launch_bounds__(kThreads)
    merge_kway_groups_kernel(const Key* __restrict__ runs,
                             const Val* __restrict__ vals, int w, int G,
                             int P, int64_t groups, int64_t tiles,
                             Key* __restrict__ out_k,
                             Val* __restrict__ out_v) {
  using Ord = Order<Key>;
  using Item = typename Ord::Item;
  extern __shared__ __align__(16) unsigned char smem[];
  Key* const sk = reinterpret_cast<Key*>(smem);
  Val* const sv = reinterpret_cast<Val*>(smem + 2 * kTile * sizeof(Key));
  unsigned char* const mb = smem + stage_bytes<Key, Val, HAS_VALS>();
  const ItemBuf<Item> buf{reinterpret_cast<uint64_t*>(mb),
                          reinterpret_cast<uint32_t*>(mb + kMergeEntries * sizeof(uint64_t))};
  // A tile laid out by segment (slot j*P + o holds element o of group j),
  // padded like the merge buffer, when G is not P.
  Key* const lay_k = reinterpret_cast<Key*>(mb);
  Val* const lay_v = reinterpret_cast<Val*>(mb + kMergeEntries * sizeof(Key));
  const uint32_t magic = ((1u << 24) + G - 1) / G;
  const int per_tile = kTile / P;
  const int t0 = threadIdx.x * kItems;
  const int run = first_run(w, P);
  auto span = [&](int64_t tile) {
    const int64_t left = groups - tile * per_tile;
    return static_cast<int>(left < per_tile ? left : per_tile);
  };

  int64_t tile = blockIdx.x;
  if (tile < tiles) {
    stage_tile<Key, Val, HAS_VALS>(sk, sv, runs, vals, G, tile * per_tile, span(tile));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const int cur = it & 1;
    const int64_t next = tile + gridDim.x;
    if (next < tiles) {  // the next tile arrives while this one sorts
      stage_tile<Key, Val, HAS_VALS>(sk + (cur ^ 1) * kTile, sv + (cur ^ 1) * kTile,
                                     runs, vals, G, next * per_tile, span(next));
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();

    const Key* const k_in = sk + cur * kTile;
    const Val* const v_in = sv + cur * kTile;
    const int n_groups = span(tile);
    const int n_real = n_groups * G;
    Item x[kItems];
    if (G == P) {  // the stage is the tile: slot p of segment p / P
      Key kk[kItems];
      load16(kk, k_in + t0);
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int p = t0 + i;
        if (p < n_real) {
          x[i] = Ord::make(kk[i], p & (P - 1));
        } else {
          make_pad(x[i], p & (P - 1));
        }
      }
    } else {  // lay the tile out by segment, striped (no bank conflicts)
      for (int e = threadIdx.x; e < n_real; e += kThreads) {
        const int j = div_small(e, magic);
        lay_k[padded(j * P + e - j * G)] = k_in[e];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int p = t0 + i;
        const int o = p & (P - 1);
        if (p / P < n_groups && o < G) {
          x[i] = Ord::make(lay_k[padded(p)], o);
        } else {
          make_pad(x[i], o);
        }
      }
      __syncthreads();  // the merge levels reuse the layout's memory
    }

    if (w < kItems) {
      sort_in_thread(x, P);
      sort_in_warp(x, P);
    }
    // Runs past the group's G real elements hold only padding, which sorts
    // after every real key: once a run covers [0, G) the group is sorted.
    for (int h = run; h < G; h *= 2) merge_level(x, h, P, buf);

    const int64_t out_base = tile * per_tile * static_cast<int64_t>(G);
    if (G == P) {
      Key kk[kItems];
      Val vv[kItems];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        kk[i] = Ord::key(x[i]);
        if constexpr (HAS_VALS) {
          vv[i] = v_in[((t0 + i) & ~(P - 1)) + slot_of(x[i])];
        }
      }
      if (t0 + kItems <= n_real) {  // out_base + t0 is a multiple of 16 slots
        store16(out_k + out_base + t0, kk);
        if constexpr (HAS_VALS) store16(out_v + out_base + t0, vv);
      } else {
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          if (t0 + i < n_real) {
            out_k[out_base + t0 + i] = kk[i];
            if constexpr (HAS_VALS) out_v[out_base + t0 + i] = vv[i];
          }
        }
      }
    } else {  // back through the layout, then striped and coalesced out
      __syncthreads();  // the merge levels are done reading their buffer
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int p = t0 + i;
        if (p / P < n_groups && (p & (P - 1)) < G) {
          lay_k[padded(p)] = Ord::key(x[i]);
          if constexpr (HAS_VALS) {
            lay_v[padded(p)] = v_in[(p / P) * G + slot_of(x[i])];
          }
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < n_real; e += kThreads) {
        const int j = div_small(e, magic);
        const int q = padded(j * P + e - j * G);
        out_k[out_base + e] = lay_k[q];
        if constexpr (HAS_VALS) out_v[out_base + e] = lay_v[q];
      }
    }
    __syncthreads();  // the stage buffer `cur` is refilled next iteration
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace grouped

// ===========================================================================
// The wide grouped launch (merge_kway_groups_wide_kernel): groups of k runs
// of width w, laid out (g, k, w), of any size; merge sort's passes above the
// leaf.  The output of group i is cut into tiles of S = 3840 elements (ranks
// [r*S, min((r+1)*S, k*w)) of the group's stable merge); a block takes a few
// consecutive tiles of one group (tiles_per_block: up to 8, fewer at large
// k or when the pass has few tiles), which share their boundaries.
//
// The ragged form: with int32 lengths (g, k), run q of group i holds
// lengths[i, q] real elements (each clamped to [0, w]), the rest of its row
// padding that is never read; the group's output is its first out_len ranks
// (out_len <= k*w; tiles of S from 0), and positions at or past the group's
// real total are not written.  The co-rank counts as
// repro_torch.core.engine.lemma1_counts does: every window of run q starts
// inside [max(0, i - (the other runs' real total)), min(len_q, i)], so only
// real elements are probed, staged or merged, and real dtype-max keys never
// meet the padding.
//
// There is no phase 1.  The block co-ranks its tiles' boundaries inside its
// group itself, the paper's partition that every processing element
// computes for its own output block, with the run-index tie-break of
// repro_torch.core.engine: the cut j_q(i) of run q is the number of its
// elements whose merged rank is below i.  Global memory latency, not
// compares, bounds that search, so it is built to need few dependent reads:
//   * Windows: every cut starts in [max(0, i-(k-1)w), min(w, i)].
//   * Probe rounds: a warp per (boundary, run) reads 32 evenly spaced
//     elements of that run's window at once (asynchronously).  Each probe's
//     merged rank, with every other run's count clamped to that run's window
//     (which keeps every decision of the full count), is bracketed by the
//     other runs' probes in shared memory: a probe whose bracket lies below
//     the boundary is taken, one above is not, and the window shrinks to
//     between them.  Where the runs interleave evenly, a probe's bracket is
//     about one probe step wide whatever k is, so a round shrinks the
//     windows to a few steps of 32 with one dependent global read (a
//     probe is bracketed in every other run: k^2 searches in shared memory
//     a boundary a round, which is what the co-rank costs at large k).
//     Once a round fails to halve a boundary's windows (runs that do not
//     interleave evenly, long ties), every probe also counts exactly by a
//     binary search in global memory inside each of its brackets.
//   * Exact stage: once a boundary's windows hold at most S / (boundaries)
//     elements in all, they are read into shared memory, and a warp per
//     (boundary, run) binary-searches that run's window for the first
//     element whose clamped rank reaches the boundary, each step's counts
//     into the other runs' windows taken a lane a run; the cut is the
//     window start plus what precedes it.
// Then, tile by tile, the block stages exactly its segments and runs
// merge_kway_tile's merge tree (TablePairs levels) and leaves with 16-byte
// stores, as that kernel does.  The bound on an H100 is bytes, as for
// merge_kway_tile; the co-rank's rounds (a few microseconds each, mostly
// latency) are what a block adds, shared by its tiles (PERF.md has the
// measured times).
// ===========================================================================

namespace wide {

constexpr int kProbes = 32;        // probes of one window a round: one warp
constexpr int kMaxRuns = 64;
constexpr int kWarps = kThreads / 32;

// Tiles a block takes: up to 8 for k <= 16, 4 for k <= 32 and 2 above (a
// block's T tiles share T + 1 boundaries, and the co-rank's work is per
// boundary; the probe tables of (T + 1) * k windows bound T at large k),
// and fewer when the pass has few tiles (every SM should get work).
__host__ __device__ constexpr int tiles_per_block(int k, int64_t tiles) {
  const int by_k = k <= 16 ? 8 : k <= 32 ? 4 : 2;
  const int64_t by_size = tiles / 1024;
  return by_size < 1 ? 1 : by_size < by_k ? static_cast<int>(by_size) : by_k;
}

// Elements of sorted src[0, n) that come before x in the merge: those <= x
// when src's run is before x's (`ties`), else those < x.
template <typename Key>
__device__ __forceinline__ int count_before(const Key* src, int n, Key x,
                                            bool ties) {
  int lo = 0;
  int hi = n;
  const auto ox = ord(x);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const auto v = ord(src[mid]);
    if (ties ? v <= ox : v < ox) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The sum of x over the warp's lanes, in every lane.
__device__ __forceinline__ int64_t warp_sum(int64_t x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  return x;
}

constexpr int kInterleave = 4;

// The probes of a window (kProbes sorted values) that come before x: a
// fixed five-step search, then the last probe.  Probes of a window not
// probed this round are never used.
template <typename Key>
__device__ __forceinline__ int probes_before(const Key* p, Key x, bool ties) {
  const auto ox = ord(x);
  int n = 0;
#pragma unroll
  for (int s = kProbes / 2; s > 0; s >>= 1) {
    const auto v = ord(p[n + s - 1]);
    n += (ties ? v <= ox : v < ox) ? s : 0;
  }
  if (n == kProbes - 1) {
    const auto v = ord(p[n]);
    n += (ties ? v <= ox : v < ox) ? 1 : 0;
  }
  return n;
}

template <typename Key>
__host__ __device__ constexpr size_t scratch_bytes(int k, int nb) {
  return nb * k * kProbes * sizeof(Key)         // probe values
         + k * sizeof(int64_t)                  // segment sources
         + (nb + 2) * sizeof(int64_t)           // last window totals, totals
         + (nb * k * kProbes                    // probe positions
            + 5 * nb * k                        // lo, hi, new lo, new hi, taken
            + nb * (k + 1) + (k + 1)            // window offsets, segment starts
            + k                                 // run lengths
            + 2 + nb) * sizeof(int);            // flags
}

// The most scratch a launch takes: the widest (k, boundaries) of each tier
// of tiles_per_block.
template <typename Key>
constexpr size_t kMaxScratch = std::max({scratch_bytes<Key>(16, 9),
                                         scratch_bytes<Key>(32, 5),
                                         scratch_bytes<Key>(64, 3)});

template <typename Key, typename Val, bool HAS_VALS>
__global__ void __launch_bounds__(kThreads)
    merge_kway_groups_wide_kernel(const Key* __restrict__ runs,
                                  const Val* __restrict__ vals,
                                  const int32_t* __restrict__ lengths, int k,
                                  int w, int64_t out_len,
                                  int64_t tiles_per_group, int per_block,
                                  Key* __restrict__ out_k,
                                  Val* __restrict__ out_v) {
  extern __shared__ __align__(16) unsigned char smem[];
  Key* const kbuf0 = reinterpret_cast<Key*>(smem);
  Key* const kbuf1 = kbuf0 + kTile;
  Val* const vbuf0 = reinterpret_cast<Val*>(smem + 2 * kTile * sizeof(Key));
  Val* const vbuf1 = vbuf0 + kTile;
  const int64_t blocks_per_group = (tiles_per_group + per_block - 1) / per_block;
  const int64_t gi = blockIdx.x / blocks_per_group;
  const int64_t r0 = blockIdx.x % blocks_per_group * per_block;
  const int nt = static_cast<int>(min(static_cast<int64_t>(per_block),
                                      tiles_per_group - r0));
  const int nb = nt + 1;  // boundaries r0 .. r0 + nt
  unsigned char* sp = smem + buffer_bytes<Key, Val, HAS_VALS>();
  Key* const pv = reinterpret_cast<Key*>(sp);  // [nb][k][kProbes]
  sp += nb * k * kProbes * sizeof(Key);
  int64_t* const seg_src = reinterpret_cast<int64_t*>(sp);  // [k]
  sp += k * sizeof(int64_t);
  int64_t* const last_total = reinterpret_cast<int64_t*>(sp);  // [nb]
  sp += nb * sizeof(int64_t);
  int64_t* const totals = reinterpret_cast<int64_t*>(sp);  // real, cut at out_len
  sp += 2 * sizeof(int64_t);
  int* const pt = reinterpret_cast<int*>(sp);  // [nb][k][kProbes]
  int* const lo = pt + nb * k * kProbes;       // [nb][k]: the windows
  int* const hi = lo + nb * k;
  int* const nlo = hi + nb * k;
  int* const nhi = nlo + nb * k;
  int* const taken = nhi + nb * k;             // [nb][k]
  int* const woff = taken + nb * k;            // [nb][k + 1]
  int* const seg_start = woff + nb * (k + 1);  // [k + 1]
  int* const run_len = seg_start + (k + 1);    // [k]
  int* const flags = run_len + k;              // go / segments, exact, active[nb]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t G = static_cast<int64_t>(k) * w;
  const Key* const grp = runs + gi * G;  // run q starts at grp + q * w
  const int cap = kTile / nb;            // window elements a boundary stages

  // The runs' real lengths (w each without `lengths`; clamped to [0, w]),
  // their sum and the output's real end: min(sum, out_len).
  for (int q = tid; q < k; q += kThreads) {
    int len = w;
    if (lengths != nullptr) {
      len = lengths[gi * k + q];
      len = len < 0 ? 0 : len > w ? w : len;
    }
    run_len[q] = len;
  }
  __syncthreads();
  if (tid == 0) {
    int64_t sum = 0;
    for (int q = 0; q < k; ++q) sum += run_len[q];
    totals[0] = sum;
    totals[1] = sum < out_len ? sum : out_len;
  }
  __syncthreads();
  const int64_t real_total = totals[0];
  const int64_t end = totals[1];
  // Tiles past the real end write nothing; a block that holds only such
  // tiles has nothing to do.
  if (r0 * kTile >= end) return;
  auto bound = [&](int b) {
    const int64_t i = (r0 + b) * kTile;
    return i < end ? i : end;
  };
  const int pairs = nb * k;

  // Every cut of run q at boundary i lies in [max(0, i - (the other runs'
  // real elements)), min(len_q, i)]: only real elements are ever read.
  for (int e = tid; e < pairs; e += kThreads) {
    const int64_t i = bound(e / k);
    const int len = run_len[e % k];
    const int64_t from = i - (real_total - len);
    lo[e] = static_cast<int>(from > 0 ? from : 0);
    hi[e] = static_cast<int>(i < len ? i : static_cast<int64_t>(len));
  }
  if (tid == 0) flags[1] = 0;
  for (int b = tid; b < nb; b += kThreads) last_total[b] = INT64_MAX;
  __syncthreads();

  // Probe rounds, while a boundary's windows hold more than it may stage.
  for (;;) {
    if (warp == 0) {  // one lane a boundary
      bool more = false;
      if (lane < nb) {
        int64_t total = 0;
        for (int q = 0; q < k; ++q) total += hi[lane * k + q] - lo[lane * k + q];
        more = total > cap;
        flags[2 + lane] = more;
        // A round that did not halve the windows: count exactly from now on.
        if (more && 2 * total > last_total[lane]) flags[1] = 1;
        last_total[lane] = total;
      }
      more = __any_sync(0xffffffffu, more);
      if (lane == 0) flags[0] = more;
    }
    __syncthreads();
    if (!flags[0]) break;
    for (int e = warp; e < pairs; e += kWarps) {
      const int a = lo[e];
      const int z = hi[e];
      if (!flags[2 + e / k] || a == z) continue;
      const int q = e % k;
      const int t = a + static_cast<int>(
          (static_cast<int64_t>(lane + 1) * (z - a) + kProbes - 1) / kProbes);
      pt[e * kProbes + lane] = t;
      copy_async(pv + e * kProbes + lane, grp + static_cast<int64_t>(q) * w + t - 1);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const bool exact = flags[1];
    for (int e = warp; e < pairs; e += kWarps) {
      const int b = e / k;
      const int a = lo[e];
      const int z = hi[e];
      if (!flags[2 + b] || a == z) continue;
      const int q = e % k;
      const int t = pt[e * kProbes + lane];
      const Key x = pv[e * kProbes + lane];
      // The probe is element t-1 of run q: its merged rank, with every
      // other run's count clamped to that run's window, lies in [L, U].
      int64_t L = t - 1;
      int64_t U = t - 1;
      for (int q0 = 0; q0 < k; q0 += kInterleave) {
        // The other runs' probes before x, kInterleave runs at a time (the
        // searches are independent, so their reads overlap).
        int m[kInterleave];
#pragma unroll
        for (int j = 0; j < kInterleave; ++j) {
          m[j] = probes_before(pv + (b * k + min(q0 + j, k - 1)) * kProbes, x,
                               q0 + j < q);
        }
#pragma unroll
        for (int j = 0; j < kInterleave; ++j) {
          const int qq = q0 + j;
          if (qq >= k || qq == q) continue;
          const int f = b * k + qq;
          int clo = lo[f];
          int chi = hi[f];
          if (clo < chi) {  // probed this round: bracket by its probes
            const int* tp = pt + f * kProbes;
            clo = m[j] > 0 ? tp[m[j] - 1] : clo;
            chi = m[j] < kProbes ? tp[m[j]] - 1 : chi;
            if (exact && clo < chi) {
              clo += count_before(grp + static_cast<int64_t>(qq) * w + clo,
                                  chi - clo, x, qq < q);
              chi = clo;
            }
          }
          L += clo;
          U += chi;
        }
      }
      const int64_t i = bound(b);
      const unsigned yes = __ballot_sync(0xffffffffu, U < i);
      const unsigned no = __ballot_sync(0xffffffffu, L >= i);
      const int m = __popc(yes);  // taken probes: a prefix
      const int f = no ? __ffs(no) - 1 : kProbes;  // first probe not taken
      const int at_m = __shfl_sync(0xffffffffu, t, m > 0 ? m - 1 : 0);
      const int at_f = __shfl_sync(0xffffffffu, t, f < kProbes ? f : 0);
      if (lane == 0) {
        nlo[e] = m > 0 ? at_m : a;
        nhi[e] = f < kProbes ? at_f - 1 : z;
      }
    }
    __syncthreads();
    for (int e = tid; e < pairs; e += kThreads) {
      if (flags[2 + e / k] && lo[e] < hi[e]) {
        lo[e] = nlo[e];
        hi[e] = nhi[e];
      }
    }
    __syncthreads();
  }

  // Exact stage: every boundary's windows side by side in kbuf0; then a
  // warp per (boundary, run) finds how many of the run's window elements
  // rank below the boundary, by a binary search over the window whose
  // every step counts the candidate into the other runs' windows, a lane a
  // run (clamped ranks, as above).
  if (tid == 0) {
    for (int b = 0; b < nb; ++b) {
      int s = 0;
      for (int q = 0; q < k; ++q) {
        woff[b * (k + 1) + q] = s;
        s += hi[b * k + q] - lo[b * k + q];
      }
      woff[b * (k + 1) + k] = s;
      if (s > cap) __trap();
    }
  }
  __syncthreads();
  for (int b = 0; b < nb; ++b) {  // every copy in flight at once
    const int* const wo = woff + b * (k + 1);
    for (int c = tid; c < wo[k]; c += kThreads) {
      const int q = last_at_most(wo, k, 1, c);
      copy_async(kbuf0 + b * cap + c, grp + static_cast<int64_t>(q) * w +
                                          lo[b * k + q] + (c - wo[q]));
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int e = warp; e < pairs; e += kWarps) {
    const int b = e / k;
    const int q = e % k;
    const int* const wo = woff + b * (k + 1);
    const Key* const win = kbuf0 + b * cap;
    const int64_t i = bound(b);
    int64_t base = 0;  // every run's window start
    for (int qq = lane; qq < k; qq += 32) base += lo[b * k + qq];
    base = warp_sum(base);
    int a = 0;
    int z = wo[q + 1] - wo[q];
    while (a < z) {  // warp-uniform: the smallest t whose rank is >= i
      const int mid = (a + z) >> 1;
      const Key x = win[wo[q] + mid];
      int64_t c = 0;
      for (int qq = lane; qq < k; qq += 32) {
        if (qq != q) {
          c += count_before(win + wo[qq], wo[qq + 1] - wo[qq], x, qq < q);
        }
      }
      if (base + mid + warp_sum(c) < i) {
        a = mid + 1;
      } else {
        z = mid;
      }
    }
    if (lane == 0) taken[e] = a;
  }
  __syncthreads();

  const Val* const gvals = HAS_VALS ? vals + gi * G : nullptr;
  for (int ti = 0; ti < nt; ++ti) {
    // The tile's segments [cut_q(start), cut_q(end)), compacted in run order.
    if (tid == 0) {
      int kp = 0;
      int len = 0;
      for (int q = 0; q < k; ++q) {
        const int a = lo[ti * k + q] + taken[ti * k + q];
        const int z = lo[(ti + 1) * k + q] + taken[(ti + 1) * k + q];
        if (z < a) __trap();
        if (z > a) {
          seg_src[kp] = static_cast<int64_t>(q) * w + a;
          seg_start[kp] = len;
          ++kp;
          len += z - a;
        }
      }
      seg_start[kp] = len;
      if (len != bound(ti + 1) - bound(ti)) __trap();
      flags[0] = kp;
    }
    __syncthreads();
    const int kp = flags[0];
    const int len = seg_start[kp];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = tid + it * kThreads;
      if (i < len) {
        const int c = last_at_most(seg_start, kp, 1, i);
        const int64_t from = seg_src[c] + (i - seg_start[c]);
        copy_async(kbuf0 + i, grp + from);
        if constexpr (HAS_VALS) copy_async(vbuf0 + i, gvals + from);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    bool flipped = false;
    for (int step = 1; step < kp; step <<= 1) {
      merge_level<Key, Val, HAS_VALS>(flipped ? kbuf1 : kbuf0,
                                      flipped ? kbuf0 : kbuf1,
                                      flipped ? vbuf1 : vbuf0,
                                      flipped ? vbuf0 : vbuf1, len,
                                      TablePairs{seg_start, kp, step});
      __syncthreads();
      flipped = !flipped;
    }

    // The tile starts at a multiple of 16 bytes when the group size allows
    // it: else store element by element (still coalesced).
    const int64_t out = gi * out_len + bound(ti);
    Key* const dk = out_k + out;
    const Key* const rk = flipped ? kbuf1 : kbuf0;
    if (reinterpret_cast<uintptr_t>(dk) % 16 == 0) {
      store_tile(dk, rk, len);
    } else {
      for (int i = tid; i < len; i += kThreads) dk[i] = rk[i];
    }
    if constexpr (HAS_VALS) {
      Val* const dv = out_v + out;
      const Val* const rv = flipped ? vbuf1 : vbuf0;
      if (reinterpret_cast<uintptr_t>(dv) % 16 == 0) {
        store_tile(dv, rv, len);
      } else {
        for (int i = tid; i < len; i += kThreads) dv[i] = rv[i];
      }
    }
    __syncthreads();  // the buffers and the table are reused by the next tile
  }
}

}  // namespace wide

// One launch's arguments, passed down the template dispatch below.
enum class Mode { kTiled, kGrouped, kWide };

struct Args {
  Mode mode;
  const void* runs;
  const void* vals;
  const void* lengths;
  int k;
  int64_t w;
  const void* cb;
  void* out_k;
  void* out_v;
  int64_t out_len;
  int64_t num_tiles;
  int64_t groups;
  cudaStream_t stream;
};

template <typename Key, typename Val, bool HAS_VALS>
int launch_tiled(const Args& a) {
  auto* kernel = merge_kway_tile_kernel<Key, Val, HAS_VALS>;
  // At most min(k, S) segments of a tile are non-empty.
  const int table = std::min(a.k, kTile);
  const size_t dyn = smem_bytes<Key, Val, HAS_VALS>(table);
  // Above 48 KiB in all, a block must opt in to more shared memory.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(a.num_tiles), kThreads, dyn, a.stream>>>(
      static_cast<const Key*>(a.runs), static_cast<const Val*>(a.vals), a.k,
      a.w, static_cast<const int32_t*>(a.cb), static_cast<Key*>(a.out_k),
      static_cast<Val*>(a.out_v), a.out_len, table);
  return static_cast<int>(cudaGetLastError());
}

// The grouped launch: the shared-memory opt-in once per instance, and the
// grid (the card's SMs times the blocks of this size an SM holds) once per
// instance and buffer size.
template <typename Key, typename Val, bool HAS_VALS>
int launch_grouped(const Args& a) {
  namespace gr = grouped;
  auto* kernel = gr::merge_kway_groups_kernel<Key, Val, HAS_VALS>;
  constexpr size_t kStage = gr::stage_bytes<Key, Val, HAS_VALS>();
  constexpr size_t kRegion = gr::region_bytes<Key, Val, HAS_VALS>();
  static int sms = 0;
  static int per_sm[2] = {0, 0};  // without, with the merge buffer
  const int w = static_cast<int>(a.w);
  const int G = a.k * w;
  int P = 1;
  while (P < G) P <<= 1;
  // The merge buffer: for merge levels, or to lay out groups that are not
  // a power of two.
  const bool region = G != P || gr::first_run(w, P) < G;
  const size_t dyn = kStage + (region ? kRegion : 0);
  cudaError_t err;
  if (sms == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kStage + kRegion));
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (per_sm[region] == 0) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                        gr::kThreads, dyn);
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm[region] = n > 0 ? n : 1;
  }
  const int64_t per_tile = gr::kTile / P;
  const int64_t tiles = (a.groups + per_tile - 1) / per_tile;
  const int64_t most = static_cast<int64_t>(sms) * per_sm[region];
  const unsigned grid = static_cast<unsigned>(tiles < most ? tiles : most);
  kernel<<<grid, gr::kThreads, dyn, a.stream>>>(
      static_cast<const Key*>(a.runs), static_cast<const Val*>(a.vals), w, G,
      P, a.groups, tiles, static_cast<Key*>(a.out_k),
      static_cast<Val*>(a.out_v));
  return static_cast<int>(cudaGetLastError());
}

template <typename Key, typename Val, bool HAS_VALS>
int launch_wide(const Args& a) {
  auto* kernel = wide::merge_kway_groups_wide_kernel<Key, Val, HAS_VALS>;
  constexpr size_t kBuffers = buffer_bytes<Key, Val, HAS_VALS>();
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kBuffers + wide::kMaxScratch<Key>));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int64_t per_group = (a.out_len + kTile - 1) / kTile;
  const int per_block = wide::tiles_per_block(a.k, a.groups * per_group);
  const int64_t blocks = a.groups * ((per_group + per_block - 1) / per_block);
  if (blocks > 0x7fffffff) return -1;
  if (blocks == 0) return 0;
  const int nb = static_cast<int>(per_group < per_block ? per_group : per_block) + 1;
  const size_t dyn = kBuffers + wide::scratch_bytes<Key>(a.k, nb);
  kernel<<<static_cast<unsigned>(blocks), kThreads, dyn, a.stream>>>(
      static_cast<const Key*>(a.runs), static_cast<const Val*>(a.vals),
      static_cast<const int32_t*>(a.lengths), a.k, static_cast<int>(a.w),
      a.out_len, per_group, per_block, static_cast<Key*>(a.out_k),
      static_cast<Val*>(a.out_v));
  return static_cast<int>(cudaGetLastError());
}

template <typename Key, typename Val, bool HAS_VALS>
int launch(const Args& a) {
  switch (a.mode) {
    case Mode::kGrouped:
      return launch_grouped<Key, Val, HAS_VALS>(a);
    case Mode::kWide:
      return launch_wide<Key, Val, HAS_VALS>(a);
    default:
      return launch_tiled<Key, Val, HAS_VALS>(a);
  }
}

template <typename Key>
int launch_vals(int val_bytes, const Args& a) {
  switch (val_bytes) {
    case 0:
      return launch<Key, uint32_t, false>(a);
    case 4:
      return launch<Key, uint32_t, true>(a);
    case 8:
      return launch<Key, uint64_t, true>(a);
    default:
      return -1;
  }
}

int dispatch(int key_dtype, int val_bytes, const Args& a) {
  switch (key_dtype) {
    case 0:
      return launch_vals<int32_t>(val_bytes, a);
    case 1:
      return launch_vals<float>(val_bytes, a);
    case 2:
      return launch_vals<int64_t>(val_bytes, a);
    case 3:
      return launch_vals<double>(val_bytes, a);
    case 4:
      return launch_vals<__half>(val_bytes, a);
    case 5:
      return launch_vals<__nv_bfloat16>(val_bytes, a);
    default:
      return -1;
  }
}

}  // namespace

// key_dtype: 0 int32, 1 float32, 2 int64, 3 float64, 4 float16,
// 5 bfloat16.  val_bytes: 0 (no payload), 4 or 8.  runs/vals: (k, w)
// row-major; cb: (num_tiles+1, k) int32 cut matrix of the tile boundaries
// min(r*tile, out_len); out_k/out_v: (out_len,).  vals/out_v may be null
// when val_bytes is 0.  Returns cudaGetLastError() after the launch, or -1
// for an unsupported dtype, payload width or tile.
extern "C" int merge_kway_tile_launch(int key_dtype, int val_bytes, int tile,
                                      int k, const void* runs,
                                      const void* vals, int64_t w,
                                      const void* cb, void* out_k,
                                      void* out_v, int64_t out_len,
                                      int64_t num_tiles, void* stream) {
  if (tile != kTile || k < 1) return -1;
  Args a{};
  a.mode = Mode::kTiled;
  a.runs = runs;
  a.vals = vals;
  a.k = k;
  a.w = w;
  a.cb = cb;
  a.out_k = out_k;
  a.out_v = out_v;
  a.out_len = out_len;
  a.num_tiles = num_tiles;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(key_dtype, val_bytes, a);
}

// The grouped launch: runs/vals (groups, k, w) row-major, out_k/out_v
// (groups, k*w), with k*w <= tile = 4096.  Same dtype codes and return
// values as above.
extern "C" int merge_kway_groups_launch(int key_dtype, int val_bytes,
                                        int tile, int k, int w,
                                        int64_t groups, const void* runs,
                                        const void* vals, void* out_k,
                                        void* out_v, void* stream) {
  if (tile != grouped::kTile || k < 1 || w < 1 || groups < 1 ||
      static_cast<int64_t>(k) * w > grouped::kTile) {
    return -1;
  }
  Args a{};
  a.mode = Mode::kGrouped;
  a.runs = runs;
  a.vals = vals;
  a.k = k;
  a.w = w;
  a.out_k = out_k;
  a.out_v = out_v;
  a.groups = groups;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(key_dtype, val_bytes, a);
}

// The wide grouped launch: runs/vals (groups, k, w) row-major, any k*w
// below 2^31, 1 <= k <= 64; lengths: null, or int32 (groups, k) real run
// lengths (each clamped to [0, w]; a run's elements past its length are
// never read); out_k/out_v (groups, out_len), 0 <= out_len <= k*w: the
// first out_len ranks of each group's merge, positions at or past the
// group's real total not written; tile = 3840 output elements a block.
// Same dtype codes and return values as above.
extern "C" int merge_kway_groups_wide_launch(int key_dtype, int val_bytes,
                                             int tile, int k, int64_t w,
                                             int64_t groups,
                                             const void* runs,
                                             const void* vals,
                                             const void* lengths,
                                             int64_t out_len, void* out_k,
                                             void* out_v, void* stream) {
  if (tile != kTile || k < 1 || k > wide::kMaxRuns || w < 1 || groups < 1 ||
      static_cast<int64_t>(k) * w >= (int64_t{1} << 31) || out_len < 0 ||
      out_len > static_cast<int64_t>(k) * w) {
    return -1;
  }
  Args a{};
  a.mode = Mode::kWide;
  a.runs = runs;
  a.vals = vals;
  a.lengths = lengths;
  a.out_len = out_len;
  a.k = k;
  a.w = w;
  a.out_k = out_k;
  a.out_v = out_v;
  a.groups = groups;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(key_dtype, val_bytes, a);
}
