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
// The grouped launch (merge_kway_groups_kernel) merges g independent groups
// of k runs of width w, laid out (g, k, w), into (g, k*w): a batch of small
// stable k-way merges, as the top-k tournament and merge sort's first passes
// issue them.  A group whose k*w elements fit one tile needs no phase 1: its
// cuts are 0 and w in each run.  So a block packs floor(S / (k*w)) whole
// groups into its tile, stages them with one contiguous copy, and runs only
// the first ceil(log2 k) levels of the same merge tree, whose pairs never
// cross a group (pair bounds are clamped at the group's end; every segment is
// one run of w >= 1 elements, so none is empty).
//
// The run count k is a launch argument (any k >= 1).  Keys are int32,
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

// The pairs of one merge level over whole groups of k runs of width w packed
// side by side: inside each group of k*w slots, pair p merges runs
// [p*span, p*span+step) and [p*span+step, p*span+span), clamped at the
// group's end, so no pair crosses a group.
struct GroupPairs {
  int w;
  int group;  // k * w slots
  int step;

  __device__ __forceinline__ void find(int s, int& p, int& lo, int& md,
                                       int& he) const {
    const int span = 2 * step * w;
    const int first = s - s % group;  // the group's first slot
    p = (s - first) / span;
    lo = first + p * span;
    md = min(lo + step * w, first + group);
    he = min(lo + span, first + group);
  }
  __device__ __forceinline__ void next(int& p, int& md, int& he) const {
    int lo;
    find(he, p, lo, md, he);
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

// Grouped launch: `groups` independent groups of k sorted runs of width w,
// laid out (groups, k, w), merged into (groups, k*w).  Block r takes groups
// [r*per_tile, (r+1)*per_tile): one contiguous range of the input and of the
// output.  per_tile * k * w <= S.
template <typename Key, typename Val, bool HAS_VALS>
__global__ void __launch_bounds__(kThreads)
    merge_kway_groups_kernel(const Key* __restrict__ runs,
                             const Val* __restrict__ vals, int k, int w,
                             int64_t groups, int per_tile,
                             Key* __restrict__ out_k,
                             Val* __restrict__ out_v) {
  extern __shared__ __align__(16) unsigned char smem[];
  Key* const kbuf0 = reinterpret_cast<Key*>(smem);
  Key* const kbuf1 = kbuf0 + kTile;
  Val* const vbuf0 = reinterpret_cast<Val*>(smem + 2 * kTile * sizeof(Key));
  Val* const vbuf1 = vbuf0 + kTile;

  const int group = k * w;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * per_tile;
  const int64_t left = groups - first;
  const int len = static_cast<int>(left < per_tile ? left : per_tile) * group;
  const int64_t base = first * group;

  // Staging: the tile's groups are one contiguous, coalesced read.
  for (int i = threadIdx.x; i < len; i += kThreads) {
    copy_async(kbuf0 + i, runs + base + i);
    if constexpr (HAS_VALS) copy_async(vbuf0 + i, vals + base + i);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Merging: the first ceil(log2 k) levels of the tree, inside each group.
  bool flipped = false;
  for (int step = 1; step < k; step <<= 1) {
    merge_level<Key, Val, HAS_VALS>(flipped ? kbuf1 : kbuf0,
                                    flipped ? kbuf0 : kbuf1,
                                    flipped ? vbuf1 : vbuf0,
                                    flipped ? vbuf0 : vbuf1, len,
                                    GroupPairs{w, group, step});
    __syncthreads();
    flipped = !flipped;
  }

  // A tile starts at base elements, a multiple of 16 bytes only when the
  // group size allows it: else store element by element (still coalesced).
  Key* const dk = out_k + base;
  if (reinterpret_cast<uintptr_t>(dk) % 16 == 0) {
    store_tile(dk, flipped ? kbuf1 : kbuf0, len);
  } else {
    const Key* src = flipped ? kbuf1 : kbuf0;
    for (int i = threadIdx.x; i < len; i += kThreads) dk[i] = src[i];
  }
  if constexpr (HAS_VALS) {
    Val* const dv = out_v + base;
    if (reinterpret_cast<uintptr_t>(dv) % 16 == 0) {
      store_tile(dv, flipped ? vbuf1 : vbuf0, len);
    } else {
      const Val* src = flipped ? vbuf1 : vbuf0;
      for (int i = threadIdx.x; i < len; i += kThreads) dv[i] = src[i];
    }
  }
}

// One launch's arguments, passed down the template dispatch below.  A
// grouped launch uses groups/per_tile; a tiled one cb/out_len.
struct Args {
  bool grouped;
  const void* runs;
  const void* vals;
  int k;
  int64_t w;
  const void* cb;
  void* out_k;
  void* out_v;
  int64_t out_len;
  int64_t num_tiles;
  int64_t groups;
  int per_tile;
  cudaStream_t stream;
};

template <typename Key, typename Val, bool HAS_VALS>
int launch(const Args& a) {
  if (a.grouped) {
    auto* kernel = merge_kway_groups_kernel<Key, Val, HAS_VALS>;
    // 16 bytes of slack: a level may read (never compare) the slot after
    // the last buffer's end.
    const size_t dyn = buffer_bytes<Key, Val, HAS_VALS>() + 16;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned>(a.num_tiles), kThreads, dyn, a.stream>>>(
        static_cast<const Key*>(a.runs), static_cast<const Val*>(a.vals),
        a.k, static_cast<int>(a.w), a.groups, a.per_tile,
        static_cast<Key*>(a.out_k), static_cast<Val*>(a.out_v));
    return static_cast<int>(cudaGetLastError());
  }
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
  a.grouped = false;
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
// (groups, k*w); per_tile whole groups a tile, with per_tile >= 1 and
// per_tile * k * w <= tile.  Same dtype codes and return values as above.
extern "C" int merge_kway_groups_launch(int key_dtype, int val_bytes,
                                        int tile, int k, int w,
                                        int64_t groups, int per_tile,
                                        const void* runs, const void* vals,
                                        void* out_k, void* out_v,
                                        void* stream) {
  if (tile != kTile || k < 1 || w < 1 || groups < 1 || per_tile < 1 ||
      static_cast<int64_t>(per_tile) * k * w > kTile) {
    return -1;
  }
  Args a{};
  a.grouped = true;
  a.runs = runs;
  a.vals = vals;
  a.k = k;
  a.w = w;
  a.out_k = out_k;
  a.out_v = out_v;
  a.groups = groups;
  a.per_tile = per_tile;
  a.num_tiles = (groups + per_tile - 1) / per_tile;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(key_dtype, val_bytes, a);
}
