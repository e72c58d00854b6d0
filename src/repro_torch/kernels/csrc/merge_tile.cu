// merge_tile.cu — the stable merge of two sorted arrays, one output tile of
// kTile elements at a time, by persistent blocks that co-rank their own
// tiles and stage them double-buffered.
//
// Replaces the TPU kernel merge_tile_kernel (src/repro/kernels/merge.py:57),
// launched by merge_pallas (merge.py:139, pl.pallas_call at :191), and the
// phase 1 in front of it (the co-rank of every tile boundary, plain JAX
// there).
//
// What bounds it on an H100: bytes.  The merge reads m+n elements and writes
// m+n elements, (m+n)*sizeof(T) each way, and does O(log S) comparisons per
// element — far below the ~300 operations per byte at which the card stops
// being memory-bound.  The co-rank adds O(log min(m, n)) reads per tile
// boundary, a few bytes per tile.
//
// What the design does about that bound.
//   * Each block owns a contiguous range of T consecutive tiles (T the same
//     for every block but the last, at most kMaxTiles), so its T tiles share
//     T+1 boundaries r*S.  The grid holds as many blocks as fit on the card
//     at once (more only past kMaxTiles tiles a block).
//   * Co-rank inside the block, the paper's processing element: before its
//     first tile, one lane per boundary (all of the block's boundaries at
//     once) runs Algorithm 1 of Siebert & Träff — start from j = min(i, m),
//     k = i - j, j_low = max(0, i - n), k_low = 0 and halve toward the
//     Lemma-1 conditions for at most prop1_bound(m, n) rounds, each round's
//     four boundary reads A[j-1], B[k], B[k-1], A[j] issued together.  The
//     comparisons are those of repro_torch.core.engine
//     (first_condition_violated: !(A[j-1] <= B[k]); second_condition_violated:
//     !(B[k-1] < A[j])), so ties go to A and +-0.0 compare equal.  A lane
//     whose conditions both hold has converged (the engine's step holds it
//     there) and stops early.  The cuts go to shared memory, and, when asked,
//     to the caller (jb/kb), so they can be held against co_rank_batch.  The
//     search is latency-bound: ~28 dependent rounds once per block.
//   * The cuts give tile r its exact windows A[j_lo, j_hi) and B[k_lo, k_hi),
//     which sum to S except on the ragged last tile, so every input element
//     is read from device memory once and every output element written once.
//   * Double buffering: while a block merges tile r out of one shared-memory
//     stage, the windows of tile r+1 are in flight into the other, as
//     16-byte cp.async copies of the 16-byte-aligned superset of each window
//     (the windows start anywhere; the superset reads at most 30 bytes more
//     per window, and every 16-byte block it reads holds an element of the
//     window, so it never leaves the window's pages).
//   * Each thread co-ranks its first output inside the tile with the Lemma-1
//     binary search in shared memory (the largest jj with A[jj-1] <= B[t-jj])
//     and emits kItems outputs with the two-finger rule of
//     repro_torch.core.engine.take_first (ties go to A: stability), keeping
//     both heads in registers.
//   * kItems is odd, so the warp's strided writes of the merged tile (thread
//     t at t*kItems + i) fall on distinct shared-memory banks; the tile then
//     leaves with 16-byte coalesced stores.
//
// Keys: int32, int64, float32, float64, float16 and bfloat16 (the 16-bit
// floats compared after an exact widening to float); NaN-free.  m + n is
// below 2^31 (the cuts are int32); global offsets are 64-bit.

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace {

using repro_tile::kItems;
using repro_tile::kThreads;
using repro_tile::kTile;
using repro_tile::ord;
using repro_tile::store_tile;

// Most tiles a block owns: their kMaxTiles + 1 boundaries' cuts are kept in
// shared memory (4 KiB), little enough that the cut table never costs a
// block of occupancy.
constexpr int kMaxTiles = 511;

// One stage holds the aligned supersets of both windows of a tile: S
// elements plus at most 2 * 30 bytes, rounded to 16.
template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return kTile * static_cast<int>(sizeof(T)) + 64;
}
// Two stages, the merged tile and the cut table (j, then k, of every
// boundary).
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * stage_bytes<T>() + kTile * static_cast<int>(sizeof(T)) +
         2 * (kMaxTiles + 1) * static_cast<int>(sizeof(int32_t));
}

__device__ __forceinline__ int64_t lmin(int64_t x, int64_t y) {
  return x < y ? x : y;
}
__device__ __forceinline__ int64_t lmax(int64_t x, int64_t y) {
  return x > y ? x : y;
}

// Algorithm 1: the co-ranks (j, k) of output rank i, in at most `rounds`
// rounds (prop1_bound(m, n); 0 when a side is empty, whose guess is exact).
template <typename T>
__device__ __forceinline__ void co_rank(const T* __restrict__ a,
                                        const T* __restrict__ b, int64_t m,
                                        int64_t n, int64_t i, int rounds,
                                        int64_t* jo, int64_t* ko) {
  int64_t j = i < m ? i : m;
  int64_t k = i - j;
  int64_t j_low = i - n > 0 ? i - n : 0;
  int64_t k_low = 0;
  for (int it = 0; it < rounds; ++it) {
    // The four boundary reads, clamped as the engine clamps them; the
    // guards below make an out-of-range read moot.
    const auto a_jm1 = ord(a[lmin(lmax(j - 1, 0), m - 1)]);
    const auto b_k = ord(b[lmin(k, n - 1)]);
    const auto b_km1 = ord(b[lmin(lmax(k - 1, 0), n - 1)]);
    const auto a_j = ord(a[lmin(j, m - 1)]);
    const bool fv = j > 0 && k < n && !(a_jm1 <= b_k);
    const bool sv = k > 0 && j < m && !(b_km1 < a_j);
    if (!fv && !sv) break;  // converged: the engine's step would hold
    if (fv) {
      const int64_t d = (j - j_low + 1) >> 1;
      k_low = k;
      j -= d;
      k += d;
    } else {
      const int64_t d = (k - k_low + 1) >> 1;
      j_low = j;
      j += d;
      k -= d;
    }
  }
  *jo = j;
  *ko = k;
}

struct Window {
  int64_t j_lo, j_hi, k_lo, k_hi;
};

// Windows that are not co-ranks of the tile bounds would read or stage out
// of bounds: fail the launch loudly instead.
__device__ __forceinline__ void check_window(const Window& x, int64_t r,
                                             int64_t m, int64_t n) {
  if (x.j_lo < 0 || x.k_lo < 0 || x.j_hi < x.j_lo || x.k_hi < x.k_lo ||
      x.j_hi > m || x.k_hi > n || (x.j_hi - x.j_lo) + (x.k_hi - x.k_lo) > kTile ||
      r * kTile + (x.j_hi - x.j_lo) + (x.k_hi - x.k_lo) > m + n) {
    __trap();
  }
}

// The 16-byte-aligned byte range [lo, hi) covering x[from, to); empty when
// the window is.
struct Span {
  uintptr_t lo, hi;
};

template <typename T>
__device__ __forceinline__ Span cover(const T* x, int64_t from, int64_t to) {
  if (from == to) return {0, 0};
  const uintptr_t lo = reinterpret_cast<uintptr_t>(x + from) & ~uintptr_t{15};
  const uintptr_t hi =
      (reinterpret_cast<uintptr_t>(x + to) + 15) & ~uintptr_t{15};
  return {lo, hi};
}

__device__ __forceinline__ void cp_async16(void* smem, uintptr_t gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one group of this thread's copies is in flight.
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Starts the copies of A's window, then B's, into `stage`.
template <typename T>
__device__ __forceinline__ void stage_window(const T* a, const T* b,
                                             const Window& x,
                                             unsigned char* stage) {
  const Span sa = cover(a, x.j_lo, x.j_hi);
  const Span sb = cover(b, x.k_lo, x.k_hi);
  const int na = static_cast<int>((sa.hi - sa.lo) >> 4);
  const int nb = static_cast<int>((sb.hi - sb.lo) >> 4);
  for (int i = threadIdx.x; i < na + nb; i += kThreads) {
    const uintptr_t g = i < na ? sa.lo + 16 * uintptr_t(i)
                               : sb.lo + 16 * uintptr_t(i - na);
    cp_async16(stage + 16 * i, g);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    merge_tile_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ out, int64_t m, int64_t n,
                      int64_t num_tiles, int per_block, int rounds,
                      int32_t* __restrict__ jb_out,
                      int32_t* __restrict__ kb_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* res = reinterpret_cast<T*>(smem + 2 * stage_bytes<T>());
  int32_t* cj = reinterpret_cast<int32_t*>(smem + 2 * stage_bytes<T>() +
                                           kTile * sizeof(T));
  int32_t* ck = cj + (kMaxTiles + 1);

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * per_block;
  if (r0 >= num_tiles) return;
  const int nt = static_cast<int>(lmin(per_block, num_tiles - r0));
  const int64_t total = m + n;

  // The co-ranks of the block's nt + 1 boundaries, one lane each.
  for (int l = threadIdx.x; l <= nt; l += kThreads) {
    const int64_t i = lmin((r0 + l) * kTile, total);
    int64_t j, k;
    co_rank(a, b, m, n, i, rounds, &j, &k);
    cj[l] = static_cast<int32_t>(j);
    ck[l] = static_cast<int32_t>(k);
    // A boundary shared with the next block is written by that block.
    if (jb_out != nullptr && (l < nt || r0 + nt == num_tiles)) {
      jb_out[r0 + l] = static_cast<int32_t>(j);
      kb_out[r0 + l] = static_cast<int32_t>(k);
    }
  }
  __syncthreads();
  auto window = [&](int t) {
    return Window{cj[t], cj[t + 1], ck[t], ck[t + 1]};
  };

  Window cur = window(0);
  check_window(cur, r0, m, n);
  stage_window(a, b, cur, smem);
  cp_async_commit();

  for (int t = 0; t < nt; ++t) {
    unsigned char* stage = smem + (t & 1) * stage_bytes<T>();
    // Start the next tile's copies into the other stage (free since the
    // barrier after the previous merge).
    Window nxt{};
    if (t + 1 < nt) {
      nxt = window(t + 1);
      check_window(nxt, r0 + t + 1, m, n);
      stage_window(a, b, nxt, smem + ((t + 1) & 1) * stage_bytes<T>());
    }
    cp_async_commit();
    cp_async_wait_all_but_one();  // this tile's copies have landed
    __syncthreads();

    const int la = static_cast<int>(cur.j_hi - cur.j_lo);
    const int lb = static_cast<int>(cur.k_hi - cur.k_lo);
    const int len = la + lb;  // == kTile except on the last tile
    const Span span_a = cover(a, cur.j_lo, cur.j_hi);
    const T* sa = reinterpret_cast<const T*>(
        stage + (reinterpret_cast<uintptr_t>(a + cur.j_lo) & 15));
    const T* sb = reinterpret_cast<const T*>(
        stage + (span_a.hi - span_a.lo) +
        (reinterpret_cast<uintptr_t>(b + cur.k_lo) & 15));

    const int t0 = threadIdx.x * kItems;
    if (t0 < len) {
      // Co-rank of local rank t0: the largest jj in [max(0, t0-lb),
      // min(t0, la)] whose first Lemma condition A[jj-1] <= B[t0-jj] holds
      // (an exhausted B window satisfies it).
      int lo = max(0, t0 - lb);
      int hi = min(t0, la);
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        const int kk = t0 - mid;
        if (kk >= lb || ord(sa[mid - 1]) <= ord(sb[kk])) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      int ja = lo;
      int kk = t0 - lo;
      T xa = ja < la ? sa[ja] : T();
      T xb = kk < lb ? sb[kk] : T();
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int p = t0 + i;
        if (p < len) {
          // take_first: A has elements left and (B exhausted or A <= B).
          const bool take_a = ja < la && (kk >= lb || ord(xa) <= ord(xb));
          res[p] = take_a ? xa : xb;
          ja += take_a;
          kk += !take_a;
          // The taken side's next head.  Past its window's end this reads
          // the stage's next bytes (B's window, or the stage's slack), which
          // are never compared.
          const T next = take_a ? sa[ja] : sb[kk];
          xa = take_a ? next : xa;
          xb = take_a ? xb : next;
        }
      }
    }
    __syncthreads();  // the tile is merged; its stage may be refilled

    store_tile(out + (r0 + t) * kTile, res, len);
    cur = nxt;
  }
}

// One launch's arguments, passed down the template dispatch below.
struct Args {
  const void* a;
  const void* b;
  void* out;
  int64_t m;
  int64_t n;
  int64_t num_tiles;
  void* jb;
  void* kb;
  cudaStream_t stream;
};

// How many blocks of merge_tile_kernel<T> the device holds at once.  Found
// once per instance and device, together with the opt-in to more than
// 48 KiB of shared memory, then read from the cache at every launch.
template <typename T>
cudaError_t resident_blocks(int device, int64_t* resident) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int64_t> cache[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  *resident = cache[device].load(std::memory_order_relaxed);
  if (*resident > 0) return cudaSuccess;
  auto* kernel = merge_tile_kernel<T>;
  constexpr int smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  *resident = static_cast<int64_t>(std::max(per_sm, 1)) * sms;
  cache[device].store(*resident, std::memory_order_relaxed);
  return cudaSuccess;
}

// Proposition 1's round bound ceil(log2 min(m, n)) + 1 (0 for an empty
// side): repro_torch.core.engine.prop1_bound.
int prop1_bound(int64_t m, int64_t n) {
  const int64_t mn = std::min(m, n);
  if (mn <= 0) return 0;
  int bits = 0;
  for (uint64_t v = static_cast<uint64_t>(mn - 1); v; v >>= 1) ++bits;
  return bits + 1;
}

template <typename T>
int launch(const Args& x) {
  auto* kernel = merge_tile_kernel<T>;
  constexpr int smem = smem_bytes<T>();
  int device = 0;
  int64_t resident = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = resident_blocks<T>(device, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Equal contiguous ranges, one a resident block, at most kMaxTiles each.
  const int64_t per = std::min<int64_t>((x.num_tiles + resident - 1) / resident,
                                        kMaxTiles);
  const int64_t grid = (x.num_tiles + per - 1) / per;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, x.stream>>>(
      static_cast<const T*>(x.a), static_cast<const T*>(x.b),
      static_cast<T*>(x.out), x.m, x.n, x.num_tiles, static_cast<int>(per),
      prop1_bound(x.m, x.n), static_cast<int32_t*>(x.jb),
      static_cast<int32_t*>(x.kb));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 int32, 1 float32, 2 bfloat16, 3 int64, 4 float64, 5 float16.
// a: (m,), b: (n,), out: (m+n,), m + n below 2^31, num_tiles =
// ceil((m+n)/tile) >= 1.  jb/kb: null, or int32 (num_tiles+1,) that receive
// the co-ranks the kernel found for the tile boundaries min(r*tile, m+n).
// Returns cudaGetLastError() after the launch, or -1 for an unsupported
// dtype, tile or size.
extern "C" int merge_tile_launch(int dtype, int tile, const void* a,
                                 const void* b, void* out, int64_t m,
                                 int64_t n, int64_t num_tiles, void* jb,
                                 void* kb, void* stream) {
  const Args x{a, b, out, m, n, num_tiles, jb, kb,
               static_cast<cudaStream_t>(stream)};
  if (tile != kTile || m < 0 || n < 0 || m + n >= (int64_t{1} << 31) ||
      num_tiles < 1 || num_tiles != (m + n + kTile - 1) / kTile ||
      (jb == nullptr) != (kb == nullptr)) {
    return -1;
  }
  switch (dtype) {
    case 0:
      return launch<int32_t>(x);
    case 1:
      return launch<float>(x);
    case 2:
      return launch<__nv_bfloat16>(x);
    case 3:
      return launch<int64_t>(x);
    case 4:
      return launch<double>(x);
    case 5:
      return launch<__half>(x);
    default:
      return -1;
  }
}
