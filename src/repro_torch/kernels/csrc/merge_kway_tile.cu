// merge_kway_tile.cu — one output tile of the stable k-way merge of k
// sorted runs, optionally carrying a payload.
//
// Replaces the TPU kernel merge_kway_tile_kernel and its helper
// _lane_count_search (src/repro/kernels/merge.py:208-326), launched by
// merge_kway_pallas (merge.py:332, pl.pallas_call at :430).
//
// What bounds it on an H100: bytes.  A merge of k runs of width w reads
// k*w*(sizeof(key)+sizeof(val)) bytes and writes as many, and needs only
// about log2(k) comparisons per element.  This first design does more:
// k-1 binary searches of up to log2(S)+1 steps per element in shared
// memory, so at k = 16 those searches, not the bytes, set its time
// (PERF.md); a merge tree inside the tile would cut them to log2(k)
// merge-path steps.
//
// What the design does about that bound: phase 1 (the multi-way co-rank
// of every tile boundary r*S, computed by the caller in torch ops, clamped
// at the real run lengths) gives each block its segment [cb[r,q],
// cb[r+1,q]) of every run q; the segments sum to S (less on the ragged
// last tile).  A block stages exactly those elements — each run's segment
// a contiguous, coalesced read — so every input byte crosses device memory
// once.  Inside the tile:
//   * staged element (q, u) gets its tile-local merged rank
//     u + sum_{q' != q} count_below(segment q', x, ties = q' < q)
//     by binary search in shared memory (the run-index tie-break of
//     repro_torch.core.engine.lemma1_counts: stability);
//   * after one barrier every thread scatters its keys (and payload) to
//     shared memory at their ranks — the ranks are a bijection onto the
//     tile, so no two threads write one slot;
//   * the merged tile leaves with coalesced stores.
// This is the scatter form of kway_positions / merge_kway_ranked; the TPU
// kernel used the gather form only because it has no scatter.
//
// The ragged "lengths" form needs nothing here: phase 1 clamps the cuts at
// the lengths, so padding is never staged and real dtype-max keys never
// meet sentinels.  Output positions past the real total are not written.
//
// The run count k is a launch argument (any k >= 1): the segment table,
// 2k+1 ints, lives in dynamic shared memory.  Keys are int32, int64,
// float32, float64, float16 or bfloat16 (the 16-bit floats compared after
// an exact widening to float); the payload is copied as raw 4- or 8-byte
// words, so any dtype of that width rides along.  Global offsets are
// 64-bit.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 2048;  // output elements per block
constexpr int kThreads = 256;
constexpr int kItems = kTile / kThreads;

template <typename T>
__device__ __forceinline__ T ord(T v) {
  return v;
}
__device__ __forceinline__ float ord(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float ord(__half v) { return __half2float(v); }

// |{ y in seg[0, n) : y <= x }| (ties) or |{ y : y < x }| (strict) — the
// engine's count_below pair, as a lower-bound search over a sorted segment.
template <typename Key>
__device__ __forceinline__ int count_below(const Key* seg, int n, Key x,
                                           bool ties) {
  const auto ox = ord(x);
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    const auto y = ord(seg[lo + half]);
    if (ties ? (y <= ox) : (y < ox)) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// Val is the payload word (uint32_t or uint64_t); HAS_VALS false ignores it.
template <typename Key, typename Val, bool HAS_VALS>
__global__ void __launch_bounds__(kThreads)
    merge_kway_tile_kernel(const Key* __restrict__ runs,
                           const Val* __restrict__ vals, int k, int64_t w,
                           const int32_t* __restrict__ cb,
                           Key* __restrict__ out_k, Val* __restrict__ out_v,
                           int64_t out_len) {
  // Raw storage: shared variables take no constructors (the 16-bit floats
  // have one).
  __shared__ __align__(16) unsigned char smem_k[kTile * sizeof(Key)];
  __shared__ __align__(16) unsigned char smem_v[HAS_VALS ? kTile * sizeof(Val)
                                                         : 1];
  extern __shared__ int seg[];  // 2k+1 ints
  Key* sk = reinterpret_cast<Key*>(smem_k);
  Val* sv = reinterpret_cast<Val*>(smem_v);
  int* s_start = seg;      // segment q is sk[s_start[q], s_start[q+1])
  int* s_lo = seg + k + 1;  // its first element in run q

  const int64_t r = blockIdx.x;
  const int32_t* lo_row = cb + r * k;
  const int32_t* hi_row = lo_row + k;
  for (int q = threadIdx.x; q < k; q += kThreads) {
    const int lo = lo_row[q];
    const int hi = hi_row[q];
    // Cuts that are not co-ranks of the tile bounds would read or stage
    // out of bounds: fail the launch loudly instead.
    if (lo < 0 || hi < lo || hi > w || hi - lo > kTile) __trap();
    s_lo[q] = lo;
    s_start[q + 1] = hi - lo;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int off = 0;
    s_start[0] = 0;
    for (int q = 1; q <= k; ++q) {
      off += s_start[q];
      if (off > kTile) __trap();
      s_start[q] = off;
    }
    if (r * kTile + off > out_len) __trap();
  }
  __syncthreads();
  const int len = s_start[k];

  // Stage every run's segment: one contiguous read per run.
  for (int q = 0; q < k; ++q) {
    const int base = s_start[q];
    const int n = s_start[q + 1] - base;
    const int64_t src = q * w + s_lo[q];
    for (int u = threadIdx.x; u < n; u += kThreads) {
      sk[base + u] = runs[src + u];
      if constexpr (HAS_VALS) sv[base + u] = vals[src + u];
    }
  }
  __syncthreads();

  Key x[kItems];
  Val v[kItems];
  int rank[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = threadIdx.x + it * kThreads;
    rank[it] = -1;
    if (i < len) {
      // The run whose segment holds staged slot i: the last q with
      // s_start[q] <= i (empty segments repeat a start).
      int q = 0;
      int hi = k - 1;
      while (q < hi) {
        const int mid = (q + hi + 1) >> 1;
        if (s_start[mid] <= i) {
          q = mid;
        } else {
          hi = mid - 1;
        }
      }
      const Key xi = sk[i];
      int rk = i - s_start[q];
      for (int p = 0; p < k; ++p) {
        if (p != q) {
          rk += count_below(sk + s_start[p], s_start[p + 1] - s_start[p], xi,
                            p < q);
        }
      }
      x[it] = xi;
      if constexpr (HAS_VALS) v[it] = sv[i];
      rank[it] = rk;
    }
  }
  __syncthreads();  // every search has read the staged tile

#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (rank[it] >= 0) {
      sk[rank[it]] = x[it];
      if constexpr (HAS_VALS) sv[rank[it]] = v[it];
    }
  }
  __syncthreads();

  Key* dk = out_k + r * kTile;
  for (int i = threadIdx.x; i < len; i += kThreads) dk[i] = sk[i];
  if constexpr (HAS_VALS) {
    Val* dv = out_v + r * kTile;
    for (int i = threadIdx.x; i < len; i += kThreads) dv[i] = sv[i];
  }
}

// One launch's arguments, passed down the template dispatch below.
struct Args {
  const void* runs;
  const void* vals;
  int k;
  int64_t w;
  const void* cb;
  void* out_k;
  void* out_v;
  int64_t out_len;
  int64_t num_tiles;
  cudaStream_t stream;
};

template <typename Key, typename Val, bool HAS_VALS>
int launch(const Args& a) {
  auto* kernel = merge_kway_tile_kernel<Key, Val, HAS_VALS>;
  const size_t dyn = (2 * static_cast<size_t>(a.k) + 1) * sizeof(int);
  // Above 48 KiB in all, a block must opt in to more shared memory.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(a.num_tiles), kThreads, dyn, a.stream>>>(
      static_cast<const Key*>(a.runs), static_cast<const Val*>(a.vals), a.k,
      a.w, static_cast<const int32_t*>(a.cb), static_cast<Key*>(a.out_k),
      static_cast<Val*>(a.out_v), a.out_len);
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
  const Args a{runs,  vals,    k,       w,         cb,
               out_k, out_v,   out_len, num_tiles, static_cast<cudaStream_t>(stream)};
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
