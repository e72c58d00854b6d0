// merge_tile.cu — one output tile of the stable merge of two sorted arrays.
//
// Replaces the TPU kernel merge_tile_kernel (src/repro/kernels/merge.py:57),
// launched by merge_pallas (merge.py:139, pl.pallas_call at :191).
//
// What bounds it on an H100: bytes.  The merge reads m+n elements and writes
// m+n elements, (m+n)*sizeof(T) each way, and does O(log S) comparisons per
// element — far below the ~300 operations per byte at which the card stops
// being memory-bound.
//
// What the design does about that bound: every input element is read from
// device memory once and every output element written once, both as
// contiguous runs of neighbouring addresses (coalesced).  Phase 1 (the
// co-rank of every tile boundary r*S, computed by the caller in torch ops)
// gives each block its exact windows A[j_lo, j_hi) and B[k_lo, k_hi), with
// (j_hi - j_lo) + (k_hi - k_lo) == S except on the ragged last tile, so a
// block stages exactly the S elements it merges and no more.  All
// searching happens in shared memory:
//   * each thread co-ranks its first output rank inside the tile with the
//     Lemma-1 binary search (the largest jj with A[jj-1] <= B[t-jj]),
//   * then emits its kItems outputs with the two-finger rule of
//     repro_torch.core.engine.take_first (ties go to A: stability),
//   * outputs collect in shared memory and leave with coalesced stores.
// The ragged last tile is masked in the kernel; nothing is padded.
//
// Keys: int32, int64, float32, float64, float16 and bfloat16 (the 16-bit
// floats compared after an exact widening to float).  Global offsets are
// 64-bit.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;  // output elements per block
constexpr int kItems = 4;    // outputs per thread
constexpr int kThreads = kTile / kItems;

template <typename T>
__device__ __forceinline__ T ord(T v) {
  return v;
}

__device__ __forceinline__ float ord(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float ord(__half v) { return __half2float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    merge_tile_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const int32_t* __restrict__ jb,
                      const int32_t* __restrict__ kb, T* __restrict__ out,
                      int64_t m, int64_t n) {
  // Raw storage: shared variables take no constructors (the 16-bit
  // floats have one).
  __shared__ __align__(16) unsigned char smem[2 * kTile * sizeof(T)];
  T* win = reinterpret_cast<T*>(smem);  // A's window, then B's window
  T* res = win + kTile;                 // the merged tile

  const int64_t r = blockIdx.x;
  const int64_t j_lo = jb[r];
  const int64_t j_hi = jb[r + 1];
  const int64_t k_lo = kb[r];
  const int64_t k_hi = kb[r + 1];
  // Windows that are not co-ranks of the tile bounds would read or stage
  // out of bounds: fail the launch loudly instead.
  if (j_lo < 0 || k_lo < 0 || j_hi < j_lo || k_hi < k_lo || j_hi > m ||
      k_hi > n || (j_hi - j_lo) + (k_hi - k_lo) > kTile ||
      r * kTile + (j_hi - j_lo) + (k_hi - k_lo) > m + n) {
    __trap();
  }
  const int la = static_cast<int>(j_hi - j_lo);
  const int lb = static_cast<int>(k_hi - k_lo);
  const int len = la + lb;  // == kTile except on the last tile

  for (int i = threadIdx.x; i < len; i += kThreads) {
    win[i] = i < la ? a[j_lo + i] : b[k_lo + (i - la)];
  }
  __syncthreads();

  const T* sa = win;
  const T* sb = win + la;
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
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int t = t0 + it;
      if (t < len) {
        // take_first: A has elements left and (B exhausted or A <= B).
        const bool take_a = ja < la && (kk >= lb || ord(sa[ja]) <= ord(sb[kk]));
        res[t] = take_a ? sa[ja++] : sb[kk++];
      }
    }
  }
  __syncthreads();

  T* dst = out + r * kTile;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    dst[i] = res[i];
  }
}

// One launch's arguments, passed down the template dispatch below.
struct Args {
  const void* a;
  const void* b;
  const void* jb;
  const void* kb;
  void* out;
  int64_t m;
  int64_t n;
  int64_t num_tiles;
  cudaStream_t stream;
};

template <typename T>
int launch(const Args& x) {
  merge_tile_kernel<T>
      <<<static_cast<unsigned>(x.num_tiles), kThreads, 0, x.stream>>>(
          static_cast<const T*>(x.a), static_cast<const T*>(x.b),
          static_cast<const int32_t*>(x.jb), static_cast<const int32_t*>(x.kb),
          static_cast<T*>(x.out), x.m, x.n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 int32, 1 float32, 2 bfloat16, 3 int64, 4 float64, 5 float16.
// a: (m,), b: (n,), out: (m+n,); jb/kb: (num_tiles+1,) int32 co-ranks of
// the tile boundaries min(r*tile, m+n).  Returns cudaGetLastError() after
// the launch, or -1 for an unsupported dtype or tile.
extern "C" int merge_tile_launch(int dtype, int tile, const void* a,
                                 const void* b, const void* jb,
                                 const void* kb, void* out, int64_t m,
                                 int64_t n, int64_t num_tiles, void* stream) {
  const Args x{a, b, jb, kb, out, m, n, num_tiles,
               static_cast<cudaStream_t>(stream)};
  if (tile != kTile) return -1;
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
