// common.cuh — what the two tile kernels (merge_tile.cu, merge_kway_tile.cu)
// share: the block shape, the key order and the tile store.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace repro_tile {

constexpr int kThreads = 256;
constexpr int kItems = 15;                // outputs per thread (odd)
constexpr int kTile = kThreads * kItems;  // outputs per tile: 3840

// The order keys are compared in: as they are, or the 16-bit floats after an
// exact widening to float.
template <typename T>
__device__ __forceinline__ T ord(T v) {
  return v;
}
__device__ __forceinline__ float ord(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float ord(__half v) { return __half2float(v); }

// Copies src[0, len) to dst with 16-byte coalesced stores, and the last
// len % (16 / sizeof(T)) elements one by one.  dst is 16-byte aligned: the
// output is a fresh allocation and every tile starts at r * kTile elements,
// a multiple of 16 bytes.
template <typename T>
__device__ __forceinline__ void store_tile(T* dst, const T* src, int len) {
  constexpr int kVec = 16 / sizeof(T);
  const int nv = len / kVec;
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  }
  for (int i = nv * kVec + threadIdx.x; i < len; i += kThreads) {
    dst[i] = src[i];
  }
}

}  // namespace repro_tile
