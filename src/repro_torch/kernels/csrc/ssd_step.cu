// ssd_step.cu — one token of the Mamba2 SSD recurrence for every (row,
// head), writing the float32 state in place and returning y.
//
// Replaces no TPU kernel.  The reference runs a decode step as ssd_chunked
// at s = chunk = 1 in XLA ops (src/repro/models/ssm.py); the port's plain
// version is repro_torch.models.ssm.ssd_step followed by a copy_ of its new
// state into the cache.  That chain makes nine passes over the state S (the
// decay product, the outer product, the add, the einsum for y and the
// copy back read 5S and write 4S) and about twenty launches a layer.
//
// What bounds it on an H100: bytes.  Per (row, head) it reads and writes
// headdim x d_state float32 state values and does about five flops on each,
// far below the ~300 operations per byte at which the card stops being
// memory-bound.  The least traffic is 2S: the state read once and written
// once (x, dt, B, C and y are a few bytes per state row).
//
// What the design does about that bound.
//   * One block per (row, head) owns that head's (headdim, d_state) tile of
//     the state; blocks are independent, so nothing carries between them.
//   * Lanes run along d_state: a segment of `lanes` lanes (a power of two,
//     at most 32) holds one state row, each lane one or two float4 chunks of
//     it, so a warp's loads and stores are 16 bytes a lane on consecutive
//     addresses.  B and C for the lane's chunks are loaded once into
//     registers and serve every row the lane visits.
//   * Each thread issues the loads of kUnroll rows before it computes and
//     stores any of them, so enough bytes are in flight to cover the
//     latency of device memory.
//   * The state is read with __ldcs and written with __stcs (evict-first):
//     one layer's state is far larger than the 50 MB L2 and a step never
//     reads it again.
//   * Each block computes its own scalars in float32: a = -exp(A_log[h]),
//     dA = exp(dt * a), dt * x.  h' = dA * h + (dt * x) * B is built with
//     __fmul_rn/__fadd_rn, which nvcc may not contract into an FMA, so the
//     state equals the plain version's (three separately rounded ops) bit
//     for bit.
//   * y[p] = sum_n C[n] * h'[p, n] in float32, reduced by warp shuffles
//     inside the segment, then cast to x's dtype; the D skip follows the
//     plain version's casts: D * x in float32, cast to x's dtype, then
//     added (a bf16 add in a bf16 run).
//
// Inputs: x (batch, nheads, headdim) and B, C (batch, ngroups, d_state) in
// float32 or bfloat16, contiguous but for their row stride; dt (batch,
// nheads) float32 with a row stride; A_log, D (nheads,) float32; the state
// (batch, nheads, headdim, d_state) float32, contiguous and 16-byte
// aligned; d_state a multiple of 4 up to 256; ngroups divides nheads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;
constexpr int kMaxState = 256;

struct Args {
  const void* x;
  int64_t x_row;
  const float* dt;
  int64_t dt_row;
  const void* b;
  int64_t b_row;
  const void* c;
  int64_t c_row;
  const float* a_log;
  const float* d_skip;
  float* state;
  void* y;
  int nheads, headdim, d_state, ngroups, lanes;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// y + D * x in x's dtype, with the plain version's casts.
__device__ __forceinline__ float finish(float y, float x, float d, float*) {
  return __fadd_rn(y, __fmul_rn(d, x));
}
__device__ __forceinline__ __nv_bfloat16 finish(float y, float x, float d,
                                                __nv_bfloat16*) {
  const float yb = __bfloat162float(__float2bfloat16_rn(y));
  const float skip = __bfloat162float(__float2bfloat16_rn(__fmul_rn(d, x)));
  return __float2bfloat16_rn(__fadd_rn(yb, skip));
}

__device__ __forceinline__ float4 update(float4 h, float decay, float dtx,
                                         const float* bq) {
  float4 o;
  o.x = __fadd_rn(__fmul_rn(h.x, decay), __fmul_rn(dtx, bq[0]));
  o.y = __fadd_rn(__fmul_rn(h.y, decay), __fmul_rn(dtx, bq[1]));
  o.z = __fadd_rn(__fmul_rn(h.z, decay), __fmul_rn(dtx, bq[2]));
  o.w = __fadd_rn(__fmul_rn(h.w, decay), __fmul_rn(dtx, bq[3]));
  return o;
}

// kPerLane: float4 chunks of a state row a lane holds (1 up to d_state 128
// with 32 lanes, 2 above).
template <typename T, int kPerLane>
__global__ void __launch_bounds__(kThreads) ssd_step_kernel(Args a) {
  const int64_t bh = blockIdx.x;  // row * nheads + head
  const int64_t row = bh / a.nheads;
  const int head = static_cast<int>(bh % a.nheads);
  const int grp = head / (a.nheads / a.ngroups);

  const float rate = -expf(a.a_log[head]);
  const float dt = a.dt[row * a.dt_row + head];
  const float decay = expf(__fmul_rn(dt, rate));
  const float d = a.d_skip[head];

  const int chunks = a.d_state >> 2;
  const int lanes = a.lanes;
  const int lane = threadIdx.x & 31;
  const int li = lane & (lanes - 1);
  const int per_warp = 32 / lanes;
  const int per_pass = per_warp * (kThreads / 32);
  const int mine = (threadIdx.x >> 5) * per_warp + lane / lanes;

  const T* bp = static_cast<const T*>(a.b) + row * a.b_row +
                static_cast<int64_t>(grp) * a.d_state;
  const T* cp = static_cast<const T*>(a.c) + row * a.c_row +
                static_cast<int64_t>(grp) * a.d_state;
  float bq[kPerLane][4], cq[kPerLane][4];
  bool has[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int q = li + k * lanes;
    has[k] = q < chunks;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bq[k][j] = has[k] ? to_f32(bp[4 * q + j]) : 0.0f;
      cq[k][j] = has[k] ? to_f32(cp[4 * q + j]) : 0.0f;
    }
  }

  const T* xp = static_cast<const T*>(a.x) + row * a.x_row +
                static_cast<int64_t>(head) * a.headdim;
  float4* sp = reinterpret_cast<float4*>(a.state + bh * a.headdim * a.d_state);
  T* yp = static_cast<T*>(a.y) + bh * a.headdim;

  // The loop bounds are the same for every thread of the block, so the
  // shuffles below run on full warps; `p < headdim` guards memory only.
  for (int base = 0; base < a.headdim; base += per_pass * kUnroll) {
    float4 h[kUnroll][kPerLane];
    float xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * per_pass + mine;
      xv[u] = 0.0f;
      if (p < a.headdim) {
        xv[u] = to_f32(xp[p]);
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          if (has[k]) h[u][k] = __ldcs(sp + p * chunks + li + k * lanes);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = base + u * per_pass + mine;
      float acc = 0.0f;
      if (p < a.headdim) {
        const float dtx = __fmul_rn(xv[u], dt);
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          if (has[k]) {
            const float4 o = update(h[u][k], decay, dtx, bq[k]);
            __stcs(sp + p * chunks + li + k * lanes, o);
            acc = fmaf(cq[k][0], o.x, acc);
            acc = fmaf(cq[k][1], o.y, acc);
            acc = fmaf(cq[k][2], o.z, acc);
            acc = fmaf(cq[k][3], o.w, acc);
          }
        }
      }
      for (int off = lanes >> 1; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (li == 0 && p < a.headdim) {
        yp[p] = finish(acc, xv[u], d, static_cast<T*>(nullptr));
      }
    }
  }
}

template <typename T>
int launch(const Args& a, int64_t blocks, cudaStream_t stream) {
  if (a.d_state / 4 <= 32) {
    ssd_step_kernel<T, 1><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(a);
  } else {
    ssd_step_kernel<T, 2><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype of x, B, C and y: 0 float32, 1 bfloat16.  Row strides are in
// elements.  Returns cudaGetLastError() after the launch (0 with nothing to
// launch), or -1 for arguments the kernel does not take.
extern "C" int ssd_step_launch(int dtype, const void* x, int64_t x_row,
                               const void* dt, int64_t dt_row, const void* b,
                               int64_t b_row, const void* c, int64_t c_row,
                               const void* a_log, const void* d_skip,
                               void* state, void* y, int64_t batch,
                               int nheads, int headdim, int d_state,
                               int ngroups, void* stream) {
  if (batch < 0 || nheads < 1 || headdim < 1 || ngroups < 1 ||
      nheads % ngroups || d_state < 4 || d_state > kMaxState ||
      d_state % 4 || batch * nheads >= (int64_t{1} << 31) ||
      reinterpret_cast<uintptr_t>(state) % 16) {
    return -1;
  }
  if (batch == 0) return 0;
  int lanes = 1;
  while (lanes < 32 && lanes * (d_state / 4 <= 32 ? 1 : 2) < d_state / 4) {
    lanes <<= 1;
  }
  const Args a{x,
               x_row,
               static_cast<const float*>(dt),
               dt_row,
               b,
               b_row,
               c,
               c_row,
               static_cast<const float*>(a_log),
               static_cast<const float*>(d_skip),
               static_cast<float*>(state),
               y,
               nheads,
               headdim,
               d_state,
               ngroups,
               lanes};
  const int64_t blocks = batch * nheads;
  auto* s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(a, blocks, s);
    case 1:
      return launch<__nv_bfloat16>(a, blocks, s);
    default:
      return -1;
  }
}
