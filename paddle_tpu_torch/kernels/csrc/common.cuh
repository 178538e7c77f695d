// Shared device helpers for the hand-written kernels of paddle_tpu_torch.
// Reductions run in a fixed order (butterfly over the warp, then warp 0
// over the per-warp partials), so a kernel's result is a pure function of
// its inputs: no atomics, no launch-shape-dependent split.
#pragma once

#include <cuda_runtime.h>

namespace ptt {

constexpr float kNegInf = -1e30f;  // the reference kernels' NEG_INF mask
constexpr float kLog2e = 1.4426950408889634f;

// component e of a float4
__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// over the 4 lanes of a quad (an mma.sync fragment row's lanes)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Block-wide sum broadcast to every thread.  `red` is shared scratch of at
// least 33 floats; blockDim.x must be a multiple of 32 (at most 1024).
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // an earlier call's readers are done with red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

}  // namespace ptt
