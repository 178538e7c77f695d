// The forms that paddle_tpu_torch/kernels/csrc/add_layer_norm.cu and
// softmax_xent.cu replaced, kept to be timed beside them in the same call
// (scripts/row_kernels_check.py builds this file with -I
// paddle_tpu_torch/kernels/csrc into a library of its own; chip_smoke.py's
// kernel phase times them):
//
// - fused_add_layer_norm's block form: one 256-thread block a row, the row
//   sum s kept in H floats of dynamic shared memory, the mean and the
//   variance each a block reduction with its barriers.  It took any H to
//   12288 floats but never raised the 48 KB default limit beside its
//   static scratch, so H 12256-12288 failed at launch;
// - fused_softmax_xent's two forms as they ran (the entry points below
//   dispatch as the kernels did): one warp a row with 32 value slots a
//   lane for C <= 1024, and for every C > 1024 one block of 256 threads a
//   row, an online max / rescaled sum over each thread's strided columns
//   by 4-byte loads, merged over the block, the backward reading the row a
//   second time to write dx.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpRows = 8;     // rows a block in the warp form
constexpr int kMaxPerLane = 32;  // C <= 32 * 32 in the warp form

__global__ void __launch_bounds__(kThreads) add_ln_block(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float* __restrict__ s_out, float* __restrict__ o_out,
    float* __restrict__ mean_out, float* __restrict__ var_out, int H,
    float eps) {
  extern __shared__ float srow[];  // H floats
  __shared__ float red[33];
  const long base = static_cast<long>(blockIdx.x) * H;
  float acc = 0.f;
  for (int j = threadIdx.x; j < H; j += kThreads) {
    const float s = x[base + j] + y[base + j];
    srow[j] = s;
    s_out[base + j] = s;
    acc += s;
  }
  const float mean = ptt::block_sum(acc, red) / static_cast<float>(H);
  float acc2 = 0.f;
  for (int j = threadIdx.x; j < H; j += kThreads) {
    const float d = srow[j] - mean;
    acc2 = fmaf(d, d, acc2);
  }
  const float var = ptt::block_sum(acc2, red) / static_cast<float>(H);
  if (threadIdx.x == 0) {
    mean_out[blockIdx.x] = mean;
    var_out[blockIdx.x] = var;
  }
  const float inv = 1.f / sqrtf(var + eps);
  for (int j = threadIdx.x; j < H; j += kThreads) {
    o_out[base + j] = (srow[j] - mean) * inv * gamma[j] + beta[j];
  }
}

__device__ __forceinline__ float gold_of(const float* __restrict__ row,
                                         long long label, int C) {
  return (label >= 0 && label < C) ? row[label] : 0.f;
}

__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  s = (s == 0.f ? 0.f : s * expf(m - mx)) + (s2 == 0.f ? 0.f : s2 * expf(m2 - mx));
  m = mx;
}

__device__ __forceinline__ void warp_merge(float& m, float& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
}

__device__ __forceinline__ void row_stats(const float* __restrict__ row, int C,
                                          float* red, float& m, float& s) {
  m = -INFINITY;
  s = 0.f;
  for (int j = threadIdx.x; j < C; j += kThreads) {
    const float v = row[j];
    if (v > m) {
      s = (s == 0.f ? 0.f : s * expf(m - v)) + 1.f;
      m = v;
    } else {
      s += expf(v - m);
    }
  }
  warp_merge(m, s);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[warp] = m;
    red[32 + warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    float mw = lane < kThreads / 32 ? red[lane] : -INFINITY;
    float sw = lane < kThreads / 32 ? red[32 + lane] : 0.f;
    warp_merge(mw, sw);
    if (lane == 0) {
      red[64] = mw;
      red[65] = sw;
    }
  }
  __syncthreads();
  m = red[64];
  s = red[65];
}

__global__ void __launch_bounds__(kThreads) sxent_fwd_row(
    const float* __restrict__ x, const long long* __restrict__ labels,
    float* __restrict__ loss, int C) {
  __shared__ float red[66];
  const int r = blockIdx.x;
  const float* row = x + static_cast<long>(r) * C;
  float m, s;
  row_stats(row, C, red, m, s);
  if (threadIdx.x == 0) loss[r] = (logf(s) + m) - gold_of(row, labels[r], C);
}

__global__ void __launch_bounds__(kThreads) sxent_bwd_row(
    const float* __restrict__ x, const long long* __restrict__ labels,
    const float* __restrict__ dy, float* __restrict__ dx, int C) {
  __shared__ float red[66];
  const int r = blockIdx.x;
  const long base = static_cast<long>(r) * C;
  float m, s;
  row_stats(x + base, C, red, m, s);
  const long long label = labels[r];
  const float g = dy[r];
  for (int j = threadIdx.x; j < C; j += kThreads) {
    const float p = expf(x[base + j] - m) / s;
    dx[base + j] = (p - (j == label ? 1.f : 0.f)) * g;
  }
}

// The warp form: lane `lane` holds columns lane, lane + 32, ...; columns
// past C hold -inf and take no part.
__device__ __forceinline__ void warp_row(const float* __restrict__ row, int C,
                                         int lane, float (&v)[kMaxPerLane],
                                         float& m, float& s) {
  m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int j = lane + 32 * i;
    v[i] = j < C ? row[j] : -INFINITY;
    m = fmaxf(m, v[i]);
  }
  m = ptt::warp_max(m);
  s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    if (lane + 32 * i < C) s += expf(v[i] - m);
  }
  s = ptt::warp_sum(s);
}

__global__ void __launch_bounds__(kWarpRows * 32) sxent_fwd_warp(
    const float* __restrict__ x, const long long* __restrict__ labels,
    float* __restrict__ loss, int R, int C) {
  const int r = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (r >= R) return;  // the whole warp leaves; no block barrier follows
  const int lane = threadIdx.x & 31;
  const float* row = x + static_cast<long>(r) * C;
  float v[kMaxPerLane];
  float m, s;
  warp_row(row, C, lane, v, m, s);
  if (lane == 0) loss[r] = (logf(s) + m) - gold_of(row, labels[r], C);
}

__global__ void __launch_bounds__(kWarpRows * 32) sxent_bwd_warp(
    const float* __restrict__ x, const long long* __restrict__ labels,
    const float* __restrict__ dy, float* __restrict__ dx, int R, int C) {
  const int r = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (r >= R) return;
  const int lane = threadIdx.x & 31;
  const long base = static_cast<long>(r) * C;
  float v[kMaxPerLane];
  float m, s;
  warp_row(x + base, C, lane, v, m, s);
  const long long label = labels[r];
  const float g = dy[r];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int j = lane + 32 * i;
    if (j < C) {
      const float p = expf(v[i] - m) / s;
      dx[base + j] = (p - (j == label ? 1.f : 0.f)) * g;
    }
  }
}

}  // namespace

extern "C" int ptt_before_add_layer_norm(const float* x, const float* y, const float* gamma,
                                         const float* beta, float* s_out, float* o_out,
                                         float* mean_out, float* var_out, int R, int H,
                                         float eps, cudaStream_t stream) {
  if (R == 0 || H == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(H) * sizeof(float);
  add_ln_block<<<R, kThreads, smem, stream>>>(x, y, gamma, beta, s_out, o_out, mean_out,
                                              var_out, H, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptt_before_softmax_xent_fwd(const float* x, const long long* labels,
                                           float* loss, int R, int C, cudaStream_t stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  if (C <= 32 * kMaxPerLane)
    sxent_fwd_warp<<<(R + kWarpRows - 1) / kWarpRows, kWarpRows * 32, 0, stream>>>(
        x, labels, loss, R, C);
  else
    sxent_fwd_row<<<R, kThreads, 0, stream>>>(x, labels, loss, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptt_before_softmax_xent_bwd(const float* x, const long long* labels,
                                           const float* dy, float* dx, int R, int C,
                                           cudaStream_t stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  if (C <= 32 * kMaxPerLane)
    sxent_bwd_warp<<<(R + kWarpRows - 1) / kWarpRows, kWarpRows * 32, 0, stream>>>(
        x, labels, dy, dx, R, C);
  else
    sxent_bwd_row<<<R, kThreads, 0, stream>>>(x, labels, dy, dx, C);
  return static_cast<int>(cudaGetLastError());
}
