// fused_softmax_xent: per-row softmax cross entropy over [R, C] float32
// logits and int64 hard labels, forward and backward.
//
//   loss_r = lse_r - gold_r,   lse_r = log(sum_c exp(x[r, c] - m_r)) + m_r,
//   gold_r = x[r, y_r] for 0 <= y_r < C, else 0 (the reference's iota
//   compare finds no column), so an out-of-range label's loss is the lse;
//   dx[r, c] = (exp(x[r, c] - m_r) / s_r - [c == y_r]) * dy_r.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py fused_softmax_xent, the
// forward _sxent_fwd_call (kernel body _sxent_kernel) and the backward
// _sxent_bwd_call (kernel body _sxent_bwd_kernel).
//
// Bound on the card: memory.  The forward reads the logits (4 R C bytes)
// and the labels (8 R) and writes the loss (4 R); the backward reads the
// logits, labels and dy (4 R C + 12 R) and writes dx (4 R C).  About 4 R C
// flops against that, far below the card's ratio.
//
// Design: the TPU kernel walks row blocks in order; here every row is
// independent, so the grid covers the rows and nothing carries between
// blocks.
//   * C <= 1024: one warp per row, 8 rows a block.  Each lane keeps its
//     strided share of the row (at most 32 values) in registers, so the
//     backward, like the forward, reads the logits once: max, then the
//     sum of exp(x - max), each a warp butterfly.
//   * C > 1024: one block of 256 threads per row.  Each thread runs an
//     online max / rescaled sum over its strided columns (one read of the
//     row), then the (max, sum) pairs are merged by a warp butterfly and
//     warp 0 over the per-warp pairs.  The backward reads the row a second
//     time to write dx.
// Every merge is commutative and its tree depends only on C, never on R
// or the launch, so a row's result is a pure function of that row: no
// atomics, two runs are bit-equal.  The backward recomputes max and sum
// from the logits, as _sxent_bwd_kernel does; there is no lse residual.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kWarpRows = 8;       // rows a block in the warp form
constexpr int kMaxPerLane = 32;    // C <= 32 * 32 in the warp form
constexpr int kRowThreads = 256;   // threads a block in the row form

__device__ __forceinline__ float gold_of(const float* __restrict__ row,
                                         long long label, int C) {
  return (label >= 0 && label < C) ? row[label] : 0.f;
}

// (m, s) merge of two online-softmax partials: commutative bit for bit.
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

// Row max and sum of exp(x - max) over one row in the row form, broadcast
// to every thread.  `red` is shared scratch of 2 * 32 + 2 floats.
__device__ __forceinline__ void row_stats(const float* __restrict__ row, int C,
                                          float* red, float& m, float& s) {
  m = -INFINITY;
  s = 0.f;
  for (int j = threadIdx.x; j < C; j += kRowThreads) {
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
    float mw = lane < kRowThreads / 32 ? red[lane] : -INFINITY;
    float sw = lane < kRowThreads / 32 ? red[32 + lane] : 0.f;
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

__global__ void __launch_bounds__(kRowThreads) sxent_fwd_row(
    const float* __restrict__ x, const long long* __restrict__ labels,
    float* __restrict__ loss, int C) {
  __shared__ float red[66];
  const int r = blockIdx.x;
  const float* row = x + static_cast<long>(r) * C;
  float m, s;
  row_stats(row, C, red, m, s);
  if (threadIdx.x == 0) loss[r] = (logf(s) + m) - gold_of(row, labels[r], C);
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

__global__ void __launch_bounds__(kRowThreads) sxent_bwd_row(
    const float* __restrict__ x, const long long* __restrict__ labels,
    const float* __restrict__ dy, float* __restrict__ dx, int C) {
  __shared__ float red[66];
  const int r = blockIdx.x;
  const long base = static_cast<long>(r) * C;
  float m, s;
  row_stats(x + base, C, red, m, s);
  const long long label = labels[r];
  const float g = dy[r];
  for (int j = threadIdx.x; j < C; j += kRowThreads) {
    const float p = expf(x[base + j] - m) / s;
    dx[base + j] = (p - (j == label ? 1.f : 0.f)) * g;
  }
}

}  // namespace

extern "C" int ptt_softmax_xent_fwd(const float* x, const long long* labels,
                                    float* loss, int R, int C,
                                    cudaStream_t stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  if (C <= 32 * kMaxPerLane) {
    sxent_fwd_warp<<<(R + kWarpRows - 1) / kWarpRows, kWarpRows * 32, 0,
                     stream>>>(x, labels, loss, R, C);
  } else {
    sxent_fwd_row<<<R, kRowThreads, 0, stream>>>(x, labels, loss, C);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptt_softmax_xent_bwd(const float* x, const long long* labels,
                                    const float* dy, float* dx, int R, int C,
                                    cudaStream_t stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  if (C <= 32 * kMaxPerLane) {
    sxent_bwd_warp<<<(R + kWarpRows - 1) / kWarpRows, kWarpRows * 32, 0,
                     stream>>>(x, labels, dy, dx, R, C);
  } else {
    sxent_bwd_row<<<R, kRowThreads, 0, stream>>>(x, labels, dy, dx, C);
  }
  return static_cast<int>(cudaGetLastError());
}
