// The grid-sync form of fused_lstm and fused_gru that csrc/recurrent.cu
// replaced, kept as the baseline of scripts/recurrent_kernel_check.py's
// step split (not part of the kernel library).  One cooperative launch,
// block k owning ceil(H / SMs) units with their W columns in shared memory;
// each step stages h_{t-1} for a tile of rows one float at a time through
// L2, forms the gate columns with a fixed-order float32 dot over H,
// applies the cell update, and meets the grid at cooperative_groups'
// grid.sync() (twice a step for the GRU, whose r h and update gate go
// through a global scratch).
//
// `parts` runs a prefix of a step, to split where its time goes: 0 the
// barriers alone, 1 with the stage, 2 with the stage and the dot, 3 the
// whole step (the form's own output).
#include <cmath>

#include <cooperative_groups.h>

#include "common.cuh"  // paddle_tpu_torch/kernels/csrc (nvcc -I)

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;  // register accumulators a thread

struct Seq {
  const float* x;     // [B, T, G H] projected inputs
  const float* w;     // [H, G H]
  const float* h0;    // [B, H]
  const float* c0;    // [B, H] (LSTM only)
  const int* lens;    // [B]
  float* hs;          // [B, T, H]
  float* cs;          // [B, T, H] (LSTM only)
  float* rh;          // [B, H] r h scratch (GRU only)
  float* ug;          // [B, H] update-gate scratch (GRU only)
  int B, T, H;
  int units;          // hidden units a block owns
  int tile;           // batch rows staged in shared memory at a time
};

__device__ __forceinline__ float sigmoidf(float z) { return 1.f / (1.f + expf(-z)); }

// Copy the block's W columns for gates [g0, g0 + ng) into shared memory as
// [H, ng * units]: local column g * units + u is W column (g0 + g) H + u0 + u;
// columns past the block's last unit are zero.
__device__ void load_w(const Seq& p, int G, int g0, int ng, int u0, int nu, float* wsm) {
  const int cols = ng * p.units;
  for (int i = threadIdx.x; i < p.H * cols; i += kThreads) {
    const int k = i / cols, c = i % cols;
    const int g = c / p.units, u = c % p.units;
    wsm[i] = u < nu ? p.w[static_cast<long long>(k) * G * p.H + (g0 + g) * p.H + u0 + u] : 0.f;
  }
}

// Stage rows [b0, b0 + rows) of a [B, H] state whose row b starts at
// src + b * stride into hsm (row stride H + 1, which keeps the rows of a
// warp's thread groups in different banks).  `fresh`: written by other
// blocks in this launch, so read through L2.
__device__ void stage(const float* src, long long stride, int b0, int rows, int H, bool fresh,
                      float* hsm) {
  for (int i = threadIdx.x; i < rows * H; i += kThreads) {
    const int r = i / H, k = i % H;
    const float* ptr = src + (b0 + r) * stride + k;
    hsm[r * (H + 1) + k] = fresh ? __ldcg(ptr) : *ptr;
  }
}

// gsm[r, j] = sum_k hsm[r, k] wsm[k, j] for the tile's rows and `cols`
// columns, k in order.  Thread (group, j) owns column j and rows group,
// group + groups, ... of each pass.
__device__ void tile_dots(const float* hsm, const float* wsm, int rows, int H, int cols,
                          float* gsm) {
  const int groups = kThreads / cols;
  const int j = threadIdx.x % cols, grp = threadIdx.x / cols;
  if (grp >= groups) return;
  for (int base = 0; base < rows; base += groups * kRowsPerThread) {
    float acc[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;
    for (int k = 0; k < H; ++k) {
      const float wv = wsm[k * cols + j];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int row = base + grp + r * groups;
        if (row < rows) acc[r] = fmaf(hsm[row * (H + 1) + k], wv, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int row = base + grp + r * groups;
      if (row < rows) gsm[row * cols + j] = acc[r];
    }
  }
}

__global__ void __launch_bounds__(kThreads) lstm_seq_kernel(Seq p, int parts) {
  extern __shared__ float smem[];
  const int U = p.units, H = p.H, C = 4 * U;
  const int u0 = blockIdx.x * U, nu = min(U, H - u0);
  float* wsm = smem;                      // [H, 4U]
  float* hsm = wsm + H * C;               // [tile, H + 1]
  float* gsm = hsm + p.tile * (H + 1);    // [tile, 4U]
  load_w(p, 4, 0, 4, u0, nu, wsm);
  cg::grid_group grid = cg::this_grid();
  const long long rowT = static_cast<long long>(p.T) * H;  // hs / cs row stride
  for (int t = 0; t < p.T; ++t) {
    for (int b0 = 0; b0 < p.B; b0 += p.tile) {
      const int rows = min(p.tile, p.B - b0);
      if (parts >= 1) {
        if (t == 0) stage(p.h0, H, b0, rows, H, false, hsm);
        else stage(p.hs + static_cast<long long>(t - 1) * H, rowT, b0, rows, H, true, hsm);
      }
      __syncthreads();
      if (parts >= 2) tile_dots(hsm, wsm, rows, H, C, gsm);
      __syncthreads();
      for (int i = threadIdx.x; i < (parts >= 3 ? rows * nu : 0); i += kThreads) {
        const int r = i / nu, u = i % nu, b = b0 + r, j = u0 + u;
        const float* x = p.x + (static_cast<long long>(b) * p.T + t) * 4 * H;
        const float* g = gsm + r * C;
        const float gi = x[j] + g[u];
        const float gf = x[H + j] + g[U + u];
        const float gc = x[2 * H + j] + g[2 * U + u];
        const float go = x[3 * H + j] + g[3 * U + u];
        const long long at = static_cast<long long>(b) * rowT + static_cast<long long>(t) * H + j;
        const float c_prev = t == 0 ? p.c0[static_cast<long long>(b) * H + j] : p.cs[at - H];
        const float h_prev = hsm[r * (H + 1) + j];
        float c = sigmoidf(gf) * c_prev + sigmoidf(gi) * tanhf(gc);
        float h = sigmoidf(go) * tanhf(c);
        if (t >= p.lens[b]) {
          c = c_prev;
          h = h_prev;
        }
        p.hs[at] = h;
        p.cs[at] = c;
      }
      __syncthreads();
    }
    grid.sync();
  }
}

__global__ void __launch_bounds__(kThreads) gru_seq_kernel(Seq p, int parts) {
  extern __shared__ float smem[];
  const int U = p.units, H = p.H;
  const int u0 = blockIdx.x * U, nu = min(U, H - u0);
  float* wur = smem;                      // [H, 2U]: update, reset columns
  float* wc = wur + H * 2 * U;            // [H, U]: candidate columns
  float* hsm = wc + H * U;                // [tile, H + 1]
  float* gsm = hsm + p.tile * (H + 1);    // [tile, 2U]
  load_w(p, 3, 0, 2, u0, nu, wur);
  load_w(p, 3, 2, 1, u0, nu, wc);
  cg::grid_group grid = cg::this_grid();
  const long long rowT = static_cast<long long>(p.T) * H;
  for (int t = 0; t < p.T; ++t) {
    // phase 1: u and r for this block's units; r h into the scratch
    for (int b0 = 0; b0 < p.B; b0 += p.tile) {
      const int rows = min(p.tile, p.B - b0);
      if (parts >= 1) {
        if (t == 0) stage(p.h0, H, b0, rows, H, false, hsm);
        else stage(p.hs + static_cast<long long>(t - 1) * H, rowT, b0, rows, H, true, hsm);
      }
      __syncthreads();
      if (parts >= 2) tile_dots(hsm, wur, rows, H, 2 * U, gsm);
      __syncthreads();
      for (int i = threadIdx.x; i < (parts >= 3 ? rows * nu : 0); i += kThreads) {
        const int r = i / nu, u = i % nu, b = b0 + r, j = u0 + u;
        const float* x = p.x + (static_cast<long long>(b) * p.T + t) * 3 * H;
        const float ug = sigmoidf(x[j] + gsm[r * 2 * U + u]);
        const float rg = sigmoidf(x[H + j] + gsm[r * 2 * U + U + u]);
        p.rh[static_cast<long long>(b) * H + j] = rg * hsm[r * (H + 1) + j];
        p.ug[static_cast<long long>(b) * H + j] = ug;
      }
      __syncthreads();
    }
    grid.sync();
    // phase 2: the candidate from every unit's r h, then the blend
    for (int b0 = 0; b0 < p.B; b0 += p.tile) {
      const int rows = min(p.tile, p.B - b0);
      if (parts >= 1) stage(p.rh, H, b0, rows, H, true, hsm);
      __syncthreads();
      if (parts >= 2) tile_dots(hsm, wc, rows, H, U, gsm);
      __syncthreads();
      for (int i = threadIdx.x; i < (parts >= 3 ? rows * nu : 0); i += kThreads) {
        const int r = i / nu, u = i % nu, b = b0 + r, j = u0 + u;
        const float* x = p.x + (static_cast<long long>(b) * p.T + t) * 3 * H;
        const float c = tanhf(x[2 * H + j] + gsm[r * U + u]);
        const float ug = p.ug[static_cast<long long>(b) * H + j];
        const long long at = static_cast<long long>(b) * rowT + static_cast<long long>(t) * H + j;
        const float h_prev = t == 0 ? p.h0[static_cast<long long>(b) * H + j] : __ldcg(p.hs + at - H);
        const float h = ug * c + (1.f - ug) * h_prev;
        p.hs[at] = t < p.lens[b] ? h : h_prev;
      }
      __syncthreads();
    }
    grid.sync();
  }
}

// Geometry and cooperative launch of either kernel: `wcols` W columns per
// unit in shared memory, `gcols` gate columns per unit in the tile's dot.
// Returns a CUDA error code: cudaErrorInvalidValue when the block's W
// slice and one staged row do not fit in shared memory or the gate
// columns exceed the block's threads, cudaErrorCooperativeLaunchTooLarge
// when the grid cannot be co-resident.
int launch_seq(const void* kernel, Seq p, int parts, int wcols, int gcols, cudaStream_t stream) {
  if (p.B == 0 || p.T == 0 || p.H == 0) return static_cast<int>(cudaSuccess);
  int dev = 0, sms = 0, optin = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  p.units = (p.H + sms - 1) / sms;
  const int blocks = (p.H + p.units - 1) / p.units;
  if (gcols * p.units > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const long long fixed = static_cast<long long>(p.H) * wcols * p.units * sizeof(float);
  const long long per_row = static_cast<long long>(p.H + 1 + gcols * p.units) * sizeof(float);
  const long long room = (optin - fixed) / per_row;
  if (room < 1) return static_cast<int>(cudaErrorInvalidValue);
  p.tile = static_cast<int>(room < p.B ? room : p.B);
  const size_t smem = static_cast<size_t>(fixed + per_row * p.tile);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<long long>(per_sm) * sms < blocks)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&p, &parts};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptt_grid_sync_lstm(const float* x, const float* w, const float* h0,
                                  const float* c0, const int* lens, float* hs, float* cs, int B,
                                  int T, int H, int parts, cudaStream_t stream) {
  Seq p{x, w, h0, c0, lens, hs, cs, nullptr, nullptr, B, T, H, 0, 0};
  return launch_seq(reinterpret_cast<const void*>(lstm_seq_kernel), p, parts, 4, 4, stream);
}

extern "C" int ptt_grid_sync_gru(const float* x, const float* w, const float* h0, const int* lens,
                                 float* hs, float* scratch, int B, int T, int H, int parts,
                                 cudaStream_t stream) {
  const long long bh = static_cast<long long>(B) * H;
  Seq p{x, w, h0, nullptr, lens, hs, nullptr, scratch, scratch + bh, B, T, H, 0, 0};
  return launch_seq(reinterpret_cast<const void*>(gru_seq_kernel), p, parts, 3, 2, stream);
}
