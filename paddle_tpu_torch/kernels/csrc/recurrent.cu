// fused_lstm and fused_gru: whole-sequence recurrences over padded,
// already projected inputs, float32 row-major.
//
//   LSTM: gates = xproj[:, t] + h_{t-1} W       (xproj [B, T, 4H], W [H, 4H],
//         gate order i | f | c~ | o)
//         c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(c~),  h_t = sigmoid(o) tanh(c_t)
//   GRU:  u = sigmoid(x_u + h W_u), r = sigmoid(x_r + h W_r)
//         (xproj [B, T, 3H], W [H, 3H] = [W_u | W_r | W_c])
//         c = tanh(x_c + (r h) W_c),  h_t = u c + (1 - u) h_{t-1}
//   A row b with t >= lens[b] keeps its state: h_t = h_{t-1} (and c_t =
//   c_{t-1}), so a row of length 0 outputs h0 (and c0) at every t.
//   Outputs: hs (and cs) [B, T, H].
//
// Replaces: paddle_tpu/ops/pallas_kernels.py fused_lstm (_lstm_seq_fwd,
// kernel body _lstm_seq_kernel) and fused_gru (_gru_seq_fwd, kernel body
// _gru_seq_kernel).  The backward has no kernel there either: both take
// the vjp of the dense scan (kernels/recurrent.py does the same).
//
// Bound on the card: operations, in principle.  The LSTM at B 32, T 64,
// H 512 does 2 B T H 4H = 4.3 GFLOP on 29 MB.  In practice the T steps are
// a serial chain: step t needs every unit of h_{t-1}, so the whole card
// meets at a barrier once a step (twice for the GRU), and each step's
// product is only B x H x 4H.
//
// Design (a persistent RNN): the TPU kernel keeps all of W [H, 4H] in one
// core's VMEM, 4 MiB at H 512; one SM holds 227 KB.  So one cooperative
// launch puts at most one block on each SM, every block co-resident, and
// block k owns a fixed contiguous slice of `units` hidden units with every
// gate column of those units.  Its W columns ([H, 4 units] for the LSTM,
// 32 KB at H 512) are copied into shared memory once and stay there for
// all T steps: W is read from device memory once per sequence, as on the
// TPU.  Each step a block stages h_{t-1} for a tile of batch rows in
// shared memory (the output hs is the exchange buffer: h_{t-1} is
// hs[:, t-1], written by every block in the step before, as the TPU
// kernel writes o_ref[:, t] every step), computes its gate columns with a
// fixed-order float32 dot over H, applies the cell update and writes
// h_t (and c_t) for its units, and then the grid meets at a grid-wide
// barrier (cooperative_groups grid sync) before step t + 1.  The LSTM's c
// never leaves the block's units: c_{t-1} is read back from the block's
// own cs writes.  The GRU needs two phases a step: phase 1 forms u and r
// for the block's units and writes r h to a [B, H] scratch, a barrier,
// then phase 2 forms c = tanh(x_c + (r h) W_c) from every unit's r h.
// That scratch is the one intermediate the TPU kept in VMEM that here
// goes through L2.  Reads of values other blocks wrote in this launch
// use ld.global.cg (L2, never a stale L1 line).
//
// Determinism: no atomics; every dot sums over k = 0 .. H-1 in order, so a
// row's result does not depend on the other rows, the tiling or the grid.
// The length mask is a select (t < lens[b]), equal to the reference's
// active blend for finite values.  Plain expf/tanhf (no fast math).
#include <cmath>

#include <cooperative_groups.h>

#include "common.cuh"

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

__global__ void __launch_bounds__(kThreads) lstm_seq_kernel(Seq p) {
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
      if (t == 0) stage(p.h0, H, b0, rows, H, false, hsm);
      else stage(p.hs + static_cast<long long>(t - 1) * H, rowT, b0, rows, H, true, hsm);
      __syncthreads();
      tile_dots(hsm, wsm, rows, H, C, gsm);
      __syncthreads();
      for (int i = threadIdx.x; i < rows * nu; i += kThreads) {
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

__global__ void __launch_bounds__(kThreads) gru_seq_kernel(Seq p) {
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
      if (t == 0) stage(p.h0, H, b0, rows, H, false, hsm);
      else stage(p.hs + static_cast<long long>(t - 1) * H, rowT, b0, rows, H, true, hsm);
      __syncthreads();
      tile_dots(hsm, wur, rows, H, 2 * U, gsm);
      __syncthreads();
      for (int i = threadIdx.x; i < rows * nu; i += kThreads) {
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
      stage(p.rh, H, b0, rows, H, true, hsm);
      __syncthreads();
      tile_dots(hsm, wc, rows, H, U, gsm);
      __syncthreads();
      for (int i = threadIdx.x; i < rows * nu; i += kThreads) {
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
int launch_seq(const void* kernel, Seq p, int wcols, int gcols, cudaStream_t stream) {
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
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptt_lstm_seq(const float* x, const float* w, const float* h0, const float* c0,
                            const int* lens, float* hs, float* cs, int B, int T, int H,
                            cudaStream_t stream) {
  Seq p{x, w, h0, c0, lens, hs, cs, nullptr, nullptr, B, T, H, 0, 0};
  return launch_seq(reinterpret_cast<const void*>(lstm_seq_kernel), p, 4, 4, stream);
}

extern "C" int ptt_gru_seq(const float* x, const float* w, const float* h0, const int* lens,
                           float* hs, float* scratch, int B, int T, int H,
                           cudaStream_t stream) {
  const long long bh = static_cast<long long>(B) * H;
  Seq p{x, w, h0, nullptr, lens, hs, nullptr, scratch, scratch + bh, B, T, H, 0, 0};
  return launch_seq(reinterpret_cast<const void*>(gru_seq_kernel), p, 3, 2, stream);
}
