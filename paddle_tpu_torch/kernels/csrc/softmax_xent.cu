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
// them.  The caller's plan (sxent_plan in kernels/softmax_xent.py) picks
// one of three forms by C:
//   * the warp form (C <= 1024): one warp a row, 8 rows a block.  Each
//     lane keeps its strided share of the row (at most 32 values) in
//     registers, so the backward, like the forward, reads the logits once:
//     max, then the sum of exp(x - max), each a warp butterfly.  At BERT's
//     NSP head [32, 2] it sits at the launch floor;
//   * the staged form (C up to what 8 blocks' shared memory holds): the
//     row is cut into `ctas` parts of equal length (a multiple of 4), one
//     block of `threads` threads a part, the blocks of a row one
//     thread-block cluster.  A block stages its part in shared memory by
//     16-byte cp.async copies, all in flight at once (a row starts on 16
//     bytes only where C % 4 == 0, so a part has a scalar head up to its
//     first aligned column and a scalar tail).  Thread t reads the columns
//     t, t + threads, ... of the part from shared memory, in order: their
//     max, merged over the block, then the sum of exp(x - max), summed
//     over the block in a fixed order (the backward keeps each
//     exponential in the stage; a part that is all -inf gives the pair
//     (-inf, 0), which the fold skips); the blocks' (max, sum) pairs fold in rank
//     order through distributed shared memory.  The backward writes dx as
//     the staged exponentials times one factor a block (16-byte stores),
//     so it reads each row of logits once and takes one exp a column;
//   * the two-read row form (wider rows): one block of 256 threads a row,
//     each thread an online max / sum over its strided columns, merged as
//     above; the backward reads the row a second time to write dx.
// Every merge is commutative and its tree depends only on C (the plan is a
// function of C), never on R, the launch or where a row starts, so a
// row's result is a pure function of that row: no atomics, two runs are
// bit-equal.  The backward recomputes max and sum from the logits, as
// _sxent_bwd_kernel does; there is no lse residual.
#include <cooperative_groups.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpRows = 8;       // rows a block in the warp form
constexpr int kMaxPerLane = 32;    // C <= 32 * 32 in the warp form
constexpr int kRowThreads = 256;   // threads a block in the two-read form
constexpr int kMaxCtas = 8;        // blocks a row in the staged form
// the staged form's dynamic shared memory: at most the 232,448 bytes a
// block may take, less its static scratch
constexpr int kMaxStageBytes = 232448 - 1024;

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

// Row max and sum of exp(x - max) over one row in the two-read form,
// broadcast to every thread.  `red` is shared scratch of 2 * 32 + 2 floats.
__device__ __forceinline__ void row_stats(const float* __restrict__ row, int C,
                                          float* red, float& m, float& s) {
  m = -INFINITY;
  s = 0.f;
  for (int j = threadIdx.x; j < C; j += kRowThreads) {
    const float v = row[j];
    if (v > m) {
      s = (s == 0.f ? 0.f : s * expf(m - v)) + 1.f;
      m = v;
    } else if (v > -INFINITY) {  // -inf adds 0; with m -inf, exp would be NaN
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

// ---- the warp form ----------------------------------------------------------
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

template <bool BWD>
int launch_warp(const float* x, const long long* labels, const float* dy, float* out, int R,
                int C, cudaStream_t stream) {
  if (C < 1 || C > 32 * kMaxPerLane) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((R + kWarpRows - 1) / kWarpRows);
  if (BWD)
    sxent_bwd_warp<<<blocks, kWarpRows * 32, 0, stream>>>(x, labels, dy, out, R, C);
  else
    sxent_fwd_warp<<<blocks, kWarpRows * 32, 0, stream>>>(x, labels, out, R, C);
  return static_cast<int>(cudaGetLastError());
}

// ---- the staged form ----------------------------------------------------------
__device__ __forceinline__ int misalign(const float* p) {  // floats past 16 bytes
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The block's max, broadcast to every thread (`red`: 33 floats).
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = ptt::warp_max(v);
  __syncthreads();  // an earlier reader of red is done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : -INFINITY;
    t = ptt::warp_max(t);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

// grid: ctas x R blocks along x, a cluster of `ctas` a row (ctas 1: no
// cluster); part = the columns a block holds (a multiple of 4).  The
// block's max m_b comes first, then its sum s_b of exp(x - m_b), the
// exponentials kept in the stage for dx; the blocks' (m_b, s_b) fold in
// rank order into the row's (m, s), and dx = exp(x - m_b) exp(m_b - m) / s.
template <bool BWD>
__global__ void __launch_bounds__(1024) sxent_staged(
    const float* __restrict__ x, const long long* __restrict__ labels,
    const float* __restrict__ dy, float* __restrict__ out, int C, int ctas, int part) {
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  __shared__ float red[33];
  __shared__ float pair[2];  // the block's (max, sum), read by its peers
  const int rank = static_cast<int>(blockIdx.x % ctas);
  const long r = blockIdx.x / ctas;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int p0 = rank * part;
  const int len = max(0, min(C, p0 + part) - p0);
  const float* src = x + r * C + p0;
  // column p0 + j of the part lies at stage[q + j]: the first 16-byte
  // aligned column lands on a 16-byte boundary of the stage
  const int q = misalign(src);
  const int head = min(len, (4 - q) & 3);
  const int n4 = (len - head) >> 2;
  const int tail = len - head - 4 * n4;
  for (int k = t; k < n4; k += T)
    ptt::cp_async16(stage + q + head + 4 * k, src + head + 4 * k, true);
  if (t < head) ptt::cp_async4(stage + q + t, src + t, true);
  if (t < tail) ptt::cp_async4(stage + q + head + 4 * n4 + t, src + head + 4 * n4 + t, true);
  ptt::cp_async_commit();
  ptt::cp_async_wait(0);
  __syncthreads();
  float m = -INFINITY;
  for (int j = t; j < len; j += T) m = fmaxf(m, stage[q + j]);
  m = block_max(m, red);
  // a part all -inf: every exponential 0, so the pair is (-inf, 0)
  const float m0 = m == -INFINITY ? 0.f : m;
  float s = 0.f;
  for (int j = t; j < len; j += T) {
    const float e = expf(stage[q + j] - m0);
    if (BWD) stage[q + j] = e;
    s += e;
  }
  s = ptt::block_sum(s, red);
  const float m_b = m;
  if (ctas > 1) {
    if (t == 0) {
      pair[0] = m;
      pair[1] = s;
    }
    cluster_arrive();  // releases the pair written above
    cluster_wait();    // acquires the peers' pairs
    cg::cluster_group cluster = cg::this_cluster();
    const float* peer = cluster.map_shared_rank(pair, 0);
    m = peer[0];
    s = peer[1];
    for (int k = 1; k < ctas; ++k) {  // every block folds in rank order
      peer = cluster.map_shared_rank(pair, k);
      merge(m, s, peer[0], peer[1]);
    }
    cluster_arrive();  // this block has read its peers' pairs
  }
  const long long label = labels[r];
  if (!BWD) {
    if (rank == 0 && t == 0) out[r] = (logf(s) + m) - gold_of(x + r * C, label, C);
  } else {
    const float g = dy[r];
    const float scale = expf(m_b - m) / s;
    float* dst = out + r * C + p0;
    auto d = [&](float e, int j) {  // dx at column p0 + j
      return (e * scale - (p0 + j == label ? 1.f : 0.f)) * g;
    };
    if (misalign(dst) == q) {  // dx's rows start as x's: 16-byte stores
      const float4* staged = stage4 + (q + head) / 4;
      for (int k = t; k < n4; k += T) {
        const int j = head + 4 * k;
        const float4 e = staged[k];
        *reinterpret_cast<float4*>(dst + j) =
            make_float4(d(e.x, j), d(e.y, j + 1), d(e.z, j + 2), d(e.w, j + 3));
      }
      if (t < head) dst[t] = d(stage[q + t], t);
      const int j = head + 4 * n4 + t;
      if (t < tail) dst[j] = d(stage[q + j], j);
    } else {
      for (int j = t; j < len; j += T) dst[j] = d(stage[q + j], j);
    }
  }
  if (ctas > 1) cluster_wait();  // no block leaves while a peer may read its pair
}

// ---- the two-read row form ------------------------------------------------
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

template <bool BWD>
int launch_staged(const float* x, const long long* labels, const float* dy, float* out,
                  int R, int C, int ctas, int threads, int smem, cudaStream_t stream) {
  static const cudaError_t raised = cudaFuncSetAttribute(
      sxent_staged<BWD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxStageBytes);
  if (raised != cudaSuccess) return static_cast<int>(raised);
  const int part = ((C + ctas - 1) / ctas + 3) & ~3;
  if (ctas < 1 || ctas > kMaxCtas || (ctas & (ctas - 1)) != 0 || threads < 32 ||
      threads > 1024 || threads % 32 != 0 || smem < 4 * (part + 4) || smem > kMaxStageBytes ||
      static_cast<long>(ctas) * R >= (1L << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas * R));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ctas);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  if (ctas > 1) {
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, sxent_staged<BWD>, x, labels, dy, out, C, ctas, part));
}

}  // namespace

// The plan (sxent_plan): form 0 the warp form (C <= 1024), form 1 the staged form
// with `ctas` blocks a row (1, 2, 4 or 8) of `threads` threads and `smem`
// bytes of stage each, form 2 the two-read row form; R and C last.
extern "C" int ptt_softmax_xent_fwd(const float* x, const long long* labels,
                                    float* loss, int form, int ctas,
                                    int threads, int smem, int R, int C,
                                    cudaStream_t stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  if (form == 0) return launch_warp<false>(x, labels, nullptr, loss, R, C, stream);
  if (form == 1)
    return launch_staged<false>(x, labels, nullptr, loss, R, C, ctas, threads, smem, stream);
  if (form != 2 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  sxent_fwd_row<<<R, kRowThreads, 0, stream>>>(x, labels, loss, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptt_softmax_xent_bwd(const float* x, const long long* labels,
                                    const float* dy, float* dx, int form, int ctas,
                                    int threads, int smem, int R, int C,
                                    cudaStream_t stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  if (form == 0) return launch_warp<true>(x, labels, dy, dx, R, C, stream);
  if (form == 1)
    return launch_staged<true>(x, labels, dy, dx, R, C, ctas, threads, smem, stream);
  if (form != 2 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  sxent_bwd_row<<<R, kRowThreads, 0, stream>>>(x, labels, dy, dx, C);
  return static_cast<int>(cudaGetLastError());
}
