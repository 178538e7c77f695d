// matmul_bias_act: out = act(x @ w + bias) over x [M, K], w [K, N],
// bias [N] (optional), all float32 row-major.  act is applied to the
// float32 accumulator before the single store: identity, relu, tanh,
// sigmoid, exact-erf gelu 0.5 z (1 + erf(z / sqrt 2)), swish z sigmoid(z).
// matmul_swiglu, the gated form on the same tile: out = silu(x @ wg) *
// (x @ wu) over wg and wu [K, N], both products and the gate formed in
// registers, so the gate and up pre-activations never reach device memory.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py matmul_bias_act
// (_mm_call, kernel body _mm_kernel, epilogue _mm_act) and matmul_swiglu
// (_swiglu_call, kernel body _swiglu_kernel).
//
// Bound on the card: at the serving path's shapes (M = 128 rows,
// 768 <-> 3072) one call does 2 M K N = 6.04e8 flops on about 11.4 MB, so
// in float32 with TF32 off it is bound by the card's float32 (non-tensor-
// core) rate rather than by memory.  The gated form at the TinyLlama
// paths' shapes (x [4096 or 128, 2048], wg/wu [2048, 5632]) does 4 M K N
// flops (1.89e11 or 5.91e9) on 189 MB or 96 MB: bound by operations too.
//
// Design: a shared-memory tiled float32 GEMM.  A block owns a 32 x 64
// output tile; each of its 256 threads keeps a 2 x 4 register micro-tile
// and walks K in steps of 16, reading the x and w tiles from shared
// memory.  Ragged edges (M, N, K not multiples of the tile) load zeros
// and mask the store.  The epilogue adds the bias and applies the
// activation to the accumulator in registers.  The gated form loads the
// x tile once per k step with a wg and a wu tile beside it and keeps two
// micro-tiles, g and u, from the same x values; its epilogue is
// g / (1 + exp(-g)) * u.
//
// Fixed split-K: a narrow output (ffn_out, N = 768) has too few tiles to
// fill the card (48 blocks on 132 SMs), so K is cut into slices of
// k_slice (a constant the caller passes, never derived from M or N).
// With more than one slice, grid.z runs one block per slice, each writes
// its partial tile to a workspace [slices, M, N], and reduce_epilogue
// sums the slices in slice order before the bias and the activation.  No
// atomics: each output element sums its k in one fixed order that
// depends on K alone, so a row's result does not depend on the other
// rows (the serving engine's pooled == solo contract).  The gated form
// takes no split-K: N = 5632 gives 88 column tiles, so even the serving
// step's 128 rows launch 352 blocks.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 32, BN = 64, BK = 16, TM = 2, TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256

enum Act { kIdentity = 0, kRelu = 1, kTanh = 2, kSigmoid = 3, kGelu = 4, kSwish = 5 };

__device__ __forceinline__ float apply_act(float z, int act) {
  switch (act) {
    case kRelu: return fmaxf(z, 0.f);
    case kTanh: return tanhf(z);
    case kSigmoid: return 1.f / (1.f + expf(-z));
    case kGelu: return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
    case kSwish: return z / (1.f + expf(-z));
    default: return z;
  }
}

// out (or, with Partial, slice blockIdx.z of the workspace) = the tile's
// sum over k in [blockIdx.z * k_slice, min(K, (blockIdx.z + 1) * k_slice));
// with Gated, w is wg, wu the up weight, and out = silu(x wg) * (x wu)
template <bool Partial, bool Gated>
__global__ void __launch_bounds__(kThreads) mm_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ wu, const float* __restrict__ bias,
    float* __restrict__ out, int M, int N, int K, int k_slice, int act) {
  __shared__ float As[BK][BM];  // x tile, transposed: As[k][m]
  __shared__ float Bs[BK][BN];  // w tile: Bs[k][n]
  __shared__ float Us[Gated ? BK : 1][BN];  // wu tile (gated form only)
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float acc[TM][TN], up[Gated ? TM : 1][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = 0.f;
      if constexpr (Gated) up[i][j] = 0.f;
    }

  const int k_begin = blockIdx.z * k_slice;
  const int k_end = min(K, k_begin + k_slice);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;  // neighbouring threads: neighbouring k
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < k_end) ? x[static_cast<long>(gm) * K + gk] : 0.f;
    }
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;  // neighbouring threads: neighbouring n
      const int gk = k0 + r, gn = n0 + c;
      const bool in = gk < k_end && gn < N;
      const long off = static_cast<long>(gk) * N + gn;
      Bs[r][c] = in ? w[off] : 0.f;
      if constexpr (Gated) Us[r][c] = in ? wu[off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN], bu[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        b[j] = Bs[kk][tx * TN + j];
        if constexpr (Gated) bu[j] = Us[kk][tx * TN + j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          if constexpr (Gated) up[i][j] = fmaf(a[i], bu[j], up[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      float z = acc[i][j];
      if constexpr (Gated) {
        out[static_cast<long>(gm) * N + gn] = z / (1.f + expf(-z)) * up[i][j];
      } else if constexpr (Partial) {
        out[(static_cast<long>(blockIdx.z) * M + gm) * N + gn] = z;
      } else {
        if (bias != nullptr) z += bias[gn];
        out[static_cast<long>(gm) * N + gn] = apply_act(z, act);
      }
    }
  }
}

// out = act(sum over slices of ws + bias), the slices summed in order
__global__ void reduce_epilogue(const float* __restrict__ ws,
                                const float* __restrict__ bias,
                                float* __restrict__ out, int M, int N,
                                int slices, int act) {
  const long mn = static_cast<long>(M) * N;
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       i < mn; i += static_cast<long>(gridDim.x) * blockDim.x) {
    float z = 0.f;
    for (int s = 0; s < slices; ++s) z += ws[s * mn + i];
    if (bias != nullptr) z += bias[i % N];
    out[i] = apply_act(z, act);
  }
}

}  // namespace

// workspace: [ceil(K / k_slice), M, N] floats when K > k_slice, else unused
extern "C" int ptt_matmul_bias_act(const float* x, const float* w,
                                   const float* bias, float* out,
                                   float* workspace, int M, int N, int K,
                                   int k_slice, int act,
                                   cudaStream_t stream) {
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  if (act < kIdentity || act > kSwish || k_slice <= 0 || k_slice % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slices = K > k_slice ? (K + k_slice - 1) / k_slice : 1;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, slices);
  if (slices == 1) {
    mm_kernel<false, false><<<grid, kThreads, 0, stream>>>(
        x, w, nullptr, bias, out, M, N, K, K, act);
  } else {
    if (workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    mm_kernel<true, false><<<grid, kThreads, 0, stream>>>(
        x, w, nullptr, nullptr, workspace, M, N, K, k_slice, act);
    const long mn = static_cast<long>(M) * N;
    const long want = (mn + 255) / 256;
    const int blocks = static_cast<int>(want < 65535 ? want : 65535);
    reduce_epilogue<<<blocks, 256, 0, stream>>>(workspace, bias, out, M, N,
                                                slices, act);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptt_matmul_swiglu(const float* x, const float* wg,
                                 const float* wu, float* out, int M, int N,
                                 int K, cudaStream_t stream) {
  if (M < 0 || N < 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_kernel<false, true><<<grid, kThreads, 0, stream>>>(
      x, wg, wu, nullptr, out, M, N, K, K, kIdentity);
  return static_cast<int>(cudaGetLastError());
}
