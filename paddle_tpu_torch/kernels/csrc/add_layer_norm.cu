// fused_add_layer_norm: s = x + y, then LayerNorm(s) * gamma + beta, over
// [R, H] float32 rows; writes s (the residual stream), the normalized rows
// and each row's mean and variance (the op's Mean and Variance outputs,
// which would otherwise cost a recompute of the statistics).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py fused_add_layer_norm
// (_add_ln_call, kernel body _add_ln_kernel).
//
// Bound on the card: memory.  It reads x, y (8 R H bytes) and writes s and
// the output (8 R H bytes) plus 8 R bytes of statistics: 16 R H + 8 R bytes
// for about 10 R H flops.
//
// Design: one block per row.  The row's sum s is formed once, written out
// and kept in shared memory, so the statistics and the normalization
// never re-read x or y from device memory: each input byte is read once
// and each output byte written once.  Statistics are two-pass in float32,
// as in _add_ln_kernel: first the mean, then the mean of the squared
// deviations, each a fixed-order block reduction (deterministic and
// row-independent).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) add_ln_kernel(
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

}  // namespace

extern "C" int ptt_add_layer_norm(const float* x, const float* y,
                                  const float* gamma, const float* beta,
                                  float* s_out, float* o_out, float* mean_out,
                                  float* var_out, int R, int H, float eps,
                                  cudaStream_t stream) {
  if (R == 0 || H == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(H) * sizeof(float);
  add_ln_kernel<<<R, kThreads, smem, stream>>>(x, y, gamma, beta, s_out,
                                                o_out, mean_out, var_out, H,
                                                eps);
  return static_cast<int>(cudaGetLastError());
}
