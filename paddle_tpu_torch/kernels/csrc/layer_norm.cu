// fused_layer_norm: LayerNorm(x) * gamma + beta over [R, H] float32 rows;
// writes the normalized rows and each row's mean and variance (the
// layer_norm op's Mean and Variance outputs).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py fused_layer_norm (_ln_fwd,
// kernel body _ln_kernel).
//
// Bound on the card: memory.  It reads x (4 R H bytes) and writes the
// output (4 R H bytes) plus 8 R bytes of statistics, for about 8 R H flops.
//
// Design: one block per row, as add_layer_norm.cu without the residual
// input.  The row is read once into shared memory, so the statistics and
// the normalization never re-read x from device memory.  Statistics are
// two-pass in float32, as in _ln_kernel: first the mean, then the mean of
// the squared deviations, each a fixed-order block reduction
// (deterministic and row-independent).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) ln_kernel(
    const float* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, float* __restrict__ o_out,
    float* __restrict__ mean_out, float* __restrict__ var_out, int H,
    float eps) {
  extern __shared__ float srow[];  // H floats
  __shared__ float red[33];
  const long base = static_cast<long>(blockIdx.x) * H;
  float acc = 0.f;
  for (int j = threadIdx.x; j < H; j += kThreads) {
    const float v = x[base + j];
    srow[j] = v;
    acc += v;
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

extern "C" int ptt_layer_norm(const float* x, const float* gamma,
                              const float* beta, float* o_out, float* mean_out,
                              float* var_out, int R, int H, float eps,
                              cudaStream_t stream) {
  if (R == 0 || H == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(H) * sizeof(float);
  ln_kernel<<<R, kThreads, smem, stream>>>(x, gamma, beta, o_out, mean_out,
                                            var_out, H, eps);
  return static_cast<int>(cudaGetLastError());
}
