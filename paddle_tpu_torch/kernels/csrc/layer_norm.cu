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
// Design: two forms, picked by the caller's plan (ln_plan in
// kernels/layer_norm.py) from the row width:
//
// - the register form (H up to 1024): one warp per row, 1 to 8 rows a
//   block (the plan keeps every SM a block where the rows allow: a few SMs
//   cannot pull many rows at the card's rate).  The row stays in
//   registers, N4 float4 slots a lane (float4 loads and stores where H % 4
//   == 0, else 4 N4 scalars a lane), and gamma and beta are read once per
//   warp as float4.  No shared memory and no block barrier: the block form
//   at H 768 spends its time in two block reductions and their barriers,
//   not in moving bytes;
// - the block form (wider rows, up to the 48 KB row buffer): one block of
//   256 threads per row, the row read once into shared memory.  At H 2048
//   it beat the register form at every row count (PERF.md section 6).
//
// Statistics are two-pass in float32 in both, as in _ln_kernel: first the
// mean, then the mean of the squared deviations, each a fixed-order
// reduction (a lane's slots in order, then xor shuffles; the block form
// adds warp 0 over the warps), so a row's result is a function of the row
// alone: deterministic and independent of the other rows.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlockRowBytes = 48 * 1024;  // the block form's widest row

// the register form, a row a warp: N4 float4 slots a lane; VEC: column
// 4 (32 i + lane) + e of slot i, else column 32 (4 i + e) + lane (scalar,
// any H)
template <int N4, bool VEC>
__global__ void __launch_bounds__(kThreads) ln_warp_kernel(
    const float* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, float* __restrict__ o_out,
    float* __restrict__ mean_out, float* __restrict__ var_out, int R, int H,
    float eps) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= R) return;  // warp-uniform
  const float* xr = x + row * H;
  float* orow = o_out + row * H;
  float4 v[N4];
#pragma unroll
  for (int i = 0; i < N4; ++i) {
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (VEC) {
      const int c = 4 * (32 * i + lane);
      if (c < H) v[i] = *reinterpret_cast<const float4*>(xr + c);
    } else {
      const int c = 128 * i + lane;
      if (c < H) v[i].x = xr[c];
      if (c + 32 < H) v[i].y = xr[c + 32];
      if (c + 64 < H) v[i].z = xr[c + 64];
      if (c + 96 < H) v[i].w = xr[c + 96];
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < N4; ++i) acc += v[i].x + v[i].y + v[i].z + v[i].w;
  const float mean = ptt::warp_sum(acc) / static_cast<float>(H);
  float acc2 = 0.f;
#pragma unroll
  for (int i = 0; i < N4; ++i) {
    // padding slots hold 0, whose deviation must not count
    const int c = VEC ? 4 * (32 * i + lane) : 128 * i + lane;
    const float dx = v[i].x - mean, dy = v[i].y - mean, dz = v[i].z - mean,
                dw = v[i].w - mean;
    if (VEC) {
      if (c < H) acc2 += dx * dx + dy * dy + dz * dz + dw * dw;
    } else {
      if (c < H) acc2 = fmaf(dx, dx, acc2);
      if (c + 32 < H) acc2 = fmaf(dy, dy, acc2);
      if (c + 64 < H) acc2 = fmaf(dz, dz, acc2);
      if (c + 96 < H) acc2 = fmaf(dw, dw, acc2);
    }
  }
  const float var = ptt::warp_sum(acc2) / static_cast<float>(H);
  if (lane == 0) {
    mean_out[row] = mean;
    var_out[row] = var;
  }
  const float inv = 1.f / sqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < N4; ++i) {
    if (VEC) {
      const int c = 4 * (32 * i + lane);
      if (c < H) {
        const float4 g = *reinterpret_cast<const float4*>(gamma + c);
        const float4 b = *reinterpret_cast<const float4*>(beta + c);
        *reinterpret_cast<float4*>(orow + c) =
            make_float4((v[i].x - mean) * inv * g.x + b.x, (v[i].y - mean) * inv * g.y + b.y,
                        (v[i].z - mean) * inv * g.z + b.z, (v[i].w - mean) * inv * g.w + b.w);
      }
    } else {
      const int c = 128 * i + lane;
      if (c < H) orow[c] = (v[i].x - mean) * inv * gamma[c] + beta[c];
      if (c + 32 < H) orow[c + 32] = (v[i].y - mean) * inv * gamma[c + 32] + beta[c + 32];
      if (c + 64 < H) orow[c + 64] = (v[i].z - mean) * inv * gamma[c + 64] + beta[c + 64];
      if (c + 96 < H) orow[c + 96] = (v[i].w - mean) * inv * gamma[c + 96] + beta[c + 96];
    }
  }
}

// the block form: one block per row, the row in shared memory
__global__ void __launch_bounds__(kThreads) ln_block_kernel(
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

template <int N4>
int launch_warp(const float* x, const float* gamma, const float* beta, float* o_out,
                float* mean_out, float* var_out, int R, int H, bool vec, int rows,
                float eps, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((R + rows - 1) / rows);
  if (vec)
    ln_warp_kernel<N4, true><<<blocks, 32 * rows, 0, stream>>>(x, gamma, beta, o_out,
                                                               mean_out, var_out, R, H, eps);
  else
    ln_warp_kernel<N4, false><<<blocks, 32 * rows, 0, stream>>>(x, gamma, beta, o_out,
                                                                mean_out, var_out, R, H, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan (ln_plan): form 0 is the register form with n4 float4 slots a
// lane (1, 2, 4, 6 or 8; 128 n4 >= H), float4 access when vec
// (H % 4 == 0) and `rows` rows a block (1 to 8); form 1 the block form
// (n4, vec and rows unused).
extern "C" int ptt_layer_norm(const float* x, const float* gamma,
                              const float* beta, float* o_out, float* mean_out,
                              float* var_out, int R, int H, int form, int n4,
                              int vec, int rows, float eps, cudaStream_t stream) {
  if (R == 0 || H == 0) return static_cast<int>(cudaSuccess);
  if (form == 1) {
    const size_t smem = static_cast<size_t>(H) * sizeof(float);
    if (smem > kBlockRowBytes) return static_cast<int>(cudaErrorInvalidValue);
    // a 48 KB row beside the block's static red[] is past the default limit
    static int ready = static_cast<int>(cudaFuncSetAttribute(
        ln_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBlockRowBytes));
    if (ready != 0) return ready;
    ln_block_kernel<<<R, kThreads, smem, stream>>>(x, gamma, beta, o_out, mean_out,
                                                   var_out, H, eps);
    return static_cast<int>(cudaGetLastError());
  }
  if (form != 0 || 128 * n4 < H || (vec && H % 4 != 0) || rows < 1 ||
      rows > kThreads / 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool v4 = vec != 0;
  switch (n4) {
    case 1:
      return launch_warp<1>(x, gamma, beta, o_out, mean_out, var_out, R, H, v4, rows, eps,
                            stream);
    case 2:
      return launch_warp<2>(x, gamma, beta, o_out, mean_out, var_out, R, H, v4, rows, eps,
                            stream);
    case 4:
      return launch_warp<4>(x, gamma, beta, o_out, mean_out, var_out, R, H, v4, rows, eps,
                            stream);
    case 6:
      return launch_warp<6>(x, gamma, beta, o_out, mean_out, var_out, R, H, v4, rows, eps,
                            stream);
    case 8:
      return launch_warp<8>(x, gamma, beta, o_out, mean_out, var_out, R, H, v4, rows, eps,
                            stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
