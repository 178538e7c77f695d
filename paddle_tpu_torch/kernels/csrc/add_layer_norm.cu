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
// Design: the row stays in registers, in `warps` warps (1, 2, 4 or 8), up
// to 8 warps a block: `rows` rows a block, picked by the caller's plan
// (add_ln_plan in kernels/add_layer_norm.py) so that every SM gets a block
// where the rows allow.  Lane `lane` of the row's warp w holds, in slot i,
// the four columns 4 (32 (i warps + w) + lane) + e: float4 loads and
// stores where vec (H % 4 == 0 and every row pointer on 16 bytes), else
// the same columns as four scalars, so both give a row the same bits.  x
// and y are each read once, s and the output each written once, gamma and
// beta read once a warp; a lane issues all its loads before it uses one
// (gamma's and beta's too, up to 8 slots), so a row waits for memory once.  One warp a row needs no shared memory and no
// barrier; a row over several warps exchanges one float a warp for each
// statistic through shared memory (one block barrier each).  The form
// this replaced (one 256-thread block a row, the row in shared memory,
// two block reductions) spent its time in barriers, not in moving bytes.
//
// Statistics are two-pass in float32, as in _add_ln_kernel: first the
// mean, then the mean of the squared deviations, each summed in a fixed
// order (a lane's slots in order, xor shuffles over the lanes, the warps
// of the row in order).  The plan fixes warps and slots by H alone, so a
// row's result is a function of that row only: deterministic, and equal
// whatever the other rows and however many there are.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 8;  // warps a block (rows x warps a row)

__device__ __forceinline__ float row_total(float t, float* red, int warps, int rb, int w,
                                           int lane) {
  t = ptt::warp_sum(t);
  if (warps == 1) return t;
  if (lane == 0) red[rb * warps + w] = t;
  __syncthreads();
  float u = red[rb * warps];
  for (int k = 1; k < warps; ++k) u += red[rb * warps + k];
  return u;
}

template <int N4, bool VEC>
__global__ void __launch_bounds__(32 * kMaxWarps) add_ln_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float* __restrict__ s_out, float* __restrict__ o_out,
    float* __restrict__ mean_out, float* __restrict__ var_out, int R, int H, int warps,
    float eps) {
  __shared__ float red[2][kMaxWarps];  // a warp's partial of each statistic
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = warp % warps;   // the warp's place in its row
  const int rb = warp / warps;  // the row's place in the block
  const long row = static_cast<long>(blockIdx.x) * (blockDim.x / (32 * warps)) + rb;
  const bool live = row < R;
  if (warps == 1 && !live) return;  // warp-uniform; no barrier follows
  const long base = live ? row * H : 0;
  // every load of the row first, so all of a lane's loads are in flight
  // at once; then s = x + y, written out
  float4 v[N4], u[N4];
#pragma unroll
  for (int i = 0; i < N4; ++i) {
    v[i] = u[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int c = 4 * (32 * (i * warps + w) + lane);
    if (!live || c >= H) continue;
    if (VEC) {
      v[i] = *reinterpret_cast<const float4*>(x + base + c);
      u[i] = *reinterpret_cast<const float4*>(y + base + c);
    } else {
      if (c < H) v[i].x = x[base + c], u[i].x = y[base + c];
      if (c + 1 < H) v[i].y = x[base + c + 1], u[i].y = y[base + c + 1];
      if (c + 2 < H) v[i].z = x[base + c + 2], u[i].z = y[base + c + 2];
      if (c + 3 < H) v[i].w = x[base + c + 3], u[i].w = y[base + c + 3];
    }
  }
  // up to 8 slots, gamma and beta too: their loads wait beside x's and y's
  // rather than after the statistics
  constexpr bool kEarly = N4 <= 8;
  float4 ga[kEarly ? N4 : 1], be[kEarly ? N4 : 1];
#pragma unroll
  for (int i = 0; i < (kEarly ? N4 : 0); ++i) {
    const int c = 4 * (32 * (i * warps + w) + lane);
    ga[i] = be[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!live || c >= H) continue;
    if (VEC) {
      ga[i] = *reinterpret_cast<const float4*>(gamma + c);
      be[i] = *reinterpret_cast<const float4*>(beta + c);
    } else {
      if (c < H) ga[i].x = gamma[c], be[i].x = beta[c];
      if (c + 1 < H) ga[i].y = gamma[c + 1], be[i].y = beta[c + 1];
      if (c + 2 < H) ga[i].z = gamma[c + 2], be[i].z = beta[c + 2];
      if (c + 3 < H) ga[i].w = gamma[c + 3], be[i].w = beta[c + 3];
    }
  }
#pragma unroll
  for (int i = 0; i < N4; ++i) {
    v[i] = make_float4(v[i].x + u[i].x, v[i].y + u[i].y, v[i].z + u[i].z, v[i].w + u[i].w);
    const int c = 4 * (32 * (i * warps + w) + lane);
    if (!live || c >= H) continue;
    if (VEC) {
      *reinterpret_cast<float4*>(s_out + base + c) = v[i];
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < H) s_out[base + c + e] = ptt::comp(v[i], e);
    }
  }
  float acc = 0.f;  // padding slots hold 0
#pragma unroll
  for (int i = 0; i < N4; ++i) acc += v[i].x + v[i].y + v[i].z + v[i].w;
  const float mean = row_total(acc, red[0], warps, rb, w, lane) / static_cast<float>(H);
  float acc2 = 0.f;
#pragma unroll
  for (int i = 0; i < N4; ++i) {
    const int c = 4 * (32 * (i * warps + w) + lane);
    // a padding column's deviation must not count
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = ptt::comp(v[i], e) - mean;
      if (c + e < H) acc2 = fmaf(d, d, acc2);
    }
  }
  const float var = row_total(acc2, red[1], warps, rb, w, lane) / static_cast<float>(H);
  if (!live) return;  // after the last barrier
  if (w == 0 && lane == 0) {
    mean_out[row] = mean;
    var_out[row] = var;
  }
  const float inv = 1.f / sqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < N4; ++i) {
    const int c = 4 * (32 * (i * warps + w) + lane);
    if (c >= H) continue;
    float4 g, b;
    if constexpr (kEarly) {
      g = ga[i];
      b = be[i];
    } else if (VEC) {
      g = *reinterpret_cast<const float4*>(gamma + c);
      b = *reinterpret_cast<const float4*>(beta + c);
    } else {
      g = b = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < H) g.x = gamma[c], b.x = beta[c];
      if (c + 1 < H) g.y = gamma[c + 1], b.y = beta[c + 1];
      if (c + 2 < H) g.z = gamma[c + 2], b.z = beta[c + 2];
      if (c + 3 < H) g.w = gamma[c + 3], b.w = beta[c + 3];
    }
    const float4 o = make_float4(
        (v[i].x - mean) * inv * g.x + b.x, (v[i].y - mean) * inv * g.y + b.y,
        (v[i].z - mean) * inv * g.z + b.z, (v[i].w - mean) * inv * g.w + b.w);
    if (VEC) {
      *reinterpret_cast<float4*>(o_out + base + c) = o;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < H) o_out[base + c + e] = ptt::comp(o, e);
    }
  }
}

template <int N4>
int launch(const float* x, const float* y, const float* gamma, const float* beta,
           float* s_out, float* o_out, float* mean_out, float* var_out, int R, int H,
           bool vec, int warps, int rows, float eps, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((R + rows - 1) / rows);
  const unsigned threads = static_cast<unsigned>(32 * warps * rows);
  if (vec)
    add_ln_kernel<N4, true><<<blocks, threads, 0, stream>>>(
        x, y, gamma, beta, s_out, o_out, mean_out, var_out, R, H, warps, eps);
  else
    add_ln_kernel<N4, false><<<blocks, threads, 0, stream>>>(
        x, y, gamma, beta, s_out, o_out, mean_out, var_out, R, H, warps, eps);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// The plan (add_ln_plan): n4 float4 slots a lane (1, 2, 3, 4, 6, 8, 12 or
// 16), float4 access when vec, `warps` warps a row (1, 2, 4 or 8) with
// 128 n4 warps >= H, and `rows` rows a block (rows x warps <= 8).
extern "C" int ptt_add_layer_norm(const float* x, const float* y,
                                  const float* gamma, const float* beta,
                                  float* s_out, float* o_out, float* mean_out,
                                  float* var_out, int R, int H, int n4, int vec,
                                  int warps, int rows, float eps,
                                  cudaStream_t stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  const bool v4 = vec != 0;
  if (H < 1 || (warps != 1 && warps != 2 && warps != 4 && warps != 8) || rows < 1 ||
      warps * rows > kMaxWarps || static_cast<long>(128) * n4 * warps < H ||
      (v4 && (H % 4 != 0 || !aligned16(x) || !aligned16(y) || !aligned16(gamma) ||
              !aligned16(beta) || !aligned16(s_out) || !aligned16(o_out))))
    return static_cast<int>(cudaErrorInvalidValue);
#define PTT_ADD_LN(N)                                                                   \
  case N:                                                                               \
    return launch<N>(x, y, gamma, beta, s_out, o_out, mean_out, var_out, R, H, v4, warps, \
                     rows, eps, stream);
  switch (n4) {
    PTT_ADD_LN(1)
    PTT_ADD_LN(2)
    PTT_ADD_LN(3)
    PTT_ADD_LN(4)
    PTT_ADD_LN(6)
    PTT_ADD_LN(8)
    PTT_ADD_LN(12)
    PTT_ADD_LN(16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PTT_ADD_LN
}
