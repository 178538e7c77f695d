// fused_linear_xent: the logits-free projected cross entropy, forward and
// backward, over x [R, H], w [H, V], int64 labels [R], all float32
// row-major.  The logits z = x @ w exist only as register tiles; no [R, V]
// buffer is ever written.  Per row, with valid = (0 <= label < V):
//
//   loss = valid (1 - eps) (lse - z[label]) + eps (lse - sum_v z / V)
//   g    = dy (valid (1 - eps) (p - onehot) + eps (p - 1 / V)),  p = exp(z - lse)
//   dx   = g @ w^T,   dw = x^T @ g
//
// Replaces: paddle_tpu/ops/pallas_kernels.py fused_linear_xent: the
// forward _lxent_fwd (kernel body _lxent_fwd_kernel) and the backward
// _lxent_bwd, whose dx and dw calls run _lxent_dx_kernel and
// _lxent_dw_kernel over _lxent_grad_tile.
//
// Bound on the card: operations.  At R 4096, H 512, V 10000 the forward
// does 2 R H V = 41.9 GFLOP on 29 MB, dx and dw each twice that (the
// logits tile is recomputed from the saved lse), so with TF32 off all
// three are bound by the float32 (non-tensor-core) rate.
//
// Design.  Ragged edges load zeros; vocab columns >= V are masked in the
// kernel, so a ragged V needs no padded copy of w.  Every logits element
// sums over H in ascending order with fmaf, in all three kernels, so the
// backward recomputes exactly the forward's z.
// - forward: one block per (64-row tile, vocab split).  A block computes
//   each [64, 64] logits tile by walking H in 16-deep steps through shared
//   memory (4 x 4 register micro-tile a thread), and walks its split's
//   vocab tiles in order, keeping per row the running max, sum of
//   exponentials, gold logit and logit sum (row reductions are fixed
//   butterflies over 16 lanes).  A second pass merges the splits of each
//   row in split order.  The split count depends on R and V alone.
// - dx (H <= 512): one block per 32-row tile, owning all of H.  The x tile
//   stays in shared memory; per vocab tile in order, the whole [H, 64] w
//   tile is loaded, z and g are formed, and g @ w_tile^T is accumulated in
//   registers (4 rows x H / 32 columns a thread).
// - dw (H <= 512): one block per 32-column vocab tile, owning all of H.
//   The w tile stays in shared memory; per 32-row tile in order, z and g
//   are formed (rows >= R give zero) and x_tile^T @ g is accumulated
//   (H / 64 x 8 a thread), while the next x tile loads into the other of
//   two buffers (rows >= R load zero).
// - Wider H falls back to blocks of (32-row or 64-column tile, 256-wide H
//   slice) that stage 16-deep slices as the forward does and recompute z
//   once per H slice.
// No atomics anywhere: every output sums in one fixed order, so a step is
// bit-reproducible from the same state.
//
// sharded_linear_xent: the same three passes over ONE vocab shard, w_local
// [H, V/n], with labels in local column coordinates (label - col0: a label
// of another shard is negative or >= V/n and matches no column, and a
// column past the slab is masked before its label is compared).
// - parts: the forward's streaming pass and split merge, emitting per row
//   this shard's lse_j = m + log l, gold_j and the logit sum sum_j and no
//   loss; the caller combines the shards (max and sums over ranks).
// - dx / dw: the backward passes above with the row validity `valid` [R]
//   (from the GLOBAL labels) and the smoothing denominator vocab_total
//   given, instead of derived from the local V.  dx is this shard's
//   partial of g @ w_local^T; the caller sums it over the shards.
// Replaces: paddle_tpu/ops/pallas_kernels.py sharded_linear_xent:
// _lxent_parts (kernel body _lxent_parts_kernel) and _lxent_bwd_sharded,
// whose dx and dw calls run _lxent_dx_kernel_sharded and
// _lxent_dw_kernel_sharded over _lxent_grad_tile with valid/vocab_total.
// Bound: operations, as the unsharded forms (2 R H V/n for parts, twice
// that for dx and for dw).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BK = 16;   // depth of one staged step over H
constexpr int BV = 64;   // vocab columns per logits tile
constexpr int HS = 256;  // hidden columns owned by one dx / dw block
constexpr int PAD = 4;   // shared-row padding: fewer bank conflicts, 16-byte rows

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// z = x[r0 : r0 + 16 TM, :] @ w[:, v0 : v0 + BV] over all of H.  Thread
// (ty, tx) = (tid / 16, tid % 16) owns rows ty TM .. ty TM + TM - 1 and
// columns tx 4 .. tx 4 + 3 of the tile.  Ends with a __syncthreads().
template <int TM>
__device__ __forceinline__ void logits_tile(const float* __restrict__ x,
                                            const float* __restrict__ w, int R,
                                            int H, int V, int r0, int v0,
                                            float (*xs)[16 * TM + PAD],
                                            float (*ws)[BV], float (&z)[TM][4]) {
  constexpr int BR = 16 * TM;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) z[i][j] = 0.f;
  for (int k0 = 0; k0 < H; k0 += BK) {
    for (int i = tid; i < BR * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;  // neighbouring threads: neighbouring k
      const int gr = r0 + r, gk = k0 + c;
      xs[c][r] = (gr < R && gk < H) ? x[static_cast<long>(gr) * H + gk] : 0.f;
    }
    for (int i = tid; i < BK * BV; i += kThreads) {
      const int r = i / BV, c = i % BV;  // neighbouring threads: neighbouring v
      const int gk = k0 + r, gv = v0 + c;
      ws[r][c] = (gk < H && gv < V) ? w[static_cast<long>(gk) * V + gv] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      if (TM == 4) {
        const float4 av = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
        a[0] = av.x; a[1] = av.y; a[2 % TM] = av.z; a[3 % TM] = av.w;
      } else {
        const float2 av = *reinterpret_cast<const float2*>(&xs[kk][ty * TM]);
        a[0] = av.x; a[1 % TM] = av.y;
      }
      const float4 bv = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) z[i][j] = fmaf(a[i], b[j], z[i][j]);
    }
    __syncthreads();
  }
}

// d loss / d z at one logits element (valid column), times dy
__device__ __forceinline__ float grad_elem(float z, float lse, float dy,
                                           bool valid, bool gold, float eps,
                                           float inv_v) {
  const float p = expf(z - lse);
  float g = valid ? (1.f - eps) * (p - (gold ? 1.f : 0.f)) : 0.f;
  if (eps != 0.f) g += eps * (p - inv_v);
  return g * dy;
}

// Does row gr (< R) take the label term?  The unsharded form derives it
// from its label; the sharded form is handed it (vld != nullptr), since a
// local label cannot tell an other shard's column from outside the vocab.
__device__ __forceinline__ bool row_valid(const float* __restrict__ vld,
                                          int gr, long long lbl, int V) {
  return vld != nullptr ? vld[gr] != 0.f : (lbl >= 0 && lbl < V);
}

// per-split partials: part[(split * 4 + q) * R + row], q = max, sum of
// exponentials, gold logit, logit sum
__global__ void __launch_bounds__(kThreads) lxent_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const long long* __restrict__ labels, float* __restrict__ part, int R,
    int H, int V, int tiles_per_split) {
  constexpr int TM = 4, BR = 64;
  __shared__ __align__(16) float xs[BK][BR + PAD];
  __shared__ __align__(16) float ws[BK][BV];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * BR;
  const int n_vt = (V + BV - 1) / BV;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_vt, t_begin + tiles_per_split);
  long long lbl[TM];
  float m[TM], l[TM], gold[TM], zsum[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = r0 + ty * TM + i;
    lbl[i] = gr < R ? labels[gr] : -1;
    m[i] = ptt::kNegInf;
    l[i] = gold[i] = zsum[i] = 0.f;
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int v0 = t * BV;
    float z[TM][4];
    logits_tile<TM>(x, w, R, H, V, r0, v0, xs, ws, z);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float tmax = ptt::kNegInf, tz = 0.f, tg = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gv = v0 + tx * 4 + j;
        if (gv < V) {
          tmax = fmaxf(tmax, z[i][j]);
          tz += z[i][j];
          if (gv == lbl[i]) tg += z[i][j];
        }
      }
      tmax = group16_max(tmax);
      const float m_new = fmaxf(m[i], tmax);
      float ts = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (v0 + tx * 4 + j < V) ts += expf(z[i][j] - m_new);
      }
      ts = group16_sum(ts);
      tz = group16_sum(tz);
      tg = group16_sum(tg);
      l[i] = l[i] * expf(m[i] - m_new) + ts;
      m[i] = m_new;
      gold[i] += tg;
      zsum[i] += tz;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gr = r0 + ty * TM + i;
      if (gr >= R) continue;
      const long base = static_cast<long>(blockIdx.y) * 4 * R + gr;
      part[base] = m[i];
      part[base + R] = l[i];
      part[base + 2L * R] = gold[i];
      part[base + 3L * R] = zsum[i];
    }
  }
}

// merge the splits of each row in split order; write loss and lse
__global__ void lxent_fwd_combine(const float* __restrict__ part,
                                  const long long* __restrict__ labels,
                                  float* __restrict__ loss,
                                  float* __restrict__ lse, int R, int V,
                                  int splits, float eps) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float mx = ptt::kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part[static_cast<long>(s) * 4 * R + r]);
  float l = 0.f, gold = 0.f, zsum = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long base = static_cast<long>(s) * 4 * R + r;
    l += part[base + R] * expf(part[base] - mx);
    gold += part[base + 2L * R];
    zsum += part[base + 3L * R];
  }
  const float ls = mx + logf(l);
  const long long lbl = labels[r];
  const bool valid = lbl >= 0 && lbl < V;
  float out = valid ? (1.f - eps) * (ls - gold) : 0.f;
  if (eps != 0.f) out += eps * (ls - zsum / static_cast<float>(V));
  loss[r] = out;
  lse[r] = ls;
}

// the same merge for one vocab shard: lse_j, gold_j and sum_j, no loss
__global__ void lxent_parts_combine(const float* __restrict__ part,
                                    float* __restrict__ lse,
                                    float* __restrict__ gold_out,
                                    float* __restrict__ sum_out, int R,
                                    int splits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float mx = ptt::kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part[static_cast<long>(s) * 4 * R + r]);
  float l = 0.f, gold = 0.f, zsum = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long base = static_cast<long>(s) * 4 * R + r;
    l += part[base + R] * expf(part[base] - mx);
    gold += part[base + 2L * R];
    zsum += part[base + 3L * R];
  }
  lse[r] = mx + logf(l);
  gold_out[r] = gold;
  sum_out[r] = zsum;
}

// vld: nullptr (unsharded) or the row validity [R] (sharded); VT: the
// smoothing denominator (V unsharded, the whole vocab sharded)
__global__ void __launch_bounds__(kThreads) lxent_dx_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const long long* __restrict__ labels, const float* __restrict__ vld,
    const float* __restrict__ lse, const float* __restrict__ dy,
    float* __restrict__ dx, int R, int H, int V, int VT, float eps) {
  constexpr int TM = 2, BR = 32;
  __shared__ __align__(16) float xs[BK][BR + PAD];
  __shared__ __align__(16) float ws[BK][BV];
  __shared__ __align__(16) float gs[BV][BR + PAD];  // g tile, gs[v][r]
  __shared__ __align__(16) float wt[BK][HS + PAD];  // w^T chunk, wt[v][h]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // logits tile layout
  const int rg = tid / 32, hg = tid % 32;  // dx tile: rows rg 4 .., h hg 4 .. and 128 + hg 4 ..
  const int r0 = blockIdx.x * BR;
  const int h0 = blockIdx.y * HS;
  const float inv_v = 1.f / static_cast<float>(VT);
  long long lbl[TM];
  float rl[TM], rdy[TM];
  bool rvalid[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = r0 + ty * TM + i;
    lbl[i] = gr < R ? labels[gr] : -1;
    rl[i] = gr < R ? lse[gr] : 0.f;
    rdy[i] = gr < R ? dy[gr] : 0.f;
    rvalid[i] = gr < R && row_valid(vld, gr, lbl[i], V);
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int n_vt = (V + BV - 1) / BV;
  for (int t = 0; t < n_vt; ++t) {
    const int v0 = t * BV;
    float z[TM][4];
    logits_tile<TM>(x, w, R, H, V, r0, v0, xs, ws, z);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gv = v0 + tx * 4 + j;
        gs[tx * 4 + j][ty * TM + i] =
            gv < V ? grad_elem(z[i][j], rl[i], rdy[i], rvalid[i], gv == lbl[i], eps, inv_v)
                   : 0.f;
      }
    }
    __syncthreads();
    for (int c0 = 0; c0 < BV; c0 += BK) {
      for (int i = tid; i < BK * HS; i += kThreads) {
        const int h = i / BK, c = i % BK;  // neighbouring threads: neighbouring v
        const int gh = h0 + h, gv = v0 + c0 + c;
        wt[c][h] = (gh < H && gv < V) ? w[static_cast<long>(gh) * V + gv] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&gs[c0 + kk][rg * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&wt[kk][hg * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&wt[kk][128 + hg * 4]);
        const float a[4] = {av.x, av.y, av.z, av.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = r0 + rg * 4 + i;
    if (gr >= R) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gh = h0 + (j < 4 ? hg * 4 + j : 128 + hg * 4 + (j - 4));
      if (gh < H) dx[static_cast<long>(gr) * H + gh] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads) lxent_dw_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const long long* __restrict__ labels, const float* __restrict__ vld,
    const float* __restrict__ lse, const float* __restrict__ dy,
    float* __restrict__ dw, int R, int H, int V, int VT, float eps) {
  constexpr int TM = 2, BR = 32;
  __shared__ __align__(16) float xs[BK][BR + PAD];
  __shared__ __align__(16) float ws[BK][BV];
  __shared__ __align__(16) float gs[BR][BV + PAD];  // g tile, gs[r][v]
  __shared__ __align__(16) float xt[BK][HS + PAD];  // x^T chunk, xt[r][h]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // logits tile layout
  const int hg = tid / 8, vg = tid % 8;    // dw tile: h hg 4 .. and 128 + hg 4 .., v vg 4 .. and 32 + vg 4 ..
  const int v0 = blockIdx.x * BV;
  const int h0 = blockIdx.y * HS;
  const float inv_v = 1.f / static_cast<float>(VT);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int n_rt = (R + BR - 1) / BR;
  for (int rt = 0; rt < n_rt; ++rt) {
    const int r0 = rt * BR;
    float z[TM][4];
    logits_tile<TM>(x, w, R, H, V, r0, v0, xs, ws, z);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gr = r0 + ty * TM + i;
      const bool row = gr < R;  // the row tail gives zero
      const long long lbl = row ? labels[gr] : -1;
      const float rl = row ? lse[gr] : 0.f;
      const float rdy = row ? dy[gr] : 0.f;
      const bool valid = row && row_valid(vld, gr, lbl, V);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gv = v0 + tx * 4 + j;
        gs[ty * TM + i][tx * 4 + j] =
            (row && gv < V) ? grad_elem(z[i][j], rl, rdy, valid, gv == lbl, eps, inv_v)
                            : 0.f;
      }
    }
    __syncthreads();
    for (int c0 = 0; c0 < BR; c0 += BK) {
      for (int i = tid; i < BK * HS; i += kThreads) {
        const int c = i / HS, h = i % HS;  // neighbouring threads: neighbouring h
        const int gr = r0 + c0 + c, gh = h0 + h;
        xt[c][h] = (gr < R && gh < H) ? x[static_cast<long>(gr) * H + gh] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&xt[kk][hg * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&xt[kk][128 + hg * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&gs[c0 + kk][vg * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&gs[c0 + kk][32 + vg * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gh = h0 + (i < 4 ? hg * 4 + i : 128 + hg * 4 + (i - 4));
    if (gh >= H) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gv = v0 + (j < 4 ? vg * 4 + j : 32 + vg * 4 + (j - 4));
      if (gv < V) dw[static_cast<long>(gh) * V + gv] = acc[i][j];
    }
  }
}

// ---- backward with operands resident in shared memory (H <= kResidentH) ----
// The kernels above stage 16-deep slices of x and w through shared memory
// with two barriers per slice, and at 8 warps an SM each slice waits out a
// round trip to L2.  Below, a block keeps its fixed operand (dx: the x row
// tile; dw: the w vocab tile) in shared memory for its whole life and loads
// the other one whole per tile, so the logits tile is computed with no
// barrier inside the H loop; and each block owns all of H, so the logits
// are recomputed once per (row tile, vocab tile) instead of once per H slice.

constexpr int kResidentH = 512;

// Bulk tile loads go through cp.async: every element's copy is in flight
// at once, where a load-then-store loop keeps one a thread in flight.  A
// masked element copies 0 bytes and zero-fills (its source pointer is
// still a valid address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// z[2][4] for rows ty 2 .. ty 2 + 1 and columns tx 4 .. tx 4 + 3 of a
// [32, 64] tile: xs is x^T [H][32 + PAD], ws is w [H][64 + PAD]
__device__ __forceinline__ void resident_logits_32x64(const float* xs,
                                                      const float* ws, int H,
                                                      int ty, int tx,
                                                      float (&z)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) z[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < H; ++k) {
    const float2 a = *reinterpret_cast<const float2*>(&xs[k * (32 + PAD) + ty * 2]);
    const float4 b = *reinterpret_cast<const float4*>(&ws[k * (BV + PAD) + tx * 4]);
    const float av[2] = {a.x, a.y};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) z[i][j] = fmaf(av[i], bv[j], z[i][j]);
  }
}

// x rows [r0, r0 + 32) into xs[k][r] (x^T), zeros past R; the caller
// waits (cp_async_wait_all) and synchronizes before reading
__device__ __forceinline__ void load_x_tile(const float* __restrict__ x,
                                            float* xs, int R, int H, int r0) {
  for (int i = threadIdx.x; i < 32 * H; i += kThreads) {
    const int r = i / H, k = i % H;  // neighbouring threads: neighbouring k
    const int gr = r0 + r;
    cp_async4(&xs[k * (32 + PAD) + r],
              x + (gr < R ? static_cast<long>(gr) * H + k : 0), gr < R);
  }
}

// w[:, v0 : v0 + n] into ws[k][c] (row stride n + PAD), zeros past V
__device__ __forceinline__ void load_w_tile(const float* __restrict__ w,
                                            float* ws, int H, int V, int v0,
                                            int n) {
  for (int i = threadIdx.x; i < H * n; i += kThreads) {
    const int k = i / n, c = i % n;  // neighbouring threads: neighbouring v
    const int gv = v0 + c;
    cp_async4(&ws[k * (n + PAD) + c],
              w + (gv < V ? static_cast<long>(k) * V + gv : 0), gv < V);
  }
}

// one block per 32-row tile, all of H: dx[r0:r0+32, :] = g @ w^T
__global__ void __launch_bounds__(kThreads) lxent_dx_resident_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const long long* __restrict__ labels, const float* __restrict__ vld,
    const float* __restrict__ lse, const float* __restrict__ dy,
    float* __restrict__ dx, int R, int H, int V, int VT, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // [H][32 + PAD], x^T, resident
  float* ws = xs + H * (32 + PAD);           // [H][64 + PAD], w vocab tile
  float* gs = ws + H * (BV + PAD);           // [32][64 + PAD], g tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;    // logits tile layout
  const int rg = tid / 32, lane = tid % 32;  // dx: rows rg 4 .., h = lane + 32 j
  const int r0 = blockIdx.x * 32;
  const float inv_v = 1.f / static_cast<float>(VT);
  long long lbl[2];
  float rl[2], rdy[2];
  bool rvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = r0 + ty * 2 + i;
    lbl[i] = gr < R ? labels[gr] : -1;
    rl[i] = gr < R ? lse[gr] : 0.f;
    rdy[i] = gr < R ? dy[gr] : 0.f;
    rvalid[i] = gr < R && row_valid(vld, gr, lbl[i], V);
  }
  load_x_tile(x, xs, R, H, r0);  // waited for with the first w tile
  float acc[4][kResidentH / 32];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kResidentH / 32; ++j) acc[i][j] = 0.f;
  const int n_vt = (V + BV - 1) / BV;
  for (int t = 0; t < n_vt; ++t) {
    const int v0 = t * BV;
    __syncthreads();  // the last tile's readers of ws and gs are done
    load_w_tile(w, ws, H, V, v0, BV);
    cp_async_wait_all();
    __syncthreads();
    float z[2][4];
    resident_logits_32x64(xs, ws, H, ty, tx, z);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float gv4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gv = v0 + tx * 4 + j;
        gv4[j] = gv < V ? grad_elem(z[i][j], rl[i], rdy[i], rvalid[i],
                                    gv == lbl[i], eps, inv_v)
                        : 0.f;
      }
      *reinterpret_cast<float4*>(&gs[(ty * 2 + i) * (BV + PAD) + tx * 4]) =
          make_float4(gv4[0], gv4[1], gv4[2], gv4[3]);
    }
    __syncthreads();
    // acc[i][j] += sum over the tile's v of g[rg 4 + i][v] w[lane + 32 j][v],
    // v ascending
    for (int c = 0; c < BV; c += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&gs[(rg * 4 + i) * (BV + PAD) + c]);
#pragma unroll
      for (int j = 0; j < kResidentH / 32; ++j) {
        const int h = lane + 32 * j;
        if (h < H) {
          const float4 b = *reinterpret_cast<const float4*>(&ws[h * (BV + PAD) + c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float s = acc[i][j];
            s = fmaf(a[i].x, b.x, s);
            s = fmaf(a[i].y, b.y, s);
            s = fmaf(a[i].z, b.z, s);
            s = fmaf(a[i].w, b.w, s);
            acc[i][j] = s;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = r0 + rg * 4 + i;
    if (gr >= R) continue;
#pragma unroll
    for (int j = 0; j < kResidentH / 32; ++j) {
      const int h = lane + 32 * j;
      if (h < H) dx[static_cast<long>(gr) * H + h] = acc[i][j];
    }
  }
}

constexpr int BVW = 32;  // vocab columns per dw block

// one block per 32-column vocab tile, all of H: dw[:, v0:v0+32] = x^T @ g
__global__ void __launch_bounds__(kThreads) lxent_dw_resident_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const long long* __restrict__ labels, const float* __restrict__ vld,
    const float* __restrict__ lse, const float* __restrict__ dy,
    float* __restrict__ dw, int R, int H, int V, int VT, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                  // [H][32 + PAD], w vocab tile, resident
  float* xbuf = ws + H * (BVW + PAD);  // 2 x [H][32 + PAD], x^T row tiles
  float* gt = xbuf + 2 * H * (32 + PAD);  // [32 v][32 + PAD], g^T tile
  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;        // logits: row ty, cols tx 4 ..
  const int vg = tid / 64, hl = tid % 64;      // dw: v vg 8 .., h = hl + 64 j
  const int v0 = blockIdx.x * BVW;
  const float inv_v = 1.f / static_cast<float>(VT);
  load_w_tile(w, ws, H, V, v0, BVW);  // waited for with the first x tile
  load_x_tile(x, xbuf, R, H, 0);
  float acc[kResidentH / 64][8];
#pragma unroll
  for (int j = 0; j < kResidentH / 64; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0.f;
  const int n_rt = (R + 31) / 32;
  for (int rt = 0; rt < n_rt; ++rt) {
    const int r0 = rt * 32;
    const float* xs = xbuf + (rt & 1) * H * (32 + PAD);
    cp_async_wait_all();  // this row tile's x has landed
    __syncthreads();      // ... for every thread; the last tile's readers are done
    if (rt + 1 < n_rt)    // the next row tile's x lands while this one computes
      load_x_tile(x, xbuf + ((rt + 1) & 1) * H * (32 + PAD), R, H, r0 + 32);
    float z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float a = xs[k * (32 + PAD) + ty];
      const float4 b = *reinterpret_cast<const float4*>(&ws[k * (BVW + PAD) + tx * 4]);
      z[0] = fmaf(a, b.x, z[0]);
      z[1] = fmaf(a, b.y, z[1]);
      z[2] = fmaf(a, b.z, z[2]);
      z[3] = fmaf(a, b.w, z[3]);
    }
    {
      const int gr = r0 + ty;
      const bool row = gr < R;  // the row tail gives zero
      const long long lbl = row ? labels[gr] : -1;
      const float rl = row ? lse[gr] : 0.f;
      const float rdy = row ? dy[gr] : 0.f;
      const bool valid = row && row_valid(vld, gr, lbl, V);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gv = v0 + tx * 4 + j;
        gt[(tx * 4 + j) * (32 + PAD) + ty] =
            (row && gv < V) ? grad_elem(z[j], rl, rdy, valid, gv == lbl, eps, inv_v)
                            : 0.f;
      }
    }
    __syncthreads();
    // acc[j][i] += sum over the tile's rows r of x[r][hl + 64 j] g[r][vg 8 + i],
    // r ascending
    for (int c = 0; c < 32; c += 4) {
      float4 b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        b[i] = *reinterpret_cast<const float4*>(&gt[(vg * 8 + i) * (32 + PAD) + c]);
#pragma unroll
      for (int j = 0; j < kResidentH / 64; ++j) {
        const int h = hl + 64 * j;
        if (h < H) {
          const float4 a = *reinterpret_cast<const float4*>(&xs[h * (32 + PAD) + c]);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float s = acc[j][i];
            s = fmaf(a.x, b[i].x, s);
            s = fmaf(a.y, b[i].y, s);
            s = fmaf(a.z, b[i].z, s);
            s = fmaf(a.w, b[i].w, s);
            acc[j][i] = s;
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kResidentH / 64; ++j) {
    const int h = hl + 64 * j;
    if (h >= H) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gv = v0 + vg * 8 + i;
      if (gv < V) dw[static_cast<long>(h) * V + gv] = acc[j][i];
    }
  }
}

size_t dx_resident_smem(int H) {
  return sizeof(float) * (static_cast<size_t>(H) * (32 + PAD + BV + PAD) +
                          32 * (BV + PAD));
}

size_t dw_resident_smem(int H) {
  return sizeof(float) * (static_cast<size_t>(H) * (BVW + PAD + 2 * (32 + PAD)) +
                          BVW * (32 + PAD));
}

// the forward's streaming pass over the vocab splits; returns the split
// count used (every used split has a tile)
int launch_fwd_parts(const float* x, const float* w, const long long* labels,
                     float* workspace, int R, int H, int V, int splits,
                     cudaStream_t stream) {
  const int n_vt = (V + BV - 1) / BV;
  const int per = (n_vt + splits - 1) / splits;  // tiles per split
  const int used = (n_vt + per - 1) / per;
  lxent_fwd_kernel<<<dim3((R + 63) / 64, used), kThreads, 0, stream>>>(
      x, w, labels, workspace, R, H, V, per);
  return used;
}

int launch_dx(const float* x, const float* w, const long long* labels,
              const float* vld, const float* lse, const float* dy, float* dx,
              int R, int H, int V, int VT, float eps, cudaStream_t stream) {
  if (R == 0 || H == 0) return static_cast<int>(cudaSuccess);
  if (V <= 0 || VT <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (H <= kResidentH) {
    const size_t smem = dx_resident_smem(H);
    // the dynamic shared-memory limit is raised once, at the first launch
    // (outside any CUDA-graph capture in this package's use)
    static const cudaError_t raised = cudaFuncSetAttribute(
        lxent_dx_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dx_resident_smem(kResidentH)));
    if (raised != cudaSuccess) return static_cast<int>(raised);
    lxent_dx_resident_kernel<<<(R + 31) / 32, kThreads, smem, stream>>>(
        x, w, labels, vld, lse, dy, dx, R, H, V, VT, eps);
  } else {
    lxent_dx_kernel<<<dim3((R + 31) / 32, (H + HS - 1) / HS), kThreads, 0, stream>>>(
        x, w, labels, vld, lse, dy, dx, R, H, V, VT, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_dw(const float* x, const float* w, const long long* labels,
              const float* vld, const float* lse, const float* dy, float* dw,
              int R, int H, int V, int VT, float eps, cudaStream_t stream) {
  if (H == 0 || V == 0) return static_cast<int>(cudaSuccess);
  if (VT <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaMemsetAsync(
      dw, 0, sizeof(float) * static_cast<size_t>(H) * V, stream));
  if (H <= kResidentH) {
    const size_t smem = dw_resident_smem(H);
    // the dynamic shared-memory limit is raised once, at the first launch
    // (outside any CUDA-graph capture in this package's use)
    static const cudaError_t raised = cudaFuncSetAttribute(
        lxent_dw_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dw_resident_smem(kResidentH)));
    if (raised != cudaSuccess) return static_cast<int>(raised);
    lxent_dw_resident_kernel<<<(V + BVW - 1) / BVW, kThreads, smem, stream>>>(
        x, w, labels, vld, lse, dy, dw, R, H, V, VT, eps);
  } else {
    lxent_dw_kernel<<<dim3((V + BV - 1) / BV, (H + HS - 1) / HS), kThreads, 0, stream>>>(
        x, w, labels, vld, lse, dy, dw, R, H, V, VT, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// workspace: [splits, 4, R] floats
extern "C" int ptt_linear_xent_fwd(const float* x, const float* w,
                                   const long long* labels, float* loss,
                                   float* lse, float* workspace, int R, int H,
                                   int V, int splits, float eps,
                                   cudaStream_t stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  if (H <= 0 || V <= 0 || splits <= 0 || workspace == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int used = launch_fwd_parts(x, w, labels, workspace, R, H, V, splits, stream);
  lxent_fwd_combine<<<(R + 255) / 256, 256, 0, stream>>>(workspace, labels, loss,
                                                          lse, R, V, used, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptt_linear_xent_dx(const float* x, const float* w,
                                  const long long* labels, const float* lse,
                                  const float* dy, float* dx, int R, int H,
                                  int V, float eps, cudaStream_t stream) {
  return launch_dx(x, w, labels, nullptr, lse, dy, dx, R, H, V, V, eps, stream);
}

extern "C" int ptt_linear_xent_dw(const float* x, const float* w,
                                  const long long* labels, const float* lse,
                                  const float* dy, float* dw, int R, int H,
                                  int V, float eps, cudaStream_t stream) {
  return launch_dw(x, w, labels, nullptr, lse, dy, dw, R, H, V, V, eps, stream);
}

// one vocab shard's parts: w is the [H, V] slab, labels local; lse, gold
// and sum [R]; workspace [splits, 4, R] floats
extern "C" int ptt_linear_xent_parts(const float* x, const float* w,
                                     const long long* labels, float* lse,
                                     float* gold, float* sum, float* workspace,
                                     int R, int H, int V, int splits,
                                     cudaStream_t stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  if (H <= 0 || V <= 0 || splits <= 0 || workspace == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int used = launch_fwd_parts(x, w, labels, workspace, R, H, V, splits, stream);
  lxent_parts_combine<<<(R + 255) / 256, 256, 0, stream>>>(workspace, lse, gold,
                                                            sum, R, used);
  return static_cast<int>(cudaGetLastError());
}

// one vocab shard's dx partial / dw slab: valid [R] from the global labels,
// vocab_total the whole vocab
extern "C" int ptt_linear_xent_dx_sharded(const float* x, const float* w,
                                          const long long* labels,
                                          const float* valid, const float* lse,
                                          const float* dy, float* dx, int R,
                                          int H, int V, int vocab_total,
                                          float eps, cudaStream_t stream) {
  if (valid == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dx(x, w, labels, valid, lse, dy, dx, R, H, V, vocab_total, eps,
                   stream);
}

extern "C" int ptt_linear_xent_dw_sharded(const float* x, const float* w,
                                          const long long* labels,
                                          const float* valid, const float* lse,
                                          const float* dy, float* dw, int R,
                                          int H, int V, int vocab_total,
                                          float eps, cudaStream_t stream) {
  if (valid == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dw(x, w, labels, valid, lse, dy, dw, R, H, V, vocab_total, eps,
                   stream);
}
