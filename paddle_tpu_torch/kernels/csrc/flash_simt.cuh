// The SIMT form of the flash-attention tile kernels (flash_attention.cu's
// header comment sets out the contract, the masks and both forms), and the
// mask helpers the tensor-core forms share: included by flash_attention.cu
// (float32 operands) and flash_attention_bf16.cu (bf16 q, k, v, dO and
// outputs, widened to float32 as they are staged, every sum in float32,
// each output rounded once).  The key bias, lse and delta are float32 in
// both.
#pragma once

#include "bf16_mma.cuh"
#include "common.cuh"

namespace {

using ptt::comp;

// ---- SIMT form (d 128) ----------------------------------------------------------
constexpr int kThreads = 256;
constexpr int BQ = 64;  // query rows of the forward and dq tiles
constexpr int BK = 64;  // keys of every key tile

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 4 consecutive elements of a global operand as floats (8-byte aligned in
// bf16), and 4 floats stored as the output type, rounded once
__device__ __forceinline__ float4 ldg4(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 ldg4(const ptt::bf16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(ptt::bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(ptt::pack2(v.x, v.y), ptt::pack2(v.z, v.w));
}

// rows [r0, r0 + rows) of a [T, D] matrix (float32 or bf16, widened) into
// dst[D][rows] (transposed), times `mul`; rows at or past T read as zero.
// Consecutive threads take consecutive rows, so the shared-memory stores
// hit distinct banks.
template <int D, class E>
__device__ __forceinline__ void load_t(float* dst, const E* src, int r0,
                                       int rows, int T, float mul) {
  for (int i = threadIdx.x; i < rows * (D / 4); i += kThreads) {
    const int r = i % rows, c4 = i / rows;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) val = ldg4(src + static_cast<long>(r0 + r) * D + c4 * 4);
    dst[(c4 * 4 + 0) * rows + r] = val.x * mul;
    dst[(c4 * 4 + 1) * rows + r] = val.y * mul;
    dst[(c4 * 4 + 2) * rows + r] = val.z * mul;
    dst[(c4 * 4 + 3) * rows + r] = val.w * mul;
  }
}

// rows [r0, r0 + rows) of a [T, D] matrix into dst[rows][D] (row-major,
// float32).
template <int D, class E>
__device__ __forceinline__ void load_rows(float* dst, const E* src, int r0,
                                          int rows, int T) {
  for (int i = threadIdx.x; i < rows * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c4 = i % (D / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) val = ldg4(src + static_cast<long>(r0 + r) * D + c4 * 4);
    *reinterpret_cast<float4*>(dst + r * D + c4 * 4) = val;
  }
}

// the number of key tiles of `bk` keys a query tile [q0, q0 + rows) of a
// row with query base qpos0 reads: with causal masking none past the
// global position of its last query (the _band block skip)
__device__ __forceinline__ int key_tiles(int q0, int rows, int Tq, int Tk, bool causal,
                                         int qpos0, int bk) {
  const int nk = (Tk + bk - 1) / bk;
  if (!causal) return nk;
  const int last = qpos0 + min(q0 + rows, Tq) - 1;
  if (last < 0) return 0;
  return min(nk, last / bk + 1);
}

// the first key tile of `bk` keys a query tile [q0, ...) of a row with
// query base qpos0 reads: under a window none before its first query's
// first visible key (the _band window skip; clamped before dividing, as C
// division truncates toward zero)
__device__ __forceinline__ int first_key_tile(int q0, int window, int qpos0, int bk) {
  const long first = static_cast<long>(qpos0) + q0 - window + 1;
  return (window <= 0 || first <= 0) ? 0 : static_cast<int>(first / bk);
}

// the visibility of key `key` to the query at global position qpos with
// segment ids sq, sk: in range, causal, in the window, in the segment
__device__ __forceinline__ bool visible(int key, int Tk, int qpos, bool causal,
                                        int window, const int* seg, int sq, int sk) {
  return key < Tk && (!causal || key <= qpos) &&
         (window <= 0 || static_cast<long>(qpos) - key < window) &&
         (seg == nullptr || sq == sk);
}

// a segment tile: ids [r0, r0 + n) of a row into dst (0 past T or without ids)
__device__ __forceinline__ void load_seg(int* dst, const int* seg, int r0, int n, int T) {
  if (threadIdx.x < n) {
    const int r = r0 + threadIdx.x;
    dst[threadIdx.x] = (seg != nullptr && r < T) ? seg[r] : 0;
  }
}

// the row's query base: qbase[bh * qstride], or 0 without one
__device__ __forceinline__ int query_base(const int* qbase, int qstride, int bh) {
  return qbase != nullptr ? qbase[static_cast<long>(bh) * qstride] : 0;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
template <int D, class E, class EK = E>
__global__ void __launch_bounds__(kThreads) simt_fwd_kernel(
    const E* __restrict__ q, const EK* __restrict__ k,
    const EK* __restrict__ v, const float* __restrict__ kb,
    const int* __restrict__ qbase, E* __restrict__ o,
    float* __restrict__ lse, int Tq, int Tk, bool causal, int qstride,
    float scale, int window, const int* __restrict__ seg) {
  constexpr int G = D / 64;  // column groups of 64: thread columns g*64 + tx*4 + e
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][BQ], q * scale
  float* Kt = Qt + D * BQ;                      // [D][BK]
  float* Vs = Kt + D * BK;                      // [BK][D]
  float* Ps = Vs + BK * D;                      // [BQ][BK]
  __shared__ float kbs[BK];
  __shared__ int segq[BQ], segk[BK];
  const int bh = blockIdx.x;
  const int nq = gridDim.y;
  const int q0 = (causal ? nq - 1 - blockIdx.y : blockIdx.y) * BQ;  // heavy tiles first
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qpos0 = query_base(qbase, qstride, bh);
  const E* qb = q + static_cast<long>(bh) * Tq * D;
  const EK* kbase = k + static_cast<long>(bh) * Tk * D;
  const EK* vbase = v + static_cast<long>(bh) * Tk * D;
  const int* segb = seg != nullptr ? seg + static_cast<long>(bh) * Tk : nullptr;

  load_t<D>(Qt, qb, q0, BQ, Tq, scale);
  load_seg(segq, segb, q0, BQ, Tq);
  float acc[4][4 * G], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = ptt::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = key_tiles(q0, BQ, Tq, Tk, causal, qpos0, BK);
  for (int kt = first_key_tile(q0, window, qpos0, BK); kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q is staged; the previous tile's K, V, P are consumed
    load_t<D>(Kt, kbase, k0, BK, Tk, 1.f);
    load_rows<D>(Vs, vbase, k0, BK, Tk);
    if (threadIdx.x < BK) {
      const int j = k0 + threadIdx.x;
      kbs[threadIdx.x] = (kb != nullptr && j < Tk) ? kb[static_cast<long>(bh) * Tk + j] : 0.f;
    }
    load_seg(segk, segb, k0, BK, Tk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float4 a = ld4(Qt + c * BQ + ty * 4);
      const float4 b = ld4(Kt + c * BK + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(comp(a, i), comp(b, j), s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qrow = q0 + ty * 4 + i;
      const int qpos = qpos0 + qrow;
      bool valid[4];
      float mx = ptt::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        valid[j] = visible(key, Tk, qpos, causal, window, segb, segq[ty * 4 + i],
                           segk[tx * 4 + j]);
        s[i][j] = valid[j] ? s[i][j] + kbs[tx * 4 + j] : ptt::kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float p[4], psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p[j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(Ps + (ty * 4 + i) * BK + tx * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int j4 = 0; j4 < BK / 4; ++j4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = ld4(Ps + (ty * 4 + i) * BK + j4 * 4);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 b = ld4(Vs + (j4 * 4 + jj) * D + g * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][g * 4 + e] = fmaf(comp(pa[i], jj), comp(b, e), acc[i][g * 4 + e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + ty * 4 + i;
    if (qrow >= Tq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    E* orow = o + (static_cast<long>(bh) * Tq + qrow) * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float4 out;
      out.x = acc[i][g * 4 + 0] / safe_l;
      out.y = acc[i][g * 4 + 1] / safe_l;
      out.z = acc[i][g * 4 + 2] / safe_l;
      out.w = acc[i][g * 4 + 3] / safe_l;
      st4(orow + g * 64 + tx * 4, out);
    }
    if (tx == 0) lse[static_cast<long>(bh) * Tq + qrow] = m[i] + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------
template <int D, class E>
__global__ void __launch_bounds__(kThreads) simt_dq_kernel(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const float* __restrict__ kb,
    const float* __restrict__ lse, const E* __restrict__ dout,
    const float* __restrict__ delta, const int* __restrict__ qbase,
    E* __restrict__ dq, int Tq, int Tk, bool causal, int qstride,
    float scale, int window, const int* __restrict__ seg) {
  constexpr int G = D / 64;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][BQ]
  float* dOt = Qt + D * BQ;                     // [D][BQ]
  float* Kt = dOt + D * BQ;                     // [D][BK]
  float* Vt = Kt + D * BK;                      // [D][BK]
  float* Ks = Vt + D * BK;                      // [BK][D]
  float* dSs = Ks + BK * D;                     // [BQ][BK]
  __shared__ float kbs[BK];
  __shared__ int segq[BQ], segk[BK];
  const int bh = blockIdx.x;
  const int nq = gridDim.y;
  const int q0 = (causal ? nq - 1 - blockIdx.y : blockIdx.y) * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long qoff = static_cast<long>(bh) * Tq;
  const int qpos0 = query_base(qbase, qstride, bh);
  const E* kbase = k + static_cast<long>(bh) * Tk * D;
  const E* vbase = v + static_cast<long>(bh) * Tk * D;
  const int* segb = seg != nullptr ? seg + static_cast<long>(bh) * Tk : nullptr;

  load_t<D>(Qt, q + qoff * D, q0, BQ, Tq, 1.f);
  load_t<D>(dOt, dout + qoff * D, q0, BQ, Tq, 1.f);
  load_seg(segq, segb, q0, BQ, Tq);
  float lse_r[4], delta_r[4], acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + ty * 4 + i;
    lse_r[i] = qrow < Tq ? lse[qoff + qrow] : 0.f;
    delta_r[i] = qrow < Tq ? delta[qoff + qrow] : 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = key_tiles(q0, BQ, Tq, Tk, causal, qpos0, BK);
  for (int kt = first_key_tile(q0, window, qpos0, BK); kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_t<D>(Kt, kbase, k0, BK, Tk, 1.f);
    load_t<D>(Vt, vbase, k0, BK, Tk, 1.f);
    load_rows<D>(Ks, kbase, k0, BK, Tk);
    if (threadIdx.x < BK) {
      const int j = k0 + threadIdx.x;
      kbs[threadIdx.x] = (kb != nullptr && j < Tk) ? kb[static_cast<long>(bh) * Tk + j] : 0.f;
    }
    load_seg(segk, segb, k0, BK, Tk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float4 a = ld4(Qt + c * BQ + ty * 4);
      const float4 b = ld4(Kt + c * BK + tx * 4);
      const float4 a2 = ld4(dOt + c * BQ + ty * 4);
      const float4 b2 = ld4(Vt + c * BK + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(comp(a, i), comp(b, j), s[i][j]);
          dp[i][j] = fmaf(comp(a2, i), comp(b2, j), dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qrow = q0 + ty * 4 + i;
      const bool live = lse_r[i] > ptt::kNegInf / 2;
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        const bool valid = live && visible(key, Tk, qpos0 + qrow, causal, window, segb,
                                           segq[ty * 4 + i], segk[tx * 4 + j]);
        const float p = valid ? expf(s[i][j] * scale + kbs[tx * 4 + j] - lse_r[i]) : 0.f;
        ds[j] = p * (dp[i][j] - delta_r[i]);
      }
      *reinterpret_cast<float4*>(dSs + (ty * 4 + i) * BK + tx * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int j4 = 0; j4 < BK / 4; ++j4) {
      float4 da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = ld4(dSs + (ty * 4 + i) * BK + j4 * 4);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 b = ld4(Ks + (j4 * 4 + jj) * D + g * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][g * 4 + e] = fmaf(comp(da[i], jj), comp(b, e), acc[i][g * 4 + e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + ty * 4 + i;
    if (qrow >= Tq) continue;
    E* row = dq + (qoff + qrow) * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 out = make_float4(acc[i][g * 4 + 0] * scale, acc[i][g * 4 + 1] * scale,
                                     acc[i][g * 4 + 2] * scale, acc[i][g * 4 + 3] * scale);
      st4(row + g * 64 + tx * 4, out);
    }
  }
}

// ---------------------------------------------------------------------------
// dk / dv / dkb: one block per (bh, 64-key tile), query tiles of QB rows
// ---------------------------------------------------------------------------
template <int D, int QB, class E>
__global__ void __launch_bounds__(kThreads) simt_dkv_kernel(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const float* __restrict__ kb,
    const float* __restrict__ lse, const E* __restrict__ dout,
    const float* __restrict__ delta, const int* __restrict__ qbase,
    E* __restrict__ dk, E* __restrict__ dv, float* __restrict__ dkb,
    int Tq, int Tk, bool causal, int qstride, float scale, int window,
    const int* __restrict__ seg) {
  constexpr int G = D / 64;
  constexpr int QPT = QB / 16;  // queries of the score tile per thread
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // [D][BK]
  float* Vt = Kt + D * BK;                      // [D][BK]
  float* Qt = Vt + D * BK;                      // [D][QB]
  float* dOt = Qt + D * QB;                     // [D][QB]
  float* Qs = dOt + D * QB;                     // [QB][D]
  float* dOs = Qs + QB * D;                     // [QB][D]
  float* PTs = dOs + QB * D;                    // [BK][QB]
  float* dSTs = PTs + BK * QB;                  // [BK][QB]
  __shared__ float lse_s[QB], delta_s[QB];
  __shared__ int segq[QB];
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long qoff = static_cast<long>(bh) * Tq;
  const long koff = static_cast<long>(bh) * Tk;
  const int qpos0 = query_base(qbase, qstride, bh);
  const E* qrows = q + qoff * D;
  const E* obase = dout + qoff * D;
  const int* segb = seg != nullptr ? seg + koff : nullptr;

  load_t<D>(Kt, k + koff * D, k0, BK, Tk, 1.f);
  load_t<D>(Vt, v + koff * D, k0, BK, Tk, 1.f);
  float kbv[4], dkb_acc[4], dk_acc[4][4 * G], dv_acc[4][4 * G];
  int segk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    kbv[i] = (kb != nullptr && key < Tk) ? kb[koff + key] : 0.f;
    segk[i] = (segb != nullptr && key < Tk) ? segb[key] : 0;
    dkb_acc[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }

  const int nqt = (Tq + QB - 1) / QB;
  // causal: a query tile whose last query (global position qpos0 + q0 +
  // QB - 1) comes before this key tile sees none of it
  const int qt_start = causal ? max(0, (k0 - qpos0) / QB) : 0;
  // window: the query tiles from the first whose first query (global
  // position qpos0 + q0) is at or past k0 + BK - 1 + window see none of it
  int qt_end = nqt;
  if (window > 0) {
    const long lim = static_cast<long>(k0) + BK - 1 + window - qpos0;
    const long tiles = lim <= 0 ? 0 : (lim + QB - 1) / QB;
    qt_end = tiles < nqt ? static_cast<int>(tiles) : nqt;
  }
  for (int qt = qt_start; qt < qt_end; ++qt) {
    const int q0 = qt * QB;
    __syncthreads();  // K, V are staged; the previous query tile is consumed
    load_t<D>(Qt, qrows, q0, QB, Tq, 1.f);
    load_t<D>(dOt, obase, q0, QB, Tq, 1.f);
    load_rows<D>(Qs, qrows, q0, QB, Tq);
    load_rows<D>(dOs, obase, q0, QB, Tq);
    if (threadIdx.x < QB) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < Tq ? lse[qoff + r] : 0.f;
      delta_s[threadIdx.x] = r < Tq ? delta[qoff + r] : 0.f;
    }
    load_seg(segq, segb, q0, QB, Tq);
    __syncthreads();

    float st[4][QPT], dpt[4][QPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < QPT; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float4 a = ld4(Kt + c * BK + ty * 4);
      const float4 a2 = ld4(Vt + c * BK + ty * 4);
      float b[QPT], b2[QPT];
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        b[j] = Qt[c * QB + tx * QPT + j];
        b2[j] = dOt[c * QB + tx * QPT + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < QPT; ++j) {
          st[i][j] = fmaf(comp(a, i), b[j], st[i][j]);
          dpt[i][j] = fmaf(comp(a2, i), b2[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty * 4 + i;
      float p[QPT], ds[QPT];
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const int rl = tx * QPT + j;
        const int qrow = q0 + rl;
        const float lse_v = lse_s[rl];
        const bool valid = qrow < Tq && lse_v > ptt::kNegInf / 2 &&
                           visible(key, Tk, qpos0 + qrow, causal, window, segb, segq[rl],
                                   segk[i]);
        p[j] = valid ? expf(st[i][j] * scale + kbv[i] - lse_v) : 0.f;
        ds[j] = p[j] * (dpt[i][j] - delta_s[rl]);
        dkb_acc[i] += ds[j];
      }
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        PTs[(ty * 4 + i) * QB + tx * QPT + j] = p[j];
        dSTs[(ty * 4 + i) * QB + tx * QPT + j] = ds[j];
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int r4 = 0; r4 < QB / 4; ++r4) {
      float4 pa[4], da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = ld4(PTs + (ty * 4 + i) * QB + r4 * 4);
        da[i] = ld4(dSTs + (ty * 4 + i) * QB + r4 * 4);
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int r = r4 * 4 + rr;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 bo = ld4(dOs + r * D + g * 64 + tx * 4);
          const float4 bq = ld4(Qs + r * D + g * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dv_acc[i][g * 4 + e] = fmaf(comp(pa[i], rr), comp(bo, e), dv_acc[i][g * 4 + e]);
              dk_acc[i][g * 4 + e] = fmaf(comp(da[i], rr), comp(bq, e), dk_acc[i][g * 4 + e]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    const float col = half_warp_sum(dkb_acc[i]);  // every lane: all 16 query lanes
    if (key >= Tk) continue;
    E* dkrow = dk + (koff + key) * D;
    E* dvrow = dv + (koff + key) * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      st4(dkrow + g * 64 + tx * 4,
          make_float4(dk_acc[i][g * 4 + 0] * scale, dk_acc[i][g * 4 + 1] * scale,
                      dk_acc[i][g * 4 + 2] * scale, dk_acc[i][g * 4 + 3] * scale));
      st4(dvrow + g * 64 + tx * 4,
          make_float4(dv_acc[i][g * 4 + 0], dv_acc[i][g * 4 + 1],
                      dv_acc[i][g * 4 + 2], dv_acc[i][g * 4 + 3]));
    }
    if (dkb != nullptr && tx == 0) dkb[koff + key] = col;
  }
}

// entries [r0, r0 + R) of a [T] vector of 4-byte values into shared
// memory by cp.async (zero past T); nothing without one
template <int R>
__device__ __forceinline__ void stage_vec(float* dst, const void* src, int r0, int T) {
  if (src != nullptr && threadIdx.x < R) {
    const int r = r0 + threadIdx.x;
    ptt::cp_async4_b(dst + threadIdx.x, static_cast<const float*>(src) + (r < T ? r : 0),
                     r < T);
  }
}

// Dynamic shared memory above 48 KB must be opted into once per kernel.
template <typename K>
int prepare(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// EK: the type of k and v (bf16 beside a float32 q in the forward's
// bf16-KV form; E otherwise)
template <int D, class E, class EK = E>
int launch_simt_fwd(const E* q, const EK* k, const EK* v, const float* kb,
               const int* qbase, E* o, float* lse, int BH, int Tq, int Tk,
               bool causal, int qstride, float scale, int window, const int* seg,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * D * 64 + 64 * D + 64 * 64);
  static int ready = prepare(simt_fwd_kernel<D, E, EK>, smem);
  if (ready != 0) return ready;
  const dim3 grid(BH, (Tq + BQ - 1) / BQ);
  simt_fwd_kernel<D, E, EK><<<grid, kThreads, smem, stream>>>(q, k, v, kb, qbase, o, lse, Tq,
                                                   Tk, causal, qstride, scale, window,
                                                   seg);
  return static_cast<int>(cudaGetLastError());
}

template <int D, class E>
int launch_simt_dq(const E* q, const E* k, const E* v, const float* kb,
              const float* lse, const E* dout, const float* delta,
              const int* qbase, E* dq, int BH, int Tq, int Tk, bool causal,
              int qstride, float scale, int window, const int* seg,
              cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * D * 64 + 64 * D + 64 * 64);
  static int ready = prepare(simt_dq_kernel<D, E>, smem);
  if (ready != 0) return ready;
  const dim3 grid(BH, (Tq + BQ - 1) / BQ);
  simt_dq_kernel<D, E><<<grid, kThreads, smem, stream>>>(q, k, v, kb, lse, dout, delta,
                                                  qbase, dq, Tq, Tk, causal,
                                                  qstride, scale, window, seg);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int QB, class E>
int launch_simt_dkv(const E* q, const E* k, const E* v, const float* kb,
               const float* lse, const E* dout, const float* delta,
               const int* qbase, E* dk, E* dv, float* dkb, int BH,
               int Tq, int Tk, bool causal, int qstride, float scale, int window,
               const int* seg, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * D * BK + 4 * D * QB + 2 * BK * QB);
  static int ready = prepare(simt_dkv_kernel<D, QB, E>, smem);
  if (ready != 0) return ready;
  const dim3 grid(BH, (Tk + BK - 1) / BK);
  simt_dkv_kernel<D, QB, E><<<grid, kThreads, smem, stream>>>(
      q, k, v, kb, lse, dout, delta, qbase, dk, dv, dkb, Tq, Tk, causal, qstride,
      scale, window, seg);
  return static_cast<int>(cudaGetLastError());
}

// The operands the three kernels take: causal without a query base needs
// Tq == Tk; a window (0: none) needs causal; segment ids need Tq == Tk and
// no query base.
bool bad_operands(const int* qbase, int Tq, int Tk, int causal, int qstride, int window,
                  const int* seg) {
  return (causal && qbase == nullptr && Tq != Tk) || qstride < 0 || window < 0 ||
         (window > 0 && !causal) || (seg != nullptr && (qbase != nullptr || Tq != Tk));
}

// A kernel's form (flash_plan in flash_attention.py, the same rule for
// both dtypes): 1, the tensor-core kernel, at d 64; 0, the SIMT kernel, at
// d 128, and for dq at d 64 with at most 64 queries and 64 keys.
bool bad_form(int form, int d, int Tq, int Tk, bool dq) {
  if (form == 1) return d != 64;
  return form != 0 || !(d == 128 || (dq && d == 64 && Tq <= 64 && Tk <= 64));
}

}  // namespace
