// flash_attention: blocked online-softmax attention over q [BH, Tq, d] and
// k, v [BH, Tk, d], float32, with an optional additive key bias kb [BH, Tk]
// and causal masking (Tq == Tk, query i sees keys 0 .. i).  Three kernels:
//
//   forward  o = softmax(q k^T * scale + kb) v, and lse [BH, Tq], the row
//            log-sum-exp the backward rebuilds the probabilities from;
//   dq       dq = scale * dS k,        dS = P * (dO v^T - delta);
//   dk/dv    dk = scale * dS^T q,  dv = P^T dO,  dkb = column sums of dS;
//
// with P = exp(q k^T * scale + kb - lse) and delta = rowsum(o * dO), which
// the caller computes.  Neither pass ever writes a [Tq, Tk] tile to device
// memory.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py flash_attention (_flash_fwd,
// kernel body _flash_fwd_kernel; _flash_bwd, kernel bodies _flash_dq_kernel
// and _flash_dkv_kernel; causal block skip _band).  The window and segment
// forms are not ported here.
//
// Bound on the card: operations.  At the GPT-2 training shapes (BH 96, T
// 1024, d 64, causal) the forward does 2 matrix products over the causal
// half of the [T, T] scores (about 12.9 GFLOP) against 100 MB of q, k, v,
// o and lse, far above the card's FP32 flops-per-byte balance; dq does 3
// products and dk/dv 4.
//
// Design (a plain SIMT FP32 first form).  On the TPU the grid runs in order
// and carries the online-softmax state in VMEM scratch across key blocks;
// on Hopper blocks run in parallel, so each block owns its output tile and
// walks the other operand's tiles in order inside one loop:
//
//   forward and dq: one block of 256 threads per (bh, 64-query tile),
//                   walking 64-key tiles in order;
//   dk/dv:          one block per (bh, 64-key tile), walking query tiles
//                   (64 queries for d 64, 32 for d 128) in order.
//
// Every score tile is a register-tiled product: thread (ty, tx) of the
// 16 x 16 grid owns 4 rows x 4 columns of it, reading both operands as
// float4 from transposed [d][tile] shared-memory copies.  The tile of
// probabilities (or dS) goes to shared memory row-major, and the second
// product (P v, dS k, P^T dO, dS^T q) reads it as float4 against the
// row-major operand; each thread owns 4 rows x d/16 output columns.  The
// online softmax keeps each row's running max and sum in registers; a
// row's 64 scores sit in 16 lanes of one half-warp, reduced with xor
// shuffles (every lane ends with the same bits).  Key tiles wholly above
// the diagonal are skipped (the _band block skip); the diagonal tile and
// the ragged tails of Tq and Tk are masked in the kernel: a masked score
// contributes exactly zero.  The backward keeps the reference's guard
// lse <= NEG_INF / 2 -> p = 0.  No atomics: every sum runs in a fixed
// order, so a result is a pure function of the inputs.
#include "common.cuh"

namespace {

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

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// rows [r0, r0 + rows) of a [T, D] matrix into dst[D][rows] (transposed),
// times `mul`; rows at or past T read as zero.  Consecutive threads take
// consecutive rows, so the shared-memory stores hit distinct banks.
template <int D>
__device__ __forceinline__ void load_t(float* dst, const float* src, int r0,
                                       int rows, int T, float mul) {
  for (int i = threadIdx.x; i < rows * (D / 4); i += kThreads) {
    const int r = i % rows, c4 = i / rows;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) val = ld4(src + static_cast<long>(r0 + r) * D + c4 * 4);
    dst[(c4 * 4 + 0) * rows + r] = val.x * mul;
    dst[(c4 * 4 + 1) * rows + r] = val.y * mul;
    dst[(c4 * 4 + 2) * rows + r] = val.z * mul;
    dst[(c4 * 4 + 3) * rows + r] = val.w * mul;
  }
}

// rows [r0, r0 + rows) of a [T, D] matrix into dst[rows][D] (row-major).
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0,
                                          int rows, int T) {
  for (int i = threadIdx.x; i < rows * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c4 = i % (D / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) val = ld4(src + static_cast<long>(r0 + r) * D + c4 * 4);
    *reinterpret_cast<float4*>(dst + r * D + c4 * 4) = val;
  }
}

// the number of key tiles a query tile [q0, q0 + BQ) reads: with causal
// masking none past its last query (the _band block skip)
__device__ __forceinline__ int key_tiles(int q0, int Tq, int Tk, bool causal) {
  const int nk = (Tk + BK - 1) / BK;
  if (!causal) return nk;
  const int last = min(q0 + BQ, Tq) - 1;
  return min(nk, last / BK + 1);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ kb,
    float* __restrict__ o, float* __restrict__ lse, int Tq, int Tk,
    bool causal, float scale) {
  constexpr int G = D / 64;  // column groups of 64: thread columns g*64 + tx*4 + e
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][BQ], q * scale
  float* Kt = Qt + D * BQ;                      // [D][BK]
  float* Vs = Kt + D * BK;                      // [BK][D]
  float* Ps = Vs + BK * D;                      // [BQ][BK]
  __shared__ float kbs[BK];
  const int bh = blockIdx.x;
  const int nq = gridDim.y;
  const int q0 = (causal ? nq - 1 - blockIdx.y : blockIdx.y) * BQ;  // heavy tiles first
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* qb = q + static_cast<long>(bh) * Tq * D;
  const float* kbase = k + static_cast<long>(bh) * Tk * D;
  const float* vbase = v + static_cast<long>(bh) * Tk * D;

  load_t<D>(Qt, qb, q0, BQ, Tq, scale);
  float acc[4][4 * G], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = ptt::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = key_tiles(q0, Tq, Tk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q is staged; the previous tile's K, V, P are consumed
    load_t<D>(Kt, kbase, k0, BK, Tk, 1.f);
    load_rows<D>(Vs, vbase, k0, BK, Tk);
    if (threadIdx.x < BK) {
      const int j = k0 + threadIdx.x;
      kbs[threadIdx.x] = (kb != nullptr && j < Tk) ? kb[static_cast<long>(bh) * Tk + j] : 0.f;
    }
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
      bool valid[4];
      float mx = ptt::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        valid[j] = key < Tk && (!causal || key <= qrow);
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
    float* orow = o + (static_cast<long>(bh) * Tq + qrow) * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float4 out;
      out.x = acc[i][g * 4 + 0] / safe_l;
      out.y = acc[i][g * 4 + 1] / safe_l;
      out.z = acc[i][g * 4 + 2] / safe_l;
      out.w = acc[i][g * 4 + 3] / safe_l;
      *reinterpret_cast<float4*>(orow + g * 64 + tx * 4) = out;
    }
    if (tx == 0) lse[static_cast<long>(bh) * Tq + qrow] = m[i] + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ kb,
    const float* __restrict__ lse, const float* __restrict__ dout,
    const float* __restrict__ delta, float* __restrict__ dq, int Tq, int Tk,
    bool causal, float scale) {
  constexpr int G = D / 64;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][BQ]
  float* dOt = Qt + D * BQ;                     // [D][BQ]
  float* Kt = dOt + D * BQ;                     // [D][BK]
  float* Vt = Kt + D * BK;                      // [D][BK]
  float* Ks = Vt + D * BK;                      // [BK][D]
  float* dSs = Ks + BK * D;                     // [BQ][BK]
  __shared__ float kbs[BK];
  const int bh = blockIdx.x;
  const int nq = gridDim.y;
  const int q0 = (causal ? nq - 1 - blockIdx.y : blockIdx.y) * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long qoff = static_cast<long>(bh) * Tq;
  const float* kbase = k + static_cast<long>(bh) * Tk * D;
  const float* vbase = v + static_cast<long>(bh) * Tk * D;

  load_t<D>(Qt, q + qoff * D, q0, BQ, Tq, 1.f);
  load_t<D>(dOt, dout + qoff * D, q0, BQ, Tq, 1.f);
  float lse_r[4], delta_r[4], acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + ty * 4 + i;
    lse_r[i] = qrow < Tq ? lse[qoff + qrow] : 0.f;
    delta_r[i] = qrow < Tq ? delta[qoff + qrow] : 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = key_tiles(q0, Tq, Tk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_t<D>(Kt, kbase, k0, BK, Tk, 1.f);
    load_t<D>(Vt, vbase, k0, BK, Tk, 1.f);
    load_rows<D>(Ks, kbase, k0, BK, Tk);
    if (threadIdx.x < BK) {
      const int j = k0 + threadIdx.x;
      kbs[threadIdx.x] = (kb != nullptr && j < Tk) ? kb[static_cast<long>(bh) * Tk + j] : 0.f;
    }
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
        const bool valid = live && key < Tk && (!causal || key <= qrow);
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
    float* row = dq + (qoff + qrow) * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 out = make_float4(acc[i][g * 4 + 0] * scale, acc[i][g * 4 + 1] * scale,
                                     acc[i][g * 4 + 2] * scale, acc[i][g * 4 + 3] * scale);
      *reinterpret_cast<float4*>(row + g * 64 + tx * 4) = out;
    }
  }
}

// ---------------------------------------------------------------------------
// dk / dv / dkb: one block per (bh, 64-key tile), query tiles of QB rows
// ---------------------------------------------------------------------------
template <int D, int QB>
__global__ void __launch_bounds__(kThreads) dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ kb,
    const float* __restrict__ lse, const float* __restrict__ dout,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, float* __restrict__ dkb, int Tq, int Tk,
    bool causal, float scale) {
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
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long qoff = static_cast<long>(bh) * Tq;
  const long koff = static_cast<long>(bh) * Tk;
  const float* qbase = q + qoff * D;
  const float* obase = dout + qoff * D;

  load_t<D>(Kt, k + koff * D, k0, BK, Tk, 1.f);
  load_t<D>(Vt, v + koff * D, k0, BK, Tk, 1.f);
  float kbv[4], dkb_acc[4], dk_acc[4][4 * G], dv_acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    kbv[i] = (kb != nullptr && key < Tk) ? kb[koff + key] : 0.f;
    dkb_acc[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }

  const int nqt = (Tq + QB - 1) / QB;
  // causal: a query tile that ends before this key tile sees none of it
  const int qt_start = causal ? k0 / QB : 0;
  for (int qt = qt_start; qt < nqt; ++qt) {
    const int q0 = qt * QB;
    __syncthreads();  // K, V are staged; the previous query tile is consumed
    load_t<D>(Qt, qbase, q0, QB, Tq, 1.f);
    load_t<D>(dOt, obase, q0, QB, Tq, 1.f);
    load_rows<D>(Qs, qbase, q0, QB, Tq);
    load_rows<D>(dOs, obase, q0, QB, Tq);
    if (threadIdx.x < QB) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < Tq ? lse[qoff + r] : 0.f;
      delta_s[threadIdx.x] = r < Tq ? delta[qoff + r] : 0.f;
    }
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
        const bool valid = key < Tk && qrow < Tq && (!causal || key <= qrow) &&
                           lse_v > ptt::kNegInf / 2;
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
    float* dkrow = dk + (koff + key) * D;
    float* dvrow = dv + (koff + key) * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      *reinterpret_cast<float4*>(dkrow + g * 64 + tx * 4) =
          make_float4(dk_acc[i][g * 4 + 0] * scale, dk_acc[i][g * 4 + 1] * scale,
                      dk_acc[i][g * 4 + 2] * scale, dk_acc[i][g * 4 + 3] * scale);
      *reinterpret_cast<float4*>(dvrow + g * 64 + tx * 4) =
          make_float4(dv_acc[i][g * 4 + 0], dv_acc[i][g * 4 + 1],
                      dv_acc[i][g * 4 + 2], dv_acc[i][g * 4 + 3]);
    }
    if (dkb != nullptr && tx == 0) dkb[koff + key] = col;
  }
}

// Dynamic shared memory above 48 KB must be opted into once per kernel.
template <typename K>
int prepare(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, const float* kb,
               float* o, float* lse, int BH, int Tq, int Tk, bool causal,
               float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * D * 64 + 64 * D + 64 * 64);
  static int ready = prepare(fwd_kernel<D>, smem);
  if (ready != 0) return ready;
  const dim3 grid(BH, (Tq + BQ - 1) / BQ);
  fwd_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, kb, o, lse, Tq, Tk,
                                                   causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const float* kb,
              const float* lse, const float* dout, const float* delta,
              float* dq, int BH, int Tq, int Tk, bool causal, float scale,
              cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * D * 64 + 64 * D + 64 * 64);
  static int ready = prepare(dq_kernel<D>, smem);
  if (ready != 0) return ready;
  const dim3 grid(BH, (Tq + BQ - 1) / BQ);
  dq_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, kb, lse, dout, delta,
                                                  dq, Tq, Tk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int QB>
int launch_dkv(const float* q, const float* k, const float* v, const float* kb,
               const float* lse, const float* dout, const float* delta,
               float* dk, float* dv, float* dkb, int BH, int Tq, int Tk,
               bool causal, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * D * BK + 4 * D * QB + 2 * BK * QB);
  static int ready = prepare(dkv_kernel<D, QB>, smem);
  if (ready != 0) return ready;
  const dim3 grid(BH, (Tk + BK - 1) / BK);
  dkv_kernel<D, QB><<<grid, kThreads, smem, stream>>>(
      q, k, v, kb, lse, dout, delta, dk, dv, dkb, Tq, Tk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kb [BH, Tk] or null; o [BH, Tq, d]; lse [BH, Tq].  causal needs Tq == Tk.
extern "C" int ptt_flash_attention_fwd(const float* q, const float* k,
                                       const float* v, const float* kb,
                                       float* o, float* lse, int BH, int Tq,
                                       int Tk, int d, int causal, float scale,
                                       cudaStream_t stream) {
  if (BH == 0 || Tq == 0) return static_cast<int>(cudaSuccess);
  if (Tk == 0 || (causal && Tq != Tk)) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64)
    return launch_fwd<64>(q, k, v, kb, o, lse, BH, Tq, Tk, causal != 0, scale, stream);
  if (d == 128)
    return launch_fwd<128>(q, k, v, kb, o, lse, BH, Tq, Tk, causal != 0, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// delta [BH, Tq] = rowsum(o * dout); dq [BH, Tq, d]
extern "C" int ptt_flash_attention_dq(const float* q, const float* k,
                                      const float* v, const float* kb,
                                      const float* lse, const float* dout,
                                      const float* delta, float* dq, int BH,
                                      int Tq, int Tk, int d, int causal,
                                      float scale, cudaStream_t stream) {
  if (BH == 0 || Tq == 0) return static_cast<int>(cudaSuccess);
  if (Tk == 0 || (causal && Tq != Tk)) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64)
    return launch_dq<64>(q, k, v, kb, lse, dout, delta, dq, BH, Tq, Tk, causal != 0,
                         scale, stream);
  if (d == 128)
    return launch_dq<128>(q, k, v, kb, lse, dout, delta, dq, BH, Tq, Tk, causal != 0,
                          scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dk, dv [BH, Tk, d]; dkb [BH, Tk] or null (no key bias)
extern "C" int ptt_flash_attention_dkv(const float* q, const float* k,
                                       const float* v, const float* kb,
                                       const float* lse, const float* dout,
                                       const float* delta, float* dk,
                                       float* dv, float* dkb, int BH, int Tq,
                                       int Tk, int d, int causal, float scale,
                                       cudaStream_t stream) {
  if (BH == 0 || Tk == 0) return static_cast<int>(cudaSuccess);
  if (Tq == 0 || (causal && Tq != Tk)) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64)
    return launch_dkv<64, 64>(q, k, v, kb, lse, dout, delta, dk, dv, dkb, BH, Tq, Tk,
                              causal != 0, scale, stream);
  if (d == 128)
    return launch_dkv<128, 32>(q, k, v, kb, lse, dout, delta, dk, dv, dkb, BH, Tq, Tk,
                               causal != 0, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
