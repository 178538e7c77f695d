// The SIMT form of flash_attention_qvec's forward that
// paddle_tpu_torch/kernels/csrc/flash_attention_qvec.cu replaced, kept
// to be timed beside it (scripts/qvec_forms_check.py builds it with -I
// paddle_tpu_torch/kernels/csrc into a library of its own).  Same
// function and operands as the shipped kernel, at a fixed key split of
// kv_chunk keys: one block of 4 warps per (row, 16-query tile, slice),
// each warp walking 4 query rows; 32-key tiles of K and V staged with
// scalar loads between two block barriers; scores one key a lane as
// serial FP32 FMAs with both operands in shared memory, P v by shuffles;
// the online softmax in registers; slices merged by qvec_combine in
// slice order.  It ran at 23-30% of the byte bound at the serving
// shapes: issue-bound on shared-memory loads, not memory-bound.
#include "common.cuh"

namespace {

constexpr int BQ = 16;       // query rows per block
constexpr int BKV = 32;      // keys per shared-memory tile (one per lane)
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = BQ / kWarps;

// With one slice (gridDim.z == 1) it writes o (and lse, if not null);
// otherwise slice blockIdx.z's partials: part_o [BH, Tq, slices, D] and
// part_ml [BH, Tq, slices, 2].
template <int D>
__global__ void __launch_bounds__(kWarps * 32) qvec_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ qstart,
    float* __restrict__ o, float* __restrict__ lse, float* __restrict__ part_o,
    float* __restrict__ part_ml, int Tq, int Tk, int kv_chunk, float scale) {
  constexpr int DPL = D / 32;  // output columns per lane
  __shared__ float Qs[BQ][D];
  __shared__ float Ks[BKV][D + 1];  // +1: lanes read distinct banks
  __shared__ float Vs[BKV][D];
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long qbase = static_cast<long>(bh) * Tq * D;
  const long kbase = static_cast<long>(bh) * Tk * D;
  const int qs = qstart[bh];
  const int nq = min(BQ, Tq - q0);
  const int slices = gridDim.z;
  // the tile's last query sits at qs + q0 + nq - 1: no key beyond it is live
  const int kend = min(Tk, qs + q0 + nq);
  const int k_lo = blockIdx.z * kv_chunk;
  const int k_hi = min(kend, k_lo + kv_chunk);

  if (k_lo < k_hi) {  // block-uniform: a dead slice stages nothing
    for (int i = threadIdx.x; i < BQ * D; i += kWarps * 32) {
      const int r = i / D, c = i % D;
      Qs[r][c] = r < nq ? q[qbase + static_cast<long>(q0 + r) * D + c] * scale : 0.f;
    }
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = ptt::kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[rr][dd] = 0.f;
  }

  // kv_chunk is a multiple of BKV, so a tile never crosses into the next
  // slice; keys at or past kend fail j <= qpos below
  for (int kt = k_lo; kt < k_hi; kt += BKV) {
    __syncthreads();  // Q is staged; the previous K/V tile is consumed
    for (int i = threadIdx.x; i < BKV * D; i += kWarps * 32) {
      const int r = i / D, c = i % D;
      const int j = kt + r;
      const bool ok = j < Tk;
      Ks[r][c] = ok ? k[kbase + static_cast<long>(j) * D + c] : 0.f;
      Vs[r][c] = ok ? v[kbase + static_cast<long>(j) * D + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      if (r >= nq) continue;  // warp-uniform
      const int qpos = qs + q0 + r;
      const int j = kt + lane;
      float s = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) s = fmaf(Qs[r][c], Ks[lane][c], s);
      const bool valid = j < Tk && j <= qpos;
      s = valid ? s : ptt::kNegInf;
      const float m_new = fmaxf(m[rr], ptt::warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + ptt::warp_sum(p);
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[rr][dd] *= alpha;
#pragma unroll 8
      for (int jj = 0; jj < BKV; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd)
          acc[rr][dd] = fmaf(pj, Vs[jj][lane + 32 * dd], acc[rr][dd]);
      }
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    if (r >= nq) continue;
    if (slices == 1) {
      const float safe_l = l[rr] == 0.f ? 1.f : l[rr];
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd)
        o[qbase + static_cast<long>(q0 + r) * D + lane + 32 * dd] = acc[rr][dd] / safe_l;
      if (lse != nullptr && lane == 0)
        lse[static_cast<long>(bh) * Tq + q0 + r] = m[rr] + logf(safe_l);
    } else {
      const long prow = (static_cast<long>(bh) * Tq + q0 + r) * slices + blockIdx.z;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) part_o[prow * D + lane + 32 * dd] = acc[rr][dd];
      if (lane == 0) {
        part_ml[2 * prow] = m[rr];
        part_ml[2 * prow + 1] = l[rr];
      }
    }
  }
}

// One warp per query row: merge the row's slices in slice order.  A slice
// with no live key has m = NEG_INF, so its weight exp(m - max) is 0.
template <int D>
__global__ void __launch_bounds__(kWarps * 32) qvec_combine(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    float* __restrict__ o, float* __restrict__ lse, int rows, int slices) {
  constexpr int DPL = D / 32;
  const long row = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* ml = part_ml + row * slices * 2;
  float mx = ptt::kNegInf;
  for (int c = 0; c < slices; ++c) mx = fmaxf(mx, ml[2 * c]);
  float l = 0.f, acc[DPL];
#pragma unroll
  for (int dd = 0; dd < DPL; ++dd) acc[dd] = 0.f;
  for (int c = 0; c < slices; ++c) {
    const float wgt = expf(ml[2 * c] - mx);
    l = fmaf(ml[2 * c + 1], wgt, l);
    const float* po = part_o + (row * slices + c) * D;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[dd] = fmaf(po[lane + 32 * dd], wgt, acc[dd]);
  }
  const float safe_l = l == 0.f ? 1.f : l;
#pragma unroll
  for (int dd = 0; dd < DPL; ++dd) o[row * D + lane + 32 * dd] = acc[dd] / safe_l;
  if (lse != nullptr && lane == 0) lse[row] = mx + logf(safe_l);
}

template <int D>
int launch(const float* q, const float* k, const float* v, const int* qstart,
           float* o, float* lse, float* part_o, float* part_ml, int BH, int Tq,
           int Tk, int kv_chunk, float scale, cudaStream_t stream) {
  const int slices = Tk > kv_chunk ? (Tk + kv_chunk - 1) / kv_chunk : 1;
  if (slices > 1 && (part_o == nullptr || part_ml == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(BH, (Tq + BQ - 1) / BQ, slices);
  qvec_kernel<D><<<grid, kWarps * 32, 0, stream>>>(q, k, v, qstart, o, lse,
                                                   part_o, part_ml, Tq, Tk,
                                                   kv_chunk, scale);
  if (slices > 1) {
    const int rows = BH * Tq;
    qvec_combine<D><<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
        part_o, part_ml, o, lse, rows, slices);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lse [BH, Tq] or null; part_o [BH, Tq, slices, d] and part_ml [BH, Tq,
// slices, 2] floats, with slices = ceil(Tk / kv_chunk), when Tk > kv_chunk;
// else unused
extern "C" int ptt_qvec_simt(const float* q, const float* k,
                                        const float* v, const int* qstart,
                                        float* o, float* lse, float* part_o,
                                        float* part_ml, int BH, int Tq,
                                        int Tk, int d, int kv_chunk,
                                        float scale, cudaStream_t stream) {
  if (BH == 0 || Tq == 0) return static_cast<int>(cudaSuccess);
  if (kv_chunk <= 0 || kv_chunk % BKV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64)
    return launch<64>(q, k, v, qstart, o, lse, part_o, part_ml, BH, Tq, Tk, kv_chunk,
                      scale, stream);
  if (d == 128)
    return launch<128>(q, k, v, qstart, o, lse, part_o, part_ml, BH, Tq, Tk, kv_chunk,
                       scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
