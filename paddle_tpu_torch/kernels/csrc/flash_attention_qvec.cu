// flash_attention_qvec (forward): per-row offset-causal attention over
// q [BH, Tq, d] against k, v [BH, Tk, d], float32, with qstart [BH] int32.
// Query i of row b sits at global position qstart[b] + i and may attend
// keys 0 .. qstart[b] + i; the output is softmax(q k^T * scale) v over
// those keys.  This is the attention of the ragged serving step: every
// slot of the pool carries its own causal cutoff inside one launch.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py:621 flash_attention_qvec, its
// forward _flash_fwd (:279) with qvec (kernel body _flash_fwd_kernel, block
// skip _band).  Like _flash_fwd it can also give each query row's
// log-sum-exp, lse [BH, Tq] = m + log(l), through an optional pointer: the
// backward (flash_attention.cu's dq and dk/dv with a per-row query base)
// rebuilds the probabilities from it.  The serving step passes null, and
// its output bits do not depend on it.
//
// Bound on the card: memory.  A serving step reads the live K/V prefix of
// every row (2 * 4 * d bytes a key) and does 4 d flops a key and query: at
// Tq = 16 that is 8 flops a byte, under FP32's balance on this card (67
// TFLOP/s over 3.35 TB/s, 20 flops a byte) but far under that of 3xTF32 on
// the tensor cores (165 TFLOP/s effective).  The GPT-2 step (BH 96, Tk
// 1024, d 64) reads 50.3 MB, the TinyLlama-width step (BH 256, Tk 2048)
// 268 MB.  The form this replaces (scripts/flash_attention_qvec_simt.cu)
// computed one key a lane in FP32 with both operands read from shared
// memory, staged 32-key tiles with scalar loads between two block
// barriers, and ran at 23-30% of the byte bound: issue-bound, not
// memory-bound.
//
// Design (the plan, qvec_plan in kernels/flash_attention.py, hands in the
// warps a block, the slice length and the number of slices, a function of
// Tk and d only, never of BH, qstart or the data):
//
// - A block per (head row, tile of 16 queries, slice of slice_len keys).
//   Tq = 16 is the M of mma.sync.m16n8k8, so a row's query tile is one A
//   operand.  q * scale is split once per block into 3xTF32 big and small
//   fragment words in shared memory (not kept in registers: the tile
//   kernels spilled so) and each warp reads it back at every chunk.
// - Each warp owns the slice's chunks w, w + W, w + 2W, ... of 16 keys,
//   staged by 16-byte cp.async into its own ring of two slots in dynamic
//   shared memory; it waits on its own copies only, so no block barrier
//   sits between staging and compute.  K's float4 columns are swizzled
//   by key (the B fragment's eight keys a quarter-warp hit distinct
//   banks), V's by key pair.  Chunks of 16 keys ran faster on the card
//   than chunks of 32 (164 registers against 128) and rings of two
//   faster than rings of three; 8 warps over slices of 1024 keys (137
//   KB, a block an SM; one slice and no second kernel at Tk 1024) faster
//   than 2 or 4 warps or slices of 256-768, at full caches and at a
//   pool's mixed ones (scripts/qvec_forms_check.py, PERF.md section 6).
//   Chunks wholly past the tile's last cutoff (kend, _band's block skip)
//   are never staged; a slice wholly past it stages nothing and writes
//   an (m = NEG_INF, l = 0) partial.
// - S = (q scale) k^T and P v run on 3xTF32 mma.sync (tf32_mma.cuh): each
//   staged K and V element is read once by one warp, so it is split in
//   registers as it is read (in integer ops, split_rna), and each lane
//   reads 16 bytes a load (a depth permutation on both sides of q k^T, an
//   output-column permutation of P v, undone at the store).  P stays in
//   registers as the A fragment of P v (split_acc's order).  Each
//   product starts from a zeroed fragment (the tensor core's own
//   accumulation rounds toward zero): the scores over 64-deep parts, P v
//   over the chunk, each added in float32.
// - The per-query cutoff (key j > qstart + i scores NEG_INF and adds
//   exactly 0) is applied on the C fragment, only in a chunk that crosses
//   a cutoff or Tk.  The online softmax (m, l) of the warp's rows g and g
//   + 8 runs on the fragment with quad shuffles.
// - Merges in a fixed order: the warps' (m, l, acc) in warp order through
//   shared memory into the slice's partial; with more than one slice the
//   partials go to a [BH, Tq, slices] workspace and qvec_combine merges
//   them by log-sum-exp in slice order.  No atomics; l == 0 divides by 1.  A row's result is a function of its
//   own q, k, v and qstart (the serving engine's pooled == solo
//   contract).  No [Tq, Tk] score tile ever reaches device memory.
#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

using ptt::Split;
using ptt::comp;
using ptt::cp_async16;
using ptt::kLog2e;
using ptt::mma3;
using ptt::quad_max;
using ptt::quad_sum;
using ptt::split_acc;
using ptt::split_rna;

constexpr int QT = 16;         // query rows of a tile: mma.sync's M
constexpr int CK = 16;         // keys of a warp's chunk
constexpr int NS = 2;          // chunks of a warp's ring
constexpr int kMaxWarps = 8;
constexpr int kMaxSmem = 232448;  // the most a block may have on the card

// floats of dynamic shared memory: QF, the split q tile (big and small
// words of every 8-deep step); the warps' rings, K and V of a chunk a
// slot; Wml, a warp's (m, l) a row
__host__ __device__ constexpr int smem_floats(int D, int W) {
  return 2 * QT * D + W * NS * 2 * CK * D + W * QT * 2;
}

// Swizzled float4 columns of a staged chunk (row = the key in the chunk):
// K's by key (the B fragment's keys g of a quarter-warp), V's by key pair
// (the rows 2t, 2t + 1 of a quarter-warp)
__device__ __forceinline__ int kcol(int r, int c4) { return (c4 ^ ((r & 3) << 2)) * 4; }
__device__ __forceinline__ int vcol(int r, int c4) { return (c4 ^ (r & 6)) * 4; }

// The layout of q k^T's depth: 8-deep step kk = 2p + h takes dims 16p + 4t
// + 2h (fragment depth t) and 16p + 4t + 2h + 1 (depth t + 4), so a lane's
// float4 of K at dims 16p + 4t .. + 3 feeds steps 2p and 2p + 1.  P v's
// n-tile n = 4m + r takes output column c of the tile from dim 32m + 4c +
// r, so a lane's float4 of V at dims 32m + 4g .. + 3 feeds n-tiles 4m ..
// 4m + 3; its accumulator (g, 2t), (g, 2t + 1) holds dims 32m + 8t + r and
// 32m + 8t + 4 + r.
//
// One block of W = blockDim.x / 32 warps per (head row, query tile,
// slice): block x is slice x % slices of query tile (x / slices) % qtiles
// of head row x / (slices qtiles).  One slice writes o (and lse, if not
// null); more write their partials to part_o [BH, Tq, slices, D] and
// part_ml [BH, Tq, slices, 2] for qvec_combine.
template <int D>
__global__ void __launch_bounds__(kMaxWarps * 32) qvec_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ qstart,
    float* __restrict__ o, float* __restrict__ lse, float* __restrict__ part_o,
    float* __restrict__ part_ml, int Tq, int Tk, int slice_len, int slices,
    float scale) {
  constexpr int D4 = D / 4;
  constexpr int KS = D / 8;   // 8-deep steps of q k^T
  constexpr int NJ = CK / 8;  // 8-key blocks of a chunk
  constexpr int NT = D / 8;   // n-tiles of P v
  constexpr int SLOT = 2 * CK * D;
  extern __shared__ float4 smem4[];
  const int W = blockDim.x >> 5;
  uint4* QF = reinterpret_cast<uint4*>(smem4);  // [KS][big, small][32 lanes]
  float* rings = reinterpret_cast<float*>(QF + 64 * KS);
  float* Wml = rings + W * NS * SLOT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qtiles = (Tq + QT - 1) / QT;
  const int slice = blockIdx.x % slices;
  const int q0 = (blockIdx.x / slices) % qtiles * QT;
  const long bh = blockIdx.x / slices / qtiles;
  const int nq = min(QT, Tq - q0);
  const int qpos0 = qstart[bh] + q0;  // the tile's first query's position
  // the tile's last query sits at qpos0 + nq - 1: no key beyond it is live
  const int kend = min(Tk, qpos0 + nq);
  const int s_lo = slice * slice_len;
  const int n_chunks = kend > s_lo ? (min(kend, s_lo + slice_len) - s_lo + CK - 1) / CK : 0;
  const int n_mine = n_chunks > warp ? (n_chunks - warp + W - 1) / W : 0;
  float* ring = rings + warp * NS * SLOT;
  const float* kb = k + bh * Tk * D;
  const float* vb = v + bh * Tk * D;

  // the warp's i-th chunk (slice chunk warp + i W) into ring slot i % NS;
  // keys at or past Tk zero-filled, so a masked p = 0 meets v = 0
  auto issue = [&](int i) {
    if (i < n_mine) {
      const int c0 = s_lo + (warp + i * W) * CK;
      float* slot = ring + (i % NS) * SLOT;
#pragma unroll 4
      for (int e = lane; e < CK * D4; e += 32) {
        const int r = e / D4, c4 = e % D4;
        const bool ok = c0 + r < Tk;
        const long src = static_cast<long>(ok ? c0 + r : 0) * D + c4 * 4;
        cp_async16(slot + r * D + kcol(r, c4), kb + src, ok);
        cp_async16(slot + CK * D + r * D + vcol(r, c4), vb + src, ok);
      }
    }
    ptt::cp_async_commit();
  };
  for (int i = 0; i < NS; ++i) issue(i);

  // q * scale, split once: QF[64 kk + lane] the big parts of step kk,
  // QF[64 kk + 32 + lane] the small ones; rows past Tq zero
  for (int e = threadIdx.x; e < 32 * KS; e += blockDim.x) {
    const int kk = e >> 5, ln = e & 31, gg = ln >> 2, tt = ln & 3;
    const int col = 16 * (kk >> 1) + 4 * tt + 2 * (kk & 1);
    float2 lo = make_float2(0.f, 0.f), hi = lo;
    if (gg < nq) lo = *reinterpret_cast<const float2*>(q + ((bh * Tq) + q0 + gg) * D + col);
    if (gg + 8 < nq)
      hi = *reinterpret_cast<const float2*>(q + ((bh * Tq) + q0 + gg + 8) * D + col);
    const Split a0 = split_rna(lo.x * scale), a1 = split_rna(hi.x * scale);
    const Split a2 = split_rna(lo.y * scale), a3 = split_rna(hi.y * scale);
    QF[64 * kk + ln] = make_uint4(a0.big, a1.big, a2.big, a3.big);
    QF[64 * kk + 32 + ln] = make_uint4(a0.small, a1.small, a2.small, a3.small);
  }
  __syncthreads();  // QF is staged

  const int pa = qpos0 + g, pb = pa + 8;  // the positions of rows g, g + 8
  float acc[NT][4], m_a = ptt::kNegInf, m_b = ptt::kNegInf, l_a = 0.f, l_b = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int i = 0; i < n_mine; ++i) {
    ptt::cp_async_wait(NS - 1);
    __syncwarp();  // chunk i is in the warp's ring
    const float* Ks = ring + (i % NS) * SLOT;
    const float* Vs = Ks + CK * D;
    const int c0 = s_lo + (warp + i * W) * CK;

    // S = (q scale) k^T: 64-deep parts from zero, added in float32
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int part = 0; part < D / 64; ++part) {
      float c[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        const int p = 4 * part + pp;
        Split qa[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 big = QF[64 * (2 * p + h) + lane], small = QF[64 * (2 * p + h) + 32 + lane];
          qa[h][0] = Split{big.x, small.x};
          qa[h][1] = Split{big.y, small.y};
          qa[h][2] = Split{big.z, small.z};
          qa[h][3] = Split{big.w, small.w};
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int r = 8 * j + g;
          const float4 kx = *reinterpret_cast<const float4*>(Ks + r * D + kcol(r, 4 * p + t));
          const Split b0[2] = {split_rna(kx.x), split_rna(kx.y)};
          const Split b1[2] = {split_rna(kx.z), split_rna(kx.w)};
          mma3(c[j], qa[0], b0);
          mma3(c[j], qa[1], b1);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += c[j][e];
    }

    // the cutoff, only where the chunk crosses one (or Tk)
    unsigned live = ~0u;  // bit 4 j + e: element (j, e) is visible
    if (c0 + CK > Tk || c0 + CK - 1 > qpos0) {
      live = 0u;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = c0 + 8 * j + 2 * t + (e & 1);
          if (key < Tk && key <= (e < 2 ? pa : pb)) live |= 1u << (4 * j + e);
        }
    }
    float mx_a = ptt::kNegInf, mx_b = ptt::kNegInf;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = (live >> (4 * j + e)) & 1u ? s[j][e] : ptt::kNegInf;
        if (e < 2)
          mx_a = fmaxf(mx_a, s[j][e]);
        else
          mx_b = fmaxf(mx_b, s[j][e]);
      }
    const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
    const float al_a = exp2f((m_a - mn_a) * kLog2e), al_b = exp2f((m_b - mn_b) * kLog2e);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;  // this lane's share of the rows' sums
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            (live >> (4 * j + e)) & 1u ? exp2f((s[j][e] - (e < 2 ? mn_a : mn_b)) * kLog2e) : 0.f;
        s[j][e] = p;
        if (e < 2)
          ps_a += p;
        else
          ps_b += p;
      }
    l_a = l_a * al_a + ps_a;
    l_b = l_b * al_b + ps_b;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= al_a;
      acc[n][1] *= al_a;
      acc[n][2] *= al_b;
      acc[n][3] *= al_b;
    }

    // P v over the chunk, from zero, added in float32; P never leaves the
    // registers
    Split pfr[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) split_acc(pfr[j], s[j]);
#pragma unroll
    for (int mm = 0; mm < D / 32; ++mm) {
      float c[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) c[r][0] = c[r][1] = c[r][2] = c[r][3] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int r0 = 8 * j + 2 * t;
        const float4 v0 = *reinterpret_cast<const float4*>(Vs + r0 * D + vcol(r0, 8 * mm + g));
        const float4 v1 =
            *reinterpret_cast<const float4*>(Vs + (r0 + 1) * D + vcol(r0 + 1, 8 * mm + g));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const Split b[2] = {split_rna(comp(v0, r)), split_rna(comp(v1, r))};
          mma3(c[r], pfr[j], b);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * mm + r][e] += c[r][e];
    }
    __syncwarp();  // every lane is done with slot i % NS
    issue(i + NS);
  }
  ptt::cp_async_wait(0);
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);

  // the warp's partial: acc [16][D] into its own (consumed) ring, (m, l)
  // to Wml
  __syncwarp();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float* arow = ring + (g + 8 * half) * D + 8 * t;
#pragma unroll
    for (int mm = 0; mm < D / 32; ++mm) {
      *reinterpret_cast<float4*>(arow + 32 * mm) =
          make_float4(acc[4 * mm][2 * half], acc[4 * mm + 1][2 * half],
                      acc[4 * mm + 2][2 * half], acc[4 * mm + 3][2 * half]);
      *reinterpret_cast<float4*>(arow + 32 * mm + 4) =
          make_float4(acc[4 * mm][2 * half + 1], acc[4 * mm + 1][2 * half + 1],
                      acc[4 * mm + 2][2 * half + 1], acc[4 * mm + 3][2 * half + 1]);
    }
  }
  if (t == 0) {
    Wml[(warp * QT + g) * 2] = m_a;
    Wml[(warp * QT + g) * 2 + 1] = l_a;
    Wml[(warp * QT + g + 8) * 2] = m_b;
    Wml[(warp * QT + g + 8) * 2 + 1] = l_b;
  }
  __syncthreads();

  // the block's slice: each thread a float4 of a row, the warps in order
  for (int e = threadIdx.x; e < nq * D4; e += blockDim.x) {
    const int row = e / D4, c4 = e % D4;
    float M = ptt::kNegInf;
    for (int w = 0; w < W; ++w) M = fmaxf(M, Wml[(w * QT + row) * 2]);
    float L = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < W; ++w) {
      const float wgt = expf(Wml[(w * QT + row) * 2] - M);
      L = fmaf(Wml[(w * QT + row) * 2 + 1], wgt, L);
      const float4 a = *reinterpret_cast<const float4*>(rings + w * NS * SLOT + row * D + 4 * c4);
      A.x = fmaf(a.x, wgt, A.x);
      A.y = fmaf(a.y, wgt, A.y);
      A.z = fmaf(a.z, wgt, A.z);
      A.w = fmaf(a.w, wgt, A.w);
    }
    const long orow = bh * Tq + q0 + row;
    if (slices == 1) {
      const float safe_l = L == 0.f ? 1.f : L;
      *reinterpret_cast<float4*>(o + orow * D + 4 * c4) =
          make_float4(A.x / safe_l, A.y / safe_l, A.z / safe_l, A.w / safe_l);
      if (lse != nullptr && c4 == 0) lse[orow] = M + logf(safe_l);
    } else {
      const long prow = orow * slices + slice;
      *reinterpret_cast<float4*>(part_o + prow * D + 4 * c4) = A;
      if (c4 == 0) {
        part_ml[2 * prow] = M;
        part_ml[2 * prow + 1] = L;
      }
    }
  }
}

// One warp per query row: merge the row's slices in slice order.  A slice
// with no live key has m = NEG_INF, so its weight exp(m - max) is 0.
template <int D>
__global__ void __launch_bounds__(128) qvec_combine(const float* __restrict__ part_o,
                                                    const float* __restrict__ part_ml,
                                                    float* __restrict__ o,
                                                    float* __restrict__ lse, long rows,
                                                    int slices) {
  constexpr int DPL = D / 32;
  const long row = static_cast<long>(blockIdx.x) * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* ml = part_ml + row * slices * 2;
  float M = ptt::kNegInf;
  for (int c = 0; c < slices; ++c) M = fmaxf(M, ml[2 * c]);
  float L = 0.f, A[DPL];
#pragma unroll
  for (int dd = 0; dd < DPL; ++dd) A[dd] = 0.f;
  for (int c = 0; c < slices; ++c) {
    const float wgt = expf(ml[2 * c] - M);
    L = fmaf(ml[2 * c + 1], wgt, L);
    const float* po = part_o + (row * slices + c) * D + lane;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) A[dd] = fmaf(po[32 * dd], wgt, A[dd]);
  }
  const float safe_l = L == 0.f ? 1.f : L;
#pragma unroll
  for (int dd = 0; dd < DPL; ++dd) o[row * D + lane + 32 * dd] = A[dd] / safe_l;
  if (lse != nullptr && lane == 0) lse[row] = M + logf(safe_l);
}

template <int D>
int launch(const float* q, const float* k, const float* v, const int* qstart, float* o,
           float* lse, float* part_o, float* part_ml, int BH, int Tq, int Tk, int W,
           int slice_len, int slices, int smem, float scale, cudaStream_t stream) {
  if (smem != static_cast<int>(sizeof(float)) * smem_floats(D, W) || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  // dynamic shared memory above 48 KB is opted into once, at the most a
  // block may have
  static int ready = static_cast<int>(cudaFuncSetAttribute(
      qvec_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem));
  if (ready != 0) return ready;
  const long blocks = static_cast<long>(BH) * ((Tq + QT - 1) / QT) * slices;
  if (blocks >= (1L << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (slices > 1 && (part_o == nullptr || part_ml == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  qvec_kernel<D><<<static_cast<unsigned>(blocks), W * 32, smem, stream>>>(
      q, k, v, qstart, o, lse, part_o, part_ml, Tq, Tk, slice_len, slices, scale);
  if (slices > 1) {
    const long rows = static_cast<long>(BH) * Tq;
    qvec_combine<D><<<static_cast<unsigned>((rows + 3) / 4), 128, 0, stream>>>(
        part_o, part_ml, o, lse, rows, slices);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lse [BH, Tq] or null; the plan (qvec_plan in kernels/flash_attention.py):
// warps a block (1-8), slice_len keys a slice (a multiple of the 16-key
// chunk) and slices = ceil(Tk / slice_len), and the dynamic shared memory
// in bytes, checked against the kernel's layout; part_o [BH, Tq, slices,
// d] and part_ml [BH, Tq, slices, 2] when slices > 1, else unused.
extern "C" int ptt_flash_attention_qvec(const float* q, const float* k, const float* v,
                                        const int* qstart, float* o, float* lse,
                                        float* part_o, float* part_ml, int BH, int Tq,
                                        int Tk, int d, int warps, int slice_len, int slices,
                                        int smem, float scale, cudaStream_t stream) {
  if (BH == 0 || Tq == 0) return static_cast<int>(cudaSuccess);
  if (Tk <= 0 || warps < 1 || warps > kMaxWarps || slice_len <= 0 || slice_len % CK != 0 ||
      slices != (Tk + slice_len - 1) / slice_len)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64)
    return launch<64>(q, k, v, qstart, o, lse, part_o, part_ml, BH, Tq, Tk, warps, slice_len,
                      slices, smem, scale, stream);
  if (d == 128)
    return launch<128>(q, k, v, qstart, o, lse, part_o, part_ml, BH, Tq, Tk, warps, slice_len,
                       slices, smem, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
