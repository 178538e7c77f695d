// flash_attention (forward), the few-row form: o = softmax(q k^T * scale +
// kb) v and lse [BH, Tq] over q [BH, Tq, d] with Tq <= 8, against k, v
// [BH, Tk, d], float32, with an optional additive key bias kb [BH, Tk]; no
// causal mask, window, segment ids or query base.  These are the decode
// steps' calls: the one-token step (Tq 1), the beam step (Tq 1 over 8 rows
// a head) and the GQA fold (Tq = the group size), each with the key bias
// that masks the cache's tail.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py flash_attention, its forward
// _flash_fwd (kernel body _flash_fwd_kernel) at these forms.  The same
// (o, lse) as flash_attention.cu's forward kernel, which keeps every other
// form.
//
// Bound on the card: memory.  A call reads k and v whole (2 * 4 * Tk * d
// bytes a head row) for about 4 * Tq * d flops a key: at Tq <= 8 far below
// the card's flops-per-byte balance.  The GPT-2 one-token step (BH 48, Tk
// 1024, d 64) reads 25.2 MB.
//
// Design.  flash_attention.cu's forward stages a 64-query tile: at Tq 1 it
// computes 63 rows of padding and runs one block per head row, walking
// every key tile in order (48 blocks for 132 SMs).  Here the keys are cut
// into fixed slices of `slice_len` (a multiple of 32, at most 256; the
// caller's plan, a function of Tk and d only, never of BH or of the bias),
// and one block per (head row, slice) reads its slice once:
//
// - each warp owns one 32-key chunk of the slice, staged into its own
//   shared memory with cp.async 16-byte copies (K with its float4 columns
//   swizzled by key, so the lanes' row reads hit distinct banks), and
//   waits for its own copies only: no block barrier between staging and
//   compute;
// - scores one key a lane against the block's <= 8 query rows (scaled once
//   into shared memory), the chunk's softmax state (m, l) a row in
//   registers, and p v with each lane owning d / 32 output columns;
// - the block merges its warps' (m, l, acc) in warp order into the slice's
//   partial; with more than one slice the partials go to a [BH, Tq,
//   slices] workspace and a second small kernel, rows_combine, merges them
//   by log-sum-exp in slice order.  (A thread-block cluster per head row
//   whose rank 0 gathered the slices through distributed shared memory was
//   measured too and was slower at Tk 1024: PERF.md section 6.)
//
// No key is skipped on its bias value: the bias masks, the tiles do not.
// A key at the NEG_INF bias scores exactly -1e30 in float32, so a row whose
// every key is masked takes o = the mean of v and lse = -1e30 + log(Tk), as
// the plain version and _flash_fwd_kernel do; a slice wholly masked in a
// row that sees other keys weighs exp(-1e30 - m) = 0.  l == 0 divides by 1.
// No atomics, and every sum runs in a fixed order, so a row's result is a
// function of its own q, k, v and bias: pooled == solo, and the beam's
// reorder stays exact.
#include "common.cuh"
#include "tf32_mma.cuh"  // cp.async staging only

namespace {

using ptt::comp;
using ptt::cp_async16;

constexpr int kMaxWarps = 8;  // a slice of at most 256 keys

// floats of dynamic shared memory for W warps at head dim D, TQ rows
__host__ __device__ constexpr int smem_floats(int D, int TQ, int W) {
  return 2 * W * 32 * D      // Ks, Vs: a 32-key chunk of K and V a warp
         + TQ * D            // Qs: q * scale
         + W * TQ * 32       // Ps: a warp's probabilities
         + W * TQ * 2;       // Wml: a warp's (m, l) a row
}

// One block of W = blockDim.x / 32 warps per (head row, slice): block x is
// head row x / slices, slice x % slices.  One slice writes o and lse; more
// write their partials to part_o [BH, Tq, slices, D] and part_ml [BH, Tq,
// slices, 2] for rows_combine.
template <int D, int TQ>
__global__ void __launch_bounds__(kMaxWarps * 32) rows_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ kb,
    float* __restrict__ o, float* __restrict__ lse, float* __restrict__ part_o,
    float* __restrict__ part_ml, int Tq, int Tk, int slice_len, int slices,
    float scale) {
  constexpr int D4 = D / 4;
  constexpr int DPL = D / 32;  // output columns a lane
  extern __shared__ float4 smem4[];
  const int W = blockDim.x >> 5;
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + W * 32 * D;
  float* Qs = Vs + W * 32 * D;
  float* Ps = Qs + TQ * D;
  float* Wml = Ps + W * TQ * 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slice = blockIdx.x % slices;
  const long bh = blockIdx.x / slices;
  const int key0 = slice * slice_len + warp * 32;
  const int nkeys = max(0, min(32, min(Tk, (slice + 1) * slice_len) - key0));
  float* Kw = Ks + warp * 32 * D;
  float* Vw = Vs + warp * 32 * D;

  if (nkeys > 0) {  // warp-uniform: the chunk's copies go first
    const float* kbase = k + (bh * Tk + key0) * D;
    const float* vbase = v + (bh * Tk + key0) * D;
    for (int i = lane; i < 32 * D4; i += 32) {
      const int r = i / D4, c4 = i % D4;
      const bool ok = r < nkeys;  // past the chunk's keys: zero-filled
      const long src = static_cast<long>(ok ? r : 0) * D + c4 * 4;
      cp_async16(Kw + r * D + ((c4 ^ (r & 7)) * 4), kbase + src, ok);
      cp_async16(Vw + r * D + c4 * 4, vbase + src, ok);
    }
    ptt::cp_async_commit();
  }
  for (int i = threadIdx.x; i < TQ * D; i += blockDim.x) {
    const int r = i / D;
    Qs[i] = r < Tq ? q[(bh * Tq + r) * D + i % D] * scale : 0.f;
  }
  const bool valid = lane < nkeys;
  const float bias = (kb != nullptr && valid) ? kb[bh * Tk + key0 + lane] : 0.f;
  __syncthreads();  // Qs is staged

  float m[TQ], l[TQ], acc[TQ][DPL];
#pragma unroll
  for (int t = 0; t < TQ; ++t) {
    m[t] = ptt::kNegInf;
    l[t] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[t][dd] = 0.f;
  }
  if (nkeys > 0) {
    ptt::cp_async_wait(0);
    __syncwarp();  // the warp's chunk is in shared memory
    float s[TQ];
#pragma unroll
    for (int t = 0; t < TQ; ++t) s[t] = 0.f;
#pragma unroll 4
    for (int c4 = 0; c4 < D4; ++c4) {
      const float4 kk = *reinterpret_cast<const float4*>(Kw + lane * D + ((c4 ^ (lane & 7)) * 4));
#pragma unroll
      for (int t = 0; t < TQ; ++t) {
        const float4 qq = *reinterpret_cast<const float4*>(Qs + t * D + c4 * 4);
        s[t] = fmaf(qq.x, kk.x, s[t]);
        s[t] = fmaf(qq.y, kk.y, s[t]);
        s[t] = fmaf(qq.z, kk.z, s[t]);
        s[t] = fmaf(qq.w, kk.w, s[t]);
      }
    }
    float* Pw = Ps + warp * TQ * 32;
#pragma unroll
    for (int t = 0; t < TQ; ++t) {
      const float st = valid ? s[t] + bias : ptt::kNegInf;
      m[t] = ptt::warp_max(st);
      const float p = valid ? expf(st - m[t]) : 0.f;
      l[t] = ptt::warp_sum(p);
      Pw[t * 32 + lane] = p;
    }
    __syncwarp();
#pragma unroll 2
    for (int j4 = 0; j4 < 8; ++j4) {
      float4 pp[TQ];
#pragma unroll
      for (int t = 0; t < TQ; ++t) pp[t] = *reinterpret_cast<const float4*>(Pw + t * 32 + j4 * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = Vw + (j4 * 4 + e) * D + lane;
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) {
          const float vv = vrow[32 * dd];
#pragma unroll
          for (int t = 0; t < TQ; ++t) acc[t][dd] = fmaf(comp(pp[t], e), vv, acc[t][dd]);
        }
      }
    }
  }
  // the warp's partial: (m, l) to Wml, acc over its own (consumed) K chunk
#pragma unroll
  for (int t = 0; t < TQ; ++t) {
    if (lane == 0) {
      Wml[(warp * TQ + t) * 2] = m[t];
      Wml[(warp * TQ + t) * 2 + 1] = l[t];
    }
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) Kw[t * D + lane + 32 * dd] = acc[t][dd];
  }
  __syncthreads();

  // the block's slice: row t merged by warp t % W over the warps in order
  for (int t = warp; t < Tq && t < TQ; t += W) {
    float M = ptt::kNegInf;
    for (int w = 0; w < W; ++w) M = fmaxf(M, Wml[(w * TQ + t) * 2]);
    float L = 0.f, A[DPL];
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) A[dd] = 0.f;
    for (int w = 0; w < W; ++w) {
      const float wgt = expf(Wml[(w * TQ + t) * 2] - M);
      L = fmaf(Wml[(w * TQ + t) * 2 + 1], wgt, L);
      const float* Aw = Ks + w * 32 * D + t * D + lane;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) A[dd] = fmaf(Aw[32 * dd], wgt, A[dd]);
    }
    const long row = bh * Tq + t;
    if (slices == 1) {
      const float safe_l = L == 0.f ? 1.f : L;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) o[row * D + lane + 32 * dd] = A[dd] / safe_l;
      if (lane == 0) lse[row] = M + logf(safe_l);
    } else {
      const long prow = row * slices + slice;
      if (lane == 0) {
        part_ml[2 * prow] = M;
        part_ml[2 * prow + 1] = L;
      }
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) part_o[prow * D + lane + 32 * dd] = A[dd];
    }
  }
}

// One warp per query row: merge the row's slices in slice order.
template <int D>
__global__ void __launch_bounds__(128) rows_combine(const float* __restrict__ part_o,
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
  if (lane == 0) lse[row] = M + logf(safe_l);
}

// the largest dynamic shared memory any plan asks of a kernel at head dim D
template <int D>
constexpr int max_smem_bytes() {
  return static_cast<int>(sizeof(float)) * smem_floats(D, 8, D == 64 ? kMaxWarps : 4);
}

template <int D, int TQ>
int launch(const float* q, const float* k, const float* v, const float* kb, float* o,
           float* lse, float* part_o, float* part_ml, int BH, int Tq, int Tk,
           int slice_len, int slices, float scale, cudaStream_t stream) {
  const int W = slice_len / 32;
  const int smem = static_cast<int>(sizeof(float)) * smem_floats(D, TQ, W);
  if (smem > max_smem_bytes<D>()) return static_cast<int>(cudaErrorInvalidValue);
  // dynamic shared memory above 48 KB is opted into once, at the most any
  // plan asks
  static int ready = static_cast<int>(cudaFuncSetAttribute(
      rows_kernel<D, TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem_bytes<D>()));
  if (ready != 0) return ready;
  const long blocks = static_cast<long>(BH) * slices;
  if (blocks >= (1L << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (slices > 1 && (part_o == nullptr || part_ml == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  rows_kernel<D, TQ><<<static_cast<unsigned>(blocks), W * 32, smem, stream>>>(
      q, k, v, kb, o, lse, part_o, part_ml, Tq, Tk, slice_len, slices, scale);
  if (slices > 1) {
    const long rows = static_cast<long>(BH) * Tq;
    rows_combine<D><<<static_cast<unsigned>((rows + 3) / 4), 128, 0, stream>>>(
        part_o, part_ml, o, lse, rows, slices);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const float* q, const float* k, const float* v, const float* kb, float* o,
             float* lse, float* part_o, float* part_ml, int BH, int Tq, int Tk,
             int slice_len, int slices, float scale, cudaStream_t stream) {
  // Tq rounds up to 1, 2, 4 or 8 rows; the rows past Tq are zero and unwritten
  if (Tq == 1)
    return launch<D, 1>(q, k, v, kb, o, lse, part_o, part_ml, BH, Tq, Tk, slice_len,
                        slices, scale, stream);
  if (Tq == 2)
    return launch<D, 2>(q, k, v, kb, o, lse, part_o, part_ml, BH, Tq, Tk, slice_len,
                        slices, scale, stream);
  if (Tq <= 4)
    return launch<D, 4>(q, k, v, kb, o, lse, part_o, part_ml, BH, Tq, Tk, slice_len,
                        slices, scale, stream);
  return launch<D, 8>(q, k, v, kb, o, lse, part_o, part_ml, BH, Tq, Tk, slice_len, slices,
                      scale, stream);
}

}  // namespace

// kb [BH, Tk] or null; o [BH, Tq, d]; lse [BH, Tq]; the plan (rows_plan in
// kernels/flash_attention.py): slice_len keys a slice (a multiple of 32, at
// most 256, 128 at d 128) and slices = ceil(Tk / slice_len); part_o [BH,
// Tq, slices, d] and part_ml [BH, Tq, slices, 2] when slices > 1, else
// unused.
extern "C" int ptt_flash_attention_rows(const float* q, const float* k, const float* v,
                                        const float* kb, float* o, float* lse,
                                        float* part_o, float* part_ml, int BH, int Tq,
                                        int Tk, int d, int slice_len, int slices,
                                        float scale, cudaStream_t stream) {
  if (BH == 0 || Tq == 0) return static_cast<int>(cudaSuccess);
  if (Tq > 8 || Tk <= 0 || slice_len <= 0 || slice_len % 32 != 0 ||
      slice_len > 32 * kMaxWarps || slices != (Tk + slice_len - 1) / slice_len)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64)
    return launch_d<64>(q, k, v, kb, o, lse, part_o, part_ml, BH, Tq, Tk, slice_len, slices,
                        scale, stream);
  if (d == 128)
    return launch_d<128>(q, k, v, kb, o, lse, part_o, part_ml, BH, Tq, Tk, slice_len, slices,
                         scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
