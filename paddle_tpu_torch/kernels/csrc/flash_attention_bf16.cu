// flash_attention's bf16 forms: the forward, dq and dk/dv kernels of
// flash_attention.cu (whose header comment sets out the contract and the
// masks: causal, key bias, window and segment ids, alone or together; the
// lse sentinel of a row that sees no key; fixed orders, no atomics) on
// bf16 q, k, v and dO.  The key bias, lse and delta stay float32; o, dq,
// dk and dv are bf16, each rounded once from its float32 accumulator; lse
// and dkb are float32.
//
// Replaces the same pallas_calls as flash_attention.cu with bf16 operands:
// paddle_tpu/ops/pallas_kernels.py _flash_fwd (pallas_call :279, body
// _flash_fwd_kernel) and _flash_bwd (dq :447, dk/dv :471).  The Pallas
// bodies widen q, k, v and dO to float32 and keep p and dS float32 for
// the second products (p v, dS k, p^T dO, dS^T q), accumulating in
// float32: these kernels do the same arithmetic on the tensor cores.
//
// Tensor-core form (d 64): mma.sync.m16n8k16 bf16 with float32
// accumulation (bf16_mma.cuh).  The product of two bf16 values is exact
// in float32, so q k^T and dO v^T are the widened products of the
// reference up to the order of their sums; the scale is applied to the
// float32 scores.  The products with a float32 operand (p v, dS k, p^T dO,
// dS^T q) take it as a bf16 hi + lo pair, hi = bf16(p) and lo = bf16(p -
// hi), two products each: p is kept to ~2^-16 relative where a single
// rounding to bf16 (the reference's dense path, not its kernel) would
// keep 2^-8.  Blocks as in the float32 tensor-core form: 8 warps of 16 own
// rows; the forward a (bh, 128-query tile) walking 64-key tiles, dq the
// same walking 64-key tiles, dk/dv a (bh, 128-key tile) walking 32-query
// tiles, computing S^T = k q^T and dP^T = v dO^T so that the scores stay
// in the accumulator fragments, whose layout over two 8-column blocks is
// the A fragment of the next product's 16-deep step over those columns.
// The resident operand (q; q and dO; k and v) is staged once and held in
// registers as A fragments for the whole walk; the walked tiles come in a
// ring of two cp.async stages of 16-byte copies (half the float32 form's
// bytes), read by ldmatrix (.trans for the [depth][column] operands: v in
// p v, k in dS k, dO and q in dk/dv) from rows whose 16-byte chunks are
// XOR-swizzled by row % 8, so each 8-address phase hits 8 bank groups.
//
// SIMT form (d 128; dq at d 64 within 64 x 64): flash_simt.cuh's kernels
// with bf16 operands widened as they are staged (flash_plan gives the
// same form at a shape in both dtypes).
//
// Bound on the card: operations at the training shapes.  GPT-2's forward
// (BH 96, T 1024, causal) is about 12.9 GFLOP over the causal half: 0.013
// ms at bf16's 989 TFLOP/s against 0.015 ms for its 50 MB of bytes; these
// kernels issue twice the bf16 products of the second product (hi and lo).
#include "bf16_mma.cuh"
#include "common.cuh"
#include "flash_simt.cuh"
#include "tf32_mma.cuh"

namespace {

using ptt::bf16;
using ptt::kLog2e;
using ptt::ldsm_x4;
using ptt::ldsm_x4_t;
using ptt::mma_bf16;
using ptt::quad_max;
using ptt::quad_sum;

constexpr int HD = 64;         // head dim
constexpr int NW = 8;          // warps a block
constexpr int NT = 32 * NW;    // threads a block
constexpr int OWN = 16 * NW;   // a block's own rows: 16 a warp
constexpr int KWALK = 64;      // the forward's and dq's key tile
constexpr int QWALK = 32;      // dk/dv's query tile
constexpr int TILE_B = 2 * HD;  // bytes of a staged row

// a [rows][64] bf16 tile: chunk c (8 elements) of row r at chunk c ^ (r % 8)
struct Swz8 {
  __device__ __forceinline__ int operator()(int r) const { return r & 7; }
};

__device__ __forceinline__ const bf16* at(const bf16* tile, int r, int c) {
  return ptt::at_bf16(tile, HD, r, c, Swz8());
}

// rows [r0, r0 + R) of a [T, 64] bf16 matrix into a swizzled tile by
// 16-byte cp.async; rows at or past T zero-filled
template <int R>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int r0, int T) {
  ptt::stage_bf16(dst, src, R, HD, HD, r0, 0, T, HD, ptt::kCopy16, threadIdx.x, NT, Swz8());
}

// the warp's 16 rows [r, r + 16) of a staged tile as the A operand of
// the four 16-deep steps over d
__device__ __forceinline__ void load_a(unsigned (&a)[4][4], const bf16* tile, int r) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4(a[kk], at(tile, r + (lane & 15), 16 * kk + 8 * (lane >> 4)));
}

// s[j] (+)= A B^T over d, the 8-row blocks j of B = the tile's rows
// [0, 8 NJ) (rows as the product's columns: k in q k^T)
template <int NJ>
__device__ __forceinline__ void product_nt(float (&s)[NJ][4], const unsigned (&a)[4][4],
                                           const bf16* tile) {
  const int lane = threadIdx.x & 31;
  const int row = (lane & 7) + ((lane >> 4) << 3), col = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int jp = 0; jp < NJ / 2; ++jp) {
      unsigned b[4];
      ldsm_x4(b, at(tile, 16 * jp + row, 16 * kk + col));
      mma_bf16(s[2 * jp], a[kk], b[0], b[1]);
      mma_bf16(s[2 * jp + 1], a[kk], b[2], b[3]);
    }
}

// the bf16 hi + lo pair of two floats: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_hi_lo(float x, float y, unsigned& hi, unsigned& lo) {
  hi = ptt::pack2(x, y);
  lo = ptt::pack2(x - __uint_as_float(hi << 16), y - __uint_as_float(hi & 0xffff0000u));
}

// acc[n] += P V over the 8 d-blocks n: P the float32 accumulator
// fragments p[j] over the tile's first 8 NJ rows of depth (hi and lo
// products), V = the tile's rows [0, 8 NJ) as [depth][d]
template <int NJ>
__device__ __forceinline__ void product_pv(float (&acc)[8][4], const float (&p)[NJ][4],
                                           const bf16* tile) {
  const int lane = threadIdx.x & 31;
  const int row = (lane & 7) + (((lane >> 3) & 1) << 3), col = (lane >> 4) << 3;
#pragma unroll
  for (int kc = 0; kc < NJ / 2; ++kc) {
    unsigned hi[4], lo[4];
    split_hi_lo(p[2 * kc][0], p[2 * kc][1], hi[0], lo[0]);
    split_hi_lo(p[2 * kc][2], p[2 * kc][3], hi[1], lo[1]);
    split_hi_lo(p[2 * kc + 1][0], p[2 * kc + 1][1], hi[2], lo[2]);
    split_hi_lo(p[2 * kc + 1][2], p[2 * kc + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned b[4];
      ldsm_x4_t(b, at(tile, 16 * kc + row, 16 * np + col));
      mma_bf16(acc[2 * np], hi, b[0], b[1]);
      mma_bf16(acc[2 * np], lo, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], hi, b[2], b[3]);
      mma_bf16(acc[2 * np + 1], lo, b[2], b[3]);
    }
  }
}

// rows g and g + 8 of a 16 x 64 float32 fragment set, rounded once, into
// [T, 64] bf16 rows r0 + g, r0 + g + 8 (below T), times `mul`
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[8][4], int r0, int T,
                                           float mul_a, float mul_b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= T) continue;
    const float mul = half == 0 ? mul_a : mul_b;
    unsigned* out = reinterpret_cast<unsigned*>(dst + static_cast<long>(row) * HD + 2 * t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      out[4 * n] = ptt::pack2(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// forward: a block per (bh, OWN-query tile), walking KWALK-key tiles
// ---------------------------------------------------------------------------
constexpr int FWD_SLOT = 2 * KWALK * TILE_B + 2 * 4 * KWALK;  // k, v; key bias, key ids
constexpr int FWD_SMEM = OWN * TILE_B + 2 * FWD_SLOT;

__global__ void __launch_bounds__(NT, 1) bf16_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ kb, const int* __restrict__ qbase, bf16* __restrict__ o,
    float* __restrict__ lse, int Tq, int Tk, bool causal, int qstride, float scale,
    int window, const int* __restrict__ seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3, g = lane >> 2;
  const int bh = blockIdx.x;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * OWN;  // heavy first
  const int r0 = q0 + 16 * (tid >> 5);  // the warp's first row
  const int qpos0 = query_base(qbase, qstride, bh);
  const bf16* kbase = k + static_cast<long>(bh) * Tk * HD;
  const bf16* vbase = v + static_cast<long>(bh) * Tk * HD;
  const float* kbb = kb != nullptr ? kb + static_cast<long>(bh) * Tk : nullptr;
  const int* segb = seg != nullptr ? seg + static_cast<long>(bh) * Tk : nullptr;

  const int kt0 = first_key_tile(q0, window, qpos0, KWALK);
  const int n_t = max(0, key_tiles(q0, OWN, Tq, Tk, causal, qpos0, KWALK) - kt0);
  auto slot = [&](int i) { return smem + OWN * TILE_B + (i & 1) * FWD_SLOT; };
  auto feed = [&](int i) {
    if (i < n_t) {
      bf16* ks = reinterpret_cast<bf16*>(slot(i));
      float* kbs = reinterpret_cast<float*>(ks + 2 * KWALK * HD);
      const int k0 = (kt0 + i) * KWALK;
      stage<KWALK>(ks, kbase, k0, Tk);
      stage<KWALK>(ks + KWALK * HD, vbase, k0, Tk);
      stage_vec<KWALK>(kbs, kbb, k0, Tk);
      stage_vec<KWALK>(kbs + KWALK, segb, k0, Tk);
    }
    ptt::cp_async_commit();
  };
  stage<OWN>(Qs, q + static_cast<long>(bh) * Tq * HD, q0, Tq);
  ptt::cp_async_commit();
  feed(0);
  feed(1);
  ptt::cp_async_wait(2);
  __syncthreads();  // q landed
  unsigned qa[4][4];
  load_a(qa, Qs, r0 - q0);

  const int pa = qpos0 + r0 + g, pb = pa + 8;  // rows g and g + 8: positions, ids
  const int sa = (segb != nullptr && r0 + g < Tq) ? segb[r0 + g] : 0;
  const int sb = (segb != nullptr && r0 + g + 8 < Tq) ? segb[r0 + g + 8] : 0;
  const bool warp_live = r0 < Tq;
  const int wp0 = qpos0 + r0, wp1 = qpos0 + min(r0 + 15, Tq - 1);  // the warp's positions
  float acc[8][4], m_a = ptt::kNegInf, m_b = ptt::kNegInf, l_a = 0.f, l_b = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int i = 0; i < n_t; ++i) {
    const int k0 = (kt0 + i) * KWALK;
    ptt::cp_async_wait(1);
    __syncthreads();  // tile i landed
    const bf16* ks = reinterpret_cast<const bf16*>(slot(i));
    const bf16* vs = ks + KWALK * HD;
    const float* kbs = reinterpret_cast<const float*>(vs + KWALK * HD);
    const int* segk = reinterpret_cast<const int*>(kbs + KWALK);
    // a tile none of the warp's rows sees costs the warp nothing
    if (warp_live && !(causal && k0 > wp1) &&
        !(window > 0 && static_cast<long>(wp0) - (k0 + KWALK - 1) >= window)) {
      const bool full = segb == nullptr && k0 + KWALK <= Tk &&
                        (!causal || k0 + KWALK - 1 <= wp0) &&
                        (window <= 0 || static_cast<long>(wp1) - k0 < window);
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      product_nt(s, qa, ks);
      unsigned live = ~0u;  // bit 4 j + e: element (j, e) is visible
      if (!full) {
        live = 0u;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * t + (e & 1);
            if (visible(k0 + c, Tk, e < 2 ? pa : pb, causal, window, segb, e < 2 ? sa : sb,
                        segb != nullptr ? segk[c] : 0))
              live |= 1u << (4 * j + e);
          }
      }
      float mx_a = ptt::kNegInf, mx_b = ptt::kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = fmaf(s[j][e], scale, kbb != nullptr ? kbs[8 * j + 2 * t + (e & 1)] : 0.f);
          s[j][e] = (live >> (4 * j + e)) & 1u ? x : ptt::kNegInf;
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
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (live >> (4 * j + e)) & 1u
                              ? exp2f((s[j][e] - (e < 2 ? mn_a : mn_b)) * kLog2e)
                              : 0.f;
          s[j][e] = p;
          if (e < 2)
            ps_a += p;
          else
            ps_b += p;
        }
      l_a = l_a * al_a + ps_a;
      l_b = l_b * al_b + ps_b;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[n][0] *= al_a;
        acc[n][1] *= al_a;
        acc[n][2] *= al_b;
        acc[n][3] *= al_b;
      }
      product_pv(acc, s, vs);  // the probabilities never leave the registers
    }
    __syncthreads();  // every warp is done with slot i % 2
    feed(i + 2);
  }
  ptt::cp_async_wait(0);

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float safe_a = l_a == 0.f ? 1.f : l_a, safe_b = l_b == 0.f ? 1.f : l_b;
  store_rows(o + static_cast<long>(bh) * Tq * HD, acc, r0, Tq, 1.f / safe_a, 1.f / safe_b);
  if (t == 0) {
    if (r0 + g < Tq) lse[static_cast<long>(bh) * Tq + r0 + g] = m_a + logf(safe_a);
    if (r0 + g + 8 < Tq) lse[static_cast<long>(bh) * Tq + r0 + g + 8] = m_b + logf(safe_b);
  }
}

// ---------------------------------------------------------------------------
// dq: a block per (bh, OWN-query tile), walking KWALK-key tiles; q and dO
// held as A fragments, the registers holding dq and a tile's S and dP
// ---------------------------------------------------------------------------
constexpr int DQ_SLOT = FWD_SLOT;  // k, v; key bias, key ids
constexpr int DQ_SMEM = 2 * OWN * TILE_B + 2 * DQ_SLOT;

__global__ void __launch_bounds__(NT, 1) bf16_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ kb, const float* __restrict__ lse, const bf16* __restrict__ dout,
    const float* __restrict__ delta, const int* __restrict__ qbase, bf16* __restrict__ dq,
    int Tq, int Tk, bool causal, int qstride, float scale, int window,
    const int* __restrict__ seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + OWN * HD;
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3, g = lane >> 2;
  const int bh = blockIdx.x;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * OWN;
  const int r0 = q0 + 16 * (tid >> 5);
  const long qoff = static_cast<long>(bh) * Tq;
  const int qpos0 = query_base(qbase, qstride, bh);
  const bf16* kbase = k + static_cast<long>(bh) * Tk * HD;
  const bf16* vbase = v + static_cast<long>(bh) * Tk * HD;
  const float* kbb = kb != nullptr ? kb + static_cast<long>(bh) * Tk : nullptr;
  const int* segb = seg != nullptr ? seg + static_cast<long>(bh) * Tk : nullptr;

  const int kt0 = first_key_tile(q0, window, qpos0, KWALK);
  const int n_t = max(0, key_tiles(q0, OWN, Tq, Tk, causal, qpos0, KWALK) - kt0);
  auto slot = [&](int i) { return smem + 2 * OWN * TILE_B + (i & 1) * DQ_SLOT; };
  auto feed = [&](int i) {
    if (i < n_t) {
      bf16* ks = reinterpret_cast<bf16*>(slot(i));
      float* kbs = reinterpret_cast<float*>(ks + 2 * KWALK * HD);
      const int k0 = (kt0 + i) * KWALK;
      stage<KWALK>(ks, kbase, k0, Tk);
      stage<KWALK>(ks + KWALK * HD, vbase, k0, Tk);
      stage_vec<KWALK>(kbs, kbb, k0, Tk);
      stage_vec<KWALK>(kbs + KWALK, segb, k0, Tk);
    }
    ptt::cp_async_commit();
  };
  stage<OWN>(Qs, q + qoff * HD, q0, Tq);
  stage<OWN>(dOs, dout + qoff * HD, q0, Tq);
  ptt::cp_async_commit();
  feed(0);
  feed(1);
  ptt::cp_async_wait(2);
  __syncthreads();  // q and dO landed
  unsigned qa[4][4], da[4][4];
  load_a(qa, Qs, r0 - q0);
  load_a(da, dOs, r0 - q0);

  const int ra = r0 + g, rb = ra + 8;
  const float lse_a = ra < Tq ? lse[qoff + ra] : 0.f, lse_b = rb < Tq ? lse[qoff + rb] : 0.f;
  const float dl_a = ra < Tq ? delta[qoff + ra] : 0.f, dl_b = rb < Tq ? delta[qoff + rb] : 0.f;
  // the reference's guard: a row whose lse is the sentinel takes no gradient
  const bool live_a = lse_a > ptt::kNegInf / 2, live_b = lse_b > ptt::kNegInf / 2;
  const int pa = qpos0 + ra, pb = pa + 8;
  const int sa = (segb != nullptr && ra < Tq) ? segb[ra] : 0;
  const int sb = (segb != nullptr && rb < Tq) ? segb[rb] : 0;
  const bool warp_live = r0 < Tq;
  const int wp0 = qpos0 + r0, wp1 = qpos0 + min(r0 + 15, Tq - 1);
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int i = 0; i < n_t; ++i) {
    const int k0 = (kt0 + i) * KWALK;
    ptt::cp_async_wait(1);
    __syncthreads();  // tile i landed
    const bf16* ks = reinterpret_cast<const bf16*>(slot(i));
    const bf16* vs = ks + KWALK * HD;
    const float* kbs = reinterpret_cast<const float*>(vs + KWALK * HD);
    const int* segk = reinterpret_cast<const int*>(kbs + KWALK);
    if (warp_live && !(causal && k0 > wp1) &&
        !(window > 0 && static_cast<long>(wp0) - (k0 + KWALK - 1) >= window)) {
      const bool full = segb == nullptr && k0 + KWALK <= Tk &&
                        (!causal || k0 + KWALK - 1 <= wp0) &&
                        (window <= 0 || static_cast<long>(wp1) - k0 < window);
      float s[8][4], dp[8][4];  // S = q k^T, dP = dO v^T
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      product_nt(s, qa, ks);
      product_nt(dp, da, vs);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          const bool valid =
              (e < 2 ? live_a : live_b) &&
              (full || visible(k0 + c, Tk, e < 2 ? pa : pb, causal, window, segb,
                               e < 2 ? sa : sb, segb != nullptr ? segk[c] : 0));
          const float p =
              valid ? exp2f((fmaf(s[j][e], scale, kbb != nullptr ? kbs[c] : 0.f) -
                             (e < 2 ? lse_a : lse_b)) * kLog2e)
                    : 0.f;
          s[j][e] = p * (dp[j][e] - (e < 2 ? dl_a : dl_b));  // dS
        }
      product_pv(acc, s, ks);  // dq += dS k
    }
    __syncthreads();  // every warp is done with slot i % 2
    feed(i + 2);
  }
  ptt::cp_async_wait(0);
  store_rows(dq + qoff * HD, acc, r0, Tq, scale, scale);
}

// ---------------------------------------------------------------------------
// dk / dv / dkb: a block per (bh, OWN-key tile), walking QWALK-query
// tiles; k and v held as A fragments, the registers holding dk, dv and a
// tile's S^T and dP^T
// ---------------------------------------------------------------------------
constexpr int DKV_SLOT = 2 * QWALK * TILE_B + 3 * 4 * QWALK;  // q, dO; lse, delta, ids
constexpr int DKV_SMEM = 2 * OWN * TILE_B + 2 * DKV_SLOT;

__global__ void __launch_bounds__(NT, 1) bf16_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ kb, const float* __restrict__ lse, const bf16* __restrict__ dout,
    const float* __restrict__ delta, const int* __restrict__ qbase, bf16* __restrict__ dk,
    bf16* __restrict__ dv, float* __restrict__ dkb, int Tq, int Tk, bool causal, int qstride,
    float scale, int window, const int* __restrict__ seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + OWN * HD;
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3, g = lane >> 2;
  const int bh = blockIdx.x;
  const long qoff = static_cast<long>(bh) * Tq;
  const long koff = static_cast<long>(bh) * Tk;
  const int qpos0 = query_base(qbase, qstride, bh);
  const bf16* qrows = q + qoff * HD;
  const bf16* orows = dout + qoff * HD;
  const int* segb = seg != nullptr ? seg + koff : nullptr;
  const int nqt = (Tq + QWALK - 1) / QWALK;
  const int k0 = blockIdx.y * OWN;
  const int kr0 = k0 + 16 * (tid >> 5);  // the warp's first key

  // causal: a query tile whose last query comes before the block's first
  // key sees none of it; window: from the first query tile whose first
  // query is at or past k0 + OWN - 1 + window none do
  const int qt0 = causal ? max(0, (k0 - qpos0) / QWALK) : 0;
  int qt1 = nqt;
  if (window > 0) {
    const long lim = static_cast<long>(k0) + OWN - 1 + window - qpos0;
    const long tiles = lim <= 0 ? 0 : (lim + QWALK - 1) / QWALK;
    qt1 = tiles < nqt ? static_cast<int>(tiles) : nqt;
  }
  const int n_t = max(0, qt1 - qt0);
  auto slot = [&](int i) { return smem + 2 * OWN * TILE_B + (i & 1) * DKV_SLOT; };
  auto feed = [&](int i) {
    if (i < n_t) {
      bf16* qs = reinterpret_cast<bf16*>(slot(i));
      float* ls = reinterpret_cast<float*>(qs + 2 * QWALK * HD);
      const int q0 = (qt0 + i) * QWALK;
      stage<QWALK>(qs, qrows, q0, Tq);
      stage<QWALK>(qs + QWALK * HD, orows, q0, Tq);
      stage_vec<QWALK>(ls, lse + qoff, q0, Tq);
      stage_vec<QWALK>(ls + QWALK, delta + qoff, q0, Tq);
      stage_vec<QWALK>(ls + 2 * QWALK, segb, q0, Tq);
    }
    ptt::cp_async_commit();
  };
  stage<OWN>(Ks, k + koff * HD, k0, Tk);
  stage<OWN>(Vs, v + koff * HD, k0, Tk);
  ptt::cp_async_commit();
  feed(0);
  feed(1);
  ptt::cp_async_wait(2);
  __syncthreads();  // k and v landed
  unsigned ka[4][4], va[4][4];
  load_a(ka, Ks, kr0 - k0);
  load_a(va, Vs, kr0 - k0);

  const int key_a = kr0 + g, key_c = key_a + 8;  // rows g and g + 8
  const float kb_a = (kb != nullptr && key_a < Tk) ? kb[koff + key_a] : 0.f;
  const float kb_c = (kb != nullptr && key_c < Tk) ? kb[koff + key_c] : 0.f;
  const int sk_a = (segb != nullptr && key_a < Tk) ? segb[key_a] : 0;
  const int sk_c = (segb != nullptr && key_c < Tk) ? segb[key_c] : 0;
  const bool warp_live = kr0 < Tk;
  const int wk1 = min(kr0 + 15, Tk - 1);  // the warp's last key
  float dk_acc[8][4], dv_acc[8][4], dkb_a = 0.f, dkb_c = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int i = 0; i < n_t; ++i) {
    const int q0 = (qt0 + i) * QWALK;
    ptt::cp_async_wait(1);
    __syncthreads();  // tile i landed
    const bf16* qs = reinterpret_cast<const bf16*>(slot(i));
    const bf16* os = qs + QWALK * HD;
    const float* lse_s = reinterpret_cast<const float*>(os + QWALK * HD);
    const float* dl_s = lse_s + QWALK;
    const int* segq = reinterpret_cast<const int*>(dl_s + QWALK);
    const long last_q = static_cast<long>(qpos0) + min(q0 + QWALK, Tq) - 1;
    if (warp_live && !(causal && last_q < kr0) &&
        !(window > 0 && static_cast<long>(qpos0) + q0 - wk1 >= window)) {
      const bool full = segb == nullptr && q0 + QWALK <= Tq && kr0 + 16 <= Tk &&
                        (!causal || static_cast<long>(qpos0) + q0 >= kr0 + 15) &&
                        (window <= 0 || last_q - kr0 < window);
      float st[4][4], dpt[4][4];  // S^T = k q^T, dP^T = v dO^T
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      product_nt(st, ka, qs);
      product_nt(dpt, va, os);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);  // the query in the tile
          const float lq = lse_s[c];
          const bool valid =
              lq > ptt::kNegInf / 2 &&
              (full || (q0 + c < Tq &&
                        visible(e < 2 ? key_a : key_c, Tk, qpos0 + q0 + c, causal, window, segb,
                                segb != nullptr ? segq[c] : 0, e < 2 ? sk_a : sk_c)));
          const float p =
              valid ? exp2f((fmaf(st[j][e], scale, e < 2 ? kb_a : kb_c) - lq) * kLog2e) : 0.f;
          const float ds = p * (dpt[j][e] - dl_s[c]);
          if (e < 2)
            dkb_a += ds;
          else
            dkb_c += ds;
          st[j][e] = p;
          dpt[j][e] = ds;
        }
      product_pv(dv_acc, st, os);   // dv += P^T dO
      product_pv(dk_acc, dpt, qs);  // dk += dS^T q
    }
    __syncthreads();  // every warp is done with slot i % 2
    feed(i + 2);
  }
  ptt::cp_async_wait(0);

  dkb_a = quad_sum(dkb_a);
  dkb_c = quad_sum(dkb_c);
  store_rows(dk + koff * HD, dk_acc, kr0, Tk, scale, scale);
  store_rows(dv + koff * HD, dv_acc, kr0, Tk, 1.f, 1.f);
  if (dkb != nullptr && t == 0) {
    if (key_a < Tk) dkb[koff + key_a] = dkb_a;
    if (key_c < Tk) dkb[koff + key_c] = dkb_c;
  }
}

int launch_tc_fwd(const bf16* q, const bf16* k, const bf16* v, const float* kb,
                  const int* qbase, bf16* o, float* lse, int BH, int Tq, int Tk, bool causal,
                  int qstride, float scale, int window, const int* seg, cudaStream_t stream) {
  static int ready = prepare(bf16_fwd_kernel, FWD_SMEM);
  if (ready != 0) return ready;
  const dim3 grid(BH, (Tq + OWN - 1) / OWN);
  bf16_fwd_kernel<<<grid, NT, FWD_SMEM, stream>>>(q, k, v, kb, qbase, o, lse, Tq, Tk, causal,
                                                  qstride, scale, window, seg);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc_dq(const bf16* q, const bf16* k, const bf16* v, const float* kb,
                 const float* lse, const bf16* dout, const float* delta, const int* qbase,
                 bf16* dq, int BH, int Tq, int Tk, bool causal, int qstride, float scale,
                 int window, const int* seg, cudaStream_t stream) {
  static int ready = prepare(bf16_dq_kernel, DQ_SMEM);
  if (ready != 0) return ready;
  const dim3 grid(BH, (Tq + OWN - 1) / OWN);
  bf16_dq_kernel<<<grid, NT, DQ_SMEM, stream>>>(q, k, v, kb, lse, dout, delta, qbase, dq, Tq,
                                                Tk, causal, qstride, scale, window, seg);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc_dkv(const bf16* q, const bf16* k, const bf16* v, const float* kb,
                  const float* lse, const bf16* dout, const float* delta, const int* qbase,
                  bf16* dk, bf16* dv, float* dkb, int BH, int Tq, int Tk, bool causal,
                  int qstride, float scale, int window, const int* seg, cudaStream_t stream) {
  static int ready = prepare(bf16_dkv_kernel, DKV_SMEM);
  if (ready != 0) return ready;
  const dim3 grid(BH, (Tk + OWN - 1) / OWN);
  bf16_dkv_kernel<<<grid, NT, DKV_SMEM, stream>>>(q, k, v, kb, lse, dout, delta, qbase, dk,
                                                  dv, dkb, Tq, Tk, causal, qstride, scale,
                                                  window, seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 entry points: the float32 forms' operands and checks
// (flash_attention.cu), with q, k, v, dO, o, dq, dk and dv bf16.
extern "C" int ptt_flash_attention_fwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                                            const float* kb, const int* qbase, bf16* o,
                                            float* lse, int BH, int Tq, int Tk, int d,
                                            int form, int causal, int qstride, float scale,
                                            int window, const int* seg,
                                            cudaStream_t stream) {
  if (BH == 0 || Tq == 0) return static_cast<int>(cudaSuccess);
  if (Tk == 0 || bad_operands(qbase, Tq, Tk, causal, qstride, window, seg) ||
      bad_form(form, d, Tq, Tk, false))
    return static_cast<int>(cudaErrorInvalidValue);
  if (form == 1)
    return launch_tc_fwd(q, k, v, kb, qbase, o, lse, BH, Tq, Tk, causal != 0, qstride, scale,
                         window, seg, stream);
  return launch_simt_fwd<128>(q, k, v, kb, qbase, o, lse, BH, Tq, Tk, causal != 0, qstride,
                              scale, window, seg, stream);
}

extern "C" int ptt_flash_attention_dq_bf16(const bf16* q, const bf16* k, const bf16* v,
                                           const float* kb, const int* qbase, const float* lse,
                                           const bf16* dout, const float* delta, bf16* dq,
                                           int BH, int Tq, int Tk, int d, int form, int causal,
                                           int qstride, float scale, int window,
                                           const int* seg, cudaStream_t stream) {
  if (BH == 0 || Tq == 0) return static_cast<int>(cudaSuccess);
  if (Tk == 0 || bad_operands(qbase, Tq, Tk, causal, qstride, window, seg) ||
      bad_form(form, d, Tq, Tk, true))
    return static_cast<int>(cudaErrorInvalidValue);
  if (form == 1)
    return launch_tc_dq(q, k, v, kb, lse, dout, delta, qbase, dq, BH, Tq, Tk, causal != 0,
                        qstride, scale, window, seg, stream);
  if (d == 64)
    return launch_simt_dq<64>(q, k, v, kb, lse, dout, delta, qbase, dq, BH, Tq, Tk,
                              causal != 0, qstride, scale, window, seg, stream);
  return launch_simt_dq<128>(q, k, v, kb, lse, dout, delta, qbase, dq, BH, Tq, Tk,
                             causal != 0, qstride, scale, window, seg, stream);
}

extern "C" int ptt_flash_attention_dkv_bf16(const bf16* q, const bf16* k, const bf16* v,
                                            const float* kb, const int* qbase,
                                            const float* lse, const bf16* dout,
                                            const float* delta, bf16* dk, bf16* dv,
                                            float* dkb, int BH, int Tq, int Tk, int d,
                                            int form, int causal, int qstride, float scale,
                                            int window, const int* seg,
                                            cudaStream_t stream) {
  if (BH == 0 || Tk == 0) return static_cast<int>(cudaSuccess);
  if (Tq == 0 || bad_operands(qbase, Tq, Tk, causal, qstride, window, seg) ||
      bad_form(form, d, Tq, Tk, false))
    return static_cast<int>(cudaErrorInvalidValue);
  if (form == 1)
    return launch_tc_dkv(q, k, v, kb, lse, dout, delta, qbase, dk, dv, dkb, BH, Tq, Tk,
                         causal != 0, qstride, scale, window, seg, stream);
  return launch_simt_dkv<128, 32>(q, k, v, kb, lse, dout, delta, qbase, dk, dv, dkb, BH, Tq,
                                  Tk, causal != 0, qstride, scale, window, seg, stream);
}
