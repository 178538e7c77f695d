// flash_attention: blocked online-softmax attention over q [BH, Tq, d] and
// k, v [BH, Tk, d], float32, with an optional additive key bias kb [BH, Tk],
// causal masking, an optional sliding window and optional segment ids.
// Query row i of head row b sits at global position p = base(b) + i and,
// causal, sees keys 0 .. p, where the optional query base is read on the
// device: qbase[b * qstride] (stride 0: one scalar offset for every row;
// stride 1: a [BH] vector of per-row bases).  With no base, base(b) = 0
// and causal needs Tq == Tk.  A window w > 0 (causal only) keeps the keys
// j with p - j < w.  Segment ids seg [BH, T] (Tq == Tk, no base; sequence
// packing) keep the keys j with seg[b, j] == seg[b, i].  Three kernels:
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
// and _flash_dkv_kernel; causal block skip _band), and the same three
// pallas_calls with a query base: flash_attention_piece (scalar qoff, the
// chunked-decode and ring-attention piece) and the backward of
// flash_attention_qvec (per-row qvec).  The piece's lse cotangent folds
// into delta in the caller (delta = rowsum(o * dO) - dlse, as _flash_bwd
// does), so the kernels do not change for it.  The sliding window is
// _band's (in global positions), the segment ids are the has_seg operands
// of _unpack_flash_refs, compared per score tile as the reference does.
//
// Bound on the card: operations.  At the GPT-2 training shapes (BH 96, T
// 1024, d 64, causal) the forward does 2 matrix products over the causal
// half of the [T, T] scores (about 12.9 GFLOP) against 100 MB of q, k, v,
// o and lse: 0.1925 ms at the FP32 rate (67 TFLOP/s), 0.0782 ms on the
// tensor cores in 3xTF32 (three TF32 products at 495 TFLOP/s for each
// float32 one), both above the 0.030 ms the bytes take; dq does 3
// products and dk/dv 4.
//
// Two forms, one chosen for each kernel and shape (flash_plan in
// flash_attention.py, handed in as `form` and checked here): the
// tensor-core form at head dim 64, the SIMT form at head dim 128 (whose
// resident operands overflow the tensor-core form's registers) and for
// dq at shapes within 64 x 64.  Both keep every mask below.  On the TPU
// the grid runs in order and carries the online-softmax state in VMEM
// scratch across key blocks; on Hopper blocks run in parallel, so each
// block owns its output tile and walks the other operand's tiles in order
// inside one loop.  No atomics: every sum runs in a fixed order, so a
// result is a pure function of the inputs (reruns are bit-equal, and a
// row's bits do not depend on BH).
//
// Tensor-core form (d 64): 3xTF32 on mma.sync m16n8k8 (tf32_mma.cuh).
//   forward: a block of 8 warps per (bh, 128-query tile), walking 64-key
//            tiles; dq: the same blocks walking 32-key tiles; dk/dv: a
//            block per (bh, 128-key tile), walking 32-query tiles.  A
//            warp owns 16 rows: queries in the forward and dq, keys in
//            dk/dv, which computes S^T = k q^T and dP^T = v dO^T, so the
//            scores stay in the accumulator fragments and a row's max
//            and sum reduce over the 4 lanes of a quad.
//   - The walked operand (k, v; q, dO with lse and delta) is staged by
//     16-byte cp.async into a ring of two stages: tile i + 1 is in flight
//     while tile i's products run.  Each landed tile is split once by the
//     whole block into big and small TF32 parts (rounded in integer ops,
//     split_rna), in the fragment order of each product that reads it:
//     one 16-byte shared-memory word a lane and mma.
//   - The resident operand is split once for the whole walk: q into
//     registers in dq; q (forward), dO (dq) and k (dk/dv) into the warp's
//     own shared memory; v (dk/dv) is kept there raw and split at each
//     use, since both split would pass the block's shared memory.  The
//     registers hold the accumulators and a tile's scores; this placement
//     ran fastest of those tried on the card.
//   - P never goes to shared memory: under tf32_mma.cuh's depth order the
//     accumulator fragment of an 8-column block of S is the A fragment of
//     the next product's 8-deep step over those columns (split_acc), for
//     P v, dS k, P^T dO and dS^T q.
//   - The tensor core's own accumulation rounds toward zero, so each
//     product of a tile starts from a zeroed fragment: the scores over d
//     64, the second products in 32-deep chunks, each added in float32 to
//     the running accumulator (after the alpha rescale in the forward).
//   - The forward launches its heaviest query tiles first.  dk/dv keeps
//     the SIMT form's ascending key tiles, whose first (under causal
//     masking, the one that walks every query tile) is the heaviest:
//     pairing key tile y with nk - 1 - y in one block ran 2-3% slower on
//     the card.  A warp skips a tile none of its rows sees, and masks per
//     entry only on a tile that is not wholly visible.
//
// The SIMT kernels and the mask helpers live in flash_simt.cuh, shared
// with the bf16 forms (flash_attention_bf16.cu), which stage bf16
// operands into the same float32 tiles.
//
// The forward's bf16-KV form (ptt_flash_attention_fwd_kvbf16: B9's chunked
// decode and speculative verify over a bf16 KV cache) reads bf16 k and v
// beside float32 q, o, lse and key bias, as _flash_fwd_kernel takes them:
// the tensor-core form stages the bf16 tiles by 16-byte cp.async (8
// elements a copy) and widens them as it splits them (a bf16 value is
// exact in TF32, so its small word is 0), the SIMT form widens them as it
// stages them.  Every product and sum is the float32 form's.
//
// SIMT form (d 128; dq within 64 x 64): FP32 FMAs, 256 threads a block,
// the forward and dq per (bh, 64-query tile) walking 64-key tiles, dk/dv
// per (bh, 64-key tile) walking 32-query tiles.  Every
// score tile is a register-tiled product: thread (ty, tx) of the 16 x 16
// grid owns 4 rows x 4 columns of it, reading both operands as float4
// from transposed [d][tile] shared-memory copies; the probabilities (or
// dS) go through shared memory to the second product; a row's 64 scores
// sit in 16 lanes of one half-warp, reduced with xor shuffles.
//
// Masks, in both forms.  Key tiles wholly past a tile's last query (in
// global positions) are skipped (the _band block skip), and so are query
// tiles wholly before a key tile in dk/dv; the diagonal tile and the
// ragged tails of Tq and Tk are masked in the kernel: a masked score
// contributes exactly zero.  The backward keeps the reference's guard
// lse <= NEG_INF / 2 -> p = 0.  The window bounds the tiles walked from
// both sides: a query tile starts at the key tile of its first query's
// first visible key, and in dk/dv a key tile stops before the first query
// tile that lies wholly past its window, so the work scales with the
// window, not with T.  Segment ids skip no tile (as in the reference):
// each block stages its query tile's and each key tile's ids in shared
// memory and masks per entry.  In a packed row the early key tiles are
// wholly masked for a later segment's queries; such an entry adds exactly
// 0 to l, the accumulators and every gradient, and a row that sees no key
// at all (a window past the piece's keys) keeps lse = NEG_INF, the
// sentinel the backward guards on.
#include "common.cuh"
#include "flash_simt.cuh"
#include "tf32_mma.cuh"

namespace {

using ptt::kLog2e;
using ptt::quad_max;
using ptt::quad_sum;
using ptt::split_acc;

// ---- tensor-core form (d 64): 3xTF32 mma.sync tiles --------------------------------
using ptt::Split;
using ptt::cp_async16;
using ptt::cp_async_commit;
using ptt::cp_async_wait;
using ptt::mma3;
using ptt::split_rna;

constexpr int TD = 64;         // head dim
constexpr int TW = 8;          // warps a block
constexpr int TT = 32 * TW;    // threads a block
constexpr int TOWN = 16 * TW;  // a block's own rows: 16 a warp
constexpr int FWALK = 64;      // the forward's key tile
constexpr int BWALK = 32;      // dq's key tile, dk/dv's query tile
constexpr int LDR = TD + 8;    // a staged row's stride: conflict-free float2 reads
constexpr int AFRAG = 8 * 64;  // 16-byte words of a warp's split A operand

// a walked tile of R rows: floats staged, 16-byte words of its split form
template <int R>
struct Walk {
  static constexpr int kRaw = R * LDR;
  static constexpr int kFrag = R * TD / 2;
};

// The warp's 16 rows [r0, r0 + 16) of a [T, 64] matrix as the A operand,
// 8-deep step kk: x[kk] = rows (g, g + 8, g, g + 8) at depths (2t, 2t,
// 2t + 1, 2t + 1) of the step, tf32_mma.cuh's order; rows at or past T
// read as zero.
__device__ __forceinline__ void load_a(float (&x)[8][4], const float* src, int r0, int T) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bool in0 = r0 + g < T, in1 = r0 + g + 8 < T;
  const float* p0 = src + static_cast<long>(in0 ? r0 + g : 0) * TD + 2 * t;
  const float* p1 = src + static_cast<long>(in1 ? r0 + g + 8 : 0) * TD + 2 * t;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const float2 u = in0 ? *reinterpret_cast<const float2*>(p0 + 8 * kk) : make_float2(0.f, 0.f);
    const float2 w = in1 ? *reinterpret_cast<const float2*>(p1 + 8 * kk) : make_float2(0.f, 0.f);
    x[kk][0] = u.x;
    x[kk][1] = w.x;
    x[kk][2] = u.y;
    x[kk][3] = w.y;
  }
}

__device__ __forceinline__ void split_a(Split (&a)[4], const float (&x)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = split_rna(x[i]);
}

// The warp's A operand split once into its own AFRAG words of shared
// memory, for the whole walk where the registers cannot hold it:
// AF[64 kk + lane] the four big parts of step kk, AF[64 kk + 32 + lane]
// the four small ones.  The warp alone reads it back (after a __syncwarp).
__device__ __forceinline__ void store_a_split(uint4* AF, const float (&x)[8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    Split a[4];
    split_a(a, x[kk]);
    AF[64 * kk + lane] = make_uint4(a[0].big, a[1].big, a[2].big, a[3].big);
    AF[64 * kk + 32 + lane] = make_uint4(a[0].small, a[1].small, a[2].small, a[3].small);
  }
}

__device__ __forceinline__ void load_a_split(Split (&a)[4], const uint4* AF, int kk) {
  const int lane = threadIdx.x & 31;
  const uint4 b = AF[64 * kk + lane], s = AF[64 * kk + 32 + lane];
  a[0] = Split{b.x, s.x};
  a[1] = Split{b.y, s.y};
  a[2] = Split{b.z, s.z};
  a[3] = Split{b.w, s.w};
}

// rows [r0, r0 + R) of a [T, 64] matrix of E (float32; bf16 k and v in the
// forward's bf16-KV form) into a staged tile of E (row stride LDR elements,
// 16-byte aligned in both) by 16-byte cp.async; rows at or past T
// zero-filled
template <int R, class E = float>
__device__ __forceinline__ void stage_tile(float* dst, const E* src, int r0, int T) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(E));  // elements a copy
  constexpr int NC = TD / EPC;                           // copies a row
  E* tile = reinterpret_cast<E*>(dst);
#pragma unroll
  for (int it = 0; it < R * NC / TT; ++it) {
    const int i = threadIdx.x + it * TT;
    const int r = i / NC, c = (i % NC) * EPC;
    const bool in = r0 + r < T;
    ptt::cp_async16_b(tile + r * LDR + c, in ? src + static_cast<long>(r0 + r) * TD + c : src,
                      in);
  }
}

// A staged tile X [R][LDR] split once, for every warp, into the B operand
// of the products that read it, one 16-byte word a lane and 8 x 8 block
// ({big, big, small, small} of its two values, mma3's order).  K-style,
// X's rows are the product's columns (q k^T: X = k):
// F[(j 8 + kk) 32 + lane] holds X[8j + g][8kk + 2t], X[8j + g][8kk + 2t + 1].
// A bf16 tile is widened as it is read (exactly: its small words are 0).
template <int R, class E = float>
__device__ __forceinline__ void split_kstyle(uint4* F, const float* Xs) {
  const E* X = reinterpret_cast<const E*>(Xs);
#pragma unroll
  for (int it = 0; it < Walk<R>::kFrag / TT; ++it) {
    const int i = threadIdx.x + it * TT;
    const int lane = i & 31, jk = i >> 5;
    const int g = lane >> 2, t = lane & 3;
    const float2 x = ptt::widen2(X + (8 * (jk >> 3) + g) * LDR + 8 * (jk & 7) + 2 * t);
    const Split a = split_rna(x.x), b = split_rna(x.y);
    F[i] = make_uint4(a.big, b.big, a.small, b.small);
  }
}

// V-style, X's rows are the product's depth (P v: X = v):
// F[(j 8 + n) 32 + lane] holds X[8j + 2t][8n + g], X[8j + 2t + 1][8n + g].
template <int R, class E = float>
__device__ __forceinline__ void split_vstyle(uint4* F, const float* Xs) {
  const E* X = reinterpret_cast<const E*>(Xs);
#pragma unroll
  for (int it = 0; it < Walk<R>::kFrag / TT; ++it) {
    const int i = threadIdx.x + it * TT;
    const int lane = i & 31, jn = i >> 5;
    const int g = lane >> 2, t = lane & 3;
    const E* p = X + (8 * (jn >> 3) + 2 * t) * LDR + 8 * (jn & 7) + g;
    const Split a = split_rna(ptt::widen(p[0])), b = split_rna(ptt::widen(p[LDR]));
    F[i] = make_uint4(a.big, b.big, a.small, b.small);
  }
}

// acc[n] += sum over the NJ column blocks j0 .. j0 + NJ - 1 of a[j]
// B[j][n] (V-style F): one 8 NJ-deep product from zero for each n, added
// in float32 (the tensor core's own accumulation rounds toward zero)
template <int NJ>
__device__ __forceinline__ void product_add(float (&acc)[8][4], const Split (&a)[NJ][4],
                                            const uint4* F, int j0, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma3(c, a[j], F[((j0 + j) * 8 + n) * 32 + lane]);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += c[e];
  }
}

// ---------------------------------------------------------------------------
// forward: a block per (bh, TOWN-query tile), walking FWALK-key tiles; q
// split in shared memory, the registers holding o and a tile's scores.  KV
// is float32, or bf16 in the bf16-KV form (B9 over a bf16 cache), whose k
// and v tiles take the first half of their float32 slots
// ---------------------------------------------------------------------------
constexpr int FRAW = Walk<FWALK>::kRaw;
constexpr int FWD_SLOT = 2 * FRAW + 2 * FWALK;  // k, v; key bias, key ids
constexpr size_t FWD_SMEM = sizeof(float) * (2 * FWD_SLOT + 2 * FWALK) +
                            (2 * Walk<FWALK>::kFrag + TW * AFRAG) * sizeof(uint4);

template <class KV>
__global__ void __launch_bounds__(TT, 1) tc_fwd_kernel(
    const float* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
    const float* __restrict__ kb, const int* __restrict__ qbase, float* __restrict__ o,
    float* __restrict__ lse, int Tq, int Tk, bool causal, int qstride, float scale,
    int window, const int* __restrict__ seg) {
  extern __shared__ __align__(16) float smem[];
  uint4* Kf = reinterpret_cast<uint4*>(smem + 2 * FWD_SLOT);  // K-style k
  uint4* Vf = Kf + Walk<FWALK>::kFrag;                       // V-style v
  uint4* qa_s = Vf + Walk<FWALK>::kFrag + (threadIdx.x >> 5) * AFRAG;  // this warp's q
  float* kbs = reinterpret_cast<float*>(Vf + Walk<FWALK>::kFrag + TW * AFRAG);
  int* segk = reinterpret_cast<int*>(kbs + FWALK);
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3, g = lane >> 2;
  const int bh = blockIdx.x;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * TOWN;  // heavy first
  const int r0 = q0 + 16 * (tid >> 5);  // the warp's first row
  const int qpos0 = query_base(qbase, qstride, bh);
  const KV* kbase = k + static_cast<long>(bh) * Tk * TD;
  const KV* vbase = v + static_cast<long>(bh) * Tk * TD;
  const float* kbb = kb != nullptr ? kb + static_cast<long>(bh) * Tk : nullptr;
  const int* segb = seg != nullptr ? seg + static_cast<long>(bh) * Tk : nullptr;

  {  // q split once for the whole walk
    float x[8][4];
    load_a(x, q + static_cast<long>(bh) * Tq * TD, r0, Tq);
    store_a_split(qa_s, x);
    __syncwarp();
  }
  const int pa = qpos0 + r0 + g, pb = pa + 8;  // rows g and g + 8: positions, ids
  const int sa = (segb != nullptr && r0 + g < Tq) ? segb[r0 + g] : 0;
  const int sb = (segb != nullptr && r0 + g + 8 < Tq) ? segb[r0 + g + 8] : 0;
  const bool warp_live = r0 < Tq;
  const int wp0 = qpos0 + r0, wp1 = qpos0 + min(r0 + 15, Tq - 1);  // the warp's positions
  float acc[8][4], m_a = ptt::kNegInf, m_b = ptt::kNegInf, l_a = 0.f, l_b = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int kt0 = first_key_tile(q0, window, qpos0, FWALK);
  const int n_t = max(0, key_tiles(q0, TOWN, Tq, Tk, causal, qpos0, FWALK) - kt0);
  auto feed = [&](int i) {
    if (i < n_t) {
      float* slot = smem + (i & 1) * FWD_SLOT;
      const int k0 = (kt0 + i) * FWALK;
      stage_tile<FWALK>(slot, kbase, k0, Tk);
      stage_tile<FWALK>(slot + FRAW, vbase, k0, Tk);
      stage_vec<FWALK>(slot + 2 * FRAW, kbb, k0, Tk);
      stage_vec<FWALK>(slot + 2 * FRAW + FWALK, segb, k0, Tk);
    }
    cp_async_commit();
  };
  feed(0);
  feed(1);
  for (int i = 0; i < n_t; ++i) {
    const int k0 = (kt0 + i) * FWALK;
    cp_async_wait(1);
    __syncthreads();  // tile i landed; every warp is done with tile i - 1
    const float* slot = smem + (i & 1) * FWD_SLOT;
    split_kstyle<FWALK, KV>(Kf, slot);
    split_vstyle<FWALK, KV>(Vf, slot + FRAW);
    if (tid < FWALK) {
      kbs[tid] = kbb != nullptr ? slot[2 * FRAW + tid] : 0.f;
      segk[tid] = reinterpret_cast<const int*>(slot + 2 * FRAW + FWALK)[tid];
    }
    __syncthreads();  // the split tile is ready; slot i % 2 is free
    feed(i + 2);
    // a tile none of the warp's rows sees (the diagonal's far side, the
    // window's near side) costs the warp nothing
    if (!warp_live || (causal && k0 > wp1) ||
        (window > 0 && static_cast<long>(wp0) - (k0 + FWALK - 1) >= window))
      continue;
    const bool full = segb == nullptr && k0 + FWALK <= Tk &&
                      (!causal || k0 + FWALK - 1 <= wp0) &&
                      (window <= 0 || static_cast<long>(wp1) - k0 < window);
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      Split qa[4];
      load_a_split(qa, qa_s, kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) mma3(s[j], qa, Kf[(j * 8 + kk) * 32 + lane]);
    }
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
        const float x = fmaf(s[j][e], scale, kbs[8 * j + 2 * t + (e & 1)]);
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
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= al_a;
      acc[n][1] *= al_a;
      acc[n][2] *= al_b;
      acc[n][3] *= al_b;
    }
    // P v: the probabilities never leave the registers; 32 keys at a time
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Split pa[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) split_acc(pa[j], s[4 * h + j]);
      product_add(acc, pa, Vf, 4 * h, lane);
    }
  }
  cp_async_wait(0);

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= Tq) continue;
    const float l = half == 0 ? l_a : l_b;
    const float safe_l = l == 0.f ? 1.f : l;
    float* orow = o + (static_cast<long>(bh) * Tq + row) * TD + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(acc[n][2 * half] / safe_l, acc[n][2 * half + 1] / safe_l);
    if (t == 0) lse[static_cast<long>(bh) * Tq + row] = (half == 0 ? m_a : m_b) + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// dq: a block per (bh, TOWN-query tile), walking BWALK-key tiles; q split
// in registers (measured faster than in shared memory), dO split in shared
// memory, the registers holding q, dq and a tile's S and dP
// ---------------------------------------------------------------------------
constexpr int BRAW = Walk<BWALK>::kRaw;
constexpr int BFRAG = Walk<BWALK>::kFrag;
constexpr int DQ_SLOT = 2 * BRAW + 2 * BWALK;  // k, v; key bias, key ids
constexpr size_t DQ_SMEM = sizeof(float) * (2 * DQ_SLOT + 2 * BWALK) +
                           (3 * BFRAG + TW * AFRAG) * sizeof(uint4);

__global__ void __launch_bounds__(TT, 1) tc_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ kb, const float* __restrict__ lse, const float* __restrict__ dout,
    const float* __restrict__ delta, const int* __restrict__ qbase, float* __restrict__ dq,
    int Tq, int Tk, bool causal, int qstride, float scale, int window,
    const int* __restrict__ seg) {
  extern __shared__ __align__(16) float smem[];
  uint4* Kf = reinterpret_cast<uint4*>(smem + 2 * DQ_SLOT);  // K-style k (q k^T)
  uint4* Vf = Kf + BFRAG;                                      // K-style v (dO v^T)
  uint4* Kv = Vf + BFRAG;                                      // V-style k (dS k)
  uint4* dOa = Kv + BFRAG + (threadIdx.x >> 5) * AFRAG;       // this warp's dO
  float* kbs = reinterpret_cast<float*>(Kv + BFRAG + TW * AFRAG);
  int* segk = reinterpret_cast<int*>(kbs + BWALK);
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3, g = lane >> 2;
  const int bh = blockIdx.x;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * TOWN;
  const int r0 = q0 + 16 * (tid >> 5);
  const long qoff = static_cast<long>(bh) * Tq;
  const int qpos0 = query_base(qbase, qstride, bh);
  const float* kbase = k + static_cast<long>(bh) * Tk * TD;
  const float* vbase = v + static_cast<long>(bh) * Tk * TD;
  const float* kbb = kb != nullptr ? kb + static_cast<long>(bh) * Tk : nullptr;
  const int* segb = seg != nullptr ? seg + static_cast<long>(bh) * Tk : nullptr;

  Split qa[8][4];
  {
    float x[8][4];
    load_a(x, q + qoff * TD, r0, Tq);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) split_a(qa[kk], x[kk]);
    load_a(x, dout + qoff * TD, r0, Tq);
    store_a_split(dOa, x);
    __syncwarp();
  }
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

  const int kt0 = first_key_tile(q0, window, qpos0, BWALK);
  const int n_t = max(0, key_tiles(q0, TOWN, Tq, Tk, causal, qpos0, BWALK) - kt0);
  auto feed = [&](int i) {
    if (i < n_t) {
      float* slot = smem + (i & 1) * DQ_SLOT;
      const int k0 = (kt0 + i) * BWALK;
      stage_tile<BWALK>(slot, kbase, k0, Tk);
      stage_tile<BWALK>(slot + BRAW, vbase, k0, Tk);
      stage_vec<BWALK>(slot + 2 * BRAW, kbb, k0, Tk);
      stage_vec<BWALK>(slot + 2 * BRAW + BWALK, segb, k0, Tk);
    }
    cp_async_commit();
  };
  feed(0);
  feed(1);
  for (int i = 0; i < n_t; ++i) {
    const int k0 = (kt0 + i) * BWALK;
    cp_async_wait(1);
    __syncthreads();  // tile i landed; every warp is done with tile i - 1
    const float* slot = smem + (i & 1) * DQ_SLOT;
    split_kstyle<BWALK>(Kf, slot);
    split_kstyle<BWALK>(Vf, slot + BRAW);
    split_vstyle<BWALK>(Kv, slot);
    if (tid < BWALK) {
      kbs[tid] = kbb != nullptr ? slot[2 * BRAW + tid] : 0.f;
      segk[tid] = reinterpret_cast<const int*>(slot + 2 * BRAW + BWALK)[tid];
    }
    __syncthreads();  // the split tile is ready; slot i % 2 is free
    feed(i + 2);
    if (!warp_live || (causal && k0 > wp1) ||
        (window > 0 && static_cast<long>(wp0) - (k0 + BWALK - 1) >= window))
      continue;
    const bool full = segb == nullptr && k0 + BWALK <= Tk &&
                      (!causal || k0 + BWALK - 1 <= wp0) &&
                      (window <= 0 || static_cast<long>(wp1) - k0 < window);
    float s[4][4], dp[4][4];  // S = q k^T, dP = dO v^T
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      Split da[4];
      load_a_split(da, dOa, kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = (j * 8 + kk) * 32 + lane;
        mma3(s[j], qa[kk], Kf[f]);
        mma3(dp[j], da, Vf[f]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const bool valid =
            (e < 2 ? live_a : live_b) &&
            (full || visible(k0 + c, Tk, e < 2 ? pa : pb, causal, window, segb,
                             e < 2 ? sa : sb, segb != nullptr ? segk[c] : 0));
        const float p =
            valid ? exp2f((fmaf(s[j][e], scale, kbs[c]) - (e < 2 ? lse_a : lse_b)) * kLog2e)
                  : 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? dl_a : dl_b));  // dS
      }
    Split ds4[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_acc(ds4[j], s[j]);
    product_add<4>(acc, ds4, Kv, 0, lane);
  }
  cp_async_wait(0);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= Tq) continue;
    float* drow = dq + (qoff + row) * TD + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(drow + 8 * n) =
          make_float2(acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// dk / dv / dkb: a block per (bh, TOWN-key tile), walking
// BWALK-query tiles; k split and v in shared memory (v split at each use:
// both split would pass the block's shared memory), the registers holding
// dk, dv and a tile's S^T and dP^T
// ---------------------------------------------------------------------------
constexpr int DKV_SLOT = 2 * BRAW + 3 * BWALK;  // q, dO; lse, delta, query ids
constexpr size_t DKV_SMEM = sizeof(float) * (2 * DKV_SLOT + 3 * BWALK) +
                            (4 * BFRAG + TW * AFRAG + TW * 256) * sizeof(uint4);

__global__ void __launch_bounds__(TT, 1) tc_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ kb, const float* __restrict__ lse, const float* __restrict__ dout,
    const float* __restrict__ delta, const int* __restrict__ qbase, float* __restrict__ dk,
    float* __restrict__ dv, float* __restrict__ dkb, int Tq, int Tk, bool causal, int qstride,
    float scale, int window, const int* __restrict__ seg) {
  extern __shared__ __align__(16) float smem[];
  uint4* Qk = reinterpret_cast<uint4*>(smem + 2 * DKV_SLOT);  // K-style q (k q^T)
  uint4* Ok = Qk + BFRAG;                                       // K-style dO (v dO^T)
  uint4* Qv = Ok + BFRAG;                                       // V-style q (dS^T q)
  uint4* Ov = Qv + BFRAG;                                       // V-style dO (P^T dO)
  uint4* ka_s = Ov + BFRAG + (threadIdx.x >> 5) * AFRAG;       // this warp's k, split
  float4* va_s = reinterpret_cast<float4*>(Ov + BFRAG + TW * AFRAG) +
                 (threadIdx.x >> 5) * 256;  // this warp's v, split at each use
  float* lse_s = reinterpret_cast<float*>(Ov + BFRAG + TW * AFRAG + TW * 256);
  float* dl_s = lse_s + BWALK;
  int* segq = reinterpret_cast<int*>(dl_s + BWALK);
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3, g = lane >> 2;
  const int bh = blockIdx.x;
  const long qoff = static_cast<long>(bh) * Tq;
  const long koff = static_cast<long>(bh) * Tk;
  const int qpos0 = query_base(qbase, qstride, bh);
  const float* qrows = q + qoff * TD;
  const float* orows = dout + qoff * TD;
  const float* lrows = lse + qoff;
  const float* drows = delta + qoff;
  const int* segb = seg != nullptr ? seg + koff : nullptr;
  const int nqt = (Tq + BWALK - 1) / BWALK;
  // block y owns key tile y: causal, the blocks launch heaviest first (key
  // tile 0 walks every query tile), as the forward's do in reverse
  const int k0 = blockIdx.y * TOWN;
  const int kr0 = k0 + 16 * (tid >> 5);  // the warp's first key
  {
    float x[8][4], y4[8][4];
    load_a(x, k + koff * TD, kr0, Tk);
    load_a(y4, v + koff * TD, kr0, Tk);
    store_a_split(ka_s, x);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      va_s[32 * kk + lane] = make_float4(y4[kk][0], y4[kk][1], y4[kk][2], y4[kk][3]);
    __syncwarp();
  }
  const int ka = kr0 + g, kc = ka + 8;  // rows g and g + 8
  const float kb_a = (kb != nullptr && ka < Tk) ? kb[koff + ka] : 0.f;
  const float kb_c = (kb != nullptr && kc < Tk) ? kb[koff + kc] : 0.f;
  const int sk_a = (segb != nullptr && ka < Tk) ? segb[ka] : 0;
  const int sk_c = (segb != nullptr && kc < Tk) ? segb[kc] : 0;
  const bool warp_live = kr0 < Tk;
  const int wk1 = min(kr0 + 15, Tk - 1);  // the warp's last key
  float dk_acc[8][4], dv_acc[8][4], dkb_a = 0.f, dkb_c = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // causal: a query tile whose last query comes before the block's first
  // key sees none of it; window: from the first query tile whose first
  // query is at or past k0 + TOWN - 1 + window none do
  const int qt0 = causal ? max(0, (k0 - qpos0) / BWALK) : 0;
  int qt1 = nqt;
  if (window > 0) {
    const long lim = static_cast<long>(k0) + TOWN - 1 + window - qpos0;
    const long tiles = lim <= 0 ? 0 : (lim + BWALK - 1) / BWALK;
    qt1 = tiles < nqt ? static_cast<int>(tiles) : nqt;
  }
  const int n_t = max(0, qt1 - qt0);
  auto feed = [&](int i) {
    if (i < n_t) {
      float* slot = smem + (i & 1) * DKV_SLOT;
      const int q0 = (qt0 + i) * BWALK;
      stage_tile<BWALK>(slot, qrows, q0, Tq);
      stage_tile<BWALK>(slot + BRAW, orows, q0, Tq);
      stage_vec<BWALK>(slot + 2 * BRAW, lrows, q0, Tq);
      stage_vec<BWALK>(slot + 2 * BRAW + BWALK, drows, q0, Tq);
      stage_vec<BWALK>(slot + 2 * BRAW + 2 * BWALK, segb, q0, Tq);
    }
    cp_async_commit();
  };
  feed(0);
  feed(1);
  for (int i = 0; i < n_t; ++i) {
    const int q0 = (qt0 + i) * BWALK;
    cp_async_wait(1);
    __syncthreads();  // tile i landed; every warp is done with tile i - 1
    const float* slot = smem + (i & 1) * DKV_SLOT;
    split_kstyle<BWALK>(Qk, slot);
    split_kstyle<BWALK>(Ok, slot + BRAW);
    split_vstyle<BWALK>(Qv, slot);
    split_vstyle<BWALK>(Ov, slot + BRAW);
    if (tid < BWALK) {
      lse_s[tid] = slot[2 * BRAW + tid];
      dl_s[tid] = slot[2 * BRAW + BWALK + tid];
      segq[tid] = reinterpret_cast<const int*>(slot + 2 * BRAW + 2 * BWALK)[tid];
    }
    __syncthreads();
    feed(i + 2);
    const long last_q = static_cast<long>(qpos0) + min(q0 + BWALK, Tq) - 1;
    if (!warp_live || (causal && last_q < kr0) ||
        (window > 0 && static_cast<long>(qpos0) + q0 - wk1 >= window))
      continue;
    const bool full = segb == nullptr && q0 + BWALK <= Tq && kr0 + 16 <= Tk &&
                      (!causal || static_cast<long>(qpos0) + q0 >= kr0 + 15) &&
                      (window <= 0 || last_q - kr0 < window);
    float st[4][4], dpt[4][4];  // S^T = k q^T, dP^T = v dO^T
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      Split ka4[4], va4[4];
      load_a_split(ka4, ka_s, kk);
      const float4 vr = va_s[32 * kk + lane];
      const float vx[4] = {vr.x, vr.y, vr.z, vr.w};
      split_a(va4, vx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = (j * 8 + kk) * 32 + lane;
        mma3(st[j], ka4, Qk[f]);
        mma3(dpt[j], va4, Ok[f]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);  // the query in the tile
        const float lq = lse_s[c];
        const bool valid =
            lq > ptt::kNegInf / 2 &&
            (full || (q0 + c < Tq &&
                      visible(e < 2 ? ka : kc, Tk, qpos0 + q0 + c, causal, window, segb,
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
    Split a4[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_acc(a4[j], st[j]);
    product_add(dv_acc, a4, Ov, 0, lane);  // dv += P^T dO
#pragma unroll
    for (int j = 0; j < 4; ++j) split_acc(a4[j], dpt[j]);
    product_add(dk_acc, a4, Qv, 0, lane);  // dk += dS^T q
  }
  cp_async_wait(0);

  dkb_a = quad_sum(dkb_a);
  dkb_c = quad_sum(dkb_c);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = kr0 + g + 8 * half;
    if (key >= Tk) continue;
    float* dkrow = dk + (koff + key) * TD + 2 * t;
    float* dvrow = dv + (koff + key) * TD + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(dkrow + 8 * n) =
          make_float2(dk_acc[n][2 * half] * scale, dk_acc[n][2 * half + 1] * scale);
      *reinterpret_cast<float2*>(dvrow + 8 * n) =
          make_float2(dv_acc[n][2 * half], dv_acc[n][2 * half + 1]);
    }
    if (dkb != nullptr && t == 0) dkb[koff + key] = half == 0 ? dkb_a : dkb_c;
  }
}

template <class KV>
int launch_tc_fwd(const float* q, const KV* k, const KV* v, const float* kb,
                  const int* qbase, float* o, float* lse, int BH, int Tq, int Tk, bool causal,
                  int qstride, float scale, int window, const int* seg, cudaStream_t stream) {
  static int ready = prepare(tc_fwd_kernel<KV>, FWD_SMEM);
  if (ready != 0) return ready;
  const dim3 grid(BH, (Tq + TOWN - 1) / TOWN);
  tc_fwd_kernel<KV><<<grid, TT, FWD_SMEM, stream>>>(q, k, v, kb, qbase, o, lse, Tq, Tk,
                                                    causal, qstride, scale, window, seg);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc_dq(const float* q, const float* k, const float* v, const float* kb,
                 const float* lse, const float* dout, const float* delta, const int* qbase,
                 float* dq, int BH, int Tq, int Tk, bool causal, int qstride, float scale,
                 int window, const int* seg, cudaStream_t stream) {
  static int ready = prepare(tc_dq_kernel, DQ_SMEM);
  if (ready != 0) return ready;
  const dim3 grid(BH, (Tq + TOWN - 1) / TOWN);
  tc_dq_kernel<<<grid, TT, DQ_SMEM, stream>>>(q, k, v, kb, lse, dout, delta, qbase, dq, Tq,
                                              Tk, causal, qstride, scale, window, seg);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc_dkv(const float* q, const float* k, const float* v, const float* kb,
                  const float* lse, const float* dout, const float* delta, const int* qbase,
                  float* dk, float* dv, float* dkb, int BH, int Tq, int Tk, bool causal,
                  int qstride, float scale, int window, const int* seg, cudaStream_t stream) {
  static int ready = prepare(tc_dkv_kernel, DKV_SMEM);
  if (ready != 0) return ready;
  const dim3 grid(BH, (Tk + TOWN - 1) / TOWN);
  tc_dkv_kernel<<<grid, TT, DKV_SMEM, stream>>>(q, k, v, kb, lse, dout, delta, qbase, dk, dv,
                                                dkb, Tq, Tk, causal, qstride, scale, window,
                                                seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kb [BH, Tk] or null; qbase (int32, read at b * qstride) or null;
// o [BH, Tq, d]; lse [BH, Tq]; window 0 or the causal window; seg [BH, T]
// int32 segment ids or null.
extern "C" int ptt_flash_attention_fwd(const float* q, const float* k,
                                       const float* v, const float* kb,
                                       const int* qbase, float* o, float* lse,
                                       int BH, int Tq, int Tk, int d, int form,
                                       int causal, int qstride, float scale,
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

// the forward's bf16-KV form: k, v bf16 [BH, Tk, d]; q, kb, o and lse
// float32, as in ptt_flash_attention_fwd (the chunked decode step and the
// speculative verify over a bf16 cache: B9)
extern "C" int ptt_flash_attention_fwd_kvbf16(const float* q, const ptt::bf16* k,
                                              const ptt::bf16* v, const float* kb,
                                              const int* qbase, float* o, float* lse,
                                              int BH, int Tq, int Tk, int d, int form,
                                              int causal, int qstride, float scale,
                                              int window, const int* seg,
                                              cudaStream_t stream) {
  if (BH == 0 || Tq == 0) return static_cast<int>(cudaSuccess);
  if (Tk == 0 || bad_operands(qbase, Tq, Tk, causal, qstride, window, seg) ||
      bad_form(form, d, Tq, Tk, false))
    return static_cast<int>(cudaErrorInvalidValue);
  if (form == 1)
    return launch_tc_fwd(q, k, v, kb, qbase, o, lse, BH, Tq, Tk, causal != 0, qstride, scale,
                         window, seg, stream);
  return launch_simt_fwd<128, float, ptt::bf16>(q, k, v, kb, qbase, o, lse, BH, Tq, Tk,
                                                causal != 0, qstride, scale, window, seg,
                                                stream);
}

// delta [BH, Tq] = rowsum(o * dout) (minus the lse cotangent, if any);
// dq [BH, Tq, d]
extern "C" int ptt_flash_attention_dq(const float* q, const float* k,
                                      const float* v, const float* kb,
                                      const int* qbase, const float* lse,
                                      const float* dout, const float* delta,
                                      float* dq, int BH, int Tq, int Tk, int d,
                                      int form, int causal, int qstride,
                                      float scale, int window, const int* seg,
                                      cudaStream_t stream) {
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

// dk, dv [BH, Tk, d]; dkb [BH, Tk] or null (no key bias)
extern "C" int ptt_flash_attention_dkv(const float* q, const float* k,
                                       const float* v, const float* kb,
                                       const int* qbase, const float* lse,
                                       const float* dout, const float* delta,
                                       float* dk, float* dv, float* dkb,
                                       int BH, int Tq, int Tk, int d, int form,
                                       int causal, int qstride, float scale,
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
