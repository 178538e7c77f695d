// fused_linear_xent: the logits-free projected cross entropy, forward and
// backward, over x [R, H], w [H, V], int64 labels [R], all float32
// row-major.  The logits z = x @ w exist only as register and shared-memory
// tiles; no [R, V] buffer is ever written.  Per row, with valid = (0 <=
// label < V):
//
//   loss = valid (1 - eps) (lse - z[label]) + eps (lse - sum_v z / V)
//   g    = dy (valid (1 - eps) (p - onehot) + eps (p - 1 / V)),  p = exp(z - lse)
//   dx   = g @ w^T,   dw = x^T @ g
//
// Replaces: paddle_tpu/ops/pallas_kernels.py fused_linear_xent, the forward
// _lxent_fwd (pallas_call :1647, body _lxent_fwd_kernel) and the backward
// _lxent_bwd, whose dx (:1680) and dw (:1693) calls run _lxent_dx_kernel and
// _lxent_dw_kernel over _lxent_grad_tile; and sharded_linear_xent's
// _lxent_parts (:1818) and _lxent_bwd_sharded (dx :1900, dw :1914).
//
// Bound on the card: operations.  The forward does 2 R H V FLOPs, dx and dw
// 4 R H V each (the logits are recomputed from the saved lse, then one
// product).  With TF32 off that is the float32 rate (67 TFLOP/s); these
// kernels run the products on the tensor cores in 3xTF32 (three TF32
// products per float32 product at 495 TFLOP/s, i.e. ops / 165 TFLOP/s).
//
// Arithmetic: 3xTF32.  Every operand element is split as it leaves shared
// memory, big = cvt.rna.tf32.f32(a), small = cvt.rna.tf32.f32(a - big),
// and each product accumulates small*big + big*small + big*big in f32 with
// mma.sync.m16n8k8.tf32; the tensor cores get only cvt's TF32 values, never
// raw float32 bits.  The CPU tests emulate it: within 1e-5 of the largest
// magnitude against float64 at K 768 and 2048, where one TF32 product
// misses 1e-4.  The tensor core's own accumulation rounds toward zero, so a
// long contraction (dx over V, dw over R) adds each 16-deep product,
// started from zero, to a float32 sum.
//
// Design, one for every H.  H is cut into n slices of HS columns (the plan,
// lxent_plan in linear_xent.py: HS 256 while n <= 8, else n = 8).  A
// logits tile [64 rows, 64 vocab columns] is the sum over the slices, in
// ascending order, of per-slice partials, each a fresh 3xTF32 accumulation
// over its slice in 64-deep steps by warp pairs (the even and the odd
// 8-deep steps, added).  The forward, dx and dw all compute every logit
// that way, so the backward recomputes the forward's z.
// - Staging: a ring of buffers in dynamic shared memory fed by cp.async
//   (16-byte copies where the rows are 16-byte aligned, else 4-byte;
//   masked elements zero-fill, so a ragged V needs no padded copy of w),
//   one __syncthreads a stage.  Rows are XOR-swizzled so that every
//   fragment load is free of bank conflicts in the orientations a tile is
//   read in.  dx and dw keep the slice's fixed operand resident (HS 256:
//   dx's x [64, 256], dw's w [256, 64]) and hold the tile's chunks of the
//   other in the ring until the second product has read them; wider
//   slices stream both operands and stage the second product's again.
// - forward / parts: one block per (64-row tile, vocab split); the block
//   adds the slices' partials itself, keeps per thread the running max,
//   sum of exponentials, gold logit and logit sum of its rows over the
//   columns it holds, merges them in a fixed order at the end, and a second
//   pass merges the splits of each row in split order.
// - dx / dw: a thread-block cluster of n blocks along H, one per slice
//   (cudaLaunchKernelEx, cluster dimension n).  Per tile every block
//   computes its slice's partial into shared memory, the cluster meets at a
//   barrier, each block adds its 1/n share of the tile over the n partials
//   in slice order through distributed shared memory, and after a second
//   barrier every block gathers the shares, so all hold a bit-identical z
//   (~48 KB of peers' shared memory read a block and tile), forms g from z and
//   the saved lse, and accumulates its slice of the output: dx blocks (one
//   per row tile, walking the vocab tiles) g @ w[slice, vtile]^T into
//   [64, HS]; dw blocks (one per vocab tile, walking the row tiles)
//   x[rtile, slice]^T @ g into [HS, 64].  With two cluster barriers a tile
//   the buffers need no second copy; a last barrier precedes exit, since
//   peers may still read a block's shared memory.  Each logits tile is
//   computed once per kernel: 2 x 2 R H V FLOPs a backward kernel.  A
//   block's registers hold at most 768 output columns (rows for dw); a
//   slice wider than that (H > 8 x 768) is done in passes of 768, each
//   walking all tiles again, so the logits are computed ceil(HS / 768)
//   times there.
// No atomics anywhere: every output sums in one fixed order, so a step is
// bit-reproducible from the same state.
//
// Why mma.sync and not yet wgmma: tf32 wgmma takes both operands K-major
// in shared memory, and w [H, V] is MN-major for the logits product, as is
// x for dw's x^T @ g; a wgmma form needs a transposing stage and separate
// big / small tiles.  It is the next step (ROADMAP B4a).
//
// sharded_linear_xent: the same passes over ONE vocab shard, w_local
// [H, V/n], with labels in local column coordinates (label - col0: a label
// of another shard is negative or >= V/n and matches no column).
// - parts: the forward's pass and split merge, emitting per row this
//   shard's lse_j = m + log l, gold_j and the logit sum sum_j and no loss;
//   the caller combines the shards (max and sums over ranks).
// - dx / dw: the backward passes with the row validity `valid` [R] (from
//   the GLOBAL labels) and the smoothing denominator vocab_total given,
//   instead of derived from the local V.  dx is this shard's partial of
//   g @ w_local^T; the caller sums it over the shards.
#include "common.cuh"
#include "tf32_mma.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int BR = 64;        // rows of a logits tile
constexpr int BV = 64;        // vocab columns of a logits tile
constexpr int KC = 64;        // depth of a logits stage: x [BR][KC], w [KC][BV]
constexpr int KG = 16;        // depth of a product stage: dx w^T [SW][KG], dw x [KG][SW]
constexpr int kSubHS = 768;   // the widest pass a dx / dw block's registers hold
constexpr int kResHS = 256;   // the widest slice whose operand stays resident
constexpr int kTile = BR * BV;
constexpr int kSmemMax = 232448;

// ---- shared-memory layout: XOR swizzles ------------------------------------
// A tile row stores column c at c ^ sw(row).  Each swizzle moves whole
// 4-float groups (16-byte copies stay whole) and maps a fragment load's 32
// lanes onto distinct banks (a 64-bit load's 16 lanes of a half-warp onto
// distinct bank pairs):
// - swz, rows of a multiple of 32 floats read as 8 rows x 4 columns (rows by
//   lane / 4; also as 8 rows x 4 column pairs) or 4 rows x 8 columns (rows
//   by lane % 4): x stages, the g tile, dw's x^T stages;
// - swz_w, w [h][v] stages and tiles, read as rows 2t and 2t + 1 x 8
//   columns (the logits) and as 8 rows x 4 column pairs (dx's g @ w^T);
// - swz16, dx's w^T stage [HS][16], read as 8 rows x 4 column pairs.
__device__ __forceinline__ int swz(int row) {
  return ((row & 3) << 3) | (((row >> 2) & 1) << 2);
}
__device__ __forceinline__ int swz_w(int row) {
  return ((row & 3) ^ ((row >> 2) & 1)) << 3;
}
__device__ __forceinline__ int swz16(int row) { return ((row >> 1) & 1) << 3; }

enum Swizzle { kSwz, kSwzW, kSwz16 };

template <int SW>
__device__ __forceinline__ int swizzle(int row) {
  return SW == kSwz ? swz(row) : SW == kSwzW ? swz_w(row) : swz16(row);
}

// ---- 3xTF32 on mma.sync, cp.async staging (tf32_mma.cuh) ---------------------
using ptt::Split;
using ptt::cp_async16;
using ptt::cp_async4;
using ptt::cp_async_commit;
using ptt::cp_async_wait;
using ptt::mma3;
using ptt::split;
using ptt::split2;

// Copy src[r0 + i, c0 + j] (row stride ld, bounds rows < nr, cols < nc) for
// i < rows, j < cols into dst[i * cols + (j ^ sw(i))]; out of bounds
// zero-fills.  vec: 16-byte copies (ld, c0 and nc multiples of 4 and src
// 16-byte aligned, so a 4-group is wholly in or out).  Inlined with a
// constant `cols` where the tile fixes it.
template <int SW>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                     int rows, int cols, long ld, int r0, int c0,
                                     int nr, int nc, bool vec) {
  if (vec) {
    const int G = cols / 4;
    for (int i = threadIdx.x; i < rows * G; i += kThreads) {
      const int r = i / G, c = (i % G) * 4;
      const bool in = r0 + r < nr && c0 + c < nc;
      cp_async16(dst + r * cols + (c ^ swizzle<SW>(r)),
                 in ? src + (r0 + r) * ld + c0 + c : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i % cols;
      const bool in = r0 + r < nr && c0 + c < nc;
      cp_async4(dst + r * cols + (c ^ swizzle<SW>(r)),
                in ? src + (r0 + r) * ld + c0 + c : src, in);
    }
  }
}

// A ring of `slots` stage buffers, filled in order by `feed(slot)` (which
// stages the next step and advances itself) `ahead` stages ahead of their
// use and consumed in the same order.  consume() waits for the oldest
// stage, meets the block at one barrier and feeds stage q + ahead into slot
// (q + ahead) % slots, whose last stage q + ahead - slots the block is done
// with: the one before (slots = ahead + 1), or a tile's whole set of
// stages, kept for a second product (slots = stages a tile + ahead).
struct Ring {
  float* base;
  int stage_floats, slots, ahead, left;  // left: stages still to feed
  int read = 0, write = 0;

  __device__ __forceinline__ int next(int i) const { return i + 1 == slots ? 0 : i + 1; }
  __device__ __forceinline__ const float* slot(int i) const {
    return base + i * stage_floats;
  }
  template <class Feed>
  __device__ __forceinline__ void feed_one(Feed& feed) {
    if (left > 0) {
      feed(base + write * stage_floats);
      --left;
    }
    write = next(write);
    cp_async_commit();
  }
  template <class Feed>
  __device__ __forceinline__ void prologue(Feed& feed) {
    for (int i = 0; i < ahead; ++i) feed_one(feed);
  }
  template <class Feed>
  __device__ __forceinline__ const float* consume(Feed& feed) {
    cp_async_wait(ahead - 1);
    __syncthreads();
    feed_one(feed);
    const float* s = base + read * stage_floats;
    read = next(read);
    return s;
  }
};

// ---- the logits tile ------------------------------------------------------------
// A [64, 64] logits tile is computed by warp pairs: warp (q, kh) = (warp % 4,
// warp / 4) accumulates the 32 x 32 quadrant q (rows 32 (q / 2) .., columns
// 32 (q % 2) ..) over the even (kh 0) or odd (kh 1) k-steps of each stage; the two
// halves are added (kh 0 + kh 1) through shared memory.  After that a
// thread holds z[j][e] of row 32 (q / 2) + 16 kh + g + 8 (e / 2) and column
// 32 (q % 2) + 8 j + 2 t + e % 2.
__device__ __forceinline__ int z_row(int i) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return ((warp & 3) >> 1) * 32 + (warp >> 2) * 16 + (lane >> 2) + 8 * i;
}
__device__ __forceinline__ int z_col(int j) {  // + e
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp & 1) * 32 + j * 8 + 2 * (lane & 3);
}

// acc += this warp's k-half of x_stage @ w_stage over one KC-deep stage
// (k-steps kh, kh + 2, ..); xs: x [BR][KC] of rows xstride apart (swz of
// the row), ws: w [KC][BV] (swz_w)
__device__ __forceinline__ void logits_stage(const float* xs, int xstride,
                                             const float* ws,
                                             float (&acc)[2][4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q = warp & 3, kh = warp >> 2;
  const int rb = (q >> 1) * 32 + g;
  const int sr = swz(rb);  // the same for rb + 8, + 16, + 24
  const int cb = (q & 1) * 32 + g;
#pragma unroll
  for (int ks = 0; ks < KC / 16; ++ks) {
    const int kk = (2 * ks + kh) * 8;
    Split a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = rb + 16 * mi;
      split2(xs + r * xstride + ((kk + 2 * t) ^ sr), a[mi][0], a[mi][2]);
      split2(xs + (r + 8) * xstride + ((kk + 2 * t) ^ sr), a[mi][1], a[mi][3]);
    }
    const int s0 = swz_w(kk + 2 * t), s1 = swz_w(kk + 2 * t + 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = cb + 8 * j;
      Split b[2];
      b[0] = split(ws[(kk + 2 * t) * BV + (v ^ s0)]);
      b[1] = split(ws[(kk + 2 * t + 1) * BV + (v ^ s1)]);
      mma3(acc[0][j], a[0], b);
      mma3(acc[1][j], a[1], b);
    }
  }
}

// a warp's k-half partial into a partial buffer [kh][q][mi][j][lane][4]
// (2 kTile floats)
__device__ __forceinline__ void put_half(const float (&acc)[2][4][4], float* buf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int base = ((warp >> 2) * 4 + (warp & 3)) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(buf + (((base + mi) * 4 + j) * 32 + lane) * 4) =
          make_float4(acc[mi][j][0], acc[mi][j][1], acc[mi][j][2], acc[mi][j][3]);
}

// this thread's 16 logits of a partial buffer (local or a peer's): kh 0 + kh 1
__device__ __forceinline__ void get_sum(const float* buf, float (&z)[4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = warp & 3, mi = warp >> 2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 a = *reinterpret_cast<const float4*>(
        buf + ((((0 * 4 + q) * 2 + mi) * 4 + j) * 32 + lane) * 4);
    const float4 b = *reinterpret_cast<const float4*>(
        buf + ((((1 * 4 + q) * 2 + mi) * 4 + j) * 32 + lane) * 4);
    z[j][0] = a.x + b.x; z[j][1] = a.y + b.y; z[j][2] = a.z + b.z; z[j][3] = a.w + b.w;
  }
}

// the logits stages of one slice: [h_begin, min(h_begin + HS, H)) in
// KC-deep steps (the last one masked at the slice's end)
__device__ __forceinline__ int slice_stages(int h_begin, int H, int HS) {
  return (min(HS, H - h_begin) + KC - 1) / KC;
}

// stage a logits step: x[r0 .., h0 ..] and w[h0 .., v0 ..], zero from h_end
// (the slice's end) on
__device__ __forceinline__ void stage_logits(float* slot, const float* __restrict__ x,
                                             const float* __restrict__ w, int R,
                                             int H, int V, int r0, int h0, int h_end,
                                             int v0, bool xvec, bool wvec) {
  stage<kSwz>(slot, x, BR, KC, H, r0, h0, R, h_end, xvec);
  stage<kSwzW>(slot + BR * KC, w, KC, BV, V, h0, v0, h_end, V, wvec);
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

// The cluster's z, as a reduce-scatter and a gather: every block puts its
// two k-halves in part [2 kTile]; after a cluster barrier block c adds, for
// the float4s of the tile it owns (a 1/n share, owner(f) = f n / 1024), the
// n slices' partials in slice order, each its kh 0 + kh 1, into zs [kTile];
// after a second barrier every thread reads its 16 logits from their
// owners.  All blocks hold the same z, each having read ~48 KB of its
// peers' shared memory whatever n.
__device__ __forceinline__ void cluster_sum(const float (&acc)[2][4][4], float* part,
                                            float* zs, int n,
                                            cg::cluster_group& cluster,
                                            float (&z)[4][4]) {
  constexpr int F = kTile / 4;  // float4s of a tile
  put_half(acc, part);
  cluster.sync();
  const int c = static_cast<int>(cluster.block_rank());
  const int hi = ((c + 1) * F + n - 1) / n;
  for (int f = (c * F + n - 1) / n + threadIdx.x; f < hi; f += kThreads) {
    float4 sum;
    for (int r = 0; r < n; ++r) {
      const float4* p = reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r));
      const float4 a = p[f], b = p[F + f];
      const float4 sl = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
      if (r == 0) {
        sum = sl;
      } else {
        sum.x += sl.x; sum.y += sl.y; sum.z += sl.z; sum.w += sl.w;
      }
    }
    reinterpret_cast<float4*>(zs)[f] = sum;
  }
  cluster.sync();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int f = ((((warp & 3) * 2 + (warp >> 2)) * 4 + j) * 32 + lane);
    const float4 v = reinterpret_cast<const float4*>(
        cluster.map_shared_rank(zs, (f * n) / F))[f];
    z[j][0] = v.x; z[j][1] = v.y; z[j][2] = v.z; z[j][3] = v.w;
  }
}

// g of this thread's logits (rows r0 + z_row, columns v0 + z_col) into gs
// [BR][BV] (swizzled); rows >= R and columns >= V give 0
__device__ __forceinline__ void store_grad(const float (&z)[4][4], float* gs,
                                           const long long (&lbl)[2], const float (&rl)[2],
                                           const float (&rdy)[2], const bool (&rok)[2],
                                           const bool (&rvalid)[2], int v0, int V,
                                           float eps, float inv_v) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = z_row(i);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = z_col(j);
      float out[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gv = v0 + c + e;
        out[e] = (rok[i] && gv < V)
                     ? grad_elem(z[j][2 * i + e], rl[i], rdy[i], rvalid[i],
                                 gv == lbl[i], eps, inv_v)
                     : 0.f;
      }
      *reinterpret_cast<float2*>(gs + r * BV + (c ^ swz(r))) = make_float2(out[0], out[1]);
    }
  }
}

// ---- forward: one block per (row tile, vocab split) -----------------------------
// per-split partials: part[(split * 4 + q) * R + row], q = max, sum of
// exponentials, gold logit, logit sum
__global__ void __launch_bounds__(kThreads, 1) lxent_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const long long* __restrict__ labels, float* __restrict__ part, int R,
    int H, int V, int HS, int stages, int stage_floats, int tiles_per_split,
    bool xvec, bool wvec) {
  extern __shared__ __align__(16) float smem[];
  float* xch = smem + stages * stage_floats;  // [2][2 kTile]: the k-halves
  const int tid = threadIdx.x, lane = tid & 31;
  const int t = lane & 3;
  const int r0 = blockIdx.x * BR;
  const int n_vt = (V + BV - 1) / BV;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_vt, t_begin + tiles_per_split);
  int steps = 0;  // logits stages a tile, over all slices
  for (int h0 = 0; h0 < H; h0 += HS) steps += slice_stages(h0, H, HS);
  Ring ring{smem, stage_floats, stages, stages - 1, (t_end - t_begin) * steps};
  int f_tile = t_begin, f_slice = 0, f_h = 0;  // the next stage to feed
  auto feed = [&](float* slot) {
    const int h_end = min(H, f_slice + HS);
    stage_logits(slot, x, w, R, H, V, r0, f_h, h_end, f_tile * BV, xvec, wvec);
    f_h += KC;
    if (f_h >= h_end) {
      f_slice += HS;
      if (f_slice >= H) {
        f_slice = 0;
        ++f_tile;
      }
      f_h = f_slice;
    }
  };
  long long lbl[2];
  float m[2], l[2], gold[2], zsum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = r0 + z_row(i);
    lbl[i] = gr < R ? labels[gr] : -1;
    m[i] = ptt::kNegInf;
    l[i] = gold[i] = zsum[i] = 0.f;
  }
  ring.prologue(feed);
  int buf = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int v0 = tile * BV;
    float z[4][4] = {};
    for (int h0 = 0; h0 < H; h0 += HS) {  // the slices, in order
      float acc[2][4][4] = {};
      const int n_st = slice_stages(h0, H, HS);
      for (int s = 0; s < n_st; ++s) {
        const float* st = ring.consume(feed);
        logits_stage(st, KC, st + BR * KC, acc);
      }
      float* xb = xch + buf * 2 * kTile;
      put_half(acc, xb);
      __syncthreads();
      float sl[4][4];
      get_sum(xb, sl);
      buf ^= 1;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[j][e] = h0 == 0 ? sl[j][e] : z[j][e] + sl[j][e];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tmax = ptt::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gv = v0 + z_col(j) + e;
          const float zv = z[j][2 * i + e];
          if (gv < V) {
            tmax = fmaxf(tmax, zv);
            zsum[i] += zv;
            if (gv == lbl[i]) gold[i] += zv;
          }
        }
      const float m_new = fmaxf(m[i], tmax);
      float ts = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (v0 + z_col(j) + e < V) ts += expf(z[j][2 * i + e] - m_new);
        }
      l[i] = l[i] * expf(m[i] - m_new) + ts;
      m[i] = m_new;
    }
  }
  // merge a row's statistics over the 4 lanes of a quad, then over the
  // two column quadrants, in a fixed order
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float mn = fmaxf(m[i], mo);
      l[i] = l[i] * expf(m[i] - mn) + lo * expf(mo - mn);
      m[i] = mn;
      gold[i] += __shfl_xor_sync(0xffffffffu, gold[i], off);
      zsum[i] += __shfl_xor_sync(0xffffffffu, zsum[i], off);
    }
  }
  cp_async_wait(0);
  __syncthreads();  // the ring's last readers are done; reuse it
  float* stat = smem;  // [2 column quadrants][BR rows][4]
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* s = stat + (((tid >> 5) & 1) * BR + z_row(i)) * 4;
      s[0] = m[i]; s[1] = l[i]; s[2] = gold[i]; s[3] = zsum[i];
    }
  }
  __syncthreads();
  if (tid < BR && r0 + tid < R) {
    const float* a = stat + tid * 4;
    const float* b = stat + (BR + tid) * 4;
    const float mn = fmaxf(a[0], b[0]);
    const long base = static_cast<long>(blockIdx.y) * 4 * R + r0 + tid;
    part[base] = mn;
    part[base + R] = a[1] * expf(a[0] - mn) + b[1] * expf(b[0] - mn);
    part[base + 2L * R] = a[2] + b[2];
    part[base + 3L * R] = a[3] + b[3];
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

// ---- dx: a cluster of n blocks along H per 64-row tile ---------------------------
// Block c owns dx[r0 .. r0 + 64, c HS .. (c + 1) HS).  Per vocab tile: the
// slice's logits stages, the cluster sum, g into gs, then acc += g @ w^T
// over the tile's 64 vocab columns, 16 at a time.  Warp (wr, wc) = (warp /
// 4, warp % 4) owns rows 32 wr .. and columns (SW / 4) wc .. of the
// block's [64, SW] columns of this pass: NJ n8 tiles (SW / 32 used).
// - NJ 8 (HS <= 256, every shape up to H 2048): one pass, SW = HS; the
//   block's x [64, HS] stays in shared memory, and the ring's stages are
//   the tile's w chunks [KC, 64], kept until the product has read them (w^T
//   from the same tiles), so each operand crosses from L2 once a tile.
// - NJ 24 (wider slices): passes of SW <= kSubHS columns; a stage holds x
//   and w chunks, and the product stages w^T [SW, 16] again.
// vld: nullptr (unsharded) or the row validity [R] (sharded); VT: the
// smoothing denominator (V unsharded, the whole vocab sharded).
template <int NJ>
__global__ void __launch_bounds__(kThreads, 1) lxent_dx_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const long long* __restrict__ labels, const float* __restrict__ vld,
    const float* __restrict__ lse, const float* __restrict__ dy,
    float* __restrict__ dx, int R, int H, int V, int VT, float eps, int HS,
    int n, int stages, int stage_floats, bool xvec, bool wvec) {
  constexpr bool kRes = NJ * 32 <= kResHS;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  float* xs = smem;                                     // [BR][HS] (kRes)
  float* ring_base = xs + (kRes ? BR * HS : 0);
  float* part = ring_base + stages * stage_floats;      // [2 kTile]: the k-halves
  float* zs = part + 2 * kTile;                         // [kTile]: the owned share of z
  float* gs = zs + kTile;                               // [BR][BV]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h0 = static_cast<int>(cluster.block_rank()) * HS;
  const int h_end = min(H, h0 + HS);
  const int r0 = blockIdx.y * BR;
  const int n_vt = (V + BV - 1) / BV;
  const int n_lg = slice_stages(h0, H, HS);
  const int per_tile = kRes ? n_lg : n_lg + BV / KG;
  const int passes = (HS + kSubHS - 1) / kSubHS;  // the same in every block
  Ring ring{ring_base, stage_floats, stages, kRes ? stages - n_lg : stages - 1,
            passes * n_vt * per_tile};
  int f_pass = 0, f_tile = 0, f_step = 0;
  auto feed = [&](float* slot) {
    if (kRes)  // w[h0 + KC f_step .., v0 ..]
      stage<kSwzW>(slot, w, KC, BV, V, h0 + f_step * KC, f_tile * BV, h_end,
                             V, wvec);
    else if (f_step < n_lg)
      stage_logits(slot, x, w, R, H, V, r0, h0 + f_step * KC, h_end, f_tile * BV,
                   xvec, wvec);
    else  // w^T rows of the pass's columns, vocab columns v0 + KG (f_step - n_lg) ..
      stage<kSwz16>(slot, w, min(kSubHS, HS - f_pass * kSubHS), KG, V,
                              h0 + f_pass * kSubHS,
                              f_tile * BV + (f_step - n_lg) * KG, H, V, wvec);
    if (++f_step == per_tile) {
      f_step = 0;
      if (++f_tile == n_vt) {
        f_tile = 0;
        ++f_pass;
      }
    }
  };
  const float inv_v = 1.f / static_cast<float>(VT);
  long long lbl[2];
  float rl[2], rdy[2];
  bool rok[2], rvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = r0 + z_row(i);
    rok[i] = gr < R;
    lbl[i] = rok[i] ? labels[gr] : -1;
    rl[i] = rok[i] ? lse[gr] : 0.f;
    rdy[i] = rok[i] ? dy[gr] : 0.f;
    rvalid[i] = rok[i] && row_valid(vld, gr, lbl[i], V);
  }
  const int wr = warp >> 2, wc = warp & 3;
  if (kRes) {  // the block's x rows, its slice: one group before the ring's
    stage<kSwz>(xs, x, BR, HS, H, r0, h0, R, h_end, xvec);
    cp_async_commit();
  }
  ring.prologue(feed);
  for (int pass = 0; pass < passes; ++pass) {
    const int p0 = h0 + pass * kSubHS;               // the pass's first column
    const int sw = min(kSubHS, HS - pass * kSubHS);  // and its width
    const int nj = sw / 32;                          // n8 tiles a warp
    const int hw = wc * (sw / 4);  // the warp's first column in the pass
    float acc[2][NJ][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int tile = 0; tile < n_vt; ++tile) {
      const int first = ring.read;  // the slot of this tile's first stage
      float lg[2][4][4] = {};
      for (int s = 0; s < n_lg; ++s) {
        const float* st = ring.consume(feed);
        if (kRes)
          logits_stage(xs + s * KC, HS, st, lg);
        else
          logits_stage(st, KC, st + BR * KC, lg);
      }
      float z[4][4];
      cluster_sum(lg, part, zs, n, cluster, z);
      store_grad(z, gs, lbl, rl, rdy, rok, rvalid, tile * BV, V, eps, inv_v);
      // gs is read after the next barrier: the resident form's own, the
      // streaming form's next consume
      if (kRes) __syncthreads();
      for (int k = 0; k < BV / KG; ++k) {
        // w^T: the resident form reads the tile's w chunk wc (the warp's
        // HS / 4 = KC columns of the slice), the streaming form a w^T stage
        const float* wt;
        int wt_stride;
        if (kRes) {
          if (wc >= n_lg) break;  // past the slice's end: never stored
          int sl = first + wc;
          if (sl >= stages) sl -= stages;
          wt = ring.slot(sl) + k * KG;
          wt_stride = BV;
        } else {
          wt = ring.consume(feed);  // [SW][KG], swz16
          wt_stride = KG;
        }
        Split a[KG / 8][2][4];
#pragma unroll
        for (int kk = 0; kk < KG / 8; ++kk) {
          const int kv = k * KG + kk * 8;  // column of gs
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = wr * 32 + i * 16 + g;
            const int sr = swz(r);
            split2(gs + r * BV + ((kv + 2 * t) ^ sr), a[kk][i][0], a[kk][i][2]);
            split2(gs + (r + 8) * BV + ((kv + 2 * t) ^ sr), a[kk][i][1], a[kk][i][3]);
          }
        }
        // a 16-deep product starts from zero and is added to the running sum
        // in float32: the mma's own accumulation rounds toward zero, and over
        // all of V its bias grew to 2e-4 of dx at GPT-2's V
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j < nj) {
            const int h = kRes ? j * 8 + g : hw + j * 8 + g;  // row of wt
            const int sh = kRes ? swz_w(h) : swz16(h);
            const int kb = kRes ? k * KG : 0;                 // wt's column base
            float d[2][4] = {};
#pragma unroll
            for (int kk = 0; kk < KG / 8; ++kk) {
              Split b[2];
              split2(wt - kb + h * wt_stride + ((kb + kk * 8 + 2 * t) ^ sh), b[0], b[1]);
              mma3(d[0], a[kk][0], b);
              mma3(d[1], a[kk][1], b);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[0][j][e] += d[0][e];
              acc[1][j][e] += d[1][e];
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j >= nj) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gr = r0 + wr * 32 + i * 16 + g + 8 * (e >> 1);
          const int gh = p0 + hw + j * 8 + 2 * t + (e & 1);
          if (gr < R && gh < H) dx[static_cast<long>(gr) * H + gh] = acc[i][j][e];
        }
      }
  }
  cp_async_wait(0);
  cluster.sync();  // no block leaves while a peer may read its part
}

// ---- dw: a cluster of n blocks along H per 64-column vocab tile ------------------
// Block c owns dw[c HS .. (c + 1) HS, v0 .. v0 + 64).  Per row tile: the
// slice's logits stages, the cluster sum, g into gs, then acc += x^T @ g
// over the tile's 64 rows, 16 at a time.  Warp (wr, wc) = (warp / 4, warp %
// 4) owns rows (SW / 2) wr .. and columns 16 wc .. of the block's [SW, 64]
// rows of this pass: MI m16 tiles (SW / 32 used) x 2 n8 tiles.
// - MI 8 (HS <= 256): one pass, SW = HS; the block's w [HS, 64] stays in
//   shared memory, and the ring's stages are the tile's x chunks [64, KC],
//   kept until the product has read them (x^T from the same tiles).
// - MI 24 (wider slices): passes of SW <= kSubHS rows; a stage holds x and
//   w chunks, and the product stages x [16, SW] again.
template <int MI>
__global__ void __launch_bounds__(kThreads, 1) lxent_dw_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const long long* __restrict__ labels, const float* __restrict__ vld,
    const float* __restrict__ lse, const float* __restrict__ dy,
    float* __restrict__ dw, int R, int H, int V, int VT, float eps, int HS,
    int n, int stages, int stage_floats, bool xvec, bool wvec) {
  constexpr bool kRes = MI * 32 <= kResHS;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  float* ws = smem;                                     // [HS][BV] (kRes)
  float* ring_base = ws + (kRes ? HS * BV : 0);
  float* part = ring_base + stages * stage_floats;      // [2 kTile]: the k-halves
  float* zs = part + 2 * kTile;                         // [kTile]: the owned share of z
  float* gs = zs + kTile;                               // [BR][BV]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h0 = static_cast<int>(cluster.block_rank()) * HS;
  const int h_end = min(H, h0 + HS);
  const int v0 = blockIdx.y * BV;
  const int n_rt = (R + BR - 1) / BR;
  const int n_lg = slice_stages(h0, H, HS);
  const int per_tile = kRes ? n_lg : n_lg + BR / KG;
  const int passes = (HS + kSubHS - 1) / kSubHS;  // the same in every block
  Ring ring{ring_base, stage_floats, stages, kRes ? stages - n_lg : stages - 1,
            passes * n_rt * per_tile};
  int f_pass = 0, f_tile = 0, f_step = 0;
  auto feed = [&](float* slot) {
    if (kRes)  // x[r0 .., h0 + KC f_step ..]
      stage<kSwz>(slot, x, BR, KC, H, f_tile * BR, h0 + f_step * KC, R, h_end,
                            xvec);
    else if (f_step < n_lg)
      stage_logits(slot, x, w, R, H, V, f_tile * BR, h0 + f_step * KC, h_end, v0,
                   xvec, wvec);
    else  // x rows r0 + KG (f_step - n_lg) .., the pass's columns
      stage<kSwz>(slot, x, KG, min(kSubHS, HS - f_pass * kSubHS), H,
                  f_tile * BR + (f_step - n_lg) * KG, h0 + f_pass * kSubHS, R, H,
                  xvec);
    if (++f_step == per_tile) {
      f_step = 0;
      if (++f_tile == n_rt) {
        f_tile = 0;
        ++f_pass;
      }
    }
  };
  const float inv_v = 1.f / static_cast<float>(VT);
  const int wr = warp >> 2, wc = warp & 3;
  if (kRes) {  // the block's w tile: one group before the ring's
    stage<kSwzW>(ws, w, HS, BV, V, h0, v0, h_end, V, wvec);
    cp_async_commit();
  }
  ring.prologue(feed);
  for (int pass = 0; pass < passes; ++pass) {
    const int p0 = h0 + pass * kSubHS;               // the pass's first row
    const int sw = min(kSubHS, HS - pass * kSubHS);  // and its height
    const int mi = sw / 32;                          // m16 tiles a warp
    const int hw = wr * (sw / 2);  // the warp's first row in the pass
    float acc[MI][2][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int tile = 0; tile < n_rt; ++tile) {
      const int r0 = tile * BR;
      const int first = ring.read;  // the slot of this tile's first stage
      float lg[2][4][4] = {};
      for (int s = 0; s < n_lg; ++s) {
        const float* st = ring.consume(feed);
        if (kRes)
          logits_stage(st, KC, ws + s * KC * BV, lg);
        else
          logits_stage(st, KC, st + BR * KC, lg);
      }
      float z[4][4];
      cluster_sum(lg, part, zs, n, cluster, z);
      long long lbl[2];
      float rl[2], rdy[2];
      bool rok[2], rvalid[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // the row tail gives zero
        const int gr = r0 + z_row(i);
        rok[i] = gr < R;
        lbl[i] = rok[i] ? labels[gr] : -1;
        rl[i] = rok[i] ? lse[gr] : 0.f;
        rdy[i] = rok[i] ? dy[gr] : 0.f;
        rvalid[i] = rok[i] && row_valid(vld, gr, lbl[i], V);
      }
      store_grad(z, gs, lbl, rl, rdy, rok, rvalid, v0, V, eps, inv_v);
      if (kRes) __syncthreads();  // gs is read below
      for (int k = 0; k < BR / KG; ++k) {
        // x^T: the resident form reads the tile's x chunks (the chunk of
        // column h at h / KC), the streaming form an x stage [KG][SW]
        const float* xr = kRes ? nullptr : ring.consume(feed);
        Split b[KG / 8][2][2];
#pragma unroll
        for (int kk = 0; kk < KG / 8; ++kk) {
          const int kr = k * KG + kk * 8;  // row of gs
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int v = wc * 16 + j * 8 + g;
            b[kk][j][0] = split(gs[(kr + t) * BV + (v ^ swz(kr + t))]);
            b[kk][j][1] = split(gs[(kr + t + 4) * BV + (v ^ swz(kr + t + 4))]);
          }
        }
        // a 16-deep product starts from zero and is added to the running sum
        // in float32 (see dx)
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          if (i < mi) {
            const int h = hw + i * 16 + g;  // column of x in the pass
            const float* xa;  // x rows k KG .., columns h .. (and h + 8)
            int xstride, hc, r_base;
            if (kRes) {
              int sl = first + (hw + i * 16) / KC;
              if ((hw + i * 16) / KC >= n_lg) continue;  // past the slice's end
              if (sl >= stages) sl -= stages;
              xa = ring.slot(sl);
              xstride = KC;
              hc = h % KC;
              r_base = k * KG;
            } else {
              xa = xr;
              xstride = sw;
              hc = h;
              r_base = 0;
            }
            float d[2][4] = {};
#pragma unroll
            for (int kk = 0; kk < KG / 8; ++kk) {
              const int ra = r_base + kk * 8 + t;
              const int s0 = swz(ra), s1 = swz(ra + 4);
              Split a[4];
              a[0] = split(xa[ra * xstride + (hc ^ s0)]);
              a[1] = split(xa[ra * xstride + ((hc + 8) ^ s0)]);
              a[2] = split(xa[(ra + 4) * xstride + (hc ^ s1)]);
              a[3] = split(xa[(ra + 4) * xstride + ((hc + 8) ^ s1)]);
              mma3(d[0], a, b[kk][0]);
              mma3(d[1], a, b[kk][1]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[i][0][e] += d[0][e];
              acc[i][1][e] += d[1][e];
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      if (i >= mi) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gh = p0 + hw + i * 16 + g + 8 * (e >> 1);
          const int gv = v0 + wc * 16 + j * 8 + 2 * t + (e & 1);
          if (gh < H && gv < V) dw[static_cast<long>(gh) * V + gv] = acc[i][j][e];
        }
    }
  }
  cp_async_wait(0);
  cluster.sync();  // no block leaves while a peer may read its part
}

// ---- host side ---------------------------------------------------------------
// the plan from linear_xent.py's lxent_plan; the tile is BR x BV
struct Plan {
  int HS, n, stages, smem;
};

// dx / dw: a ring stage is a w (dx) or x (dw) chunk [KC, 64] when the
// slice's other operand stays resident (HS <= kResHS, which is then 256),
// else x and w chunks or a product stage of one pass's columns x KG
bool resident(int HS) { return HS <= kResHS; }

int stage_floats(int HS) {
  return resident(HS) ? KC * BV : max((BR + BV) * KC, KG * min(HS, kSubHS));
}

// the bytes this file's layout takes for a plan, which the plan's smem must
// cover: the resident operand, the ring, the two k-halves, the owned share
// of z and the g tile
size_t plan_smem(const Plan& p) {
  return sizeof(float) * ((resident(p.HS) ? static_cast<size_t>(BR) * p.HS : 0) +
                          static_cast<size_t>(p.stages) * stage_floats(p.HS) +
                          4 * kTile);
}

// the forward's ring of (x, w) chunk pairs: as many as the plan's bytes hold
// beside its two buffers of two k-halves, at most 4
constexpr int kFwdStage = (BR + BV) * KC;
int fwd_stages(const Plan& p) {
  return min(4, (p.smem / static_cast<int>(sizeof(float)) - 4 * kTile) / kFwdStage);
}

// the plan checked against this file's layout and H: (n - 1) HS < H <= n HS
bool plan_ok(const Plan& p, int H) {
  const int n_lg = (p.HS + KC - 1) / KC;
  return p.HS > 0 && p.HS % 32 == 0 &&
         (!resident(p.HS) || p.HS == kResHS) && p.n >= 1 && p.n <= 8 &&
         static_cast<long>(p.n - 1) * p.HS < H && H <= static_cast<long>(p.n) * p.HS &&
         (resident(p.HS) ? p.stages >= n_lg + 2 : p.stages >= 3 && p.stages <= 4) &&
         p.smem >= static_cast<int>(plan_smem(p)) && p.smem <= kSmemMax &&
         fwd_stages(p) >= 3;
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

// the dynamic shared-memory limit is raised once per kernel, at its first
// launch (outside any CUDA-graph capture in this package's use)
template <class K>
cudaError_t raise_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemMax);
}

// a cluster of p.n blocks along x over `tiles` blocks along y.  Whether the
// card can place such a cluster is asked once per (kernel, n, smem).
template <class K, class... Args>
cudaError_t launch_cluster(K kernel, const Plan& p, int tiles, cudaStream_t stream,
                           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n, tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  struct Checked {
    const void* fn;
    int n, smem;
  };
  static Checked checked[32];
  static int n_checked = 0;
  bool seen = false;
  for (int i = 0; i < n_checked; ++i)
    seen |= checked[i].fn == reinterpret_cast<const void*>(kernel) &&
            checked[i].n == p.n && checked[i].smem == p.smem;
  if (!seen) {
    int clusters = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    if (n_checked < 32) checked[n_checked++] = {reinterpret_cast<const void*>(kernel), p.n, p.smem};
  }
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// the forward's pass over the vocab splits; *used: the split count used
// (every used split has a tile)
cudaError_t launch_fwd_parts(const float* x, const float* w, const long long* labels,
                             float* workspace, int R, int H, int V, int splits,
                             const Plan& p, cudaStream_t stream, int* used) {
  static const cudaError_t raised = raise_smem(lxent_fwd_kernel);
  if (raised != cudaSuccess) return raised;
  const int n_vt = (V + BV - 1) / BV;
  const int per = (n_vt + splits - 1) / splits;  // tiles per split
  *used = (n_vt + per - 1) / per;
  lxent_fwd_kernel<<<dim3((R + BR - 1) / BR, *used), kThreads, p.smem, stream>>>(
      x, w, labels, workspace, R, H, V, p.HS, fwd_stages(p), kFwdStage, per,
      (H % 4 == 0) && aligned16(x), (V % 4 == 0) && aligned16(w));
  return cudaGetLastError();
}

int launch_dx(const float* x, const float* w, const long long* labels,
              const float* vld, const float* lse, const float* dy, float* dx,
              int R, int H, int V, int VT, float eps, const Plan& p,
              cudaStream_t stream) {
  if (R == 0 || H == 0) return static_cast<int>(cudaSuccess);
  if (V <= 0 || VT <= 0 || !plan_ok(p, H)) return static_cast<int>(cudaErrorInvalidValue);
  const bool xvec = (H % 4 == 0) && aligned16(x), wvec = (V % 4 == 0) && aligned16(w);
  const int tiles = (R + BR - 1) / BR;
  cudaError_t e;
  if (p.HS <= 256) {
    static const cudaError_t raised = raise_smem(lxent_dx_kernel<8>);
    if (raised != cudaSuccess) return static_cast<int>(raised);
    e = launch_cluster(lxent_dx_kernel<8>, p, tiles, stream, x, w, labels, vld, lse,
                       dy, dx, R, H, V, VT, eps, p.HS, p.n, p.stages,
                       stage_floats(p.HS), xvec, wvec);
  } else {
    static const cudaError_t raised = raise_smem(lxent_dx_kernel<kSubHS / 32>);
    if (raised != cudaSuccess) return static_cast<int>(raised);
    e = launch_cluster(lxent_dx_kernel<kSubHS / 32>, p, tiles, stream, x, w, labels,
                       vld, lse, dy, dx, R, H, V, VT, eps, p.HS, p.n, p.stages,
                       stage_floats(p.HS), xvec, wvec);
  }
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

int launch_dw(const float* x, const float* w, const long long* labels,
              const float* vld, const float* lse, const float* dy, float* dw,
              int R, int H, int V, int VT, float eps, const Plan& p,
              cudaStream_t stream) {
  if (H == 0 || V == 0) return static_cast<int>(cudaSuccess);
  if (VT <= 0 || !plan_ok(p, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaMemsetAsync(
      dw, 0, sizeof(float) * static_cast<size_t>(H) * V, stream));
  const bool xvec = (H % 4 == 0) && aligned16(x), wvec = (V % 4 == 0) && aligned16(w);
  const int tiles = (V + BV - 1) / BV;
  cudaError_t e;
  if (p.HS <= 256) {
    static const cudaError_t raised = raise_smem(lxent_dw_kernel<8>);
    if (raised != cudaSuccess) return static_cast<int>(raised);
    e = launch_cluster(lxent_dw_kernel<8>, p, tiles, stream, x, w, labels, vld, lse,
                       dy, dw, R, H, V, VT, eps, p.HS, p.n, p.stages,
                       stage_floats(p.HS), xvec, wvec);
  } else {
    static const cudaError_t raised = raise_smem(lxent_dw_kernel<kSubHS / 32>);
    if (raised != cudaSuccess) return static_cast<int>(raised);
    e = launch_cluster(lxent_dw_kernel<kSubHS / 32>, p, tiles, stream, x, w, labels,
                       vld, lse, dy, dw, R, H, V, VT, eps, p.HS, p.n, p.stages,
                       stage_floats(p.HS), xvec, wvec);
  }
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// workspace: [splits, 4, R] floats; (hs, nsl, stages, smem): the plan
extern "C" int ptt_linear_xent_fwd(const float* x, const float* w,
                                   const long long* labels, float* loss,
                                   float* lse, float* workspace, int R, int H,
                                   int V, int splits, int hs, int nsl, int stages,
                                   int smem, float eps,
                                   cudaStream_t stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  const Plan p{hs, nsl, stages, smem};
  if (H <= 0 || V <= 0 || splits <= 0 || workspace == nullptr || !plan_ok(p, H))
    return static_cast<int>(cudaErrorInvalidValue);
  int used = 0;
  const cudaError_t e = launch_fwd_parts(x, w, labels, workspace, R, H, V, splits, p,
                                         stream, &used);
  if (e != cudaSuccess) return static_cast<int>(e);
  lxent_fwd_combine<<<(R + 255) / 256, 256, 0, stream>>>(workspace, labels, loss,
                                                          lse, R, V, used, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptt_linear_xent_dx(const float* x, const float* w,
                                  const long long* labels, const float* lse,
                                  const float* dy, float* dx, int R, int H,
                                  int V, int hs, int nsl, int stages,
                                  int smem, float eps,
                                  cudaStream_t stream) {
  return launch_dx(x, w, labels, nullptr, lse, dy, dx, R, H, V, V, eps,
                   Plan{hs, nsl, stages, smem}, stream);
}

extern "C" int ptt_linear_xent_dw(const float* x, const float* w,
                                  const long long* labels, const float* lse,
                                  const float* dy, float* dw, int R, int H,
                                  int V, int hs, int nsl, int stages,
                                  int smem, float eps,
                                  cudaStream_t stream) {
  return launch_dw(x, w, labels, nullptr, lse, dy, dw, R, H, V, V, eps,
                   Plan{hs, nsl, stages, smem}, stream);
}

// one vocab shard's parts: w is the [H, V] slab, labels local; lse, gold
// and sum [R]; workspace [splits, 4, R] floats
extern "C" int ptt_linear_xent_parts(const float* x, const float* w,
                                     const long long* labels, float* lse,
                                     float* gold, float* sum, float* workspace,
                                     int R, int H, int V, int splits, int hs,
                                     int nsl, int stages, int smem,
                                     cudaStream_t stream) {
  if (R == 0) return static_cast<int>(cudaSuccess);
  const Plan p{hs, nsl, stages, smem};
  if (H <= 0 || V <= 0 || splits <= 0 || workspace == nullptr || !plan_ok(p, H))
    return static_cast<int>(cudaErrorInvalidValue);
  int used = 0;
  const cudaError_t e = launch_fwd_parts(x, w, labels, workspace, R, H, V, splits, p,
                                         stream, &used);
  if (e != cudaSuccess) return static_cast<int>(e);
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
                                          int H, int V, int vocab_total, int hs,
                                          int nsl, int stages, int smem,
                                          float eps,
                                          cudaStream_t stream) {
  if (valid == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dx(x, w, labels, valid, lse, dy, dx, R, H, V, vocab_total, eps,
                   Plan{hs, nsl, stages, smem}, stream);
}

extern "C" int ptt_linear_xent_dw_sharded(const float* x, const float* w,
                                          const long long* labels,
                                          const float* valid, const float* lse,
                                          const float* dy, float* dw, int R,
                                          int H, int V, int vocab_total, int hs,
                                          int nsl, int stages, int smem,
                                          float eps,
                                          cudaStream_t stream) {
  if (valid == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dw(x, w, labels, valid, lse, dy, dw, R, H, V, vocab_total, eps,
                   Plan{hs, nsl, stages, smem}, stream);
}
