// B4's bf16 forms as they were before B12's bf16 forms were added to
// paddle_tpu_torch/kernels/csrc/linear_xent_bf16.cu (which now takes a
// row validity and a smoothing denominator in dx / dw, and launches only
// the vocab splits that hold a tile).  scripts/bf16_kernels_check.py
// builds this file into a library of its own and holds the current B4
// bf16 forms bit-equal to these at WMT's and BERT's shapes.  The entry
// points carry a _before suffix; the kernels are unchanged.
//
// fused_linear_xent, bf16 forms: the logits-free projected cross entropy
// over x [R, H] and w [H, V] in bf16, int64 labels [R]; the logits, lse and
// loss in float32.  The same arithmetic as linear_xent.cu's header:
//
//   loss = valid (1 - eps) (lse - z[label]) + eps (lse - sum_v z / V)
//   g    = dy (valid (1 - eps) (p - onehot) + eps (p - 1 / V)),  p = exp(z - lse)
//   dx   = bf16(g) @ w^T,   dw = x^T @ bf16(g)
//
// with z = x @ w formed in float32 from bf16 products (exact), and g
// rounded to bf16 before each backward product, as the reference's
// _lxent_dx_kernel / _lxent_dw_kernel do (g.astype(x_ref.dtype)); dx and
// dw are rounded once to bf16.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py fused_linear_xent with bf16
// refs: _lxent_fwd (pallas_call :1647, body _lxent_fwd_kernel) and
// _lxent_bwd's dx (:1680) and dw (:1693) calls.
//
// Bound on the card: operations.  The forward does 2 R H V FLOPs, dx and dw
// 4 R H V each (the logits recomputed, then one product), at bf16's dense
// tensor-core rate (989 TFLOP/s).
//
// Design: the simple first form, on native bf16 products (bf16_mma.cuh:
// mma.sync.m16n8k16 with float32 accumulation, ldmatrix fragments), for
// any H.  A block computes a logits tile by streaming x [BR][64] and w
// [64][BC] chunks of H through a 3-deep cp.async ring (16-byte copies
// where a width is a multiple of 8, 4-byte copies where it is even, as
// BERT's V 30522, element loads where it is odd), 8 warps each
// accumulating a 16 x BC / (8 / (BR / 16)) piece over the whole of H in
// the tensor core.
// - forward (ptt_linear_xent_fwd_bf16): one block per (64-row tile, vocab
//   split), tiles of 64 x 64; each thread keeps the running max, sum of
//   exponentials, gold logit and logit sum of its two rows over its
//   columns, merged in a fixed order at the end; a second kernel merges
//   the splits of each row in split order (the float32 form's
//   fwd_splits, from R and V).
// - dx (ptt_linear_xent_dx_bf16): one block per (32-row tile, H pass of
//   512 columns), walking the vocab tiles of 64: the logits tile over all
//   of H, g rounded to bf16 into shared memory, then dx[32 x 512] +=
//   g @ w[pass, tile]^T from the w slab [512][64] staged at the tile's
//   start.  128 blocks at R 4096.
// - dw (ptt_linear_xent_dw_bf16): one block per (32-column vocab tile, H
//   pass), walking the row tiles of 64: the logits tile, g into shared
//   memory, then dw[512 x 32] += x[tile, pass]^T @ g from the x slab
//   [64][512].  313 blocks at V 10000.
// H over 512 takes ceil(H / 512) passes, each recomputing the logits.
// Every output sums in one fixed order, no atomics: a step is
// bit-reproducible.  Each chunk of w (dx) or x (dw) is read twice a tile,
// once for the logits and once as the slab, the second time mostly from
// L2; keeping the logits' chunks for the second product is the next step.
#include "bf16_mma.cuh"
#include "common.cuh"
#include "lxent_common.cuh"
#include "tf32_mma.cuh"

namespace {

using ptt::bf16;
using ptt::cp_async_commit;
using ptt::cp_async_wait;

constexpr int kThreads = 256;
constexpr int KC = 64;       // depth of a logits chunk
constexpr int kRing = 3;     // the logits ring's stages
constexpr int HP = 512;      // the widest H pass of dx / dw
constexpr int kSmemMax = 232448;

// chunk c of row r at c ^ swz(r): the 8 rows of an ldmatrix phase land on
// 8 bank groups for rows of 8 or more chunks (r % 8) and of 4 (r / 2 % 4)
template <int Chunks>
struct Swz {
  __device__ __forceinline__ int operator()(int r) const {
    return Chunks >= 8 ? (r & 7) : Chunks == 4 ? ((r >> 1) & 3) : ((r >> 2) & 1);
  }
};

// The logits tile [BR][BC] of rows r0.., columns v0.., over all of H,
// accumulated into `acc` (this warp's 16 rows x BC / WNW columns: NJ n8
// blocks), its chunks consumed from the ring.  The ring's feed order is
// the consumer's: this tile's H chunks in order.
template <int BR, int BC>
struct Logits {
  static constexpr int WM = BR / 16;       // warps along rows
  static constexpr int WNW = 8 / WM;       // warps along columns
  static constexpr int WC = BC / WNW;      // a warp's columns
  static constexpr int NJ = WC / 8;
  static constexpr int kXElems = BR * KC;
  static constexpr int kStageElems = BR * KC + KC * BC;
  static_assert(WM * WNW == 8 && NJ % 2 == 0, "logits warps");

  __device__ __forceinline__ static int row(int i) {  // this thread's rows, i = 0, 1
    return ((threadIdx.x >> 5) % WM) * 16 + ((threadIdx.x & 31) >> 2) + 8 * i;
  }
  __device__ __forceinline__ static int col(int j) {  // + e (0, 1)
    return ((threadIdx.x >> 5) / WM) * WC + 8 * j + 2 * (threadIdx.x & 3);
  }

  // stage chunk h0 of the tile (r0, v0) into a ring slot
  __device__ __forceinline__ static void feed(bf16* slot, const bf16* __restrict__ x,
                                              const bf16* __restrict__ w, int R, int H, int V,
                                              int r0, int h0, int v0, int xcopy, int wcopy) {
    ptt::stage_bf16(slot, x, BR, KC, H, r0, h0, R, H, xcopy, threadIdx.x, kThreads, Swz<KC / 8>());
    ptt::stage_bf16(slot + kXElems, w, KC, BC, V, h0, v0, H, V, wcopy, threadIdx.x, kThreads,
                    Swz<BC / 8>());
  }

  // acc += the chunk in `slot`
  __device__ __forceinline__ static void mma(const bf16* slot, float (&acc)[NJ][4]) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int a_row = (warp % WM) * 16 + (lane & 15);
    const int b_k = (lane & 7) + 8 * ((lane >> 3) & 1);
    const int b_col = (warp / WM) * WC + 8 * (lane >> 4);
    const bf16* ws = slot + kXElems;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      unsigned a[4];
      ptt::ldsm_x4(a, ptt::at_bf16(slot, KC, a_row, 16 * ks + 8 * (lane >> 4), Swz<KC / 8>()));
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        unsigned b[4];
        ptt::ldsm_x4_t(b, ptt::at_bf16(ws, BC, 16 * ks + b_k, b_col + 8 * j, Swz<BC / 8>()));
        ptt::mma_bf16(acc[j], a, b[0], b[1]);
        ptt::mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
  }
};

// A ring of kRing stage slots fed in order, kRing - 1 ahead of use.
struct Ring {
  bf16* base;
  int stage_elems, left;  // left: stages still to feed
  int read = 0, write = 0;

  template <class Feed>
  __device__ __forceinline__ void feed_one(Feed& feed) {
    if (left > 0) {
      feed(base + write * stage_elems);
      --left;
    }
    write = write + 1 == kRing ? 0 : write + 1;
    cp_async_commit();
  }
  template <class Feed>
  __device__ __forceinline__ void prologue(Feed& feed) {
    for (int i = 0; i < kRing - 1; ++i) feed_one(feed);
  }
  // waits for the oldest stage (and any older group), then refills the
  // slot the block finished with one stage ago
  template <class Feed>
  __device__ __forceinline__ const bf16* consume(Feed& feed) {
    cp_async_wait(kRing - 2);
    __syncthreads();
    feed_one(feed);
    const bf16* s = base + read * stage_elems;
    read = read + 1 == kRing ? 0 : read + 1;
    return s;
  }
};

// g of a logits tile (rows r0 + L::row, columns v0 + L::col) rounded to
// bf16 into gs [BR][BC] (swizzled); rows >= R and columns >= V give 0
template <class L, int BR, int BC>
__device__ __forceinline__ void store_grad(const float (&z)[L::NJ][4], bf16* gs, int r0, int v0,
                                           int R, int V, const long long* __restrict__ labels,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ dy, float eps,
                                           float inv_v) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = L::row(i);
    const int gr = r0 + r;
    const bool rok = gr < R;
    const long long lbl = rok ? labels[gr] : -1;
    const float ls = rok ? lse[gr] : 0.f, d = rok ? dy[gr] : 0.f;
    const bool valid = lbl >= 0 && lbl < V;
#pragma unroll
    for (int j = 0; j < L::NJ; ++j) {
      const int c = L::col(j);
      float out[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gv = v0 + c + e;
        out[e] = (rok && gv < V) ? grad_elem(z[j][2 * i + e], ls, d, valid, gv == lbl, eps, inv_v)
                                 : 0.f;
      }
      *reinterpret_cast<unsigned*>(
          const_cast<bf16*>(ptt::at_bf16(gs, BC, r, c, Swz<BC / 8>()))) =
          ptt::pack2(out[0], out[1]);
    }
  }
}

// ---- forward: one block per (64-row tile, vocab split) --------------------------
using LF = Logits<64, 64>;

// per-split partials: part[(split * 4 + q) * R + row], q = max, sum of
// exponentials, gold logit, logit sum
__global__ void __launch_bounds__(kThreads, 1) lxent_fwd_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const long long* __restrict__ labels, float* __restrict__ part, int R, int H, int V,
    int tiles_per_split, int xcopy, int wcopy) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * 64;
  const int n_vt = (V + 63) / 64;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_vt, t_begin + tiles_per_split);
  const int chunks = (H + KC - 1) / KC;
  Ring ring{smem, LF::kStageElems, max(0, t_end - t_begin) * chunks};
  int f_tile = t_begin, f_h = 0;
  auto feed = [&](bf16* slot) {
    LF::feed(slot, x, w, R, H, V, r0, f_h, f_tile * 64, xcopy, wcopy);
    f_h += KC;
    if (f_h >= H) {
      f_h = 0;
      ++f_tile;
    }
  };
  long long lbl[2];
  float m[2], l[2], gold[2], zsum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = r0 + LF::row(i);
    lbl[i] = gr < R ? labels[gr] : -1;
    m[i] = ptt::kNegInf;
    l[i] = gold[i] = zsum[i] = 0.f;
  }
  ring.prologue(feed);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int v0 = tile * 64;
    float z[LF::NJ][4] = {};
    for (int c = 0; c < chunks; ++c) LF::mma(ring.consume(feed), z);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tmax = ptt::kNegInf;
#pragma unroll
      for (int j = 0; j < LF::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gv = v0 + LF::col(j) + e;
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
      for (int j = 0; j < LF::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (v0 + LF::col(j) + e < V) ts += expf(z[j][2 * i + e] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + ts;
      m[i] = m_new;
    }
  }
  // a row's statistics over the 4 lanes of a quad, then over the two
  // column warps, in a fixed order
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
  float* stat = reinterpret_cast<float*>(smem_raw);  // [2 column warps][64 rows][4]
  if ((tid & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* s = stat + (((tid >> 5) / LF::WM) * 64 + LF::row(i)) * 4;
      s[0] = m[i];
      s[1] = l[i];
      s[2] = gold[i];
      s[3] = zsum[i];
    }
  }
  __syncthreads();
  if (tid < 64 && r0 + tid < R) {
    const float* a = stat + tid * 4;
    const float* b = stat + (64 + tid) * 4;
    const float mn = fmaxf(a[0], b[0]);
    const long base = static_cast<long>(blockIdx.y) * 4 * R + r0 + tid;
    part[base] = mn;
    part[base + R] = a[1] * expf(a[0] - mn) + b[1] * expf(b[0] - mn);
    part[base + 2L * R] = a[2] + b[2];
    part[base + 3L * R] = a[3] + b[3];
  }
}

// ---- dx: one block per (32-row tile, H pass) --------------------------------------
using LX = Logits<32, 64>;
constexpr int kDxSlab = HP * 64;  // the w slab [HP h][64 v]
constexpr int kDxSmem = 2 * (kRing * LX::kStageElems + kDxSlab + 32 * 64);

__global__ void __launch_bounds__(kThreads, 1) lxent_dx_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const long long* __restrict__ labels,
    const float* __restrict__ lse, const float* __restrict__ dy, bf16* __restrict__ dx, int R,
    int H, int V, float eps, int xcopy, int wcopy) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring_base = reinterpret_cast<bf16*>(smem_raw);
  bf16* slab = ring_base + kRing * LX::kStageElems;  // [HP][64], chunks swizzled r % 8
  bf16* gs = slab + kDxSlab;                         // [32][64]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * 32;
  const int h0 = blockIdx.y * HP;
  const int n_vt = (V + 63) / 64;
  const int chunks = (H + KC - 1) / KC;
  const float inv_v = 1.f / static_cast<float>(V);
  Ring ring{ring_base, LX::kStageElems, n_vt * chunks};
  int f_tile = 0, f_h = 0;
  auto feed = [&](bf16* slot) {
    LX::feed(slot, x, w, R, H, V, r0, f_h, f_tile * 64, xcopy, wcopy);
    f_h += KC;
    if (f_h >= H) {
      f_h = 0;
      ++f_tile;
    }
  };
  auto stage_slab = [&](int v0) {  // w[h0 .. h0 + HP, v0 .. v0 + 64]
    ptt::stage_bf16(slab, w, HP, 64, V, h0, v0, H, V, wcopy, threadIdx.x, kThreads, Swz<8>());
    cp_async_commit();
  };
  // dx[32 x HP]: warp w owns columns [64 w, 64 w + 64): 2 m16 x 8 n8
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  const int n_base = warp * 64;
  stage_slab(0);
  ring.prologue(feed);
  for (int tile = 0; tile < n_vt; ++tile) {
    const int v0 = tile * 64;
    float z[LX::NJ][4] = {};
    for (int c = 0; c < chunks; ++c) LX::mma(ring.consume(feed), z);
    store_grad<LX, 32, 64>(z, gs, r0, v0, R, V, labels, lse, dy, eps, inv_v);
    cp_async_wait(0);  // the slab (and the ring's prefetch) landed
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // v in 4 k16 steps
      unsigned a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ptt::ldsm_x4(a[mi], ptt::at_bf16(gs, 64, 16 * mi + (lane & 15),
                                         16 * ks + 8 * (lane >> 4), Swz<8>()));
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        if (h0 + n_base + 8 * j >= H) break;  // warp-uniform
        unsigned b[4];
        ptt::ldsm_x4(b, ptt::at_bf16(slab, 64, n_base + 8 * j + (lane & 7) + 8 * (lane >> 4),
                                     16 * ks + 8 * ((lane >> 3) & 1), Swz<8>()));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          ptt::mma_bf16(acc[mi][j], a[mi], b[0], b[1]);
          ptt::mma_bf16(acc[mi][j + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // gs and the slab are free
    if (tile + 1 < n_vt) stage_slab(v0 + 64);
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 16 * mi + g + 8 * hh;
        const int c = h0 + n_base + 8 * j + 2 * t;
        if (r >= R) continue;
        bf16* dst = dx + static_cast<long>(r) * H + c;
        if (c + 1 < H && (H & 1) == 0) {
          *reinterpret_cast<unsigned*>(dst) = ptt::pack2(acc[mi][j][2 * hh], acc[mi][j][2 * hh + 1]);
        } else {
          if (c < H) dst[0] = ptt::f2bf(acc[mi][j][2 * hh]);
          if (c + 1 < H) dst[1] = ptt::f2bf(acc[mi][j][2 * hh + 1]);
        }
      }
}

// ---- dw: one block per (32-column vocab tile, H pass) -----------------------------
using LW = Logits<64, 32>;
constexpr int kDwSlab = 64 * HP;  // the x slab [64 r][HP h]
constexpr int kDwSmem = 2 * (kRing * LW::kStageElems + kDwSlab + 64 * 32);

__global__ void __launch_bounds__(kThreads, 1) lxent_dw_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const long long* __restrict__ labels,
    const float* __restrict__ lse, const float* __restrict__ dy, bf16* __restrict__ dw, int R,
    int H, int V, float eps, int xcopy, int wcopy) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring_base = reinterpret_cast<bf16*>(smem_raw);
  bf16* slab = ring_base + kRing * LW::kStageElems;  // [64][HP], chunks swizzled r % 8
  bf16* gs = slab + kDwSlab;                         // [64][32]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int v0 = blockIdx.x * 32;
  const int h0 = blockIdx.y * HP;
  const int n_rt = (R + 63) / 64;
  const int chunks = (H + KC - 1) / KC;
  const float inv_v = 1.f / static_cast<float>(V);
  Ring ring{ring_base, LW::kStageElems, n_rt * chunks};
  int f_tile = 0, f_h = 0;
  auto feed = [&](bf16* slot) {
    LW::feed(slot, x, w, R, H, V, f_tile * 64, f_h, v0, xcopy, wcopy);
    f_h += KC;
    if (f_h >= H) {
      f_h = 0;
      ++f_tile;
    }
  };
  auto stage_slab = [&](int r0) {  // x[r0 .. r0 + 64, h0 .. h0 + HP]
    ptt::stage_bf16(slab, x, 64, HP, H, r0, h0, R, H, xcopy, threadIdx.x, kThreads, Swz<8>());
    cp_async_commit();
  };
  // dw[HP x 32]: warp w owns rows [64 w, 64 w + 64): 4 m16 x 4 n8
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  const int m_base = warp * 64;
  const bool live = h0 + m_base < H;  // warp-uniform
  stage_slab(0);
  ring.prologue(feed);
  for (int tile = 0; tile < n_rt; ++tile) {
    const int r0 = tile * 64;
    float z[LW::NJ][4] = {};
    for (int c = 0; c < chunks; ++c) LW::mma(ring.consume(feed), z);
    store_grad<LW, 64, 32>(z, gs, r0, v0, R, V, labels, lse, dy, eps, inv_v);
    cp_async_wait(0);
    __syncthreads();
    if (live) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // r in 4 k16 steps
        unsigned b[2][4];  // g [64 r][32 v]: n8 blocks (0, 1) and (2, 3)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp)
          ptt::ldsm_x4_t(b[jp], ptt::at_bf16(gs, 32, 16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1),
                                             16 * jp + 8 * (lane >> 4), Swz<4>()));
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          unsigned a[4];  // x^T: m = h, k = r, from x [r][h] transposed
          ptt::ldsm_x4_t(a, ptt::at_bf16(slab, HP, 16 * ks + (lane & 7) + 8 * (lane >> 4),
                                         m_base + 16 * mi + 8 * ((lane >> 3) & 1), Swz<8>()));
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            ptt::mma_bf16(acc[mi][2 * jp], a, b[jp][0], b[jp][1]);
            ptt::mma_bf16(acc[mi][2 * jp + 1], a, b[jp][2], b[jp][3]);
          }
        }
      }
    }
    __syncthreads();
    if (tile + 1 < n_rt) stage_slab(r0 + 64);
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = h0 + m_base + 16 * mi + g + 8 * hh;
        const int c = v0 + 8 * j + 2 * t;
        if (r >= H) continue;
        bf16* dst = dw + static_cast<long>(r) * V + c;
        if (c + 1 < V && (V & 1) == 0) {
          *reinterpret_cast<unsigned*>(dst) = ptt::pack2(acc[mi][j][2 * hh], acc[mi][j][2 * hh + 1]);
        } else {
          if (c < V) dst[0] = ptt::f2bf(acc[mi][j][2 * hh]);
          if (c + 1 < V) dst[1] = ptt::f2bf(acc[mi][j][2 * hh + 1]);
        }
      }
}

constexpr int kFwdSmem = 2 * kRing * LF::kStageElems;
static_assert(kDxSmem <= kSmemMax && kDwSmem <= kSmemMax && kFwdSmem <= kSmemMax, "smem");

template <class Kern>
cudaError_t raise_smem(Kern kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// part: [splits, 4, R] float32 scratch (splits from fwd_splits)
extern "C" int ptt_linear_xent_fwd_bf16_before(const bf16* x, const bf16* w, const long long* labels,
                                        float* loss, float* lse, float* part, int R, int H,
                                        int V, int splits, float eps, cudaStream_t stream) {
  if (R < 0 || H < 1 || V < 1 || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaSuccess);
  static const cudaError_t raised = raise_smem(lxent_fwd_bf16_kernel, kFwdSmem);
  if (raised != cudaSuccess) return static_cast<int>(raised);
  const int n_vt = (V + 63) / 64;
  const int per = (n_vt + splits - 1) / splits;
  const int xcopy = ptt::copy_mode(H, x);
  const int wcopy = ptt::copy_mode(V, w);
  lxent_fwd_bf16_kernel<<<dim3((R + 63) / 64, splits), kThreads, kFwdSmem, stream>>>(
      x, w, labels, part, R, H, V, per, xcopy, wcopy);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  lxent_fwd_combine<<<(R + 255) / 256, 256, 0, stream>>>(part, labels, loss, lse, R, V,
                                                             splits, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptt_linear_xent_dx_bf16_before(const bf16* x, const bf16* w, const long long* labels,
                                       const float* lse, const float* dy, bf16* dx, int R,
                                       int H, int V, float eps, cudaStream_t stream) {
  if (R < 0 || H < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return static_cast<int>(cudaSuccess);
  static const cudaError_t raised = raise_smem(lxent_dx_bf16_kernel, kDxSmem);
  if (raised != cudaSuccess) return static_cast<int>(raised);
  const int xcopy = ptt::copy_mode(H, x);
  const int wcopy = ptt::copy_mode(V, w);
  lxent_dx_bf16_kernel<<<dim3((R + 31) / 32, (H + HP - 1) / HP), kThreads, kDxSmem, stream>>>(
      x, w, labels, lse, dy, dx, R, H, V, eps, xcopy, wcopy);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptt_linear_xent_dw_bf16_before(const bf16* x, const bf16* w, const long long* labels,
                                       const float* lse, const float* dy, bf16* dw, int R,
                                       int H, int V, float eps, cudaStream_t stream) {
  if (R < 0 || H < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) {  // no row: dw is 0
    const cudaError_t e =
        cudaMemsetAsync(dw, 0, static_cast<size_t>(H) * V * sizeof(bf16), stream);
    return static_cast<int>(e);
  }
  static const cudaError_t raised = raise_smem(lxent_dw_bf16_kernel, kDwSmem);
  if (raised != cudaSuccess) return static_cast<int>(raised);
  const int xcopy = ptt::copy_mode(H, x);
  const int wcopy = ptt::copy_mode(V, w);
  lxent_dw_bf16_kernel<<<dim3((V + 31) / 32, (H + HP - 1) / HP), kThreads, kDwSmem, stream>>>(
      x, w, labels, lse, dy, dw, R, H, V, eps, xcopy, wcopy);
  return static_cast<int>(cudaGetLastError());
}
