// matmul_bias_act: out = act(x @ w + bias) over x [M, K], w [K, N],
// bias [N] (optional), all float32 row-major.  act is applied to the
// float32 sum before the single store: identity, relu, tanh, sigmoid,
// exact-erf gelu 0.5 z (1 + erf(z / sqrt 2)), swish z sigmoid(z).
// matmul_swiglu, the gated form of the same kernels: out = silu(x @ wg) *
// (x @ wu) over wg and wu [K, N], both products and the gate formed on
// chip, so the gate and up pre-activations never reach device memory.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py matmul_bias_act (:1257;
// pallas_call :1237 in _mm_call, kernel body _mm_kernel :1148, epilogue
// _mm_act) and matmul_swiglu (:1325; pallas_call :1302 in _swiglu_call,
// body _swiglu_kernel :1286).
//
// Bound on the card.  Many rows (training, serving, prefill): operations,
// 2 M K N FLOPs (4 M K N gated).  With TF32 off that is the float32 rate,
// 67 TFLOP/s, of which the library's SGEMM reaches about two thirds; only
// the tensor cores pass it: 3xTF32 (three TF32 products per float32
// product) is bound at 495 / 3 = 165 TFLOP/s.  Few rows (the decode and
// beam steps' 1-16): bytes, the 4 K N bytes of w (8 K N gated) read once.
//
// The plan (mm_plan in matmul_epilogue.py, handed in as five ints: form,
// bm, bn, slices, k_slice) is a pure function of (M, N, K): the form, the
// block tile and the K slices.  K slice s covers [s k_slice, min(K, (s +
// 1) k_slice)); with more than one slice, the slices of an output tile
// are one thread-block cluster along grid x, and their partial tiles are
// summed through distributed shared memory in slice order before the
// epilogue (bias and activation, or the gate) is applied once.  No
// workspace, no second launch, no atomics: every output element sums its
// k in one fixed order given by the plan, so reruns are bit-equal.  The
// order depends on (M, N, K) and nothing else: a row's result never
// depends on another row's values (the serving engine's pooled == solo
// contract at its fixed M), while the same row at another M may take
// another plan and differ in the last bits.
//
// Tiled form (M > 16): 3xTF32 on mma.sync.m16n8k8 (tf32_mma.cuh, shared
// with linear_xent.cu: the same split, big*small order and fragment
// layout; the split's rounding is done in integer ops, tf32_mma.cuh's
// split_rna, as the mainloop does 96 splits a warp per stage beside its
// 192 mma).  A block of 8 warps owns a bm x bn output tile (matmul_bias_act 128 x 128
// or 64 x 64; matmul_swiglu 128 x 64 or 64 x 64 of each of g and u, two
// accumulator sets from the same x fragments); a warp owns 32 rows and
// bn / (8 / (bm / 32)) columns.  K advances in 32-deep stages through a
// ring of 4 cp.async stages in dynamic shared memory (128 KB: one block
// an SM for the large tile, two for the small): 16-byte copies where
// rows are 16-byte aligned, 4-byte copies otherwise, masked elements
// zero-filled (K 1000, N 333, N 2 need no padded copy).  Rows are
// XOR-swizzled so that the fragment loads are free of bank conflicts: an
// x row [32] stores column c at c ^ 8 (row % 4) (a half-warp's float2
// loads cover 4 rows x 8 columns); a w row [bn] at c ^ 8 ((row % 4) ^
// (row / 4 % 2)) (a warp's loads cover rows 2t or 2t + 1 of an 8-deep
// step x 8 columns).  The tensor core's own accumulation rounds toward
// zero, so each stage is a chunk: a warp splits its x fragments of the
// stage once, then per 8 columns forms the stage's 32-deep product from
// zero (12 mma) and adds it in float32 to the running sum, stages in
// ascending k.  The epilogue puts the tile in shared memory (row stride
// bn + 8: conflict-free float2 writes), then the cluster's blocks each
// finish a 1/slices share of it with float4 reads and coalesced stores.
// mma.sync's own TF32 rate on this card is below wgmma's 495 TFLOP/s
// (scripts/matmul_check.py --card measures it).
//
// Skinny form (M <= 16): bound by w's bytes, so it reads w once, 16 bytes
// a thread, with plain float32 FMAs (the products are exact float32; at
// these rows the FMAs are well under the byte time).  A block owns a
// column strip of bn (128, 64 or 32) and a K slice; its 256 threads are
// bn / 4 column groups x 1024 / bn k-lanes.  x's rows (padded to a power
// of two, at most 16) are staged in shared memory 256 k at a time; each
// thread walks its k-lane's rows of w 4 loads ahead, the block sums the
// k-lanes in lane order, and the cluster sums the slices in slice order.
//
// Why mma.sync and not yet wgmma: tf32 wgmma takes both operands K-major
// in shared memory, and w [K, N] is N-major; a wgmma form needs a
// transposing stage and separate big / small tiles.
#include "tf32_mma.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

using ptt::Split;
using ptt::cp_async16;
using ptt::cp_async4;
using ptt::cp_async_commit;
using ptt::cp_async_wait;
using ptt::mma3;
using ptt::split2_rna;
using ptt::split_rna;

constexpr int kThreads = 256;
constexpr int BK = 32;        // depth of a stage: one mma accumulation from zero
constexpr int kRaster = 8;    // row tiles walked together: blocks share w strips
constexpr int XCH = 256;      // the skinny form's x chunk (k a stage)
constexpr int kSkinnyRows = 16;
constexpr int kSmemMax = 232448;

enum Form { kTiled = 0, kSkinny = 1 };
enum Act { kIdentity = 0, kRelu = 1, kTanh = 2, kSigmoid = 3, kGelu = 4, kSwish = 5 };

__device__ __forceinline__ float apply_act(float z, int act) {
  switch (act) {
    case kRelu: return fmaxf(z, 0.f);
    case kTanh: return tanhf(z);
    case kSigmoid: return 1.f / (1.f + expf(-z));
    case kGelu: return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
    case kSwish: return z / (1.f + expf(-z));
    default: return z;
  }
}

// the epilogue of one output element: act(z + bias) or silu(z) * u
template <bool Gated>
__device__ __forceinline__ float finish(float z, float u, const float* __restrict__ bias,
                                        int col, int act) {
  if constexpr (Gated) {
    return z / (1.f + expf(-z)) * u;
  } else {
    if (bias != nullptr) z += __ldg(bias + col);
    return apply_act(z, act);
  }
}

// out[row][col .. col + 3] from v (and u), masked at N; vec: N % 4 == 0 and
// out 16-byte aligned, so a 4-group is wholly in or out
template <bool Gated>
__device__ __forceinline__ void store4(float* __restrict__ out, const float* __restrict__ bias,
                                       int row, int col, int N, int act, float4 v, float4 u,
                                       bool vec) {
  float r[4] = {v.x, v.y, v.z, v.w};
  const float ru[4] = {u.x, u.y, u.z, u.w};
  float* dst = out + static_cast<long>(row) * N + col;
  if (vec) {
    if (col >= N) return;
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = finish<Gated>(r[j], ru[j], bias, col + j, act);
    *reinterpret_cast<float4*>(dst) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < N) dst[j] = finish<Gated>(r[j], ru[j], bias, col + j, act);
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The cluster's sum of a partial tile, finished by shares: `part` holds
// this block's partial tile (products x rows x cols, row stride ld, in
// shared memory).  After a cluster barrier, block `rank` of `n` adds, for
// its 1/n share of the tile's 4-groups, the n partials in slice order,
// finishes and stores them; a second barrier keeps every block's shared
// memory alive until its peers have read it.  n == 1 reads its own tile.
template <bool Gated>
__device__ __forceinline__ void cluster_finish(float* part, int rows, int cols, int ld,
                                               int rank, int n, int m0, int n0, int M,
                                               int N, const float* __restrict__ bias,
                                               float* __restrict__ out, int act, bool vec) {
  cg::cluster_group cluster = cg::this_cluster();
  if (n > 1)
    cluster.sync();
  else
    __syncthreads();
  const int groups = rows * cols / 4;
  const int per = (groups + n - 1) / n;
  const int end = min(groups, (rank + 1) * per);
  const int plane = rows * ld;  // the u tile follows the g tile
  for (int q = rank * per + threadIdx.x; q < end; q += blockDim.x) {
    const int r = (q * 4) / cols, c = (q * 4) % cols;
    const int off = r * ld + c;
    float4 v = *reinterpret_cast<const float4*>(
        n > 1 ? cluster.map_shared_rank(part, 0) + off : part + off);
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (Gated)
      u = *reinterpret_cast<const float4*>(
          (n > 1 ? cluster.map_shared_rank(part, 0) : part) + plane + off);
    for (int s = 1; s < n; ++s) {
      const float* peer = cluster.map_shared_rank(part, s);
      v = add4(v, *reinterpret_cast<const float4*>(peer + off));
      if constexpr (Gated) u = add4(u, *reinterpret_cast<const float4*>(peer + plane + off));
    }
    if (m0 + r < M) store4<Gated>(out, bias, m0 + r, n0 + c, N, act, v, u, vec);
  }
  if (n > 1) cluster.sync();  // no block leaves while a peer may read its part
}

// ---- tiled form: 3xTF32 tensor-core tiles -------------------------------------
constexpr int kStages = 4;  // the cp.async ring

__device__ __forceinline__ int swz_x(int row) { return (row & 3) << 3; }
__device__ __forceinline__ int swz_w(int row) {
  return ((row & 3) ^ ((row >> 2) & 1)) << 3;
}

template <int BM, int BN, bool Gated>
struct Tile {
  static constexpr int kWarpsM = BM / 32;
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int WN = BN / kWarpsN;  // a warp's columns (of each product)
  static constexpr int NJ = WN / 8;
  static constexpr int kW = Gated ? 2 : 1;  // weight tiles a stage
  static constexpr int kXFloats = BM * BK;
  static constexpr int kWFloats = BK * BN;
  static constexpr int kStageFloats = kXFloats + kW * kWFloats;
  static constexpr int kMain = kStages * kStageFloats;
  static constexpr int kPartLd = BN + 8;
  static constexpr int kPartFloats = kW * BM * kPartLd;
  static constexpr int kSmem = 4 * (kMain > kPartFloats ? kMain : kPartFloats);
  static_assert(kWarpsM * kWarpsN == 8 && NJ >= 1 && BN % 32 == 0, "tile");
  static_assert(kSmem <= kSmemMax, "shared memory");
};

// block t of a tiles_m x tiles_n grid, walked kRaster row tiles at a time
// so that the blocks in flight share column strips of w
__device__ __forceinline__ void raster(int t, int tiles_m, int tiles_n, int& tm, int& tn) {
  const int per_group = kRaster * tiles_n;
  const int group = t / per_group;
  const int first = group * kRaster;
  const int rows = min(kRaster, tiles_m - first);
  const int i = t - group * per_group;
  tm = first + i % rows;
  tn = i / rows;
}

// grid (slices, tiles): block (s, t) sums K slice s of output tile t;
// vec_x / vec_w: 16-byte copies of x / of w (and wu); vec_out: float4 stores
template <int BM, int BN, bool Gated>
__global__ void __launch_bounds__(kThreads, BM == 128 ? 1 : 2) mm_tiled(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ wu,
    const float* __restrict__ bias, float* __restrict__ out, int M, int N, int K,
    int k_slice, int act, bool vec_x, bool vec_w, bool vec_out) {
  using T = Tile<BM, BN, Gated>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp % T::kWarpsM, warp_n = warp / T::kWarpsM;
  int tm, tn;
  raster(blockIdx.y, (M + BM - 1) / BM, (N + BN - 1) / BN, tm, tn);
  const int m0 = tm * BM, n0 = tn * BN;
  const int slice = blockIdx.x;
  const int k_begin = slice * k_slice;
  const int k_end = min(K, k_begin + k_slice);
  const int n_stages = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // stage s of this slice into ring slot s % kStages (or only a commit)
  auto feed = [&](int s) {
    if (s < n_stages) {
      float* xs = smem + (s % kStages) * T::kStageFloats;
      const int k0 = k_begin + s * BK;
      if (vec_x) {
        for (int i = tid; i < BM * (BK / 4); i += kThreads) {
          const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
          const bool in = m0 + r < M && k0 + c < k_end;
          cp_async16(xs + r * BK + (c ^ swz_x(r)),
                     in ? x + static_cast<long>(m0 + r) * K + k0 + c : x, in);
        }
      } else {
        for (int i = tid; i < BM * BK; i += kThreads) {
          const int r = i / BK, c = i % BK;
          const bool in = m0 + r < M && k0 + c < k_end;
          cp_async4(xs + r * BK + (c ^ swz_x(r)),
                    in ? x + static_cast<long>(m0 + r) * K + k0 + c : x, in);
        }
      }
#pragma unroll
      for (int p = 0; p < T::kW; ++p) {
        const float* src = p == 0 ? w : wu;
        float* ws = xs + T::kXFloats + p * T::kWFloats;
        if (vec_w) {
          for (int i = tid; i < BK * (BN / 4); i += kThreads) {
            const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
            const bool in = k0 + r < k_end && n0 + c < N;
            cp_async16(ws + r * BN + (c ^ swz_w(r)),
                       in ? src + static_cast<long>(k0 + r) * N + n0 + c : src, in);
          }
        } else {
          for (int i = tid; i < BK * BN; i += kThreads) {
            const int r = i / BN, c = i % BN;
            const bool in = k0 + r < k_end && n0 + c < N;
            cp_async4(ws + r * BN + (c ^ swz_w(r)),
                      in ? src + static_cast<long>(k0 + r) * N + n0 + c : src, in);
          }
        }
      }
    }
    cp_async_commit();
  };

  float acc[T::kW][2][T::NJ][4];
#pragma unroll
  for (int p = 0; p < T::kW; ++p)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < T::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][mi][j][e] = 0.f;

  const int rb = warp_m * 32 + g;  // the warp's fragment rows: rb (+ 8, + 16, + 24)
  const int sr = swz_x(rb);        // the same for all four
  const int cb = warp_n * T::WN + g;
  for (int s = 0; s < kStages - 1; ++s) feed(s);
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait(kStages - 2);
    __syncthreads();  // stage s landed for all; slot (s - 1) % kStages is free
    feed(s + kStages - 1);
    const float* xs = smem + (s % kStages) * T::kStageFloats;
    const float* ws = xs + T::kXFloats;
    // the stage's x fragments, split once for all the warp's columns
    Split a[BK / 8][2][4];
#pragma unroll
    for (int kq = 0; kq < BK / 8; ++kq) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = rb + 16 * mi;
        const int c = (8 * kq + 2 * t) ^ sr;
        split2_rna(xs + r * BK + c, a[kq][mi][0], a[kq][mi][2]);
        split2_rna(xs + (r + 8) * BK + c, a[kq][mi][1], a[kq][mi][3]);
      }
    }
    // per 8 columns: the stage's product from zero, then added to the sum
#pragma unroll
    for (int p = 0; p < T::kW; ++p) {
      const float* wp = ws + p * T::kWFloats;
#pragma unroll
      for (int j = 0; j < T::NJ; ++j) {
        const int col = cb + 8 * j;
        float c[2][4] = {};
#pragma unroll
        for (int kq = 0; kq < BK / 8; ++kq) {
          const int k2 = 8 * kq + 2 * t;
          const Split b[2] = {split_rna(wp[k2 * BN + (col ^ swz_w(k2))]),
                              split_rna(wp[(k2 + 1) * BN + (col ^ swz_w(k2 + 1))])};
          mma3(c[0], a[kq][0], b);
          mma3(c[1], a[kq][1], b);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[p][0][j][e] += c[0][e];
          acc[p][1][j][e] += c[1][e];
        }
      }
    }
  }
  cp_async_wait(0);
  __syncthreads();  // the ring is free: it holds the partial tile now

  float* part = smem;
#pragma unroll
  for (int p = 0; p < T::kW; ++p)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < T::NJ; ++j) {
        const int r = warp_m * 32 + 16 * mi + g;
        const int col = warp_n * T::WN + 8 * j + 2 * t;
        float* dst = part + p * BM * T::kPartLd + r * T::kPartLd + col;
        *reinterpret_cast<float2*>(dst) = make_float2(acc[p][mi][j][0], acc[p][mi][j][1]);
        *reinterpret_cast<float2*>(dst + 8 * T::kPartLd) =
            make_float2(acc[p][mi][j][2], acc[p][mi][j][3]);
      }
  cluster_finish<Gated>(part, BM, BN, T::kPartLd, slice, gridDim.x, m0, n0, M, N, bias, out,
                        act, vec_out);
}

// ---- skinny form: few rows, bound by w's bytes ----------------------------------
template <int MR, bool Gated>
struct Skinny {
  static constexpr int kW = Gated ? 2 : 1;
  static constexpr int MRP = MR >= 4 ? MR + 4 : MR;  // x chunk row stride
  // x chunk [XCH][MRP], the k-lanes' sums [kW][1024 / bn][MR][bn], the
  // block's sums [kW][MR][bn]
  static constexpr int smem(int bn) {
    return 4 * (XCH * MRP + kW * 1024 * MR + kW * MR * bn);
  }
  static_assert(smem(128) <= kSmemMax, "shared memory");
};

// grid (slices, strips): block (s, b) sums K slice s of columns
// [b bn, (b + 1) bn); vec_w: 16-byte loads of w (and wu)
template <int MR, bool Gated>
__global__ void __launch_bounds__(kThreads, MR <= 8 ? 3 : 1) mm_skinny(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ wu,
    const float* __restrict__ bias, float* __restrict__ out, int M, int N, int K,
    int k_slice, int act, int bn, bool vec_w, bool vec_out) {
  using S = Skinny<MR, Gated>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int CG = bn / 4, KL = kThreads / CG;
  const int cgi = tid % CG, kl = tid / CG;
  const int n0 = blockIdx.y * bn;
  const int col = n0 + 4 * cgi;
  const int slice = blockIdx.x;
  const int k_begin = slice * k_slice;
  const int k_end = min(K, k_begin + k_slice);
  float* xs = smem;
  float* red = xs + XCH * S::MRP;
  float* part = red + S::kW * 1024 * MR;

  float acc[S::kW][MR][4];
#pragma unroll
  for (int p = 0; p < S::kW; ++p)
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[p][m][j] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += XCH) {
    const int kn = min(XCH, k_end - kc);
    __syncthreads();  // the last chunk's readers are done
    for (int i = tid; i < MR * XCH; i += kThreads) {
      const int m = i / XCH, kk = i % XCH;
      xs[kk * S::MRP + m] = (m < M && kk < kn) ? __ldg(x + static_cast<long>(m) * K + kc + kk) : 0.f;
    }
    __syncthreads();
    for (int kk = kl; kk < kn; kk += 4 * KL) {
      float4 wv[S::kW][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = kk + q * KL;
#pragma unroll
        for (int p = 0; p < S::kW; ++p) {
          const float* src = (p == 0 ? w : wu) + static_cast<long>(kc + k) * N + col;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (k < kn) {
            if (vec_w) {
              if (col < N) v = __ldg(reinterpret_cast<const float4*>(src));
            } else {
              if (col < N) v.x = __ldg(src);
              if (col + 1 < N) v.y = __ldg(src + 1);
              if (col + 2 < N) v.z = __ldg(src + 2);
              if (col + 3 < N) v.w = __ldg(src + 3);
            }
          }
          wv[p][q] = v;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = kk + q * KL;
        if (k >= kn) break;
        float xv[MR];
        if constexpr (MR >= 4) {
#pragma unroll
          for (int m = 0; m < MR; m += 4) {
            const float4 v = *reinterpret_cast<const float4*>(xs + k * S::MRP + m);
            xv[m] = v.x, xv[m + 1] = v.y, xv[m + 2] = v.z, xv[m + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int m = 0; m < MR; ++m) xv[m] = xs[k * S::MRP + m];
        }
#pragma unroll
        for (int p = 0; p < S::kW; ++p)
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            acc[p][m][0] = fmaf(xv[m], wv[p][q].x, acc[p][m][0]);
            acc[p][m][1] = fmaf(xv[m], wv[p][q].y, acc[p][m][1]);
            acc[p][m][2] = fmaf(xv[m], wv[p][q].z, acc[p][m][2]);
            acc[p][m][3] = fmaf(xv[m], wv[p][q].w, acc[p][m][3]);
          }
      }
    }
  }

  // the k-lanes' sums, added in lane order
#pragma unroll
  for (int p = 0; p < S::kW; ++p)
#pragma unroll
    for (int m = 0; m < MR; ++m)
      *reinterpret_cast<float4*>(red + ((p * KL + kl) * MR + m) * bn + 4 * cgi) =
          make_float4(acc[p][m][0], acc[p][m][1], acc[p][m][2], acc[p][m][3]);
  __syncthreads();
  for (int e = tid; e < MR * bn; e += kThreads) {
#pragma unroll
    for (int p = 0; p < S::kW; ++p) {
      float v = red[p * KL * MR * bn + e];
      for (int l = 1; l < KL; ++l) v += red[(p * KL + l) * MR * bn + e];
      part[p * MR * bn + e] = v;
    }
  }
  // the slices' sums, in slice order, finished by shares ([MR][bn] planes)
  cluster_finish<Gated>(part, MR, bn, bn, slice, gridDim.x, 0, n0, M, N, bias, out, act,
                        vec_out);
}

// ---- host side ------------------------------------------------------------------
struct Plan {
  int form, bm, bn, slices, k_slice;
};

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

// the plan checked against K and this file's kernels
bool plan_ok(const Plan& p, int M, int K, bool gated) {
  if (p.slices < 1 || p.slices > 8 || p.k_slice <= 0 || p.k_slice % BK != 0) return false;
  if (K == 0 ? p.slices != 1
             : !(static_cast<long>(p.slices - 1) * p.k_slice < K &&
                 K <= static_cast<long>(p.slices) * p.k_slice))
    return false;
  if (p.form == kTiled)
    return (p.bm == 128 && p.bn == (gated ? 64 : 128)) || (p.bm == 64 && p.bn == 64);
  if (p.form == kSkinny)
    return (p.bm == 1 || p.bm == 2 || p.bm == 4 || p.bm == 8 || p.bm == kSkinnyRows) &&
           M <= p.bm && (p.bn == 128 || p.bn == 64 || p.bn == 32);
  return false;
}

// grid (slices, blocks) with a cluster of `slices` along x.  The kernel's
// dynamic shared-memory limit is raised to smem_max at its first launch
// (outside any CUDA-graph capture in this package's use), and whether the
// card can place such a cluster is asked once per (slices, smem).
template <auto Kern, class... Args>
cudaError_t launch(int threads, int slices, int blocks, int smem, int smem_max,
                   cudaStream_t stream, Args... args) {
  static const cudaError_t raised =
      cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (raised != cudaSuccess) return raised;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slices, blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  if (slices > 1) {
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    static int checked[32][2];  // (slices, smem) pairs the card can place
    static int n_checked = 0;
    bool seen = false;
    for (int i = 0; i < n_checked; ++i)
      seen |= checked[i][0] == slices && checked[i][1] == smem;
    if (!seen) {
      int clusters = 0;
      const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, Kern, &cfg);
      if (e != cudaSuccess) return e;
      if (clusters < 1) return cudaErrorInvalidConfiguration;
      if (n_checked < 32) {
        checked[n_checked][0] = slices;
        checked[n_checked++][1] = smem;
      }
    }
  }
  return cudaLaunchKernelEx(&cfg, Kern, args...);
}

template <bool Gated>
cudaError_t run_tiled(const Plan& p, const float* x, const float* w, const float* wu,
                      const float* bias, float* out, int M, int N, int K, int act,
                      cudaStream_t stream) {
  const int tiles = ((M + p.bm - 1) / p.bm) * ((N + p.bn - 1) / p.bn);
  const bool vec_x = K % 4 == 0 && aligned16(x);
  const bool vec_w = N % 4 == 0 && aligned16(w) && (!Gated || aligned16(wu));
  const bool vec_out = N % 4 == 0 && aligned16(out);
  if (p.bm == 128) {
    constexpr int BN = Gated ? 64 : 128;
    constexpr int smem = Tile<128, BN, Gated>::kSmem;
    return launch<mm_tiled<128, BN, Gated>>(kThreads, p.slices, tiles, smem, smem, stream, x, w, wu,
                                             bias, out, M, N, K, p.k_slice, act, vec_x,
                                             vec_w, vec_out);
  }
  constexpr int smem = Tile<64, 64, Gated>::kSmem;
  return launch<mm_tiled<64, 64, Gated>>(kThreads, p.slices, tiles, smem, smem, stream, x, w, wu, bias,
                                        out, M, N, K, p.k_slice, act, vec_x, vec_w, vec_out);
}

template <int MR, bool Gated>
cudaError_t run_skinny_rows(const Plan& p, const float* x, const float* w, const float* wu,
                            const float* bias, float* out, int M, int N, int K, int act,
                            cudaStream_t stream) {
  const bool vec_w = N % 4 == 0 && aligned16(w) && (!Gated || aligned16(wu));
  const bool vec_out = N % 4 == 0 && aligned16(out);
  return launch<mm_skinny<MR, Gated>>(kThreads, p.slices, (N + p.bn - 1) / p.bn,
                                      Skinny<MR, Gated>::smem(p.bn),
                                      Skinny<MR, Gated>::smem(128), stream, x, w, wu, bias,
                                      out, M, N, K, p.k_slice, act, p.bn, vec_w, vec_out);
}

template <bool Gated>
cudaError_t run_skinny(const Plan& p, const float* x, const float* w, const float* wu,
                       const float* bias, float* out, int M, int N, int K, int act,
                       cudaStream_t stream) {
  switch (p.bm) {
    case 1: return run_skinny_rows<1, Gated>(p, x, w, wu, bias, out, M, N, K, act, stream);
    case 2: return run_skinny_rows<2, Gated>(p, x, w, wu, bias, out, M, N, K, act, stream);
    case 4: return run_skinny_rows<4, Gated>(p, x, w, wu, bias, out, M, N, K, act, stream);
    case 8: return run_skinny_rows<8, Gated>(p, x, w, wu, bias, out, M, N, K, act, stream);
    default:
      return run_skinny_rows<kSkinnyRows, Gated>(p, x, w, wu, bias, out, M, N, K, act,
                                                 stream);
  }
}

template <bool Gated>
int run(const Plan& p, const float* x, const float* w, const float* wu, const float* bias,
        float* out, int M, int N, int K, int act, cudaStream_t stream) {
  if (M < 0 || N < 0 || K < 0 || act < kIdentity || act > kSwish || !plan_ok(p, M, K, Gated))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t e = p.form == kTiled
                            ? run_tiled<Gated>(p, x, w, wu, bias, out, M, N, K, act, stream)
                            : run_skinny<Gated>(p, x, w, wu, bias, out, M, N, K, act, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// plan: form, bm, bn, slices, k_slice (matmul_epilogue.mm_plan)
extern "C" int ptt_matmul_bias_act(const float* x, const float* w, const float* bias,
                                   float* out, int M, int N, int K, int act, int form,
                                   int bm, int bn, int slices, int k_slice,
                                   cudaStream_t stream) {
  return run<false>(Plan{form, bm, bn, slices, k_slice}, x, w, nullptr, bias, out, M, N, K,
                    act, stream);
}

extern "C" int ptt_matmul_swiglu(const float* x, const float* wg, const float* wu,
                                 float* out, int M, int N, int K, int form, int bm, int bn,
                                 int slices, int k_slice, cudaStream_t stream) {
  return run<true>(Plan{form, bm, bn, slices, k_slice}, x, wg, wu, nullptr, out, M, N, K,
                   kIdentity, stream);
}
