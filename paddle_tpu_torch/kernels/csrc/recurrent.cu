// fused_lstm and fused_gru: whole-sequence recurrences over padded,
// already projected inputs, float32 row-major.
//
//   LSTM: gates = xproj[:, t] + h_{t-1} W       (xproj [B, T, 4H], W [H, 4H],
//         gate order i | f | c~ | o)
//         c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(c~),  h_t = sigmoid(o) tanh(c_t)
//   GRU:  u = sigmoid(x_u + h W_u), r = sigmoid(x_r + h W_r)
//         (xproj [B, T, 3H], W [H, 3H] = [W_u | W_r | W_c])
//         c = tanh(x_c + (r h) W_c),  h_t = u c + (1 - u) h_{t-1}
//   A row b with t >= lens[b] keeps its state: h_t = h_{t-1} (and c_t =
//   c_{t-1}), so a row of length 0 outputs h0 (and c0) at every t.
//   Outputs: hs (and cs) [B, T, H].
//
// Replaces: paddle_tpu/ops/pallas_kernels.py fused_lstm (_lstm_seq_fwd,
// kernel body _lstm_seq_kernel) and fused_gru (_gru_seq_fwd, kernel body
// _gru_seq_kernel).  The backward has no kernel there either: both take
// the vjp of the dense scan (kernels/recurrent.py does the same).
//
// Bound on the card: the T steps are a serial chain.  Step t needs every
// unit of h_{t-1}, so the blocks meet once a step (twice for the GRU),
// and a step's product is only B x H x G H: 67 MFLOP for the LSTM at B 32,
// H 512, well under a microsecond of the card.  What a step costs is the
// meeting, the exchange of h and the latency of its chain of dependent
// operations, so the design cuts each of those.
//
// Design (a persistent RNN, one cooperative launch; its geometry is
// recurrent.py's rnn_plan, a function of the shape alone):
// - Block k owns `units` hidden units (4 at H 512: 128 blocks, one an SM,
//   all co-resident) with every gate column of them: G units columns of W
//   ([H, 16] for the LSTM at H 512).  Its warps split K = H into slices
//   of k_steps x 8.  At H <= 512, ceil(H / 64) warps take 8 k-steps each
//   (zero W past H) and hold their slice of the block's W columns in
//   registers for the whole launch, split once into 3xTF32 big/small
//   mma.sync B fragments (8 k-steps x 2 n-tiles x 4 words = 64 registers
//   a thread); past that about 8 warps split K, W stays in shared memory,
//   unsplit, and each step splits what it reads.  W is read from device
//   memory once a launch.
// - A step's product runs on the tensor cores in 3xTF32 m16n8k8 (as B4,
//   B5 and B3 run it: tf32_mma.cuh), 16-row m-tiles over a pass of at most
//   32 rows, h_{t-1}'s A fragments split as a warp reads them; the tiles
//   are compile-time, so the m- and n-tiles' chains of mma.sync
//   interleave.  Each warp
//   writes its K slice's partial tile to shared memory, and the epilogue
//   sums the partials in warp order: a fixed order, no atomics, the same
//   on any card.
// - The exchange: each block writes its units of h_t to a [2, B, hp]
//   buffer (hp = H rounded up to 4, so every row starts 16-byte aligned;
//   the wrapper zeroes it, so the pad columns read as 0), beside hs.  The
//   rows are contiguous whatever T is, and a stage is whole 16-byte
//   cp.async.cg copies (L2, never a stale L1 line), all issued together and
//   waited once, into a [rows, hstride] tile whose stride is 8 mod 16 words
//   (the A fragments' float2 reads hit distinct banks; W's and the
//   partials' strides likewise).  The LSTM writes
//   h_t to slot t & 1: a block still reading h_{t-1} is never overwritten.
//   The GRU keeps h in slot 0 and r h in slot 1; each is read only between
//   the two barriers that bracket its writes, so one slot each suffices.
//   What is the block's own stays in shared memory: the LSTM's c, the
//   GRU's update gate, and its own units of h_{t-1}.
// - The GRU needs two exchanges a step: phase 2 forms (r h) W_c from every
//   unit of r h, and no block can hold the W_r that would let it form r
//   over all units itself (H x H floats, 1 MB at H 512, against 227 KB of
//   shared memory and 256 KB of registers an SM).
// - A per-step barrier of our own in place of grid.sync(): one arrival
//   counter that each block's thread 0 adds to with a release reduction
//   and polls with relaxed loads, then one fence (`arrive`, `wait_for`).
//   Per-block flags polled by one warp, as first written, took 1.7 us a
//   meeting against the counter's 1.2 (scripts/recurrent_kernel_check.py
//   times both).  The wrapper zeroes the counter before each launch, so an
//   earlier launch's arrivals never release a waiter.  The launch stays
//   cooperative for its guarantee that every block is co-resident: without
//   it a spin barrier can deadlock.  The next step's x slice (the block's
//   gate columns of xproj) is copied in while the block waits.
//
// Determinism: every gate sums its K slices in one order fixed by the
// plan; a row's result does not depend on the other rows.  The length mask
// is a select (t < lens[b]), equal to the reference's active blend for
// finite values.  Plain expf/tanhf (no fast math).
#include <cmath>
#include <cstdint>
#include <mutex>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

using ptt::Split;

constexpr int kMaxThreads = 256;  // 32 x k_warps x n_warps
constexpr int kRegKs = 8;         // k-steps a warp holds in registers
constexpr int kMt = 2;            // 16-row m-tiles: a pass takes at most 32 rows
constexpr int kNtw = 2;           // 8-column n-tiles a warp takes in one product

struct Seq {
  const float* x;     // [B, T, G H] projected inputs
  const float* w;     // [H, G H]
  const float* h0;    // [B, H]
  const float* c0;    // [B, H] (LSTM only)
  const int* lens;    // [B]
  float* hs;          // [B, T, H]
  float* cs;          // [B, T, H] (LSTM only)
  float* xch;         // [2, B, hp] exchange, zeroed by the wrapper
  unsigned* counter;  // the barrier's arrivals, zeroed by the wrapper
  int B, T, H;
  // rnn_plan
  int units, k_warps, n_warps, k_steps, rows;
  // derived by layout()
  int blocks, hp, kp, hstride, wstride, pstride;
  int nt[2], coff[2];  // each product's n-tiles and first W column in shared memory
};

// pad n up to the next value that is `rem` modulo `mod`
constexpr int pad_to(int n, int mod, int rem) {
  return n + ((rem - n % mod) % mod + mod) % mod;
}

// The derived geometry and the dynamic shared memory in bytes (rnn_plan's
// smem must equal it).  Shared memory, in floats: W as k pairs [kp / 2,
// wstride] of float2; the h tile [rows, hstride]; the partials [k_warps,
// rows, pstride]; the x slice [B, G units]; the block's own state [2, B,
// units]; the lengths [B].
long long layout(Seq& p, int gates) {
  const int U = p.units;
  p.blocks = (p.H + U - 1) / U;
  p.hp = (p.H + 3) & ~3;
  p.kp = p.k_warps * p.k_steps * 8;
  p.hstride = pad_to(p.kp, 16, 8);
  p.nt[0] = gates == 4 ? (4 * U + 7) / 8 : (2 * U + 7) / 8;
  p.nt[1] = gates == 4 ? 0 : (U + 7) / 8;
  p.coff[0] = 0;
  p.coff[1] = 8 * p.nt[0];
  p.wstride = pad_to(8 * (p.nt[0] + p.nt[1]), 8, 4);
  p.pstride = pad_to(8 * (p.nt[0] > p.nt[1] ? p.nt[0] : p.nt[1]), 16, 8);
  const long long floats = static_cast<long long>(p.kp) * p.wstride +
                           static_cast<long long>(p.rows) * p.hstride +
                           static_cast<long long>(p.k_warps) * p.rows * p.pstride +
                           static_cast<long long>(p.B) * gates * U + 2LL * p.B * U + p.B;
  return floats * static_cast<long long>(sizeof(float));
}

struct Smem {
  float* w;     // [kp / 2, wstride] float2: (W[2i][c], W[2i + 1][c])
  float* h;     // [rows, hstride] staged state
  float* part;  // [k_warps, rows, pstride] each warp's partial products
  float* xs;    // [B, G units] this step's x slice: gate g, unit u at g units + u
  float* hown;  // [B, units] the block's units of h_{t-1}
  float* aux;   // [B, units] LSTM: c_{t-1}; GRU: this step's update gate
  int* lens;    // [B]
};

__device__ Smem carve(const Seq& p, float* smem, int gates) {
  Smem s;
  s.w = smem;
  s.h = s.w + static_cast<long long>(p.kp) * p.wstride;
  s.part = s.h + p.rows * p.hstride;
  s.xs = s.part + p.k_warps * p.rows * p.pstride;
  s.hown = s.xs + p.B * gates * p.units;
  s.aux = s.hown + p.B * p.units;
  s.lens = reinterpret_cast<int*>(s.aux + p.B * p.units);
  return s;
}

__device__ __forceinline__ float sigmoidf(float z) { return 1.f / (1.f + expf(-z)); }

// ---- the barrier ---------------------------------------------------------------
// The blocks meet at one arrival counter (zeroed by the wrapper): after a
// __syncthreads() (every thread's stores of the phase done), thread 0 adds
// 1 with a release reduction at GPU scope; to wait for the n-th meeting it
// polls the counter with relaxed loads until it reaches n x blocks, then
// fences (a relaxed read that observes the releases, then fence.acq_rel:
// PTX's acquire pattern), and the block meets at __syncthreads().  A wait
// longer than kWaitLimitNs means a block never arrived (it cannot while
// the launch is cooperative): the kernel traps, so the launch fails with
// an error instead of spinning for ever.
constexpr unsigned long long kWaitLimitNs = 10000000000ull;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(ns));
  return ns;
}

__device__ __forceinline__ void arrive(unsigned* counter) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
}

__device__ __forceinline__ void wait_for(const unsigned* counter, unsigned target) {
  if (threadIdx.x == 0) {
    const unsigned long long start = global_ns();
    unsigned seen;
    do {
      asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
      if (seen < target && global_ns() - start > kWaitLimitNs) __trap();
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

// ---- copies ----------------------------------------------------------------------
// The block's gate columns of x at step t into xs (4-byte copies: a gate's
// run of units need not be 16-byte aligned), one commit group.
__device__ void prefetch_x(const Seq& p, const Smem& s, int gates, int t, int u0, int nu) {
  const int per = gates * nu;
  for (int i = threadIdx.x; i < p.B * per; i += blockDim.x) {
    const int b = i / per, j = i - b * per, g = j / nu, u = j - g * nu;
    ptt::cp_async4(s.xs + (b * gates + g) * p.units + u,
                   p.x + (static_cast<long long>(b) * p.T + t) * gates * p.H + g * p.H + u0 + u,
                   true);
  }
  ptt::cp_async_commit();
}

// Rows [r0, r0 + rows) of a state whose row b starts at src + b * stride
// into the h tile: 16-byte copies when `vec` (rows 16-byte aligned; the
// exchange's pad columns are zero), else 4-byte ones.  Waits for every
// copy of the thread (the x slice's too), then the block.
__device__ void stage(const Seq& p, const Smem& s, const float* src, long long stride, bool vec,
                      int r0, int rows) {
  if (vec) {
    // chunk i = r n4 + c of the rows, walked by the block's stride in (r, c)
    const int n4 = (p.H + 3) >> 2, dr = blockDim.x / n4, dc = blockDim.x - dr * n4;
    int r = threadIdx.x / n4, c = threadIdx.x - r * n4;
    while (r < rows) {
      ptt::cp_async16(s.h + r * p.hstride + 4 * c, src + (r0 + r) * stride + 4 * c, true);
      r += dr;
      c += dc;
      if (c >= n4) {
        c -= n4;
        ++r;
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * p.H; i += blockDim.x) {
      const int r = i / p.H, k = i - r * p.H;
      ptt::cp_async4(s.h + r * p.hstride + k, src + (r0 + r) * stride + k, true);
    }
  }
  ptt::cp_async_commit();
  ptt::cp_async_wait(0);
  __syncthreads();
}

// ---- set-up ----------------------------------------------------------------------
// The lengths, the block's units of h0 (and c0), zeroed tiles, and the
// block's W columns into shared memory: product 0 holds gates [0, G0)
// (LSTM: i f c~ o; GRU: u r) at column g units + u, the GRU's product 1
// the candidate at coff[1] + u; rows k >= H and columns past the block's
// last unit stay zero.  W is read in runs of a gate's units (16-byte loads
// where H and units are multiples of 4).
__device__ void setup(const Seq& p, const Smem& s, int gates, int u0, int nu) {
  const int U = p.units;
  for (int i = threadIdx.x; i < p.B; i += blockDim.x) s.lens[i] = p.lens[i];
  for (int i = threadIdx.x; i < p.B * nu; i += blockDim.x) {
    const int b = i / nu, u = i - b * nu;
    s.hown[b * U + u] = p.h0[static_cast<long long>(b) * p.H + u0 + u];
    if (gates == 4) s.aux[b * U + u] = p.c0[static_cast<long long>(b) * p.H + u0 + u];
  }
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < p.kp * p.wstride / 4; i += blockDim.x)
    reinterpret_cast<float4*>(s.w)[i] = zero;
  for (int i = threadIdx.x; i < p.rows * p.hstride / 4; i += blockDim.x)
    reinterpret_cast<float4*>(s.h)[i] = zero;
  __syncthreads();
  const bool vec = p.H % 4 == 0 && U % 4 == 0 && (reinterpret_cast<uintptr_t>(p.w) & 15) == 0;
  const int chunks = vec ? nu / 4 : nu;
  const int per_k = gates * chunks;
  for (int i = threadIdx.x; i < p.H * per_k; i += blockDim.x) {
    const int k = i / per_k, j = i - k * per_k, g = j / chunks, q = j - g * chunks;
    const int col = gates == 3 && g == 2 ? p.coff[1] : g * U;
    const float* src = p.w + static_cast<long long>(k) * gates * p.H + g * p.H + u0;
    float* dst = s.w + ((k >> 1) * p.wstride) * 2 + (k & 1);
    if (vec) {
      const float4 v = *reinterpret_cast<const float4*>(src + 4 * q);
      dst[(col + 4 * q) * 2] = v.x;
      dst[(col + 4 * q + 1) * 2] = v.y;
      dst[(col + 4 * q + 2) * 2] = v.z;
      dst[(col + 4 * q + 3) * 2] = v.w;
    } else {
      dst[(col + q) * 2] = src[q];
    }
  }
  __syncthreads();
}

// ---- the product -----------------------------------------------------------------
// W column `col`'s B fragment for the 8-deep k-step at k0, split:
// {b[0].big, b[1].big, b[0].small, b[1].small} (tf32_mma.cuh's order: the
// fragment's depth t is k0 + 2t, t + 4 is k0 + 2t + 1).
__device__ __forceinline__ uint4 bfrag(const Seq& p, const float* w, int k0, int col, int tq) {
  const float2 v = *reinterpret_cast<const float2*>(w + (((k0 >> 1) + tq) * p.wstride + col) * 2);
  const Split lo = ptt::split_rna(v.x), hi = ptt::split_rna(v.y);
  return make_uint4(lo.big, hi.big, lo.small, hi.small);
}

// The register form's W (k_steps == kRegKs, one warp along N): slot n of
// k-step ks is the LSTM's n-tile n, or the GRU's product n (one n-tile
// each there); a missing n-tile is zero.
template <int kGates>
__device__ void load_frags(const Seq& p, const float* w, uint4 (&wr)[kRegKs][kNtw]) {
  const int lane = threadIdx.x & 31, kw = threadIdx.x >> 5;
#pragma unroll
  for (int ks = 0; ks < kRegKs; ++ks) {
#pragma unroll
    for (int slot = 0; slot < kNtw; ++slot) {
      const int prod = kGates == 4 ? 0 : slot, nt = kGates == 4 ? slot : 0;
      wr[ks][slot] = nt < p.nt[prod] ? bfrag(p, w, (kw * kRegKs + ks) * 8,
                                             p.coff[prod] + nt * 8 + (lane >> 2), lane & 3)
                                     : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// acc[mt][n] += the h tile's m-tile mt x the k-step at k0 against b[n],
// for kMts m-tiles and kNt n-tiles: no branch, so the m-tiles' and
// n-tiles' chains of mma.sync interleave.
template <int kMts, int kNt>
__device__ __forceinline__ void mma_kstep(const Seq& p, const float* h, int k0,
                                          const uint4 (&b)[kNtw], float (&acc)[kMt][kNtw][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < kMts; ++mt) {
    Split a[4];
    const float* row = h + (mt * 16 + (lane >> 2)) * p.hstride + k0 + 2 * (lane & 3);
    ptt::split2_rna(row, a[0], a[2]);
    ptt::split2_rna(row + 8 * p.hstride, a[1], a[3]);
#pragma unroll
    for (int n = 0; n < kNt; ++n) ptt::mma3(acc[mt][n], a, b[n]);
  }
}

// Product kProd over the tile's kMts m-tiles (the plan's rows: a short
// last pass computes rows it does not store): warp (kw, nw) sums its K
// slice for its n-tiles and writes the partial tile to part[kw].  The
// register form takes its 8 k-steps and its n-tiles (the LSTM's 2, the
// GRU's 1 a product) whole, missing ones as zero W; the shared-memory
// form walks k_steps and zeroes the B fragments past its n-tiles.
template <int kGates, bool kRegW, int kProd, int kMts>
__device__ void product(const Seq& p, const Smem& s, const uint4 (&wr)[kRegKs][kNtw]) {
  constexpr int kNt = kGates == 4 || !kRegW ? kNtw : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kw = warp % p.k_warps, nw = warp / p.k_warps;
  const int nt0 = nw * kNtw;
  const int ntv = p.nt[kProd] - nt0;  // this warp's n-tiles (may be <= 0)
  float acc[kMt][kNtw][4];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int n = 0; n < kNtw; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  const int kb = kw * p.k_steps * 8;
  if constexpr (kRegW) {
#pragma unroll
    for (int ks = 0; ks < kRegKs; ++ks) {
      uint4 b[kNtw];
#pragma unroll
      for (int n = 0; n < kNtw; ++n) b[n] = wr[ks][kGates == 4 ? n : kProd];
      mma_kstep<kMts, kNt>(p, s.h, kb + ks * 8, b, acc);
    }
  } else {
    const int col = p.coff[kProd] + nt0 * 8 + (lane >> 2);
    for (int ks = 0; ks < p.k_steps; ++ks) {
      uint4 b[kNtw];
#pragma unroll
      for (int n = 0; n < kNtw; ++n)
        b[n] = n < ntv ? bfrag(p, s.w, kb + ks * 8, col + n * 8, lane & 3)
                       : make_uint4(0u, 0u, 0u, 0u);
      mma_kstep<kMts, kNt>(p, s.h, kb + ks * 8, b, acc);
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMts; ++mt) {
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      if (n < ntv) {
        float* d = s.part + (kw * p.rows + mt * 16 + (lane >> 2)) * p.pstride + (nt0 + n) * 8 +
                   2 * (lane & 3);
        *reinterpret_cast<float2*>(d) = make_float2(acc[mt][n][0], acc[mt][n][1]);
        *reinterpret_cast<float2*>(d + 8 * p.pstride) = make_float2(acc[mt][n][2], acc[mt][n][3]);
      }
    }
  }
}

// h_{t-1} W column c of pass row r: the warps' K slices summed in warp
// order (k_warps <= 8: the loads issue together)
__device__ __forceinline__ float gate_sum(const Seq& p, const float* part, int r, int c) {
  constexpr int kMaxKw = kMaxThreads / 32;
  const float* q = part + r * p.pstride + c;
  const int step = p.rows * p.pstride;
  float v[kMaxKw];
#pragma unroll
  for (int kw = 0; kw < kMaxKw; ++kw) v[kw] = kw < p.k_warps ? q[kw * step] : 0.f;
  float z = v[0];
#pragma unroll
  for (int kw = 1; kw < kMaxKw; ++kw)
    if (kw < p.k_warps) z += v[kw];
  return z;
}

// ---- the epilogues ---------------------------------------------------------------
__device__ void lstm_epilogue(const Seq& p, const Smem& s, int t, int r0, int rows, int u0,
                              int nu) {
  const int U = p.units;
  float* xch = p.xch + static_cast<long long>(t & 1) * p.B * p.hp;
  for (int i = threadIdx.x; i < rows * nu; i += blockDim.x) {
    const int r = i / nu, u = i - r * nu, b = r0 + r;
    const float* x = s.xs + b * 4 * U;
    const float gi = x[u] + gate_sum(p, s.part, r, u);
    const float gf = x[U + u] + gate_sum(p, s.part, r, U + u);
    const float gc = x[2 * U + u] + gate_sum(p, s.part, r, 2 * U + u);
    const float go = x[3 * U + u] + gate_sum(p, s.part, r, 3 * U + u);
    const float c_prev = s.aux[b * U + u], h_prev = s.hown[b * U + u];
    float c = sigmoidf(gf) * c_prev + sigmoidf(gi) * tanhf(gc);
    float h = sigmoidf(go) * tanhf(c);
    if (t >= s.lens[b]) {
      c = c_prev;
      h = h_prev;
    }
    s.aux[b * U + u] = c;
    s.hown[b * U + u] = h;
    const long long at = (static_cast<long long>(b) * p.T + t) * p.H + u0 + u;
    p.hs[at] = h;
    p.cs[at] = c;
    xch[static_cast<long long>(b) * p.hp + u0 + u] = h;
  }
}

// GRU phase 1: u and r for the block's units; r h_{t-1} to the exchange
__device__ void gru_epilogue_ur(const Seq& p, const Smem& s, int r0, int rows, int u0, int nu) {
  const int U = p.units;
  float* rh = p.xch + static_cast<long long>(p.B) * p.hp;
  for (int i = threadIdx.x; i < rows * nu; i += blockDim.x) {
    const int r = i / nu, u = i - r * nu, b = r0 + r;
    const float* x = s.xs + b * 3 * U;
    const float ug = sigmoidf(x[u] + gate_sum(p, s.part, r, u));
    const float rg = sigmoidf(x[U + u] + gate_sum(p, s.part, r, U + u));
    s.aux[b * U + u] = ug;
    rh[static_cast<long long>(b) * p.hp + u0 + u] = rg * s.hown[b * U + u];
  }
}

// GRU phase 2: the candidate from every unit's r h, then the blend
__device__ void gru_epilogue_h(const Seq& p, const Smem& s, int t, int r0, int rows, int u0,
                               int nu) {
  const int U = p.units;
  for (int i = threadIdx.x; i < rows * nu; i += blockDim.x) {
    const int r = i / nu, u = i - r * nu, b = r0 + r;
    const float c = tanhf(s.xs[b * 3 * U + 2 * U + u] + gate_sum(p, s.part, r, u));
    const float ug = s.aux[b * U + u], h_prev = s.hown[b * U + u];
    const float h = t < s.lens[b] ? ug * c + (1.f - ug) * h_prev : h_prev;
    s.hown[b * U + u] = h;
    p.hs[(static_cast<long long>(b) * p.T + t) * p.H + u0 + u] = h;
    p.xch[static_cast<long long>(b) * p.hp + u0 + u] = h;
  }
}

__device__ __forceinline__ bool h0_vec(const Seq& p) {
  return p.H % 4 == 0 && (reinterpret_cast<uintptr_t>(p.h0) & 15) == 0;
}

// ---- the kernels -----------------------------------------------------------------
template <bool kRegW, int kMts>
__global__ void __launch_bounds__(kMaxThreads, 1) lstm_seq_kernel(Seq p) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(p, smem, 4);
  const int u0 = blockIdx.x * p.units, nu = min(p.units, p.H - u0);
  prefetch_x(p, s, 4, 0, u0, nu);
  setup(p, s, 4, u0, nu);
  uint4 wr[kRegKs][kNtw];
  if constexpr (kRegW) load_frags<4>(p, s.w, wr);
  const long long bhp = static_cast<long long>(p.B) * p.hp;
  for (int t = 0; t < p.T; ++t) {
    for (int r0 = 0; r0 < p.B; r0 += p.rows) {
      const int rows = min(p.rows, p.B - r0);
      if (t == 0)
        stage(p, s, p.h0, p.H, h0_vec(p), r0, rows);
      else
        stage(p, s, p.xch + ((t - 1) & 1) * bhp, p.hp, true, r0, rows);
      product<4, kRegW, 0, kMts>(p, s, wr);
      __syncthreads();
      lstm_epilogue(p, s, t, r0, rows, u0, nu);
      __syncthreads();
    }
    if (t + 1 < p.T) {
      arrive(p.counter);
      prefetch_x(p, s, 4, t + 1, u0, nu);
      wait_for(p.counter, (t + 1) * p.blocks);
    }
  }
}

template <bool kRegW, int kMts>
__global__ void __launch_bounds__(kMaxThreads, 1) gru_seq_kernel(Seq p) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(p, smem, 3);
  const int u0 = blockIdx.x * p.units, nu = min(p.units, p.H - u0);
  prefetch_x(p, s, 3, 0, u0, nu);
  setup(p, s, 3, u0, nu);
  uint4 wr[kRegKs][kNtw];
  if constexpr (kRegW) load_frags<3>(p, s.w, wr);
  const float* rh = p.xch + static_cast<long long>(p.B) * p.hp;
  for (int t = 0; t < p.T; ++t) {
    for (int r0 = 0; r0 < p.B; r0 += p.rows) {
      const int rows = min(p.rows, p.B - r0);
      if (t == 0)
        stage(p, s, p.h0, p.H, h0_vec(p), r0, rows);
      else
        stage(p, s, p.xch, p.hp, true, r0, rows);
      product<3, kRegW, 0, kMts>(p, s, wr);
      __syncthreads();
      gru_epilogue_ur(p, s, r0, rows, u0, nu);
      __syncthreads();
    }
    arrive(p.counter);
    wait_for(p.counter, (2 * t + 1) * p.blocks);
    for (int r0 = 0; r0 < p.B; r0 += p.rows) {
      const int rows = min(p.rows, p.B - r0);
      stage(p, s, rh, p.hp, true, r0, rows);
      product<3, kRegW, 1, kMts>(p, s, wr);
      __syncthreads();
      gru_epilogue_h(p, s, t, r0, rows, u0, nu);
      __syncthreads();
    }
    if (t + 1 < p.T) {
      arrive(p.counter);
      prefetch_x(p, s, 3, t + 1, u0, nu);
      wait_for(p.counter, (2 * t + 2) * p.blocks);
    }
  }
}

// ---- the launch ------------------------------------------------------------------
// What a launch would otherwise query every time, cached: each
// device's SM count, shared-memory opt-in and cooperative support; each
// kernel's dynamic shared-memory limit as set so far; the co-resident
// blocks an SM for each (kernel, device, threads, shared memory).
struct DevInfo {
  int sms = 0, optin = 0, coop = 0;
  bool known = false;
};
struct Occupancy {
  const void* kernel;
  int dev, threads, smem, per_sm;
};
struct SmemLimit {
  const void* kernel;
  int dev, bytes;
};

std::mutex g_mu;
DevInfo g_dev[64];
Occupancy g_occ[64];
int g_nocc = 0;
SmemLimit g_lim[32];
int g_nlim = 0;

int cached_occupancy(const void* kernel, int dev, int threads, int smem, int* per_sm) {
  for (int i = 0; i < g_nocc; ++i) {
    const Occupancy& o = g_occ[i];
    if (o.kernel == kernel && o.dev == dev && o.threads == threads && o.smem == smem) {
      *per_sm = o.per_sm;
      return cudaSuccess;
    }
  }
  int* set = nullptr;
  for (int i = 0; i < g_nlim; ++i)
    if (g_lim[i].kernel == kernel && g_lim[i].dev == dev) set = &g_lim[i].bytes;
  if (set == nullptr || *set < smem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (set != nullptr)
      *set = smem;
    else if (g_nlim < 32)
      g_lim[g_nlim++] = SmemLimit{kernel, dev, smem};
  }
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (g_nocc < 64) g_occ[g_nocc++] = Occupancy{kernel, dev, threads, smem, *per_sm};
  return cudaSuccess;
}

// Returns a CUDA error code: cudaErrorInvalidValue when the plan does not
// fit the kernel (threads, rows, register form) or its shared memory
// differs from the layout's, cudaErrorCooperativeLaunchTooLarge when the
// blocks cannot all be co-resident.
int launch_seq(const void* kernel, Seq p, int gates, bool regs, int smem_plan, cudaStream_t stream) {
  if (p.B == 0) return static_cast<int>(cudaSuccess);
  const long long smem = layout(p, gates);
  const int threads = 32 * p.k_warps * p.n_warps;
  const bool reg_fit = !regs || (p.k_steps == kRegKs && p.n_warps == 1 &&
                                  (gates == 4 ? p.nt[0] <= kNtw : p.nt[0] == 1 && p.nt[1] == 1));
  if (smem != smem_plan || threads > kMaxThreads || p.rows < 16 || p.rows > 16 * kMt ||
      p.rows % 16 || !reg_fit || p.kp < p.H || p.n_warps * kNtw < p.nt[0] ||
      p.n_warps * kNtw < p.nt[1])
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  int per_sm = 0;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    DevInfo& d = g_dev[dev];
    if (!d.known) {
      err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err == cudaSuccess) err = cudaDeviceGetAttribute(&d.coop, cudaDevAttrCooperativeLaunch, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
      d.known = true;
    }
    if (!d.coop) return static_cast<int>(cudaErrorNotSupported);
    if (smem > d.optin) return static_cast<int>(cudaErrorInvalidValue);
    err = static_cast<cudaError_t>(
        cached_occupancy(kernel, dev, threads, static_cast<int>(smem), &per_sm));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (static_cast<long long>(per_sm) * d.sms < p.blocks)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(kernel, dim3(p.blocks), dim3(threads), args,
                                    static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the kernel of a plan: W in registers or not, 16 or 32 rows a pass
template <typename K>
const void* pick_kernel(int regs, int rows, K reg1, K reg2, K smem1, K smem2) {
  return reinterpret_cast<const void*>(regs ? (rows > 16 ? reg2 : reg1)
                                            : (rows > 16 ? smem2 : smem1));
}

Seq make_seq(const float* x, const float* w, const float* h0, const float* c0, const int* lens,
             float* hs, float* cs, float* xch, float* counter, int B, int T, int H, int units,
             int k_warps, int n_warps, int k_steps, int rows) {
  Seq p{};
  p.x = x;
  p.w = w;
  p.h0 = h0;
  p.c0 = c0;
  p.lens = lens;
  p.hs = hs;
  p.cs = cs;
  p.xch = xch;
  p.counter = reinterpret_cast<unsigned*>(counter);
  p.B = B;
  p.T = T;
  p.H = H;
  p.units = units;
  p.k_warps = k_warps;
  p.n_warps = n_warps;
  p.k_steps = k_steps;
  p.rows = rows;
  return p;
}

}  // namespace

// The plan's seven ints (recurrent.py rnn_plan): units, k_warps, n_warps,
// k_steps, rows, regs (W in registers), smem.  xch [2, B, hp] and the
// counter (one word) must be zero.
extern "C" int ptt_lstm_seq(const float* x, const float* w, const float* h0, const float* c0,
                            const int* lens, float* hs, float* cs, float* xch, float* counter,
                            int B, int T, int H, int units, int k_warps, int n_warps, int k_steps,
                            int rows, int regs, int smem, cudaStream_t stream) {
  const Seq p = make_seq(x, w, h0, c0, lens, hs, cs, xch, counter, B, T, H, units, k_warps,
                         n_warps, k_steps, rows);
  const void* kernel = pick_kernel(regs, rows, lstm_seq_kernel<true, 1>, lstm_seq_kernel<true, 2>,
                                   lstm_seq_kernel<false, 1>, lstm_seq_kernel<false, 2>);
  return launch_seq(kernel, p, 4, regs != 0, smem, stream);
}

extern "C" int ptt_gru_seq(const float* x, const float* w, const float* h0, const int* lens,
                           float* hs, float* xch, float* counter, int B, int T, int H,
                           int units, int k_warps, int n_warps, int k_steps, int rows, int regs,
                           int smem, cudaStream_t stream) {
  const Seq p = make_seq(x, w, h0, nullptr, lens, hs, nullptr, xch, counter, B, T, H, units,
                         k_warps, n_warps, k_steps, rows);
  const void* kernel = pick_kernel(regs, rows, gru_seq_kernel<true, 1>, gru_seq_kernel<true, 2>,
                                   gru_seq_kernel<false, 1>, gru_seq_kernel<false, 2>);
  return launch_seq(kernel, p, 3, regs != 0, smem, stream);
}
