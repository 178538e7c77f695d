// bf16 on mma.sync, ldmatrix and cp.async, and bf16 row access: the device
// helpers shared by the bf16 forms of the kernels (matmul_bias_act.cu's
// mm_tiled_bf16, linear_xent_bf16.cu, layer_norm.cu, add_layer_norm.cu).
//
// The products are mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32:
// bf16 operands, float32 accumulation.  A bf16 product is exact in float32
// (8 + 8 significand bits), so no split is needed, and the instruction runs
// at twice TF32's rate.  Operand fragments come from shared memory through
// ldmatrix (four 8 x 8 b16 matrices a call; .trans for an operand stored
// along the other dimension), from tiles whose 16-byte chunks are XOR
// swizzled so that each 8-address phase of an ldmatrix hits 8 distinct
// bank groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ptt {

using bf16 = __nv_bfloat16;

// ---- bf16 <-> float -------------------------------------------------------------
__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }

// 8 bf16 of a 16-byte word as floats, and back (round to nearest even)
__device__ __forceinline__ void unpack8(const uint4& w, float (&f)[8]) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

// ---- mma.sync on bf16 ------------------------------------------------------------
// d += a b over an m16 x n8 x k16 step.  A fragment (row-major, m16 x k16):
// a[0] rows g, columns 2t..2t+1; a[1] rows g + 8; a[2] columns 2t + 8..;
// a[3] both.  B fragment (k16 x n8): b[0] rows 2t..2t+1, column g; b[1]
// rows 2t + 8... D: d[0..1] (g, 2t..2t+1), d[2..3] (g + 8, ..); g = lane / 4,
// t = lane % 4.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices; lane l gives the row address of matrix l / 8,
// row l % 8, and receives element (l / 4, 2 (l % 4) ..) of each
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// the same, each matrix transposed: lane l receives elements (2 (l % 4) ..,
// l / 4) of the stored matrix
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// ---- staging ------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16_b(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4_b(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

// How a bf16 tile is staged: 16-byte cp.async copies of 8 elements (the
// row stride, the column start and bound multiples of 8, src 16-byte
// aligned), 4-byte copies of 2 (all even, src 4-byte aligned), else
// element loads through registers (any shape).
enum Copy { kCopy1 = 0, kCopy4 = 1, kCopy16 = 2 };

__host__ __device__ __forceinline__ int copy_mode(long ld, const void* src) {
  const size_t a = reinterpret_cast<size_t>(src);
  return ld % 8 == 0 && a % 16 == 0 ? kCopy16 : ld % 2 == 0 && a % 4 == 0 ? kCopy4 : kCopy1;
}

// A tile of `rows` x `cols` bf16 (cols a multiple of 8) from src[r0 + i,
// c0 + j] (row stride ld elements), rows < nr and columns < nc, into shared
// memory with chunk c (8 elements) of row i at chunk c ^ (swz(i) %
// chunks), out of bounds 0, by copies of `mode` (copy_mode of ld and src;
// c0 and nc multiples of the copy's width).
template <class Swz>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* __restrict__ src, int rows,
                                           int cols, long ld, int r0, int c0, int nr, int nc,
                                           int mode, int tid, int nthreads, Swz swz) {
  const int chunks = cols / 8;
  if (mode == kCopy16) {
    for (int i = tid; i < rows * chunks; i += nthreads) {
      const int r = i / chunks, c = i % chunks;
      const bool in = r0 + r < nr && c0 + 8 * c < nc;
      cp_async16_b(dst + r * cols + 8 * (c ^ (swz(r) & (chunks - 1))),
                   in ? src + (r0 + r) * ld + c0 + 8 * c : src, in);
    }
  } else if (mode == kCopy4) {
    const int pairs = cols / 2;
    for (int i = tid; i < rows * pairs; i += nthreads) {
      const int r = i / pairs, c = 2 * (i % pairs);
      const bool in = r0 + r < nr && c0 + c < nc;
      cp_async4_b(dst + r * cols + 8 * ((c / 8) ^ (swz(r) & (chunks - 1))) + c % 8,
                  in ? src + (r0 + r) * ld + c0 + c : src, in);
    }
  } else {
    for (int i = tid; i < rows * cols; i += nthreads) {
      const int r = i / cols, c = i % cols;
      const bool in = r0 + r < nr && c0 + c < nc;
      dst[r * cols + 8 * ((c / 8) ^ (swz(r) & (chunks - 1))) + c % 8] =
          in ? src[(r0 + r) * ld + c0 + c] : f2bf(0.f);
    }
  }
}

// ---- a KV cache's elements, float32 or bf16, read as float32 --------------------
// The attention kernels' bf16-KV forms stage bf16 keys and values and widen
// them where they are read; a bf16 value widened is exact in float32 (and
// in TF32: 8 significant bits of 11).  The float32 overloads are the plain
// reads, so one kernel source serves both forms.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return bf2f(v); }

// 2 and 4 consecutive elements (8 / 16 bytes in float32, 4 / 8 in bf16)
__device__ __forceinline__ float2 widen2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 widen2(const bf16* p) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float4 widen4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 widen4(const bf16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

// the address of element (r, c) of such a tile (c a multiple of 8 for the
// start of a chunk)
template <class Swz>
__device__ __forceinline__ const bf16* at_bf16(const bf16* tile, int cols, int r, int c,
                                               Swz swz) {
  return tile + r * cols + 8 * ((c / 8) ^ (swz(r) & (cols / 8 - 1))) + c % 8;
}

}  // namespace ptt
