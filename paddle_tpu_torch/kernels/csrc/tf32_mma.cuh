// 3xTF32 on mma.sync and cp.async staging: the device helpers shared by
// the kernels that run float32 products on the tensor cores
// (linear_xent.cu, matmul_bias_act.cu, flash_attention.cu).
#pragma once

#include <cuda_runtime.h>

namespace ptt {

// ---- 3xTF32 on mma.sync ------------------------------------------------------
// a TF32 operand: a rounded to nearest (ties away from zero)
__device__ __forceinline__ unsigned tf32_rna(float a) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

struct Split {
  unsigned big, small;
};

// a = big + small (the mask keeps big's value exactly its 19 TF32 bits)
__device__ __forceinline__ Split split(float a) {
  Split s;
  s.big = tf32_rna(a);
  s.small = tf32_rna(a - __uint_as_float(s.big & 0xffffe000u));
  return s;
}

// two neighbouring floats of shared memory, split
__device__ __forceinline__ void split2(const float* p, Split& lo, Split& hi) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  lo = split(v.x);
  hi = split(v.y);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], unsigned a0, unsigned a1,
                                         unsigned a2, unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: small*big, big*small, big*big, in that order.
// A fragment (m16 x k8): a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4),
// a[3] (g + 8, t + 4); B fragment (k8 x n8): b[0] (t, g), b[1] (t + 4, g);
// D: d[0..1] (g, 2t..2t+1), d[2..3] (g + 8, 2t..2t+1); g = lane / 4, t = lane % 4.
// The callers take fragment k t as depth 2t and k t + 4 as depth 2t + 1 of
// the 8-deep step (the same permutation on both sides), so a[0] and a[2]
// are neighbours in shared memory and load as one float2.
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4],
                                     const Split (&b)[2]) {
  mma_tf32(d, a[0].small, a[1].small, a[2].small, a[3].small, b[0].big, b[1].big);
  mma_tf32(d, a[0].big, a[1].big, a[2].big, a[3].big, b[0].small, b[1].small);
  mma_tf32(d, a[0].big, a[1].big, a[2].big, a[3].big, b[0].big, b[1].big);
}

// The split with the values of split() for finite normal floats:
// cvt.rna.tf32.f32 rounds the magnitude to nearest, ties away from zero,
// which on the bit pattern is adding half of the 13 dropped bits' unit and
// clearing them.  Done so in integer ops: cvt issues at a quarter of their
// rate (16 against 64 results a clock an SM in the CUDA guide's table).
__device__ __forceinline__ unsigned rna_bits(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ Split split_rna(float a) {
  Split s;
  s.big = rna_bits(a);
  s.small = rna_bits(a - __uint_as_float(s.big));
  return s;
}

__device__ __forceinline__ void split2_rna(const float* p, Split& lo, Split& hi) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  lo = split_rna(v.x);
  hi = split_rna(v.y);
}

// An accumulator fragment of an 8-column block as the A operand of the
// next product's 8-deep step over those columns: d[0], d[1], d[2], d[3]
// sit at (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1), which is
// a[0], a[2], a[1], a[3] under the depth order above.
__device__ __forceinline__ void split_acc(Split (&a)[4], const float (&d)[4]) {
  a[0] = split_rna(d[0]);
  a[1] = split_rna(d[2]);
  a[2] = split_rna(d[1]);
  a[3] = split_rna(d[3]);
}

// mma3 with the B fragment split ahead of time into one 16-byte word,
// b = {b[0].big, b[1].big, b[0].small, b[1].small}
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4], const uint4& b) {
  mma_tf32(d, a[0].small, a[1].small, a[2].small, a[3].small, b.x, b.y);
  mma_tf32(d, a[0].big, a[1].big, a[2].big, a[3].big, b.z, b.w);
  mma_tf32(d, a[0].big, a[1].big, a[2].big, a[3].big, b.x, b.y);
}

// ---- cp.async staging ---------------------------------------------------------
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n groups are pending (n = stages - 2: 0, 1 or 2)
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace ptt
