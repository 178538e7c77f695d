// The float32 tail shared by the linear cross entropy's float32 and bf16
// forms (linear_xent.cu, linear_xent_bf16.cu): a row's validity, d loss /
// d z at one logits element, and the merges of the forward's per-split
// row statistics (the loss, or one vocab shard's parts).
#pragma once

#include "common.cuh"

namespace {

// Does row gr (< R) take the label term?  The unsharded form derives it
// from its label; the sharded form is handed it (vld != nullptr), since a
// local label cannot tell an other shard's column from outside the vocab.
__device__ __forceinline__ bool row_valid(const float* __restrict__ vld,
                                          int gr, long long lbl, int V) {
  return vld != nullptr ? vld[gr] != 0.f : (lbl >= 0 && lbl < V);
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

// merge the splits of each row in split order; write loss and lse
// (part[(split * 4 + q) * R + row], q = max, sum of exponentials, gold
// logit, logit sum)
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

}  // namespace
