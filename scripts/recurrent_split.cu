// Where a step of csrc/recurrent.cu's kernels goes: the shipped kernels'
// own helpers (this file includes the shipped source), run for a prefix of
// each step, for scripts/recurrent_kernel_check.py (not part of the kernel
// library).  `parts` 0: the barriers alone (once a step for the LSTM,
// twice for the GRU: the empty recurrence, the design's serial floor);
// 1: with the stage of h (and r h) into the tile; 2: with the tensor-core
// product and its partials.  The whole step is the shipped kernel.  Two
// barriers of per-block flags, alone, for comparison with the shipped
// arrival counter (the counter's buffer then holds a word a block): 3, one
// warp polls every flag with relaxed loads and fences once; 4, an acquire
// load a flag a poll and a fence before the release store.  Each variant
// runs the shipped set-up (W into registers) first.
#include "recurrent.cu"  // paddle_tpu_torch/kernels/csrc (nvcc -I)

namespace {

// kForm 0: the shipped counter; 1, 2: per-block flags in p.counter[0 ..
// blocks), polled by one warp, relaxed with one fence (1) or with acquire
// loads and a fence before the release store (2)
template <int kForm>
__device__ __forceinline__ void step_barrier(const Seq& p, unsigned v) {
  if constexpr (kForm == 0) {
    arrive(p.counter);
    wait_for(p.counter, v * p.blocks);
  } else {
    __syncthreads();
    if (threadIdx.x == 0) {
      if (kForm == 2) __threadfence();
      asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p.counter + blockIdx.x), "r"(v)
                   : "memory");
    }
    if (threadIdx.x < 32) {
      const unsigned long long start = global_ns();
      bool ready;
      do {
        ready = true;
        for (int i = threadIdx.x; i < p.blocks; i += 32) {
          unsigned f;
          if (kForm == 1)
            asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n"
                         : "=r"(f)
                         : "l"(p.counter + i)
                         : "memory");
          else
            asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                         : "=r"(f)
                         : "l"(p.counter + i)
                         : "memory");
          ready = ready && f >= v;
        }
        if (!ready && global_ns() - start > kWaitLimitNs) __trap();
      } while (!__all_sync(0xffffffffu, ready));
      __threadfence();
    }
    __syncthreads();
  }
}

template <int kParts, int kMts>
__global__ void __launch_bounds__(kMaxThreads, 1) lstm_split_kernel(Seq p) {
  constexpr int kForm = kParts <= 2 ? 0 : kParts - 2;
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(p, smem, 4);
  const int u0 = blockIdx.x * p.units, nu = min(p.units, p.H - u0);
  prefetch_x(p, s, 4, 0, u0, nu);
  setup(p, s, 4, u0, nu);
  uint4 wr[kRegKs][kNtw];
  load_frags<4>(p, s.w, wr);
  const long long bhp = static_cast<long long>(p.B) * p.hp;
  for (int t = 0; t < p.T; ++t) {
    for (int r0 = 0; r0 < p.B; r0 += p.rows) {
      const int rows = min(p.rows, p.B - r0);
      if (kParts == 1 || kParts == 2) stage(p, s, p.xch + ((t + 1) & 1) * bhp, p.hp, true, r0, rows);
      if (kParts == 2) {
        product<4, true, 0, kMts>(p, s, wr);
        __syncthreads();
      }
    }
    if (t + 1 < p.T) step_barrier<kForm>(p, t + 1);
  }
  ptt::cp_async_wait(0);
}

template <int kParts, int kMts>
__global__ void __launch_bounds__(kMaxThreads, 1) gru_split_kernel(Seq p) {
  constexpr int kForm = kParts <= 2 ? 0 : kParts - 2;
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(p, smem, 3);
  const int u0 = blockIdx.x * p.units, nu = min(p.units, p.H - u0);
  prefetch_x(p, s, 3, 0, u0, nu);
  setup(p, s, 3, u0, nu);
  uint4 wr[kRegKs][kNtw];
  load_frags<3>(p, s.w, wr);
  const float* rh = p.xch + static_cast<long long>(p.B) * p.hp;
  for (int t = 0; t < p.T; ++t) {
    for (int r0 = 0; r0 < p.B; r0 += p.rows) {
      const int rows = min(p.rows, p.B - r0);
      if (kParts == 1 || kParts == 2) stage(p, s, p.xch, p.hp, true, r0, rows);
      if (kParts == 2) {
        product<3, true, 0, kMts>(p, s, wr);
        __syncthreads();
      }
    }
    step_barrier<kForm>(p, 2 * t + 1);
    for (int r0 = 0; r0 < p.B; r0 += p.rows) {
      const int rows = min(p.rows, p.B - r0);
      if (kParts == 1 || kParts == 2) stage(p, s, rh, p.hp, true, r0, rows);
      if (kParts == 2) {
        product<3, true, 1, kMts>(p, s, wr);
        __syncthreads();
      }
    }
    if (t + 1 < p.T) step_barrier<kForm>(p, 2 * t + 2);
  }
  ptt::cp_async_wait(0);
}

// the split kernel for `parts` (0..4) at the plan's rows a pass
const void* pick_lstm(int parts, int rows) {
  switch (parts) {
    case 0: return reinterpret_cast<const void*>(lstm_split_kernel<0, 2>);
    case 1: return reinterpret_cast<const void*>(lstm_split_kernel<1, 2>);
    case 2:
      return rows > 16 ? reinterpret_cast<const void*>(lstm_split_kernel<2, 2>)
                       : reinterpret_cast<const void*>(lstm_split_kernel<2, 1>);
    case 3: return reinterpret_cast<const void*>(lstm_split_kernel<3, 2>);
    default: return reinterpret_cast<const void*>(lstm_split_kernel<4, 2>);
  }
}

const void* pick_gru(int parts, int rows) {
  switch (parts) {
    case 0: return reinterpret_cast<const void*>(gru_split_kernel<0, 2>);
    case 1: return reinterpret_cast<const void*>(gru_split_kernel<1, 2>);
    case 2:
      return rows > 16 ? reinterpret_cast<const void*>(gru_split_kernel<2, 2>)
                       : reinterpret_cast<const void*>(gru_split_kernel<2, 1>);
    case 3: return reinterpret_cast<const void*>(gru_split_kernel<3, 2>);
    default: return reinterpret_cast<const void*>(gru_split_kernel<4, 2>);
  }
}

}  // namespace

// ptt_lstm_seq's and ptt_gru_seq's arguments (the register form's plan
// only) and `parts` in 0..4 before the stream.
extern "C" int ptt_split_lstm(const float* x, const float* w, const float* h0, const float* c0,
                              const int* lens, float* hs, float* cs, float* xch, float* counter,
                              int B, int T, int H, int units, int k_warps, int n_warps,
                              int k_steps, int rows, int regs, int smem, int parts,
                              cudaStream_t stream) {
  if (!regs || parts < 0 || parts > 4) return static_cast<int>(cudaErrorInvalidValue);
  const Seq p = make_seq(x, w, h0, c0, lens, hs, cs, xch, counter, B, T, H, units, k_warps, n_warps,
                         k_steps, rows);
  return launch_seq(pick_lstm(parts, rows), p, 4, true, smem, stream);
}

extern "C" int ptt_split_gru(const float* x, const float* w, const float* h0, const int* lens,
                             float* hs, float* xch, float* counter, int B, int T, int H, int units,
                             int k_warps, int n_warps, int k_steps, int rows, int regs, int smem,
                             int parts, cudaStream_t stream) {
  if (!regs || parts < 0 || parts > 4) return static_cast<int>(cudaErrorInvalidValue);
  const Seq p = make_seq(x, w, h0, nullptr, lens, hs, nullptr, xch, counter, B, T, H, units, k_warps,
                         n_warps, k_steps, rows);
  return launch_seq(pick_gru(parts, rows), p, 3, true, smem, stream);
}
